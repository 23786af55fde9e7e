#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — card name, power limit, and the nvcc build of every kernel of
             the port from the sources in this checkout.
2. kernel  — the banked kernel against its plain PyTorch version on the
             card, N=256, on both of its paths: 65,536 events on a 64-row
             bank staged in shared memory; a 1,024-event window on it, and
             65,536 events on 4,096 rows and on the first T past the
             card's shared-memory limit, read through L1/L2.  On each:
             K = 1, 3, 5, 8 in sorted, interleaved and random layouts, a
             partial tail, flat segments, unsorted tables and NaN knots,
             ties on knots (bitwise), out-of-support and NaN scores, M=1,
             and out-of-range ids (NaN in the plain version's rows, every
             row compared); on the L1/L2 path also tables of N=33 and
             tables 4 bytes off a 16-byte boundary, K = 3 and 8; then its
             times at T=64 (each layout), at
             T=4,096 and at a 1,024 x 3 serve window, each beside the
             plain version's and the memory/compute bound, and both
             kernels' times from 1,024 to 65,536 rows on one bank, where
             the host's choice between them turns.
3. serve   — the port's main path, ``MuseServer.score_batch``, over the
             FraudWorld ensemble (3 experts, 16 features, N=256) with 64
             tenant predictors and a shadow candidate: mixed-tenant windows
             of 1,024 requests through the hand-written kernel, checked
             against the same traffic through the plain version, with a
             T^Q refresh published mid-run; then the same windows through
             servers with fused device tracking at staging 4,096 (nothing
             drained before the snapshot) and 64 (spills): responses and,
             after the tracker's sync, estimator snapshots bitwise equal to
             the eager server's, and the track stage's host ms of each.
4. lifecycle — the model-update lifecycle (paper Fig. 3) through the
             port's control plane: 32 FraudWorld tenants plus an onboarding
             one, each on its own predictor, on two replicas (one with
             fused device tracking) behind a fenced ``ReplicaSet``; a
             ``FleetCalibrationController`` refits after a cold-start
             phase; a ``RollingUpdate`` promotes {m1,m2} -> {m1,m2,m3}
             with stale maps under traffic; one fleet refresh; a last
             phase ending in a 32,768-request window (the banked kernel's
             shared-memory path).  Eight tenants and the onboarding one run
             a ``DecisionLoop`` into an ``AuditLog``.  Checks: alert rates
             within 1.2 pp of a = 2% before and after the update, for all
             32 tenants; fleet-monotone generations, no request lost or
             repeated; every response within 2e-5 of the plain banked
             version from its generation's archived parameters; every
             audited decision replayed bit for bit through the kernel
             (one-row banks of unpadded tables); a flipped byte caught at
             its index; the device-tracking replica's estimators equal an
             eager twin's over the same windows.
5. engine  — the async dispatch engine (``serving/engine.py``):
             ``repro_torch.benchmarks.bench_async_engine`` at the
             reference's sizes, 32 tenants each on its own predictor over
             three MLP experts (64 -> 512 -> 512 -> 1), T^Q of 128 knots,
             16,384 events in windows of 128 (adaptive up to 2,048): the sync
             ``ServerBatcher``, the engine with fixed and with adaptive
             windows, tracking off and fused device tracking on — events/s
             of each, bitwise equal scores across all five, every event
             tracked; then the serve phase's server tiered at 16 hot and 15
             victim slots through the engine, bitwise equal to the dense
             server (prefetched rows, cold-miss stalls).
6. tiering — the tiered bank store (``serving/tiering.py``):
             ``repro_torch.benchmarks.bench_tiered_bank`` at its sizes
             (K = 4, N = 256, 384 hot + 127 victim slots + the prior):
             bitwise equal to the dense bank at 1,024 tenants; device bytes
             (1,064,960 at every size) and host bytes over 1,024 .. 10^6
             tenants; hot-row events/s at batch 8,192; stall rates of a
             95/5 hot/cold mix at batch 2,048 without and with prefetch (0
             with it at 10^6); the p99 dispatch time at 100,000 tenants
             under a concurrent prefetching thread, staging under the lock
             against overlapped, and its staging conflicts.
7. sharding — the tenant-sharded topology (``ShardedTransformBank``,
             ``ShardedBankDispatcher``, ``ShardedTieredBankStore``):
             ``repro_torch.benchmarks.bench_sharded_bank`` at its sizes (K =
             4, N = 256, batch 8,192, T = 256 / 1,024 / 4,096, S = 1 / 2 /
             4 / 8), every sharded row bitwise the dense launch, one launch
             a call, resident bytes exact (1,064,960 a shard at T = 4,096,
             S = 8); the dispatcher on an uneven assignment leaving one of 8
             shards empty at the same sizes, bitwise; the serve phase's
             configuration served at S = 4, at S = 8 and tiered over S = 4
             (4 hot + 3 victim slots a shard) through the async engine,
             each response bitwise the dense server's with equal
             generations across a mid-run publish, launches held to the
             sharded dispatches (passes on the composed store); then fleet
             refreshes published by a writer thread while traffic runs
             through the engine on the S = 4 server: consecutive
             generations, every response replayed bit for bit through the
             kernel from its own generation's parameters.
8. main_bench — the main path's two benchmarks at the reference's sizes:
             ``bench_serving_latency`` (the path at batch 1 / 16 / 64 / 256,
             the shared-parameter kernel alone at 4,096 rows, the
             transform's share of the path) and ``bench_multitenant_batch``
             (one banked launch against 64 per-predictor launches at 64 x
             1,024, each within 2e-5 of its plain version).
9. paper_bench — the paper's tables and figures at the reference's full
             sizes (``repro_torch.benchmarks``): Table 1 (T^C on the
             card), Fig. 4 (T^Q of 400,000 and 200,000 live scores through
             the quantile-map kernel, and the fleet refresh at 4-128
             tenants through the banked kernel), Fig. 6 (three T^Q
             launches of 400,000 scores), Fig. 5 (a rolling update over 3
             replicas under traffic), the fleet calibration plane (2-16
             replicas) and the attack campaign (every audited decision
             replayed bit for bit through the banked kernel), each with
             its own launch counts; the T^Q kernel on the live scores
             within 2e-5 of its plain version (bitwise on knots, no score
             changing bin unless within 2e-5 of an edge) and its time
             at 400,000 x 256 beside its plain version and bound; Table 1
             and Figs. 4 and 6 against the port's CPU run at the same
             size (the values whose bits differ counted);
             the rollout's, the fleet's and the campaign's invariants;
             then ``python -m repro_torch.examples.quickstart`` on the
             card, line for line its CPU run.
10. attention — the two flash-attention kernels against their plain
             version on the card, float32 and bfloat16 (bf16 with D = 64
             or 128 runs the tensor-core form, the rest the SIMT form,
             checked per case): the reference's five cases, Tq < Tk, a
             ragged T = 1,000, a window across tile edges, D = 80 and
             D = 128, B > 1, and rows that see no key (exactly 0); then
             at the prefill shape of qwen3-8b (B=4, T=2,048, 32/8 heads,
             D=128, causal) the tensor-core form's time in bf16 and the
             SIMT form's in float32, each beside the plain version,
             PyTorch's own attention call and the bound.
11. llm_serve — the port's model path at the full width of qwen3-8b
             (36 layers, d_model 4,096, vocab 151,936; bf16 weights from a
             seed): ``launch.serve.serve`` prefills 4 x 2,048 tokens through
             the tensor-core kernel, decodes 16 greedy steps and maps the
             risk score through T^Q.  Over six weight and prompt seeds the
             kernel prefill's served risk scores and last-token logits are
             held against float32 and bfloat16 reference prefills of the
             same weights, and each attention call's last rows inside the
             model against the plain version in float32.  A float32
             prefill through the kernel branch (the SIMT form's path) is
             held against the float32 reference prefill.
12. zoo_serve — the MoE, xLSTM and Mamba families at full width, each
             built in bf16 from seed 0 and freed before the next:
             olmoe-1b-7b (16 layers, d_model 2,048, 64 experts of 1,024,
             top-8), xlstm-1.3b (48 blocks, sLSTM:mLSTM 1:7) and the first
             five layers of jamba-1.5-large-398b (d_model 8,192: four
             Mamba layers of d_inner 16,384, N = 16, one attention layer of
             64/8 heads of 128, three MLPs of 24,576, two MoEs of 16
             experts of 24,576, top-2; one 8-layer period does not fit one
             card): through ``launch.serve.serve`` a 4 x 2,048 prefill
             through the kernel branch (olmoe: 16 tensor-core flash
             launches, 16/16 heads of 128; jamba: 1, and 4 selective-scan
             launches) and 16 decode steps (jamba: 4 selective-scan
             launches a step), each risk score through T^Q by the
             ``score_pipeline`` kernel (17 launches a run); times, CUDA
             launches, device busy share and its split (cuBLAS, flash,
             the selective scan, the MoE's scatter and gather, the rest),
             peak memory; qwen3's accuracy rule over six seeds (jamba, whose
             float32 copy would not fit, layer by layer: each Mamba layer
             of the kernel-branch prefill, as served, against a float32
             copy of it on the same input, no farther than twice the bf16
             layer with the plain scan), and for olmoe and jamba the share
             of (token, slot) routes that differ between bf16 and float32
             (printed, not gated); the selective-scan kernel against its
             plain version within 2e-5 (y and h_T) on small cases (T = 1,
             ragged T and C, N = 8 and 16, h0 given or not, an aliased
             in-place state) and on the float32 inputs a served prefill
             gives each of jamba's four Mamba layers, timed there beside
             its plain version and its bound; the flash kernel at olmoe's
             prefill shape against its plain version, with its time, bound
             and PyTorch's attention call; then ``python -m
             repro_torch.examples.serve_e2e`` on the card in a process of
             its own (three transformer experts, one of them olmoe smoke,
             behind the banked kernel), with its banked launches.
13. score_kernels — the quantile-map and shared-parameter score-pipeline
             kernels against their plain versions, float32 and bfloat16
             (the score-pipeline kernel bit for bit on every case): the
             reference's cases, scores on knots (bitwise), NaN scores,
             scores outside the support, flat, all-flat, unsorted and
             NaN-knot tables at K = 3 and 8, M = 1, a (4, 7, 9) batch,
             K = 1; the quantile map on sizes no multiple of the block,
             scores off a 16-byte boundary, N = 2, 4,095 and 4,096, and
             tables that fail the sortedness proof; the last knot: 2,000
             random tables of 128 knots, alone and edge-padded to 256,
             scored on, one ulp past and one ulp below their last knot
             through the three T^Q kernels (the banked one on both paths),
             padded bitwise equal to unpadded; then their times at a
             1,024-row serve window (the benchmark's 65,536 rows are timed
             by phase 15).
14. decode_attention — the decode kernel against its plain version,
             float32 within 2e-5 and bf16 within bf16's rounding of the
             plain version run in float32 on the same inputs: the
             reference's cases and per-row lengths, valid_len 0 (exactly
             0) and past S, S not a multiple of a round, D = 80 and 128, 1
             and 8 query heads per KV head; then at the benchmark's shape
             (4 x 16,384, 8/2 heads, D=64) and at qwen3-8b's decode
             (4 x 2,064, 32/8 heads, D=128): both checks, its time in
             bf16 warm and with L2 cold, in float32 warm, beside PyTorch's
             own attention call (warm and cold), the bounds and a traced
             loop (a call's period, the combine's tail, the launches a
             call: at most two, and no other kernel).
15. bench_kernels — the port's kernel microbenchmark at full size, the path
             of those three kernels: every entry agrees with its plain
             version and every kernel launched.
16. train   — training on the card: the selective scan's backward kernel
             against its plain version within 2e-5 on every gradient
             (T = 1, ragged T and C, N = 8 and 16, h0 given or not, dh_T
             zero and nonzero); jamba-1.5-large-398b's first layer at full
             width (Mamba d_inner 16,384, N = 16, MLP of 24,576, vocab
             65,536; 2,098,085,889 float32 parameters from seed 0) trained
             12 steps of 4 x 2,048 tokens by ``Trainer.fit`` with AdamW on
             a cosine schedule, remat and bf16 compute: losses and gradient
             norms finite, the loss falling, ms a step, tokens/s, peak
             memory, launches (two forward scans a step, remat's recompute
             one of them, and one backward of each of its two kernels);
             the backward kernel on step 1's live inputs within 2e-5 of its
             plain version, timed beside it and its bound; the Mamba
             layer's parameter gradients through the kernels in bf16 no
             farther from a float32 plain-scan copy than twice the bf16
             plain layer (three seeds); one profiled step's busy share and
             split; then ``python -m
             repro_torch.examples.train_fraud_scorer`` at the reference's
             defaults in a process of its own, and again from its
             checkpoints.
17. roofline — every path phases 11, 12 and 16 timed (qwen3-8b, olmoe-1b-7b,
             xlstm-1.3b and jamba's five layers, prefill and decode; jamba's
             one-layer train step) read against the one-card roofline
             (``launch/roofline.py`` at the H100's published rates) at that
             run's batch, length and kind: mfu, flops_share, hbm_share,
             roofline_share and the bottleneck, none over 1.05; the
             dry-run's trace of each step on meta (``launch/dryrun.py``:
             its kernel calls equal to the run's launches; its argument
             bytes at most the measured peak, its predicted peak over the
             measured one); nothing is timed again; then ``python -m
             repro_torch.launch.dryrun`` on qwen3-8b x decode_32k in a
             process of its own.
18. kernels — every kernel of the port with its launches on its path, its
             error and its times at the path's shapes.

Any failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, without CUDA or outside the repository.  The
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

TOL = 2e-5            # the reference's f32 kernel tolerance
ATTN_TOL = {"float32": 5e-5,   # the reference's flash property sweep
            "bfloat16": 2e-2}  # the reference's bf16 kernel tolerance


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


# ---------------------------------------------------------------- phase 1
def phase_device() -> tuple[str, str]:
    import torch
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    seconds = _build.build_all()
    regs = {name: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln
                   or "warning" in ln.lower()]
            for name, log in _build.BUILD_LOGS.items()}
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": seconds, "build_wall_s": time.perf_counter() - t0,
          "ptxas": regs})
    return torch.cuda.get_device_name(0), smi


# ---------------------------------------------------------------- phase 2
def _bank(rng, t, k, n, dev):
    import numpy as np
    import torch

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return (f32(rng.uniform(0.05, 1.0, (t, k))),
            f32(rng.uniform(0.1, 2.0, (t, k))),
            f32(np.sort(rng.uniform(0, 1, (t, n)), axis=-1)),
            f32(np.sort(rng.uniform(0, 1, (t, n)), axis=-1)))


def _compare(name, got, want, *, exact=False, tol=TOL) -> float:
    import torch

    got, want = got.cpu(), want.cpu()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: shape/dtype")
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    check(torch.equal(nan_g, nan_w), f"{name}: NaN rows differ")
    fin = ~nan_w
    err = (got[fin].float() - want[fin].float()).abs().max().item() \
        if fin.any() else 0.0
    if exact:
        check(torch.equal(got[fin], want[fin]), f"{name}: not bitwise equal")
    check(err <= tol, f"{name}: max abs err {err} > {tol}")
    return err


def _ids(a, dev):
    import numpy as np
    import torch

    return torch.tensor(np.asarray(a, np.int32), device=dev)


def _layout(name, rng, t, m):
    import numpy as np

    if name == "sorted":          # tenant runs, as a shard-bucketed window
        return np.repeat(np.arange(t), -(-m // t))[:m]
    if name == "interleaved":     # tenants alternate row by row
        return np.arange(m) % t
    return rng.integers(0, t, m)


def _banked_cases(dev, t, m, n, rng, errs, tag) -> None:
    """Every case of the kernel phase on one bank size, so on one of the
    banked kernel's two paths; errors go to ``errs`` under ``tag``."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import score_pipeline as sp

    def cmp(name, y, tid, bank, exact=False):
        key = f"{tag}/{name}"
        errs[key] = _compare(key, sp.score_pipeline_banked(y, tid, *bank),
                             ref.score_pipeline_banked(y, tid, *bank),
                             exact=exact)

    def scores(rows, k, lo=0.0, hi=1.0):
        return torch.tensor(rng.uniform(lo, hi, (rows, k)).astype(
            np.float32), device=dev)

    # K = 1, 3, 5, 8 (16-byte score reads at K = 8) in three layouts
    for k in (1, 3, 5, 8):
        bank = _bank(rng, t, k, n, dev)
        y = scores(m, k)
        for layout in ("sorted", "interleaved", "random"):
            cmp(f"k{k}/{layout}", y, _ids(_layout(layout, rng, t, m), dev),
                bank)
    k = 8
    bank = _bank(rng, t, k, n, dev)
    betas, weights, src, refq = bank
    y = scores(m, k)
    tid = _ids(rng.integers(0, t, m), dev)

    # partial tail: 17 rows past a whole number of warps and blocks
    cmp("partial_tail", scores(m + 17, k),
        _ids(np.concatenate([rng.integers(0, t, m), np.full(17, 5)]), dev),
        bank)

    # flat source segments and fully degenerate tables (search path)
    flat = src.clone()
    flat[:, 40:90] = flat[:, 40:41]
    flat[::7] = 0.5
    cmp("flat_segments", y, tid, (betas, weights, flat, refq))

    # unsorted tables and NaN knots in some tenants' rows (count path)
    odd = src.clone()
    odd[1::5] = torch.rand(odd[1::5].shape, device=dev)
    odd[2::5, 7] = float("nan")
    cmp("unsorted_and_nan_knots", y, tid, (betas, weights, odd, refq))

    # ties: identity T^C and A (K = 1, beta = w = 1: agg == score) with
    # scores ON the knots of each row's table, a flat run whose reference
    # jumps included: the bucket must be the exact count, so the outputs
    # must be bitwise equal
    knots = src.clone()
    knots[:, 100:120] = knots[:, 100:101]
    j = torch.tensor(rng.integers(0, n - 1, m), device=dev)
    ones = torch.ones(t, 1, device=dev)
    cmp("ties_on_knots", knots[tid.long(), j][:, None].contiguous(), tid,
        (ones, ones, knots, refq), exact=True)

    # aggregates far outside every table's support (clip to the edges)
    cmp("out_of_support", torch.cat([scores(m // 2, k, 0.0, 0.02),
                                     scores(m // 2, k, 0.98, 1.0)]), tid,
        (betas, weights, 0.4 + 0.2 * src, refq))

    # NaN scores come out NaN in the same rows
    y_nan = y.clone()
    y_nan[::13, 3] = float("nan")
    cmp("nan_scores", y_nan, tid, bank)

    cmp("m1", y[:1], tid[:1], bank)

    # out-of-range ids: NaN in exactly the plain version's rows, every row
    # compared (the plain version masks them to NaN too)
    bad = tid.clone()
    bad[::11] = t + 3
    bad[5::17] = -1
    bad[7::29] = -t
    got = sp.score_pipeline_banked(y, bad, *bank)
    out = (bad < 0) | (bad >= t)
    check(bool(torch.isnan(got[out]).all()), f"{tag}: out-of-range ids NaN")
    errs[f"{tag}/out_of_range_ids"] = _compare(
        f"{tag}/out_of_range_ids", got,
        ref.score_pipeline_banked(y, bad, *bank))


def _four_bytes_off(x):
    """``x`` copied into a contiguous tensor that starts 4 bytes past a
    16-byte boundary."""
    import torch

    out = torch.empty(x.numel() + 1, device=x.device,
                      dtype=x.dtype)[1:].view(x.shape)
    out.copy_(x)
    check(out.data_ptr() % 16 == 4, "table not 4 bytes off 16")
    return out


def _launch_path(path, y, tid, bank):
    """One call of the banked kernel on ``path`` whatever the host's
    choice, through its C launcher (the crossover timing only)."""
    import torch
    from repro_torch.kernels import score_pipeline as sp

    out = torch.empty(y.shape[0], device=y.device)
    (m, k), (t, n) = y.shape, bank[2].shape

    def go():
        code = sp._library().score_pipeline_banked_launch(
            y.data_ptr(), tid.data_ptr(), *(x.data_ptr() for x in bank),
            out.data_ptr(), m, k, t, n, int(path == "shared"),
            torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"{path} launch failed ({code})")
        return out
    return go


def phase_kernel(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.benchmarks.timing import banked_bound, device_ms
    from repro_torch.kernels import ref
    from repro_torch.kernels import score_pipeline as sp

    m, n = 65_536, 256
    card = sp.card(dev)
    past = card[0] // sp.banked_shared_bytes(1, n) + 1
    rng = np.random.default_rng(0)
    errs: dict[str, float] = {}
    paths = {}
    # 65,536 rows on T = 64 stage the bank in shared memory; a 1,024-row
    # window on it, and 65,536 rows on T = 4,096 and on the first T past
    # the card's limit, read it through L1/L2
    for tag, t, rows in (("t64", 64, m), ("t64_window", 64, 1_024),
                         ("t4096", 4_096, m), ("past_limit", past, m)):
        paths[tag] = {"T": t, "M": rows,
                      "path": sp.banked_path(t, n, rows, *card)}
        _banked_cases(dev, t, rows, n, rng, errs, tag)
    check([v["path"] for v in paths.values()]
          == ["shared", "global", "global", "global"], f"paths {paths}")
    # the L1/L2 kernel's float-at-a-time table reads: rows of N = 33, and
    # tables 4 bytes off a 16-byte boundary, at K = 3 and 8
    for tag, rows in (("t64_window", 1_024), ("past_limit", m)):
        for tables, nn in (("n33", 33), ("misaligned", n)):
            t = 64 if tag == "t64_window" else \
                card[0] // sp.banked_shared_bytes(1, nn) + 1
            check(sp.banked_path(t, nn, rows, *card) == "global",
                  f"{tag}/{tables}: path")
            for k in (3, 8):
                betas, weights, src, refq = _bank(rng, t, k, nn, dev)
                if tables == "misaligned":
                    src, refq = _four_bytes_off(src), _four_bytes_off(refq)
                bank = (betas, weights, src, refq)
                y = torch.tensor(rng.uniform(0, 1, (rows, k)).astype(
                    np.float32), device=dev)
                tid = _ids(rng.integers(0, t, rows), dev)
                key = f"{tag}/{tables}/k{k}"
                errs[key] = _compare(
                    key, sp.score_pipeline_banked(y, tid, *bank),
                    ref.score_pipeline_banked(y, tid, *bank))
    torch.cuda.synchronize()

    # times: the benchmark's T = 64 bank in each layout, the reference
    # benchmark's T = 4,096 bank in random order, and a serve window
    timings = {}
    for name, (rows, k, t, layout) in {
            "t64_sorted": (m, 8, 64, "sorted"),
            "t64_interleaved": (m, 8, 64, "interleaved"),
            "t64_random": (m, 8, 64, "random"),
            "t4096_random": (m, 8, 4_096, "random"),
            "window_1024x3": (1_024, 3, 64, "random")}.items():
        bank = _bank(rng, t, k, n, dev)
        y = torch.tensor(rng.uniform(0, 1, (rows, k)).astype(np.float32),
                         device=dev)
        tid = _ids(_layout(layout, rng, t, rows), dev)
        err = _compare(name, sp.score_pipeline_banked(y, tid, *bank),
                       ref.score_pipeline_banked(y, tid, *bank))
        bound_ms, bound_by = banked_bound(rows, k, t, n)
        timings[name] = {
            "shape": {"M": rows, "K": k, "T": t, "N": n, "layout": layout},
            "path": sp.banked_path(t, n, rows, *card), "max_abs_err": err,
            "ms": device_ms(lambda: sp.score_pipeline_banked(y, tid, *bank)),
            "plain_ms": device_ms(
                lambda: ref.score_pipeline_banked(y, tid, *bank), inner=10),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}

    # where the host's choice turns: both kernels on one 64-tenant bank,
    # random ids, K = 8, from a serve window to the benchmark's size (each
    # held to the plain version first)
    bank = _bank(rng, 64, 8, n, dev)
    crossover = {}
    for rows in (1_024, 4_096, 16_384, 32_768, 65_536):
        y = torch.tensor(rng.uniform(0, 1, (rows, 8)).astype(np.float32),
                         device=dev)
        tid = _ids(rng.integers(0, 64, rows), dev)
        want = ref.score_pipeline_banked(y, tid, *bank)
        crossover[rows] = {"chosen": sp.banked_path(64, n, rows, *card)}
        for path in ("shared", "global"):
            fn = _launch_path(path, y, tid, bank)
            _compare(f"crossover/{rows}/{path}", fn().clone(), want)
            crossover[rows][path] = device_ms(fn)
    big = timings["t4096_random"]
    result = {"phase": "kernel", "name": "score_pipeline_banked",
              "card": {"shared_limit_bytes": card[0], "sms": card[1]},
              "paths": paths, "shape": big["shape"],
              "max_abs_err": max(errs.values()), "errors": errs,
              "ties_bitwise": True, "out_of_range_ids": "NaN, every row",
              **{key: big[key] for key in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")},
              "timings": timings, "crossover_ms": crossover,
              "timing": "CUDA events, median of 20 runs of back-to-back "
                        "launches queued behind a busy card; bank warm in L2"}
    emit(result)
    return result


# ---------------------------------------------------------------- phase 3
GROUP = ("m1", "m2", "m3")
N_TENANTS = 64
WINDOW = 1024
N_WINDOWS = 10


def _serve_setup(dev):
    """(world, server factory, windows) of the serve phase; the engine
    phase serves the same configuration tiered."""
    import dataclasses

    import numpy as np
    from repro_torch.core.routing import (
        Condition, Intent, RoutingTable, ScoringRule, ShadowRule)
    from repro_torch.experiments.fraud_world import FraudWorld
    from repro_torch.serving.server import MuseServer, ServerConfig
    from repro_torch.serving.types import ScoringRequest
    from repro_torch.training.data import FraudEventStream, TenantProfile

    world = FraudWorld.build(seed=0)
    rng = np.random.default_rng(1)
    streams = [FraudEventStream(TenantProfile(
        f"tenant{i:02d}", fraud_rate=float(rng.uniform(0.002, 0.02)),
        feature_shift=float(rng.uniform(-0.3, 0.5)), seed=1000 + i))
        for i in range(N_TENANTS)]
    specs = [world.predictor_spec(f"p{i}", GROUP, world.custom_quantile_map(
        GROUP, s.sample(4096)[0])) for i, s in enumerate(streams)]
    cand = dataclasses.replace(
        world.predictor_spec("cand", GROUP, world.custom_quantile_map(
            GROUP, world.client.sample(4096)[0])), weights=(2.0, 1.0, 1.0))
    routing = RoutingTable(
        tuple(ScoringRule(Condition(tenants=(f"tenant{i:02d}",)), f"p{i}")
              for i in range(N_TENANTS)),
        (ShadowRule(Condition(tenants=tuple(f"tenant{i:02d}"
                                            for i in range(8))), ("cand",)),),
        version="v1")

    def server(fused: bool, **config) -> MuseServer:
        s = MuseServer(routing, ServerConfig(fused_kernel=fused, **config),
                       device=dev)
        factories = world.model_factories(dev)
        for spec in specs + [cand]:
            s.deploy(spec, factories)
        return s

    feats = [s.sample(N_WINDOWS * WINDOW)[0] for s in streams]
    tenants = rng.integers(0, N_TENANTS, (N_WINDOWS, WINDOW))
    windows = [[ScoringRequest(Intent(tenant=f"tenant{t:02d}"),
                               feats[t][w * WINDOW + j],
                               request_id=w * WINDOW + j)
                for j, t in enumerate(tenants[w])] for w in range(N_WINDOWS)]
    return world, server, windows


def _live_bank(server):
    """(predictor names, bank) of the server's largest cached bank."""
    key = max(server.plane.banks, key=len)
    return key, server.plane.banks[key].bank


def _drive(server, windows, refresh):
    """Score every window, publishing ``refresh(server)`` after the middle
    one; returns per-window responses and host seconds per window."""
    out, secs = [], []
    for w, reqs in enumerate(windows):
        t0 = time.perf_counter()
        out.append(server.score_batch(reqs))
        secs.append(time.perf_counter() - t0)
        if w == N_WINDOWS // 2 - 1:
            refresh(server)
    return out, secs


def _stage_ms(server, reqs, reps: int = 5) -> dict:
    """Median host milliseconds of each stage of one single-group window,
    run as ``score_batch`` runs them, each stage ended by a device sync."""
    import numpy as np
    import torch

    samples: dict[str, list[float]] = {}
    for _ in range(reps):
        marks = [("start", time.perf_counter())]

        def mark(name):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))

        plane = server.plane
        res = [server.routing.resolve(r.intent) for r in reqs]
        mark("route")
        idxs, names, cache = list(range(len(reqs))), [r.live for r in res], {}
        raws = server.run_models(reqs, idxs, names, cache, plane)
        mark("run_models")
        scores, bank, tid = server.apply_transforms(raws, names, plane)
        mark("apply_transforms")
        server.build_responses(reqs, idxs, names, scores, raws, bank,
                               server.routing.version, 0.0)
        mark("build_responses")
        server.track(reqs, idxs, names, raws, bank, tid)
        mark("track")
        server._run_shadows(reqs, res, cache, plane)
        mark("shadows")
        for (_, a), (name, b) in zip(marks, marks[1:]):
            samples.setdefault(name, []).append((b - a) * 1e3)
    return {name: float(np.median(v)) for name, v in samples.items()}


def _same_snapshots(name, want: dict, got: dict) -> None:
    """Estimator checkpoint snapshots equal: meta exactly, the live
    prefixes of the reservoir and the recent ring bitwise."""
    import numpy as np

    check(want.keys() == got.keys() and len(want) > 0, f"{name}: streams")
    for key, (arrays, meta) in want.items():
        check(got[key][1] == meta, f"{name}: {key} meta")
        for arr, live in (("buf", meta["filled"]),
                          ("recent", meta["recent_filled"])):
            check(np.array_equal(got[key][0][arr][:live], arrays[arr][:live]),
                  f"{name}: {key} {arr} not bitwise equal")


def _device_tracking(make_server, windows, refresh, resp, eager) -> dict:
    """Fused device tracking at staging 4,096 (nothing drained before the
    snapshot) and 64 (spills) against the eager server, over the same
    windows: responses bitwise equal, and after the tracker's sync the
    estimator snapshots bitwise equal."""
    want = eager.snapshot_estimator_checkpoints()
    out = {}
    for staging in (4096, 64):
        server = make_server(True, track_device=True, track_staging=staging)
        got, secs = _drive(server, windows, refresh)
        for w, (a, b) in enumerate(zip(resp, got)):
            check([(r.score, r.predictor, r.bank_generation) for r in a] ==
                  [(r.score, r.predictor, r.bank_generation) for r in b],
                  f"staging {staging}, window {w}: responses bitwise equal "
                  "to the eager server's")
        tracker = server._tracker
        pending = tracker.pending_total()
        if staging == 4096:
            check(pending > 0 and tracker.spills == 0,
                  f"staging 4096: {pending} pending, {tracker.spills} "
                  "spills before the sync")
        else:
            check(tracker.spills > 0, "staging 64 spills")
        drains = tracker.drains
        t0 = time.perf_counter()
        snap = server.snapshot_estimator_checkpoints()
        sync_ms = (time.perf_counter() - t0) * 1e3
        _same_snapshots(f"staging {staging}", want, snap)
        check(tracker.pending_total() == 0, "the snapshot drained the plane")
        out[str(staging)] = {
            "pending_before_sync": pending, "spills": tracker.spills,
            "host_fallbacks": tracker.host_fallbacks,
            "appends": tracker.appends, "drains_before_sync": drains,
            "drains": tracker.drains, "snapshot_ms": sync_ms,
            "staged_windows": server.metrics["track_staged_windows"],
            "events_per_s": (N_WINDOWS - 1) * WINDOW / sum(secs[1:]),
            "stage_ms": _stage_ms(server, windows[-1])}
    return out


def phase_serve(dev, setup) -> tuple[dict, dict]:
    import numpy as np
    import torch
    from repro_torch.kernels import ops

    world, make_server, windows = setup
    fused, plain = make_server(True), make_server(False)
    before = {}

    def refresh(server):
        # T^Q_v1 for tenant00's predictor, fitted on the fused server's live
        # stream, published to both servers; the bank it replaces is kept
        if "qm" not in before:
            before["qm"] = server.fit_custom_quantile_map(
                "tenant00", "p0", world.ref_quantiles)
            before["key"], before["bank"] = _live_bank(server)
        server.publish_quantile_maps({"p0": before["qm"]})

    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    resp, secs = _drive(fused, windows, refresh)
    launches = dict(ops.LAUNCHES)
    metrics = dict(fused.metrics)
    resp_plain, secs_plain = _drive(plain, windows, refresh)

    check(launches["score_pipeline_banked"] == metrics["kernel_dispatches"]
          > 0, f"launches {launches} == kernel_dispatches "
          f"{metrics['kernel_dispatches']}")
    half = N_WINDOWS // 2
    err = 0.0
    for w, (reqs, a, b) in enumerate(zip(windows, resp, resp_plain)):
        sa = np.array([r.score for r in a])
        sb = np.array([r.score for r in b])
        check(bool(np.isfinite(sa).all() and (sa >= 0).all()
                   and (sa <= 1).all()), f"window {w}: scores in [0, 1]")
        check([r.predictor for r in a] ==
              [f"p{int(q.intent.tenant[6:])}" for q in reqs],
              f"window {w}: predictors as routed")
        gens = {r.bank_generation for r in a}
        check(gens == {0 if w < half else 1}, f"window {w}: generation {gens}")
        err = max(err, float(np.abs(sa - sb).max()))
    check(err <= TOL, f"fused vs plain max abs err {err}")

    # the refresh changed tenant00's scores: its rows after the publish,
    # rescored under the replaced bank, come out different
    rows = [r for w in range(half, N_WINDOWS)
            for q, r in zip(windows[w], resp[w])
            if q.intent.tenant == "tenant00"]
    check(len(rows) > 0, "tenant00 has traffic after the refresh")
    key, old_bank = before["key"], before["bank"]
    raws = torch.tensor([r.raw_scores for r in rows], device=dev)
    idx = torch.full((len(rows),), key.index("p0"), dtype=torch.int32,
                     device=dev)
    old = old_bank(raws, idx).cpu().numpy()
    moved = float(np.abs(old - np.array([r.score for r in rows])).max())
    check(moved > 1e-4, f"refreshed T^Q moved tenant00's scores ({moved})")

    tracking = _device_tracking(make_server, windows, refresh, resp, fused)
    lat = np.array(secs[1:]) * 1e3
    stages = _stage_ms(fused, windows[-1])
    result = {
        "phase": "serve", "windows": N_WINDOWS, "window_requests": WINDOW,
        "tenants": N_TENANTS, "experts": len(GROUP),
        "launches": launches, "metrics": metrics,
        "max_abs_err_vs_plain": err, "refresh_max_score_change": moved,
        "events_per_s": (N_WINDOWS - 1) * WINDOW / sum(secs[1:]),
        "p50_window_ms": float(np.percentile(lat, 50)),
        "p99_window_ms": float(np.percentile(lat, 99)),
        "first_window_ms": secs[0] * 1e3,
        "plain_events_per_s": (N_WINDOWS - 1) * WINDOW / sum(secs_plain[1:]),
        "timing": "host clock per score_batch window (ends in a device "
                  "sync), first window excluded",
        "stage_ms": stages,
        "track_ms": {"eager": stages["track"],
                     **{f"device_{k}": v["stage_ms"]["track"]
                        for k, v in tracking.items()}},
        "device_tracking": tracking,
        "bank_generation": metrics["bank_generation"],
        "shadow_records": metrics["shadow_evals"]}
    emit(result)

    # the main path's own kernel shapes: the live bank and a live window
    key, bank = _live_bank(fused)
    last = resp[-1]
    row_of = {n: i for i, n in enumerate(key)}
    main = {"raws": torch.tensor([r.raw_scores for r in last], device=dev),
            "idx": torch.tensor([row_of[r.predictor] for r in last],
                                dtype=torch.int32, device=dev),
            "bank": (bank.betas, bank.weights, bank.src_quantiles,
                     bank.ref_quantiles)}
    return result, main


# ---------------------------------------------------------------- phase 4
# The model-update lifecycle (paper Fig. 3) on two replicas of the card.
LIFECYCLE = dict(
    tenants=32,          # calibrated tenants, each on its own predictor
    audited=8,           # of them, with a client decision loop + audit log
    events=4_000,        # per tenant and traffic phase
    window=1_024,        # mixed-tenant requests a dispatch
    big=32_768,          # phase C's last window: the shared-memory path
    onboard=250,         # the onboarding tenant's events a phase
    rollout_batches=3)   # windows between two rollout transitions
LC_ALERT = 0.02          # the client's alert rate a, and the Eq.-5 target
LC_REL_ERROR = 0.3       # Eq.-5 delta (gate ~2.1k events a stream)
LC_BAND = 0.012          # +-1.2 pp: the reference's headline invariant
COLD_KNOTS = 128         # the cold-start prior's table; refits have 256
OLD, NEW = ("m1", "m2"), ("m1", "m2", "m3")


class _Recorder:
    """What the load balancer sent and answered, in dispatch order."""

    def __init__(self):
        self.sent: list[int] = []
        self.responses: list = []
        self.windows: list[tuple[str, list, list]] = []   # (phase, reqs, resp)
        # (phase, replica id, requests, host ms) of each dispatch
        self.timings: list[tuple[str, int, int, float]] = []


def _lifecycle_world(dev, sizes):
    """FraudWorld with the retrained third expert, 32 tenant feeds plus an
    onboarding tenant, and the cold-start prior at ``COLD_KNOTS`` knots."""
    import numpy as np
    from repro_torch.core.coldstart import (default_quantile_map,
                                            fit_beta_mixture)
    from repro_torch.experiments.fraud_world import FraudWorld, train_expert
    from repro_torch.training.data import FraudEventStream, TenantProfile

    world = FraudWorld.build(n_experts=2, betas=(0.18, 0.18), seed=17,
                             client_shift=0.3)
    world.experts["m3"] = train_expert(FraudEventStream(TenantProfile(
        "train-pool", fraud_rate=0.01, feature_shift=0.3, seed=303)),
        "m3", 0.02, mask_seed=33)
    n = sizes["tenants"]
    tenants = [f"bank{i:02d}" for i in range(n)] + ["bank-new"]
    feeds = {t: FraudEventStream(TenantProfile(
        t, fraud_rate=0.006 + 0.003 * (i % 3),
        feature_shift=0.25 + 0.06 * (i % 3), seed=500 + i))
        for i, t in enumerate(tenants)}
    # the Beta-mixture prior of world.coldstart_quantile_map, on a coarser
    # table: every bank that mixes it with a 256-knot refit pads it
    x, y = world.train_tenant.sample(60_000)
    fit = fit_beta_mixture(world.ensemble_aggregated(OLD, x),
                           fraud_prior=float(np.mean(y)), n_trials=1, seed=7)
    ref = np.interp(np.linspace(0, 1, COLD_KNOTS),
                    np.linspace(0, 1, len(world.ref_quantiles)),
                    world.ref_quantiles)
    cold = default_quantile_map(fit, ref)
    return world, tenants, feeds, cold


def _lifecycle_windows(feeds, tenants, sizes, rng, ids, *, big=False):
    """One traffic phase: ``events`` per calibrated tenant and ``onboard``
    for the onboarding one, shuffled into mixed windows of ``window``
    requests (with ``big``, the last ``big`` requests form one window)."""
    import numpy as np
    from repro_torch.core.routing import Intent
    from repro_torch.serving.types import ScoringRequest

    rows = []
    for t in tenants:
        n = sizes["onboard"] if t == "bank-new" else sizes["events"]
        rows.extend((t, x) for x in feeds[t].sample(n)[0])
    reqs = [ScoringRequest(Intent(tenant=rows[i][0]), rows[i][1],
                           request_id=next(ids))
            for i in rng.permutation(len(rows))]
    cut = len(reqs) - sizes["big"] if big else len(reqs)
    out = [reqs[i:min(i + sizes["window"], cut)]
           for i in range(0, cut, sizes["window"])]
    return out + ([reqs[cut:]] if big else [])


def phase_lifecycle(dev, sizes: dict | None = None) -> dict:
    """The Fig.-3 lifecycle through the port's entry points: 32 tenants on
    two replicas (one with fused device tracking), a fleet calibration
    plane, a rolling promotion {m1,m2} -> {m1,m2,m3} with stale maps, a
    fleet refresh, client decisions audited and replayed bit for bit
    through the banked kernel."""
    import copy
    import dataclasses
    import itertools

    import numpy as np
    import torch
    from repro_torch.core.routing import (Condition, RoutingTable,
                                          ScoringRule)
    from repro_torch.core.quantiles import StreamingQuantileEstimator
    from repro_torch.core.transforms import (TransformBank,
                                             banked_score_pipeline)
    from repro_torch.experiments.fraud_world import DIM
    from repro_torch.kernels import ops
    from repro_torch.kernels import score_pipeline as sp
    from repro_torch.serving import (AuditLog, DecisionLoop, DecisionPolicy,
                                     FleetCalibrationController,
                                     GenerationLedger, MuseServer,
                                     RefreshPolicy, Replica, ReplicaSet,
                                     RollingUpdate, ServerConfig)
    from repro_torch.serving.drift import realized_alert_rate

    sizes = {**LIFECYCLE, **(sizes or {})}
    t_start = time.perf_counter()
    # the host's cyclic garbage collector: the run keeps every response,
    # decision and audit entry alive, and a full collection walks them all
    pauses: list[tuple[int, float]] = []
    started: dict[str, float] = {}

    def on_gc(stage, info):
        if stage == "start":
            started["t"] = time.perf_counter()
        elif "t" in started:
            pauses.append((info["generation"],
                           (time.perf_counter() - started.pop("t")) * 1e3))

    gc.callbacks.append(on_gc)
    world, tenants, feeds, cold = _lifecycle_world(dev, sizes)
    calibrated = tenants[:-1]
    audited = set(calibrated[:sizes["audited"]]) | {"bank-new"}
    factories = world.model_factories(dev)
    device_servers: list = []

    def make_server(version: str, group: tuple[str, ...], device: bool):
        """A replica's server: every tenant on its own predictor of
        ``group`` with the cold prior, tracking on the device (staging
        4,096; the windows it scores are kept) or eagerly."""
        routing = RoutingTable(tuple(
            ScoringRule(Condition(tenants=(t,)), f"{version}-{t}")
            for t in tenants), version=version)
        server = MuseServer(routing, ServerConfig(
            track_device=device, track_staging=4096,
            refresh_alert_rate=LC_ALERT, refresh_rel_error=LC_REL_ERROR),
            device=dev)
        for t in tenants:
            server.deploy(world.predictor_spec(f"{version}-{t}", group, cold),
                          factories)
        if device:
            device_servers.append(server)
            served = server.served_windows = []
            inner = server.score_batch

            def score_batch(requests):
                served.append(list(requests))
                return inner(requests)

            server.score_batch = score_batch
        return server

    rec = _Recorder()
    log, ledger = AuditLog(), GenerationLedger(device=dev)
    loop = DecisionLoop(DecisionPolicy(alert_rate=LC_ALERT),
                        world.ref_quantiles, audit=log)
    current = ["A_cold"]

    class Fleet(ReplicaSet):
        """The load balancer: every dispatch is one client stream (the
        payment gateway), fenced; the audited tenants' decisions are made
        and logged, and every window is kept."""

        def dispatch(self, requests, stream=None):
            served = {r.replica_id: r.served for r in self.replicas}
            t0 = time.perf_counter()
            resp = super().dispatch(requests, stream=stream or "gateway")
            ms = (time.perf_counter() - t0) * 1e3
            rid = next(r.replica_id for r in self.replicas
                       if r.served != served.get(r.replica_id, 0))
            rec.timings.append((current[0], rid, len(requests), ms))
            check([r.request_id for r in resp] ==
                  [q.request_id for q in requests],
                  f"{current[0]}: responses in request order")
            rec.sent.extend(q.request_id for q in requests)
            rec.responses.extend(resp)
            rec.windows.append((current[0], requests, resp))
            pairs = [(q, r) for q, r in zip(requests, resp)
                     if q.intent.tenant in audited]
            loop.process([q for q, _ in pairs], [r for _, r in pairs])
            return resp

    rs = Fleet([Replica(i, make_server("v1", OLD, i == 0), "v1", ready=True)
                for i in range(2)])
    fleet = FleetCalibrationController(
        rs, world.ref_quantiles,
        RefreshPolicy(alert_rate=LC_ALERT, rel_error=LC_REL_ERROR))
    recorded: set[tuple[int, int]] = set()

    def record_fleet():
        """Archive what every ready replica serves, once per generation."""
        for rep in rs.ready_replicas:
            key = (id(rep.server), rep.server.bank_generation)
            if key not in recorded:
                ledger.record_server(rep.server)
                recorded.add(key)

    def serve(reqs):
        record_fleet()
        rs.dispatch(reqs)
        return rec.timings[-1][3]

    rng = np.random.default_rng(18)
    ids = itertools.count()
    phases: dict[str, dict] = {}
    windows_launches = 0

    def traffic_phase(phase, *, big=False):
        nonlocal windows_launches
        current[0] = phase
        wins = _lifecycle_windows(feeds, tenants, sizes, rng, ids, big=big)
        before = ops.LAUNCHES["score_pipeline_banked"]
        ms = [serve(w) for w in wins]
        windows_launches += ops.LAUNCHES["score_pipeline_banked"] - before
        n = len(wins) - (1 if big else 0)
        lat = np.array(ms[1:n])
        phases[phase] = {
            "windows": len(wins), "events": sum(map(len, wins)),
            "events_per_s": sum(map(len, wins[1:n])) / lat.sum() * 1e3,
            "p50_window_ms": float(np.percentile(lat, 50)),
            "p99_window_ms": float(np.percentile(lat, 99)),
            "max_window_ms": float(lat.max())}
        if big:
            phases[phase]["big_window"] = {
                "requests": len(wins[-1]), "ms": ms[-1],
                "events_per_s": len(wins[-1]) / ms[-1] * 1e3}

    def refresh_times(res):
        return {"fleet_generation": res.fleet_generation,
                "refreshed": len(res.refreshed),
                "rejected": len(res.rejected),
                "not_ready": len(res.not_ready),
                "acked": list(res.acked), "nacked": list(res.nacked),
                "merged_streams": res.merged_streams,
                **{k: getattr(res, k) for k in (
                    "merge_seconds", "refit_seconds", "validate_seconds",
                    "publish_seconds")}}

    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    refreshes = {}
    # A (cold): the prior serves while every stream passes the Eq.-5 gate
    traffic_phase("A_cold")
    res = fleet.refresh_fleet()
    check(len(res.refreshed) == len(calibrated) and not res.nacked,
          f"first fleet refresh: {len(res.refreshed)} refreshed, "
          f"{[r.reasons for r in res.rejected]}")
    refreshes["after_A_cold"] = refresh_times(res)
    # A: calibrated v1, the pre-update baseline
    traffic_phase("A")

    # promotion: v2 ships with the stale prior, one fleet pass per surge
    n_cal = len(calibrated)
    one_window = {**sizes, "events": sizes["window"] // n_cal - 1,
                  "onboard": n_cal}

    def rollout_traffic():
        while True:
            for w in _lifecycle_windows(feeds, tenants, one_window, rng,
                                        ids):
                record_fleet()
                yield w

    v2_device = itertools.cycle((True, False))
    update = RollingUpdate(rs, lambda: make_server("v2", NEW,
                                                   next(v2_device)),
                           "v2", schema_dim=DIM,
                           warmup_batch_sizes=(1, sizes["window"]),
                           fleet_calibration=fleet)
    current[0] = "rollout"
    before = ops.LAUNCHES["score_pipeline_banked"]
    t0 = time.perf_counter()
    timeline = update.run_with_traffic(
        rollout_traffic(), batches_per_transition=sizes["rollout_batches"])
    rollout_s = time.perf_counter() - t0
    windows_launches += ops.LAUNCHES["score_pipeline_banked"] - before
    check([r.version for r in rs.replicas] == ["v2", "v2"],
          f"rollout ends on v2: {[r.version for r in rs.replicas]}")
    refreshes["rollout"] = [refresh_times(r) for r in update.refreshes]

    # B: the new ensemble on its stale maps; then one fleet refresh
    traffic_phase("B_stale")
    res = fleet.refresh_fleet()
    refreshed = {r.tenant for r in res.refreshed
                 if r.predictor == f"v2-{r.tenant}"}
    check(set(calibrated) <= refreshed and res.acked == tuple(
        str(r.replica_id) for r in rs.replicas),
        f"v2 refresh: {len(refreshed)} refreshed, acked {res.acked}, "
        f"{[(r.tenant, r.reasons) for r in res.rejected]}")
    refreshes["after_B"] = refresh_times(res)
    # C: refreshed v2, its last window one of ``big`` rows
    traffic_phase("C", big=True)
    record_fleet()
    launches = dict(ops.LAUNCHES)
    check(launches["score_pipeline_banked"] == windows_launches > 0,
          f"lifecycle windows launched the banked kernel: {launches}")

    # 1. the headline invariant: alert rates at the fixed client threshold
    by_phase: dict[str, dict[str, list]] = {}
    for phase, reqs, resp in rec.windows:
        for q, r in zip(reqs, resp):
            by_phase.setdefault(phase, {}).setdefault(
                q.intent.tenant, []).append(r.score)
    rates = {phase: {t: realized_alert_rate(np.asarray(s),
                                            world.ref_quantiles, LC_ALERT)
                     for t, s in per.items()}
             for phase, per in by_phase.items()}
    for phase in ("A", "C"):
        off = {t: rates[phase][t] for t in calibrated
               if abs(rates[phase][t] - LC_ALERT) > LC_BAND}
        check(not off, f"phase {phase}: alert rates off a by > 1.2 pp: {off}")

    # 2. fleet-monotone generations, no request lost or repeated
    check(not rs.fleet_generation().divergent, "fleet divergent after run")
    gens = [r.bank_generation for r in rec.responses]
    check(gens == sorted(gens), "generations monotone on the gateway stream")
    per_tenant: dict[str, list[int]] = {}
    for phase, reqs, resp in rec.windows:
        for q, r in zip(reqs, resp):
            per_tenant.setdefault(q.intent.tenant, []).append(
                r.bank_generation)
    check(all(g == sorted(g) for g in per_tenant.values()),
          "generations monotone per tenant")
    got_ids = [r.request_id for r in rec.responses]
    check(len(got_ids) == len(set(got_ids)) == len(rec.sent)
          and sorted(got_ids) == sorted(rec.sent),
          f"request ids: {len(rec.sent)} sent, {len(got_ids)} answered, "
          f"{len(set(got_ids))} distinct")

    # 3. every response against the plain banked version on the CPU, from
    # its stamped generation's archived parameters
    groups: dict[tuple[int, int], list] = {}
    for r in rec.responses:
        groups.setdefault((r.bank_generation, len(r.raw_scores)),
                          []).append(r)
    plain_err = 0.0
    for (gen, _), resp in groups.items():
        names = sorted({r.predictor for r in resp})
        row = {n: i for i, n in enumerate(names)}
        params = [ledger.params(gen, n) for n in names]
        check(all(p is not None for p in params),
              f"generation {gen} archived for every predictor served")
        bank = TransformBank.from_params(
            [tuple(torch.from_numpy(a) for a in p) for p in params],
            device="cpu")
        want = banked_score_pipeline(
            torch.tensor([r.raw_scores for r in resp], dtype=torch.float32),
            torch.tensor([row[r.predictor] for r in resp]), bank.betas,
            bank.weights, bank.src_quantiles, bank.ref_quantiles).numpy()
        got = np.array([r.score for r in resp], np.float32)
        check(bool(np.isfinite(got).all()), f"generation {gen}: finite")
        plain_err = max(plain_err, float(np.abs(got - want).max()))
    check(plain_err <= TOL, f"served vs plain banked version: {plain_err}")

    # 4. every audited decision replayed bit for bit through the kernel
    entries = [json.loads(e.payload) for e in log.entries]
    big_ids = {q.request_id for q in rec.windows[-1][1]}
    big_bank = max(device_servers[-1].plane.banks.values(),
                   key=lambda e: e.bank.num_rows).bank
    big_path = sp.banked_path(big_bank.num_rows, big_bank.num_quantiles,
                              len(big_ids), *sp.card(dev))
    check(big_path == "shared", f"the {len(big_ids)}-row window's path: "
          f"{big_path}")
    widest: dict[tuple[int, str], int] = {}
    for (gen, name), row in ledger._rows.items():
        key = (gen, name.split("-")[0])
        widest[key] = max(widest.get(key, 0), row[2].shape[0])
    padded = sum(1 for e in entries if ledger.params(
        e["bank_generation"], e["predictor"])[2].shape[0] < widest[
            (e["bank_generation"], e["predictor"].split("-")[0])])
    n_gens = len({e["bank_generation"] for e in entries})
    n_big = sum(1 for e in entries if e["request_id"] in big_ids)
    check(n_gens >= 3 and n_big > 0 and padded > 0,
          f"audit covers {n_gens} generations, {n_big} big-window rows, "
          f"{padded} padded rows")
    before = ops.LAUNCHES["score_pipeline_banked"]
    t0 = time.perf_counter()
    verdict = log.verify(ledger, expected_head=log.head(),
                         expected_length=len(log), fused=True)
    verify_s = time.perf_counter() - t0
    replay_launches = ops.LAUNCHES["score_pipeline_banked"] - before
    check(verdict.ok, f"audit replay: {len(verdict.failures)} failures, "
          f"first {verdict.failures[:3]}")
    check(verdict.replayed == len(log) == replay_launches,
          f"{verdict.replayed} replayed, {len(log)} entries, "
          f"{replay_launches} kernel launches")

    # 5. one flipped payload byte fails the chain at its index
    tampered = copy.copy(log)
    tampered.entries = list(log.entries)
    at = len(log) // 2
    e = log.entries[at]
    pos = e.payload.index('"score":') + 9
    tampered.entries[at] = dataclasses.replace(
        e, payload=e.payload[:pos] + chr(ord(e.payload[pos]) ^ 1)
        + e.payload[pos + 1:])
    bad = tampered.verify()
    check(not bad.ok and [f.index for f in bad.failures
                          if f.kind == "chain"] == [at],
          f"tampered entry {at}: {bad.failures[:3]}")

    # 6. the device-tracking replica's estimators are eager tracking's:
    # the same windows through an eager twin give the same snapshots
    dev_server = device_servers[-1]
    dev_rep = next(r for r in rs.replicas if r.server is dev_server)
    other = next(r for r in rs.replicas if r is not dev_rep)
    twin = make_server("v2", NEW, False)
    mine = dev_server.served_windows
    check(dev_server._tracker is not None and twin._tracker is None
          and len(mine) > 0, "one device-tracking v2 replica, eager twin")
    for reqs in mine:
        twin.score_batch(reqs)
    snap = dev_server.snapshot_estimator_checkpoints()
    _same_snapshots("device replica vs eager twin",
                    twin.snapshot_estimator_checkpoints(), snap)
    rest = other.server.snapshot_estimator_checkpoints()
    twin_snap = twin.snapshot_estimator_checkpoints()
    for key in snap:
        parts = [p for p in (rest.get(key),) if p is not None]
        a = StreamingQuantileEstimator.merge_checkpoints([snap[key], *parts])
        b = StreamingQuantileEstimator.merge_checkpoints([twin_snap[key],
                                                          *parts])
        check(a.count == b.count and np.array_equal(a.values(), b.values()),
              f"merged {key}: device replica's fit differs from eager")

    gc.callbacks.remove(on_gc)
    full = [ms for g, ms in pauses if g == 2]
    peak = max(ms for phase, _, _, ms in rec.timings if phase == "rollout")
    # the slowest windows of ``window`` requests, with the replica that
    # served them and how many windows that replica had served before
    seen: dict[int, int] = {}
    slow = []
    for phase, rid, n, ms in rec.timings:
        if n <= sizes["window"]:
            slow.append((ms, phase, rid, seen.get(rid, 0)))
        seen[rid] = seen.get(rid, 0) + 1
    slow = [{"ms": ms, "phase": phase, "replica": rid,
             "replica_windows_before": k}
            for ms, phase, rid, k in sorted(slow, reverse=True)[:8]]
    result = {
        "phase": "lifecycle", "seconds": time.perf_counter() - t_start,
        "tenants": len(calibrated), "onboarding_tenants": 1,
        "bank_rows": big_bank.num_rows, "audited_tenants": len(audited),
        "replicas": len(rs.replicas), "traffic": phases,
        "alert_rates": {p: {"min": min(v[t] for t in calibrated),
                            "max": max(v[t] for t in calibrated)}
                        for p, v in rates.items()},
        "refreshes": refreshes,
        "rollout": {"seconds": rollout_s, "windows": len(timeline),
                    "min_ready": min(t["ready_count"] for t in timeline),
                    "max_pods": max(t["pod_count"] for t in timeline),
                    "max_window_ms": peak,
                    "phase_A_p99_window_ms": phases["A"]["p99_window_ms"],
                    "events": [(e.kind, e.replica_id, e.pod_count)
                               for e in update.events]},
        "slowest_windows": slow,
        "gc_full_collections": {
            "count": len(full), "max_ms": max(full, default=0.0),
            "total_ms": sum(full)},
        "generations": sorted(ledger.generations()),
        "launches": {"windows": windows_launches,
                     "replays": replay_launches},
        "replays": verdict.replayed, "replay_seconds": verify_s,
        "replays_big_window": n_big, "replays_padded": padded,
        "big_window_path": big_path,
        "max_abs_err_vs_plain": plain_err,
        "device_tracking": {"windows": len(mine),
                            "drains": dev_server._tracker.drains,
                            "spills": dev_server._tracker.spills},
        "timing": "host clock around ReplicaSet.dispatch (the client's "
                  "decision loop outside it); events/s over the windows "
                  "of ``window`` requests after a phase's first"}
    emit(result)
    return result


# ---------------------------------------------------------------- phase 5
ENGINE_TIERS = (16, 15)   # hot slots, victim slots of the tiered serve run


def _engine_tiered(setup) -> dict:
    """The serve phase's server (64 tenants, the FraudWorld ensemble, a
    shadow candidate) tiered at 16 hot and 15 victim slots, fed its ten
    windows through an ``AsyncDispatchEngine`` of 1,024-request windows
    (the tiers rebalanced after the first): every response bitwise equal to
    the dense server's over the same windows, sync.  The banked launches
    are counted from just after the dense server has scored, and held to
    the tiered stores' dispatches plus extra passes."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import AsyncDispatchEngine
    from repro_torch.serving.tiering import TieringConfig

    _, make_server, windows = setup
    dense = make_server(True)
    want = {r.request_id: (r.score, r.predictor, r.bank_generation)
            for reqs in windows for r in dense.score_batch(reqs)}
    hot, victims = ENGINE_TIERS
    tiered = make_server(True, tiering=TieringConfig(
        hot_capacity=hot, victim_capacity=victims))
    engine = AsyncDispatchEngine(tiered, max_batch=WINDOW, max_wait_ms=1e9)
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    engine.submit_many(windows[0])
    out = engine.drain(timeout=300.0)
    tiered.rebalance_tiers()
    t1 = time.perf_counter()
    for reqs in windows[1:]:
        engine.submit_many(reqs)
    out += engine.drain(timeout=300.0)
    t2 = time.perf_counter()
    launches = dict(ops.LAUNCHES)
    errors = list(engine.errors)
    prefetch_errors = engine.prefetch_errors
    engine.close()
    check(not errors and not prefetch_errors,
          f"tiered engine stage errors: {errors[:3]}")
    got = {r.request_id: (r.score, r.predictor, r.bank_generation)
           for r in out}
    check(got == want, "tiered engine responses bitwise equal to the dense "
          "server's")
    m = tiered.tier_metrics()
    check(m["prefetched_rows"] > 0, "the engine prefetched tier rows")
    passes = m["dispatches"] + m["extra_passes"]
    check(launches["score_pipeline_banked"] == passes > 0,
          f"the tiered engine run launched the banked kernel "
          f"{launches['score_pipeline_banked']} times for {passes} passes")
    stores = tiered.tiered_stores()
    store = stores[max(stores, key=len)]
    return {"tenants": N_TENANTS, "hot": hot, "victims": victims,
            "launches": launches,
            "windows": N_WINDOWS, "window_requests": WINDOW,
            "responses": len(out), "bitwise_vs_dense": True,
            "device_bytes": store.device_bytes,
            "host_bytes": store.host_bytes,
            "events_per_s_after_rebalance":
                (N_WINDOWS - 1) * WINDOW / (t2 - t1),
            "first_window_s": t1 - t0, "tier_metrics": m}


def phase_engine(dev, setup) -> dict:
    """The async dispatch engine (``serving/engine.py``) on the card: the
    port's ``bench_async_engine`` at the reference's sizes (five runs, each
    response bitwise its raw scores replayed through the banked kernel,
    every event tracked), then the tiered serve-phase server through the
    engine against the dense server.  Launches: each run of the benchmark
    counts its timed stream's (held there to its windows), the tiered run
    its own."""
    from repro_torch.benchmarks import bench_async_engine
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    bench = bench_async_engine.run(device=dev)
    check(all(n > 0 for n in bench["launches"].values()),
          f"every engine run launched the banked kernel: "
          f"{bench['launches']}")
    tiered = _engine_tiered(setup)
    launches = {**bench["launches"],
                "tiered": tiered["launches"]["score_pipeline_banked"]}
    result = {"phase": "engine", "launches": launches, "bench": bench,
              "tiered": tiered, "wall_s": time.perf_counter() - t0}
    emit(result)
    return result


# ---------------------------------------------------------------- phase 6
TIER_DEVICE_BYTES = 1_064_960       # (384 + 127 + 1) x (2·4 + 2·256) x 4
TIER_HOST_BYTES_AT_MAX = 2_080_000_000   # 10^6 x (2·4 + 2·256) x 4


def phase_tiering(dev) -> dict:
    """The tiered bank store (``serving/tiering.py``) on the card: the
    port's ``bench_tiered_bank`` at the reference's sizes — bitwise parity
    with the dense bank at 1,024 tenants, the sweep to 10^6 tenants, the
    stall rates with and without prefetch, the staging p99 under churn.
    Launches: the tiered stores' dispatches only (the benchmark counts them
    and holds them to their passes), not its dense bank's."""
    from repro_torch.benchmarks import bench_tiered_bank
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    bench = bench_tiered_bank.run(device=dev)
    launches = {"score_pipeline_banked": bench["dispatch_launches"]}
    check(bench["dispatch_launches"] == bench["dispatch_passes"] > 0,
          f"the tiered stores launched the banked kernel "
          f"{bench['dispatch_launches']} times for "
          f"{bench['dispatch_passes']} passes")
    rows = bench["rows"]
    check(all(r["device_bytes"] == TIER_DEVICE_BYTES for r in rows),
          f"device bytes {[r['device_bytes'] for r in rows]}")
    check(rows[-1]["tenants"] == 1_000_000
          and rows[-1]["host_bytes"] == TIER_HOST_BYTES_AT_MAX,
          f"host bytes at 10^6 tenants: {rows[-1]['host_bytes']}")
    result = {"phase": "tiering", "launches": launches, "bench": bench,
              "wall_s": time.perf_counter() - t0}
    emit(result)
    return result


# ---------------------------------------------------------------- phase 7
SHARD_DENSE_BYTES = {256: 532_480, 1024: 2_129_920, 4096: 8_519_680}
SHARD_S8_BYTES = {256: 66_560, 1024: 266_240, 4096: 1_064_960}
SERVE_SHARDS = (4, 8)
SHARD_TIERS = (4, 3)      # hot, victim slots a shard of the composed run
EMPTY_SHARD = 5           # the shard the uneven assignment leaves empty


def _sharded_uneven(dev) -> list[dict]:
    """The dispatcher at the benchmark's sizes on a skewed assignment over
    8 shards that leaves one empty: bitwise the dense launch (the
    benchmark's ``sharded_row`` raises otherwise), one launch a call."""
    import numpy as np
    import torch
    from repro_torch.benchmarks import bench_sharded_bank as bsb
    from repro_torch.core.transforms import ShardedTransformBank
    from repro_torch.device import to_numpy
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_tenant_mesh
    from repro_torch.serving.server import ShardedBankDispatcher

    rng = np.random.default_rng(7)
    disp = ShardedBankDispatcher(make_tenant_mesh(8, dev))
    owners = np.array([s for s in range(8) if s != EMPTY_SHARD])
    weights = 0.6 ** np.arange(len(owners))
    rows = []
    for t in (256, 1024, 4096):
        bank = bsb.random_bank(rng, t, dev)
        scores = rng.uniform(0, 1, (8192, bsb.K)).astype(np.float32)
        tid = rng.integers(0, t, 8192)
        dense = to_numpy(ops.score_pipeline_banked(
            torch.from_numpy(scores).to(dev),
            torch.from_numpy(tid.astype(np.int32)).to(dev), bank.betas,
            bank.weights, bank.src_quantiles, bank.ref_quantiles))
        assign = rng.choice(owners, t, p=weights / weights.sum())
        sbank = ShardedTransformBank.from_dense(bank, 8, shard_of=assign)
        check(sbank.row_counts[EMPTY_SHARD] == 0, "an empty shard")
        rows.append({"tenants": t, "row_counts": sbank.row_counts.tolist(),
                     "per_shard_bytes": sbank.per_shard_bytes,
                     **bsb.sharded_row(disp, sbank, scores, tid, dense, 10)})
    return rows


def _sharded_kernel_ms(dev) -> dict:
    """The banked kernel's own time (CUDA events) inside a dense launch and
    inside the S = 8 dispatcher's launch at T = 4,096, batch 8,192: the
    launch's rows and bank as the dispatcher packs them, beside the
    bound.  These launches are not a path's (they come after its count)."""
    import numpy as np
    import torch
    from repro_torch.benchmarks import bench_sharded_bank as bsb
    from repro_torch.benchmarks.timing import banked_bound, device_ms
    from repro_torch.core.transforms import ShardedTransformBank
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_tenant_mesh
    from repro_torch.serving.server import ShardedBankDispatcher

    rng = np.random.default_rng(11)
    t, b = 4096, 8192
    bank = bsb.random_bank(rng, t, dev)
    scores = rng.uniform(0, 1, (b, bsb.K)).astype(np.float32)
    tid = rng.integers(0, t, b)
    real = ops.score_pipeline_banked
    launches = {"dense": (torch.from_numpy(scores).to(dev),
                          torch.from_numpy(tid.astype(np.int32)).to(dev),
                          bank.betas, bank.weights, bank.src_quantiles,
                          bank.ref_quantiles)}
    disp = ShardedBankDispatcher(make_tenant_mesh(8, dev))
    sbank = ShardedTransformBank.from_dense(bank, 8)
    def capture(*args):      # the dispatcher's launch, as it packs it
        launches["s8"] = args
        return real(*args)

    try:
        ops.score_pipeline_banked = capture
        disp(scores, tid, sbank)
    finally:
        ops.score_pipeline_banked = real
    out = {}
    for name, args in launches.items():
        m, rows = args[0].shape[0], args[2].shape[0]
        bound_ms, bound_by = banked_bound(m, bsb.K, rows, bsb.N)
        out[name] = {"rows": m, "bank_rows": rows,
                     "ms": device_ms(lambda: real(*args)),
                     "bound_ms": bound_ms, "bound_by": bound_by}
    return out


def _responses(out) -> dict:
    return {r.request_id: (r.score, r.predictor, r.bank_generation)
            for r in out}


def _serve_topologies(setup) -> dict:
    """The serve phase's configuration served dense, at S = 4 and 8, and
    tiered over S = 4 through the async engine, with the same T^Q refresh
    published after the fifth window to each: every response bitwise the
    dense server's, equal generations.  Launches are counted per topology
    (set to 0 just before its run, read just after)."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import AsyncDispatchEngine
    from repro_torch.serving.tiering import TieringConfig

    world, make_server, windows = setup
    fitted = {}

    def refresh(server):
        if "qm" not in fitted:      # fitted once, on the dense server
            fitted["qm"] = server.fit_custom_quantile_map(
                "tenant00", "p0", world.ref_quantiles)
        server.publish_quantile_maps({"p0": fitted["qm"]})

    def counted(run):
        for name in ops.LAUNCHES:
            ops.LAUNCHES[name] = 0
        out = run()
        return out, ops.LAUNCHES["score_pipeline_banked"]

    def window_ms(secs):
        return [x * 1e3 for x in secs[1:]]

    dense = make_server(True)
    (resp, secs), dense_launches = counted(
        lambda: _drive(dense, windows, refresh))
    want = _responses([r for w in resp for r in w])
    result = {"dense": {"launches": dense_launches,
                        "p50_window_ms": float(np.median(secs[1:])) * 1e3,
                        "window_ms": window_ms(secs),
                        "stage_ms": _stage_ms(dense, windows[-1])}}
    for s in SERVE_SHARDS:
        server = make_server(True, tenant_shards=s)
        (got, secs), launches = counted(
            lambda: _drive(server, windows, refresh))
        check(_responses([r for w in got for r in w]) == want,
              f"S={s}: responses bitwise equal to the dense server's")
        m = server.metrics
        check(launches == m["kernel_dispatches"] == m["shard_dispatches"]
              > 0, f"S={s}: {launches} launches, {m['kernel_dispatches']} "
              f"dispatches, {m['shard_dispatches']} sharded")
        key = max(server.plane.banks, key=len)
        sbank = server.plane.banks[key].sharded
        check(sbank.generation == server.bank_generation == 1,
              f"S={s}: the sharded bank's generation")
        result[f"s{s}"] = {
            "launches": launches, "shard_dispatches": m["shard_dispatches"],
            "rows_per_shard": sbank.rows_per_shard,
            "per_shard_bytes": sbank.per_shard_bytes,
            "dense_bytes": server.plane.banks[key].bank.num_rows
            * (2 * sbank.num_experts + 2 * sbank.num_quantiles) * 4,
            "p50_window_ms": float(np.median(secs[1:])) * 1e3,
            "window_ms": window_ms(secs),
            "events_per_s": (N_WINDOWS - 1) * WINDOW / sum(secs[1:]),
            "stage_ms": _stage_ms(server, windows[-1])}

    hot, victims = SHARD_TIERS
    composed = make_server(True, tenant_shards=SERVE_SHARDS[0],
                           tiering=TieringConfig(hot_capacity=hot,
                                                 victim_capacity=victims))
    engine = AsyncDispatchEngine(composed, max_batch=WINDOW, max_wait_ms=1e9)
    half = N_WINDOWS // 2

    def run():
        out, marks = [], [time.perf_counter()]
        for part in (windows[:1], windows[1:half], windows[half:]):
            for reqs in part:
                engine.submit_many(reqs)
            out += engine.drain(timeout=300.0)
            marks.append(time.perf_counter())
            if len(out) == WINDOW:
                composed.rebalance_tiers()
            elif len(out) == half * WINDOW:
                refresh(composed)
        return out, marks

    (out, marks), launches = counted(run)
    errors, prefetch_errors = list(engine.errors), engine.prefetch_errors
    engine.close()
    check(not errors and not prefetch_errors,
          f"composed engine stage errors: {errors[:3]}")
    check(_responses(out) == want, "tiered over sharded through the engine: "
          "responses bitwise equal to the dense server's")
    tm = composed.tier_metrics()
    passes = tm["dispatches"] + tm["extra_passes"]
    check(launches == passes > 0, f"the composed stores launched the banked "
          f"kernel {launches} times for {passes} passes")
    check(tm["prefetched_rows"] > 0 and tm["cold_miss_stalls"] > 0
          and tm["extra_passes"] > 0, f"prefetch, stalls, extra passes: {tm}")
    stores = composed.tiered_stores()
    store = stores[max(stores, key=len)]
    result["tiered_s4"] = {
        "launches": launches, "passes": passes, "hot": hot,
        "victims": victims, "tier_metrics": tm,
        "per_shard_device_bytes": store.per_shard_device_bytes,
        "device_bytes": store.device_bytes, "host_bytes": store.host_bytes,
        "shard_dispatches": composed.metrics["shard_dispatches"],
        "ms_per_window_after_rebalance":
            (marks[-1] - marks[1]) * 1e3 / (N_WINDOWS - 1)}
    return result


def _publish_under_traffic(dev, setup) -> dict:
    """The reference's ``TestShardedRefreshAtomicity`` on the card: fleet
    refreshes of all 64 streams published by a writer thread while the
    serve windows stream through the engine on the S = 4 server (a window
    enters once half as many publishes as windows before it have landed).  The
    generations are consecutive; every response replays bit for bit
    through the kernel from the parameters of the one generation it is
    stamped with (a torn per-shard mix would not), and per predictor the
    generations never step back."""
    import threading

    import numpy as np
    import torch
    from repro_torch.core.quantiles import StreamingQuantileEstimator
    from repro_torch.core.transforms import TransformBank
    from repro_torch.kernels import ops
    from repro_torch.serving.calibration import (CalibrationController,
                                                 RefreshPolicy)
    from repro_torch.serving.engine import AsyncDispatchEngine

    _, make_server, windows = setup
    server = make_server(True, tenant_shards=SERVE_SHARDS[0])
    for i in range(N_TENANTS):
        est = StreamingQuantileEstimator(capacity=131072, seed=i)
        est.update(np.random.default_rng(i).uniform(0, 1, 5000))
        server._estimators[(f"tenant{i:02d}", f"p{i}")] = est
    ctrl = CalibrationController(
        server, np.linspace(0.0, 1.0, 64) ** 2,
        RefreshPolicy(alert_rate=0.05, rel_error=0.5, n_levels=64))

    def pipelines():
        return {n: p.pipeline for n, p in server.predictors.items()}

    registry = {0: pipelines()}
    check(ctrl.refresh_fleet().generation == 1, "the first refresh")
    registry[1] = pipelines()
    engine = AsyncDispatchEngine(server, max_batch=WINDOW, max_wait_ms=1e9,
                                 facade_timeout_s=300.0)
    stop = threading.Event()
    published: list[int] = []
    refresh_s: list[float] = []

    landed = threading.Condition()

    def writer():
        while not stop.is_set() and len(published) < 20:
            t0 = time.perf_counter()
            res = ctrl.refresh_fleet()
            refresh_s.append(time.perf_counter() - t0)
            registry[res.generation] = pipelines()
            with landed:
                published.append(res.generation)
                landed.notify_all()

    def traffic():
        # window w goes in once w // 2 publishes have landed, so the
        # publishes interleave with the traffic whatever their speed
        for w, reqs in enumerate(windows):
            with landed:
                landed.wait_for(lambda: len(published) >= w // 2,
                                timeout=60.0)
            engine.submit_many(reqs)

    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    wt = threading.Thread(target=writer)
    tt = threading.Thread(target=traffic)
    wt.start()
    tt.start()
    tt.join(timeout=300.0)
    check(not tt.is_alive(), "traffic thread wedged")
    responses = engine.drain(timeout=300.0)
    stop.set()
    wt.join(timeout=300.0)
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES["score_pipeline_banked"]
    check(not wt.is_alive(), "refresh writer wedged")
    errors = list(engine.errors)
    engine.close()
    check(not errors, f"engine stage errors: {errors[:3]}")
    check(sorted(r.request_id for r in responses)
          == list(range(N_WINDOWS * WINDOW)), "one response a request")
    check(len(published) >= (N_WINDOWS - 1) // 2 and
          published == list(range(2, 2 + len(published))),
          f"consecutive fleet generations: {published}")
    m = server.metrics
    check(launches == m["shard_dispatches"] == m["kernel_dispatches"] > 0,
          f"{launches} launches for {m['shard_dispatches']} sharded "
          "dispatches")
    # replay: one dense bank a generation, every response of it through
    # the kernel (these launches are not the path's)
    by_gen: dict[int, list] = {}
    for r in responses:
        by_gen.setdefault(r.bank_generation, []).append(r)
    for gen, rs in by_gen.items():
        names = sorted(registry[gen])
        pipes = [registry[gen][n] for n in names]
        bank = TransformBank.from_params(
            [(p.betas, p.weights, p.src_quantiles, p.ref_quantiles)
             for p in pipes], device=dev)
        row_of = {n: i for i, n in enumerate(names)}
        got = ops.score_pipeline_banked(
            torch.tensor([r.raw_scores for r in rs], device=dev),
            torch.tensor([row_of[r.predictor] for r in rs],
                         dtype=torch.int32, device=dev),
            bank.betas, bank.weights, bank.src_quantiles,
            bank.ref_quantiles).cpu().numpy()
        served = np.array([r.score for r in rs], np.float32)
        differ = int(np.sum(got.view(np.uint32) != served.view(np.uint32)))
        check(differ == 0, f"generation {gen}: {differ} of {len(rs)} "
              "responses differ from their generation's replay")
    last: dict[str, int] = {}
    for r in sorted(responses, key=lambda r: r.request_id):
        check(r.bank_generation >= last.get(r.predictor, -1),
              f"{r.predictor}: generation stepped back")
        last[r.predictor] = r.bank_generation
    return {"publishes": len(published), "generations_seen": sorted(by_gen),
            "launches": launches, "responses": len(responses),
            "refresh_s_median": float(np.median(refresh_s)),
            "events_per_s": len(responses) / wall}


def phase_sharding(dev, setup) -> dict:
    """The tenant-sharded topology on the card: the sharded benchmark at
    full size, an uneven assignment with an empty shard, the serve
    configuration at S = 4, 8 and tiered over S = 4, and fleet publishes
    under traffic.  Launches: each part counted on its own."""
    from repro_torch.benchmarks import bench_sharded_bank
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    bench = bench_sharded_bank.run(device=dev)
    bench_launches = ops.LAUNCHES["score_pipeline_banked"]
    rows = bench["rows"]
    check(bench["all_bitwise_parity"], "sharded rows bitwise the dense launch")
    check(all(r["launches_per_call"] == 1 for r in rows),
          f"one launch a call: {[r['launches_per_call'] for r in rows]}")
    for r in rows:
        want = SHARD_DENSE_BYTES[r["tenants"]] // max(r["shards"], 1)
        check(r["resident_bytes"] == want,
              f"T={r['tenants']}, S={r['shards']}: {r['resident_bytes']} "
              f"resident bytes, expected {want}")
    check({r["tenants"]: r["resident_bytes"] for r in rows
           if r["shards"] == 8} == SHARD_S8_BYTES, "S=8 resident bytes")
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    uneven = _sharded_uneven(dev)
    uneven_launches = ops.LAUNCHES["score_pipeline_banked"]
    serve = _serve_topologies(setup)
    publish = _publish_under_traffic(dev, setup)
    kernel_ms = _sharded_kernel_ms(dev)
    launches = {"bench": bench_launches, "uneven": uneven_launches,
                **{f"serve_{k}": v["launches"] for k, v in serve.items()},
                "publish_under_traffic": publish["launches"]}
    check(all(n > 0 for n in launches.values()),
          f"every sharded run launched the banked kernel: {launches}")
    result = {"phase": "sharding", "launches": launches, "bench": bench,
              "uneven": uneven, "serve": serve,
              "publish_under_traffic": publish, "kernel_ms": kernel_ms,
              "wall_s": time.perf_counter() - t0}
    emit(result)
    return result


# ---------------------------------------------------------------- phase 8
def phase_main_bench(dev) -> dict:
    """The main path's two benchmarks at the reference's sizes: serving
    latency and the transform's share of it, and the banked launch against
    a per-predictor loop.  Each raises if a kernel is off its plain version
    by more than 2e-5.  Launches: each benchmark counted on its own."""
    from repro_torch.benchmarks import (bench_multitenant_batch,
                                        bench_serving_latency)
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    launches = {}
    results = {}
    for name, bench in (("serving_latency", bench_serving_latency),
                        ("multitenant_batch", bench_multitenant_batch)):
        for key in ops.LAUNCHES:
            ops.LAUNCHES[key] = 0
        results[name] = bench.run(device=dev)
        launches[name] = {k: v for k, v in ops.LAUNCHES.items() if v}
        check(launches[name].get("score_pipeline", 0) > 0
              and launches[name].get("score_pipeline_banked", 0) > 0,
              f"{name} launched both Eq. 2 kernels: {launches[name]}")
    mt = results["multitenant_batch"]
    check(mt["max_abs_err_vs_oracle"] <= TOL
          and mt["max_abs_err_loop_vs_plain"] <= TOL,
          f"multitenant errors {mt['max_abs_err_vs_oracle']}, "
          f"{mt['max_abs_err_loop_vs_plain']}")
    sl = results["serving_latency"]
    check(sl["transform_pipeline_4096"]["max_abs_err_vs_plain"] <= TOL,
          "serving latency's kernel against its plain version")
    result = {"phase": "main_bench", "launches": launches, **results,
              "wall_s": time.perf_counter() - t0}
    emit(result)
    return result


# ---------------------------------------------------------------- phase 9
# The card's run of Table 1, Fig. 4 and Fig. 6 against the port's CPU run of
# the same module at the same size.  Table 1: T^C is the same float32
# expression of separate IEEE operations on both devices, so equal bits are
# expected; 1e-6 relative admits an ulp a corrected score.  Figs. 4 and 6:
# the kernel's T^Q differs from the plain version's by an ulp or so a
# score, which changes a statistic only where a score crosses a bin edge or
# a threshold: one crossing moves a bin's relative error by 1/(n·expected)
# <= 1.8e-3 (n = 200,000, least expected bin mass 0.00276), a recall by 1 /
# positives (3e-4) and an alert rate or bin mass by 1/n; 5e-3 admits two
# crossings, and every bin change must lie within 2e-5 of an edge.
PAPER_TOL = {"table1": {"rtol": 1e-6}, "fig4": {"atol": 5e-3},
             "fig6": {"atol": 5e-3}}
PAPER_STAMP = frozenset({"device", "nvidia_smi", "launches", "tq_vs_plain"})
QUICKSTART_LINES = ("models provisioned: 2 (3 predictors share 2 physical "
                    "models)", "live score via bank1-predictor-v1: ",
                    "shadow records written: 1",
                    "after T^Q swap (no model re-provisioning): ",
                    "after promotion, same intent now served by "
                    "bank1-predictor-v2 (routing v2): ")


def _live_tq(name, checks: dict) -> None:
    """The kernel against its plain version on a figure's live scores."""
    for label, c in checks.items():
        where = f"{name}/{label}"
        check(c["max_abs_err"] <= TOL,
              f"{where}: quantile_map off its plain version by "
              f"{c['max_abs_err']}")
        check(c["on_knot_equal"], f"{where}: scores on knots not bitwise")
        check(c["bin_changes"] == 0 or c["bin_changes_max_edge_gap"] <= TOL,
              f"{where}: {c['bin_changes']} scores changed bin, "
              f"{c['bin_changes_max_edge_gap']} from an edge")


def _quickstart(dev) -> dict:
    """``python -m repro_torch.examples.quickstart`` on the card, in a
    process of its own, against the same example run on the CPU here."""
    import contextlib
    import io
    import os
    from repro_torch.examples import quickstart

    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart"],
        capture_output=True, text=True, timeout=300, cwd=root,
        env={**os.environ, "PYTHONPATH": str(root / "src")})
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"quickstart: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    check(len(lines) == len(QUICKSTART_LINES)
          and all(a.startswith(b) for a, b in zip(lines, QUICKSTART_LINES)),
          f"quickstart printed {lines}")
    cpu = io.StringIO()
    with contextlib.redirect_stdout(cpu):
        quickstart.main(["--device", "cpu"])
    check(lines == cpu.getvalue().splitlines(),
          f"quickstart on the card {lines}, on the CPU "
          f"{cpu.getvalue().splitlines()}")
    return {"lines": lines, "seconds": seconds, "equals_cpu_run": True}


LIVE_TQ = (400_000, 256)   # Fig. 4's v0 and Fig. 6's launches: scores, N


def _live_tq_ms(dev) -> dict:
    """The T^Q kernel's time at the figures' launch size: 400,000 float32
    scores of the fraud score's shape against a fitted 256-knot table."""
    import numpy as np
    import torch
    from repro_torch.benchmarks.timing import device_ms, quantile_map_bound
    from repro_torch.core.transforms import (QuantileMap,
                                             fraud_reference_quantiles)
    from repro_torch.kernels import ops, ref

    m, n = LIVE_TQ
    rng = np.random.default_rng(21)
    qm = QuantileMap.fit(rng.beta(0.5, 8.0, m), fraud_reference_quantiles(n))
    x = torch.tensor(rng.beta(0.5, 8.0, m), dtype=torch.float32, device=dev)
    args = (x, qm.src_quantiles.to(dev), qm.ref_quantiles.to(dev))
    bound = quantile_map_bound(m, n, 4)
    return {"shape": {"M": m, "N": n},
            "max_abs_err": _compare("quantile_map/live", ops.quantile_map(
                *args), ref.quantile_map(*args)),
            "ms": device_ms(lambda: ops.quantile_map(*args)),
            "plain_ms": device_ms(lambda: ref.quantile_map(*args), inner=10),
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}


def phase_paper_bench(dev) -> dict:
    """The paper's tables and figures on the card at full size: Table 1,
    Fig. 4 (and its fleet refresh), Fig. 6, Fig. 5, the fleet calibration
    plane and the attack campaign, each with the launch counts set to 0
    just before it and read just after.  The T^Q kernel on Figs. 4 and 6's
    live scores is held to its plain version on the same tensors; Table 1
    and Figs. 4 and 6 to the port's CPU run at the same size (PAPER_TOL);
    Fig. 5, the fleet refresh and the attack campaign to the invariants
    their results carry.  Then the quickstart on the card."""
    from repro_torch.benchmarks import (bench_attack_campaign,
                                        bench_fig4_quantile_update,
                                        bench_fig5_rollout,
                                        bench_fig6_model_update,
                                        bench_fleet_refresh,
                                        bench_table1_calibration, paper)
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    runs = {"table1": (bench_table1_calibration.run, None),
            "fig4": (bench_fig4_quantile_update.run, "quantile_map"),
            "fig4_refresh": (bench_fig4_quantile_update.run_refresh,
                             "score_pipeline_banked"),
            "fig6": (bench_fig6_model_update.run, "quantile_map"),
            "fig5": (bench_fig5_rollout.run, "score_pipeline_banked"),
            "fleet_refresh": (bench_fleet_refresh.run,
                              "score_pipeline_banked"),
            "attack_campaign": (bench_attack_campaign.run,
                                "score_pipeline_banked")}
    results, launches, seconds = {}, {}, {}
    for name, (fn, kernel) in runs.items():
        for key in ops.LAUNCHES:
            ops.LAUNCHES[key] = 0
        t1 = time.perf_counter()
        results[name] = fn(device=dev)
        seconds[name] = time.perf_counter() - t1
        launches[name] = {k: v for k, v in ops.LAUNCHES.items() if v}
        check(kernel is None or launches[name].get(kernel, 0) > 0,
              f"{name} launched {kernel}: {launches[name]}")
    for name in ("fig4", "fig6"):
        _live_tq(name, results[name]["tq_vs_plain"])
    live = _live_tq_ms(dev)

    # the card against the CPU, at the same size
    cpu_seconds, diffs = {}, {}
    for name, tol in PAPER_TOL.items():
        t1 = time.perf_counter()
        cpu = runs[name][0](device="cpu")
        cpu_seconds[name] = time.perf_counter() - t1
        off = paper.differences(cpu, results[name], skip=PAPER_STAMP, **tol)
        check(not off, f"{name}: the card against the CPU: {off[:5]}")
        # the values whose bits differ, all within the tolerance
        not_bitwise = paper.differences(cpu, results[name], skip=PAPER_STAMP)
        diffs[name] = {"values_not_bitwise": len(not_bitwise),
                       "first": not_bitwise[:5]}

    # the invariants the other results carry
    f5 = results["fig5"]
    check(f5["invariants_ok"] and f5["min_ready"] >= f5["pod_baseline"]
          and f5["pod_final"] == f5["pod_baseline"],
          f"fig5 rollout invariants: {f5}")
    check(results["fleet_refresh"]["all_within_bound"],
          "fleet refresh: a published table past the rank-error bound")
    check(all(r["generation"] == 1 for r in results["fig4_refresh"]["rows"]),
          "fig4 refresh: one published generation a pass")
    attack = results["attack_campaign"]
    check(attack["attack_refreshes"] > 0, "attack campaign: no refresh")
    for regime in ("quiet", "attack"):
        r = attack[regime]
        check(r["audit_replayed_bitwise"] == r["audit_entries"]
              == r["audit_replay_launches"] > 0,
              f"attack {regime}: {r['audit_replayed_bitwise']} replayed "
              f"bitwise through {r['audit_replay_launches']} launches, "
              f"{r['audit_entries']} entries")
    quickstart = _quickstart(dev)

    def scalars(res):
        return {k: v for k, v in res.items()
                if isinstance(v, (int, float, str, bool)) or v is None}

    result = {"phase": "paper_bench", "launches": launches,
              "seconds": seconds, "cpu_seconds": cpu_seconds,
              "tolerance": PAPER_TOL,
              "card_vs_cpu": diffs,
              "tq_vs_plain": {n: results[n]["tq_vs_plain"]
                              for n in ("fig4", "fig6")},
              "quantile_map_live": live,
              "results": {n: scalars(r) for n, r in results.items()},
              "fig4_refresh_rows": results["fig4_refresh"]["rows"],
              "fleet_rows": results["fleet_refresh"]["rows"],
              "attack": {k: attack[k] for k in ("quiet", "attack")},
              "quickstart": quickstart,
              "wall_s": time.perf_counter() - t0}
    emit(result)
    return result


# ---------------------------------------------------------------- phase 10
# (b, tq, tk, hq, hkv, d, causal, window)
ATTN_CASES = {
    "gqa_causal": (2, 128, 128, 4, 2, 64, True, 0),
    "mha_causal": (1, 256, 256, 8, 8, 32, True, 0),
    "bidirectional": (2, 128, 128, 4, 1, 64, False, 0),
    "window_64": (1, 256, 256, 4, 2, 64, True, 64),
    "ragged_100": (1, 100, 100, 2, 2, 32, True, 0),
    "tq_lt_tk": (2, 96, 200, 4, 2, 64, True, 0),
    "ragged_1000": (1, 1000, 1000, 8, 2, 128, True, 0),
    "window_across_tiles": (2, 300, 300, 4, 2, 64, True, 50),
    "d80_hubert": (2, 192, 192, 4, 4, 80, False, 0),
    "d128_gqa": (3, 256, 256, 8, 2, 128, True, 0),
}
MAIN_ATTN = (4, 2048, 2048, 32, 8, 128, True, 0)   # qwen3-8b prefill


def _qkv(case, dtype, dev, seed):
    import torch

    b, tq, tk, hq, hkv, d = case[:6]
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((b, tq, hq, d), (b, tk, hkv, d), (b, tk, hkv, d))]


def _attn_err(name, got, want, tol) -> float:
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: shape/dtype")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
    excess = ((g - w).abs() - (tol + tol * w.abs())).max().item()
    check(excess <= 0, f"{name}: outside rtol = atol = {tol}")
    return (g - w).abs().max().item()


def phase_attention(dev) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.benchmarks.timing import attention_bound, device_ms
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    def form_of(launch):
        """Run ``launch`` and name the form it ran by the launch counts."""
        before = fa.LAUNCHES["flash_attention_wgmma"]
        out = launch()
        return out, ("wgmma" if fa.LAUNCHES["flash_attention_wgmma"] > before
                     else "simt")

    errs: dict[str, dict[str, float]] = {}
    forms: dict[str, dict[str, str]] = {}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        errs[dname], forms[dname] = {}, {}
        for i, (name, case) in enumerate(ATTN_CASES.items()):
            causal, win = case[6:]
            q, k, v = _qkv(case, dtype, dev, seed=i)
            got, form = form_of(lambda: fa.flash_attention(
                q, k, v, causal=causal, sliding_window=win))
            want_form = ("wgmma" if dtype == torch.bfloat16
                         and case[5] in fa.WGMMA_HEAD_DIMS else "simt")
            check(form == want_form, f"{name}/{dname} ran the {form} form, "
                  f"not {want_form}")
            forms[dname][name] = form
            errs[dname][name] = _attn_err(
                f"{name}/{dname}", got,
                ref.flash_attention(q, k, v, causal=causal, sliding_window=win),
                ATTN_TOL[dname])
        # rows past Tk + window - 1 see no key: the kernel gives exactly 0
        # (the plain version's finite NEG_INF averages them instead)
        q, k, v = _qkv((1, 256, 64, 4, 2, 64), dtype, dev, seed=99)
        got = fa.flash_attention(q, k, v, causal=True, sliding_window=16)
        want = ref.flash_attention(q, k, v, causal=True, sliding_window=16)
        masked = torch.arange(256, device=dev) >= 64 + 16 - 1
        check(bool((got[0, masked] == 0).all()),
              f"fully masked rows are exactly 0 ({dname})")
        errs[dname]["partly_masked"] = _attn_err(
            f"partly_masked/{dname}", got[0, ~masked], want[0, ~masked],
            ATTN_TOL[dname])

    # the prefill shape of qwen3-8b (one launch per attention layer): the
    # SIMT form in float32 at the tight tolerance, the tensor-core form in
    # bfloat16 as the model runs it; each timed with its plain version and
    # PyTorch's own attention call on the same inputs
    b, tq, tk, hq, hkv, d, causal, win = MAIN_ATTN
    q, k, v = _qkv(MAIN_ATTN, torch.float32, dev, seed=123)
    got, form = form_of(lambda: fa.flash_attention(q, k, v, causal=causal))
    check(form == "simt", "float32 at the main shape runs the SIMT form")
    errs["float32"]["main_shape"] = _attn_err(
        "main_shape/float32", got, ref.flash_attention(q, k, v, causal=causal),
        ATTN_TOL["float32"])
    torch.cuda.synchronize()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    bound32 = attention_bound(*MAIN_ATTN, itemsize=4)
    simt = {"form": "simt", "dtype": "float32",
            "max_abs_err": errs["float32"]["main_shape"],
            "ms": device_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                            reps=3, inner=1),
            "plain_ms": device_ms(lambda: ref.flash_attention(
                q, k, v, causal=causal), reps=3, inner=1),
            "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), reps=3, inner=3),
            "bound_ms": bound32[0], "bound_by": bound32[1]}
    want32 = ref.flash_attention(*(x.to(torch.bfloat16).float()
                                   for x in (q, k, v)), causal=causal)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    got, form = form_of(lambda: fa.flash_attention(q, k, v, causal=causal))
    check(form == "wgmma", "bf16 at the main shape runs the wgmma form")
    main_err = _attn_err("main_shape/bfloat16", got,
                         ref.flash_attention(q, k, v, causal=causal),
                         ATTN_TOL["bfloat16"])
    errs["bfloat16"]["main_shape"] = main_err
    # the model check's measure on every row: the error from float32 on
    # the same bf16 inputs as a share of the bf16 rounding bound
    share = ((got.float() - want32).abs()
             / (2.0 ** -8 * want32.abs() + 1e-5)).max().item()
    del got, want32
    torch.cuda.synchronize()
    ms = device_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                   reps=20, inner=10)
    plain_ms = device_ms(lambda: ref.flash_attention(q, k, v, causal=causal),
                         reps=3, inner=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps=20, inner=10)
    bound_ms, bound_by, flops = attention_bound(*MAIN_ATTN, itemsize=2)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    result = {"phase": "attention", "name": "flash_attention_wgmma",
              "cases": {n: list(c) for n, c in ATTN_CASES.items()},
              "forms": forms, "tolerance": ATTN_TOL, "errors": errs,
              "fully_masked_rows": "exactly 0",
              "shape": {"B": b, "Tq": tq, "Tk": tk, "Hq": hq, "Hkv": hkv,
                        "D": d, "causal": causal, "dtype": "bfloat16"},
              "max_abs_err": main_err,
              "share_of_bf16_bound_vs_f32": share,
              "ms": ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "gflop": flops / 1e9,
              # P in two bf16 terms: the tensor cores are issued 6*D flops
              # a visible pair, not 4*D
              "bound_ms_issued": 1.5 * bound_ms,
              "tflop_per_s": flops / (ms * 1e-3) / 1e12,
              "simt_f32_ms": simt["ms"], "simt_f32": simt,
              "timing": "CUDA events, median of 20 runs of 10 back-to-back "
                        "launches (SIMT form and plain versions: 3 runs of "
                        "1) queued behind a busy card"}
    emit(result)
    return result


# ---------------------------------------------------------------- phase 11
LLM_ARCH = "qwen3-8b"
LLM_BATCH, LLM_PROMPT, LLM_STEPS = 4, 2048, 16
# (weight seed, prompt seed) of the accuracy check; the first is the
# main path's model and prompt
ACC_SEEDS = ((0, 0), (0, 1), (1, 2), (1, 3), (2, 4), (2, 5))


def _max_diff(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _device_split(prof, extra: dict | None = None) -> dict:
    """Device milliseconds of a profiler window by kernel kind, and the top
    kernels; None where the trace holds no device time.  ``extra`` names
    more kinds, each by substrings of its kernels' names, taken after the
    flash kernels and the matmuls."""
    import torch

    extra = extra or {}
    cats = {"flash_attention": 0.0, "matmul": 0.0,
            **{kind: 0.0 for kind in extra}, "other": 0.0}
    top = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        name = e.key.lower()
        if any(k in name for k in ("flash_attention_kernel",
                                   "flash_attention_wgmma_kernel")):
            cats["flash_attention"] += ms
        elif any(s in name for s in ("gemm", "gemv", "nvjet", "cutlass",
                                     "xmma", "cublas", "sm90_")):
            cats["matmul"] += ms
        else:
            kind = next((k for k, subs in extra.items()
                         if any(sub in name for sub in subs)), "other")
            cats[kind] += ms
        top.append((ms, e.key[:80], e.count))
    top.sort(reverse=True)
    total = sum(cats.values())
    if total == 0:
        return None
    return {"device_ms": cats, "device_ms_total": total,
            "top": [{"kernel": k, "ms": ms, "count": n}
                    for ms, k, n in top[:8]]}


def _profile(model, prompt, transform, extra: dict | None = None) -> dict:
    """One kernel prefill and two decode steps under ``torch.profiler``:
    device time by kernel kind beside host wall time (the profiler's own
    cost is in the wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t_len = prompt.shape[1]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof_p:
        t0 = time.perf_counter()
        out, cache = model.prefill(prompt, cache_capacity=t_len + 2,
                                   attn_impl="kernel", logits_mode="last")
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
    tok = torch.argmax(out.logits[:, -1], dim=-1)[:, None]
    with profile(activities=acts) as prof_d:
        t0 = time.perf_counter()
        for i in range(2):
            step = model.decode_step(cache, tok, pos=t_len + i,
                                     attn_impl="kernel")
            tok = torch.argmax(step.logits, dim=-1)[:, None]
            transform(step.risk_score)
        torch.cuda.synchronize()
        wall_d = (time.perf_counter() - t0) / 2
    result = {}
    for name, prof, wall in (("prefill", prof_p, wall_p),
                             ("decode_step", prof_d, wall_d)):
        split = _device_split(prof, extra)
        if split is not None and name == "decode_step":
            split["device_ms"] = {k: v / 2 for k, v in
                                  split["device_ms"].items()}
            split["device_ms_total"] /= 2
        result[name] = {"wall_ms": wall * 1e3, "split": split,
                        "device_busy_share": (split["device_ms_total"] /
                                              (wall * 1e3)
                                              if split else None),
                        "cuda_launches": sum(
                            e.count for e in prof.key_averages()
                            if e.key in ("cudaLaunchKernel",
                                         "cudaLaunchKernelExC"))
                        / (2 if name == "decode_step" else 1)}
    del out, cache
    return result


def _flash_witness(launch, rows: int = 64):
    """A stand-in for ``ops.flash_attention`` that launches ``launch`` and
    holds each call's last ``rows`` query rows against the plain version in
    float32 on the same inputs (one batch row at a time, so that the
    float32 logits of a wide layer stay a few GB), as a share of the bf16
    rounding bound 2^-8 |o| + 1e-5 (at most 1 when only the output's
    rounding to bf16 separates them), beside the bf16 reference path's
    chunked attention on those inputs.  Returns (witness, stats); stats
    fill in as the witness is called."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.models import attention

    stats = {"calls": 0, "worst": {"kernel": 0.0, "bf16_reference": 0.0},
             "equal": 0, "total": 0}

    def witness(q, k, v, *, causal, sliding_window):
        out = launch(q, k, v, causal=causal, sliding_window=sliding_window)
        want = torch.cat([ref.flash_attention(
            q[i:i + 1].float(), k[i:i + 1].float(), v[i:i + 1].float(),
            causal=causal, sliding_window=sliding_window)[:, -rows:]
            for i in range(q.shape[0])])
        chunked = attention._gqa_scores_chunked(
            q, k, v, causal=causal, q_offset=0,
            sliding_window=sliding_window)[:, -rows:]
        bound = 2.0 ** -8 * want.abs() + 1e-5
        worst = stats["worst"]
        for key, got in (("kernel", out[:, -rows:]),
                         ("bf16_reference", chunked)):
            share = ((got.float() - want).abs() / bound).max().item()
            worst[key] = max(worst[key], share)
        stats["calls"] += 1
        stats["equal"] += int((out[:, -rows:] == want.to(out.dtype)).sum())
        stats["total"] += want.numel()
        return out

    return witness, stats


def _accuracy(model, prompt, rows: int = 64) -> dict:
    """Last-token logits and served risk scores of a kernel prefill and a
    bfloat16 reference prefill, each as its max distance from a float32
    reference prefill of the same weights.  During the kernel prefill each
    attention call is held against the plain version (``_flash_witness``).
    A model without attention layers takes no kernel in its prefill: its
    kernel-branch prefill is its bf16 reference prefill, run once."""
    import torch
    from repro_torch.kernels import ops

    launch = ops.flash_attention
    witness, stats = _flash_witness(launch, rows)
    kw = dict(cache_capacity=prompt.shape[1], logits_mode="last")
    has_attention = any(b.spec.mixer == "attn" for b in model.stack)
    if has_attention:
        # the model's attention reaches the kernel through
        # ops.flash_attention
        ops.flash_attention = witness
        try:
            ker, _ = model.prefill(prompt, attn_impl="kernel", **kw)
        finally:
            ops.flash_attention = launch
    ref16, _ = model.prefill(prompt, attn_impl="reference", **kw)
    if not has_attention:
        ker = ref16
    ref32, _ = model.prefill(prompt, attn_impl="reference",
                             compute_dtype=torch.float32, **kw)
    torch.cuda.empty_cache()
    return {
        "logits": {"kernel": _max_diff(ker.logits, ref32.logits),
                   "bf16_reference": _max_diff(ref16.logits, ref32.logits)},
        "served_risk": {
            "kernel": _max_diff(ker.risk_score, ref32.risk_score),
            "bf16_reference": _max_diff(ref16.risk_score, ref32.risk_score),
            "kernel_vs_bf16_reference": _max_diff(ker.risk_score,
                                                  ref16.risk_score)},
        "attention_last_rows": stats["worst"],
        "attention_last_rows_equal_to_rounded_f32": (
            stats["equal"] / stats["total"] if stats["total"] else None)}


def phase_llm_serve(dev, attention: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import Model

    cfg = get_config(LLM_ARCH)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    rng = np.random.default_rng(0)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size,
                                       (LLM_BATCH, LLM_PROMPT)),
                          dtype=torch.long, device=dev)
    transform = serve.business_transform(dev)
    n_attn = sum(s.mixer == "attn" for s in cfg.layer_pattern) * cfg.n_groups

    # the main path: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    first = serve.serve(model, prompt, decode_steps=LLM_STEPS,
                        transform=transform)
    launches = dict(ops.LAUNCHES)
    check(launches["flash_attention"] == n_attn,
          f"{launches['flash_attention']} kernel launches for one prefill "
          f"and {LLM_STEPS} decode steps, expected {n_attn}")
    check(launches["flash_attention_wgmma"] == n_attn,
          f"{launches['flash_attention_wgmma']} of the {n_attn} launches "
          "ran the tensor-core form")
    runs = []
    for _ in range(3):
        before = ops.LAUNCHES["flash_attention"]
        runs.append(serve.serve(model, prompt, decode_steps=LLM_STEPS,
                                transform=transform))
        check(ops.LAUNCHES["flash_attention"] - before == n_attn,
              "launches per prefill")
    peak = torch.cuda.max_memory_allocated()
    breakdown = _profile(model, prompt, transform)

    # decode steps and short prefills do not reach the kernel
    before = ops.LAUNCHES["flash_attention"]
    out, cache = model.prefill(prompt[:, :64], cache_capacity=65,
                               attn_impl="kernel", logits_mode="last")
    model.decode_step(cache, prompt[:, 64:65], pos=64, attn_impl="kernel")
    check(ops.LAUNCHES["flash_attention"] == before,
          "a 64-token prefill and a decode step launch no kernel")
    del out, cache

    # the float32 path: a float32 prefill through the kernel branch runs
    # the SIMT form; counts set to 0 just before, read just after
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    kw32 = dict(cache_capacity=LLM_PROMPT, compute_dtype=torch.float32,
                logits_mode="last")
    f32_kernel, _ = model.prefill(prompt, attn_impl="kernel", **kw32)
    f32_launches = dict(ops.LAUNCHES)
    check(f32_launches["flash_attention"] == n_attn
          and f32_launches["flash_attention_wgmma"] == 0,
          f"a float32 prefill runs the SIMT form {n_attn} times: "
          f"{f32_launches}")
    f32_reference, _ = model.prefill(prompt, attn_impl="reference", **kw32)
    f32_err = _max_diff(f32_kernel.logits, f32_reference.logits)
    del f32_kernel, f32_reference
    torch.cuda.empty_cache()

    for res in [first] + runs:
        biz = res.business.float()
        check(bool(((biz >= 0) & (biz <= 1)).all()),
              f"business scores in [0, 1]: {biz.tolist()}")
        check(bool(torch.isfinite(res.prefill.logits.float()).all()),
              "finite prefill logits")
    check(all(torch.equal(r.tokens, first.tokens) for r in runs),
          "greedy tokens repeat across runs")

    # kernel prefill against float32 and bfloat16 reference prefills, over
    # several weight and prompt seeds; the first pair is the main path's
    seeds = []
    for ws, ps in ACC_SEEDS:
        if ws != 0:
            del model
            torch.cuda.empty_cache()
            model = Model(cfg, device=dev, dtype=torch.bfloat16, seed=ws)
        p = torch.tensor(np.random.default_rng(ps).integers(
            0, cfg.vocab_size, (LLM_BATCH, LLM_PROMPT)),
            dtype=torch.long, device=dev)
        seeds.append({"weight_seed": ws, "prompt_seed": ps,
                      **_accuracy(model, p)})
    d_ker = max(a["logits"]["kernel"] for a in seeds)
    d_ref = max(a["logits"]["bf16_reference"] for a in seeds)
    r_ker = max(a["served_risk"]["kernel"] for a in seeds)
    r_ref = max(a["served_risk"]["bf16_reference"] for a in seeds)
    witness = {key: max(a["attention_last_rows"][key] for a in seeds)
               for key in ("kernel", "bf16_reference")}
    check(d_ker <= 2 * d_ref, f"kernel prefill logits {d_ker} from the f32 "
          f"reference, bf16 reference {d_ref}")
    check(r_ker <= 2 * max(r_ref, 1e-3), f"kernel prefill served risk "
          f"{r_ker} from the f32 reference, bf16 reference {r_ref}")
    check(witness["kernel"] <= 1.0, f"kernel attention inside the model "
          f"{witness['kernel']} of its bf16 rounding bound from float32")
    # the float32 kernel path, on the main path's weights and prompt, is no
    # farther from the float32 reference than the bf16 reference is
    f32_bf16_ref = seeds[0]["logits"]["bf16_reference"]
    check(f32_err <= f32_bf16_ref, f"float32 kernel prefill logits {f32_err} "
          f"from the float32 reference, bf16 reference {f32_bf16_ref}")

    prefill_ms = statistics.median(r.prefill_s for r in runs) * 1e3
    decode_s = statistics.median(r.decode_s for r in runs)
    cache_bytes = (2 * cfg.n_layers * LLM_BATCH * (LLM_PROMPT + LLM_STEPS)
                   * cfg.n_kv_heads * cfg.head_dim * 2)
    result = {
        "phase": "llm_serve", "arch": LLM_ARCH,
        "config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                   "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                   "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
                   "vocab_size": cfg.vocab_size},
        "params": model.param_count(), "weight_bytes": weight_bytes,
        "cache_bytes": cache_bytes, "max_memory_allocated": peak,
        "init_s": init_s, "batch": LLM_BATCH, "prompt_len": LLM_PROMPT,
        "decode_steps": LLM_STEPS, "launches": launches,
        "launches_per_prefill": n_attn,
        "prefill_ms": prefill_ms,
        "prefill_ms_runs": [r.prefill_s * 1e3 for r in runs],
        "first_prefill_ms": first.prefill_s * 1e3,
        "decode_ms_per_token": decode_s / LLM_STEPS * 1e3,
        "decode_tokens_per_s": LLM_BATCH * LLM_STEPS / decode_s,
        "prefill_tokens_per_s": LLM_BATCH * LLM_PROMPT / (prefill_ms * 1e-3),
        "kernel_share_of_prefill": n_attn * attention["ms"] / prefill_ms,
        "logits_err_kernel_vs_f32": d_ker, "logits_err_bf16_ref_vs_f32": d_ref,
        "risk_err_kernel_vs_f32": r_ker, "risk_err_bf16_ref_vs_f32": r_ref,
        "f32_path": {"launches": f32_launches,
                     "logits_err_vs_f32_reference": f32_err,
                     "bf16_reference_logits_err": f32_bf16_ref},
        "attention_last_rows_vs_f32": witness,
        "served_risk_check_per_seed": sum(
            a["served_risk"]["kernel"]
            <= 2 * max(a["served_risk"]["bf16_reference"], 1e-3)
            for a in seeds),
        "accuracy_seeds": seeds,
        "breakdown": breakdown,
        "risk_scores": first.prefill.risk_score.tolist(),
        "business_scores": first.business.tolist(),
        "timing": "host clock, each prefill and each 16-step decode loop "
                  "ended by a device sync; median of 3 runs after one "
                  "warm-up run"}
    emit(result)
    del model
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------- phase 12
JAMBA = "jamba-1.5-large-398b"
ZOO_ARCHS = ("olmoe-1b-7b", "xlstm-1.3b", JAMBA)
# what is cut, by architecture: jamba keeps its first five layers
ZOO_REDUCED = {JAMBA: {"n_layers": "72 -> 5 (layers 0-4 of the 8-layer "
                                   "period; 90.5 GB bf16 for one period "
                                   "does not fit one 80 GB card)"}}
OLMOE_ATTN = (4, 2048, 2048, 16, 16, 128, True, 0)   # olmoe-1b-7b prefill
# the Mamba scan's kernel; then the MoE's dispatch and combine (slot table
# scatter, buffer and output gathers, the stable sort of the router, the
# position count) and the embedding lookup, apart from the rest of the
# elementwise work (the first kind whose substring a kernel's name holds)
ZOO_SPLIT = {"selective_scan": ("selective_scan",),
             "scatter_gather": ("scatter", "gather", "index", "sort",
                                "scan")}
SCAN_TOL = 2e-5   # rtol = atol, y and h_T against the plain version
# (B, T, C, N, h0 given): T = 1, T past and not a multiple of the 16-step
# chunk or of 64, C not a multiple of the 128-channel block, N = 1, 3, 5, 8
# and 16
SCAN_CASES = ((2, 1, 128, 16, True), (3, 70, 200, 8, False),
              (1, 129, 33, 16, True), (4, 300, 130, 8, True),
              (2, 37, 130, 1, True), (1, 19, 33, 3, False),
              (3, 45, 129, 5, True))
E2E_ARGS = ("--batches", "20", "--batch", "32")
# serve_e2e in a process of its own, printing its kernels' launches last
E2E_CODE = """
import json, sys
from repro_torch.examples import serve_e2e
from repro_torch.kernels import ops
for name in ops.LAUNCHES:
    ops.LAUNCHES[name] = 0
serve_e2e.main(sys.argv[1:])
print("LAUNCHES " + json.dumps(ops.LAUNCHES))
"""


def _zoo_config(arch: str):
    """The architecture's full config, cut in depth where ``ZOO_REDUCED``
    says so (jamba: its first five layers, every width kept)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch == JAMBA:
        cfg = dataclasses.replace(cfg, n_layers=5,
                                  layer_pattern=cfg.layer_pattern[:5])
    return cfg


def _scan_err(name, got, want) -> float:
    """Largest |got - want|; raises past rtol = atol = ``SCAN_TOL``."""
    import torch

    diff = (got - want).abs()
    worst = (diff / (SCAN_TOL + SCAN_TOL * want.abs())).max().item()
    check(worst <= 1.0 and bool(torch.isfinite(got).all()),
          f"selective_scan {name}: {diff.max().item()} from its plain "
          f"version ({worst} of the tolerance)")
    return diff.max().item()


def _ptxas(name: str) -> dict:
    """What ptxas said of the kernels of ``csrc/<name>.cu`` as built: how
    many, the most registers one uses, and the stack frame and spill bytes
    summed over them (0 each: every state stays in registers)."""
    from repro_torch.kernels import _build

    report = _build.ptxas_report(name).values()
    return {"kernels": len(report),
            "max_registers": max(v.get("registers", 0) for v in report),
            "stack_frame_bytes": sum(v.get("stack_frame", 0)
                                     for v in report),
            "spill_bytes": sum(v.get("spill_stores", 0)
                               + v.get("spill_loads", 0) for v in report)}


def _scan_inputs(dev, b, t, c, n, given, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    dt = 0.001 + 0.1 * torch.rand((b, t, c), generator=g, device=dev)
    x, bm, cm = (torch.randn(shape, generator=g, device=dev)
                 for shape in ((b, t, c), (b, t, n), (b, t, n)))
    a = -torch.arange(1, n + 1, dtype=torch.float32, device=dev).repeat(c, 1)
    h0 = torch.randn((b, c, n), generator=g, device=dev) if given else None
    return [dt, x, bm, cm, a, h0]


def _scan_cases(dev) -> dict:
    """The selective-scan kernel against its plain version on
    ``SCAN_CASES`` and on a decode step's aliased in-place state; and a
    decode step's scan timed with the state written in place and with h_T
    written anew and copied into the state, as the stack would."""
    import torch
    from repro_torch.benchmarks.timing import device_ms
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as ss

    errs = {}
    for b, t, c, n, given in SCAN_CASES:
        args = _scan_inputs(dev, b, t, c, n, given, seed=t)
        y, h = ss.selective_scan(*args)
        want_y, want_h = ref.selective_scan(*args)
        name = f"{b}x{t}x{c}/N{n}/{'h0' if given else 'zeros'}"
        errs[name] = max(_scan_err(name + "/y", y, want_y),
                         _scan_err(name + "/h", h, want_h))
        check(torch.equal(h, want_h),
              f"selective_scan {name}: h_T not bitwise its plain version")
    args = _scan_inputs(dev, 4, 1, 16384, 16, True, seed=11)
    h0 = args[5]
    want_y, want_h = ref.selective_scan(*args[:5], h0.clone())
    y, h = ss.selective_scan(*args[:5], h0, state_out=h0)
    check(h is h0, "the aliased state is the one returned")
    errs["aliased_4x1x16384/N16"] = max(
        _scan_err("aliased/y", y, want_y), _scan_err("aliased/h", h0, want_h))
    check(torch.equal(h0, want_h),
          "selective_scan: the aliased state not bitwise its plain version")

    def copied():
        _, h = ss.selective_scan(*args[:5], h0)
        h0.copy_(h)

    decode_ms = {
        "in_place": device_ms(lambda: ss.selective_scan(
            *args[:5], h0, state_out=h0), reps=20, inner=50),
        "anew_and_copied": device_ms(copied, reps=20, inner=50)}
    del args, h0, want_y, want_h, y, h
    torch.cuda.empty_cache()
    return {"errors": errs, "decode_step_ms": decode_ms,
            "timing": "CUDA events, median of 20 runs of 50 back-to-back "
                      "calls at (4, 1, 16,384, N = 16)"}


def _scan_live(model, prompt) -> dict:
    """The selective-scan kernel on the float32 inputs a served prefill
    gives each Mamba layer, against its plain version within 2e-5 (y and
    h_T), and its time at that shape beside the plain version's and the
    bound."""
    import torch
    from repro_torch.benchmarks.timing import device_ms, selective_scan_bound
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import selective_scan as ss

    seen = []
    launch = ops.selective_scan

    def witness(*args, **kw):
        seen.append(args)
        return launch(*args, **kw)

    ops.selective_scan = witness
    try:
        model.prefill(prompt, cache_capacity=prompt.shape[1],
                      attn_impl="kernel", logits_mode="last")
    finally:
        ops.selective_scan = launch
    errs = []
    for i, args in enumerate(seen):
        check(args[5] is None and args[1].shape == seen[0][1].shape,
              f"Mamba layer {i}: a prefill's scan starts from zeros")
        y, h = ss.selective_scan(*args)
        want_y, want_h = ref.selective_scan(*args)
        errs.append({"y": _scan_err(f"layer {i}/y", y, want_y),
                     "h": _scan_err(f"layer {i}/h", h, want_h),
                     "y_max_abs": want_y.abs().max().item(),
                     "h_bitwise": bool(torch.equal(h, want_h))})
        check(errs[-1]["h_bitwise"],
              f"selective_scan layer {i}: h_T not bitwise its plain version")
        del y, h, want_y, want_h
    args = seen[0]
    ms = device_ms(lambda: ss.selective_scan(*args), reps=10, inner=5)
    plain_ms = device_ms(lambda: ref.selective_scan(*args), reps=3, inner=1)
    b, t, c = args[1].shape
    n = args[4].shape[1]
    bound_ms, bound_by = selective_scan_bound(b, t, c, n)
    del seen, args
    torch.cuda.empty_cache()
    return {"shape": {"B": b, "T": t, "C": c, "N": n}, "layers": errs,
            "max_abs_err": max(max(e["y"], e["h"]) for e in errs),
            "tolerance": SCAN_TOL, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms, "library_ms": None,
            "ptxas": _ptxas("selective_scan"),
            "timing": "CUDA events, median of 10 runs of 5 back-to-back "
                      "launches (plain: 3 runs of 1) on layer 0's inputs"}


def _mamba_accuracy(model, prompt, n_attn: int, n_moe: int) -> dict:
    """Each Mamba layer of the kernel-branch bf16 prefill, on the input it
    was given there: its output as served (bf16, the kernel), the bf16
    layer with the plain scan and a float32 copy of the layer with the
    plain scan; the first two as their max distance from the third.  Each
    attention call of that prefill held against the plain version
    (``_flash_witness``).  And the share of (token, slot) routes of each
    MoE layer's served input that a float32 router (the same weights and
    input) would route otherwise."""
    import copy

    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import mamba, moe

    layers_seen, routes_seen = [], []
    forward, route = mamba.mamba_forward, moe.route
    flash = ops.flash_attention
    flash_witness, flash_stats = _flash_witness(flash)

    def mamba_witness(params, x, mc, **kw):
        out = forward(params, x, mc, **kw)
        layers_seen.append((params, mc, x, out[0]))
        return out

    def route_witness(m, xf, mo):
        out = route(m, xf, mo)
        routes_seen.append((m, xf, mo, out[2]))
        return out

    mamba.mamba_forward, moe.route = mamba_witness, route_witness
    ops.flash_attention = flash_witness
    try:
        model.prefill(prompt, cache_capacity=prompt.shape[1],
                      attn_impl="kernel", logits_mode="last")
    finally:
        mamba.mamba_forward, moe.route = forward, route
        ops.flash_attention = flash
    check(len(routes_seen) == n_moe, f"{len(routes_seen)} routed layers")
    check(flash_stats["calls"] == n_attn,
          f"{flash_stats['calls']} attention calls held, expected {n_attn}")

    def plain(*args, state_out=None):
        return ref.selective_scan(*args)

    launch = ops.selective_scan
    result = []
    for params, mc, x, served in layers_seen:
        f32 = copy.deepcopy(params).float()
        ops.selective_scan = plain
        try:
            plain16, _ = forward(params, x, mc)
            want, _ = forward(f32, x.float(), mc)
        finally:
            ops.selective_scan = launch
        result.append({"kernel": _max_diff(served, want),
                       "bf16_plain": _max_diff(plain16, want),
                       "kernel_vs_bf16_plain": _max_diff(served, plain16),
                       "out_max_abs": want.abs().max().item()})
        del f32, plain16, want
    routes = []
    for m, xf, mo, idx16 in routes_seen:
        _, _, idx32 = route(m, xf.float(), mo)
        routes.append(int((idx16 != idx32).sum()) / idx16.numel())
    del layers_seen, routes_seen
    torch.cuda.empty_cache()
    return {"mamba_layers": result, "routes_differ_bf16_vs_f32": (
        sum(routes) / len(routes) if routes else None),
        "routes_differ_by_layer": routes,
        "attention_last_rows": flash_stats["worst"],
        "attention_last_rows_equal_to_rounded_f32": (
            flash_stats["equal"] / flash_stats["total"])}


def _olmoe_flash(dev) -> dict:
    """The tensor-core flash form at olmoe's prefill shape (16 query heads
    over 16 KV heads, D = 128, bf16) against its plain version within the
    bf16 tolerance, timed beside it, PyTorch's attention call and the
    bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.benchmarks.timing import attention_bound, device_ms
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    causal = OLMOE_ATTN[6]
    q, k, v = _qkv(OLMOE_ATTN, torch.bfloat16, dev, seed=124)
    before = fa.LAUNCHES["flash_attention_wgmma"]
    got = fa.flash_attention(q, k, v, causal=causal)
    check(fa.LAUNCHES["flash_attention_wgmma"] == before + 1,
          "olmoe's prefill shape runs the tensor-core form")
    err = _attn_err("olmoe_shape/bfloat16", got,
                    ref.flash_attention(q, k, v, causal=causal),
                    ATTN_TOL["bfloat16"])
    del got
    torch.cuda.synchronize()
    ms = device_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                   reps=20, inner=10)
    plain_ms = device_ms(lambda: ref.flash_attention(q, k, v, causal=causal),
                         reps=3, inner=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps=20, inner=10)
    bound_ms, bound_by, flops = attention_bound(*OLMOE_ATTN, itemsize=2)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    b, tq, tk, hq, hkv, d = OLMOE_ATTN[:6]
    return {"shape": {"B": b, "Tq": tq, "Tk": tk, "Hq": hq, "Hkv": hkv,
                      "D": d, "causal": causal, "dtype": "bfloat16"},
            "max_abs_err": err, "tolerance": ATTN_TOL["bfloat16"],
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ms_issued": 1.5 * bound_ms,
            "tflop_per_s": flops / (ms * 1e-3) / 1e12,
            "timing": "CUDA events, median of 20 runs of 10 back-to-back "
                      "launches (plain: 3 runs of 1)"}


def _zoo_accuracy(model, prompt, n_moe: int) -> dict:
    """qwen3's accuracy measures (``_accuracy``) on one seed, and for a MoE
    model the share of (token, slot) routes of the bf16 reference prefill
    that differ from the float32 one's, over every MoE layer (each layer
    takes the inputs its own run gives it)."""
    from repro_torch.models import moe

    seen = []
    route = moe.route

    def witness(m, xf, mo):
        out = route(m, xf, mo)
        seen.append(out[2])
        return out

    moe.route = witness
    try:
        acc = _accuracy(model, prompt)
    finally:
        moe.route = route
    if n_moe:
        # _accuracy runs the kernel, the bf16 and the float32 prefills
        # (every MoE model here has attention layers)
        check(len(seen) == 3 * n_moe, f"{len(seen)} routed layers")
        r16, r32 = seen[n_moe:2 * n_moe], seen[2 * n_moe:]
        acc["routes_differ_bf16_vs_f32"] = (
            sum(int((a != b).sum()) for a, b in zip(r16, r32))
            / sum(a.numel() for a in r16))
        acc["routes_differ_kernel_vs_bf16"] = (
            sum(int((a != b).sum()) for a, b in zip(seen[:n_moe], r16))
            / sum(a.numel() for a in r16))
    return acc


def _zoo_model(arch: str, dev) -> dict:
    """One architecture at full width in bf16 from seed 0 (full depth but
    where ``ZOO_REDUCED`` cuts it): the launcher's serve path (counts set
    to 0 just before, read just after), three timed runs, a profiled
    prefill and two decode steps, the selective-scan kernel on a served
    prefill's inputs (a model with Mamba layers), and the accuracy rule
    over ``ACC_SEEDS``."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import Model

    cfg = _zoo_config(arch)
    blocks = cfg.layer_pattern * cfg.n_groups
    n_attn = sum(s.mixer == "attn" for s in blocks)
    n_moe = sum(s.ffn == "moe" for s in blocks)
    n_mamba = sum(s.mixer == "mamba" for s in blocks)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    params = model.param_count()
    prompt = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LLM_BATCH, LLM_PROMPT)), dtype=torch.long,
        device=dev)
    transform = serve.business_transform(dev)

    # the main path: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    first = serve.serve(model, prompt, decode_steps=LLM_STEPS,
                        transform=transform)
    launches = dict(ops.LAUNCHES)
    check(launches["flash_attention"] == n_attn
          and launches["flash_attention_wgmma"] == n_attn,
          f"{arch}: {launches} for one prefill and {LLM_STEPS} decode "
          f"steps, expected {n_attn} tensor-core flash launches")
    check(launches["score_pipeline"] == LLM_STEPS + 1,
          f"{arch}: T^Q launched score_pipeline "
          f"{launches['score_pipeline']} times, expected {LLM_STEPS + 1}")
    check(launches["selective_scan"] == n_mamba * (LLM_STEPS + 1),
          f"{arch}: {launches['selective_scan']} selective-scan launches, "
          f"expected {n_mamba} a prefill and a decode step")
    check(sum(launches.values())
          == 2 * n_attn + (n_mamba + 1) * (LLM_STEPS + 1),
          f"{arch}: no other kernel of the port launched: {launches}")
    runs = []
    for _ in range(3):
        before = dict(ops.LAUNCHES)
        runs.append(serve.serve(model, prompt, decode_steps=LLM_STEPS,
                                transform=transform))
        check(all(ops.LAUNCHES[k] - before[k] == launches[k]
                  for k in launches), f"{arch}: launches per run")
    peak = torch.cuda.max_memory_allocated()
    breakdown = _profile(model, prompt, transform, ZOO_SPLIT)
    for res in [first] + runs:
        biz = res.business.float()
        check(bool(((biz >= 0) & (biz <= 1)).all()),
              f"{arch}: business scores in [0, 1]: {biz.tolist()}")
        check(bool(torch.isfinite(res.prefill.logits.float()).all()),
              f"{arch}: finite prefill logits")
        check(res.tokens.shape == (LLM_BATCH, LLM_STEPS),
              f"{arch}: {LLM_STEPS} greedy tokens a row")
    check(all(torch.equal(r.tokens, first.tokens) for r in runs),
          f"{arch}: greedy tokens repeat across runs")
    aux = float(first.prefill.moe_aux)
    check((aux > 0) == (n_moe > 0) and aux == aux,
          f"{arch}: the prefill's MoE aux loss {aux}")
    scan = _scan_live(model, prompt) if n_mamba else None

    seeds = []
    for ws, ps in ACC_SEEDS:
        if ws != 0:
            del model
            gc.collect()
            torch.cuda.empty_cache()
            model = Model(cfg, device=dev, dtype=torch.bfloat16, seed=ws)
        p = torch.tensor(np.random.default_rng(ps).integers(
            0, cfg.vocab_size, (LLM_BATCH, LLM_PROMPT)),
            dtype=torch.long, device=dev)
        acc = (_mamba_accuracy(model, p, n_attn, n_moe) if n_mamba
               else _zoo_accuracy(model, p, n_moe))
        seeds.append({"weight_seed": ws, "prompt_seed": ps, **acc})
    accuracy = (_mamba_rule(arch, seeds) if n_mamba
                else _whole_model_rule(arch, seeds))
    del model
    gc.collect()
    torch.cuda.empty_cache()

    prefill_ms = statistics.median(r.prefill_s for r in runs) * 1e3
    decode_s = statistics.median(r.decode_s for r in runs)
    return {
        "arch": arch,
        "config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                   "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                   "head_dim": cfg.head_dim, "vocab_size": cfg.vocab_size,
                   "pattern": [f"{b.mixer}/{b.ffn}"
                               for b in cfg.layer_pattern],
                   "moe": (None if cfg.moe is None else
                           {"experts": cfg.moe.num_experts,
                            "top_k": cfg.moe.top_k,
                            "d_ff_expert": cfg.moe.d_ff_expert,
                            "capacity_factor": cfg.moe.capacity_factor})},
        "params": params, "config_param_count": cfg.param_count(),
        "reduced": ZOO_REDUCED.get(arch),
        "weight_bytes": weight_bytes, "max_memory_allocated": peak,
        "init_s": init_s, "batch": LLM_BATCH, "prompt_len": LLM_PROMPT,
        "decode_steps": LLM_STEPS, "launches": launches,
        "attention_layers": n_attn, "moe_layers": n_moe,
        "mamba_layers": n_mamba,
        "prefill_ms": prefill_ms,
        "prefill_ms_runs": [r.prefill_s * 1e3 for r in runs],
        "first_prefill_ms": first.prefill_s * 1e3,
        "decode_ms_per_token": decode_s / LLM_STEPS * 1e3,
        "decode_ms_runs": [r.decode_s / LLM_STEPS * 1e3 for r in runs],
        "prefill_tokens_per_s": LLM_BATCH * LLM_PROMPT / (prefill_ms * 1e-3),
        "decode_tokens_per_s": LLM_BATCH * LLM_STEPS / decode_s,
        "moe_aux": aux, **accuracy, "selective_scan": scan,
        "routes_differ_bf16_vs_f32": (
            [a["routes_differ_bf16_vs_f32"] for a in seeds] if n_moe
            else None),
        "accuracy_seeds": seeds,
        "breakdown": breakdown,
        "risk_scores": first.prefill.risk_score.tolist(),
        "business_scores": first.business.tolist(),
        "timing": "host clock, each prefill and each 16-step decode loop "
                  "ended by a device sync; median of 3 runs after one "
                  "warm-up run"}


def _whole_model_rule(arch: str, seeds: list) -> dict:
    """qwen3's rule on whole-model prefills over the seeds: the kernel
    prefill's logits and served risk no farther from float32 than twice the
    bf16 reference's (risk floor 1e-3), attention rows within bf16
    rounding."""
    d_ker = max(a["logits"]["kernel"] for a in seeds)
    d_ref = max(a["logits"]["bf16_reference"] for a in seeds)
    r_ker = max(a["served_risk"]["kernel"] for a in seeds)
    r_ref = max(a["served_risk"]["bf16_reference"] for a in seeds)
    witness = max(a["attention_last_rows"]["kernel"] for a in seeds)
    check(d_ker <= 2 * d_ref, f"{arch}: kernel prefill logits {d_ker} from "
          f"the f32 reference, bf16 reference {d_ref}")
    check(r_ker <= 2 * max(r_ref, 1e-3), f"{arch}: kernel prefill served "
          f"risk {r_ker} from the f32 reference, bf16 reference {r_ref}")
    check(witness <= 1.0, f"{arch}: kernel attention inside the model "
          f"{witness} of its bf16 rounding bound from float32")
    return {"logits_err_kernel_vs_f32": d_ker,
            "logits_err_bf16_ref_vs_f32": d_ref,
            "risk_err_kernel_vs_f32": r_ker, "risk_err_bf16_ref_vs_f32": r_ref,
            "attention_last_rows_vs_f32": witness}


def _mamba_rule(arch: str, seeds: list) -> dict:
    """qwen3's 2x rule at the Mamba sublayer, every layer and seed: the
    served layer (the kernel) no farther from its float32 copy than twice
    the bf16 layer with the plain scan, floor 1e-3; and the attention
    rows within bf16 rounding, as in ``_whole_model_rule``."""
    rows = [(a["weight_seed"], a["prompt_seed"], i, m)
            for a in seeds for i, m in enumerate(a["mamba_layers"])]
    bad = [(ws, ps, i, m) for ws, ps, i, m in rows
           if m["kernel"] > 2 * max(m["bf16_plain"], 1e-3)]
    check(not bad, f"{arch}: Mamba layers farther from float32 than twice "
          f"the bf16 plain layer: {bad}")
    witness = max(a["attention_last_rows"]["kernel"] for a in seeds)
    check(witness <= 1.0, f"{arch}: kernel attention inside the model "
          f"{witness} of its bf16 rounding bound from float32")
    return {"attention_last_rows_vs_f32": witness,
            "mamba_layer_err_kernel_vs_f32": max(
                m["kernel"] for *_, m in rows),
            "mamba_layer_err_bf16_plain_vs_f32": max(
                m["bf16_plain"] for *_, m in rows),
            "mamba_layer_checks": len(rows)}


def _serve_e2e() -> dict:
    """``python -m repro_torch.examples.serve_e2e`` on the card in a
    process of its own: its printed lines and its kernels' launches."""
    import os

    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", E2E_CODE, *E2E_ARGS], capture_output=True,
        text=True, timeout=600, cwd=root,
        env={**os.environ, "PYTHONPATH": str(root / "src")})
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"serve_e2e: {proc.stderr[-2000:]}")
    *lines, last = proc.stdout.strip().splitlines()
    check(last.startswith("LAUNCHES "), f"serve_e2e printed {last!r} last")
    launches = json.loads(last.split(" ", 1)[1])
    check(len(lines) == 7 and lines[0].startswith(
        "deployed 3 predictors over 3 physical models")
        and lines[3].startswith("shadow evaluations recorded: 320 ")
        and lines[4] == "calibration refresh gate (Eq. 5) open: True"
        and lines[5].startswith("after live T^Q refresh: score=")
        and lines[6].startswith("after promotion: bank1 served by "
                                "bank1-ensemble-v2 (routing v2)"),
          f"serve_e2e printed {lines}")
    check(launches["score_pipeline_banked"] > 0,
          f"serve_e2e's windows launched the banked kernel: {launches}")
    return {"lines": lines, "launches": launches, "seconds": seconds}


def phase_zoo_serve(dev) -> dict:
    """olmoe-1b-7b, xlstm-1.3b and jamba-1.5-large-398b's first five layers
    at full width through the serve launcher, each freed before the next;
    the selective-scan kernel on small cases; the flash kernel at olmoe's
    prefill shape; the end-to-end serving example on the card."""
    t0 = time.perf_counter()
    models = {}
    for arch in ZOO_ARCHS:
        t1 = time.perf_counter()
        models[arch] = _zoo_model(arch, dev)
        models[arch]["wall_s"] = time.perf_counter() - t1
    scan_cases = _scan_cases(dev)
    flash = _olmoe_flash(dev)
    e2e = _serve_e2e()
    result = {"phase": "zoo_serve", "models": models,
              "selective_scan_cases": scan_cases,
              "olmoe_flash": flash, "serve_e2e": e2e,
              "wall_s": time.perf_counter() - t0}
    emit(result)
    return result


# ---------------------------------------------------------------- phase 13
SCORE_TOL = {"float32": 2e-5,    # the reference's kernel tolerances
             "bfloat16": 2e-2}   # (tests/test_kernels.py::_tol)
QM_CASES = ((16, 8), (1000, 64), (4096, 256), (333, 33))   # (scores, N)
SP_CASES = ((64, 3, 32), (1000, 8, 256), (7, 1, 8))        # (rows, K, N)
# timed here at a serve window (rows, K, N); bench_kernels times its own size
SCORE_WINDOW = (WINDOW, len(GROUP), 256)


def _tables(rng, n, dev):
    """(src, ref) float32 knots as the reference's tests make them: sorted
    uniform, the source table spanning [0, 1]."""
    import numpy as np
    import torch

    src = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    refq = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    src[0], src[-1] = 0.0, 1.0
    return torch.tensor(src, device=dev), torch.tensor(refq, device=dev)


LAST_KNOT_TABLES = (2000, 128, 256)   # tables, their knots, the bank's N


def _last_knot_cases(dev, errs) -> dict:
    """Scores on, one ulp past and one ulp below the last knot of 2,000
    random 128-knot tables (references of a fraud score's shape: mass near
    0, last knot 1), each table alone and edge-padded to 256 knots: through
    the three T^Q kernels (quantile_map, score_pipeline with identity T^C
    and A, and the banked kernel on both its paths), the padded tables'
    results must equal the unpadded ones bit for bit, and a score on or
    past the last knot must map to exactly the last reference knot."""
    import numpy as np
    import torch
    from repro_torch.kernels import quantile_map as qm
    from repro_torch.kernels import ref
    from repro_torch.kernels import score_pipeline as sp

    tables, n, n_bank = LAST_KNOT_TABLES
    rng = np.random.default_rng(19)
    src = np.sort(rng.uniform(0, 1, (tables, n)), -1).astype(np.float32)
    refq = np.concatenate([np.sort(rng.beta(0.3, 5, (tables, n - 1)), -1),
                           np.ones((tables, 1))], -1).astype(np.float32)
    pad = ((0, 0), (0, n_bank - n))
    last = src[:, -1]
    x = np.stack([last, np.nextafter(last, np.float32(np.inf)),
                  np.nextafter(last, np.float32(-np.inf))], -1)

    def dev32(a):
        return torch.tensor(np.ascontiguousarray(a, np.float32), device=dev)

    unpadded = (dev32(src), dev32(refq))
    padded = (dev32(np.pad(src, pad, "edge")), dev32(np.pad(refq, pad,
                                                           "edge")))
    xs = dev32(x)
    one = torch.ones(1, device=dev)
    want_last = dev32(refq[:, -1])
    out = {}
    for kind in ("quantile_map", "score_pipeline"):
        got = {}
        for name, (qs, qr) in (("unpadded", unpadded), ("padded", padded)):
            rows = []
            for i in range(tables):
                if kind == "quantile_map":
                    args = (xs[i], qs[i], qr[i])
                    rows.append(qm.quantile_map(*args))
                else:
                    args = (xs[i][:, None], one, one, qs[i], qr[i])
                    rows.append(sp.score_pipeline(*args))
                if i % 97 == 0:      # a sample against the plain version
                    errs[f"last_knot/{kind}/{name}/{i}"] = _compare(
                        f"last_knot/{kind}/{name}/{i}", rows[-1],
                        getattr(ref, kind)(*args))
            got[name] = torch.stack(rows)
        check(torch.equal(got["padded"], got["unpadded"]),
              f"last_knot/{kind}: padded tables not bitwise the unpadded")
        check(torch.equal(got["unpadded"][:, :2],
                          want_last[:, None].expand(-1, 2)),
              f"last_knot/{kind}: on or past the last knot is not qr[-1]")
        out[kind] = "bitwise"
    # the banked kernel, both paths: banks of 100 tables (they fit in
    # shared memory at N = 256), each row's 3 scores repeated to 30,000
    # rows so the shared path has its rows
    chunk, reps = 100, 100
    ones = torch.ones(chunk, 1, device=dev)
    for path in ("shared", "global"):
        for c in range(0, tables, chunk):
            tid = torch.arange(chunk, dtype=torch.int32,
                               device=dev).repeat_interleave(3).repeat(reps)
            y = xs[c:c + chunk].reshape(-1, 1).repeat(reps, 1)
            res = {}
            for name, (qs, qr) in (("unpadded", unpadded),
                                   ("padded", padded)):
                bank = (ones, ones, qs[c:c + chunk].contiguous(),
                        qr[c:c + chunk].contiguous())
                res[name] = _launch_path(path, y, tid, bank)().clone()
                if c == 0:
                    errs[f"last_knot/banked_{path}/{name}"] = _compare(
                        f"last_knot/banked_{path}/{name}", res[name],
                        ref.score_pipeline_banked(y, tid, *bank))
            check(torch.equal(res["padded"], res["unpadded"]),
                  f"last_knot/banked_{path}: padded not bitwise unpadded")
            check(torch.equal(res["unpadded"].view(reps, chunk, 3)[0, :, :2],
                              want_last[c:c + chunk, None].expand(-1, 2)),
                  f"last_knot/banked_{path}: on or past the last knot "
                  "is not qr[-1]")
        out[f"banked_{path}"] = "bitwise"
    return {"tables": tables, "knots": n, "bank_knots": n_bank, **out}


def phase_score_kernels(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.benchmarks.timing import (
        device_ms, quantile_map_bound, score_pipeline_bound)
    from repro_torch.kernels import quantile_map as qm
    from repro_torch.kernels import ref
    from repro_torch.kernels import score_pipeline as sp

    t0 = time.perf_counter()
    rng = np.random.default_rng(13)
    kernels = {"quantile_map": qm.quantile_map,
               "score_pipeline": sp.score_pipeline}

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    def params(k):
        return f32(rng.uniform(0.02, 1.0, k)), f32(rng.uniform(0.5, 2.0, k))

    errs: dict[str, float] = {}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        def cmp(kind, name, *args, exact=False):
            # the shared-parameter kernel sums and interpolates in its
            # plain version's order: bit for bit on every case
            key = f"{kind}/{name}/{dname}"
            got = kernels[kind](*args)
            errs[key] = _compare(key, got, getattr(ref, kind)(*args),
                                 exact=exact or kind == "score_pipeline",
                                 tol=SCORE_TOL[dname])
            return got

        def scores(shape, lo=0.0, hi=1.0):
            return f32(rng.uniform(lo, hi, shape)).to(dtype)

        src, refq = _tables(rng, 256, dev)
        # knots the scores' dtype holds exactly, with a flat run whose
        # reference jumps; a score ON knot j maps to qr[j] bitwise
        # (s - qs[j] = 0), and on the last knot to qr[-1]
        knots = src.clone()
        knots[100:120] = knots[100]
        knots = knots.to(dtype).float()
        on = knots.to(dtype)
        flat = src.clone()
        flat[40:90] = flat[40]
        unsorted = f32(rng.uniform(0, 1, 256))
        narrow = 0.4 + 0.2 * src
        outside = torch.cat([scores(2048, -1.0, -0.01),
                             scores(2048, 1.01, 2.0)])

        # the reference's cases, then draws of its property sweeps
        sweep = [(int(rng.integers(1, 513)), int(rng.choice([4, 16, 64, 128])))
                 for _ in range(8)]
        for m, nq in QM_CASES + tuple(sweep):
            cmp("quantile_map", f"{m}x{nq}", scores(m), *_tables(rng, nq, dev))
        cmp("quantile_map", "on_knots", on[:-1], knots, refq, exact=True)
        got = cmp("quantile_map", "last_knot", on[-1:], knots, refq,
                  exact=True)
        check(float(got[0]) == float(refq[-1].to(dtype)),
              "the last knot maps to exactly the last reference knot")
        y = scores(4096)
        y[::7] = float("nan")
        got = cmp("quantile_map", "nan", y, src, refq)
        check(bool(torch.isnan(got[::7]).all()), "NaN scores map to NaN")
        cmp("quantile_map", "out_of_support", outside, narrow, refq,
            exact=True)
        cmp("quantile_map", "flat_segments", scores(4096), flat, refq)
        cmp("quantile_map", "all_flat", scores(4096),
            torch.full_like(src, 0.5), refq)
        cmp("quantile_map", "unsorted", scores(4096), unsorted, refq)
        cmp("quantile_map", "m1", scores(1), src, refq)
        got = cmp("quantile_map", "batch_4x7x9", scores((4, 7, 9)),
                  *_tables(rng, 32, dev))
        check(got.shape == (4, 7, 9), "quantile_map keeps the batch shape")
        # M no multiple of the block (and of a 16-byte pack of scores),
        # scores off a 16-byte boundary, N = 2, 4,096 and N not a multiple
        # of 4, tables that fail the block's sortedness proof (the exact
        # count)
        y = scores(131_088, -0.1, 1.1)
        y[::11] = float("nan")
        for m in range(131_073, 131_080):
            cmp("quantile_map", f"tail_{m}", y[:m], src, refq)
            cmp("quantile_map", f"tail_{m - 131_000}", y[:m - 131_000], src,
                refq)
        for off in (1, 2, 3, 7):
            cmp("quantile_map", f"offset_{off}", y[off:off + 131_072], src,
                refq)
        cmp("quantile_map", "on_knots_offset",
            torch.cat([on[:1], on[:-1]])[1:], knots, refq, exact=True)
        for nq in (2, 4_095, 4_096):
            cmp("quantile_map", f"n{nq}", y[:8_191], *_tables(rng, nq, dev))
        nan_knot = src.clone()
        nan_knot[77] = float("nan")
        for name, table in (("nan_knot", nan_knot),
                            ("descending", src.flip(0).contiguous()),
                            ("unsorted", unsorted)):
            cmp("quantile_map", f"{name}_nan_scores", y[:8_191], table, refq)

        sweep = [(int(rng.integers(1, 301)), int(rng.integers(1, 10)), 64)
                 for _ in range(8)]
        for m, k, nq in SP_CASES + tuple(sweep):
            cmp("score_pipeline", f"{m}x{k}x{nq}", scores((m, k), 0.01, 0.99),
                *params(k), *_tables(rng, nq, dev))
        one = torch.ones(1, device=dev)   # K=1, beta=1, w=1: agg == score
        cmp("score_pipeline", "on_knots", on[:-1, None], one, one, knots,
            refq, exact=True)
        y = scores((4096, 8))
        y[::13, 3] = float("nan")
        got = cmp("score_pipeline", "nan", y, *params(8), src, refq)
        check(bool(torch.isnan(got[::13]).all()), "NaN scores score NaN")
        cmp("score_pipeline", "out_of_support",
            torch.cat([scores((2048, 3), 0.0, 0.02),
                       scores((2048, 3), 0.98, 1.0)]), *params(3),
            narrow, refq)
        cmp("score_pipeline", "flat_segments", scores((4096, 8)), *params(8),
            flat, refq)
        # the block's proof sends an unsorted or NaN-knot table to the
        # exact count and a sorted or flat one to the search; K = 8 reads
        # 16 bytes at a time (8 bf16 or 4 float32 a read where K allows)
        for k in (3, 8):
            for name, table in (("unsorted", unsorted),
                                ("nan_knot", nan_knot), ("flat", flat),
                                ("all_flat", torch.full_like(src, 0.5))):
                y = scores((4096, k), -0.1, 1.1)
                y[::17, 0] = float("nan")
                cmp("score_pipeline", f"{name}_k{k}", y, *params(k), table,
                    refq)
        cmp("score_pipeline", "m1", scores((1, 8)), *params(8), src, refq)
        got = cmp("score_pipeline", "batch_4x7x9", scores((4, 7, 9, 3)),
                  *params(3), *_tables(rng, 32, dev))
        check(got.shape == (4, 7, 9), "score_pipeline keeps the batch shape")
    torch.cuda.synchronize()
    last_knot = _last_knot_cases(dev, errs)

    # times at a serve window, float32, inputs drawn as the benchmark draws
    # them; the benchmark's size is timed by bench_kernels (phase 15)
    m, k, nq = SCORE_WINDOW
    y = f32(rng.uniform(0, 1, (m, k)))
    x = y[:, 0].contiguous()
    betas, weights = f32(rng.uniform(0.02, 0.5, k)), f32(np.ones(k))
    src, refq = (f32(np.sort(rng.uniform(0, 1, nq))) for _ in range(2))
    runs = {"quantile_map": ((x, src, refq), {"M": m, "N": nq},
                             quantile_map_bound(m, nq, 4)),
            "score_pipeline": ((y, betas, weights, src, refq),
                               {"M": m, "K": k, "N": nq},
                               score_pipeline_bound(m, k, nq, 4))}
    timings: dict[str, dict] = {}
    for kind, (args, shape, bound) in runs.items():
        err = _compare(f"{kind}/window", kernels[kind](*args),
                       getattr(ref, kind)(*args),
                       exact=kind == "score_pipeline")
        timings[kind] = {
            "shape": shape, "max_abs_err": err,
            "ms": device_ms(lambda: kernels[kind](*args)),
            "plain_ms": device_ms(lambda: getattr(ref, kind)(*args),
                                  inner=10),
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}
    result = {"phase": "score_kernels", "tolerance": SCORE_TOL,
              "errors": errs, "on_knots": "bitwise", "nan_scores": "NaN",
              "score_pipeline": "bitwise on every case",
              "last_knot": last_knot, "timings": timings,
              "timing": "CUDA events, median of 20 runs of 50 back-to-back "
                        "launches (plain: 10) queued behind a busy card: "
                        "throughput, not the latency of one launch",
              "wall_s": time.perf_counter() - t0}
    emit(result)
    return result


# ---------------------------------------------------------------- phase 14
DECODE_TOL = 2e-5   # float32; bf16 runs the kernel's own check (bf16_excess)
# (b, s, hq, hkv, d, valid lengths)
DECODE_CASES = {
    "gqa_256": (2, 256, 8, 2, 64, (256, 256)),   # the reference's four
    "partial_300": (1, 512, 4, 4, 32, (300,)),   # cases and its per-row
    "qpk8_128": (4, 128, 16, 2, 64, (128,) * 4),  # lengths
    "ragged_77": (1, 100, 2, 1, 32, (77,)),
    "per_row": (3, 128, 4, 2, 32, (1, 64, 128)),
    "zero_and_past_s": (3, 200, 4, 2, 64, (0, 500, 130)),
    "s_777": (2, 777, 8, 2, 64, (777, 400)),      # S not a multiple of 64
    "d80": (2, 300, 4, 4, 80, (300, 150)),
    "d128_qpk1": (1, 640, 8, 8, 128, (640,)),
    "d128_qwen3": (2, 1000, 32, 8, 128, (1000, 999)),
}
# the main path's shapes, every position valid: bench_kernels' (which
# times the kernel there) and the decode of qwen3-8b as llm_serve runs it
# (prompt 2,048 + 16 steps), each checked in float32 and bf16
DECODE_SHAPES = {"bench": (4, 16_384, 8, 2, 64),
                 "qwen3_8b": (LLM_BATCH, LLM_PROMPT + LLM_STEPS, 32, 8, 128)}


def _decode_inputs(case, dtype, dev, seed):
    import torch

    b, s, hq, hkv, d = case[:5]
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d))]


def _decode_err(name, got, q, k, v, vlen) -> float:
    """The decode kernel's output against its plain version: float32
    within 2e-5; bf16 against the plain version run in float32 on the same
    bf16 inputs, within bf16's rounding of o (``bf16_excess``)."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref

    if q.dtype == torch.float32:
        return _attn_err(name, got, ref.decode_attention(q, k, v, vlen),
                         DECODE_TOL)
    check(got.dtype == q.dtype and got.shape == q.shape,
          f"{name}: shape/dtype")
    want = ref.decode_attention(q.float(), k.float(), v.float(), vlen)
    check(bool(got.float().isfinite().all()), f"{name}: non-finite output")
    excess = da.bf16_excess(got, want)
    check(excess <= 0, f"{name}: outside bf16 rounding of the float32 "
          f"plain version by {excess}")
    return (got.float() - want).abs().max().item()


def _queued(fn, calls: int, cycles: int, lead: int = 0) -> dict:
    """CUDA-event times of ``calls`` back-to-back calls of ``fn`` queued
    behind a sleep of ``cycles`` and ``lead`` untimed calls, as
    ``device_ms`` queues them: the sleep's time (with the lead calls), the
    time a timed call, and the host's time to issue the timed calls."""
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(cycles)
    for _ in range(lead):
        fn()
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ev[2].record()
    issue_ms = (time.perf_counter() - t0) * 1e3
    ev[2].synchronize()
    return {"sleep_ms": ev[0].elapsed_time(ev[1]),
            "ms": ev[1].elapsed_time(ev[2]) / calls, "issue_ms": issue_ms}


def _cold_ms(fns, reps: int = 10) -> float:
    """``device_ms`` with the L2 cache cold: ``fns`` call the function on
    copies of its inputs that together exceed the 50 MB L2, twice round
    in each timed run, so no call finds its inputs in L2."""
    import torch
    from repro_torch.benchmarks.timing import SLEEP_CYCLES

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        calls = iter(fns * 2)
        times.append(_queued(lambda: next(calls)(), 2 * len(fns),
                             SLEEP_CYCLES)["ms"])
    return statistics.median(times)


def _decode_trace(fn, calls: int = 20) -> dict | None:
    """Where a timed call of the decode kernel spends its time.  One queued
    loop as ``device_ms`` times it, under ``torch.profiler``: its event
    times, the launches a call, a call's period (the median gap between
    successive split passes' starts), the combine's tail (the median time
    from a split pass's end to its combine's end) and the split pass's part
    of the period (the period less the tail).  Both kernels are launched
    with programmatic dependent launch, so a kernel's span in the trace
    starts before the kernel before it has ended and includes its wait for
    it; the spans are reported beside the rest.  The other kernels the
    trace holds; the same loop behind a sleep five times as long, and
    behind the sleep and one untimed call.  The trace may miss a few
    kernels, so it counts those it holds; None where it holds too few."""
    import torch
    from repro_torch.benchmarks.timing import SLEEP_CYCLES
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = _queued(fn, calls, SLEEP_CYCLES)
    check(traced["issue_ms"] < traced["sleep_ms"], "the sleep outlasts the "
          f"host's issue of the calls ({traced}), so the events time the card")
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    split = [e for e in kernels if "decode_split_" in e.name]
    combine = [e for e in kernels if "decode_combine_kernel" in e.name]
    if min(len(split), len(combine)) < calls // 2:
        return None
    starts = [e.time_range.start for e in split]
    period = statistics.median((b - a) / 1e3
                               for a, b in zip(starts, starts[1:]))
    # each split pass with the first combine that ends after it
    tails = []
    for e in split:
        after = [c.time_range.end for c in combine
                 if c.time_range.end > e.time_range.end]
        if after:
            tails.append((min(after) - e.time_range.end) / 1e3)
    tail = statistics.median(tails)
    others: dict[str, int] = {}
    for e in kernels:
        if "decode_" not in e.name:
            others[e.name] = others.get(e.name, 0) + 1
    return {"traced_loop": traced,
            "launches_per_call": (len(split) + len(combine)) / calls,
            "period_ms": period, "combine_tail_ms": tail,
            "split_pass_ms": period - tail,
            "span_ms": {k: statistics.median(e.time_range.elapsed_us()
                                             for e in v) / 1e3
                        for k, v in (("split_pass", split),
                                     ("combine", combine))},
            "traced": {"split_pass": len(split), "combine": len(combine)},
            "other_kernels": others,
            "long_sleep": _queued(fn, calls, 5 * SLEEP_CYCLES),
            "after_one_call": _queued(fn, calls, SLEEP_CYCLES, lead=1)}


def _decode_timed(label, shape, dev, errs) -> dict:
    """A timed shape, every position valid: float32 and bf16 checked; the
    kernel's time warm (float32 and bf16) and L2-cold (bf16), SDPA's warm
    and cold beside it, the plain version's, the bounds and a traced loop
    (a call's launches among them)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.benchmarks.timing import decode_bound, device_ms
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref

    b, s, hq, hkv, d = shape
    vlen = torch.full((b,), s, dtype=torch.int32, device=dev)
    q, k, v = _decode_inputs(shape, torch.float32, dev, seed=100)
    errs["float32"][label] = _decode_err(
        f"{label}/float32", da.decode_attention(q, k, v, vlen), q, k, v,
        vlen)
    f32_ms = device_ms(lambda: da.decode_attention(q, k, v, vlen), inner=20)
    f32_bound = decode_bound([s] * b, hq, hkv, d, 4)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    err = _decode_err(f"{label}/bfloat16", da.decode_attention(q, k, v, vlen),
                      q, k, v, vlen)
    errs["bfloat16"][label] = err
    bound_ms, bound_by = decode_bound([s] * b, hq, hkv, d, 2)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            enable_gqa=True)

    # enough copies of the caches that each call's K and V left L2
    copies = [(k, v)] + [(k.clone(), v.clone()) for _ in
                         range(-(-100_000_000 // (2 * k.nbytes)))]
    cold = _cold_ms([lambda kv=kv: da.decode_attention(q, *kv, vlen)
                     for kv in copies])
    library_cold = _cold_ms([lambda kv=kv: sdpa(q, *kv) for kv in copies])
    del copies
    share = bound_ms / cold
    check(share <= 1.0, f"{label}: the cold time {cold} ms is under the "
          f"bound {bound_ms} ms: an error of the timer")
    ms = device_ms(lambda: da.decode_attention(q, k, v, vlen), inner=20)
    trace = _decode_trace(lambda: da.decode_attention(q, k, v, vlen))
    check(trace is None or (trace["launches_per_call"] <= 2
                            and not trace["other_kernels"]),
          f"{label}: a call is at most two launches and nothing else")
    return {
        "shape": {"B": b, "S": s, "Hq": hq, "Hkv": hkv, "D": d,
                  "valid_len": s, "dtype": "bfloat16"},
        "plan": dict(zip(("splits", "chunk"),
                         da.plan_splits(b, hkv, s, d, torch.bfloat16))),
        "max_abs_err": err,
        "ms": ms, "cold_ms": cold, "bound_ms": bound_ms, "bound_by": bound_by,
        "share_of_bound_cold": share,
        "within_2x_bound": {"warm": ms <= 2 * bound_ms,
                            "cold": cold <= 2 * bound_ms},
        "library_ms": device_ms(lambda: sdpa(q, k, v), inner=20),
        "library_cold_ms": library_cold,
        "plain_ms": device_ms(lambda: ref.decode_attention(q, k, v, vlen),
                              reps=5, inner=3),
        "float32": {"ms": f32_ms, "bound_ms": f32_bound[0],
                    "bound_by": f32_bound[1]},
        "trace": trace}


def phase_decode_attention(dev) -> dict:
    import torch
    from repro_torch.kernels import decode_attention as da

    t0 = time.perf_counter()
    errs: dict[str, dict[str, float]] = {}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        errs[dname] = {}
        for i, (name, case) in enumerate(DECODE_CASES.items()):
            q, k, v = _decode_inputs(case, dtype, dev, seed=i)
            vlen = torch.tensor(case[5], dtype=torch.int32, device=dev)
            got = da.decode_attention(q, k, v, vlen)
            # a row with no valid position: exactly 0 from the kernel (the
            # plain version's finite NEG_INF averages it instead)
            empty = vlen == 0
            check(bool((got[empty] == 0).all()),
                  f"{name}/{dname}: rows with valid_len 0 are exactly 0")
            errs[dname][name] = _decode_err(
                f"{name}/{dname}", got[~empty], q[~empty], k[~empty],
                v[~empty], vlen[~empty])
    torch.cuda.synchronize()

    timings = {label: _decode_timed(label, shape, dev, errs)
               for label, shape in DECODE_SHAPES.items()}
    result = {"phase": "decode_attention",
              "cases": {n: list(c) for n, c in DECODE_CASES.items()},
              "tolerance": {"float32": DECODE_TOL,
                            "bfloat16": {"rtol": da.BF16_RTOL,
                                         "atol": da.BF16_ATOL,
                                         "against": "plain version in "
                                                    "float32"}},
              "errors": errs, "valid_len_0": "exactly 0", "timings": timings,
              "timing": "CUDA events, median of 20 runs of 20 back-to-back "
                        "calls (plain: 5 runs of 3) queued behind a busy "
                        "card; cold: median of 10 runs, each calling twice "
                        "round copies of the caches that exceed L2; one "
                        "call is two launches; trace: one warm loop under "
                        "torch.profiler",
              "wall_s": time.perf_counter() - t0}
    emit(result)
    return result


# ---------------------------------------------------------------- phase 15
def phase_bench_kernels() -> dict:
    """The kernel microbenchmark, ``repro_torch.benchmarks.bench_kernels``,
    at full size: the path of the three scoring and decode kernels."""
    from repro_torch.benchmarks import bench_kernels
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    res = bench_kernels.run()
    launches = res["launches"]
    off = [n for n, e in res["entries"].items() if not e["kernel_allclose"]]
    check(not off, f"bench_kernels entries off their plain versions: {off}")
    check(all(n > 0 for n in launches.values()),
          f"bench_kernels launches every kernel: {launches}")
    result = {"phase": "bench_kernels", "launches": launches, "result": res,
              "wall_s": time.perf_counter() - t0}
    emit(result)
    return result


# ---------------------------------------------------------------- phase 16
# jamba's first layer at full width: what is cut, and the built count (the
# config's 2,098,053,121 omits conv_b and dt_bias)
TRAIN_REDUCED = {"n_layers": "72 -> 1 (period position 0: Mamba + MLP; a "
                             "second layer is a 16-expert MoE, 195 GB of "
                             "training state)"}
TRAIN_PARAMS = 2_098_085_889
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 12
TRAIN_LR = (3e-4, 2)            # peak of the cosine schedule, warm-up steps
GRAD_SEEDS = (0, 1, 2)          # the gradient rule's cotangents (and rows)
# (B, T, C, N, h0 given, dh_T nonzero): T = 1, T past and not a multiple of
# the 16-step chunk or of 64, C not a multiple of the 128-channel block,
# N = 1, 3, 5, 8 and 16
SCAN_BWD_CASES = ((2, 1, 128, 16, True, True), (3, 70, 200, 8, False, False),
                  (1, 129, 33, 16, True, False), (4, 300, 130, 8, True, True),
                  (2, 64, 256, 16, False, True), (2, 37, 130, 1, True, True),
                  (1, 19, 33, 3, False, True), (3, 45, 129, 5, True, False))
SCAN_GRADS = ("ddt", "dx", "dBm", "dCm", "dA", "dh0")
TRAIN_SPLIT = {"selective_scan_bwd": ("selective_scan_bwd",),
               "selective_scan": ("selective_scan",)}
FRAUD_ARGS = ()   # train_fraud_scorer at the reference's defaults


def _train_config():
    """jamba-1.5-large-398b cut to its first layer, every width kept."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(JAMBA)
    return dataclasses.replace(cfg, n_layers=1,
                               layer_pattern=cfg.layer_pattern[:1])


def _scan_bwd_errs(tag, got, want) -> float:
    """Every gradient within ``SCAN_TOL`` of the plain backward's."""
    errs = [_scan_err(f"{tag}/{name}", g, w)
            for name, g, w in zip(SCAN_GRADS, got, want) if w is not None]
    return max(errs)


def _scan_bwd_cases(dev) -> dict:
    """The backward kernel against its plain version on ``SCAN_BWD_CASES``
    (the tile checkpoints of the forward too)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as ss

    errs = {}
    for b, t, c, n, given, dh in SCAN_BWD_CASES:
        args = _scan_inputs(dev, b, t, c, n, given, seed=t)
        g = torch.Generator(device=dev).manual_seed(t + 1)
        dy = torch.randn((b, t, c), generator=g, device=dev)
        dh_t = torch.randn((b, c, n), generator=g, device=dev) if dh else None
        _, _, chunks = ss.selective_scan(*args, chunk_states=True)
        _, _, want_chunks = ref.selective_scan(*args, chunk_states=True)
        name = (f"{b}x{t}x{c}/N{n}/{'h0' if given else 'zeros'}/"
                f"{'dh' if dh else 'no_dh'}")
        chunk_err = _scan_err(name + "/chunks", chunks, want_chunks)
        got = ss.selective_scan_backward(*args[:5], chunks, dy, dh_t,
                                         want_dh0=given)
        want = ref.selective_scan_backward(*args[:5], chunks, dy, dh_t,
                                           want_dh0=given)
        errs[name] = max(chunk_err, _scan_bwd_errs(name, got, want))
        check(torch.equal(chunks, want_chunks) and all(
            torch.equal(g, w) for g, w in zip(got, want) if w is not None),
            f"selective_scan_bwd {name}: not bitwise its plain version")
    return errs


def _plain_scan_fn():
    """A stand-in for ``ops.selective_scan`` that runs the plain forward
    and the plain backward on the card (for the gradient rule's baselines,
    outside the port)."""
    import torch
    from repro_torch.kernels import ref

    class PlainScan(torch.autograd.Function):
        @staticmethod
        def forward(dt, x, b_mat, c_mat, a, h0):
            return ref.selective_scan(dt, x, b_mat, c_mat, a, h0,
                                      chunk_states=True)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.mark_non_differentiable(output[2])
            ctx.save_for_backward(*inputs[:5], output[2])

        @staticmethod
        def backward(ctx, dy, dh_t, _):
            dt, x, b_mat, c_mat, a, chunks = ctx.saved_tensors
            got = ref.selective_scan_backward(dt, x, b_mat, c_mat, a, chunks,
                                              dy.contiguous(),
                                              dh_t.contiguous())
            return (*got[:5], None)

    def scan(*args, state_out=None):
        return PlainScan.apply(*args)[:2]

    return scan


def _grad_rule(layer, live_x, mc) -> dict:
    """The Mamba layer's parameter gradients on one batch row of step 1's
    live input (B = 1, T = 2,048), each seed's cotangent drawn on the card:
    through the kernels in bf16 (as trained), through the plain scan and
    backward in bf16, and through the plain pair in float32 on the float32
    input.  Each distance is max |g - g_f32| over max |g_f32| per
    parameter; the kernels' no farther than twice the bf16 plain layer's
    (floor 1e-3): zoo_serve's 2x rule for jamba, on the gradients."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import mamba

    names = [n for n, _ in layer.named_parameters()]
    plain, launch = _plain_scan_fn(), ops.selective_scan

    def grads(x, cot, scan):
        ops.selective_scan = scan
        try:
            out, _ = mamba.mamba_forward(layer, x, mc)
            found = torch.autograd.grad(
                torch.sum(out.float() * cot), list(layer.parameters()))
        finally:
            ops.selective_scan = launch
        return dict(zip(names, found))

    seeds, bad = [], []
    for seed in GRAD_SEEDS:
        row = seed % live_x.shape[0]
        x16 = live_x[row:row + 1]
        g = torch.Generator(device=x16.device).manual_seed(seed)
        cot = torch.randn(x16.shape, generator=g, device=x16.device)
        want = grads(x16.float(), cot, plain)
        kernel, plain16 = grads(x16, cot, launch), grads(x16, cot, plain)
        dist = {}
        for name in names:
            scale = max(want[name].abs().max().item(), 1e-30)
            d_ker = _max_diff(kernel[name], want[name]) / scale
            d_plain = _max_diff(plain16[name], want[name]) / scale
            dist[name] = {"kernel": d_ker, "bf16_plain": d_plain}
            if d_ker > 2 * max(d_plain, 1e-3):
                bad.append((seed, name, d_ker, d_plain))
        seeds.append({"seed": seed, "row": row, "distances": dist})
        del want, kernel, plain16
    check(not bad, f"Mamba gradients through the kernels farther from "
          f"float32 than twice the bf16 plain layer: {bad}")
    return {"seeds": seeds, "checks": len(seeds) * len(names),
            "kernel_vs_f32": max(d["kernel"] for s in seeds
                                 for d in s["distances"].values()),
            "bf16_plain_vs_f32": max(d["bf16_plain"] for s in seeds
                                     for d in s["distances"].values())}


def _scan_bwd_live(args) -> dict:
    """The backward kernel on the float32 inputs step 1 gave it, against
    its plain version within 2e-5, timed beside it and its bound."""
    import torch
    from repro_torch.benchmarks.timing import (device_ms,
                                               selective_scan_bwd_bound)
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as ss

    got = ss.selective_scan_backward(*args)
    want = ref.selective_scan_backward(*args)
    err = _scan_bwd_errs("live", got, want)
    bitwise = all(torch.equal(g, w) for g, w in zip(got, want)
                  if w is not None)
    check(bitwise, "selective_scan_bwd: step 1's gradients not bitwise its "
          "plain version")
    ptxas = _ptxas("selective_scan_bwd")
    check(ptxas["stack_frame_bytes"] == 0 and ptxas["spill_bytes"] == 0,
          f"selective_scan_bwd: ptxas reports a stack or spills: {ptxas}")
    del got, want
    ms = device_ms(lambda: ss.selective_scan_backward(*args), reps=5,
                   inner=3)
    plain_ms = device_ms(lambda: ref.selective_scan_backward(*args), reps=2,
                         inner=1)
    b, t, c = args[1].shape
    n = args[4].shape[1]
    bound_ms, bound_by = selective_scan_bwd_bound(b, t, c, n,
                                                  dh_t=args[7] is not None)
    return {"shape": {"B": b, "T": t, "C": c, "N": n}, "max_abs_err": err,
            "bitwise": bitwise, "tolerance": SCAN_TOL, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms, "library_ms": None,
            "ptxas": ptxas,
            "timing": "CUDA events, median of 5 runs of 3 back-to-back "
                      "calls (two launches each; plain: 2 runs of 1) on "
                      "step 1's inputs"}


def _train_fraud_scorer() -> dict:
    """``python -m repro_torch.examples.train_fraud_scorer`` at the
    reference's defaults on the card, in a process of its own, then again
    from its checkpoints: each run's summary and seconds."""
    import os
    import tempfile

    root = Path(__file__).resolve().parent
    runs = []
    with tempfile.TemporaryDirectory() as ckpt_dir:
        for _ in range(2):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m",
                 "repro_torch.examples.train_fraud_scorer", "--ckpt-dir",
                 ckpt_dir, *FRAUD_ARGS], capture_output=True, text=True,
                timeout=600, cwd=root,
                env={**os.environ, "PYTHONPATH": str(root / "src")})
            check(proc.returncode == 0,
                  f"train_fraud_scorer: {proc.stderr[-2000:]}")
            lines = proc.stdout.strip().splitlines()
            loss = lines[-1].split()
            check(loss[0] == "loss" and loss[2] == "->",
                  f"train_fraud_scorer printed {lines[-1]!r} last")
            runs.append({"seconds": time.perf_counter() - t0,
                         "first_loss": float(loss[1]),
                         "last_loss": float(loss[3]), "summary": lines[-1],
                         "resumed": any(ln.startswith("resumed params from")
                                        for ln in lines)})
    first, again = runs
    check(first["last_loss"] < first["first_loss"] and not first["resumed"],
          f"train_fraud_scorer: the loss falls: {first}")
    check(again["resumed"] and again["first_loss"] < first["first_loss"],
          f"train_fraud_scorer resumes from its checkpoint: {again}")
    return {"runs": runs}


def phase_train(dev) -> dict:
    """Training on the card: the scan's backward kernel on small cases;
    jamba-1.5-large-398b's first layer at full width trained 12 steps by
    ``Trainer.fit`` (counts set to 0 just before, read just after); the
    backward kernel on step 1's live inputs; the gradient rule over three
    seeds; one profiled step; then ``train_fraud_scorer`` and its resume."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.models import Model, mamba
    from repro_torch.training import AdamW, Trainer, cosine_schedule
    from repro_torch.training.data import TokenStream

    t0 = time.perf_counter()
    cases = _scan_bwd_cases(dev)
    torch.cuda.empty_cache()
    cfg = _train_config()
    t1 = time.perf_counter()
    model = Model(cfg, device=dev, dtype=torch.float32, seed=0)
    trainer = Trainer(model, AdamW(learning_rate=cosine_schedule(
        TRAIN_LR[0], TRAIN_LR[1], TRAIN_STEPS)), remat=True,
        compute_dtype=torch.bfloat16)
    state = trainer.init_state(None)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t1
    params = model.param_count()
    check(params == TRAIN_PARAMS, f"{params} parameters built")
    stream = iter(TokenStream(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH))

    # step 1's Mamba input and its scan backward's arguments, recorded
    live = {}
    forward, backward = mamba.mamba_forward, ss.selective_scan_backward

    def forward_witness(params, x, mc, **kw):
        live.setdefault("x", x.detach())
        return forward(params, x, mc, **kw)

    def backward_witness(*args, **kw):
        live.setdefault("bwd", tuple(
            a.detach() if isinstance(a, torch.Tensor) else a for a in args))
        return backward(*args, **kw)

    mamba.mamba_forward, ss.selective_scan_backward = (forward_witness,
                                                       backward_witness)
    lines = []
    torch.cuda.reset_peak_memory_stats()
    try:
        # the main path: counts set to 0 just before, read just after
        for name in ops.LAUNCHES:
            ops.LAUNCHES[name] = 0
        state, history = trainer.fit(state, stream, TRAIN_STEPS, log_every=1,
                                     log_fn=lines.append)
        launches = dict(ops.LAUNCHES)
    finally:
        mamba.mamba_forward, ss.selective_scan_backward = forward, backward
    peak = torch.cuda.max_memory_allocated()
    check(launches == {**{k: 0 for k in launches},
                       "selective_scan": 2 * TRAIN_STEPS,
                       "selective_scan_bwd": TRAIN_STEPS,
                       "selective_scan_bwd_reduce": TRAIN_STEPS},
          f"train launches {launches}: 2 forward scans (remat recomputes "
          f"one) and one backward of each kernel a step, nothing else")
    losses = [r["loss"] for r in history]
    gnorms = [r["grad_norm"] for r in history]
    check(len(history) == TRAIN_STEPS
          and all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"finite losses and gradient norms: {losses}, {gnorms}")
    check(losses[-1] < losses[0], f"the loss falls: {losses}")
    elapsed = [r["elapsed_s"] for r in history]
    step_ms = [(b - a) * 1e3 for a, b in zip([0.0] + elapsed, elapsed)]
    ms = statistics.median(step_ms[-8:])

    bwd_live = _scan_bwd_live(live.pop("bwd"))
    rule = _grad_rule(model.stack[0].mixer, live.pop("x"), cfg.mamba)
    torch.cuda.empty_cache()

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    step = iter([next(stream)])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t1 = time.perf_counter()
        state, _ = trainer.fit(state, step, 1, log_fn=lambda line: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    split = _device_split(prof, TRAIN_SPLIT)
    del state, trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    fraud = _train_fraud_scorer()
    result = {
        "phase": "train", "arch": JAMBA, "reduced": TRAIN_REDUCED,
        "params": params, "config_param_count": cfg.param_count(),
        "train_state_bytes": 16 * params, "init_s": init_s,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "compute_dtype": "bfloat16", "remat": True,
        "lr": {"peak": TRAIN_LR[0], "warmup": TRAIN_LR[1]},
        "log": lines, "history": history, "step_ms": step_ms,
        "ms_per_step": ms,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (ms * 1e-3),
        "max_memory_allocated": peak, "launches": launches,
        "launches_per_step": {k: v / TRAIN_STEPS for k, v in launches.items()
                              if v},
        "profiled_step": {"wall_ms": wall * 1e3, "split": split,
                          "device_busy_share": (split["device_ms_total"]
                                                / (wall * 1e3)
                                                if split else None)},
        "scan_bwd_cases": cases, "scan_bwd_live": bwd_live,
        "grad_rule": rule, "train_fraud_scorer": fraud,
        "timing": "host clock: each step of Trainer.fit ends in a device "
                  "sync (its logged loss); ms a step the median of the "
                  "last 8",
        "wall_s": time.perf_counter() - t0}
    emit(result)
    return result


# ---------------------------------------------------------------- phase 17
ROOFLINE_CAP = 1.05     # a share over this means the count is wrong
DRYRUN_CELL = ("qwen3-8b", "decode_32k")


def _roofline_path(path: str, arch: str, cfg, shape, seconds: float,
                   measured_peak: int, *, param_bytes: int,
                   launches: dict, cache_capacity: int | None = None
                   ) -> dict:
    """One measured path against the one-card roofline: the dry-run's
    trace of the same step at the run's shape on meta (its kernels' calls
    held to the run's launches), the analytic terms with the run's real
    parameter and cache bytes, and the shares of the measured time."""
    from repro_torch.benchmarks.timing import BF16_FLOPS, HBM_BYTES_PER_S
    from repro_torch.launch import dryrun, roofline

    counts = dryrun.count_step(arch, shape, cfg=cfg)
    bundle = counts.pop("bundle")
    pb, cb = dryrun.step_bytes(bundle, cache_capacity)
    check(pb == param_bytes, f"{path}: the dry-run's parameter bytes {pb} "
          f"are the run's {param_bytes}")
    calls = {k: v["calls"] for k, v in counts["kernels"].items()}
    check(calls == {k: v for k, v in launches.items() if v},
          f"{path}: the trace's kernel calls {calls} are the run's "
          f"launches {launches}")
    t = roofline.terms(cfg, shape, shape.kind, param_bytes=pb,
                       cache_bytes=cb)
    shares = {"mfu": t["model_flops"] / (seconds * BF16_FLOPS),
              "flops_share": t["flops"] / (seconds * BF16_FLOPS),
              "hbm_share": t["bytes"] / (seconds * HBM_BYTES_PER_S),
              "roofline_share": max(t["compute_s"], t["memory_s"])
              / seconds}
    check(max(shares.values()) <= ROOFLINE_CAP,
          f"{path}: a share of the roofline over {ROOFLINE_CAP}: {shares}")
    peak = counts["argument_bytes"] + counts["temp_bytes"]
    check(counts["argument_bytes"] <= measured_peak,
          f"{path}: the dry-run's {counts['argument_bytes']} argument bytes "
          f"exceed the measured peak {measured_peak}")
    return {"path": path, "arch": arch, "kind": shape.kind,
            "batch": shape.global_batch, "seq_len": shape.seq_len,
            "measured_s": seconds, **shares,
            "bottleneck": t["bottleneck"],
            "model_flops": t["model_flops"], "analytic_flops": t["flops"],
            "analytic_hbm_bytes": t["bytes"], "param_bytes": pb,
            "cache_bytes": cb, "compute_s": t["compute_s"],
            "memory_s": t["memory_s"], "counted_flops": counts["flops"],
            "counted_bytes": counts["bytes"], "kernel_calls": calls,
            "predicted": {"argument_bytes": counts["argument_bytes"],
                          "temp_bytes": counts["temp_bytes"],
                          "peak_bytes": peak},
            "measured_peak": measured_peak,
            "predicted_over_measured_peak": peak / measured_peak,
            "traced_groups": counts["traced_groups"],
            "trace_s": counts["seconds"]}


def _dryrun_cli() -> dict:
    """``python -m repro_torch.launch.dryrun`` on one full-size cell in a
    process of its own, into a scratch directory."""
    import os
    import tempfile

    root = Path(__file__).resolve().parent
    arch, shape = DRYRUN_CELL
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", out], capture_output=True,
            text=True, timeout=600, cwd=root,
            env={**os.environ, "PYTHONPATH": str(root / "src")})
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0, f"dryrun CLI: {proc.stderr[-2000:]}")
        cell = json.loads((Path(out) / f"{arch}__{shape}__h100.json")
                          .read_text())
    check(cell["device"] == "meta"
          and cell["roofline"]["bottleneck"] == "memory",
          f"dryrun CLI cell: {cell['device']}, "
          f"{cell['roofline']['bottleneck']}")
    return {"cell": f"{arch}__{shape}", "seconds": seconds,
            "memory_analysis": cell["memory_analysis"],
            "fits_one_card": cell["fits_one_card"],
            "roofline": {k: cell["roofline"][k] for k in (
                "compute_s", "memory_s", "bottleneck", "flops_per_chip",
                "bytes_per_chip", "counted_flops", "counted_bytes")},
            "stdout": proc.stdout.strip().splitlines()[-2:]}


def phase_roofline(dev, llm: dict, zoo: dict, train: dict,
                   smi: str = "") -> dict:
    """Every path the llm_serve, zoo_serve and train phases timed, read
    against the one-card roofline (``launch/roofline.py``) at that run's
    batch, length and kind: mfu, flops_share, hbm_share, roofline_share and
    the bottleneck, none over 1.05; the dry-run's predicted bytes of each
    step against the run's measured peak; then the dry-run's CLI on one
    full-size cell.  Nothing is timed again."""
    from repro_torch.configs import InputShape, get_config

    t0 = time.perf_counter()
    paths = []
    models = [(llm["arch"], get_config(llm["arch"]), llm)] + [
        (arch, _zoo_config(arch), m) for arch, m in zoo["models"].items()]
    for arch, cfg, m in models:
        b, t, steps = m["batch"], m["prompt_len"], m["decode_steps"]
        runs = steps + 1
        paths.append(_roofline_path(
            f"{arch} prefill", arch, cfg,
            InputShape("serve_prefill", t, b, "prefill"),
            m["prefill_ms"] / 1e3, m["max_memory_allocated"],
            param_bytes=m["weight_bytes"], cache_capacity=t + steps,
            launches={"flash_attention": m["launches"]["flash_attention"],
                      "selective_scan": m["launches"]["selective_scan"]
                      // runs}))
        paths.append(_roofline_path(
            f"{arch} decode", arch, cfg,
            InputShape("serve_decode", t + steps, b, "decode"),
            m["decode_ms_per_token"] / 1e3, m["max_memory_allocated"],
            param_bytes=m["weight_bytes"],
            launches={"selective_scan": m["launches"]["selective_scan"]
                      // runs}))
    steps = train["steps"]
    paths.append(_roofline_path(
        f"{JAMBA} train step", JAMBA, _train_config(),
        InputShape("train_step", train["seq"], train["batch"], "train"),
        train["ms_per_step"] / 1e3, train["max_memory_allocated"],
        param_bytes=train["train_state_bytes"],
        launches={"selective_scan": train["launches"]["selective_scan"]
                  // steps,
                  "selective_scan_bwd": train["launches"][
                      "selective_scan_bwd"] // steps}))
    cli = _dryrun_cli()
    result = {"phase": "roofline", "nvidia_smi": smi,
              "device": str(dev), "cap": ROOFLINE_CAP,
              "rates": "H100 SXM published peaks: 989e12 bf16 FLOP/s, "
                       "3.35e12 HBM bytes/s",
              "paths": paths, "dryrun_cli": cli,
              "wall_s": time.perf_counter() - t0}
    emit(result)
    return result


# ---------------------------------------------------------------- phase 18
def _benched(name: str, source: str, replaces: str, bench: dict,
             library_ms: float | None, also: dict) -> dict:
    """A kernels-line entry from bench_kernels' run (phase 15), the path of
    the kernel, with the shapes a phase before it timed beside it."""
    e = next(e for e in bench["result"]["entries"].values()
             if e["kernel"] == name)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": bench["launches"][name],
            "max_abs_err": e["max_abs_err"], "ms": e["us_per_call"] / 1e3,
            "plain_ms": e["plain_us_per_call"] / 1e3,
            "bound_ms": e["bound_us"] / 1e3, "bound_by": e["bound_by"],
            "library_ms": library_ms, "shape": e["shape"], "also": also}


def phase_kernels(kernel: dict, serve: dict, main: dict, lifecycle: dict,
                  engine: dict, tiering: dict, sharding: dict,
                  main_bench: dict, paper_bench: dict, attention: dict,
                  llm: dict, zoo: dict, scores: dict, decode: dict,
                  bench: dict, train: dict) -> None:
    from repro_torch.benchmarks.timing import banked_bound, device_ms
    from repro_torch.kernels import ref
    from repro_torch.kernels import score_pipeline as sp

    simt = attention["simt_f32"]
    raws, idx, bank = main["raws"], main["idx"], main["bank"]
    m, k = raws.shape
    t, n = bank[2].shape
    err = _compare("main_path", sp.score_pipeline_banked(raws, idx, *bank),
                   ref.score_pipeline_banked(raws, idx, *bank))
    ms = device_ms(lambda: sp.score_pipeline_banked(raws, idx, *bank))
    plain_ms = device_ms(lambda: ref.score_pipeline_banked(raws, idx, *bank),
                         inner=10)
    bound_ms, bound_by = banked_bound(m, k, t, n)
    emit({"kernels": [{
        "name": "score_pipeline_banked", "route": "cuda",
        "source": "src/repro_torch/csrc/score_pipeline_banked.cu",
        "replaces": "src/repro/kernels/score_pipeline.py:122",
        "launches": serve["launches"]["score_pipeline_banked"],
        # the lifecycle phase's own run: served windows and audit replays
        "lifecycle_launches": lifecycle["launches"],
        # the engine path (each run's timed stream, and the tiered serve
        # run) and the tiered stores' dispatches, each counted on its own
        "engine_launches": engine["launches"],
        "tiering_launches": tiering["launches"]["score_pipeline_banked"],
        # the sharded paths (benchmark, uneven assignment, the serve
        # topologies, publishes under traffic) and the two main-path
        # benchmarks, each counted on its own
        "sharding_launches": sharding["launches"],
        "main_bench_launches": {
            k: v["score_pipeline_banked"]
            for k, v in main_bench["launches"].items()},
        # the paper's benchmarks that serve, each counted on its own
        "paper_bench_launches": {
            k: v["score_pipeline_banked"]
            for k, v in paper_bench["launches"].items()
            if "score_pipeline_banked" in v},
        # the end-to-end serving example's windows, in its own process
        "serve_e2e_launches": zoo["serve_e2e"]["launches"][
            "score_pipeline_banked"],
        "max_abs_err": max(err, kernel["max_abs_err"],
                           lifecycle["max_abs_err_vs_plain"]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "shape": {"M": m, "K": k, "T": t, "N": n},
        "path": sp.banked_path(t, n, m, *sp.card(raws.device)),
        "realistic": {key: kernel[key] for key in
                      ("shape", "ms", "plain_ms", "bound_ms", "bound_by")},
        "timings": kernel["timings"],
    }, {
        "name": "flash_attention_wgmma", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention.py:25",
        "launches": llm["launches"]["flash_attention_wgmma"],
        "max_abs_err": attention["max_abs_err"],
        "ms": attention["ms"], "plain_ms": attention["plain_ms"],
        "bound_ms": attention["bound_ms"], "bound_by": attention["bound_by"],
        "library_ms": attention["library_ms"],
        "bound_ms_issued": attention["bound_ms_issued"],
        "shape": attention["shape"], "path": "bf16 prefill (llm_serve)",
        # olmoe-1b-7b's and jamba's prefills (zoo_serve), each counted on
        # its own, and the kernel at olmoe's shape (16/16 heads of 128)
        "olmoe_launches": zoo["models"]["olmoe-1b-7b"]["launches"][
            "flash_attention_wgmma"],
        "jamba_launches": zoo["models"][JAMBA]["launches"][
            "flash_attention_wgmma"],
        "olmoe_shape": zoo["olmoe_flash"],
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:25",
        "launches": llm["f32_path"]["launches"]["flash_attention"],
        **{key: simt[key] for key in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")},
        "shape": {**attention["shape"], "dtype": "float32"},
        "path": "float32 prefill (llm_serve)",
    }, {**_benched("quantile_map", "src/repro_torch/csrc/quantile_map.cu",
                   "src/repro/kernels/quantile_map.py:25", bench, None,
                   {"window": scores["timings"]["quantile_map"]}),
        # Figs. 4 and 6: T^Q of the live scores, each counted on its own,
        # and the kernel's largest difference from its plain version there
        "paper_bench_launches": {
            k: v["quantile_map"] for k, v in paper_bench["launches"].items()
            if "quantile_map" in v},
        "paper_bench_max_abs_err": max(
            c["max_abs_err"] for checks in paper_bench["tq_vs_plain"].values()
            for c in checks.values()),
        "paper_bench_live": paper_bench["quantile_map_live"]},
        {**_benched("score_pipeline", "src/repro_torch/csrc/score_pipeline.cu",
                    "src/repro/kernels/score_pipeline.py:57", bench, None,
                    {"window": scores["timings"]["score_pipeline"],
                     "serving_latency_4096": main_bench["serving_latency"][
                         "transform_pipeline_4096"]}),
         # the main path's two benchmarks, each counted on its own
         "main_bench_launches": {
             k: v["score_pipeline"]
             for k, v in main_bench["launches"].items()},
         # the serve launcher's T^Q after the prefill and each decode step,
         # each model's path counted on its own
         "llm_launches": {
             LLM_ARCH: llm["launches"]["score_pipeline"],
             **{arch: m["launches"]["score_pipeline"]
                for arch, m in zoo["models"].items()}}},
        _benched("decode_attention",
                 "src/repro_torch/csrc/decode_attention.cu",
                 "src/repro/kernels/decode_attention.py:24", bench,
                 decode["timings"]["bench"]["library_ms"],
                 decode["timings"]),
        _selective_scan_entry(zoo, train),
        _selective_scan_bwd_entry(train)]})


def _selective_scan_entry(zoo: dict, train: dict) -> dict:
    """The Mamba scan: launches on jamba's serve path (zoo_serve's main
    path run) and on its training path (the train phase's), its error over
    the small cases and the four layers' live inputs, its times at the
    prefill's shape.  The JAX package computes the scan in XLA, with no
    Pallas kernel."""
    jamba = zoo["models"][JAMBA]
    live = jamba["selective_scan"]
    cases = zoo["selective_scan_cases"]["errors"]
    return {"name": "selective_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/selective_scan.cu",
            "replaces": "src/repro/models/mamba.py:148",
            "replaces_note": "chunk_step, an XLA scan: the JAX package "
                             "has no Pallas kernel for it",
            "launches": jamba["launches"]["selective_scan"],
            "max_abs_err": max(live["max_abs_err"], *cases.values()),
            **{key: live[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "shape")},
            "path": "jamba-1.5-large-398b serve (zoo_serve): 4 a prefill, "
                    "4 a decode step",
            "train_launches": train["launches"]["selective_scan"]}


def _selective_scan_bwd_entry(train: dict) -> dict:
    """The scan's backward: launches on jamba's training path (the train
    phase's main path run), its error over the small cases and step 1's
    live inputs, its times at the training shape.  The JAX package
    differentiates its XLA scan with jax.value_and_grad."""
    live = train["scan_bwd_live"]
    return {"name": "selective_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/selective_scan_bwd.cu",
            "replaces": "src/repro/models/mamba.py:148",
            "replaces_note": "XLA's autodiff of chunk_step: the JAX package "
                             "has no kernel for it",
            "launches": train["launches"]["selective_scan_bwd"],
            "reduce_launches": train["launches"][
                "selective_scan_bwd_reduce"],
            "max_abs_err": max(live["max_abs_err"],
                               *train["scan_bwd_cases"].values()),
            **{key: live[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "shape")},
            "path": "jamba-1.5-large-398b training (train): 1 a step, and "
                    "1 launch of its reduction"}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              f"({src / 'repro_torch'} is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    name, smi = phase_device()
    kernel = phase_kernel(dev)
    setup = _serve_setup(dev)
    serve, main_shapes = phase_serve(dev, setup)
    lifecycle = phase_lifecycle(dev)
    engine = phase_engine(dev, setup)
    tiering = phase_tiering(dev)
    sharding = phase_sharding(dev, setup)
    main_bench = phase_main_bench(dev)
    paper_bench = phase_paper_bench(dev)
    attention = phase_attention(dev)
    llm = phase_llm_serve(dev, attention)
    zoo = phase_zoo_serve(dev)
    scores = phase_score_kernels(dev)
    decode = phase_decode_attention(dev)
    bench = phase_bench_kernels()
    train = phase_train(dev)
    phase_roofline(dev, llm, zoo, train, smi)
    phase_kernels(kernel, serve, main_shapes, lifecycle, engine, tiering,
                  sharding, main_bench, paper_bench, attention, llm, zoo,
                  scores, decode, bench, train)
    emit({"phase": "wall", "seconds": time.perf_counter() - t0})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
