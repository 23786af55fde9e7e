"""Kernel microbenchmark of the port: each hand-written kernel against its
plain PyTorch version, at the sizes of the reference's
``benchmarks/bench_kernels.py``, with the same inputs and seeds.

Five entries: ``quantile_map`` (65,536 scores, N=256), ``score_pipeline``
(65,536 x K=8), ``score_pipeline_banked`` (65,536 x 8 over 64 tenants,
sorted and adversarial layouts), ``flash_attention`` (1 x 1,024 tokens,
8/2 heads, D=64, bf16, causal) and ``decode_attention`` (4 x 16,384 cache
positions, 8/2 heads, D=64, bf16).  ``--quick`` takes the reference's quick
sizes.  Each entry reports the kernel's time, the plain version's, the
least time the card could take (``benchmarks/timing.py``), the largest
difference between the two and whether they agree at the reference
benchmark's tolerances.

On the card (the default) the kernels run through ``kernels/ops.py`` and
are timed with CUDA events.  With ``--device cpu`` ``ops`` runs the plain
versions and the host clock times them: that run shows that the entry
point works and measures nothing of the card.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_kernels \\
        [--quick] [--device cpu] [--out PATH]

It prints the result as JSON and writes it to ``--out`` when given.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.benchmarks import cli
from repro_torch.benchmarks.timing import (attention_bound, banked_bound,
                                           decode_bound, device_ms, host_ms,
                                           quantile_map_bound,
                                           score_pipeline_bound)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref

SCORE_TOL = dict(rtol=1e-4, atol=1e-5)   # the reference bench's tolerances
ATTN_TOL = dict(rtol=3e-2, atol=3e-2)


def _time_ms(fn, dev: torch.device, reps: int, inner: int) -> float:
    if dev.type == "cuda":
        return device_ms(fn, reps=reps, inner=inner)
    return host_ms(fn)


def _compare(got: torch.Tensor, want: torch.Tensor, tol: dict) -> dict:
    g, w = got.float(), want.float()
    return {"max_abs_err": (g - w).abs().max().item(),
            "kernel_allclose": bool(torch.allclose(g, w, **tol)),
            **tol}


def _entry(kernel, plain, dev, *, tol, bound, reps=(20, 50),
           plain_reps=(20, 10)) -> dict:
    """Check ``kernel()`` against ``plain()``, then time both."""
    result = _compare(kernel(), plain(), tol)
    result["us_per_call"] = _time_ms(kernel, dev, *reps) * 1e3
    result["plain_us_per_call"] = _time_ms(plain, dev, *plain_reps) * 1e3
    result["bound_us"], result["bound_by"] = bound[0] * 1e3, bound[1]
    return result


def run(quick: bool = False, device: torch.device | str | None = None
        ) -> dict:
    """Run the five entries on ``device`` (default: the card, or raise)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    def tensor(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a)).to(dev).to(dtype)

    before = dict(ops.LAUNCHES)
    entries = {}

    # quantile map @ 64k scores, 256-knot tables
    n, nq = (16_384 if quick else 65_536), 256
    scores = tensor(rng.uniform(0, 1, n))
    src = tensor(np.sort(rng.uniform(0, 1, nq)))
    refq = tensor(np.sort(rng.uniform(0, 1, nq)))
    entries[f"quantile_map_{n // 1024}k"] = {
        "kernel": "quantile_map", "shape": {"M": n, "N": nq},
        **_entry(lambda: ops.quantile_map(scores, src, refq),
                 lambda: ref.quantile_map(scores, src, refq), dev,
                 tol=SCORE_TOL, bound=quantile_map_bound(n, nq, 4))}

    # fused score pipeline @ 64k x 8 experts
    k = 8
    raw = tensor(rng.uniform(0, 1, (n, k)))
    betas = tensor(rng.uniform(0.02, 0.5, k))
    weights = torch.ones(k, device=dev)
    entries[f"score_pipeline_{n // 1024}kx{k}"] = {
        "kernel": "score_pipeline", "shape": {"M": n, "K": k, "N": nq},
        **_entry(lambda: ops.score_pipeline(raw, betas, weights, src, refq),
                 lambda: ref.score_pipeline(raw, betas, weights, src, refq),
                 dev, tol=SCORE_TOL,
                 bound=score_pipeline_bound(n, k, nq, 4))}

    # banked pipeline over 64 tenants: sorted runs (what shard-bucketed,
    # per-tenant-bursty windows look like) and a row-interleaved layout.
    # The CUDA kernel has no block skip; the skip rates are a property of
    # the layouts, reported as the reference reports them.
    t_bank = 64
    bank = (tensor(rng.uniform(0.05, 1.0, (t_bank, k))),
            tensor(rng.uniform(0.1, 2.0, (t_bank, k))),
            tensor(np.sort(rng.uniform(0, 1, (t_bank, nq)), -1)),
            tensor(np.sort(rng.uniform(0, 1, (t_bank, nq)), -1)))
    layouts = {"sorted": np.repeat(np.arange(t_bank, dtype=np.int32),
                                   n // t_bank),
               "adversarial": (np.arange(n) % t_bank).astype(np.int32)}
    banked, skip = {}, {}
    for name, ids in layouts.items():
        tid = tensor(ids, torch.int32)
        banked[name] = _entry(
            lambda tid=tid: ops.score_pipeline_banked(raw, tid, *bank),
            lambda tid=tid: ref.score_pipeline_banked(raw, tid, *bank), dev,
            tol=SCORE_TOL, bound=banked_bound(n, k, t_bank, nq))
        skip[name] = ops.banked_skip_stats(ids, block=256)["skip_rate"]
    srt, adv = banked["sorted"], banked["adversarial"]
    entries[f"score_pipeline_banked_{n // 1024}kx{k}"] = {
        "kernel": "score_pipeline_banked",
        "shape": {"M": n, "K": k, "T": t_bank, "N": nq},
        **srt,
        "max_abs_err": max(srt["max_abs_err"], adv["max_abs_err"]),
        "kernel_allclose": srt["kernel_allclose"] and adv["kernel_allclose"],
        "us_per_call_adversarial": adv["us_per_call"],
        "plain_us_per_call_adversarial": adv["plain_us_per_call"],
        "skip_rate_sorted": skip["sorted"],
        "skip_rate_adversarial": skip["adversarial"]}

    # flash attention 1k x 8h GQA, causal
    b, t, hq, hkv, d = 1, (256 if quick else 1024), 8, 2, 64
    bf16 = torch.bfloat16
    q = tensor(rng.normal(0, 1, (b, t, hq, d)), bf16)
    kk = tensor(rng.normal(0, 1, (b, t, hkv, d)), bf16)
    v = tensor(rng.normal(0, 1, (b, t, hkv, d)), bf16)
    entries[f"flash_attention_{t}"] = {
        "kernel": "flash_attention",
        "shape": {"B": b, "T": t, "Hq": hq, "Hkv": hkv, "D": d,
                  "causal": True, "dtype": "bfloat16"},
        **_entry(lambda: ops.flash_attention(q, kk, v, causal=True),
                 lambda: ref.flash_attention(q, kk, v, causal=True), dev,
                 tol=ATTN_TOL,
                 bound=attention_bound(b, t, t, hq, hkv, d, True, 0, 2)[:2],
                 reps=(10, 10), plain_reps=(5, 3))}

    # decode attention over a 16k cache, every position valid
    s = 4096 if quick else 16_384
    qd = tensor(rng.normal(0, 1, (4, hq, d)), bf16)
    kc = tensor(rng.normal(0, 1, (4, s, hkv, d)), bf16)
    vc = tensor(rng.normal(0, 1, (4, s, hkv, d)), bf16)
    vlen = torch.full((4,), s, dtype=torch.int32, device=dev)
    entries[f"decode_attention_{s}"] = {
        "kernel": "decode_attention",
        "shape": {"B": 4, "S": s, "Hq": hq, "Hkv": hkv, "D": d,
                  "valid_len": s, "dtype": "bfloat16"},
        **_entry(lambda: ops.decode_attention(qd, kc, vc, vlen),
                 lambda: ref.decode_attention(qd, kc, vc, vlen), dev,
                 tol=ATTN_TOL, bound=decode_bound([s] * 4, hq, hkv, d, 2),
                 reps=(20, 20), plain_reps=(5, 3))}

    cuda = dev.type == "cuda"
    ran = tuple(e["kernel"] for e in entries.values())
    return {
        "device": torch.cuda.get_device_name(dev) if cuda else str(dev),
        "nvidia_smi": cli.nvidia_smi() if cuda else None,
        "quick": quick,
        "timer": ("CUDA events, median of runs of back-to-back calls queued "
                  "behind a busy card" if cuda else
                  "host clock, median of 3 calls: a CPU run of the plain "
                  "versions, no number of the card"),
        # the launches of each kernel an entry names, and of the forms its
        # wrapper counts under names of its own (the tensor-core flash form)
        "launches": {name: ops.LAUNCHES[name] - before[name]
                     for name in ops.LAUNCHES if name.startswith(ran)},
        "entries": entries}


def main(argv: list[str] | None = None) -> int:
    return cli.main(run, __doc__, argv, ok=lambda result: all(
        e["kernel_allclose"] for e in result["entries"].values()))


if __name__ == "__main__":
    sys.exit(main())
