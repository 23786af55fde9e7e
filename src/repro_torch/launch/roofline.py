"""Roofline terms of one step on one NVIDIA H100.

Three terms per (arch x shape) cell, in seconds:

  compute    = analytic FLOPs / BF16_FLOPS          (989 TFLOP/s, bf16 dense)
  memory     = analytic HBM bytes / HBM_BYTES_PER_S (3.35 TB/s)
  collective = 0: on one card nothing crosses a link

The rates are the H100 SXM's published ones at its full power limit, kept
once in ``benchmarks/timing.py``.  The analytic model (``model_flops``,
``analytic_flops``, ``analytic_hbm_bytes``) is the reference's
``launch/roofline.py`` term for term: a function of the config and the
input shape alone.  Beside it the report carries what the dry-run's trace
counted (``counted_flops``: PyTorch's FLOP counter over the matmuls plus
the kernels' own work; ``counted_bytes``: each traced op's inputs read and
outputs written once), the counterpart of the reference's XLA
``cost_analysis``, as a cross-check.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.benchmarks.timing import BF16_FLOPS, HBM_BYTES_PER_S

HBM_CAPACITY_BYTES = 80e9      # one H100's device memory, 80 GB
ONE_CARD = "one card: no collective, the collective term is 0"


def model_flops(cfg, shape, kind: str) -> float:
    """Global 'useful' FLOPs: 6·N_active·D (train) or 2·N_active·D (fwd)."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


# ---------------------------------------------------------------------------
# analytic cost model (scan-aware, as the reference's: structure-aware
# counts that do not depend on how a compiler or a trace sees the step)
# ---------------------------------------------------------------------------

def analytic_flops(cfg, shape, kind: str) -> float:
    """Global forward+backward matmul FLOPs, structure-aware.

    Counts: projections (2·params per token), attention quadratic terms with
    causal/window truncation, MoE dispatch einsums, SSM scan elementwise work.
    Train multiplies by 4 (fwd + 2·bwd + remat re-fwd).
    """
    from repro_torch.models.config import MambaConfig, XLSTMConfig

    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    t = shape.seq_len
    bsz = shape.global_batch

    if kind == "decode":
        tokens = float(bsz)
        t_ctx = float(min(t, cfg.sliding_window) if cfg.sliding_window else t)
    else:
        tokens = float(bsz * t)
        # average causal context per token
        t_ctx = float(min(t / 2.0, cfg.sliding_window or t))
        if not cfg.causal:
            t_ctx = float(t)  # bidirectional encoder attends to all

    per_token = 0.0
    for spec in cfg.layer_pattern:
        if spec.mixer == "attn":
            proj = 2.0 * (d * hq * hd + 2 * d * hkv * hd + hq * hd * d)
            attn = 2.0 * 2.0 * hq * hd * t_ctx   # QK^T + PV
            per_token += proj + attn
        elif spec.mixer == "mamba":
            mc = cfg.mamba or MambaConfig()
            d_in = mc.expand * d
            rank = mc.dt_rank or -(-d // 16)
            proj = 2.0 * (d * 2 * d_in + d_in * (rank + 2 * mc.d_state)
                          + rank * d_in + d_in * d)
            scan = 10.0 * d_in * mc.d_state      # discretize + assoc-scan
            per_token += proj + scan
        elif spec.mixer == "mlstm":
            xc = cfg.xlstm or XLSTMConfig()
            d_in = int(xc.mlstm_proj_factor * d)
            hd_in = d_in // cfg.n_heads
            q_chunk = min(xc.chunk_size, t) if kind != "decode" else 1
            proj = 2.0 * (d * 2 * d_in + 3 * d_in * hd_in + d_in * d)
            if kind == "decode":
                mix = 2.0 * 3.0 * d_in * hd_in   # state update + readout
            else:
                # intra-chunk causal quadratic (avg ctx Q/2 over scores + PV),
                # + inter-chunk state readout, + per-chunk state update share
                mix = (4.0 * d_in * (q_chunk / 2.0)
                       + 2.0 * d_in * hd_in
                       + 4.0 * d_in * hd_in / q_chunk)
            per_token += proj + mix
        elif spec.mixer == "slstm":
            xc = cfg.xlstm or XLSTMConfig()
            d_up = int(xc.slstm_proj_factor * d)
            per_token += 2.0 * (8.0 * d * d + 2.0 * d * d_up)
        if spec.ffn == "mlp":
            per_token += 2.0 * 3.0 * d * cfg.d_ff
        elif spec.ffn == "moe":
            mo = cfg.moe
            expert = 2.0 * mo.top_k * 3.0 * d * mo.d_ff_expert
            if mo.shared_expert:
                expert += 2.0 * 3.0 * d * (mo.d_ff_shared or mo.d_ff_expert)
            router = 2.0 * d * mo.num_experts
            dispatch = 2.0 * 2.0 * mo.num_experts * (mo.top_k * mo.capacity_factor) * d
            per_token += expert + router + dispatch
    per_token *= cfg.n_groups

    # heads: logits for every token in train/encode, one position otherwise
    if kind == "train" or cfg.is_encoder_only:
        head_tokens = tokens
    elif kind == "prefill":
        head_tokens = float(bsz)
    else:
        head_tokens = tokens
    head = 2.0 * d * cfg.vocab_size * head_tokens + 2.0 * d * tokens  # + score

    fwd = per_token * tokens + head
    if kind == "train":
        return 4.0 * fwd          # fwd + 2x bwd + remat re-forward
    return fwd


def analytic_hbm_bytes(cfg, shape, kind: str, *, param_bytes: float,
                       cache_bytes: float = 0.0) -> float:
    """Global HBM traffic model (documented napkin math, not measured):

    decode  : stream params once + stream cache once + small activations
    prefill : params once + ~6 activation passes/layer + cache write
    train   : ~6x params (grad/moment read-write) + ~10 activation passes
              (fwd write, bwd read, remat rewrite, attention chunks)
    """
    d = cfg.d_model
    t = shape.seq_len
    bsz = shape.global_batch
    act_dtype = 2.0  # bf16
    if kind == "decode":
        act = cfg.n_layers * bsz * d * act_dtype * 6.0
        return param_bytes + cache_bytes + act
    act_pass = cfg.n_layers * bsz * t * d * act_dtype
    logits = bsz * t * cfg.vocab_size * 4.0
    if kind == "prefill":
        return param_bytes + 6.0 * act_pass + cache_bytes + logits / max(t, 1)
    # train
    return 6.0 * param_bytes + 10.0 * act_pass + 3.0 * logits


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh_desc: str
    chips: int
    # scan-aware analytic terms (primary)
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_global: float
    useful_flops_ratio: float
    peak_memory_per_chip: float | None
    collective_counts: dict[str, float]
    collective_bytes_by_kind: dict[str, float]
    # what the trace counted (cross-check only); None when not traced
    counted_flops: float | None
    counted_bytes: float | None
    collective_note: str = ONE_CARD

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def terms(cfg, shape, kind: str, *, param_bytes: float,
          cache_bytes: float = 0.0) -> dict[str, float]:
    """The analytic counts of one step on one card and their times:
    ``flops``, ``bytes``, ``model_flops``, ``compute_s``, ``memory_s``,
    ``bottleneck`` (the larger; the collective term is 0)."""
    flops = analytic_flops(cfg, shape, kind)
    hbm = analytic_hbm_bytes(cfg, shape, kind, param_bytes=param_bytes,
                             cache_bytes=cache_bytes)
    compute_s = flops / BF16_FLOPS
    memory_s = hbm / HBM_BYTES_PER_S
    return {"flops": flops, "bytes": hbm,
            "model_flops": model_flops(cfg, shape, kind),
            "compute_s": compute_s, "memory_s": memory_s,
            "bottleneck": "compute" if compute_s >= memory_s else "memory"}


def analyze(bundle, counted: dict[str, float | None], chips: int = 1, *,
            param_bytes_global: float = 0.0,
            cache_bytes_global: float = 0.0) -> RooflineReport:
    """The roofline of ``bundle``'s step (a ``specs.StepBundle``) on one
    card.  ``counted`` holds the trace's ``flops``, ``bytes`` and
    ``peak_bytes`` (None where not traced), in place of the reference's
    compiled XLA object."""
    if chips != 1:
        raise NotImplementedError(
            "a roofline over several cards needs their collectives: ROADMAP "
            "Queue 1 items 13f and 11b")
    cfg, shape, kind = bundle.cfg, bundle.shape, bundle.kind
    t = terms(cfg, shape, kind, param_bytes=param_bytes_global,
              cache_bytes=cache_bytes_global)
    return RooflineReport(
        arch=bundle.arch, shape=shape.name, mesh_desc="h100x1", chips=1,
        flops_per_chip=t["flops"], bytes_per_chip=t["bytes"],
        collective_bytes_per_chip=0.0,
        compute_s=t["compute_s"], memory_s=t["memory_s"], collective_s=0.0,
        bottleneck=t["bottleneck"], model_flops_global=t["model_flops"],
        useful_flops_ratio=(t["model_flops"] / t["flops"] if t["flops"] > 0
                            else float("nan")),
        peak_memory_per_chip=counted.get("peak_bytes"),
        collective_counts={}, collective_bytes_by_kind={},
        counted_flops=counted.get("flops"),
        counted_bytes=counted.get("bytes"))
