"""Serving launcher: prefill + greedy decode for one architecture, wrapped in
the MUSE transformation pipeline (the paper's Eq. 2 applied to the
risk-score head), on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --smoke \\
      --batch 4 --prompt-len 32 --decode-steps 16

Every decoder of the registry serves but jamba: the dense attention + MLP
models, the MoE models (olmoe-1b-7b, llama4-maverick) and xlstm-1.3b
(sLSTM and mLSTM blocks).  jamba's Mamba mixer raises
``NotImplementedError`` (ROADMAP Queue 1 item 13c), and hubert-xlarge is
encoder-only.  The prefill takes the attention kernel branch
(``attn_impl="kernel"``): attention over prompts of 128 tokens or more runs
the hand-written flash-attention kernel on the card, shorter ones and the
decode steps the chunked reference path; the xLSTM mixers have no kernel.
Each risk score goes through T^Q by ``kernels.ops.score_pipeline``, the
hand-written ``csrc/score_pipeline.cu`` on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.transforms import (
    QuantileMap,
    _unit_grid,
    fraud_reference_quantiles,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.model import Model, ModelOutput


def business_transform(device):
    """Single-model predictor's T^Q onto ``fraud_reference_quantiles(128)``,
    the source grid built as the reference's ``jnp.linspace(0, 1, 128)``:
    Eq. 2 with one expert through ``ops.score_pipeline`` (the kernel on
    the card, its plain version on the CPU)."""
    qm = QuantileMap(_unit_grid(128).to(device),
                     fraud_reference_quantiles(128).to(device))
    ones = torch.ones(1, device=device)

    def transform(scores: torch.Tensor) -> torch.Tensor:
        return ops.score_pipeline(scores[:, None], ones, ones,
                                  qm.src_quantiles, qm.ref_quantiles)

    return transform


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class ServeResult:
    prefill: ModelOutput      # last-token logits, risk scores
    tokens: torch.Tensor      # (B, decode_steps) greedy tokens
    risk: torch.Tensor        # (B,) raw risk score after the last step
    business: torch.Tensor    # (B,) post-T^Q business score
    prefill_s: float          # host seconds, ended by a device sync
    decode_s: float           # host seconds for all decode steps


def serve(model: Model, prompt: torch.Tensor, *, decode_steps: int,
          transform) -> ServeResult:
    """Prefill ``prompt`` (B, T) through the attention kernel branch, then
    ``decode_steps`` greedy steps, each risk score mapped through
    ``transform``; bfloat16 compute throughout."""
    dev = model.device
    capacity = prompt.shape[1] + decode_steps
    _sync(dev)
    t0 = time.perf_counter()
    out, cache = model.prefill(prompt, cache_capacity=capacity,
                               compute_dtype=torch.bfloat16,
                               attn_impl="kernel", logits_mode="last")
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    tok = torch.argmax(out.logits[:, -1], dim=-1)[:, None]
    risk, business, toks = out.risk_score, transform(out.risk_score), []
    t0 = time.perf_counter()
    for i in range(decode_steps):
        step = model.decode_step(cache, tok, pos=prompt.shape[1] + i,
                                 compute_dtype=torch.bfloat16,
                                 attn_impl="kernel")
        cache = step.cache
        tok = torch.argmax(step.logits, dim=-1)[:, None]
        toks.append(tok)
        risk = step.risk_score
        business = transform(risk)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    tokens = torch.cat(toks, dim=1) if toks else tok[:, :0]
    return ServeResult(out, tokens, risk, business, t_prefill, t_decode)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; pass cpu "
                         "to run on the CPU)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only; use forward serving")
    device = resolve_device(args.device)
    model = Model(cfg, device=device, dtype=torch.float32, seed=0)
    transform = business_transform(device)
    rng = np.random.default_rng(0)
    prompt = torch.tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.long, device=device)

    res = serve(model, prompt, decode_steps=args.decode_steps,
                transform=transform)
    print(f"prefill {args.batch}x{args.prompt_len}: "
          f"{res.prefill_s * 1e3:.1f}ms (incl. first-use kernel build)")
    steps = max(args.decode_steps, 1)
    print(f"decode: {res.decode_s / steps * 1e3:.2f}ms/token, "
          f"{args.batch * steps / max(res.decode_s, 1e-9):.0f} tok/s "
          f"on {device}")
    print(f"final business scores (post T^Q): "
          f"{np.round(res.business.cpu().numpy(), 4)}")


if __name__ == "__main__":
    main()
