"""Training launcher: the port's train step on one device, the card unless
``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --smoke \\
      --steps 50 --batch 16 --seq 64

As the reference's launcher: float32 compute, ``remat=True``, AdamW on
``cosine_schedule(lr, 10, steps)`` (``--bf16-moments`` keeps the moments
in bf16) and the synthetic ``TokenStream``.  Unlike it, there is no mesh:
the reference shards the parameters over every device it finds
(``make_mesh_for_devices``, the production sharding rules); a train step
across ranks is ROADMAP Queue 1 item 13g.  Without
``--smoke`` the full config must fit one card.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.training.data import TokenStream
from repro_torch.training.optimizer import AdamW, cosine_schedule
from repro_torch.training.train import Trainer, make_train_step


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--bf16-moments", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, device=dev, seed=None)
    print(f"device: {dev}  arch: {cfg.name}  "
          f"params ~{cfg.param_count()/1e6:.1f}M")

    opt = AdamW(
        learning_rate=cosine_schedule(args.lr, 10, args.steps),
        moment_dtype=torch.bfloat16 if args.bf16_moments else torch.float32,
    )
    state = Trainer(model, opt).init_state(0)
    step_fn = make_train_step(model, opt, remat=True,
                              compute_dtype=torch.float32)
    stream = iter(TokenStream(cfg.vocab_size, args.seq, args.batch))
    for step in range(1, args.steps + 1):
        tokens, labels = next(stream)
        state, metrics = step_fn(
            state, torch.as_tensor(tokens, dtype=torch.long, device=dev),
            torch.as_tensor(labels, dtype=torch.long, device=dev))
        if step % max(args.steps // 10, 1) == 0:
            print(f"step {step:5d}  loss {float(metrics.loss):.4f}  "
                  f"gnorm {float(metrics.grad_norm):.3f}")
    print("done")


if __name__ == "__main__":
    main()
