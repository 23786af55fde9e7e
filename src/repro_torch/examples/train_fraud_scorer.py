"""Training driver: train a transformer risk-scorer end to end.

Trains a reduced-family architecture from the assigned pool (selectable via
--arch) on the synthetic token stream with the full substrate: AdamW +
cosine schedule, remat, checkpointing, resume (of the parameters, as the
reference's driver).  It runs on the card unless ``--device`` names
another; the defaults are the reference's.  --layers/--d-model scale it up.

  PYTHONPATH=src python -m repro_torch.examples.train_fraud_scorer \\
      --steps 200 [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.training.checkpoint import latest_step, restore_checkpoint
from repro_torch.training.data import TokenStream
from repro_torch.training.optimizer import AdamW, cosine_schedule
from repro_torch.training.train import Trainer


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--layers", type=int, default=0, help="override depth")
    ap.add_argument("--d-model", type=int, default=0, help="override width")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    overrides = {}
    if args.layers:
        overrides["n_layers"] = args.layers
    if args.d_model:
        overrides["d_model"] = args.d_model
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    model = Model(cfg, device=dev, seed=None)
    print(f"arch={cfg.name}  params~{cfg.param_count()/1e6:.1f}M  "
          f"steps={args.steps}")

    opt = AdamW(learning_rate=cosine_schedule(args.lr, warmup_steps=20,
                                              total_steps=args.steps))
    trainer = Trainer(model, opt, remat=True, compute_dtype=torch.float32,
                      checkpoint_dir=args.ckpt_dir,
                      checkpoint_every=max(args.steps // 2, 1))
    state = trainer.init_state(0)

    resume = latest_step(args.ckpt_dir)
    if resume:
        restored = restore_checkpoint(args.ckpt_dir, resume, state.params)
        with torch.no_grad():
            for name, p in state.params.items():
                p.copy_(restored[name])
        print(f"resumed params from checkpoint step {resume}")

    stream = iter(TokenStream(cfg.vocab_size, args.seq, args.batch))
    state, history = trainer.fit(state, stream, num_steps=args.steps,
                                 log_every=max(args.steps // 10, 1))
    print(f"\nloss {history[0]['loss']:.3f} -> {history[-1]['loss']:.3f} "
          f"({history[-1]['elapsed_s']:.0f}s); checkpoints in "
          f"{args.ckpt_dir}")
    return history


if __name__ == "__main__":
    main()
