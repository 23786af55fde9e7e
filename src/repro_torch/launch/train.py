"""Training launcher: the port's train step, on one device or over every
rank ``torchrun`` starts.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --smoke \\
      --steps 50 --batch 16 --seq 64 [--device cpu]
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch qwen3-8b --smoke --device cpu

As the reference's launcher: float32 compute, ``remat=True``, AdamW on
``cosine_schedule(lr, 10, steps)`` (``--bf16-moments`` keeps the moments
in bf16) and the synthetic ``TokenStream``.  One process trains on one
device, the card unless ``--device cpu`` is given.  Started by
``torchrun`` with several processes, the ranks form the reference's mesh
(:func:`make_mesh_for_devices`: ("data", "model") = (n / model, model),
model the largest of 16, 8, 4, 2, 1 that divides n) over gloo with
``--device cpu`` and over NCCL, one rank a card, otherwise; the model is
drawn whole on every rank from the same seed and sharded by the
production rules without FSDP (``models/parallel.py``), each rank takes
its rows of every batch, and rank 0 prints the global batch's metrics.
Only the dense family shards; the full config must fit one card before it
is sharded.  ``--metrics PATH`` writes each step's loss, ce and grad norm
(rank 0).
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.shardings import batch_pspec, local_shard
from repro_torch.models import parallel
from repro_torch.models.model import Model
from repro_torch.training.data import TokenStream
from repro_torch.training.optimizer import AdamW, cosine_schedule
from repro_torch.training.train import Trainer, make_train_step


def make_mesh_for_devices(n: int) -> mesh_lib.Mesh:
    """The reference's mesh for ``n`` devices: (n / model, model)."""
    model = next(c for c in (16, 8, 4, 2, 1) if n % c == 0)
    return mesh_lib.Mesh(("data", mesh_lib.MODEL_AXIS), (n // model, model))


def _start(device: str | None) -> tuple[torch.device, mesh_lib.Mesh | None]:
    """The device and, under ``torchrun`` with several ranks, the live
    mesh over the process group (gloo on the CPU, NCCL on the cards)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    dev = resolve_device(device)
    if world == 1:
        return dev, None
    import torch.distributed as dist

    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    dist.init_process_group({"cuda": "nccl", "cpu": "gloo"}[dev.type],
                            device_id=dev if dev.type == "cuda" else None)
    return dev, mesh_lib.init_mesh(make_mesh_for_devices(world), device=dev)


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
    ap.add_argument("--metrics", default=None,
                    help="write each step's metrics here as JSON")
    args = ap.parse_args(argv)

    dev, mesh = _start(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    lead = mesh is None or mesh.coords() == {a: 0 for a in mesh.axis_names}
    # drawn whole from one seed on every rank, then sharded
    model = Model(cfg, device=dev, seed=None if mesh is None else 0)
    if mesh is not None:
        parallel.parallelize(model, mesh)
    if lead:
        print(f"device: {dev}  arch: {cfg.name}  "
              f"params ~{cfg.param_count()/1e6:.1f}M"
              + ("" if mesh is None else f"  mesh: {mesh.shape}"))

    opt = AdamW(
        learning_rate=cosine_schedule(args.lr, 10, args.steps),
        moment_dtype=torch.bfloat16 if args.bf16_moments else torch.float32,
    )
    state = Trainer(model, opt).init_state(0 if mesh is None else None)
    # a batch that does not divide over the data ranks is whole on each
    step_fn = make_train_step(model, opt, remat=True,
                              compute_dtype=torch.float32,
                              global_batch=args.batch)
    stream = iter(TokenStream(cfg.vocab_size, args.seq, args.batch))

    def rows(a) -> torch.Tensor:
        t = torch.as_tensor(a, dtype=torch.long, device=dev)
        if mesh is None:
            return t
        return local_shard(t, batch_pspec(args.batch, mesh, 1), mesh,
                           mesh.coords()).contiguous()

    history = []
    for step in range(1, args.steps + 1):
        tokens, labels = next(stream)
        if mesh is None:
            state, metrics = step_fn(state, rows(tokens), rows(labels))
        else:
            with mesh_lib.set_mesh(mesh):
                state, metrics = step_fn(state, rows(tokens), rows(labels))
        history.append({"step": step, "loss": float(metrics.loss),
                        "ce": float(metrics.ce_loss),
                        "grad_norm": float(metrics.grad_norm)})
        if lead and step % max(args.steps // 10, 1) == 0:
            print(f"step {step:5d}  loss {float(metrics.loss):.4f}  "
                  f"gnorm {float(metrics.grad_norm):.3f}")
    if lead and args.metrics:
        with open(args.metrics, "w") as f:
            json.dump(history, f)
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    if lead:
        print("done")


if __name__ == "__main__":
    main()
