"""One-card dry-run: what each (architecture x input shape) step would do
on one H100, traced on the ``meta`` device.

For every cell: build the step (``specs.build_step``, meta tensors), run it
once under PyTorch's FLOP counter, the kernels' meta tally
(``kernels/ops.py::meta_work``) and a dispatch mode that follows every
storage the step makes and frees, and record

  memory_analysis  argument bytes (parameters, AdamW moments or cache,
                   inputs: exact, from the meta tensors), output bytes, and
                   temp bytes (the peak of what the step holds above its
                   arguments);
  roofline         the analytic terms at the H100's rates
                   (``launch/roofline.py``) beside the trace's counts;
  fits_one_card    arguments + temp against 80 GB, and against the card's
                   own memory where one is present.

Nothing is computed on any device: the step runs on meta wherever the
dry-run is started.  Steps deeper than two groups of the layer pattern are
traced at one and at two groups, and the counts of the whole depth are
extrapolated from them (the groups are identical, so every count is
linear in their number; so is the peak, whose growth a group is what one
more group holds).  The reference's pod meshes, sharding rules, multi-pod
and ``--variant`` bundles and its HLO collective parser belong to a mesh
over several cards (ROADMAP Queue 1 items 13f and 11b).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      [--continue-on-error] [--bf16-moments] [--out DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, applicable_shapes
from repro_torch.kernels import ops
from repro_torch.launch import roofline, specs

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "benchmarks", "results", "dryrun_h100")
TAG = "h100"

# ops that make storage without writing it
_UNWRITTEN = ("empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided")


def _storage(t: torch.Tensor):
    return t.untyped_storage()


class _Trace(TorchDispatchMode):
    """Counts each op's bytes (its tensor inputs read once, its outputs
    written once; views, which move nothing, and storage made without a
    write are not counted) and follows every storage made while it is on:
    its bytes from the op that made it until it is freed, so ``peak`` is
    the most the step held at once beyond what existed before.

    An op that makes new tensors from its inputs and writes none of them
    (``add``, ``exp``, ...) gives outputs whose shapes, strides and dtypes
    are fixed by its inputs' and its other arguments; the second call with
    the same ones is answered from the first, with new meta tensors, and
    not run again.  Many of PyTorch's meta functions are Python, and a
    recurrent loop (the sLSTM's time steps) calls the same few ops tens of
    thousands of times.  Ops the FLOP counter counts are always run."""

    def __init__(self, counted_ops):
        super().__init__()
        self.bytes = 0.0
        self.live: dict[int, int] = {}
        self.now = 0
        self.peak = 0
        self.known: set[int] = set()
        self.counted_ops = set(counted_ops)
        self.answers: dict[tuple, tuple | bool] = {}

    def know(self, tensors) -> None:
        """Storages that exist before the step (its arguments)."""
        for t in tensors:
            self.known.add(_storage(t)._cdata)

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)

    def _follow(self, t: torch.Tensor) -> None:
        st = _storage(t)
        key = st._cdata
        if key in self.live or key in self.known:
            return
        n = st.nbytes()
        self.live[key] = n
        self.now += n
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._free, key)

    def _key(self, func, flat, spec) -> tuple | None:
        """What fixes a functional op's outputs, or None where it may not
        be answered from an earlier call."""
        schema = func._schema
        if (schema.is_mutable or func.overloadpacket in self.counted_ops
                or any(r.alias_info is not None for r in schema.returns)):
            return None
        key = [func, spec]
        for a in flat:
            if isinstance(a, torch.Tensor):
                key.append((a.shape, a.stride(), a.dtype))
            else:
                key.append((type(a), a))
        key = tuple(key)
        try:
            hash(key)
        except TypeError:
            return None
        return key

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat, spec = tree_flatten((args, kwargs))
        ins = [t for t in flat if isinstance(t, torch.Tensor)]
        if not ins or any(t.device.type != "meta" for t in ins):
            # a factory, or host work beside the step (a kernel's count)
            out = func(*args, **kwargs)
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor) and t.device.type == "meta":
                    self._follow(t)
            return out
        key = self._key(func, flat, spec)
        answer = self.answers.get(key) if key is not None else None
        if answer:
            out_spec, metas = answer
            out = tree_unflatten(
                [torch.empty_strided(shape, stride, dtype=dtype,
                                     device="meta")
                 for shape, stride, dtype in metas], out_spec)
        else:
            out = func(*args, **kwargs)
        out_flat, out_spec = tree_flatten(out)
        outs = [t for t in out_flat if isinstance(t, torch.Tensor)]
        if key is not None and answer is None:
            # an op whose schema aliases nothing may still return a view
            # (``_unsafe_view``): such an op is always run
            mine = {_storage(t)._cdata for t in ins}
            fresh = len(outs) == len(out_flat) and not any(
                _storage(t)._cdata in mine for t in outs)
            self.answers[key] = fresh and (
                out_spec, [(t.shape, t.stride(), t.dtype) for t in outs])
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)
        if not view and func.__name__.split(".")[0] not in _UNWRITTEN:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        for t in outs:
            self._follow(t)
        return out


def _unique_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        st = _storage(t)
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


def trace(bundle: specs.StepBundle) -> dict:
    """Run ``bundle``'s step once on meta: counted flops (matmuls by
    PyTorch's counter, kernels by their tally) and bytes, the arguments',
    outputs' and peak temporary bytes, the kernels' calls, seconds."""
    t0 = time.perf_counter()
    args = specs.tensors_of(bundle.abstract_args)
    counter = FlopCounterMode(display=False)
    mode = _Trace(counter.flop_registry)
    mode.know(args)
    with ops.meta_work() as kernels, counter, mode:
        out = bundle.step_fn(*bundle.abstract_args)
    outs = [t for t in specs.tensors_of(out)
            if _storage(t)._cdata not in mode.known]
    result = {
        "flops": float(counter.get_total_flops())
        + sum(k["flops"] for k in kernels.values()),
        "bytes": mode.bytes + sum(k["bytes"] for k in kernels.values()),
        "argument_bytes": _unique_bytes(args),
        "output_bytes": _unique_bytes(outs),
        "temp_bytes": mode.peak,
        "kernels": kernels,
        "seconds": time.perf_counter() - t0,
    }
    del out, outs
    return result


def _at_groups(cfg, groups: int):
    n_pat = len(cfg.layer_pattern)
    return dataclasses.replace(cfg, n_layers=groups * n_pat)


def count_step(arch: str, shape, *, cfg=None, **build_kwargs) -> dict:
    """The trace of one step, at its whole depth: traced outright when it
    is at most two groups of its layer pattern deep, else extrapolated
    from traces at one and at two groups (every count is linear in the
    number of identical groups).  Returns the bundle of the whole depth
    and the counts."""
    bundle = specs.build_step(arch, shape, cfg=cfg, **build_kwargs)
    g = bundle.cfg.n_groups
    if g <= 2:
        counts = trace(bundle)
        counts["traced_groups"] = [g]
    else:
        one = trace(specs.build_step(arch, shape, cfg=_at_groups(
            bundle.cfg, 1), **build_kwargs))
        two = trace(specs.build_step(arch, shape, cfg=_at_groups(
            bundle.cfg, 2), **build_kwargs))
        counts = {k: one[k] + (g - 1) * (two[k] - one[k])
                  for k in ("flops", "bytes", "output_bytes", "temp_bytes")}
        counts["kernels"] = {
            name: {k: one["kernels"].get(name, {}).get(k, 0)
                   + (g - 1) * (two["kernels"][name][k]
                                - one["kernels"].get(name, {}).get(k, 0))
                   for k in ("calls", "flops", "bytes")}
            for name in two["kernels"]}
        counts["argument_bytes"] = _unique_bytes(
            specs.tensors_of(bundle.abstract_args))
        counts["seconds"] = one["seconds"] + two["seconds"]
        counts["traced_groups"] = [1, 2]
    return {"bundle": bundle, **counts}


def step_bytes(bundle: specs.StepBundle, capacity: int | None = None
               ) -> tuple[float, float]:
    """(param_bytes, cache_bytes) the analytic HBM model takes: train, the
    parameters, their gradients and both moments (as the reference's
    dry-run gives them); decode, the parameters and the cache it reads; a
    prefill, the parameters and the cache it writes, one of ``capacity``
    (default the prompt's length; the reference's dry-run passes 0)."""
    if bundle.kind == "train":
        state = bundle.abstract_args[0]
        pb = specs.total_param_bytes(state.params)
        mb = specs.total_param_bytes(state.opt.mu)
        return float(pb * 2 + mb * 2), 0.0
    params = specs.total_param_bytes(bundle.abstract_args[0])
    if bundle.kind == "decode":
        return float(params), float(specs.total_param_bytes(
            bundle.abstract_args[1]))
    if not bundle.cfg.has_decode:
        return float(params), 0.0
    shape = bundle.shape
    return float(params), float(specs.total_param_bytes(
        bundle.model.init_cache(shape.global_batch,
                                capacity or shape.seq_len)))


def _card_memory() -> int | None:
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_properties(0).total_memory


def run_cell(arch: str, shape_name: str, *, moment_dtype=torch.float32,
             out_dir: str = RESULTS_DIR, extra_tag: str = "",
             **build_kwargs) -> dict:
    """Dry-run one cell; writes ``<arch>__<shape>__h100[_tag].json`` into
    ``out_dir`` and returns its record."""
    t0 = time.perf_counter()
    counts = count_step(arch, shape_name, moment_dtype=moment_dtype,
                        **build_kwargs)
    bundle = counts.pop("bundle")
    param_bytes, cache_bytes = step_bytes(bundle)
    resident = counts["argument_bytes"] + counts["temp_bytes"]
    report = roofline.analyze(
        bundle, {"flops": counts["flops"], "bytes": counts["bytes"],
                 "peak_bytes": float(resident)},
        param_bytes_global=param_bytes, cache_bytes_global=cache_bytes)
    card = _card_memory()
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": report.mesh_desc,
        "kind": bundle.kind,
        "device": "meta",
        "moment_dtype": str(moment_dtype).replace("torch.", ""),
        "trace_s": counts["seconds"],
        "wall_s": time.perf_counter() - t0,
        "traced_groups": counts["traced_groups"],
        "n_groups": bundle.cfg.n_groups,
        "memory_analysis": {
            "argument_bytes": counts["argument_bytes"],
            "output_bytes": counts["output_bytes"],
            "temp_bytes": counts["temp_bytes"],
            "alias_bytes": None,
        },
        "param_bytes": param_bytes,
        "cache_bytes": cache_bytes,
        "kernels": counts["kernels"],
        "fits_one_card": {
            "resident_bytes": resident,
            "80GB": resident <= roofline.HBM_CAPACITY_BYTES,
            "card_total_memory": card,
            "card": None if card is None else resident <= card,
        },
        "roofline": report.as_dict(),
    }
    ma = result["memory_analysis"]
    print(f"[dryrun] {arch:>26s} x {shape_name:<12s}"
          f" trace={counts['seconds']:7.1f}s"
          f" args={ma['argument_bytes'] / 2**30:8.2f}GiB"
          f" temp={ma['temp_bytes'] / 2**30:8.2f}GiB"
          f" flops={report.flops_per_chip:.3e}"
          f" counted={report.counted_flops:.3e}"
          f" bottleneck={report.bottleneck}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    tag = TAG + (f"_{extra_tag}" if extra_tag else "")
    with open(os.path.join(out_dir, f"{arch}__{shape_name}__{tag}.json"),
              "w") as f:
        json.dump(result, f, indent=2)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(specs.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--bf16-moments", action="store_true",
                    help="AdamW moments in bf16 (memory optimization)")
    ap.add_argument("--continue-on-error", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR,
                    help="directory of the cells' JSON files")
    args = ap.parse_args(argv)

    moment_dtype = torch.bfloat16 if args.bf16_moments else torch.float32
    cells: list[tuple[str, str]] = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in applicable_shapes(arch):
                cells.append((arch, shape))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells.append((args.arch, args.shape))

    failures = []
    t0 = time.perf_counter()
    for arch, shape in cells:
        try:
            run_cell(arch, shape, moment_dtype=moment_dtype, out_dir=args.out,
                     extra_tag="bf16m" if args.bf16_moments else "")
        except Exception as e:  # noqa: BLE001 - reported, then re-raised
            failures.append((arch, shape, repr(e)))
            print(f"[dryrun] FAILED {arch} x {shape}: {e}")
            if not args.continue_on_error:
                traceback.print_exc()
                raise
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\nall {len(cells)} dry-run cells traced OK in "
          f"{time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
