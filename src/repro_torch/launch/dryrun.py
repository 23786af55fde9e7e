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
more group holds).

On the pod meshes (``launch/mesh.py::make_production_mesh``),
:func:`build_shardings` gives every argument and output of a cell's step
its spec under the production rules (``launch/shardings.py``), FSDP
decided as the reference decides it, and :func:`argument_bytes_per_device`
what one rank holds.  ``run_cell(..., mesh=pod)`` traces one rank of the
pod mesh on meta, as the one-card trace does: the step of the model
sharded by ``models/parallel.py``, its collectives counted by kind
(``launch/collectives.py::tally``; on meta they only count), its argument
bytes held to :func:`argument_bytes_per_device`, and the roofline's
collective term over the mesh's slowest link (``launch/roofline.py``).
Every model's cells run, decode included (flash-decoding over the
cache's sequence on "model"; the Mamba and xLSTM mixers on their channel
blocks, ``models/mamba.py`` and ``models/xlstm.py``).

``--variant`` takes the reference's bundles (:func:`variant_build_kwargs`)
over a pod mesh and tags the records as the reference does
(``<arch>__<shape>__h100_pod1_opt.json``): ``opt`` runs train and
prefill with the sequence-parallel residual, train with the bf16 casts
before the FSDP gathers and decode weight-stationary (the residual's d
on the data axes; no weight gathered but the recurrent mixers' that never
touch the residual, ``models/mamba.py``, ``models/xlstm.py``), ``opt2``
adds ``moe_ep_constraint`` (which changes no number in the port),
``opt3`` turns remat off for train and ``opt4`` runs train and prefill
with the all-to-all MoE (``models/moe_a2a.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      [--continue-on-error] [--bf16-moments] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both
      (--single-pod: the (16, 16) mesh, --multi-pod: (2, 16, 16))
      [--variant opt|opt2|opt3|opt4] [--continue-on-error]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, applicable_shapes
from repro_torch.kernels import ops
from repro_torch.launch import collectives as coll
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline, shardings, specs
from repro_torch.launch.shardings import P
from repro_torch.models import transformer
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train import StepMetrics, TrainState

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
    with ops.meta_work() as kernels, coll.tally() as tally, counter, mode:
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
        "collectives": {"bytes_by_kind": dict(tally.bytes_by_kind),
                        "count_by_kind": dict(tally.count_by_kind)},
        "seconds": time.perf_counter() - t0,
    }
    del out, outs
    return result


def _at_groups(cfg, groups: int):
    n_pat = len(cfg.layer_pattern)
    return dataclasses.replace(cfg, n_layers=groups * n_pat)


def count_step(arch: str, shape, *, cfg=None, lo: int = 1,
               **build_kwargs) -> dict:
    """The trace of one step, at its whole depth: traced outright when it
    is at most ``lo + 1`` groups of its layer pattern deep, else
    extrapolated from traces at ``lo`` and ``lo + 1`` groups (every count
    is linear in the number of identical groups).  Returns the bundle of
    the whole depth and the counts.  A rank of a pod traces at 2 and 3:
    its first group's peak (the logits' and the gathered heads' buffers
    beside a small stack) grows by more than a group holds."""
    bundle = specs.build_step(arch, shape, cfg=cfg, **build_kwargs)
    g = bundle.cfg.n_groups
    hi = lo + 1
    if g <= hi:
        counts = trace(bundle)
        counts["traced_groups"] = [g]
    else:
        one = trace(specs.build_step(arch, shape, cfg=_at_groups(
            bundle.cfg, lo), **build_kwargs))
        two = trace(specs.build_step(arch, shape, cfg=_at_groups(
            bundle.cfg, hi), **build_kwargs))
        more = g - lo
        counts = {k: one[k] + more * (two[k] - one[k])
                  for k in ("flops", "bytes", "output_bytes", "temp_bytes")}
        counts["kernels"] = {
            name: {k: one["kernels"].get(name, {}).get(k, 0)
                   + more * (two["kernels"][name][k]
                             - one["kernels"].get(name, {}).get(k, 0))
                   for k in ("calls", "flops", "bytes")}
            for name in two["kernels"]}
        counts["collectives"] = {
            by: {kind: one["collectives"][by].get(kind, 0)
                 + more * (n - one["collectives"][by].get(kind, 0))
                 for kind, n in two["collectives"][by].items()}
            for by in ("bytes_by_kind", "count_by_kind")}
        counts["argument_bytes"] = _unique_bytes(
            specs.tensors_of(bundle.abstract_args))
        counts["seconds"] = one["seconds"] + two["seconds"]
        counts["traced_groups"] = [lo, hi]
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


# ---------------------------------------------------------------------------
# the pod meshes: specs and per-rank argument bytes
# ---------------------------------------------------------------------------

FSDP_THRESHOLD_BYTES = specs.FSDP_THRESHOLD_BYTES


def _logits_pspec(mesh, batch: int, vocab: int, ndim: int) -> P:
    spec: list = [None] * ndim
    dsize = mesh_lib.data_axis_size(mesh)
    if batch % dsize == 0 and dsize > 1:
        spec[0] = mesh_lib.data_axes(mesh)
    if vocab % mesh_lib.model_axis_size(mesh) == 0:
        spec[-1] = "model"
    return P(*spec)


_decide_fsdp = specs.decide_fsdp


def build_shardings(bundle: specs.StepBundle, mesh, *,
                    fsdp: bool | None = None) -> tuple[Any, Any, bool]:
    """(in_specs, out_specs, fsdp_used): nests of ``PartitionSpec`` like
    the step's arguments and outputs (the reference's ``build_shardings``,
    specs in place of ``NamedSharding``s).  ``fsdp=None`` decides it as
    the reference does: a train step when its float32 parameters or
    moments pass :data:`FSDP_THRESHOLD_BYTES` a rank, else when the bf16
    parameters do."""
    rep = P()
    b = bundle.shape.global_batch
    cfg, model = bundle.cfg, bundle.model
    batch_sh = shardings.batch_pspec(b, mesh, 0)

    if bundle.kind == "train":
        state = bundle.abstract_args[0]
        if fsdp is None:
            fsdp = _decide_fsdp(state.params, mesh) or _decide_fsdp(
                state.opt.mu, mesh)
        psh = shardings.param_pspecs(cfg, model, mesh, fsdp=fsdp)
        state_sh = TrainState(psh, AdamWState(step=rep, mu=psh, nu=psh))
        tok = shardings.batch_pspec(b, mesh, 1)
        return ((state_sh, tok, tok),
                (state_sh, StepMetrics(rep, rep, rep, rep)), fsdp)

    params = bundle.abstract_args[0]
    if fsdp is None:
        fsdp = _decide_fsdp(params, mesh)
    psh = shardings.param_pspecs(cfg, model, mesh, fsdp=fsdp)
    if bundle.kind == "prefill":
        inputs = bundle.abstract_args[1]
        in_sh = {k: shardings.batch_pspec(b, mesh, v.ndim - 1)
                 for k, v in inputs.items()}
        out_sh = {"logits": _logits_pspec(mesh, b, cfg.vocab_size, 3),
                  "risk_score": batch_sh}
        if cfg.has_decode:
            out_sh["cache"] = shardings.cache_pspecs(
                transformer.init_cache(cfg, b, bundle.shape.seq_len,
                                       device="meta"), b, mesh)
        return (psh, in_sh), out_sh, fsdp

    _, cache, inputs, _pos = bundle.abstract_args
    cache_sh = shardings.cache_pspecs(cache, b, mesh)
    in_sh = {k: shardings.batch_pspec(b, mesh, v.ndim - 1)
             for k, v in inputs.items()}
    out_sh = {"logits": _logits_pspec(mesh, b, cfg.vocab_size, 2),
              "risk_score": batch_sh, "cache": cache_sh}
    return (psh, cache_sh, in_sh, rep), out_sh, fsdp


def argument_bytes_per_device(bundle: specs.StepBundle, mesh, *,
                              fsdp: bool | None = None) -> dict:
    """What one rank of ``mesh`` holds of the step's arguments under
    :func:`build_shardings`: bytes by argument and in all, and whether
    FSDP was used."""
    in_sh, _, used = build_shardings(bundle, mesh, fsdp=fsdp)
    by_arg = [shardings.per_device_bytes(a, s, mesh)
              for a, s in zip(bundle.abstract_args, in_sh, strict=True)]
    return {"mesh": mesh.shape, "fsdp": used, "by_argument": by_arg,
            "total": sum(by_arg)}


def _card_memory() -> int | None:
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_properties(0).total_memory


VARIANTS = ("baseline", "opt", "opt2", "opt3", "opt4")


def variant_build_kwargs(variant: str, kind_hint: str, mesh) -> dict:
    """The reference's ``--variant`` bundles (its ``launch/dryrun.py``),
    as ``specs.build_step`` keywords in the port's ``PartitionSpec``:

    ``opt``: train and prefill, the sequence-parallel residual (T on
    "model") and, for train, the bf16 casts before the FSDP gathers;
    decode, the weight-stationary layout (the residual's d on the data
    axes).
    ``opt2`` / ``opt3`` add ``moe_ep_constraint``; ``opt3`` turns remat
    off for train.  ``opt4`` is ``opt`` with the all-to-all MoE
    (``moe_impl="a2a"``) for train and prefill; its decode is ``opt``'s,
    and for a model without MoE blocks the keyword is inert."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: one of {VARIANTS}")
    if variant == "baseline":
        return {}
    daxes = mesh_lib.data_axes(mesh)
    out: dict = {}
    if kind_hint == "decode":
        out["act_pspec"] = P(None, None, "data")
    elif kind_hint == "train":
        out["act_pspec"] = P(daxes, "model", None)
        out["cast_params_bf16"] = True
    else:
        out["act_pspec"] = P(daxes, "model", None)
    if variant in ("opt2", "opt3"):
        out["moe_ep_constraint"] = True
    if variant == "opt3" and kind_hint == "train":
        out["remat"] = False
    if variant == "opt4" and kind_hint != "decode":
        out["moe_impl"] = "a2a"
    return out


def run_cell(arch: str, shape_name: str, *, moment_dtype=torch.float32,
             out_dir: str = RESULTS_DIR, extra_tag: str = "", mesh=None,
             variant: str = "baseline", **build_kwargs) -> dict:
    """Dry-run one cell on one card, or one rank of a pod ``mesh``
    (``make_production_mesh``); writes ``<arch>__<shape>__h100[_tag].json``
    (``h100_pod1`` / ``h100_pod2`` over a pod, ``_<variant>`` after it
    for a bundle of :func:`variant_build_kwargs`) into ``out_dir`` and
    returns its record."""
    t0 = time.perf_counter()
    pod = mesh is not None and mesh.size > 1
    if variant != "baseline":
        if not pod:
            raise ValueError("a --variant bundle lays the step out over a "
                             "pod mesh")
        build_kwargs = {**variant_build_kwargs(
            variant, specs.SHAPES[shape_name].kind, mesh), **build_kwargs}
    expected = None
    if pod:
        whole = specs.build_step(arch, shape_name, moment_dtype=moment_dtype,
                                 **build_kwargs)
        expected = argument_bytes_per_device(whole, mesh)
        param_bytes, cache_bytes = step_bytes(whole)
        build_kwargs = {**build_kwargs, "mesh": mesh,
                        "fsdp": expected["fsdp"], "lo": 2}
        del whole
    counts = count_step(arch, shape_name, moment_dtype=moment_dtype,
                        **build_kwargs)
    bundle = counts.pop("bundle")
    if not pod:
        param_bytes, cache_bytes = step_bytes(bundle)
    elif counts["argument_bytes"] != expected["total"]:
        raise AssertionError(
            f"{arch} x {shape_name}: the rank's arguments are "
            f"{counts['argument_bytes']} bytes, the rules give "
            f"{expected['total']}")
    resident = counts["argument_bytes"] + counts["temp_bytes"]
    chips = mesh.size if pod else 1
    report = roofline.analyze(
        bundle, {"flops": counts["flops"], "bytes": counts["bytes"],
                 "peak_bytes": float(resident)}, chips,
        param_bytes_global=param_bytes, cache_bytes_global=cache_bytes,
        collectives=counts["collectives"] if pod else None, mesh=mesh)
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
    if pod:
        result.update({
            "multi_pod": "pod" in mesh.shape,
            "fsdp": bundle.fsdp,
            "collectives": counts["collectives"],
            "argument_bytes_per_device": expected,
        })
    if variant != "baseline":
        result["variant"] = variant
    ma = result["memory_analysis"]
    print(f"[dryrun] {arch:>26s} x {shape_name:<12s}"
          f" mesh={report.mesh_desc:<16s}"
          f" trace={counts['seconds']:7.1f}s"
          f" args={ma['argument_bytes'] / 2**30:8.2f}GiB"
          f" temp={ma['temp_bytes'] / 2**30:8.2f}GiB"
          f" flops={report.flops_per_chip:.3e}"
          f" coll={report.collective_bytes_per_chip:.3e}B"
          f" bottleneck={report.bottleneck}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    tag = TAG
    if pod:
        tag += "_pod2" if "pod" in mesh.shape else "_pod1"
    tag += f"_{variant}" if variant != "baseline" else ""
    tag += f"_{extra_tag}" if extra_tag else ""
    with open(os.path.join(out_dir, f"{arch}__{shape_name}__{tag}.json"),
              "w") as f:
        json.dump(result, f, indent=2)
    return result


def pod_cells() -> list[tuple[str, str]]:
    """The cells a pod mesh traces: every shape of every model of the
    catalog."""
    return [(arch, s) for arch in ARCH_IDS for s in applicable_shapes(arch)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(specs.SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="every cell (over a pod: the cells it traces, "
                         "pod_cells)")
    ap.add_argument("--single-pod", action="store_true",
                    help="one rank of the (16, 16) mesh")
    ap.add_argument("--multi-pod", action="store_true",
                    help="one rank of the (2, 16, 16) mesh")
    ap.add_argument("--both", action="store_true",
                    help="single-pod AND multi-pod meshes")
    ap.add_argument("--bf16-moments", action="store_true",
                    help="AdamW moments in bf16 (memory optimization)")
    ap.add_argument("--variant", default="baseline", choices=VARIANTS,
                    help="the reference's bundle (variant_build_kwargs), "
                         "over a pod mesh")
    ap.add_argument("--continue-on-error", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR,
                    help="directory of the cells' JSON files")
    args = ap.parse_args(argv)

    moment_dtype = torch.bfloat16 if args.bf16_moments else torch.float32
    meshes = [None]
    if args.variant != "baseline" and not (args.both or args.single_pod
                                           or args.multi_pod):
        ap.error("--variant lays the step out over a pod mesh: give "
                 "--single-pod, --multi-pod or --both")
    if args.both or args.single_pod or args.multi_pod:
        meshes = [mesh_lib.make_production_mesh(multi_pod=mp)
                  for mp in (False, True)
                  if args.both or (args.multi_pod if mp
                                   else args.single_pod)]
    runs: list[tuple[str, str, Any]] = []
    for mesh in meshes:
        if args.all:
            cells = pod_cells() if mesh is not None else [
                (arch, shape) for arch in ARCH_IDS
                for shape in applicable_shapes(arch)]
        else:
            if not args.arch or not args.shape:
                ap.error("--arch and --shape required unless --all")
            cells = [(args.arch, args.shape)]
        runs += [(arch, shape, mesh) for arch, shape in cells]

    failures = []
    t0 = time.perf_counter()
    for arch, shape, mesh in runs:
        try:
            run_cell(arch, shape, moment_dtype=moment_dtype, out_dir=args.out,
                     extra_tag="bf16m" if args.bf16_moments else "",
                     mesh=mesh, variant=args.variant)
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
    print(f"\nall {len(runs)} dry-run cells traced OK in "
          f"{time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
