"""The port's MoE FFN (``models/moe.py``) and the MoE smoke models against
the JAX package, on the CPU.

The layer: out and aux within rtol = atol = 1e-4 in float32 and 5e-2 in
bfloat16, with and without the shared expert, in one chunk and in several
(a short last chunk keeps the full chunk's capacity); the dropped
(token, slot) pairs exactly the reference's, read from its own
``pos_in_expert``; on tied router probabilities the experts and their order
exactly ``jax.lax.top_k``'s.

The models (olmoe-1b-7b and llama4-maverick smoke, converted with
``convert.model_from_numpy``): float32 forward, prefill and decode within
1e-4 (risk 1e-5), decode against the forward, the parameter counts of the
full configs.  In bfloat16 a route may land on the other side of a tie
between the packages (their attention rounds differently in the last bit,
and the router's bf16 logits tie often), and a token whose route differs
gets another expert's output.  The reference does this to itself: its
scanned ``forward`` and its own blocks run one by one route some bf16
tokens differently.  So the bf16 stack is held sublayer by sublayer on the
reference's own inputs (routes equal there), and end to end against the
reference's blocks run one by one, up to the first token whose route
differs, each such route shown to be a tie within bf16 rounding in the
reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import moe as j_moe
from repro.models.model import Model as JModel
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import model_from_numpy
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models.model import Model

F32 = dict(rtol=1e-4, atol=1e-4)
RISK = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
MOE_ARCHS = ("olmoe-1b-7b", "llama4-maverick-400b-a17b")
DTYPES = {"float32": (jnp.float32, torch.float32, F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _layer(arch, *, seed=1, **mo_changes):
    """A reference MoE layer of ``arch``'s smoke config and its port."""
    jcfg, tcfg = j_smoke(arch), get_smoke_config(arch)
    jmo = dataclasses.replace(jcfg.moe, **mo_changes)
    tmo = dataclasses.replace(tcfg.moe, **mo_changes)
    params = j_moe.init_moe(jax.random.key(seed), jcfg.d_model, jmo)
    moe = t_moe.MoE(tcfg.d_model, tmo, device="cpu")
    _load_moe(moe, jax.tree.map(np.asarray, params))
    return params, jmo, moe, tmo


def _load_moe(moe, params):
    """The converter's MoE leaves for an unstacked layer (a group axis of
    one added)."""
    from repro_torch import convert
    convert._copy_module(moe, jax.tree.map(lambda a: a[None], params), 0)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch,chunk", [
    ("olmoe-1b-7b", 4096), ("olmoe-1b-7b", 20),
    ("llama4-maverick-400b-a17b", 4096), ("llama4-maverick-400b-a17b", 16)])
def test_moe_layer_matches_reference(arch, chunk, dtype):
    """out and aux: one chunk, and chunks of 20 / 16 over 48 tokens (a
    short last chunk); llama4 has the shared expert, olmoe not."""
    jd, td, tol = DTYPES[dtype]
    params, jmo, moe, tmo = _layer(arch)
    assert (moe.shared is not None) == (arch != "olmoe-1b-7b")
    x = _x((2, 24, j_smoke(arch).d_model))
    want, want_aux = j_moe.moe_forward(params, jnp.asarray(x).astype(jd), jmo,
                                       dispatch_chunk=chunk)
    got, aux = t_moe.moe_forward(moe, torch.tensor(x).to(td), tmo,
                                 dispatch_chunk=chunk)
    assert got.dtype == td and got.shape == want.shape
    _close(got, want, tol)
    _close(aux, want_aux, RISK if dtype == "float32" else tol)


def _reference_slots(params, x, mo):
    """The reference's own ``pos_in_expert`` of a one-chunk dispatch: its
    second ``jax.nn.one_hot`` takes ``where(within_cap, pos, -1)``, read
    here as it is called.  Returns (kept (n, k) bool, pos (n, k))."""
    seen = []
    one_hot = jax.nn.one_hot

    def spy(a, n, **kw):
        seen.append(np.asarray(a))
        return one_hot(a, n, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.nn, "one_hot", spy)
        j_moe.moe_forward(params, x, mo)
    slots = seen[1]                                  # (c, k, E)
    pos = slots.max(axis=-1)
    return pos >= 0, pos


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dropped_pairs_are_the_references(dtype):
    """capacity_factor 0.5 over 64 tokens of 4 experts top-2: cap 16, and
    the pairs past it drop exactly where the reference drops them."""
    jd, td, tol = DTYPES[dtype]
    params, jmo, moe, tmo = _layer("olmoe-1b-7b", capacity_factor=0.5)
    x = _x((2, 32, 128), seed=4)
    n = 64
    cap = t_moe.capacity(n, tmo)
    assert cap == 16 == j_moe._capacity(n, jmo)
    kept, pos = _reference_slots(params, jnp.asarray(x).astype(jd), jmo)
    _, _, idx = t_moe.route(moe, torch.tensor(x).to(td).reshape(n, 128), tmo)
    slot = t_moe.dispatch_slots(idx, tmo.num_experts, cap).numpy()
    got_kept = slot < tmo.num_experts * cap
    assert 0 < (~kept).sum() < kept.size
    np.testing.assert_array_equal(got_kept, kept)
    np.testing.assert_array_equal(
        np.where(got_kept, slot % cap, -1), np.where(kept, pos, -1))
    want, _ = j_moe.moe_forward(params, jnp.asarray(x).astype(jd), jmo)
    got, _ = t_moe.moe_forward(moe, torch.tensor(x).to(td), tmo)
    _close(got, want, tol)


@pytest.mark.parametrize("chunk", [24, 40])
def test_drops_across_chunks_match_reference(chunk):
    """Drops at capacity_factor 0.5 in chunks of 24 / 40 over 64 tokens:
    every chunk, the short last one too, has the full chunk's capacity."""
    params, jmo, moe, tmo = _layer("olmoe-1b-7b", capacity_factor=0.5)
    x = _x((2, 32, 128), seed=5)
    want, want_aux = j_moe.moe_forward(params, jnp.asarray(x), jmo,
                                       dispatch_chunk=chunk)
    got, aux = t_moe.moe_forward(moe, torch.tensor(x), tmo,
                                 dispatch_chunk=chunk)
    _close(got, want, F32)
    _close(aux, want_aux, RISK)


def test_capacity_floors_and_keeps_top_k():
    mo = get_smoke_config("olmoe-1b-7b").moe
    jmo = j_smoke("olmoe-1b-7b").moe
    full = get_config("olmoe-1b-7b").moe
    for n in (1, 3, 7, 48, 4096):
        assert t_moe.capacity(n, mo) == j_moe._capacity(n, jmo)
    assert t_moe.capacity(4096, full) == 640   # 4096·8/64·1.25
    assert t_moe.capacity(4, full) == 8        # max(int(0.625), k)
    assert t_moe.capacity(7, mo) == 7          # int(7·2/4·2.0), floored


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_tied_router_probabilities_keep_top_k_order(dtype):
    """Router columns duplicated in pairs (8 experts, 4 distinct): every
    token ties, and the port's experts and their order are
    ``jax.lax.top_k``'s (the lower id first)."""
    jd, td, _ = DTYPES[dtype]
    params, jmo, moe, tmo = _layer("olmoe-1b-7b", num_experts=8, top_k=3)
    w = np.array(params["router"]["w"])
    w[:, 4:] = w[:, :4]
    params["router"]["w"] = jnp.asarray(w)
    _load_moe(moe, jax.tree.map(np.asarray, params))
    x = _x((64, 128), seed=6)
    xj = jnp.asarray(x).astype(jd)
    logits = j_layers.linear(params["router"], xj).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    assert np.array_equal(np.asarray(probs[:, :4]), np.asarray(probs[:, 4:]))
    want_vals, want_idx = jax.lax.top_k(probs, jmo.top_k)
    got_probs, got_vals, got_idx = t_moe.route(moe, torch.tensor(x).to(td),
                                               tmo)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert bool((got_idx[:, 0] < 4).all()) and bool((got_idx[:, 1] >= 4).all())
    want_gates = want_vals / jnp.maximum(
        jnp.sum(want_vals, axis=-1, keepdims=True), 1e-9)
    _close(got_vals, want_gates, RISK)


@pytest.mark.parametrize("option,item", [
    ({"ep_sharding_constraint": True}, "item 13h, tensor parallelism")])
def test_mesh_options_raise_in_the_layer(option, item):
    """The option once raised, naming ``item``; now the layer takes it
    and it changes no number (the port's buffers live on their experts'
    ranks already; ``test_torch_moe_ranks.py`` holds both packages to it
    over a mesh), and no error of the port names that item any more."""
    from repro_torch.launch import mesh as mesh_lib

    _, _, moe, tmo = _layer("olmoe-1b-7b")
    x = torch.tensor(_x((2, 16, 128), seed=3))
    got = t_moe.moe_forward(moe, x, dataclasses.replace(tmo, **option))
    want = t_moe.moe_forward(moe, x, tmo)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not hasattr(mesh_lib, "SEVERAL_CARDS")


# ---------------------------------------------------------------- models

def _pair(arch, seed=42):
    jcfg, tcfg = j_smoke(arch), get_smoke_config(arch)
    jm = JModel(jcfg)
    params = jm.init(jax.random.key(seed))
    tm = model_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                          device="cpu")
    return jm, params, tm


def _tokens(cfg, seq, seed=0, batch=2):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return jnp.asarray(toks), torch.tensor(toks, dtype=torch.long)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_smoke_forward_matches_reference(arch):
    jm, params, tm = _pair(arch)
    jt, tt = _tokens(tm.cfg, 24)
    want = jm.forward(params, tokens=jt, compute_dtype=jnp.float32)
    got = tm(tt, compute_dtype=torch.float32)
    _close(got.logits, want.logits, F32)
    _close(got.risk_score, want.risk_score, RISK)
    _close(got.hidden, want.hidden, F32)
    # the stack sums every MoE layer's aux, as the reference's scan carries it
    assert float(got.moe_aux) > 0
    _close(got.moe_aux, want.moe_aux, RISK)


def _reference_stack(jm, params, tokens, dtype):
    """The reference's stack, unrolled with its own block functions (its
    scan runs this body), keeping each sublayer's input and each MoE
    layer's routes.  Returns ([(kind, input, output, routes or None)],
    the last hidden, the summed aux)."""
    cfg = jm.cfg
    x = j_layers.embed(params["embed"], tokens, dtype)
    angles = jm._angles(x.shape[0], x.shape[1], 0, None)
    subs, aux = [], 0.0
    for g in range(cfg.n_groups):
        for i, spec in enumerate(cfg.layer_pattern):
            bp = jax.tree.map(lambda a: a[g], params["stack"][i])
            h = j_layers.rmsnorm(bp["mixer_norm"], x, cfg.norm_eps)
            out, _ = j_attn.attention_forward(bp["mixer"], h, cfg,
                                              angles=angles)
            subs.append(("attn", x, out, None))
            x = x + out
            h2 = j_layers.rmsnorm(bp["ffn_norm"], x, cfg.norm_eps)
            if spec.ffn == "moe":
                out, layer_aux = j_moe.moe_forward(bp["ffn"], h2, cfg.moe)
                aux = aux + layer_aux
                logits = j_layers.linear(
                    bp["ffn"]["router"], h2.reshape(-1, cfg.d_model)
                ).astype(jnp.float32)
                probs = jax.nn.softmax(logits, axis=-1)
                routes = (np.asarray(probs),
                          np.asarray(jax.lax.top_k(probs, cfg.moe.top_k)[1]))
            else:
                out, routes = j_layers.mlp(bp["ffn"], h2), None
            subs.append((spec.ffn, x, out, routes))
            x = x + out
    return subs, x, aux


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_sublayers_match_reference_on_its_inputs(arch):
    """bf16: each attention and FFN sublayer of the port, given the
    reference's own input to it, within 5e-2 of the reference's output,
    with the same routes; the heads on the reference's last hidden."""
    jm, params, tm = _pair(arch)
    cfg = tm.cfg
    jt, tt = _tokens(cfg, 24, seed=3)
    subs, x_last, _ = _reference_stack(jm, params, jt, jnp.bfloat16)
    angles = tm._angles(2, 24, 0, None)
    blocks = [b for b in tm.stack for _ in (0, 1)]
    n_moe = 0
    for (kind, x_in, want, routes), block in zip(subs, blocks):
        x = torch.tensor(_np(x_in)).to(torch.bfloat16)
        if kind == "attn":
            h = t_layers.rmsnorm(block.mixer_norm, x, cfg.norm_eps)
            got, _ = t_attn.attention_forward(block.mixer, h, cfg,
                                              angles=angles)
        else:
            h2 = t_layers.rmsnorm(block.ffn_norm, x, cfg.norm_eps)
            if kind == "moe":
                n_moe += 1
                _, _, idx = t_moe.route(block.ffn, h2.reshape(-1, cfg.d_model),
                                        cfg.moe)
                np.testing.assert_array_equal(idx.numpy(), routes[1])
                got, _ = t_moe.moe_forward(block.ffn, h2, cfg.moe)
            else:
                got = t_layers.mlp(block.ffn, h2)
        _close(got, want, BF16)
    assert n_moe == sum(s.ffn == "moe" for s in cfg.layer_pattern) \
        * cfg.n_groups
    want = jm._heads(params, x_last, jnp.bfloat16)
    got = tm._heads(torch.tensor(_np(x_last)).to(torch.bfloat16),
                    torch.bfloat16)
    _close(got[0], want[0], BF16)
    _close(got[1], want[1], BF16)


def _port_routes(tm, tokens):
    """Each MoE layer's experts in the port's bf16 forward, in order."""
    seen = []
    route = t_moe.route

    def spy(moe, xf, mo):
        out = route(moe, xf, mo)
        seen.append(out[2].numpy())
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_moe, "route", spy)
        out = tm(tokens)
    return out, seen


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_forward_tracks_reference_to_the_first_tie(arch, seed):
    """bf16 end to end against the reference's blocks run one by one:
    logits within 5e-2 at every position before the first token (of its
    row) whose route differs from the reference's in any MoE layer, and
    everywhere in a row without one; each differing route a tie within
    bf16 rounding in the reference (the two experts' probabilities within
    2^-6 of each other, relatively); risk and aux within 5e-2, also of the
    reference's scanned ``forward``."""
    jm, params, tm = _pair(arch)
    jt, tt = _tokens(tm.cfg, 24, seed=seed)
    subs, x_last, want_aux = _reference_stack(jm, params, jt, jnp.bfloat16)
    want_logits, want_risk, _ = jm._heads(params, x_last, jnp.bfloat16)
    got, port_routes = _port_routes(tm, tt)
    ref_routes = [r for *_, r in subs if r is not None]
    b, t = 2, 24
    first = np.full(b, t)
    for (probs, want_idx), got_idx in zip(ref_routes, port_routes):
        for row, slot in zip(*np.nonzero(got_idx != want_idx)):
            a, c = want_idx[row, slot], got_idx[row, slot]
            pa, pc = probs[row, a], probs[row, c]
            assert abs(pa - pc) <= 2.0 ** -6 * max(pa, pc), (row, slot)
            first[row // t] = min(first[row // t], row % t)
    for row in range(b):
        _close(got.logits[row, :first[row]], want_logits[row, :first[row]],
               BF16)
    scanned = jm.forward(params, tokens=jt)
    for want in ((want_risk, want_aux), (scanned.risk_score,
                                         scanned.moe_aux)):
        _close(got.risk_score, want[0], BF16)
        _close(got.moe_aux, want[1], BF16)


def test_reference_bf16_routes_depend_on_how_its_stack_runs():
    """A fault of the reference, shown here (``src/repro`` is not edited):
    olmoe smoke in bf16, prompt seed 0: its scanned ``forward`` and its own
    blocks run one by one give logits more than 5e-2 apart at some
    position, the float32 runs agree within 1e-4, and some token of the
    blocks' routers has its k-th and (k+1)-th experts within bf16 rounding
    of a tie."""
    jm, params, _ = _pair("olmoe-1b-7b")
    jt, _ = _tokens(jm.cfg, 24, seed=0)
    subs, x_last, _ = _reference_stack(jm, params, jt, jnp.bfloat16)
    unrolled = _np(jm._heads(params, x_last, jnp.bfloat16)[0])
    scanned = _np(jm.forward(params, tokens=jt).logits)
    apart = np.abs(unrolled - scanned).max(-1) > 5e-2
    assert apart.sum() >= 1
    f32 = jm.forward(params, tokens=jt, compute_dtype=jnp.float32)
    _, x32, _ = _reference_stack(jm, params, jt, jnp.float32)
    _close(jm._heads(params, x32, jnp.float32)[0], f32.logits, F32)
    gaps = [np.sort(probs, axis=-1)[:, ::-1] for *_, (probs, _) in
            (s for s in subs if s[3] is not None)]
    k = jm.cfg.moe.top_k
    assert min(float(((g[:, k - 1] - g[:, k]) / g[:, k - 1]).min())
               for g in gaps) <= 2.0 ** -6


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jm, params, tm = _pair(arch)
    t, steps = 24, 3
    jt, tt = _tokens(tm.cfg, t + steps, seed=7)
    kw = dict(cache_capacity=t + steps)
    jout, jcache = jm.prefill(params, tokens=jt[:, :t], **kw,
                              compute_dtype=jnp.float32,
                              cache_dtype=jnp.float32)
    tout, tcache = tm.prefill(tt[:, :t], **kw, compute_dtype=torch.float32)
    _close(tout.logits, jout.logits, F32)
    _close(tout.moe_aux, jout.moe_aux, RISK)
    for s in range(steps):
        jdec = jm.decode_step(params, jcache, tokens=jt[:, t + s:t + s + 1],
                              pos=t + s, compute_dtype=jnp.float32)
        tdec = tm.decode_step(tcache, tt[:, t + s:t + s + 1], pos=t + s,
                              compute_dtype=torch.float32)
        jcache, tcache = jdec.cache, tdec.cache
        _close(tdec.logits, jdec.logits, F32)
        _close(tdec.risk_score, jdec.risk_score, RISK)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_forward(arch):
    """The reference's ``test_decode_matches_forward`` and
    ``test_multi_step_decode_matches_forward`` on the port: one and three
    decode steps after a prefill track the full forward (2e-3 / 3e-3)."""
    _, _, tm = _pair(arch)
    t, steps = 24, 3
    _, tt = _tokens(tm.cfg, t + steps, seed=7)
    full = tm(tt, compute_dtype=torch.float32)
    _, cache = tm.prefill(tt[:, :t], cache_capacity=t + steps,
                          compute_dtype=torch.float32)
    for s in range(steps):
        dec = tm.decode_step(cache, tt[:, t + s:t + s + 1], pos=t + s,
                             compute_dtype=torch.float32)
        cache = dec.cache
        tol = 2e-3 if s == 0 else 3e-3
        torch.testing.assert_close(dec.logits, full.logits[:, t + s],
                                   rtol=tol, atol=tol)


def _reference_param_count(arch) -> int:
    shapes = jax.eval_shape(JModel(j_config(arch)).init, jax.random.key(0))
    return sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-maverick-400b-a17b",
                                  "xlstm-1.3b"])
def test_full_size_param_count_is_the_references(arch):
    """The full config built on the ``meta`` device has exactly the
    parameters of the reference's ``init`` (its shapes, by
    ``jax.eval_shape``)."""
    tm = Model(get_config(arch), device="meta", seed=None)
    assert tm.param_count() == _reference_param_count(arch)

