"""xLSTM mixers (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(scalar memory), numerically as the reference's ``models/xlstm.py``.

mLSTM, chunkwise-parallel:
  C_t = f_t C_{t-1} + i_t v_t k_t^T ;  n_t = f_t n_{t-1} + i_t k_t
  h_t = (C_t q_t) / max(|n_t . q_t|, 1)
Within a chunk the decayed contributions are a causal quadratic form with
decay exp(gamma_t - gamma_s + log i_s) (gamma = cumsum log f, by
log-sigmoid); the (B, H, hd, hd) matrix state is carried from chunk to
chunk by a Python loop.  The recurrent decode step uses the gates' sigmoid
directly, as the reference's does.

sLSTM, a time loop with exponential gating and its stabiliser m:
  m_t = max(f~ + m_{t-1}, i~);  i' = exp(i~ - m_t);  f' = exp(f~ + m_{t-1} - m_t)
  c_t = f' c_{t-1} + i' z_t ;  n_t = f' n_{t-1} + i' ;  h_t = o_t · c_t / max(n_t, 1)
The input product ``w_in`` is taken over all T at once; ``w_rec`` stays in
the loop.  Both states are float32, whatever the compute dtype.

On a model sharded by ``models/parallel.py`` each rank holds the rules'
blocks, and runs the port's own schedule (a deliberate difference from
the reference's GSPMD, which has none of its own):

mLSTM (``parallel.mlstm_plan``): ``up`` is column parallel over (x | z)
and the head-wise q / k / v over each head's last dim, so a rank holds
every head on a block of d_k (q, k) and d_v (v), and the states C and n
on that block of d_k.  The rank all-gathers ``up``'s output (the
head-wise products read every feature of a head, ``w_if`` all of x) and
its v block; the gates are whole (``w_if`` is replicated).  The chunk
loop then runs with no collective: C's and n's d_k blocks update from
the rank's k block, the whole v and the gates, and the numerator and the
normaliser (sums over d_k) come out as the rank's partial sums, since
the inter- and intra-chunk terms are both linear in them.  After the loop
one reduce-scatter gives the rank its d_in block of the numerator
(``down``'s row-parallel input) and one all-reduce the whole normaliser;
only max(|den|, 1) after the sum is nonlinear.  The normaliser meets a
rank-own block of the numerator, so its cotangent differs between ranks
and its all-reduce's backward all-reduces too.  The decode step runs the
same per token.

sLSTM: ``w_in`` and ``w_rec`` are column parallel over the gates [i | f |
z | o], the four states on their channel block of d.  A prefill or train
step all-gathers both weights over "model" once a call, runs the
recurrence whole on every rank (a per-step exchange would be 2·T
dependent collectives a layer) and cuts the final state to the rank's
block; every rank uses the gathered weights alike, so the gather's
backward keeps the rank's block (``collectives.all_gather_same``).  A
decode step all-gathers h, computes the rank's gate columns, sends each
column piece to the rank whose channels it holds in one split all-to-all
(``parallel.gate_plan``) and runs the cell on the rank's block; it
gathers no weight.  ``up`` and ``down`` follow their specs (at full size
d_up does not divide over 16 ranks: both whole).

Under sequence parallelism (``seq``, ``parallel.act_layout``) x and the
output are the rank's block of T.  The mLSTM gathers T at entry where
Megatron's "f" was (``parallel.enter``) and reduce-scatters ``down``'s
output; the sLSTM, whose recurrence every rank runs whole, gathers T
with the all-gather whose backward keeps the rank's block and closes
with ``down``'s reduce-scatter (the rank's block of the output where
``down`` is whole).

Under the weight-stationary decode (``ws``, ``parallel.ws_mesh``) x and
the output are every row of the batch at the rank's block of d over the
data axes, and the states are the rank's rows (``cache_pspec``).  The
weights that read the residual are contracted on their block of d
(``layers.ws_in``: the mLSTM's ``up``, the sLSTM's ``w_in``), the rank
keeps its rows for the step above, and the rows are all-gathered over
the data axes before the weights that write it (``layers.ws_out``: the
mLSTM's ``down``; the sLSTM's ``up``, contracted on the rank's block of
the gathered h, then ``down``).  The mLSTM's head-wise blocks ``wq``,
``wk`` and ``wv`` and ``w_if`` and the sLSTM's ``w_rec`` read the
mixer's own features or its state, never the residual: they stay
gathered over the data axes where FSDP put them (``parallel.weight``, as
the baseline step does).
Contracting them in place would move every row's features to every data
rank and back each step; at xlstm-1.3b's width the rules do not FSDP
the model at all, so nothing is gathered, and at a width they do, the
head-wise blocks are d_in x d_in / H, a 1 / H share of one ``up``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch import collectives as coll
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import MODEL_AXIS
from repro_torch.models import layers, parallel
from repro_torch.models.config import XLSTMConfig


class MLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, d_k, d_v) matrix memory
    n: torch.Tensor  # (B, H, d_k) normaliser


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, d)
    n: torch.Tensor  # (B, d)
    h: torch.Tensor  # (B, d)
    m: torch.Tensor  # (B, d) stabiliser


def mlstm_dims(d_model: int, n_heads: int, xc: XLSTMConfig
               ) -> tuple[int, int]:
    """(d_in, head width): the head width is ``d_in // n_heads``, not the
    config's ``head_dim``."""
    d_in = int(xc.mlstm_proj_factor * d_model)
    return d_in, d_in // n_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """The reference's ``init_mlstm`` parameters: ``up`` to (x, z), the
    head-wise (H, hd, hd) q/k/v blocks, the input/forget gate projection
    with its bias, and ``down``."""

    def __init__(self, d_model: int, n_heads: int, xc: XLSTMConfig, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        d_in, hd = mlstm_dims(d_model, n_heads, xc)
        kw = dict(device=device, dtype=dtype)
        self.up = layers.Linear(d_model, 2 * d_in, **kw)
        self.wq = layers.empty_param((n_heads, hd, hd), device, dtype)
        self.wk = layers.empty_param((n_heads, hd, hd), device, dtype)
        self.wv = layers.empty_param((n_heads, hd, hd), device, dtype)
        self.w_if = layers.Linear(d_in, 2 * n_heads, bias=True, **kw)
        self.down = layers.Linear(d_in, d_model, **kw)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.up.reset_parameters(gen)
        scale = 1.0 / math.sqrt(self.wq.shape[-1])
        for w in (self.wq, self.wk, self.wv):
            w.uniform_(-scale, scale, generator=gen)
        self.w_if.reset_parameters(gen)
        self.down.reset_parameters(gen)


def _mlstm_chunk(q, k, v, log_f, log_i, state: MLSTMState):
    """One chunk: q, k (B, H, Q, d_k), v (B, H, Q, d_v); log_f, log_i (B,
    H, Q); state C (B, H, d_k, d_v), n (B, H, d_k).  Returns (num (B, H,
    Q, d_v), den (B, H, Q), new state): h is num / max(|den|, 1).  On a
    rank's block of d_k, num and den are its partial sums over d_k."""
    bq = q.shape[2]
    gamma = torch.cumsum(log_f, dim=-1)                    # (B, H, Q)
    decay_t = torch.exp(gamma)
    h_inter = torch.matmul(q, state.c) * decay_t[..., None]
    n_inter = torch.einsum("bhqk,bhk->bhq", q, state.n) * decay_t

    d_mat = gamma[..., :, None] - gamma[..., None, :] + log_i[..., None, :]
    mask = torch.tril(torch.ones((bq, bq), dtype=torch.bool,
                                 device=q.device))
    d_exp = torch.exp(d_mat.masked_fill(~mask, -math.inf))
    scores = torch.matmul(q, k.transpose(-1, -2)) * d_exp  # (B, H, Q, Q)
    h_intra = torch.matmul(scores, v)
    n_intra = torch.sum(scores, dim=-1)

    num = h_inter + h_intra
    den = n_inter + n_intra

    total_decay = torch.exp(gamma[..., -1])                # (B, H)
    per_s = torch.exp(gamma[..., -1:] - gamma + log_i)     # (B, H, Q)
    c_new = state.c * total_decay[..., None, None] + torch.matmul(
        (k * per_s[..., None]).transpose(-1, -2), v)
    n_new = state.n * total_decay[..., None] + torch.einsum(
        "bhsk,bhs->bhk", k, per_s)
    return num, den, MLSTMState(c=c_new, n=n_new)


def _mlstm_in(params: MLSTM, x: torch.Tensor, n_heads: int, hd: int,
              plan: parallel.MLSTMPlan | None, seq=None):
    """``up`` of x, then :func:`_mlstm_heads`."""
    xz = layers.linear(params.up, parallel.enter(x, params.up, seq=seq))
    return _mlstm_heads(params, xz, n_heads, hd, plan)


def _mlstm_heads(params: MLSTM, xz: torch.Tensor, n_heads: int, hd: int,
                 plan: parallel.MLSTMPlan | None):
    """From the rank's columns of ``up``'s output, all-gathered over
    "model" on a sharded model: z (the rank's d_in block), the head-wise
    products of x's half in the compute dtype, then float32 (q, k on the
    rank's d_k block, v gathered whole), and the whole gates'
    pre-activations in float32: z, q, k, v (..., H, ·), gates (...,
    2H)."""
    pl = parallel.placement(params.up)
    if plan is not None:
        xz = coll.all_gather(xz, pl.mesh, MODEL_AXIS, xz.dim() - 1)
    xm, z = torch.chunk(xz, 2, dim=-1)
    if plan is not None:
        z = z.narrow(-1, *plan.channels)
    xh = xm.unflatten(-1, (n_heads, hd))

    def heads(w):
        return torch.einsum("...hd,hde->...he",
                            xh, parallel.weight(params, w).to(xh.dtype)
                            ).to(torch.float32)
    q, k, v = heads("wq") * (1.0 / math.sqrt(hd)), heads("wk"), heads("wv")
    if plan is not None:
        v = coll.all_gather(v, pl.mesh, MODEL_AXIS, v.dim() - 1)
    # w_if and its bias are replicated and every rank uses them on its
    # own partial sums: "f" makes their gradients whole
    w_if, b_if = parallel.weight(params.w_if, "weight"), params.w_if.bias
    if plan is not None:
        w_if = coll.copy_to(w_if, pl.mesh, MODEL_AXIS)
        b_if = coll.copy_to(b_if, pl.mesh, MODEL_AXIS)
    gates = (F.linear(xm, w_if.to(xm.dtype)) + b_if.to(xm.dtype)).to(
        torch.float32)
    return z, q, k, v, gates


def _mlstm_h(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """h = num / max(|den|, 1): num (..., H, d_v), den (..., H)."""
    return num / torch.clamp_min(torch.abs(den), 1.0)[..., None]


def _mlstm_down(params: MLSTM, h: torch.Tensor, z: torch.Tensor,
                dtype: torch.dtype, seq=None) -> torch.Tensor:
    return layers.linear(params.down, h.to(dtype) * F.silu(z), seq=seq)


def _mlstm_placed_h(params: MLSTM, num: torch.Tensor, den: torch.Tensor,
                    plan: parallel.MLSTMPlan) -> torch.Tensor:
    """The rank's partial sums over its d_k block, num (..., H, d_v) and
    den (..., H) -> h on the rank's d_in block: the numerator
    reduce-scattered onto that block, the normaliser all-reduced and read
    at each channel's head (max(|den|, 1) stays a head's, never a
    channel's, tensor)."""
    mesh = parallel.placement(params.up).mesh
    lo, c = plan.channels
    # the head of each of the rank's d_in channels
    head = torch.arange(lo, lo + c, device=num.device) // num.shape[-1]
    den = coll.all_reduce_sum(den.contiguous(), mesh, MODEL_AXIS)
    num = coll.reduce_scatter(num.flatten(-2), mesh, MODEL_AXIS,
                              num.dim() - 2)
    return num / torch.clamp_min(torch.abs(den), 1.0)[..., head]


def _mlstm_placed_out(params: MLSTM, num: torch.Tensor, den: torch.Tensor,
                      z: torch.Tensor, dtype: torch.dtype,
                      plan: parallel.MLSTMPlan, seq=None) -> torch.Tensor:
    """``down`` of h · silu(z), h from the partial sums
    (:func:`_mlstm_placed_h`)."""
    return _mlstm_down(params, _mlstm_placed_h(params, num, den, plan), z,
                       dtype, seq)


def mlstm_plan(params: MLSTM, n_heads: int, hd: int
               ) -> parallel.MLSTMPlan | None:
    """The rank's :class:`~repro_torch.models.parallel.MLSTMPlan`; None
    where the layer runs whole."""
    pl = parallel.placement(params.up)
    if pl is None:
        return None
    return parallel.mlstm_plan(n_heads, hd, pl.model_size, pl.model_rank,
                               "mLSTM")


def mlstm_forward(params: MLSTM, x: torch.Tensor, n_heads: int,
                  xc: XLSTMConfig, *,
                  initial_state: MLSTMState | None = None,
                  return_state: bool = False, seq=None
                  ) -> tuple[torch.Tensor, MLSTMState | None]:
    """x: (B, T, d_model) -> (out, final state if ``return_state``).

    Chunks of ``min(chunk_size, T)``; a short last chunk runs at its own
    length, which is the reference's padding (log f = 0, log i = -1e9)
    without the pad rows: no pad reaches the output or the state.  On a
    sharded model the states are the rank's d_k block; with ``seq`` x
    and out are the rank's block of T.
    """
    _, hd = mlstm_dims(x.shape[-1], n_heads, xc)
    plan = mlstm_plan(params, n_heads, hd)
    z, q, k, v, gates = _mlstm_in(params, x, n_heads, hd, plan, seq)
    b, t = q.shape[:2]
    q, k, v = (a.transpose(1, 2) for a in (q, k, v))     # (B, H, T, ·)
    i_raw, f_raw = torch.chunk(gates, 2, dim=-1)
    log_i = F.logsigmoid(i_raw).transpose(1, 2)            # (B, H, T)
    log_f = F.logsigmoid(f_raw).transpose(1, 2)

    state = initial_state or MLSTMState(
        c=torch.zeros((b, n_heads, k.shape[-1], hd), dtype=torch.float32,
                      device=x.device),
        n=torch.zeros((b, n_heads, k.shape[-1]), dtype=torch.float32,
                      device=x.device))
    qc = min(xc.chunk_size, t)
    parts = []
    for s in range(0, t, qc):
        num, den, state = _mlstm_chunk(
            q[:, :, s:s + qc], k[:, :, s:s + qc], v[:, :, s:s + qc],
            log_f[..., s:s + qc], log_i[..., s:s + qc], state)
        # whole, h a chunk at a time; placed, the partial sums, combined
        # over "model" after the loop
        parts.append(_mlstm_h(num, den) if plan is None else (num, den))
    if plan is None:
        h = torch.cat(parts, dim=2).transpose(1, 2).reshape(b, t, -1).to(
            x.dtype)
        out = _mlstm_down(params, h, z, x.dtype, seq)
    else:
        nums, dens = zip(*parts)
        out = _mlstm_placed_out(
            params, torch.cat(nums, dim=2).transpose(1, 2),   # (B, T, H, ·)
            torch.cat(dens, dim=2).transpose(1, 2), z, x.dtype, plan, seq)
    return out, (state if return_state else None)


def mlstm_decode_step(params: MLSTM, x: torch.Tensor, n_heads: int,
                      xc: XLSTMConfig, state: MLSTMState, ws=None
                      ) -> tuple[torch.Tensor, MLSTMState]:
    """One-token recurrent step. x: (B, 1, d_model); with ``ws`` (the
    weight-stationary decode) every row of the batch at the rank's block
    of d, as the output (the module's docstring)."""
    d_model = x.shape[-1] * (1 if ws is None else
                             mesh_lib.data_axis_size(ws))
    _, hd = mlstm_dims(d_model, n_heads, xc)
    plan = mlstm_plan(params, n_heads, hd)
    if ws is None:
        z, q, k, v, gates = _mlstm_in(params, x[:, 0], n_heads, hd, plan)
    else:
        xz, = layers.ws_in([params.up], x[:, 0], ws)
        z, q, k, v, gates = _mlstm_heads(
            params, parallel.ws_rows(xz, state.n.shape[0], ws), n_heads, hd,
            plan)
    i_g = torch.sigmoid(gates[:, :n_heads])
    f_g = torch.sigmoid(gates[:, n_heads:])

    c = state.c * f_g[..., None, None] + i_g[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = state.n * f_g[..., None] + i_g[..., None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, c)
    den = torch.einsum("bhk,bhk->bh", q, n)
    if ws is not None:
        h = (_mlstm_h(num, den).flatten(-2) if plan is None
             else _mlstm_placed_h(params, num, den, plan))
        y = parallel.ws_all_rows(h.to(x.dtype) * F.silu(z), x.shape[0], ws)
        return layers.ws_out(params.down, y, ws)[:, None], MLSTMState(c=c,
                                                                      n=n)
    if plan is None:
        out = _mlstm_down(params, _mlstm_h(num, den).flatten(-2), z, x.dtype)
    else:
        out = _mlstm_placed_out(params, num, den, z, x.dtype, plan)
    return out[:, None], MLSTMState(c=c, n=n)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """The reference's ``init_slstm`` parameters: input and recurrent gate
    projections (i, f, z, o) and the GELU up/down projection."""

    def __init__(self, d_model: int, xc: XLSTMConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        d_up = int(xc.slstm_proj_factor * d_model)
        kw = dict(device=device, dtype=dtype)
        self.w_in = layers.Linear(d_model, 4 * d_model, bias=True, **kw)
        self.w_rec = layers.Linear(d_model, 4 * d_model, **kw)
        self.up = layers.Linear(d_model, d_up, **kw)
        self.down = layers.Linear(d_up, d_model, **kw)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for lin in (self.w_in, self.w_rec, self.up, self.down):
            lin.reset_parameters(gen)


def slstm_plan(params: SLSTM, d_model: int) -> parallel.GatePlan | None:
    """The rank's :class:`~repro_torch.models.parallel.GatePlan` over
    ``w_in`` / ``w_rec``'s gate columns; None where the layer runs whole."""
    pl = parallel.placement(params.w_in)
    if pl is None:
        return None
    return parallel.gate_plan(4, d_model, pl.model_size, pl.model_rank,
                              "sLSTM w_in")


def _slstm_cell(pre: torch.Tensor, state: SLSTMState,
                gp: parallel.GatePlan | None, mesh) -> SLSTMState:
    """One step from the float32 pre-activations ``pre`` (B, 4d): ``w_in``
    of x_t and ``w_rec`` of h, each in the compute dtype, then float32.
    On a rank's gate columns (``gp``) one split all-to-all gives it the
    four gates of its channel block, which its ``state`` holds."""
    if gp is None or len(gp.send) == 1:
        i_raw, f_raw, z_raw, o_raw = torch.chunk(pre, 4, dim=-1)
    else:
        pieces = pre.unflatten(-1, (4, gp.channels[1])).movedim(-2, 0)
        if gp.order != tuple(range(4)):
            pieces = pieces[list(gp.order)]
        i_raw, f_raw, z_raw, o_raw = coll.all_to_all_split_raw(
            pieces, mesh, MODEL_AXIS, list(gp.send), list(gp.recv))
    f_m = f_raw + state.m
    m_new = torch.maximum(f_m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(f_m - m_new)
    c = f_g * state.c + i_g * torch.tanh(z_raw)
    n = f_g * state.n + i_g
    h = torch.sigmoid(o_raw) * c / torch.clamp_min(n, 1.0)
    return SLSTMState(c=c, n=n, h=h, m=m_new)


def _slstm_out(params: SLSTM, h: torch.Tensor, seq=None) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    h = parallel.enter(h, params.up)
    return layers.linear(params.down, F.gelu(layers.linear(params.up, h),
                                             approximate="tanh"), seq=seq)


def _whole(params: layers.Linear, gp: parallel.GatePlan | None) -> torch.Tensor:
    """The whole (4d, d) weight: the rank's gate columns all-gathered over
    "model" (every rank runs the whole recurrence with it)."""
    w = parallel.weight(params, "weight")
    if gp is None:
        return w
    return coll.all_gather_same(w, parallel.placement(params).mesh,
                                MODEL_AXIS, 0)


def slstm_forward(params: SLSTM, x: torch.Tensor, xc: XLSTMConfig, *,
                  initial_state: SLSTMState | None = None,
                  return_state: bool = False, seq=None
                  ) -> tuple[torch.Tensor, SLSTMState | None]:
    """x (B, T, d) -> (out, final state if ``return_state``).  On a
    sharded model the recurrence runs whole on every rank and the states
    (``initial_state`` and the final one) are the rank's channel block;
    with ``seq`` x and out are the rank's block of T."""
    if seq is not None:
        x = coll.all_gather_same(x, seq, MODEL_AXIS, 1)
    b, t, d = x.shape
    gp = slstm_plan(params, d)
    mesh = None if gp is None else parallel.placement(params.w_in).mesh
    if initial_state is not None and gp is not None:
        initial_state = SLSTMState(*(coll.all_gather_raw(
            a, mesh, MODEL_AXIS, 1) for a in initial_state))
    state = initial_state or init_slstm_state(b, d, device=x.device)
    w_rec = _whole(params.w_rec, gp).to(x.dtype)
    pre_in = (F.linear(x, _whole(params.w_in, gp).to(x.dtype))
              + params.w_in.bias.to(x.dtype)).to(torch.float32)  # (B, T, 4d)
    hs = []
    for step in range(t):
        pre = pre_in[:, step] + F.linear(state.h.to(x.dtype), w_rec).to(
            torch.float32)
        state = _slstm_cell(pre, state, None, None)
        hs.append(state.h)
    h = torch.stack(hs, dim=1).to(x.dtype)                   # (B, T, d)
    if return_state and gp is not None:
        state = SLSTMState(*(a.narrow(1, *gp.channels) for a in state))
    return _slstm_out(params, h, seq), (state if return_state else None)


def slstm_decode_step(params: SLSTM, x: torch.Tensor, xc: XLSTMConfig,
                      state: SLSTMState, ws=None
                      ) -> tuple[torch.Tensor, SLSTMState]:
    """One step, x (B, 1, d).  On a sharded model ``state`` is the rank's
    channel block: h is all-gathered for ``w_rec``, the rank computes its
    gate columns and the cell runs on its block after the gates'
    exchange; the new h is all-gathered for ``up``.  With ``ws`` (the
    weight-stationary decode) x and out are every row of the batch at the
    rank's block of d, the state the rank's rows (the module's
    docstring)."""
    d = x.shape[-1] * (1 if ws is None else mesh_lib.data_axis_size(ws))
    gp = slstm_plan(params, d)
    mesh = None if gp is None else parallel.placement(params.w_in).mesh
    h = state.h if gp is None else coll.all_gather_raw(state.h, mesh,
                                                       MODEL_AXIS, 1)
    if ws is None:
        pre_in = layers.linear(params.w_in, x[:, 0])
    else:
        pre_in, = layers.ws_in([params.w_in], x[:, 0], ws)
        pre_in = parallel.ws_rows(pre_in, state.h.shape[0], ws)
    pre = pre_in.to(torch.float32) + \
        layers.linear(params.w_rec, h.to(x.dtype)).to(torch.float32)
    new_state = _slstm_cell(pre, state, gp, mesh)
    h = new_state.h if gp is None else coll.all_gather_raw(
        new_state.h, mesh, MODEL_AXIS, 1)
    if ws is None:
        return _slstm_out(params, h[:, None].to(x.dtype)), new_state
    # every row of h at the rank's block of d: up and down contracted on
    # their blocks of it
    h = parallel.ws_all_rows(h, x.shape[0], ws)
    hb = h.narrow(-1, parallel.data_index(ws) * x.shape[-1], x.shape[-1])
    u, = layers.ws_in([params.up], hb[:, None].to(x.dtype), ws)
    return layers.ws_out(params.down, F.gelu(u, approximate="tanh"),
                         ws), new_state


def init_mlstm_state(batch: int, d_model: int, n_heads: int,
                     xc: XLSTMConfig, device=None) -> MLSTMState:
    _, hd = mlstm_dims(d_model, n_heads, xc)
    return MLSTMState(
        c=torch.zeros((batch, n_heads, hd, hd), dtype=torch.float32,
                      device=device),
        n=torch.zeros((batch, n_heads, hd), dtype=torch.float32,
                      device=device))


def init_slstm_state(batch: int, d_model: int, device=None) -> SLSTMState:
    z = torch.zeros((batch, d_model), dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z, h=z, m=z)
