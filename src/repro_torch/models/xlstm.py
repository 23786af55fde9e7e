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
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
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
    """One chunk: q, k, v (B, H, Q, d); log_f, log_i (B, H, Q); state C
    (B, H, d, d), n (B, H, d).  Returns (h (B, H, Q, d), new state)."""
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
    h = num / torch.clamp_min(torch.abs(den), 1.0)[..., None]

    total_decay = torch.exp(gamma[..., -1])                # (B, H)
    per_s = torch.exp(gamma[..., -1:] - gamma + log_i)     # (B, H, Q)
    c_new = state.c * total_decay[..., None, None] + torch.matmul(
        (k * per_s[..., None]).transpose(-1, -2), v)
    n_new = state.n * total_decay[..., None] + torch.einsum(
        "bhsk,bhs->bhk", k, per_s)
    return h, MLSTMState(c=c_new, n=n_new)


def _mlstm_qkv(params: MLSTM, xh: torch.Tensor, scale: float):
    """Head-wise block products in the compute dtype, then float32:
    xh (..., H, hd) -> q, k, v (..., H, hd)."""
    def heads(w):
        return torch.einsum("...hd,hde->...he", xh, w.to(xh.dtype)
                            ).to(torch.float32)
    return heads(params.wq) * scale, heads(params.wk), heads(params.wv)


def mlstm_forward(params: MLSTM, x: torch.Tensor, n_heads: int,
                  xc: XLSTMConfig, *,
                  initial_state: MLSTMState | None = None,
                  return_state: bool = False
                  ) -> tuple[torch.Tensor, MLSTMState | None]:
    """x: (B, T, d_model) -> (out, final state if ``return_state``).

    Chunks of ``min(chunk_size, T)``; a short last chunk runs at its own
    length, which is the reference's padding (log f = 0, log i = -1e9)
    without the pad rows: no pad reaches the output or the state.
    """
    b, t, _ = x.shape
    d_in, hd = mlstm_dims(x.shape[-1], n_heads, xc)
    scale = 1.0 / math.sqrt(hd)

    xm, z = torch.chunk(layers.linear(params.up, x), 2, dim=-1)
    q, k, v = (a.transpose(1, 2) for a in _mlstm_qkv(
        params, xm.reshape(b, t, n_heads, hd), scale))    # (B, H, T, hd)
    gates = layers.linear(params.w_if, xm).to(torch.float32)  # (B, T, 2H)
    i_raw, f_raw = torch.chunk(gates, 2, dim=-1)
    log_i = F.logsigmoid(i_raw).transpose(1, 2)            # (B, H, T)
    log_f = F.logsigmoid(f_raw).transpose(1, 2)

    state = initial_state or MLSTMState(
        c=torch.zeros((b, n_heads, hd, hd), dtype=torch.float32,
                      device=x.device),
        n=torch.zeros((b, n_heads, hd), dtype=torch.float32,
                      device=x.device))
    qc = min(xc.chunk_size, t)
    hs = []
    for s in range(0, t, qc):
        h, state = _mlstm_chunk(q[:, :, s:s + qc], k[:, :, s:s + qc],
                                v[:, :, s:s + qc], log_f[..., s:s + qc],
                                log_i[..., s:s + qc], state)
        hs.append(h)
    h = torch.cat(hs, dim=2).transpose(1, 2).reshape(b, t, d_in).to(x.dtype)
    out = layers.linear(params.down, h * F.silu(z))
    return out, (state if return_state else None)


def mlstm_decode_step(params: MLSTM, x: torch.Tensor, n_heads: int,
                      xc: XLSTMConfig, state: MLSTMState
                      ) -> tuple[torch.Tensor, MLSTMState]:
    """One-token recurrent step. x: (B, 1, d_model)."""
    b = x.shape[0]
    d_in, hd = mlstm_dims(x.shape[-1], n_heads, xc)
    scale = 1.0 / math.sqrt(hd)

    xm, z = torch.chunk(layers.linear(params.up, x), 2, dim=-1)
    q, k, v = _mlstm_qkv(params, xm.reshape(b, n_heads, hd), scale)
    gates = layers.linear(params.w_if, xm).to(torch.float32).reshape(
        b, 2 * n_heads)
    i_g = torch.sigmoid(gates[:, :n_heads])
    f_g = torch.sigmoid(gates[:, n_heads:])

    c = state.c * f_g[..., None, None] + i_g[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = state.n * f_g[..., None] + i_g[..., None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, c)
    den = torch.einsum("bhk,bhk->bh", q, n)
    h = num / torch.clamp_min(torch.abs(den), 1.0)[..., None]
    h = h.reshape(b, 1, d_in).to(x.dtype)
    out = layers.linear(params.down, h * F.silu(z))
    return out, MLSTMState(c=c, n=n)


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


def _slstm_cell(params: SLSTM, pre_in: torch.Tensor, state: SLSTMState,
                dtype: torch.dtype) -> SLSTMState:
    """One step from the float32 input pre-activations ``pre_in`` (B, 4d)
    (``w_in`` of x_t in the compute dtype, then float32); ``h`` enters
    ``w_rec`` in the compute dtype."""
    pre = pre_in + layers.linear(params.w_rec, state.h.to(dtype)).to(
        torch.float32)
    i_raw, f_raw, z_raw, o_raw = torch.chunk(pre, 4, dim=-1)
    f_m = f_raw + state.m
    m_new = torch.maximum(f_m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(f_m - m_new)
    c = f_g * state.c + i_g * torch.tanh(z_raw)
    n = f_g * state.n + i_g
    h = torch.sigmoid(o_raw) * c / torch.clamp_min(n, 1.0)
    return SLSTMState(c=c, n=n, h=h, m=m_new)


def _slstm_out(params: SLSTM, h: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return layers.linear(params.down, F.gelu(layers.linear(params.up, h),
                                             approximate="tanh"))


def slstm_forward(params: SLSTM, x: torch.Tensor, xc: XLSTMConfig, *,
                  initial_state: SLSTMState | None = None,
                  return_state: bool = False
                  ) -> tuple[torch.Tensor, SLSTMState | None]:
    b, t, d = x.shape
    state = initial_state or init_slstm_state(b, d, device=x.device)
    pre_in = layers.linear(params.w_in, x).to(torch.float32)  # (B, T, 4d)
    hs = []
    for step in range(t):
        state = _slstm_cell(params, pre_in[:, step], state, x.dtype)
        hs.append(state.h)
    h = torch.stack(hs, dim=1).to(x.dtype)                   # (B, T, d)
    return _slstm_out(params, h), (state if return_state else None)


def slstm_decode_step(params: SLSTM, x: torch.Tensor, xc: XLSTMConfig,
                      state: SLSTMState) -> tuple[torch.Tensor, SLSTMState]:
    pre_in = layers.linear(params.w_in, x[:, 0]).to(torch.float32)
    new_state = _slstm_cell(params, pre_in, state, x.dtype)
    return _slstm_out(params, new_state.h[:, None].to(x.dtype)), new_state


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
