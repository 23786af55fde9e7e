"""Mamba (S6) selective state-space mixer, numerically as the reference's
``models/mamba.py``.

    xz = in_proj(x);  x_in, z = split(xz)
    x_conv = silu(causal_conv(x_in))               (K shifted adds)
    dt, Bm, Cm = split(x_proj(x_conv));  dt = softplus(dt_proj(dt) + dt_bias)
    h_t = exp(dt_t · A) · h_{t-1} + (dt_t · x_conv_t) · Bm_t,  A = -exp(A_log)
    y_t = Σ_n h_t · Cm_t + x_conv_t · D;  out = out_proj(y · silu(z))

The reference bounds the TPU's VMEM with a chunked two-level scan (a
sequential ``lax.scan`` over chunks, an associative scan inside each).
Here the whole sequence is one call of ``kernels.ops.selective_scan``: on
the card the hand-written ``csrc/selective_scan.cu``, whose threads keep
the (d_inner × N) states in registers, so no state reaches device memory;
on the CPU its plain version.  The scan, the skip and the gate run in
float32 and the rest in the compute dtype, where the reference does.

Decode is the O(1) recurrent step with a (B, d_conv-1, d_inner) conv tail
and a (B, d_inner, N) float32 SSM state.  Unlike the reference, which
returns a new state, the step writes the SSM state into the state it was
given, in place (the kernel's output aliases its input), as the port's
decode writes keys and values and the xLSTM states.

On a model sharded by ``models/parallel.py`` a rank runs the mixer on its
block of the d_inner channels, the block its conv tail and SSM state hold
under ``cache_pspec``.  The rules make ``in_proj`` column parallel over
the concatenated (x | z) columns, so the rank's columns are two channel
blocks of x or of z that other ranks own (at 16 ranks, ranks 0-7 hold
only x, 8-15 only z).  The port's own schedule, a deliberate difference
from the reference's GSPMD, which has none of its own:

  1. Megatron's "f" before ``in_proj``;
  2. one split all-to-all over "model" (``parallel.gate_plan``) sends
     each of the rank's two pieces of xz to its owner: the rank ends with
     its x block and its z block, and no rank gathers xz;
  3. the conv, ``dt_proj`` (column parallel) and the scan run on the
     block, the per-channel leaves at the rank's block
     (``parallel.rank_block``: ``dt_bias`` is whole under the rules);
  4. ``x_proj`` is row parallel: one all-reduce of its small (dt_rank +
     2N) output, and "f" after it, since every rank uses all of it on its
     own channels;
  5. the skip and the gate, then the row-parallel ``out_proj``'s
     all-reduce.

A decode step runs the same per token.  Where the columns do not divide
over "model" the rules keep the mixer whole, and every rank runs all of
it.

Under the weight-stationary decode (``ws``, ``parallel.ws_mesh``) x is
every row of the batch at the rank's block of d over the data axes, and
the states are the rank's rows (``cache_pspec``: batch on the data axes,
d_inner on "model").  ``in_proj`` is contracted on its block of d
(``layers.ws_in``: partial sums, one float32 all-reduce an axis); the
rank keeps its rows and runs steps 2-5 on them as above; the output rows
are all-gathered over the data axes for ``out_proj``, contracted on its
block of d (``layers.ws_out``).  ``x_proj``, ``dt_proj`` and ``A_log``
(and ``conv_w`` where FSDP cuts its K taps, as on two data ranks; not at
full width) never touch the residual and stay gathered over the data
axes where FSDP put them (``parallel.weight``, as the baseline step
gathers them): at
jamba's full width the three come to about 2.1 MB a Mamba layer a rank
in bf16 (x_proj 1.1, dt_proj 1.0, A_log 0.03), 0.27% of the baseline
decode_32k step's 49.82 GB of all-gathers on pod1.  Contracting them
where the rows are would move about as many bytes at decode_32k's 128
rows (the rows of x_conv to every data rank, dt_proj's float32 partials
back) and put three more dependent collectives on every layer's path.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.launch import collectives as coll
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import MODEL_AXIS
from repro_torch.models import layers, parallel
from repro_torch.models.config import MambaConfig


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, d_inner) trailing inputs of the conv
    ssm: torch.Tensor   # (B, d_inner, N) recurrent SSM state (float32)


def dt_rank_of(d_model: int, mc: MambaConfig) -> int:
    return mc.dt_rank or -(-d_model // 16)


class Mamba(nn.Module):
    """The reference's ``init_mamba`` parameters: ``in_proj`` to (x, z),
    the depthwise ``conv_w`` (d_conv, d_in) and ``conv_b``, ``x_proj`` to
    (dt, B, C), ``dt_proj`` with ``dt_bias``, ``A_log`` (d_in, N), the skip
    ``D`` and ``out_proj``."""

    def __init__(self, d_model: int, mc: MambaConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        d_in = mc.expand * d_model
        rank = dt_rank_of(d_model, mc)
        kw = dict(device=device, dtype=dtype)
        self.in_proj = layers.Linear(d_model, 2 * d_in, **kw)
        self.conv_w = layers.empty_param((mc.d_conv, d_in), device, dtype)
        self.conv_b = layers.empty_param((d_in,), device, dtype)
        self.x_proj = layers.Linear(d_in, rank + 2 * mc.d_state, **kw)
        self.dt_proj = layers.Linear(rank, d_in, **kw)
        self.dt_bias = layers.empty_param((d_in,), device, dtype)
        self.A_log = layers.empty_param((d_in, mc.d_state), device, dtype)
        self.D = layers.empty_param((d_in,), device, dtype)
        self.out_proj = layers.Linear(d_in, d_model, **kw)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The reference's init: S4D-real A (A_log = log 1..N), dt_bias the
        inverse softplus of dt drawn log-uniformly from [0.001, 0.1]."""
        self.in_proj.reset_parameters(gen)
        self.conv_w.normal_(0.0, 1.0, generator=gen).mul_(0.1)
        self.conv_b.zero_()
        self.x_proj.reset_parameters(gen)
        self.dt_proj.reset_parameters(gen)
        f32 = dict(dtype=torch.float32, device=self.D.device)
        u = torch.empty(self.dt_bias.shape, **f32).uniform_(generator=gen)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001))
                       + math.log(0.001))
        self.dt_bias.copy_(torch.log(torch.expm1(dt)))
        n = self.A_log.shape[1]
        self.A_log.copy_(torch.log(torch.arange(1, n + 1, **f32)).expand(
            self.A_log.shape))
        self.D.fill_(1.0)
        self.out_proj.reset_parameters(gen)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                tail: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv over time, x (B, T, C), w (K, C): K shifted
    adds in x's dtype, in the reference's order.  ``tail`` (B, K-1, C):
    the previous inputs (decode, a continued sequence); zeros if None."""
    k = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([tail.to(x.dtype), x], dim=1)          # (B, T+K-1, C)
    t = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + t] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def plan(params: Mamba, d_model: int, mc: MambaConfig
         ) -> parallel.GatePlan | None:
    """The rank's :class:`~repro_torch.models.parallel.GatePlan` over
    ``in_proj``'s (x | z) columns; None where the mixer runs whole (no
    placement, or columns that do not divide)."""
    pl = parallel.placement(params.in_proj)
    if pl is None:
        return None
    return parallel.gate_plan(2, mc.expand * d_model, pl.model_size,
                              pl.model_rank, "Mamba in_proj")


def _in_proj(params: Mamba, x: torch.Tensor, gp: parallel.GatePlan | None,
             seq=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x_in and z of the rank's channel block: ``in_proj`` of x, then the
    split all-to-all of its column pieces to their owners (none over one
    rank, where the pieces are the rank's own).  With ``seq`` x is the
    rank's block of T, all-gathered at entry."""
    x = parallel.enter(x, params.in_proj, seq=seq)
    return _split_xz(params, layers.linear(params.in_proj, x), gp)


def _split_xz(params: Mamba, xz: torch.Tensor, gp: parallel.GatePlan | None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x_in and z of the rank's channel block from the rank's columns of
    ``in_proj``'s output (:func:`_in_proj`)."""
    if gp is None or len(gp.send) == 1:
        x_in, z = torch.chunk(xz, 2, dim=-1)
        return x_in, z
    c = gp.channels[1]
    pieces = xz.unflatten(-1, (len(gp.pieces), c)).movedim(-2, 0)
    if gp.order != tuple(range(len(gp.order))):
        pieces = pieces[list(gp.order)]
    mine = coll.all_to_all_split(pieces, parallel.placement(
        params.in_proj).mesh, MODEL_AXIS, list(gp.send), list(gp.recv))
    return mine[0], mine[1]


def _ssm_inputs(params: Mamba, x_conv: torch.Tensor, mc: MambaConfig,
                d_model: int, block: tuple[int, int] | None):
    """dt (float32, softplus in x's dtype), Bm and Cm (float32,
    contiguous) and A = -exp(A_log) (float32) of the scan, on the
    channels ``block`` (None: all of them)."""
    rank = dt_rank_of(d_model, mc)
    n = mc.d_state
    proj = layers.linear(params.x_proj, x_conv)
    if parallel.sharded_on_model(params.x_proj, "weight", 1):
        # every rank uses all of dt_raw, Bm and Cm on its own channels
        proj = coll.copy_to(proj, parallel.placement(params.x_proj).mesh,
                            MODEL_AXIS)
    dt_raw, b_mat, c_mat = torch.split(proj, [rank, n, n], dim=-1)
    dt_bias = parallel.rank_block(params, "dt_bias", 0, block)
    dt = F.softplus(layers.linear(params.dt_proj, dt_raw)
                    + dt_bias.to(x_conv.dtype)).to(torch.float32)
    a = -torch.exp(parallel.rank_block(params, "A_log", 0, block).to(
        torch.float32))
    f32 = torch.float32
    return (dt.contiguous(), b_mat.to(f32).contiguous(),
            c_mat.to(f32).contiguous(), a.contiguous())


def _conv(params: Mamba, x_in: torch.Tensor, tail, block):
    return F.silu(causal_conv(
        x_in, parallel.rank_block(params, "conv_w", 1, block),
        parallel.rank_block(params, "conv_b", 0, block), tail))


def _gate(params: Mamba, y: torch.Tensor, x_conv: torch.Tensor,
          z: torch.Tensor, dtype: torch.dtype, block) -> torch.Tensor:
    """The skip and the gate in float32, cast back to ``dtype``."""
    f32 = torch.float32
    y = y + x_conv.to(f32) * parallel.rank_block(params, "D", 0,
                                                 block).to(f32)
    return (y * F.silu(z.to(f32))).to(dtype)


def _gate_out(params: Mamba, y: torch.Tensor, x_conv: torch.Tensor,
              z: torch.Tensor, dtype: torch.dtype, block, seq=None
              ) -> torch.Tensor:
    """:func:`_gate`, then ``out_proj`` (with ``seq``, reduce-scattered
    onto the rank's block of T)."""
    return layers.linear(params.out_proj,
                         _gate(params, y, x_conv, z, dtype, block), seq=seq)


def mamba_forward(params: Mamba, x: torch.Tensor, mc: MambaConfig, *,
                  initial_state: MambaState | None = None,
                  return_state: bool = False, seq=None
                  ) -> tuple[torch.Tensor, MambaState | None]:
    """Full-sequence mixer: x (B, T, d_model) -> (out, the final state if
    ``return_state``).  ``initial_state`` continues a sequence.  On a
    sharded model the states are the rank's channel block; with ``seq``
    x and out are the rank's block of T (the scan runs the whole T)."""
    d_model = x.shape[-1]
    gp = plan(params, d_model, mc)
    block = None if gp is None else gp.channels
    x_in, z = _in_proj(params, x, gp, seq)
    tail = initial_state.conv if initial_state is not None else None
    x_conv = _conv(params, x_in, tail, block)
    dt, b_mat, c_mat, a = _ssm_inputs(params, x_conv, mc, d_model, block)
    h0 = initial_state.ssm if initial_state is not None else None
    y, h_final = ops.selective_scan(
        dt, x_conv.to(torch.float32).contiguous(), b_mat, c_mat, a, h0)
    out = _gate_out(params, y, x_conv, z, x.dtype, block, seq)

    state = None
    if return_state:
        k = mc.d_conv
        src = x_in if initial_state is None else torch.cat(
            [initial_state.conv.to(x_in.dtype), x_in], dim=1)
        conv_tail = src[:, -(k - 1):]
        short = k - 1 - conv_tail.shape[1]
        if short > 0:
            conv_tail = F.pad(conv_tail, (0, 0, short, 0))
        state = MambaState(conv=conv_tail, ssm=h_final)
    return out, state


def mamba_decode_step(params: Mamba, x: torch.Tensor, mc: MambaConfig,
                      state: MambaState, ws=None
                      ) -> tuple[torch.Tensor, MambaState]:
    """One-token step, x (B, 1, d_model).  Writes the new SSM state into
    ``state.ssm`` in place and returns it with the new conv tail.  With
    ``ws`` (the weight-stationary decode) x and out are every row of the
    batch at the rank's block of d: the module's docstring."""
    d_model = x.shape[-1] * (1 if ws is None else
                             mesh_lib.data_axis_size(ws))
    gp = plan(params, d_model, mc)
    if ws is None:
        x_in, z = _in_proj(params, x, gp)                  # (B, 1, c)
    else:
        xz, = layers.ws_in([params.in_proj], x, ws)
        x_in, z = _split_xz(params, parallel.ws_rows(
            xz, state.conv.shape[0], ws), gp)
    block = None if gp is None else gp.channels
    x_conv = _conv(params, x_in, state.conv, block)
    new_conv = torch.cat([state.conv.to(x_in.dtype), x_in], dim=1)[:, 1:]
    dt, b_mat, c_mat, a = _ssm_inputs(params, x_conv, mc, d_model, block)
    y, ssm = ops.selective_scan(
        dt, x_conv.to(torch.float32).contiguous(), b_mat, c_mat, a,
        state.ssm, state_out=state.ssm)
    if ws is None:
        out = _gate_out(params, y, x_conv, z, x.dtype, block)
    else:
        out = layers.ws_out(params.out_proj, parallel.ws_all_rows(
            _gate(params, y, x_conv, z, x.dtype, block), x.shape[0], ws),
            ws)
    return out, MambaState(conv=new_conv, ssm=ssm)


def init_mamba_state(batch: int, d_model: int, mc: MambaConfig,
                     dtype=torch.bfloat16, device=None) -> MambaState:
    """A zero state of every channel: the conv tail in ``dtype`` (the
    cache's), the SSM state in float32 (``transformer.init_cache`` cuts a
    sharded model's block of it)."""
    d_in = mc.expand * d_model
    return MambaState(
        conv=torch.zeros((batch, mc.d_conv - 1, d_in), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, d_in, mc.d_state), dtype=torch.float32,
                        device=device))
