"""Architecture configuration schema.

One :class:`ModelConfig` describes any architecture in the assigned pool:
dense GQA decoders, MoE, VLM backbones, audio encoders, SSMs (xLSTM), and
hybrids (Jamba).  ``layer_pattern`` encodes the repeating block structure so
hybrid stacks can be scanned over their period (keeping HLO size bounded for
126-layer models).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

MixerKind = Literal["attn", "mamba", "mlstm", "slstm"]
FFNKind = Literal["mlp", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One layer's composition: a sequence mixer + a feed-forward block."""

    mixer: MixerKind = "attn"
    ffn: FFNKind = "mlp"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 1024
    # capacity factor for GShard-style dispatch: capacity per expert =
    # ceil(tokens * top_k / num_experts * capacity_factor)
    capacity_factor: float = 1.25
    shared_expert: bool = False          # llama4-style always-on expert
    d_ff_shared: int = 0
    router_aux_loss_weight: float = 0.01  # load-balance auxiliary loss
    router_jitter: float = 0.0
    # §Perf knob: constrain expert buffers to the "model" mesh axis so the
    # dispatch einsum reduce-scatters each rank's own experts instead of
    # all-reducing the full (E, cap, d) buffer (16x fewer bytes at model=16).
    ep_sharding_constraint: bool = False
    # "einsum": GShard-style one-hot dispatch (portable, all-reduce-heavy);
    # "a2a": shard_map expert parallelism with explicit all_to_all dispatch
    # (the TPU-native schedule — see models/moe_a2a.py and §Perf).
    impl: str = "einsum"


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2          # d_inner = expand * d_model
    dt_rank: int = 0         # 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    mlstm_proj_factor: float = 2.0   # up-projection factor for mLSTM blocks
    slstm_proj_factor: float = 4.0 / 3.0
    chunk_size: int = 128            # chunkwise-parallel mLSTM chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: Literal["dense", "moe", "vlm", "audio", "ssm", "hybrid"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    # layer pattern: the stack is n_layers/len(pattern) repetitions of this
    # block tuple. Dense models: a single ("attn","mlp") entry.
    layer_pattern: tuple[BlockSpec, ...] = (BlockSpec(),)
    # attention
    rope_theta: float = 10000.0
    qk_norm: bool = False             # qwen3-style per-head q/k RMSNorm
    mrope: bool = False               # qwen2-vl multimodal RoPE (t/h/w sections)
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # in rotary half-dims
    causal: bool = True               # False for encoder-only (hubert)
    sliding_window: int = 0           # 0 = full attention; >0 = window size
    # sub-configs
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    xlstm: XLSTMConfig | None = None
    # frontends (VLM/audio): embeddings come precomputed from a stub frontend
    embeds_input: bool = False
    # serving / scoring head
    score_head: bool = True
    # numerics
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # citation / provenance
    source: str = ""

    def __post_init__(self) -> None:
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_layers % len(self.layer_pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern period {len(self.layer_pattern)}"
            )
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError(f"{self.name}: n_heads must be a multiple of n_kv_heads")

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.layer_pattern)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def has_decode(self) -> bool:
        return self.causal

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + heads)."""
        d, hd = self.d_model, self.head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        total = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d  # lm head
        for spec in self.layer_pattern * self.n_groups:
            if spec.mixer == "attn":
                total += d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
                total += 2 * d  # norms
                if self.qk_norm:
                    total += 2 * hd
            elif spec.mixer == "mamba":
                mc = self.mamba or MambaConfig()
                d_in = mc.expand * d
                dt_rank = mc.dt_rank or -(-d // 16)
                total += d * 2 * d_in            # in_proj (x, z)
                total += d_in * mc.d_conv        # conv
                total += d_in * (dt_rank + 2 * mc.d_state)  # x -> dt, B, C
                total += dt_rank * d_in          # dt_proj
                total += d_in * mc.d_state       # A_log
                total += d_in                    # D
                total += d_in * d                # out_proj
                total += d                       # norm
            elif spec.mixer == "mlstm":
                xc = self.xlstm or XLSTMConfig()
                d_in = int(xc.mlstm_proj_factor * d)
                hd_in = d_in // self.n_heads
                total += d * 2 * d_in            # up proj (x, z)
                total += 3 * d_in * hd_in        # q, k, v (head-wise blocks)
                total += d_in * 2 * self.n_heads # i, f gate projections
                total += d_in * d                # down proj
                total += d                       # norm
            elif spec.mixer == "slstm":
                xc = self.xlstm or XLSTMConfig()
                total += 4 * d * d + 4 * d * d   # input + recurrent (i,f,z,o)
                total += 4 * d                   # biases
                f = xc.slstm_proj_factor
                total += int(d * d * f * 2)      # ffn-ish up/down
                total += d
            if spec.ffn == "mlp":
                total += 3 * d * self.d_ff + d   # swiglu + norm
            elif spec.ffn == "moe":
                mo = self.moe
                assert mo is not None
                total += d * mo.num_experts      # router
                total += mo.num_experts * 3 * d * mo.d_ff_expert
                if mo.shared_expert:
                    total += 3 * d * (mo.d_ff_shared or mo.d_ff_expert)
                total += d
        total += d  # final norm
        if self.score_head:
            total += d + 1
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        full = self.param_count()
        n_moe_layers = sum(1 for s in self.layer_pattern if s.ffn == "moe") * self.n_groups
        per_layer_expert = 3 * self.d_model * mo.d_ff_expert
        inactive = n_moe_layers * (mo.num_experts - mo.top_k) * per_layer_expert
        return full - inactive
