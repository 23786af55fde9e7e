"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7, MoE 16e top-2
[arXiv:2403.19887].

Block structure (period 8): attention at index 4 of each 8-layer block
(1 attn : 7 mamba), MoE replacing the dense MLP on every other layer.
"""
from repro_torch.models.config import BlockSpec, MambaConfig, ModelConfig, MoEConfig

ARCH_ID = "jamba-1.5-large-398b"

_PATTERN = tuple(
    BlockSpec(
        mixer=("attn" if i == 4 else "mamba"),
        ffn=("moe" if i % 2 == 1 else "mlp"),
    )
    for i in range(8)
)


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        head_dim=128,
        rope_theta=10_000.0,
        layer_pattern=_PATTERN,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576,
                      capacity_factor=1.25),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        source="arXiv:2403.19887",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="hybrid",
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        head_dim=64,
        layer_pattern=(BlockSpec("mamba", "mlp"), BlockSpec("attn", "moe")),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=256,
                      capacity_factor=2.0),  # = E/top_k: drop-free for tests
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
        source="arXiv:2403.19887",
    )
