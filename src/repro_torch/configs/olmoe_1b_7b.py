"""olmoe-1b-7b — MoE decoder, 64 experts top-8 [arXiv:2409.02060]."""
from repro_torch.models.config import BlockSpec, ModelConfig, MoEConfig

ARCH_ID = "olmoe-1b-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,
        vocab_size=50304,
        head_dim=128,
        rope_theta=10_000.0,
        qk_norm=True,  # OLMoE uses QK-Norm
        layer_pattern=(BlockSpec("attn", "moe"),),
        moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024,
                      capacity_factor=1.25),
        source="arXiv:2409.02060",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        head_dim=32,
        qk_norm=True,
        layer_pattern=(BlockSpec("attn", "moe"),),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                      capacity_factor=2.0),  # = E/top_k: drop-free for tests
        source="arXiv:2409.02060",
    )
