"""qwen3-8b — dense GQA decoder with per-head QK-Norm [hf:Qwen/Qwen3-8B]."""
from repro_torch.models.config import BlockSpec, ModelConfig

ARCH_ID = "qwen3-8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=12288,
        vocab_size=151936,
        head_dim=128,
        rope_theta=1_000_000.0,
        qk_norm=True,
        layer_pattern=(BlockSpec("attn", "mlp"),),
        source="hf:Qwen/Qwen3-8B",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="dense",
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        head_dim=64,
        qk_norm=True,
        layer_pattern=(BlockSpec("attn", "mlp"),),
        source="hf:Qwen/Qwen3-8B",
    )
