"""llama3-405b — dense GQA decoder, 128k vocab [arXiv:2407.21783]."""
from repro_torch.models.config import BlockSpec, ModelConfig

ARCH_ID = "llama3-405b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=126,
        d_model=16384,
        n_heads=128,
        n_kv_heads=8,
        d_ff=53248,
        vocab_size=128256,
        head_dim=128,
        rope_theta=500_000.0,
        layer_pattern=(BlockSpec("attn", "mlp"),),
        source="arXiv:2407.21783",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="dense",
        n_layers=2,
        d_model=256,
        n_heads=8,
        n_kv_heads=2,
        d_ff=768,
        vocab_size=640,
        head_dim=32,
        rope_theta=500_000.0,
        layer_pattern=(BlockSpec("attn", "mlp"),),
        source="arXiv:2407.21783",
    )
