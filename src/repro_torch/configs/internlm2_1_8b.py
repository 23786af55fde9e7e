"""internlm2-1.8b — dense GQA decoder [arXiv:2403.17297]."""
from repro_torch.models.config import BlockSpec, ModelConfig

ARCH_ID = "internlm2-1.8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=92544,
        head_dim=128,
        rope_theta=1_000_000.0,
        layer_pattern=(BlockSpec("attn", "mlp"),),
        source="arXiv:2403.17297",
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
        rope_theta=1_000_000.0,
        layer_pattern=(BlockSpec("attn", "mlp"),),
        source="arXiv:2403.17297",
    )
