"""deepseek-coder-33b — dense GQA decoder, llama-arch [arXiv:2401.14196]."""
from repro_torch.models.config import BlockSpec, ModelConfig

ARCH_ID = "deepseek-coder-33b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="dense",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=19200,
        vocab_size=32256,
        head_dim=128,
        rope_theta=100_000.0,
        layer_pattern=(BlockSpec("attn", "mlp"),),
        source="arXiv:2401.14196",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="dense",
        n_layers=2,
        d_model=224,
        n_heads=7,
        n_kv_heads=1,
        d_ff=448,
        vocab_size=384,
        head_dim=32,
        rope_theta=100_000.0,
        layer_pattern=(BlockSpec("attn", "mlp"),),
        source="arXiv:2401.14196",
    )
