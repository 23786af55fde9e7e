"""qwen2-vl-7b — VLM language backbone with M-RoPE [arXiv:2409.12191].

The ViT vision encoder + projector are a stub frontend (DESIGN.md §4):
``input_specs()`` supplies fused patch/text embeddings of shape (B, T, d);
the backbone implements M-RoPE (t/h/w rotary sections) and dynamic-resolution
semantics via explicit (3, B, T) position ids.
"""
from repro_torch.models.config import BlockSpec, ModelConfig

ARCH_ID = "qwen2-vl-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="vlm",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        head_dim=128,
        rope_theta=1_000_000.0,
        mrope=True,
        mrope_sections=(16, 24, 24),
        embeds_input=True,
        layer_pattern=(BlockSpec("attn", "mlp"),),
        source="arXiv:2409.12191",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="vlm",
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        head_dim=64,
        mrope=True,
        mrope_sections=(8, 12, 12),
        embeds_input=True,
        layer_pattern=(BlockSpec("attn", "mlp"),),
        source="arXiv:2409.12191",
    )
