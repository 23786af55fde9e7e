"""hubert-xlarge — audio encoder-only backbone [arXiv:2106.07447].

The mel-spectrogram + conv feature extractor is a stub frontend: frame
embeddings (B, T, 1280) arrive precomputed.  Encoder-only (bidirectional,
non-causal) — no decode step, so decode_32k / long_500k are skipped for this
architecture (recorded in DESIGN.md §4).  The LM head predicts the 504
discrete HuBERT cluster units per frame (masked prediction objective).
"""
from repro_torch.models.config import BlockSpec, ModelConfig

ARCH_ID = "hubert-xlarge"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        head_dim=80,
        causal=False,
        embeds_input=True,
        layer_pattern=(BlockSpec("attn", "mlp"),),
        source="arXiv:2106.07447",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="audio",
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=4,
        d_ff=512,
        vocab_size=104,
        head_dim=64,
        causal=False,
        embeds_input=True,
        layer_pattern=(BlockSpec("attn", "mlp"),),
        source="arXiv:2106.07447",
    )
