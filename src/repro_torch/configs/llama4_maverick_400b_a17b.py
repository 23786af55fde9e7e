"""llama4-maverick-400b-a17b — MoE 128e top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

MoE interleaved every other layer (dense SwiGLU otherwise), one shared
expert always active on MoE layers.  The early-fusion multimodal frontend is
stubbed like the VLM configs (text path exercised; embeds accepted directly).
"""
from repro_torch.models.config import BlockSpec, ModelConfig, MoEConfig

ARCH_ID = "llama4-maverick-400b-a17b"

_PATTERN = (BlockSpec("attn", "mlp"), BlockSpec("attn", "moe"))


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        head_dim=128,
        rope_theta=500_000.0,
        layer_pattern=_PATTERN,
        moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192,
                      capacity_factor=1.25, shared_expert=True,
                      d_ff_shared=8192),
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="moe",
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        head_dim=64,
        layer_pattern=(BlockSpec("attn", "mlp"), BlockSpec("attn", "moe")),
        moe=MoEConfig(num_experts=4, top_k=1, d_ff_expert=256,
                      capacity_factor=4.0, shared_expert=True,  # E/top_k: drop-free
                      d_ff_shared=256),
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
