"""xlstm-1.3b — sLSTM + mLSTM blocks (xLSTM[7:1]) [arXiv:2405.04517].

Pattern period 8: one sLSTM block followed by seven mLSTM blocks; no separate
FFN (the xLSTM blocks carry their own up/down projections, hence d_ff = 0).
"""
from repro_torch.models.config import BlockSpec, ModelConfig, XLSTMConfig

ARCH_ID = "xlstm-1.3b"

_PATTERN = tuple(
    BlockSpec(mixer=("slstm" if i == 0 else "mlstm"), ffn="none")
    for i in range(8)
)


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        head_dim=512,
        layer_pattern=_PATTERN,
        xlstm=XLSTMConfig(mlstm_proj_factor=2.0, slstm_proj_factor=4.0 / 3.0,
                          chunk_size=128),
        source="arXiv:2405.04517",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        arch_type="ssm",
        n_layers=2,
        d_model=128,
        n_heads=2,
        n_kv_heads=2,
        d_ff=0,
        vocab_size=512,
        head_dim=64,
        layer_pattern=(BlockSpec("slstm", "none"), BlockSpec("mlstm", "none")),
        xlstm=XLSTMConfig(mlstm_proj_factor=2.0, slstm_proj_factor=4.0 / 3.0,
                          chunk_size=32),
        source="arXiv:2405.04517",
    )
