"""Model zoo in PyTorch: attention, Mamba and xLSTM mixers, MLP and MoE FFNs."""
from repro_torch.models.config import (
    BlockSpec,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    XLSTMConfig,
)
from repro_torch.models.model import DecodeOutput, Model, ModelOutput

__all__ = [
    "BlockSpec", "MambaConfig", "ModelConfig", "MoEConfig", "XLSTMConfig",
    "DecodeOutput", "Model", "ModelOutput",
]
