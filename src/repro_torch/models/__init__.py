"""Model zoo in PyTorch: the dense and encoder attention + MLP family."""
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
