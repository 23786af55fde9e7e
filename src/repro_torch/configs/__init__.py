"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Every entry cites its source paper / model card; smoke variants are reduced
same-family configs (2 layers, d_model <= 512, <= 4 experts) for CPU tests.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig
from repro_torch.configs.shapes import SHAPES, InputShape  # re-export

_MODULES = {
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b_a17b",
}

ARCH_IDS: tuple[str, ...] = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch]).config()


def get_smoke_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch]).smoke_config()


def applicable_shapes(arch: str) -> tuple[str, ...]:
    """Which of the four assigned shapes run for this architecture.

    Skips (recorded in DESIGN.md §4):
      * encoder-only (hubert): no decode step -> decode_32k, long_500k skipped.
      * long_500k needs sub-quadratic attention: SSM/hybrid run natively;
        dense/MoE/VLM decoders run it via the sliding-window variant (we
        implement it, so they are NOT skipped).
    """
    cfg = get_config(arch)
    if cfg.is_encoder_only:
        return ("train_4k", "prefill_32k")
    return ("train_4k", "prefill_32k", "decode_32k", "long_500k")
