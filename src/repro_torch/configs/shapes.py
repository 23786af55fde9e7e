"""Assigned input shapes (public pool) + shape-kind semantics.

  train_4k     — training step          (seq 4,096,   global batch 256)
  prefill_32k  — inference prefill      (seq 32,768,  global batch 32)
  decode_32k   — inference decode: ONE new token, KV cache of seq_len
                 (seq 32,768, global batch 128)
  long_500k    — long-context decode    (seq 524,288, global batch 1);
                 requires sub-quadratic attention: native for SSM/hybrid,
                 sliding-window variant for dense decoders, skipped for
                 encoder-only models.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

ShapeKind = Literal["train", "prefill", "decode"]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: ShapeKind


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES: dict[str, InputShape] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}
