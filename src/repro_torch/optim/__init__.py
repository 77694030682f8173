"""The optimizer of the port (`repro.optim`): AdamW with f32 update math,
the warmup-cosine schedule and the data-parallel reduction's gradient
compression (`compress.py`; the train step that reduces over several
cards is ROADMAP Queue 1 L)."""

from .adamw import AdamConfig, adam_init, adam_update, global_norm
from .compress import (compress_decompress, compressed_psum,
                       dequantize_int8, quantize_int8, wire_bytes)
from .schedule import warmup_cosine

__all__ = ["AdamConfig", "adam_init", "adam_update", "compress_decompress",
           "compressed_psum", "dequantize_int8", "global_norm",
           "quantize_int8", "warmup_cosine", "wire_bytes"]
