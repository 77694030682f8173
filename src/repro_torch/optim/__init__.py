"""The optimizer of the port (`repro.optim`): AdamW with f32 update math,
the warmup-cosine schedule and the gradient compression of the
reference (`compress.py`). The data-parallel train step
(`models/steps.make_sharded_train_step`) reduces in f32 without it, as
the reference's step does."""

from .adamw import AdamConfig, adam_init, adam_update, global_norm
from .compress import (compress_decompress, compressed_psum,
                       dequantize_int8, quantize_int8, wire_bytes)
from .schedule import warmup_cosine

__all__ = ["AdamConfig", "adam_init", "adam_update", "compress_decompress",
           "compressed_psum", "dequantize_int8", "global_norm",
           "quantize_int8", "warmup_cosine", "wire_bytes"]
