"""The optimizer of the port (`repro.optim`): AdamW with f32 update math
and the warmup-cosine schedule. The reference's gradient compression
(`optim/compress.py`) serves only the data-parallel reduction, which comes
with the groups slice (ROADMAP Queue 1 I)."""

from .adamw import AdamConfig, adam_init, adam_update, global_norm
from .schedule import warmup_cosine

__all__ = ["AdamConfig", "adam_init", "adam_update", "global_norm",
           "warmup_cosine"]
