"""Data pipeline (the port of `repro.data.pipeline`): MemPool's
distributed DMA (paper §5.3) mapped to host feeding.

  frontend    = the training loop requesting "global batch for step k"
  Splitter    = cuts the global batch at shard boundaries
  Distributor = routes each slice to the device that owns it
  backend     = the loader materializing a slice

The stream is stateless-resumable: batch k is a pure function of (seed,
k), drawn with numpy exactly as the reference draws it (bit for bit), so
a restored checkpoint needs no loader state and a resumed run continues
the stream at its step. Where the reference takes a JAX mesh and its
batch axes, the port takes its devices (one card here; data parallelism
over several is the groups slice, ROADMAP Queue 1 I). The slicing
arithmetic is the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    global_batch: int
    seq_len: int
    vocab: int


class SyntheticLMStream:
    """Deterministic synthetic token stream: each row an independent
    zipfian draw over the vocab. Batch k is a pure function of (seed, k)."""

    def __init__(self, spec: BatchSpec, seed: int = 0):
        self.spec = spec
        self.seed = seed
        ranks = np.arange(1, spec.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._p = p / p.sum()

    def batch(self, step: int, lo: int = 0, hi: int | None = None) -> dict:
        """Rows [lo, hi) of global batch `step` (the splitter's slice), as
        int32 numpy arrays {"tokens", "labels"} (labels: tokens shifted
        by one)."""
        hi = self.spec.global_batch if hi is None else hi
        out_tokens = np.empty((hi - lo, self.spec.seq_len + 1), np.int32)
        for row in range(lo, hi):
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + step) * 131_071 + row)
            out_tokens[row - lo] = rng.choice(
                self.spec.vocab, size=self.spec.seq_len + 1, p=self._p)
        return {"tokens": out_tokens[:, :-1], "labels": out_tokens[:, 1:]}


class Splitter:
    """Cut a global batch request at shard boundaries (the paper's
    splitter): one shard a device of `devices`."""

    def __init__(self, devices: Sequence):
        self.devices = list(devices)
        self.n_shards = max(len(self.devices), 1)

    def slices(self, global_batch: int) -> list[tuple[int, int]]:
        n = self.n_shards
        if global_batch % n:
            n = math.gcd(global_batch, n)
        per = global_batch // n
        return [(i * per, (i + 1) * per) for i in range(n)]


class Distributor:
    """Route shard slices to their owning devices (the paper's distributor
    tree). In one process every device is local, so each slice is
    materialized here; the routing (slice i -> device i) is the
    reference's."""

    def __init__(self, devices: Sequence, splitter: Splitter):
        self.devices = list(devices)
        self.splitter = splitter

    def local_slices(self, global_batch: int) -> list[tuple[int, int]]:
        return list(self.splitter.slices(global_batch))

    def materialize(self, stream: SyntheticLMStream, step: int,
                    device=None) -> dict:
        """The global batch `step` from its per-slice parts, as int32
        tensors on `device` (None: the GPU). The copy is a plain one on
        the calling thread's current stream, so it is ordered with any
        work already queued there."""
        device = resolve_device(device)
        parts = [stream.batch(step, lo, hi)
                 for lo, hi in self.local_slices(stream.spec.global_batch)]
        return {k: torch.from_numpy(np.concatenate([p[k] for p in parts]))
                .to(device) for k in parts[0]}


def stream_batches(stream: SyntheticLMStream, distributor: Distributor,
                   device=None, start_step: int = 0) -> Iterator[dict]:
    """The global batches from `start_step` on, on `device` (the feed of
    `CompiledTrain.run` without double buffering)."""
    step = start_step
    while True:
        yield distributor.materialize(stream, step, device)
        step += 1
