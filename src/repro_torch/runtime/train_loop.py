"""Training driver (the port of `repro.runtime.train_loop`): the data
feed, the train step (or a K-step chunk), async checkpointing, per-step
straggler detection, a SIGTERM-triggered final checkpoint and resume from
the latest checkpoint.

With `steps_per_sync > 1` and a `train_chunk` (`engine.make_train_chunk`)
the loop runs K steps a host round-trip: the straggler detector and the
log sample at chunk granularity and the host syncs once a chunk. The
state is updated in place by the step; a checkpoint takes its host copy
when `save` is called, before the next step runs.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Callable

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.runtime.engine import StallClock, stack_batches


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(),
                                       "repro_torch-ckpt")
    keep_checkpoints: int = 3
    # straggler detection: flag steps slower than mean + z * std
    straggler_z: float = 3.0
    straggler_warmup: int = 10
    # steps a host sync (needs a train_chunk; 1 = the per-step loop)
    steps_per_sync: int = 1


class StragglerDetector:
    """Per-step wall-time z-score detector (paper §8: a straggling host
    shows up as a slow step)."""

    def __init__(self, z: float = 3.0, warmup: int = 10):
        self.z = z
        self.warmup = warmup
        self.times: list[float] = []
        self.events: list[dict] = []

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) <= self.warmup:
            return False
        hist = np.asarray(self.times[-100:-1])
        mu, sd = hist.mean(), hist.std() + 1e-9
        if dt > mu + self.z * sd:
            self.events.append({"step": step, "seconds": dt, "mean": mu,
                                "sigma": sd})
            return True
        return False


def _crossed(prev: int, step: int, every: int) -> bool:
    """Did [prev, step] cross a multiple of `every`? (chunk-safe cadence)"""
    return step // max(every, 1) > prev // max(every, 1)


class TrainLoop:
    def __init__(self, cfg: TrainLoopConfig, train_step: Callable, state,
                 batch_iter, *, train_chunk: Callable | None = None):
        self.cfg = cfg
        self.train_step = train_step
        self.train_chunk = train_chunk
        self.state = state
        self.batch_iter = batch_iter
        self.ckpt = CheckpointManager(cfg.checkpoint_dir,
                                      keep=cfg.keep_checkpoints)
        self.straggler = StragglerDetector(cfg.straggler_z,
                                           cfg.straggler_warmup)
        self.metrics_log: list[dict] = []
        self.clock = StallClock()
        self._preempted = False

    # -- fault handling -----------------------------------------------------
    def _install_preemption_handler(self):
        """SIGTERM sets the preemption flag until `run` returns, which then
        puts the previous handler back (the reference leaves its own
        installed)."""
        def handler(signum, frame):
            self._preempted = True
        try:
            return signal.signal(signal.SIGTERM, handler)
        except ValueError:
            return None  # not on the main thread (tests)

    def maybe_resume(self) -> int:
        step = self.ckpt.latest_step()
        if step is None:
            return 0
        self.state = self.ckpt.restore(step, self.state)
        return step

    # -- main loop ------------------------------------------------------------
    def _next_batch(self):
        batch = next(self.batch_iter)
        if isinstance(batch, tuple):           # (step_idx, batch) feeds
            batch = batch[1]
        return batch

    def run(self, start_step: int | None = None) -> dict:
        prev = self._install_preemption_handler()
        try:
            return self._run(start_step)
        finally:
            if prev is not None:
                signal.signal(signal.SIGTERM, prev)

    def _run(self, start_step: int | None) -> dict:
        step = self.maybe_resume() if start_step is None else start_step
        k_cfg = max(self.cfg.steps_per_sync, 1)
        chunked = k_cfg > 1 and self.train_chunk is not None
        self.clock = StallClock()
        t_loop = time.perf_counter()
        while step < self.cfg.total_steps and not self._preempted:
            k = min(k_cfg, self.cfg.total_steps - step) if chunked else 1
            if chunked and k > 1:
                batches = [self._next_batch() for _ in range(k)]
                t0 = self.clock.dispatch()
                self.state, metrics = self.train_chunk(
                    self.state, stack_batches(batches))
            else:
                batch = self._next_batch()
                t0 = self.clock.dispatch()
                self.state, metrics = self.train_step(self.state, batch)
            self.clock.sync(metrics["loss"])
            loss = float(metrics["loss"].reshape(-1)[-1])   # (K,) or 0-d
            dt = time.perf_counter() - t0
            prev, step = step, step + k
            slow = self.straggler.observe(step, dt)
            if _crossed(prev, step, self.cfg.log_every) or slow:
                row = {"step": step, "seconds": dt, "loss": loss,
                       "straggler": bool(slow)}
                if k > 1:
                    row["steps_in_chunk"] = k
                self.metrics_log.append(row)
            if _crossed(prev, step, self.cfg.checkpoint_every):
                self.ckpt.save(step, self.state)
        # final checkpoint on natural end or preemption
        self.ckpt.save(step, self.state, block=True)
        self.ckpt.wait()
        return {"final_step": step,
                "preempted": self._preempted,
                "wall_seconds": time.perf_counter() - t_loop,
                "straggler_events": self.straggler.events,
                "stall": self.clock.report(),
                "steps_per_sync": k_cfg if chunked else 1,
                "metrics": self.metrics_log}
