"""Elastic restart on the PyTorch port: survive a node failure and resume
on the survivors (the flow of `examples/elastic_restart.py`).

Drives the compiled step of a Cluster `TrainProgram` by hand:
  1. train, async-checkpointing every 3 steps;
  2. "lose a host" (a `Coordinator` leave event) mid-run -> a blocking
     preemption checkpoint;
  3. re-plan the mesh for the survivors (model axis kept, data axis
     shrunk);
  4. restore the same logical state onto the survivors' device
     (`CheckpointManager.restore(..., shardings=device)`), bit for bit,
     and keep training — the data stream is a pure function of (seed,
     step), so not a single batch repeats.

    PYTHONPATH=src python examples/elastic_restart_torch.py

Trains on the GPU; `--device cpu` trains on the CPU.
"""

import argparse
import os
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.cluster import Cluster, TrainProgram, cells  # noqa: E402
from repro_torch.data import BatchSpec, SyntheticLMStream  # noqa: E402
from repro_torch.runtime.coordination import (  # noqa: E402
    Coordinator, replan_mesh_shape)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--arch", default="qwen3-14b-smoke")
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch-elastic"))
    args = ap.parse_args(argv)
    shutil.rmtree(args.ckpt, ignore_errors=True)

    cluster = Cluster(args.arch, device=args.device)
    cfg = cluster.arch
    # compile once; drive the program's step function by hand so the
    # failure/restore choreography stays explicit
    program = cluster.compile(TrainProgram(
        num_steps=10, batch=args.batch, seq=args.seq, seed=1,
        checkpoint_dir=args.ckpt))
    state = program.init_state(seed=1)
    train_step = program.step
    mgr = CheckpointManager(args.ckpt, keep=2)
    stream = SyntheticLMStream(BatchSpec(args.batch, args.seq, cfg.vocab),
                               seed=1)
    fed = []                                  # the stream steps trained on

    def step_on(state, k):
        fed.append(k)
        return train_step(state, stream.batch(k))

    # phase 1: run on the "big" mesh, checkpoint every 3 steps
    coord = Coordinator(n_hosts=64)
    step = 0
    for _ in range(7):
        state, metrics = step_on(state, step)
        step += 1
        if step % 3 == 0:
            mgr.save(step, state)
    print(f"phase 1: reached step {step}, "
          f"loss={float(metrics['loss']):.4f}")

    # phase 2: a host dies -> the coordinator's survivors replan the mesh
    coord.emit("leave", "host-17")
    new_shape = replan_mesh_shape(coord.n_hosts * 4, model_parallel=1)
    print(f"host lost: {coord.n_hosts} hosts remain -> new mesh "
          f"{new_shape}")
    mgr.save(step, state, block=True)          # preemption checkpoint

    # phase 3: a fresh process's view — restore the logical state onto
    # the survivors' device (one card here; the layout is
    # device-independent), every leaf placed by `shardings`
    latest = mgr.latest_step()
    survivor = cells.group_devices(cluster, 1)[0]
    like = pytree.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                           state)
    restored = mgr.restore(latest, like, shardings=survivor)
    for a, b in zip(pytree.tree_leaves(state), pytree.tree_leaves(restored)):
        if b.device != survivor or not torch.equal(_bits(a), _bits(b)):
            raise AssertionError("the restored state differs from the "
                                 "saved one")
    print(f"restored step {latest} bit-exactly onto {survivor}")

    # phase 4: continue where we left off — the stream is f(seed, step)
    state = restored
    for _ in range(3):
        state, metrics = step_on(state, latest)
        latest += 1
    if len(set(fed)) != len(fed) or fed != list(range(len(fed))):
        raise AssertionError(f"batches repeated or skipped: {fed}")
    loss = float(metrics["loss"])
    print(f"resumed to step {latest}, loss={loss:.4f} — no data repeated, "
          f"no optimizer state lost")
    return {"final_step": latest, "fed": fed, "loss": loss,
            "mesh": new_shape, "state": state}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


if __name__ == "__main__":
    main()
