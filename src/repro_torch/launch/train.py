"""Training launcher (the port of `repro.launch.train`):

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen3-14b --smoke --steps 50 --batch 4 --seq 128

A thin wrapper over the Cluster façade: one `Cluster` (device, mesh and
kernel policy) compiling a `TrainProgram`. It runs on the GPU unless
`--device cpu` is given.

Sharding: under ``torchrun --nproc-per-node N`` (which sets ``RANK`` /
``WORLD_SIZE`` / ``LOCAL_RANK`` and the rendezvous address) each process
is one rank, on ``cuda:LOCAL_RANK``, and the mesh is ``(data, N //
data)`` over ("data", "model") with ``--data-axis`` data (0: all N), as
the reference's launcher builds it; the step
(`steps.make_sharded_train_step`) is then data-parallel over "data" and
tensor-parallel over "model", each leaf split as the plan splits it:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen3-14b --smoke --steps 4 --data-axis 2   # (2, 2)

An arch with block kinds the model axis does not take yet raises at a
model axis above 1 (`steps.check_mesh`). A single process given
``--data-axis`` without torchrun makes its own one-rank group (NCCL on
the card, gloo on the CPU) over a file store in a temporary directory:
no network. Without ``--data-axis`` and outside torchrun the run is the
plain single-device one.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.cluster import Cluster, TrainProgram
from repro_torch.cluster.policy import MODES
from repro_torch.configs import get
from repro_torch.core.addressing import MeshSpec
from repro_torch.device import resolve_device


def _start_group(device: torch.device) -> str | None:
    """Join torchrun's process group, or start a one-rank group of this
    process; -> the file store's directory to remove (None: torchrun's)."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)            # torchrun's env://
        return None
    root = tempfile.mkdtemp(prefix="repro_torch-group-")
    store = dist.FileStore(os.path.join(root, "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)
    return root


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch-train"))
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--data-axis", type=int, default=None,
                    help="data axis size (0 = all ranks; the model axis "
                         "takes the rest); given, or under torchrun, the "
                         "run is sharded over a process group")
    ap.add_argument("--policy", default=None, choices=MODES,
                    help="kernel policy mode (default: env-derived)")
    ap.add_argument("--no-resume", action="store_true",
                    help="ignore checkpoints in --checkpoint-dir")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get(args.arch + ("-smoke" if args.smoke else ""))
    device = resolve_device(args.device)
    mesh, store_dir = None, None
    if args.data_axis is not None or "WORLD_SIZE" in os.environ:
        n_dev = int(os.environ.get("WORLD_SIZE", 1))
        data = args.data_axis or n_dev
        if n_dev % data:
            ap.error(f"--data-axis {data} does not divide the {n_dev} ranks")
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
            torch.cuda.set_device(device)
        store_dir = _start_group(device)
        mesh = MeshSpec((data, n_dev // data), ("data", "model"))
    try:
        cluster = Cluster(cfg, mesh, device=device, policy=args.policy)
        program = cluster.compile(TrainProgram(
            num_steps=args.steps, batch=args.batch, seq=args.seq,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            resume=not args.no_resume))
        report = program.run()
    finally:
        if mesh is not None:
            dist.destroy_process_group()
        if store_dir is not None:
            import shutil
            shutil.rmtree(store_dir, ignore_errors=True)

    print(f"\nfinal step {report['final_step']} "
          f"in {report['wall_seconds']:.1f}s; "
          f"stragglers={len(report['straggler_events'])}")
    for m in report["metrics"][-5:]:
        print(f"  step {m['step']:>5d} loss={m['loss']:.4f} "
              f"{m['seconds'] * 1e3:.0f}ms")
    return report


if __name__ == "__main__":
    main()
