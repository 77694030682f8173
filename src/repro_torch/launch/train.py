"""Training launcher (the port of `repro.launch.train`):

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen3-14b --smoke --steps 50 --batch 4 --seq 128

A thin wrapper over the Cluster façade: one `Cluster` (device and kernel
policy) compiling a `TrainProgram`. It runs on the GPU unless `--device
cpu` is given.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.cluster import Cluster, TrainProgram
from repro_torch.cluster.policy import MODES
from repro_torch.configs import get


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
    ap.add_argument("--data-axis", type=int, default=0,
                    help="data axis size (0 = all devices; the port runs "
                         "on one device until ROADMAP Queue 1 I)")
    ap.add_argument("--policy", default=None, choices=MODES,
                    help="kernel policy mode (default: env-derived)")
    ap.add_argument("--no-resume", action="store_true",
                    help="ignore checkpoints in --checkpoint-dir")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.data_axis not in (0, 1):
        ap.error(f"--data-axis {args.data_axis}: the port trains on one "
                 f"device (data parallelism is ROADMAP Queue 1 I)")

    cfg = get(args.arch + ("-smoke" if args.smoke else ""))
    cluster = Cluster(cfg, device=args.device, policy=args.policy)
    program = cluster.compile(TrainProgram(
        num_steps=args.steps, batch=args.batch, seq=args.seq,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        resume=not args.no_resume))
    report = program.run()

    print(f"\nfinal step {report['final_step']} "
          f"in {report['wall_seconds']:.1f}s; "
          f"stragglers={len(report['straggler_events'])}")
    for m in report["metrics"][-5:]:
        print(f"  step {m['step']:>5d} loss={m['loss']:.4f} "
              f"{m['seconds'] * 1e3:.0f}ms")
    return report


if __name__ == "__main__":
    main()
