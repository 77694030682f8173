"""End-to-end training on the PyTorch port (the flow of
`examples/train_lm.py`): a ~100M-parameter xlstm-family LM for a few
hundred steps through `TrainProgram`: the synthetic stream with the
double-buffered feed, the train step, async checkpointing with resume,
straggler detection.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300

`--fast` takes a 27M variant; the run is on the GPU unless `--device cpu`
is given.
"""

import argparse
import dataclasses
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.cluster import Cluster, TrainProgram  # noqa: E402
from repro_torch.configs import get  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch-train-lm"))
    ap.add_argument("--fast", action="store_true",
                    help="27M CI-speed variant instead of ~100M")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # a ~100M-parameter xlstm-family model (8L, d=768, 32k vocab);
    # --fast: a 27M variant
    if args.fast:
        cfg = dataclasses.replace(
            get("xlstm-125m"), n_layers=4, vocab=8192, attn_chunk=128)
    else:
        cfg = dataclasses.replace(
            get("xlstm-125m"), n_layers=8, vocab=32768, attn_chunk=128)
    print(f"model: {cfg.name} variant, {cfg.n_params() / 1e6:.1f}M params")

    cluster = Cluster(cfg, device=args.device)
    program = cluster.compile(TrainProgram(
        num_steps=args.steps, batch=args.batch, seq=args.seq,
        checkpoint_dir=args.ckpt, checkpoint_every=100,
        log_every=max(min(25, args.steps // 4), 1), warmup=20,
        double_buffer=True, resume=True))

    t0 = time.time()
    report = program.run()

    losses = [m["loss"] for m in report["metrics"]]
    print(f"\n{report['final_step']} steps in {time.time() - t0:.0f}s "
          f"({report['final_step'] / max(time.time() - t0, 1):.2f} steps/s)")
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(must decrease on the zipfian stream)")
    print(f"stragglers flagged: {len(report['straggler_events'])}")
    if report["final_step"] >= 100:   # inside warmup the lr is ~0
        assert losses[-1] < losses[0], "loss did not improve"
    return report


if __name__ == "__main__":
    main()
