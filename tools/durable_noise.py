"""Where the spread of chip_smoke.py's `[chaos] part=durable` rates comes
from (GPU).

Runs `chip_smoke.chaos_durable` (qwen3-14b's graphed paged chaos session
at full width, the fault-free workload) once for each journal setting:
the journal's directory on the checkout's file system, the same with the
journal's fsync made a no-op (the journal is then flushed to the OS only),
and, where /dev/shm is writable, the journal on /dev/shm. Each setting
runs `--blocks` blocks ordered none, journal, journal, none. Every run
logs its `[chaos] part=durable` line (its rate, its capture chunk, its
median chunk, the commits' time); a summary line a setting gives the
spread of the rates in each mode and of the block ratios. A gate that
fails is reported, not raised. Prints the card's name and power limit.

    python3 tools/durable_noise.py --blocks 5
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import re
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def spread(xs) -> str:
    return f"{min(xs):.4f}-{max(xs):.4f}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, default=5)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.cluster.session import Cluster
    from repro_torch.configs import get
    from repro_torch.kernels import build
    from repro_torch.models import steps

    if not torch.cuda.is_available():
        print("durable_noise: CUDA is not available", file=sys.stderr)
        return 2
    print(cs.gpu_line(), flush=True)
    build.build(verbose=False)
    for name in build.SOURCES:
        build.library(name)
    params = steps.init_params(get("qwen3-14b"), 0, device="cuda")
    cluster = Cluster("qwen3-14b")
    reqs = cs.serve_requests(cluster.arch.vocab)
    with contextlib.redirect_stdout(io.StringIO()):
        prog, want = cs.chaos_faults(cluster, params, reqs)
    cs.DURABLE_BLOCKS = args.blocks

    scratch = Path(tempfile.mkdtemp(prefix="durable_noise_", dir=ROOT))
    settings = [("checkout", scratch / "fsync", True),
                ("no_fsync", scratch / "flush", False)]
    if os.access("/dev/shm", os.W_OK):
        settings.append(("shm", Path(tempfile.mkdtemp(dir="/dev/shm")), True))
    real_fsync = os.fsync
    try:
        for name, root, fsync in settings:
            root.mkdir(parents=True, exist_ok=True)
            out = io.StringIO()
            os.fsync = real_fsync if fsync else (lambda fd: None)
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(out):
                    cs.chaos_durable(prog, params, reqs, want, root)
                failed = ""
            except AssertionError as e:
                failed = str(e)
            finally:
                os.fsync = real_fsync
            text = out.getvalue()
            print(text, end="", flush=True)
            rates = {"none": [], "journal": []}
            for line in text.splitlines():
                m = re.search(r"mode=(none|journal) .*e2e_tokens_per_s=(\S+)",
                              line)
                if m:
                    rates[m.group(1)].append(float(m.group(2)))
            blocks = re.search(r"block_ratios=(\S+)", text)
            cs.log("durable_noise", setting=name, blocks=args.blocks,
                   none_rates=spread(rates["none"]),
                   journal_rates=spread(rates["journal"]),
                   block_ratios=blocks.group(1) if blocks else "none",
                   gate_failed=bool(failed),
                   seconds=f"{time.perf_counter() - t0:.1f}")
            if failed:
                print(f"[durable_noise] {name}: {failed}", flush=True)
    finally:
        for _, root, _ in settings:
            shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(scratch, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
