"""chip_smoke.py's groups phase alone (GPU): build every kernel (the
phase runs rows 1-2 on qwen3-14b and conv2d in the locality example),
optionally run the groups' card tests, make qwen3-14b's 40 layers of
random weights on the card, then `chip_smoke.groups_phase()` (part=one,
two, quarantine, crash, locality, compress; ~1-2 min), with the card's
name and power limit.

    python3 tools/groups_phase.py            # the phase
    python3 tools/groups_phase.py --tests    # the card tests first
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

TESTS = "sharded or restore_places or subnormal or routes_by_shape"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tests", action="store_true",
                    help=f"run tests/test_torch_cuda.py -k '{TESTS}' first")
    args = ap.parse_args()

    import torch

    import chip_smoke
    from repro_torch.configs import get
    from repro_torch.kernels import build, launches
    from repro_torch.models import steps

    print(chip_smoke.gpu_line(), flush=True)
    t0 = time.perf_counter()
    build.build()
    for name in build.SOURCES:
        build.library(name)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    if args.tests:
        r = subprocess.run([sys.executable, "-m", "pytest", "-q",
                            "tests/test_torch_cuda.py", "-k", TESTS],
                           cwd=ROOT, env=dict(os.environ,
                                              PYTHONPATH=str(ROOT / "src")))
        if r.returncode:
            return r.returncode
    params = steps.init_params(get("qwen3-14b"), 0, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = chip_smoke.groups_phase(launches, params)
    print(f"groups phase {time.perf_counter() - t0:.1f} s: "
          f"traced {out['traced']}, conv2d {out['conv2d']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
