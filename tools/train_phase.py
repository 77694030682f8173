"""chip_smoke.py's train phase alone (GPU): build the three kernels of
qwen3-14b's fused route, optionally run the training card tests, then
`chip_smoke.train_phase()` (part=step, part=grads, part=run; ~1 min),
with the card's name and power limit.

    python3 tools/train_phase.py            # the phase
    python3 tools/train_phase.py --tests    # the card tests first
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

TESTS = "fused_op_backward or refuses or f32_result or flash_vjp or train_step"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tests", action="store_true",
                    help=f"run tests/test_torch_cuda.py -k '{TESTS}' first")
    args = ap.parse_args()

    import chip_smoke
    from repro_torch.kernels import build, launches

    print(chip_smoke.gpu_line(), flush=True)
    t0 = time.perf_counter()
    build.build(chip_smoke.QWEN_FUSED)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    if args.tests:
        r = subprocess.run([sys.executable, "-m", "pytest", "-q",
                            "tests/test_torch_cuda.py", "-k", TESTS],
                           cwd=ROOT, env=dict(os.environ,
                                              PYTHONPATH=str(ROOT / "src")))
        if r.returncode:
            return r.returncode
    t0 = time.perf_counter()
    chip_smoke.train_phase(launches)
    print(f"train phase {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
