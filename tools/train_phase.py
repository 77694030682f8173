"""chip_smoke.py's train phase alone (GPU): build the three kernels of
qwen3-14b's fused route, optionally run the training card tests, then
`chip_smoke.train_phase()` (part=step, part=grads, part=remat,
part=run; ~1 min),
and with --dp the dp phase after it (the plan, the sharded step at
(data=1, model=1) held to the train phase's with its model collectives,
the same step with the per-layer gather (part=fsdp), the launcher with
--data-axis 1), with the card's name and power limit. With --tp,
chip_smoke's tp parts: rows 1-3 at the model axis's local shapes
(part=kernels), then the two-thread (1, 2) step (part=threads) and the
two-thread (2, 1) per-layer gather (part=fsdp_threads); --tp-only runs
those alone. --remat-only runs part=remat alone (the selective remat
policies on qwen3-14b at full width, TRAIN_LAYERS layers).

    python3 tools/train_phase.py            # the phase
    python3 tools/train_phase.py --tests    # the card tests first
    python3 tools/train_phase.py --dp       # then chip_smoke's dp phase
    python3 tools/train_phase.py --tp-only  # the tp parts alone (~2 min)
    python3 tools/train_phase.py --remat-only   # part=remat alone
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
    ap.add_argument("--dp", action="store_true",
                    help="run chip_smoke's dp phase after the train phase")
    ap.add_argument("--tp", action="store_true",
                    help="then chip_smoke's tp parts=kernels and threads")
    ap.add_argument("--tp-only", action="store_true",
                    help="the tp parts alone")
    ap.add_argument("--remat-only", action="store_true",
                    help="the train phase's part=remat alone")
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
    if args.remat_only:
        t0 = time.perf_counter()
        chip_smoke.train_remat_part(launches)
        print(f"train part=remat {time.perf_counter() - t0:.1f} s",
              flush=True)
        return 0
    if not args.tp_only:
        t0 = time.perf_counter()
        _, plain = chip_smoke.train_phase(launches)
        print(f"train phase {time.perf_counter() - t0:.1f} s", flush=True)
        if args.dp:
            t0 = time.perf_counter()
            chip_smoke.dp_phase(launches, plain)
            print(f"dp phase {time.perf_counter() - t0:.1f} s", flush=True)
        del plain
    if args.tp or args.tp_only:
        t0 = time.perf_counter()
        chip_smoke.tp_kernels_part([])
        chip_smoke.tp_threads_part(launches)
        chip_smoke.tp_fsdp_threads_part(launches)
        print(f"tp parts {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
