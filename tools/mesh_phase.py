"""chip_smoke.py's mesh parts alone (GPU): build the three kernels of
qwen3-14b's fused route, then the serving cells on a mesh: part=kernels
(rows 1-2 on the decode kernel at a rank's local decode shapes, row 3 at
the (1, 2) prefill's heads), part=cells (qwen3-14b at full width and
depth on a one-rank NCCL (data=1, model=1) mesh, each cell bit-equal to
its plain path) and part=threads (a (data=1, model=2) decode of qwen3-14b
at full depth, two thread ranks, against the one-rank step in bf16 and
in f32), with the card's name and power limit.

    python3 tools/mesh_phase.py             # the three parts (~4 min)
    python3 tools/mesh_phase.py --threads   # part=threads alone
"""

from __future__ import annotations

import argparse
import gc
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", action="store_true",
                    help="part=threads alone")
    args = ap.parse_args()

    import torch

    import chip_smoke
    from repro_torch.configs import get
    from repro_torch.kernels import build, launches
    from repro_torch.models import steps

    print(chip_smoke.gpu_line(), flush=True)
    t0 = time.perf_counter()
    build.build(chip_smoke.QWEN_FUSED)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    if not args.threads:
        t0 = time.perf_counter()
        chip_smoke.tp_kernels_part([], chip_smoke.MESH_ROWS, "mesh")
        print(f"mesh part=kernels {time.perf_counter() - t0:.1f} s",
              flush=True)
        cfg = get("qwen3-14b")
        t0 = time.perf_counter()
        params = steps.init_params(cfg, 0, device="cuda")
        torch.cuda.synchronize()
        print(f"params {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        chip_smoke.mesh_cells_part(launches, cfg, params)
        print(f"mesh part=cells {time.perf_counter() - t0:.1f} s",
              flush=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    chip_smoke.mesh_threads_part(launches)
    print(f"mesh part=threads {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
