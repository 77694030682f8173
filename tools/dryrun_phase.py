"""chip_smoke.py's [dryrun] part alone (GPU): build the three kernels of
qwen3-14b's fused route, trace every cell of `chip_smoke.dryrun_cells`
in a process with no card visible, and hold each trace to a real call on
a one-rank NCCL (data=1, model=1) mesh: the mesh cells on qwen3-14b's
weights at full width and depth, then the train cell (4 layers at full
width, a fresh train state) after the weights are freed; with the card's
name and power limit.

    python3 tools/dryrun_phase.py           # (~3 min)
"""

from __future__ import annotations

import gc
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    import torch
    import torch.distributed as dist

    import chip_smoke
    from repro_torch.cluster import cells
    from repro_torch.configs import get
    from repro_torch.core import addressing
    from repro_torch.core.addressing import MeshSpec
    from repro_torch.kernels import build, launches
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import steps

    print(chip_smoke.gpu_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        dry = chip_smoke.dryrun_start(tmp)
        t0 = time.perf_counter()
        build.build(chip_smoke.QWEN_FUSED)
        print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
        cfg = get("qwen3-14b")
        params = steps.init_params(cfg, 0, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chip_smoke.dryrun_mesh_part(launches, cfg, params, *dry)
        print(f"dryrun mesh cells {time.perf_counter() - t0:.1f} s",
              flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    tcfg, shape, _ = chip_smoke.dryrun_cells()["train"]
    state = steps.init_train_state(tcfg, 0, device="cuda",
                                   max_seq=shape.seq_len)
    batch = chip_smoke._stream_batches(tcfg, shape.global_batch,
                                       shape.seq_len, 1)[0]
    with tempfile.TemporaryDirectory() as root:
        dist.init_process_group("nccl", store=dist.FileStore(
            f"{root}/store", 1), rank=0, world_size=1)
        try:
            mesh = make_device_mesh(MeshSpec((1, 1), ("data", "model")),
                                    "cuda")
            fn = cells.build_cell(tcfg, shape, mesh,
                                  addressing.default_rules(mesh),
                                  policy="fused")[0]
            chip_smoke.dryrun_train(launches, fn, state, batch)
        finally:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
