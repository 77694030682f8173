"""xlstm-125m's prefill on the card, in bf16 and in f32 (GPU).

The whole config (12 layers: 9 mlstm, 3 slstm), seeded weights, B=8,
S=512, as chip_smoke.py's xlstm phase runs it: `make_prefill_step`'s
eager step, the mean of 5 after a warm-up, by CUDA events. bf16 is the
served path; an f32 run takes its mLSTM heads (gates, chunk sums,
carried state) in float64 since the gradient repair of ROADMAP Queue 3,
so its prefill is the one that repair can slow. One JSON line a dtype,
with the card's name and power limit.

Imports `repro_torch` from `--root`'s `src` (default: this checkout), so
a parent tree unpacked beside it is timed by the same script; compare
two trees only within one call, in turns:

    python3 tools/xlstm_prefill.py --root results/parent
    python3 tools/xlstm_prefill.py
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout whose src/repro_torch is timed")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))

    import numpy as np
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get
    from repro_torch.models import steps

    if not torch.cuda.is_available():
        print("xlstm_prefill: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    cfg = get("xlstm-125m")
    B, S = 8, 512
    tokens = torch.from_numpy(np.random.default_rng(23).integers(
        0, cfg.vocab, (B, S))).cuda()
    params = steps.init_params(cfg, 0, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        p = pytree.tree_map(
            lambda t: t.to(dtype) if t.dtype == torch.bfloat16 else t,
            params)
        step = steps.make_prefill_step(cfg, policy="fused").eager
        tok = step(p, {"tokens": tokens})
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(args.iters):
            tok = step(p, {"tokens": tokens})
        ev[1].record()
        torch.cuda.synchronize()
        print(json.dumps({
            "root": args.root, "dtype": str(dtype).replace("torch.", ""),
            "B": B, "S": S, "eager_ms": ev[0].elapsed_time(ev[1])
            / args.iters, "tokens": tok.tolist()[:4], "card": card}),
            flush=True)
        del p
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
