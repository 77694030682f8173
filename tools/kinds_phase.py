"""chip_smoke.py's kinds parts alone (GPU): the model axis of the other
block kinds. Builds the four kernels their paths take, runs [tp]
part=kernels on the new rows (row 7 at whisper-small's rank shapes, rows
1-2 at recurrentgemma-9b's and llama-3.2-vision-90b's at model 2), then
for each arch draws its weights on the card as its chip_smoke phase does
and runs the phase's kinds parts on them: [tp] part=kinds (the sharded
train step on a one-rank NCCL (1, 1) mesh, bit-equal to the plain step;
vision: one attn and one cross block, forward and backward), [tp]
part=kinds_threads (a (1, 2) step on two thread ranks against the
one-rank gradients' noise floor), [mesh] part=kinds_cells (build_cell's
cells on (1, 1), bit-equal) and [mesh] part=kinds_threads (a (1, 2)
decode on two thread ranks), with the card's name and power limit; for
xlstm-125m then [tp] part=xlstm_tponly (the same parts under the dry
run's tponly rules, its mLSTM / sLSTM leaves split over "model";
--tponly-only runs that part alone).

    python3 tools/kinds_phase.py                    # every arch (~3 min)
    python3 tools/kinds_phase.py --arch xlstm-125m  # one arch
    python3 tools/kinds_phase.py --no-rows          # skip part=kernels
    python3 tools/kinds_phase.py --arch xlstm-125m --tponly-only --no-rows
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

ARCHS = ("whisper-small", "recurrentgemma-9b", "xlstm-125m",
         "llama-3.2-vision-90b")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", choices=ARCHS,
                    help="the archs to run (default: all four)")
    ap.add_argument("--no-rows", action="store_true",
                    help="skip [tp] part=kernels")
    ap.add_argument("--tponly-only", action="store_true",
                    help="xlstm-125m: [tp] part=xlstm_tponly alone")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.configs import get
    from repro_torch.kernels import build, launches

    print(cs.gpu_line(), flush=True)
    t0 = time.perf_counter()
    build.build(cs.QWEN_FUSED + ("matmul_bias_act",))
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    if not args.no_rows:
        t0 = time.perf_counter()
        rows = tuple(r for r in cs.TP_ROWS if r[0].split("/")[0] in
                     ("whisper", "rgemma", "vision"))
        cs.tp_kernels_part([], rows)
        print(f"tp part=kernels {time.perf_counter() - t0:.1f} s",
              flush=True)
    for arch in args.arch or ARCHS:
        t0 = time.perf_counter()
        cfg = get(arch)
        if arch == "llama-3.2-vision-90b":
            cfg = dataclasses.replace(cfg, n_layers=cs.VLM_LAYERS)
        params = cs.init_on_card(arch, cfg)
        kw = {}
        if arch == "whisper-small":
            g = torch.Generator(device="cuda").manual_seed(3)
            frames = torch.randn((cs.KINDS_B, cfg.enc_seq, cfg.d_model),
                                 generator=g, device="cuda").bfloat16()
            kw = dict(train_cfg=cfg, fresh=lambda: cs._clone_tree(params),
                      batch=cs._stream_batches(cfg, cs.KINDS_B, cs.KINDS_S,
                                               1, seed=5)[0]
                      | {"enc_embeds": frames},
                      must=("matmul_bias_act",))
        elif arch == "recurrentgemma-9b":
            L = cs.KINDS_TRAIN_LAYERS[arch]
            kw = dict(train_cfg=dataclasses.replace(cfg, n_layers=L,
                                                    grad_accum=1),
                      fresh=lambda: cs._clone_tree(params, L),
                      batch=cs._stream_batches(cfg, cs.KINDS_B, cs.KINDS_S,
                                               1, seed=6)[0],
                      must=("rmsnorm_matmul", "matmul_residual_add"))
        elif arch == "xlstm-125m":
            kw = dict(train_cfg=cfg, fresh=lambda: cs._clone_tree(params),
                      batch=cs._stream_batches(cfg, cs.KINDS_B, cs.KINDS_S,
                                               1, seed=7)[0])
        else:
            kw = dict(must=cs.QWEN_FUSED)
        if not (args.tponly_only and arch == "xlstm-125m"):
            cs.kinds_parts(launches, arch, cfg, params, **kw)
        if arch == "xlstm-125m":
            cs.xlstm_tponly_part(launches, cfg, params)
        del params, kw
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{arch} {time.perf_counter() - t0:.1f} s", flush=True)
    cs.log("kinds", walls=cs.json.dumps({k: round(v, 1) for k, v in
                                         cs.KINDS_WALLS.items()}),
           seconds=f"{sum(cs.KINDS_WALLS.values()):.1f}")
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
