"""Time the port's plain-route products (`models/layers.product`) on the
card at the shapes the model paths give them, three ways:

  bf16    one `mm` / `bmm` on bf16 operands, bf16 result (the port's)
  f32out  the same with an f32 result (`out_dtype=`), rounded to bf16
  f32     both operands upcast, an f32 `einsum`, rounded (before the
          plain route's repair)

and check that the bf16 result equals the rounded f32 result bit for bit
(cuBLAS added no partial sums in bf16 at that shape), with PyTorch's
`allow_bf16_reduced_precision_reduction` as it stands (printed).

    python3 tools/plain_products.py [--out results/plain_products.json]

Times: CUDA events, mean of 10 calls after one, ms.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

F32, BF16 = torch.float32, torch.bfloat16

# (label, einsum, a shape, b shape)
SHAPES = [
    ("mixtral prefill expert gate/up", "ecd,edf->ecf", (8, 2560, 4096),
     (8, 4096, 14336)),
    ("mixtral prefill expert down", "ecf,efd->ecd", (8, 2560, 14336),
     (8, 14336, 4096)),
    ("mixtral decode expert gate/up (T=8, C=2)", "ecd,edf->ecf",
     (8, 2, 4096), (8, 4096, 14336)),
    ("mixtral decode q", "bsd,dhk->bshk", (8, 1, 4096), (4096, 32, 128)),
    ("qwen3 pallas prefill q / o", "bsd,dhk->bshk", (1, 512, 5120),
     (5120, 40, 128)),
    ("qwen3 pallas prefill gate/up", "...d,df->...f", (1, 512, 5120),
     (5120, 17408)),
    ("qwen3 pallas prefill down", "...f,fd->...d", (1, 512, 17408),
     (17408, 5120)),
    ("whisper decoder scores (8 x 32 q, 1500 frames)", "bqkgd,bskd->bkgqs",
     (8, 32, 12, 1, 64), (8, 1500, 12, 64)),
    ("decode scores (mixtral, 4096 cache rows)", "bkgd,bskd->bkgs",
     (8, 8, 4, 128), (8, 4096, 8, 128)),
]


def ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def main() -> int:
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.models.layers import _tensor_core_product

    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    print(f"card='{card}' torch={torch.__version__} "
          f"allow_bf16_reduced_precision_reduction={flag}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, eq, sa, sb in SHAPES:
        a = torch.randn(sa, generator=g, device="cuda").to(BF16)
        b = (torch.randn(sb, generator=g, device="cuda")
             * sb[-2] ** -0.5).to(BF16)
        bf16 = _tensor_core_product(eq, a, b, BF16)
        rounded = _tensor_core_product(eq, a, b, F32).to(BF16)
        row = {"shape": label, "eq": eq, "a": sa, "b": sb,
               "bits_equal": bool(torch.equal(bf16, rounded)),
               "bf16_ms": ms(lambda: _tensor_core_product(eq, a, b, BF16)),
               "f32out_ms": ms(lambda: _tensor_core_product(
                   eq, a, b, F32).to(BF16)),
               "f32_ms": ms(lambda: torch.einsum(
                   eq, a.to(F32), b.to(F32)).to(BF16), 3)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "flag": flag, "rows": rows}, indent=1))
    return 0 if all(r["bits_equal"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
