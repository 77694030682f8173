"""Time the f32 matmul's two tensor-core routes against each other on a GPU.

The 3xTF32 product (`src/repro_torch/kernels/csrc/tf32x3_gemm.cuh`) either
splits b in a pass of its own into a workspace and then runs
`tf32x3::gemm_kernel`, or splits b's tiles inside the product
(`tf32x3::fused_kernel`), by `FUSED_MAX_M`. This script builds `matmul.cu`
three times, with that threshold as it stands ("stock"), with every M
fused ("fused") and with every M split first ("split"), and for each shape
prints one JSON line: each variant's plan (`matmul_f32_plan`), its device
time per call (a CUDA graph of 10 calls, each after a 256 MB write that
flushes the L2, less a graph of the writes alone), twice, in the order
fused, split, split, fused, and whether the variants' outputs have the same
bits. It also prints the registers and spills ptxas reports for the
product kernels. Run from the repository root on a machine with a GPU and
nvcc:

    python3 tools/f32_matmul_routes.py [--out f32_routes.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402

THRESHOLD = "constexpr int FUSED_MAX_M = 2 * BM;"
VARIANTS = {"stock": THRESHOLD,
            "fused": "constexpr int FUSED_MAX_M = 1 << 30;",
            "split": "constexpr int FUSED_MAX_M = 0;"}
SHAPES = [(4096, 4096, 4096), (2000, 512, 3000), (1000, 136, 200),
          (256, 256, 256), (300, 4096, 1000),
          *[(m, 4096, 4096) for m in (128, 256, 384, 512, 640, 768, 1024,
                                      2048)]]


def build_variants(work: Path) -> tuple[dict, str]:
    """{variant: loaded library}, and the stock build's ptxas log."""
    procs = {}
    for name, line in VARIANTS.items():
        src = work / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(build.CSRC, src)
        header = src / "tf32x3_gemm.cuh"
        text = header.read_text()
        assert THRESHOLD in text, "FUSED_MAX_M is not where this script looks"
        header.write_text(text.replace(THRESHOLD, line))
        # -fno-gnu-unique: the three libraries share one process, and a
        # static of an inline function (the plan cache, the shared-memory
        # attribute's once flag) would otherwise be one object for all three
        cmd = [build.nvcc(), *build.FLAGS, "-Xcompiler", "-fno-gnu-unique",
               "-Xptxas", "-v", "-I", str(src), "-o", str(src / "matmul.so"),
               str(src / "matmul.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs, log = {}, ""
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc ({name}) failed:\n{out}")
        if name == "stock":
            log = out
        lib = ctypes.CDLL(str(work / name / "matmul.so"))
        for fn, (argtypes, restype) in build.SIGNATURES["matmul"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs, log


def registers(log: str) -> dict:
    """{kernel: 'N registers, S bytes spill stores, L bytes spill loads'}
    for the tf32x3 kernels in a ptxas -v log."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1)
            continue
        if current and "tf32x3" in current:
            name = current
            if shutil.which("c++filt"):
                name = subprocess.run(["c++filt", current],
                                      capture_output=True,
                                      text=True).stdout.strip() or current
            if "spill" in line:
                out.setdefault(name, []).append(line.split(":", 1)[-1]
                                                .strip())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out.setdefault(name, []).append(f"{m.group(1)} registers")
    return {k: "; ".join(v) for k, v in out.items()}


def device_ms(fn, flush: torch.Tensor, iters: int = 10) -> float:
    """Device time per call of `fn`, L2 flushed before each (graphs)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    times = []
    for with_fn in (False, True):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            for _ in range(iters):
                flush.zero_()
                if with_fn:
                    fn()
        graph.replay()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return (times[1] - times[0]) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(gpu.strip().splitlines()[0], flush=True)
    libs, log = build_variants(build.build_dir() / "f32_routes")
    regs = registers(log)
    print(json.dumps({"ptxas": regs}), flush=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for m, k, n in SHAPES:
        a = torch.randn(m, k, generator=g, device="cuda")
        b = torch.randn(k, n, generator=g, device="cuda")
        row = {"shape": f"{m}x{k}x{n}"}
        outs, calls = {}, {}
        for name, lib in libs.items():
            plan = (ctypes.c_int * 7)()
            assert lib.matmul_f32_plan(m, n, k, 0, 0, plan) == 0
            row[f"{name}_plan"] = list(plan)
            ws = torch.empty(max(int(lib.matmul_workspace_floats(m, n, k, 1)),
                                 1), device="cuda")
            out = torch.empty(m, n, device="cuda")

            def call(lib=lib, ws=ws, out=out):
                err = lib.matmul_f32(a.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), ws.data_ptr(), m, n, k,
                                     0, 0, 0,
                                     torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"matmul_f32: error {err}")
            call()
            torch.cuda.synchronize()
            outs[name], calls[name] = out, call
        row["same_bits"] = all(torch.equal(outs["stock"], o)
                               for o in outs.values())
        for name in ("fused", "split", "split", "fused"):
            row.setdefault(f"{name}_ms", []).append(
                device_ms(calls[name], flush))
        row["stock_ms"] = [device_ms(calls["stock"], flush)]
        print(json.dumps(row), flush=True)
        rows.append(row)
        del a, b, outs, calls
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"gpu": gpu.strip(),
                                              "ptxas": regs,
                                              "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
