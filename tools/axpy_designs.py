"""Time the two designs of Table 1's axpy, and variants of design A,
against each other on a GPU.

Design A is the port's kernel (`src/repro_torch/kernels/csrc/axpy.cu` on
`csrc/stream.cuh`: register streaming, 4 16-byte vectors of x and of y in
flight a thread, plain loads and stores, a block a tile of 256 * 4
vectors), built as it is ("A"). `tools/axpy_designs.cu` holds the rest:
design A with cache hints and one persistent wave (`axpy_hinted`; "A_spec"
is A as first drawn, the wave with all three hints: loads that skip L1
and go first from L2, streaming stores; "A_persistent", "A_h1", "A_h2",
"A_h4" one change each), and design B (`axpy_bulk`: 1-D `cp.async.bulk`
copies through an mbarrier ring in shared memory, the output stored by
bulk copies too, on persistent blocks; "B" with loads marked evict-first
in L2, "B_nohint" without). For each shape it prints one JSON line: each
variant's blocks and its device time per call (a CUDA graph of 10 calls,
each after a 256 MB write that flushes the L2, less a graph of the writes
alone; at the smaller sizes also warm, 200 calls replayed), each variant
twice (forward, then backward through the list), beside `torch.add(y, x,
alpha=)` (before and after), and whether the variants' outputs have the
same bits; then a line of the means. It also prints ptxas's registers and
spills. Run from the repository root on a machine with a GPU and nvcc:

    python3 tools/axpy_designs.py [--out axpy_designs.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402

# (source, exported prefix, -D flags) of each variant
DESIGNS = ROOT / "tools" / "axpy_designs.cu"
VARIANTS = {
    "A": (build.CSRC / "axpy.cu", "axpy", []),
    "A_spec": (DESIGNS, "axpy_hinted", ["-DA_HINTS=7", "-DA_PERSISTENT=1"]),
    "A_persistent": (DESIGNS, "axpy_hinted",
                     ["-DA_HINTS=0", "-DA_PERSISTENT=1"]),
    "A_h1": (DESIGNS, "axpy_hinted", ["-DA_HINTS=1", "-DA_PERSISTENT=0"]),
    "A_h2": (DESIGNS, "axpy_hinted", ["-DA_HINTS=2", "-DA_PERSISTENT=0"]),
    "A_h4": (DESIGNS, "axpy_hinted", ["-DA_HINTS=4", "-DA_PERSISTENT=0"]),
    "B": (DESIGNS, "axpy_bulk", ["-DBULK_HINT=1"]),
    "B_nohint": (DESIGNS, "axpy_bulk", ["-DBULK_HINT=0"]),
}
F32, BF16 = torch.float32, torch.bfloat16
SHAPES = [("card", 1 << 28, F32), ("card", 1 << 28, BF16),
          ("paper", 768 * 128, F32), ("ragged", 1001 * 77, F32)]


def nvcc(src: Path, out: Path, flags: list) -> subprocess.Popen:
    # -fno-gnu-unique: several builds of one source share this process
    cmd = [build.nvcc(), *build.FLAGS, "-Xcompiler", "-fno-gnu-unique",
           *flags, "-Xptxas", "-v", "-I", str(build.CSRC), "-o", str(out),
           str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_variants(work: Path) -> tuple[dict, dict]:
    """{variant: (launcher f32, launcher bf16, grid)}, {variant: ptxas
    log}."""
    procs = {}
    for name, (src, _, flags) in VARIANTS.items():
        (work / name).mkdir(parents=True, exist_ok=True)
        procs[name] = nvcc(src, work / name / "axpy.so", flags)
    fns, logs = {}, {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc ({name}) failed:\n{out}")
        logs[name] = out
        lib = ctypes.CDLL(str(work / name / "axpy.so"))
        prefix = VARIANTS[name][1]
        fns[name] = ()
        for suffix in ("f32", "bf16", "grid"):
            fn = getattr(lib, f"{prefix}_{suffix}")
            fn.argtypes, fn.restype = build.SIGNATURES["axpy"][
                f"axpy_{suffix}"]
            fns[name] += (fn,)
    return fns, logs


def registers(logs: dict) -> dict:
    """{variant: 'N registers; spills'} from ptxas -v logs."""
    out = {}
    for key, log in logs.items():
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        out[key] = f"registers {regs}, spill stores {spills}"
    return out


def device_ms(fn, flush, iters: int = 10) -> float:
    """Device time per call of `fn` replayed in a CUDA graph: with `flush`,
    each call after a write of it (the L2 flushed), less a graph of the
    writes alone; without, `iters` calls back to back (warm)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    times = []
    for with_fn in ((False, True) if flush is not None else (True,)):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            for _ in range(iters):
                if flush is not None:
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
        del graph
    return (times[-1] - (times[0] if flush is not None else 0.0)) / iters


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
    libs, logs = build_variants(build.build_dir() / "axpy_designs")
    regs = registers(logs)
    print(json.dumps({"ptxas": regs}), flush=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.cuda.current_device()
    rows = []
    for size, n, dt in SHAPES:
        x = torch.randn(n, generator=g, device="cuda").to(dt)
        y = torch.randn(n, generator=g, device="cuda").to(dt)
        bf = int(dt == BF16)
        row = {"size": size, "n": n, "dtype": str(dt).replace("torch.", "")}
        outs, calls = {}, {"torch": lambda: torch.add(y, x, alpha=2.0)}
        for name, (f32, bf16, grid) in libs.items():
            launch = bf16 if bf else f32
            row[f"{name}_blocks"] = grid(n, bf, dev)
            out = torch.empty_like(x)

            def call(launch=launch, out=out):
                err = launch(None, 2.0, x.data_ptr(), y.data_ptr(),
                             out.data_ptr(), n, dev, build.stream(dev))
                if err:
                    raise RuntimeError(f"axpy: error {err}")
            call()
            torch.cuda.synchronize()
            outs[name], calls[name] = out, call
        row["same_bits"] = all(torch.equal(outs["A"], o)
                               for o in outs.values())
        row["matches_torch_add"] = torch.equal(
            outs["A"], torch.add(y, x, alpha=2.0))
        # every variant twice, forward then backward, the library call
        # before and after
        order = ["torch", *VARIANTS, *list(VARIANTS)[::-1], "torch"]
        for timing, fl, iters in (("flushed", flush, 10),
                                  *((("warm", None, 200),)
                                    if size != "card" else ())):
            for name in order:
                row.setdefault(f"{name}_{timing}_ms", []).append(
                    device_ms(calls[name], fl, iters))
        print(json.dumps(row), flush=True)
        print(json.dumps({"size": size, "dtype": row["dtype"], "mean_ms": {
            k[:-3]: round(sum(v) / len(v), 5) for k, v in row.items()
            if k.endswith("_ms")}}), flush=True)
        rows.append(row)
        del x, y, outs, calls
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"gpu": gpu.strip(),
                                              "ptxas": regs,
                                              "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
