"""Drive the PyTorch port on one NVIDIA GPU: build the CUDA kernels, hold
each against its plain PyTorch version, run the paper's Table 1 kernel
suite and the fused ops' compositions through `repro_torch.kernels.ops`,
race each kernel's plan knobs through the tuning layer (`tuned_call`, a
TuneDB, a second process warm-starting from it),
run whisper-small's prefill and decode, then qwen3-14b at full width:
its one-shot prefill on the fused and on the "pallas" route (eager and as
CUDA graphs), serving through the port's paged ServeSession, and the
fixed batch's execution engine (`ServeProgram`, K-step CUDA graphs) and
the robustness and durability layer on its graphed paged session
(scripted faults, preemption, the journal, snapshots, crash and restore);
then mixtral-8x7b at full width (8 of its 32 layers): its MoE prefill on
the banded schedule and its decode on rolling caches; then the three
mixed-kind archs: recurrentgemma-9b at full width and depth, xlstm-125m
whole, and llama-3.2-vision-90b at full width (10 of its 100 layers);
then trains qwen3-14b at full width (4 of its 40 layers) through
`TrainProgram` under "fused", and a reduced qwen3 through
`TrainProgram.run()` with checkpoint, preemption and resume.

    python3 chip_smoke.py

Phases (each prints one line; a failed phase raises, exit code != 0):

  device   the card's name and power limit (nvidia-smi)
  build    nvcc of every source in src/repro_torch/kernels/csrc (parallel)
  kernels  each kernel of the model paths vs its plain version at those
           paths' shapes (qwen3-14b's train microbatch among them: M 1024,
           B 2), in bf16 (rmsnorm also in f32): max abs error
           against the stated tolerance, kernel, plain and library times
           (CUDA events, L2 flushed before each launch; for rmsnorm and
           the decode kernel's rows also the kernel's and the library's
           device time replayed as a CUDA graph), and the card's
           least time for the same work (the bound); each GEMM row names
           its schedule: at M <= 16 the decode kernel (N tile, cluster,
           CTAs) or split-K, above it the wmma tile or the Hopper
           mainloop, persistent or one tile per block, with its N tile
           and tiles; and the decode or mainloop instantiation a profiler
           trace of one call shows (the decode kernel: one launch, no
           split-K kernel)
  suite    matmul, axpy, dotp, conv2d_3x3 and dct8x8 through
           repro_torch.kernels.ops under the default policy, in f32 (and
           bf16 for matmul and axpy; matmul rows name their schedule and
           the kernels a trace of one call shows: f32 with K, N % 4 == 0
           the 3xTF32 product, after the split pass at M > 256; other f32
           the CUDA-core tile), at the paper's sizes, at card sizes (>= 10x
           the L2) and at one ragged shape each (f32 matmul: one on each
           route): every output vs the plain version (f32 matmul also vs an f64
           product: at most twice the plain version's error), kernel,
           plain and library times (warm, 200 launches, at the paper's
           sizes, also replayed as a CUDA graph; L2 flushed at the others,
           and at card sizes also replayed as a CUDA graph, flushed), the
           bound (bytes, or operations at the f32, TF32 or bf16 peak; the
           3xTF32 route counts its three products, with the f32 CUDA-core
           bound beside it), the launches (axpy and dotp rows: their
           blocks); TF32 off for the plain versions and the library calls;
           then a host line at the paper's size for axpy (a number alpha,
           a tensor alpha) and dotp: the mean host wall a call over 1,000
           calls through ops, through the wrapper and of the library call,
           the wrapper split into checks, allocation, stream lookup and
           the C call with its launch, and the one device kernel a trace
           of one call shows; and a host profile (torch.profiler) of the
           wrapper and the library call, split into operators, CUDA
           runtime calls and the rest
  tune     the tuning layer: a kernel-only Cluster(None, tune_db=<a
           temporary directory>/tunes.json) under KernelPolicy(mode=
           "fused", tuning="timed"); every (kernel, shape) cell of
           qwen3-14b's fused path (rmsnorm_matmul M512 / M8 K5120,
           matmul_residual_add M512 / M8, flash_attention_proj S512),
           whisper-small's matmul_bias_act (M12000, K3072 N768 and K768
           N3072), f32 matmul 4096^3 on the 3xTF32 route and the Table 1
           suite at the reference bench's tune sizes go through
           ops.tuned_call: each miss races the top 3 modeled plans of the
           kernel's own knobs (tile_n; boxes, cluster), the kernel's own
           plan and, for a fused op, its composition (3 reps, CUDA
           events, each behind a ~1 ms spin, L2 flushed). One [tune] line a cell: lanes, the picked
           knobs and the kernel's own, modeled / raced us, the route, the
           winner and the default re-timed (flushed, each launch behind
           a ~1 ms spin; the least of 3 means of 10, in turn), held to
           tuned <= default x 1.15
           (benchmarks/check_gate.py's tuned check); every tuned output
           against its plain version; on the
           mainloop a pinned tile_n in the traced kernel's name and in
           wgmma_plan, the Python model's tile_n equal to wgmma_plan's; a
           pin the kernel cannot take raises. Then a fresh process
           importing only repro_torch warm-starts every cell from the DB:
           all hits, no race
  compose  each fused op's composition (`ops.OPS[name].composition`,
           its unfused lane) vs the fused kernel at a model path's shape
           under the default policy: it must launch its primitive kernels
           (rmsnorm, matmul, flash_attention) and no fused one; both timed
  agree    reduced models through the kernels on the card vs the plain
           versions on the CPU: qwen3 (2 layers, 4 heads of 128) under
           "fused" and under "tuned" with attn_schedule="pallas",
           whisper-small (2 + 2 layers at full width) under "fused", the
           MoE smoke configs under "fused" in both dispatch modes
           (grok-1-314b-smoke with heads of 128, mixtral-8x7b-smoke), and
           the mixed-kind smoke configs under "fused", their attention
           weights at the true fan-in: recurrentgemma-9b-smoke,
           xlstm-125m-smoke (no kernel on its path) and
           llama-3.2-vision-90b-smoke (heads of 128, cross gates open,
           8 image embeddings)
  whisper  whisper-small at full width (12 + 12 layers), random weights,
           under "fused": make_prefill_step on 8 x 32 tokens and 8 x 1500
           stub frames, run eagerly (its encoder MLPs launch
           matmul_bias_act 24 times) and under torch.profiler (its
           mainloop instantiations and five device kernels with the most
           time); then as a CUDA graph (a `mode=cuda_graph` line: the
           replay's token equal to the eager one, one traced replay's
           launches equal to the eager counts, the replay's wall by CUDA
           events and by the host clock, mean of 10, beside its traced
           device time and the eager wall); then ServeProgram(batch=8,
           max_seq=448, max_new=16) with the prefill's tokens as a
           one-token prompt at chunk 16 and chunk 1 (equal tokens, finite
           caches; ms a step of each, one chunk's traced device time)
  prefill  qwen3-14b, all 40 layers, random weights from a seeded
           generator on the card, make_prefill_step on B=1, S=512, run
           eagerly; then the same prefill under torch.profiler, whose five
           device kernels with the most time it prints; then as a CUDA
           graph (a `mode=cuda_graph` line, as whisper's)
  pallas_prefill  the same prefill under the default "tuned" policy with
           attn_schedule="pallas": flash_attention 40 times, projections
           as torch products; counted, traced (its five device kernels
           with the most time), its token set beside the fused prefill's;
           then as a CUDA graph (flash_attention 40 times a replay)
  serve    Cluster("qwen3-14b") ServeSessionProgram(slots=8, max_seq=256,
           max_prompt=64, chunk=16, paged=True, page_size=16) under the
           "fused" policy: 12 requests, half sharing a 32-token preamble,
           the session step replayed as a CUDA graph, under
           torch.profiler; then the same requests without the profiler,
           replayed (timed) and run eagerly (the tokens must agree)
  profile  torch.profiler over decode steps of that model (8 slots, paged),
           run eagerly and replayed as a CUDA graph: wall time per step,
           the device's busy and idle shares in each, time by kernel; the
           traced launches a step must equal one eager step's wrapper
           counts, with no split-K kernel
  engine   Cluster("qwen3-14b").compile(ServeProgram(batch=8, max_seq=256,
           max_new=64)) under "fused" with an 8 x 32 prompt, at chunk 16
           (one CUDA graph of 16 steps a chunk) and chunk 1 (a step's
           graph a token), each run twice (the second compile hits the
           cache, its run captures nothing): equal tokens, 4 and 64 host
           syncs, equal EOS results; tokens_per_s_per_slot, p50_ms,
           stall_pct, dispatch_gap_s and device_wait_s of each; one steady
           chunk traced: 16 x one eager step's launches of each kernel,
           its device busy time against its wall
  chaos    the robustness and durability layer on qwen3-14b's paged
           session (8 slots, max_seq 256, chunk 16, the step replayed as
           a CUDA graph, "fused"; the serve phase's 12 requests, classes
           cycled latency / throughput / throughput / best_effort):
           part=faults, a fault-free run, then one under a FaultPlan with
           page_alloc_fail at the first boundary, refill_error at the
           first later one that admits (its round undone, admitted
           again), kill_slot and corrupt_nan on running slots that share
           no page, bit_flip on a published page only the prefix cache
           holds and a wedge (the watchdog, recover_wedged, a new
           capture): tokens of every request equal, each fault fired once
           and seen by its own path; the NaN scan's device time (CUDA
           events) against a traced chunk's (limit 1%), the page
           checksums' costs; part=preempt, a private-cache session where a
           latency request preempts a bulk one: snapshot and restore bit
           for bit, tokens equal a run without preemption, their ms a call
           in the run against 2 x slot bytes at HBM rate (limit 25%,
           reported); part=durable, runs without durability and with the
           journal alone, alternated three times, then a snapshot every 4
           chunks: tokens equal, end-to-end tokens/s (the journal's median
           within 5% of the median without), commit and snapshot costs;
           part=scrub, the serve phase's session with the default scrub
           and none, end to end;
           part=crash, SessionCrashed at chunk 4 then program.restore,
           with snapshots and journal only: exactly-once, the counters the
           journal and the snapshot call for, the time to restore;
           part=drill, examples/serve_chaos_torch.py --crash (its child
           SIGKILLed, its parent exit 0)
  moe      mixtral-8x7b at full width (d_model 4096, 32 / 8 heads of 128,
           8 experts top-2, d_ff 14336, window 4096), 8 of its 32 layers
           (~23.7 GB; qwen3's weights are freed first), under "fused":
           make_prefill_step on B=1, S=8192 (the banded schedule, chunk
           1024, 5 bands; rmsnorm_matmul 3 times a layer,
           matmul_residual_add once, no plain version on the card; the
           experts are plain bf16 products), eager, traced and as a CUDA
           graph, beside its least time; then ServeProgram(batch=8,
           max_seq=8192, max_new=64) from an 8 x 32 prompt on rolling
           4096-row caches at chunk 16 and chunk 1: equal tokens, finite
           caches, tokens_per_s_per_slot, p50_ms, stall_pct, the step's
           least time, one steady chunk's traced device busy time
  hybrid   recurrentgemma-9b, all 38 layers (26 rglru, 12 local_attn;
           heads of 256 over one KV head, window 2048, lru_width 4096,
           geglu d_ff 12288, vocab 256000; ~20.9 GB; mixtral's weights
           are freed first), under "fused": make_prefill_step on B=1,
           S=8192 (banded, chunk 1024; rmsnorm_matmul 3 times a local_attn
           layer and twice a layer, matmul_residual_add once a local_attn
           layer and once a layer, no plain version on the card), eager,
           traced and as a CUDA graph, beside its least time
           (`prefill_bound`); ServeProgram(batch=8, max_seq=8192,
           max_new=64) from an 8 x 32 prompt at chunk 16 and chunk 1
           (rolling 2048-row local caches, the recurrent state written in
           place), as the moe phase's decode (`serve_program_check`,
           beside `decode_bound`); then a non-paged
           ServeSessionProgram(slots=8) over the serve phase's 12
           requests, replayed and eager, tokens equal
  xlstm    xlstm-125m, all 12 layers (9 mlstm, 3 slstm; ~0.24 GB): its
           prefill on B=8, S=512 (no kernel on its path, in the reference
           as in the port) eager, traced and as a CUDA graph; then
           ServeProgram(batch=8, max_seq=512, max_new=64) at chunk 16 and
           chunk 1
  vlm      llama-3.2-vision-90b at full width (d_model 8192, 64 / 8 heads
           of 128, d_ff 28672), 10 of its 100 layers (8 attn, 2 cross;
           ~21.3 GB), cross gates open: the prefill on B=1, S=512 with
           1,601 image embeddings (flash_attention_proj, rmsnorm_matmul 5
           times and matmul_residual_add once an attn layer; the cross
           layers plain), eager, traced and as a CUDA graph; then
           ServeProgram(batch=8, max_seq=256, max_new=64) at chunk 16 and
           chunk 1 (the cross K/V: the zero cache, as in the reference)
  train    qwen3-14b at full width, 4 of its 40 layers (2.88B parameters;
           bf16 weights, f32 moments and gradient accumulator, peak
           ~48 GB; the vision model's weights are freed first), under
           "fused", batch 8 x 512, grad_accum 4, remat "nothing":
           part=step, 4 steps through CompiledTrain.step (counted: rows
           1-3 launch 7 times a layer a microbatch, twice under
           recomputation; no plain version on the card), then the state
           made again and the same batches through .chunk (losses equal
           bit for bit); the step's median wall and tokens/s, its halves
           (forward + backward, AdamW) and a forward alone by CUDA
           events, the peak memory, the model FLOPs' bound at the bf16
           peak and the optimizer's byte bound, one step traced (launches
           equal to the count, the device's idle share, the kernels with
           the most time); part=grads, one microbatch's gradients through
           the kernel route and the "reference" route: every leaf finite
           and non-zero, within 2e-2 relative L2; part=run, a reduced
           qwen3 (2 layers, d_model 1024, 8 / 2 heads of 128, vocab 8192)
           through TrainProgram.run() with the double-buffered feed and
           checkpoints, a second run preempted by SIGTERM after step 6 and
           a third resumed from it: its losses equal the uninterrupted
           run's, and the loss falls; then api.train on qwen3-14b-smoke

The kernel launch counts are set to 0 before each of the suite, tune,
compose, whisper, prefill, pallas_prefill, serve, profile, engine, chaos,
moe, hybrid, xlstm, vlm and train runs and read right after; every kernel of a
phase must have launched and no plain version may have run on a CUDA
tensor. A wrapper counts the launches it makes;
the launches a replayed CUDA graph makes are counted from the profiler's
trace (`launches.traced_launches`). Every trace but the serve phase's
holds its work between two sentinel kernels (`torch.cuda._sleep`), after
64 primer kernels (a trace's first kernel records can go missing) and
0.1 s of host time: a trace that lost either sentinel is logged and taken
again with 1 s, then 4 s of host time, and the done line lists it. The
last two lines are the kernels' JSON record and {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.core import mesh as hw  # noqa: E402  (H100 data sheet)

HBM_BYTES_PER_S = hw.HBM_BW
QWEN_FUSED = ("rmsnorm_matmul", "matmul_residual_add",
              "flash_attention_proj")       # the fused route of qwen3-14b
BF16_FLOPS_PER_S = hw.PEAK_FLOPS_BF16     # dense bf16 tensor-core peak
TF32_FLOPS_PER_S = hw.PEAK_FLOPS_TF32     # dense TF32 tensor-core peak
F32_FLOPS_PER_S = hw.PEAK_FLOPS_F32       # f32 on the CUDA cores
TOL = dict(rtol=2e-2, atol=2e-2)   # bf16: one output rounding + sum order
F32_TOL = dict(rtol=1e-5, atol=1e-5)   # f32 elementwise: sum order only


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def bound(bytes_moved: float, flops: float,
          flops_per_s: float = BF16_FLOPS_PER_S) -> tuple[float, str]:
    """The card's least time in ms for the work, and what sets it: the
    bytes over HBM's rate or the operations over the peak of their type."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Mean device time of `fn` over `iters` launches, with the 50 MB L2
    flushed before each launch (the decode path streams its weights from
    device memory, so a warm L2 would flatter small weights). Given
    `spin_cycles`, a spin kernel of that many cycles runs before each
    flush, so that a pause of the host's (its cores are shared) before the
    launch is queued does not reach the timed span."""

    def __init__(self, spin_cycles: int = 0):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        self.spin_cycles = spin_cycles

    def __call__(self, fn, iters: int = 10) -> float:
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            if self.spin_cycles:
                torch.cuda._sleep(self.spin_cycles)
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            total += s.elapsed_time(e)
        return total / iters


def warm_ms(fn, iters: int = 200) -> float:
    """Mean device time of `fn` over `iters` back-to-back launches between
    one pair of events, its data left in L2 (a kernel of a few us is
    resolved only so; MemPool's own kernels run from L1)."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def graph_ms(fn, iters: int = 200, flush=None) -> float:
    """Device time per launch of `fn`: `iters` launches captured once as a
    CUDA graph and replayed between one pair of events, so the host's
    dispatch between them is not counted (warm, as `warm_ms`). Given a
    `flush` buffer, each launch follows a zeroing of it (the L2 flushed, as
    `Timer` does), and a graph of the flushes alone is subtracted."""
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
        del graph
        times.append(s.elapsed_time(e))
    return (times[-1] - (times[0] if flush is not None else 0.0)) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, launches

    t_start = time.perf_counter()
    card = gpu_line()
    log("device", gpu=f"'{card}'", torch=torch.__version__,
        cuda=torch.version.cuda, kind=f"'{torch.cuda.get_device_name(0)}'")

    libs = build.build(verbose=True)
    log("build", seconds=f"{build.build_seconds:.1f}",
        libs=",".join(p.name for p in libs.values()))
    for name in build.SOURCES:
        build.library(name)

    records = kernel_phase()
    suite_records = suite_phase(launches)
    tune_results = tune_phase(launches)
    compose_counts = compose_phase(launches)
    agree_phase()
    whisper_counts = whisper_phase(launches)
    cfg, params, prefill_counts, token = prefill_phase(launches)
    pallas_counts = pallas_prefill_phase(launches, cfg, params, token)
    serve_counts, serve_traced = serve_phase(launches, cfg, params)
    profile_phase(launches, cfg, params)
    engine_traced = engine_phase(launches, cfg, params)
    chaos_counts = chaos_phase(launches, params)
    del params                        # qwen3-14b's 29.5 GB: mixtral is next
    gc.collect()                      # reference cycles may still hold them
    torch.cuda.empty_cache()
    moe_counts, _ = moe_phase(launches)
    hybrid_counts = hybrid_phase(launches)
    xlstm_phase(launches)
    vlm_counts = vlm_phase(launches)
    train_counts = train_phase(launches)
    for rec in records:
        # launches: a kernel's runs on the device in the path that takes
        # it. The qwen3 fused kernels: the prefill's (equal to its wrapper
        # count), the traced serve run's and the engine's traced chunk's,
        # graph replays included, and the eager prefills of mixtral,
        # recurrentgemma-9b and llama-3.2-vision (none for
        # flash_attention_proj from the first two: the window keeps it off
        # their paths); wrapper_launches: the wrappers' own
        # counts over the prefill and serve runs. flash_attention: the
        # "pallas" prefill's; matmul_bias_act: the whisper prefill's;
        # rmsnorm: rmsnorm_matmul's composition's. A suite kernel's record
        # already holds the suite phase's counts. train_launches: the
        # qwen3 fused kernels' launches in one full-width train step
        # (counted and traced).
        name = rec["name"]
        if name in QWEN_FUSED:
            rec["launches"] = (prefill_counts[name] + serve_traced[name]
                               + engine_traced[name] + moe_counts[name]
                               + hybrid_counts[name] + vlm_counts[name]
                               + train_counts[name])
            rec["train_launches"] = train_counts[name]
            rec["wrapper_launches"] = prefill_counts[name] + \
                serve_counts[name] + chaos_counts[name]
        else:
            rec["launches"] = {"flash_attention": pallas_counts,
                               "matmul_bias_act": whisper_counts,
                               "rmsnorm": compose_counts}[name][name]
    records += suite_records
    for rec in records:           # each kernel's cells of the tune phase
        rec["tune"] = tune_results.get(rec["name"], [])
    log("done", seconds=f"{time.perf_counter() - t_start:.1f}",
        traces_taken_again=json.dumps(LOST_TRACES).replace(" ", ""))
    print(gpu_line())
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ----------------------------------------------------------------------------
# kernels vs plain versions
# ----------------------------------------------------------------------------

SRC = "src/repro_torch/kernels/csrc"
REPLACES = {
    "rmsnorm_matmul": "src/repro/kernels/fused.py:61",
    "matmul_residual_add": "src/repro/kernels/fused.py:196",
    "flash_attention_proj": "src/repro/kernels/fused.py:265",
    "flash_attention": "src/repro/kernels/flash_attention.py:31",
    "rmsnorm": "src/repro/kernels/rmsnorm.py:18",
    "matmul_bias_act": "src/repro/kernels/fused.py:131",
}


def gemm_schedule(name: str, m: int, k: int, n: int) -> str:
    """How GEMM wrapper `name` runs an (M, K, N) product, by the rule of
    `decode::takes` and `hopper::takes_prefill`: at M <= 16 "decode" (K
    and N multiples of 8, K <= 32768: csrc/decode_gemm.cuh, with its N tile, cluster
    size, CTAs, k rows a CTA and ring stages from `<name>_decode_plan`) or
    "split_k"; above, "wmma_tile" (K or N not a multiple of 8), or on the
    Hopper mainloop "persistent" (more tiles than SMs: one block an SM
    walks several) or "one_tile_per_block", with its N tile, tiles and
    blocks (`wgmma_plan` of csrc/wgmma_gemm.cuh). flash_attention_proj's
    projection always takes the mainloop."""
    from repro_torch.kernels import build

    if name != "flash_attention_proj":
        if m <= 16:
            if k % 8 or n % 8 or k > 32768:
                return "split_k"
            dp = (ctypes.c_int * 5)()
            build.check(name, build.entry(name, f"{name}_decode_plan")(
                m, n, k, 0, 0, dp))
            bn, cluster, ctas, k_cta, stages = dp
            return (f"decode,bn={bn},cluster={cluster},ctas={ctas},"
                    f"k_per_cta={k_cta},stages={stages}")
        if k % 8 or n % 8:
            return "wmma_tile"
    plan = (ctypes.c_int * 3)()
    build.check(name, build.entry(name, "wgmma_plan")(m, n, 0, plan))
    bn, tiles, blocks = plan
    kind = "persistent" if tiles > blocks else "one_tile_per_block"
    return f"{kind},bn={bn},tiles={tiles},blocks={blocks}"


def on_mainloop(schedule: str) -> bool:
    """Whether a `gemm_schedule` runs on the Hopper mainloop."""
    return schedule.startswith(("persistent", "one_tile_per_block"))


MAINLOOP_KERNEL = r"tma_wgmma_kernel<[^>]*>"
DECODE_KERNEL = r"tma_gemv_kernel<[^>]*>"


def f32_schedule(m: int, k: int, n: int) -> str:
    """How the f32 matmul runs an (M, K, N) product (`matmul_f32_plan`): on
    the tensor cores (K, N % 4 == 0) "tf32x3,split_pass" (the split pass,
    then the product) or "tf32x3,fused" (the product splits b itself, M <=
    256), with the N tile, cluster size, tiles, blocks, k a block walks and
    ring stages; or "cuda_core_tile" (its 128 x 128 tiles)."""
    from repro_torch.kernels import build

    p = (ctypes.c_int * 7)()
    build.check("matmul", build.entry("matmul", "matmul_f32_plan")(
        m, n, k, 0, 0, p))
    route, bn, cluster, tiles, blocks, k_cta, stages = p
    if route == 0:
        return f"cuda_core_tile,tiles={tiles}"
    return (f"tf32x3,{'split_pass' if route == 1 else 'fused'},bn={bn},"
            f"cluster={cluster},tiles={tiles},blocks={blocks},"
            f"k_per_cta={k_cta},stages={stages}")


# the kernels of each f32 matmul route, as traces name them
F32_KERNELS = {"split_pass": (r"tf32x3::split_kernel",
                              r"tf32x3::gemm_kernel<[^>]*>"),
               "fused": (r"tf32x3::fused_kernel<[^>]*>",),
               "cuda_core_tile": (r"matmul_f32_kernel",)}


SENTINEL = "spin_kernel"          # torch.cuda._sleep's kernel
PADS_S = (0.1, 1.0, 4.0)          # host time kept from a trace's ends, by try
LOST_TRACES: list[str] = []       # traces taken again: "what:sentinels seen"


def device_events(prof) -> list:
    """The device kernels of a torch.profiler trace, sentinels and primers
    left out."""
    return [e for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", ""))
            and SENTINEL not in e.key and PRIMER not in e.key]


def device_busy_ms(prof) -> float:
    """The time at least one device kernel ran in a torch.profiler trace,
    sentinels and primers left out: the union of their spans. Kernels
    launched with programmatic dependent launch (the decode kernel) start
    while the kernel before them runs and wait for it, so their spans
    overlap, and the sum of kernel times overstates the busy time."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if "CUDA" in str(getattr(e, "device_type", ""))
                   and SENTINEL not in e.name and PRIMER not in e.name)
    busy, end = 0.0, None
    for start, stop in spans:
        if end is None or start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy / 1e3


def sentinels(prof) -> int:
    """How many sentinel kernels a torch.profiler trace holds."""
    return sum(e.count for e in prof.key_averages()
               if "CUDA" in str(getattr(e, "device_type", ""))
               and SENTINEL in e.key)


PRIMERS = 64                      # primer kernels ahead of a trace's work
PRIMER = "FillFunctor<double>"    # theirs: a float64 fill, which nothing
                                  # else of the port launches


def open_record(pad_s: float) -> None:
    """Just after a profiler starts: wait `pad_s` on the host, run PRIMERS
    primer kernels, then launch the opening sentinel kernel. On the H100 a
    trace's first kernel records can go missing (one of them in a prefill's
    trace of ~3,000 records, up to 13 in a decode trace of ~15,000), so
    primers, which nothing counts, go first; the pads keep the work clear
    of the trace's ends."""
    time.sleep(pad_s)
    for _ in range(PRIMERS):
        torch.zeros(1, dtype=torch.float64, device="cuda")
    torch.cuda.synchronize()
    torch.cuda._sleep(1000)


def close_record(pad_s: float) -> None:
    """Just before a profiler stops: the closing sentinel, then `pad_s`."""
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(pad_s)


def traced(what: str, fn):
    """Run `fn` under torch.profiler between two sentinel kernels and
    return the profile. A trace that lost device records shows itself by a
    sentinel gone missing: it is logged (and noted in LOST_TRACES) and
    taken again with a longer pad, once for each of PADS_S; no whole trace
    in that many raises. `fn` runs once a trace."""
    from torch.profiler import ProfilerActivity, profile

    for pad_s in PADS_S:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            open_record(pad_s)
            fn()
            close_record(pad_s)
        seen = sentinels(prof)
        if seen == 2:
            return prof
        LOST_TRACES.append(f"{what}:{seen}")
        dev = sorted((e for e in prof.events()
                      if "CUDA" in str(getattr(e, "device_type", ""))),
                     key=lambda e: e.time_range.start)
        log("trace", what=what, pad_s=pad_s, sentinels=f"{seen}/2",
            device_events=len(dev), first=json.dumps(
                [(e.name[:40], round(e.time_range.start / 1e3, 3))
                 for e in dev[:3]]).replace(" ", ""),
            last=json.dumps(
                [(e.name[:40], round(e.time_range.start / 1e3, 3))
                 for e in dev[-2:]]).replace(" ", ""))
    raise AssertionError(f"{what}: {len(PADS_S)} traces each lost device "
                         f"records (sentinels seen in the last: {seen} of 2)")


def kernel_instance(fn, patterns=(MAINLOOP_KERNEL,), banned=()) -> str:
    """The kernels matching `patterns` (the mainloop's
    `hopper::tma_wgmma_kernel<BN,EPI,OWNER>`, the decode kernel's
    `decode::tma_gemv_kernel<NORM,EPI>`, or an f32 matmul route's
    `F32_KERNELS`) that one call of `fn` runs on the card, as a
    torch.profiler trace names them ("+" between); raises unless the trace
    shows each exactly once and no kernel matching `banned` (the decode
    kernel's split-K kernels, the other f32 routes' kernels)."""
    prof = traced("kernel_instance", fn)
    events = device_events(prof)
    names = []
    for pattern in patterns:
        hits = [(m.group(0).replace(" ", ""), e.count) for e in events
                for m in [re.search(pattern, e.key)] if m]
        if len(hits) != 1 or hits[0][1] != 1:
            raise AssertionError(f"expected one {pattern} launch in the "
                                 f"trace, saw {hits} among "
                                 f"{[e.key[:80] for e in events]}")
        names.append(hits[0][0])
    others = [e.key[:80] for e in events
              if any(re.search(b, e.key) for b in banned)]
    if others:
        raise AssertionError(f"{names}: the trace also shows {others}")
    return "+".join(names)


def _compare(name, got, want, tol=TOL):
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **tol)
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    return err


def kernel_phase() -> list[dict]:
    """Each kernel of the model paths against its plain version on the
    same inputs, at the shapes those paths give it, then timed with its
    plain version and one library call."""
    import torch.nn.functional as F

    from repro_torch.kernels import fused
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

    timer = Timer()
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(dtype)

    # name -> list of (label, err, tol, ms, plain, lib, bound, schedule,
    # graph times)
    cases = {}

    def case(name, label, kernel, plain, library, bnd, tol=TOL,
             schedule=None):
        err = _compare(f"{name} {label}", kernel(), plain(), tol)
        graphed = {}
        if schedule and on_mainloop(schedule):
            schedule += f",kernel={kernel_instance(kernel)}"
        elif schedule and schedule.startswith("decode"):
            schedule += ",kernel=" + kernel_instance(
                kernel, (DECODE_KERNEL,), ("skinny::",))
        if name == "rmsnorm" or (schedule or "").startswith("decode"):
            # a few us of device time: also without the host's dispatch
            graphed = {"graph_ms": graph_ms(kernel, 10, timer.flush),
                       "library_graph_ms": graph_ms(library, 10,
                                                    timer.flush)}
        cases.setdefault(name, []).append((
            label, err, tol, timer(kernel), timer(plain, 3), timer(library),
            bnd, schedule, graphed))

    K = 5120
    for m, n in ((8, 5120), (8, 1024), (8, 17408), (512, 5120),
                 (512, 7168), (512, 17408), (1, 5120), (16, 5120),
                 (1024, 5120), (1024, 1024), (1024, 17408)):
        x, s, w = randn(m, K), randn(K, scale=0.1), randn(K, n,
                                                           scale=K ** -0.5)
        case("rmsnorm_matmul", f"M{m}xK{K}xN{n}",
             lambda: fused.rmsnorm_matmul(x, s, w),
             lambda: fused.rmsnorm_matmul_plain(x, s, w),
             lambda: torch.matmul(x, w),
             bound((m * K + K + K * n + m * n) * 2, 2.0 * m * K * n),
             schedule=gemm_schedule("rmsnorm_matmul", m, K, n))
    # mixtral-8x7b's prefill projections (B=1, S=8192): q and k / v (q is
    # also recurrentgemma-9b's); recurrentgemma-9b (K 4096): k / v of one
    # head of 256 and the geglu gate / up (N 12288) at its prefill's M
    # 8192, and q, k / v, gate / up at its decode's M 8; llama-3.2-vision
    # (K 8192): q (N 8192), k / v (N 1024), gate / up (N 28672) at its
    # prefill's M 512 and its decode's M 8
    for m, K, n in ((8192, 4096, 4096), (8192, 4096, 1024),
                    (8192, 4096, 256), (8192, 4096, 12288),
                    (8, 4096, 4096), (8, 4096, 256), (8, 4096, 12288),
                    (512, 8192, 8192), (512, 8192, 1024),
                    (512, 8192, 28672), (8, 8192, 8192), (8, 8192, 1024),
                    (8, 8192, 28672)):
        x, s, w = randn(m, K), randn(K, scale=0.1), randn(K, n,
                                                           scale=K ** -0.5)
        case("rmsnorm_matmul", f"M{m}xK{K}xN{n}",
             lambda: fused.rmsnorm_matmul(x, s, w),
             lambda: fused.rmsnorm_matmul_plain(x, s, w),
             lambda: torch.matmul(x, w),
             bound((m * K + K + K * n + m * n) * 2, 2.0 * m * K * n),
             schedule=gemm_schedule("rmsnorm_matmul", m, K, n))
    # qwen3-14b's decode, prefill and train rows (a train microbatch is
    # 2 x 512 = 1,024 rows), mixtral's out-projection (also
    # recurrentgemma's), recurrentgemma's down projection (K 12288) and
    # its decode rows, llama-3.2-vision's out (K 8192) and down (K 28672)
    # at M 512 and M 8
    for m, k, n in ((8, 5120, 5120), (8, 17408, 5120), (512, 17408, 5120),
                    (1024, 17408, 5120), (8192, 4096, 4096), (8192, 12288, 4096),
                    (8, 4096, 4096), (8, 12288, 4096), (512, 8192, 8192),
                    (512, 28672, 8192), (8, 8192, 8192), (8, 28672, 8192)):
        a, w, r = randn(m, k), randn(k, n, scale=k ** -0.5), randn(m, n)
        case("matmul_residual_add", f"M{m}xK{k}xN{n}",
             lambda: fused.matmul_residual_add(a, w, r),
             lambda: fused.matmul_residual_add_plain(a, w, r),
             lambda: torch.addmm(r, a, w),
             bound((m * k + k * n + 2 * m * n) * 2, 2.0 * m * k * n),
             schedule=gemm_schedule("matmul_residual_add", m, k, n))
    # qwen3-14b's prefill, llama-3.2-vision-90b's (64 / 8 heads of 128,
    # d_model 8192) and qwen3-14b's train microbatch (B 2)
    for B, H, KV, S, HD, DM in ((1, 40, 8, 512, 128, 5120),
                                (1, 64, 8, 512, 128, 8192),
                                (2, 40, 8, 512, 128, 5120)):
        q, k, v = (randn(B, H, S, HD), randn(B, KV, S, HD),
                   randn(B, KV, S, HD))
        wo = randn(H, HD, DM, scale=(H * HD) ** -0.5)
        causal_pairs = S * (S + 1) // 2         # key positions this run needs
        kr, vr = (t.repeat_interleave(H // KV, dim=1) for t in (k, v))

        def library_fa():   # SDPA on the GQA-expanded k/v, then the product
            o = F.scaled_dot_product_attention(q, kr, vr, is_causal=True)
            return torch.einsum("bhsk,hkd->bsd", o, wo)

        case("flash_attention_proj", f"B{B}xH{H}xKV{KV}xS{S}xhd{HD}xdm{DM}",
             lambda: fused.flash_attention_proj(q, k, v, wo),
             lambda: fused.flash_attention_proj_plain(q, k, v, wo),
             library_fa,
             bound((q.numel() + k.numel() + v.numel() + wo.numel()
                    + B * S * DM) * 2,
                   4.0 * B * H * HD * causal_pairs
                   + 2.0 * B * S * H * HD * DM),
             schedule=gemm_schedule("flash_attention_proj", B * S, H * HD,
                                    DM))
        del q, k, v, wo, kr, vr

    # flash_attention: qwen3-14b's "pallas" prefill (causal, and full), and
    # 12 heads of 64 at a length no tile divides
    for b, h, kvh, sq, hd, causal in ((1, 40, 8, 512, 128, True),
                                      (1, 40, 8, 512, 128, False),
                                      (1, 12, 12, 1000, 64, False)):
        q, k, v = (randn(b, h, sq, hd), randn(b, kvh, sq, hd),
                   randn(b, kvh, sq, hd))
        pairs = sq * (sq + 1) // 2 if causal else sq * sq
        case("flash_attention",
             f"B{b}xH{h}xKV{kvh}xS{sq}xhd{hd}x{'causal' if causal else 'full'}",
             lambda: flash_attention(q, k, v, causal),
             lambda: flash_attention_plain(q, k, v, causal),
             lambda: F.scaled_dot_product_attention(q, k, v,
                                                    is_causal=causal,
                                                    enable_gqa=True),
             bound((2 * q.numel() + k.numel() + v.numel()) * 2,
                   4.0 * b * h * hd * pairs))

    # rmsnorm: the composition lane of qwen3-14b's rmsnorm_matmul (prefill
    # and decode rows of 5120), and fig14's 512 x 512 in f32; the
    # arithmetic is f32 on the CUDA cores
    for m, d, dt in ((512, 5120, torch.bfloat16), (8, 5120, torch.bfloat16),
                     (512, 512, torch.float32)):
        x, sc = randn(m, d, dtype=dt), randn(d, scale=0.1, dtype=dt)
        w1 = 1.0 + sc
        size = 2 if dt == torch.bfloat16 else 4
        case("rmsnorm", f"M{m}xD{d}x{str(dt).replace('torch.', '')}",
             lambda: rmsnorm(x, sc), lambda: rmsnorm_plain(x, sc),
             lambda: F.rms_norm(x, (d,), weight=w1, eps=1e-6),
             bound((2 * m * d + d) * size, 4.0 * m * d, F32_FLOPS_PER_S),
             TOL if dt == torch.bfloat16 else F32_TOL)

    # matmul_bias_act: whisper-small's encoder MLP at 8 x 1500 frames (gelu
    # in, none out) on the mainloop, and decode-sized M on the decode kernel
    for m, k, n, act in ((12000, 768, 3072, "gelu"),
                         (12000, 3072, 768, "none"),
                         (5, 768, 3072, "silu"), (8, 3072, 768, "none")):
        a, w, bias = randn(m, k), randn(k, n, scale=k ** -0.5), randn(n)
        lib_act = {"none": lambda t: t,
                   "gelu": lambda t: F.gelu(t, approximate="tanh"),
                   "silu": F.silu}[act]
        case("matmul_bias_act", f"M{m}xK{k}xN{n}x{act}",
             lambda: fused.matmul_bias_act(a, w, bias, act),
             lambda: fused.matmul_bias_act_plain(a, w, bias, act),
             lambda: lib_act(torch.addmm(bias, a, w)),
             bound((m * k + k * n + n + m * n) * 2, 2.0 * m * k * n),
             schedule=gemm_schedule("matmul_bias_act", m, k, n))

    records = []
    for name, rows in cases.items():
        for label, err, tol, ms, plain, lib, (bms, by), sched, gr in rows:
            log("kernel", name=name, shape=label, max_abs_err=f"{err:.3g}",
                tol=f"rtol={tol['rtol']},atol={tol['atol']}",
                kernel_ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
                library_ms=f"{lib:.4f}", bound_ms=f"{bms:.4f}",
                bound_by=by, **{k: f"{v:.4f}" for k, v in gr.items()},
                **({"schedule": sched} if sched else {}))
        # the record of a kernel is its first row: the decode shape of the
        # qwen3 projections, the prefill shape of the attention kernels,
        # rmsnorm's prefill rows, whisper's first MLP product
        label, err, tol, ms, plain, lib, (bms, by), _, _ = rows[0]
        records.append({
            "name": name, "route": "cuda",
            "source": f"{SRC}/{name}.cu", "replaces": REPLACES[name],
            "launches": 0, "max_abs_err": max(r[1] for r in rows),
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib, "shape": label,
            "rows": [{"shape": r[0], "max_abs_err": r[1], "ms": r[3],
                      "plain_ms": r[4], "library_ms": r[5],
                      "bound_ms": r[6][0], "bound_by": r[6][1], **r[8],
                      **({"schedule": r[7]} if r[7] else {})}
                     for r in rows]})
    del cases, timer
    torch.cuda.empty_cache()
    return records


# ----------------------------------------------------------------------------
# the paper's Table 1 suite through repro_torch.kernels.ops
# ----------------------------------------------------------------------------

SUITE_REPLACES = {
    "matmul": "src/repro/kernels/matmul.py:25",
    "axpy": "src/repro/kernels/axpy.py:19",
    "dotp": "src/repro/kernels/dotp.py:19",
    "conv2d": "src/repro/kernels/conv2d.py:28",
    "dct8x8": "src/repro/kernels/dct8x8.py:17",
}
PAPER, CARD, RAGGED, DECODE = "paper", "card", "ragged", "decode"


def suite_cases():
    """(name, size, dtype, label, args, bytes, flops, library, tol) for
    every case: the paper's sizes (benchmarks/bench_table1_kernels.py),
    card sizes (working sets >= 10x the 50 MB L2), one ragged shape per
    kernel (edges that divide no tile) and, for bf16 matmul, qwen3-14b's
    decode shape (M = 8 slots: the decode kernel). tol: assert_close keywords, or for
    dotp the absolute error allowed."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(12)
    f32, bf16 = torch.float32, torch.bfloat16
    size_of = {f32: 4, bf16: 2}

    def rand(*shape, dtype=f32, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(dtype)

    cases = []
    for size, m, k, n, dt in ((PAPER, 256, 256, 256, f32),
                              (CARD, 4096, 4096, 4096, f32),
                              (CARD, 4096, 4096, 4096, bf16),
                              (RAGGED, 1000, 136, 200, f32),
                              (RAGGED, 1000, 135, 200, f32),  # K % 4 != 0
                              (RAGGED, 1000, 136, 200, bf16),
                              (RAGGED, 5, 520, 300, bf16),
                              (DECODE, 8, 5120, 5120, bf16)):
        a = rand(m, k, dtype=dt)
        b = rand(k, n, dtype=dt, scale=1.0 if dt == f32 else k ** -0.5)
        tol = (dict(rtol=0.0, atol=1e-4 * k ** 0.5) if dt == f32 else TOL)
        cases.append(("matmul", size, dt, f"M{m}xK{k}xN{n}", (a, b),
                      (m * k + k * n + m * n) * size_of[dt], 2.0 * m * n * k,
                      ("torch.matmul", lambda a=a, b=b: torch.matmul(a, b)),
                      tol))
    alpha = torch.tensor(2.0, device="cuda")
    for size, m, n, dt, al in ((PAPER, 768, 128, f32, alpha),
                               (CARD, 2097152, 128, f32, alpha),
                               (CARD, 2097152, 128, bf16, alpha),
                               (RAGGED, 1001, 77, f32, 2.0),
                               (RAGGED, 1001, 77, bf16, alpha)):
        x, y = rand(m, n, dtype=dt), rand(m, n, dtype=dt)
        cases.append(("axpy", size, dt, f"{m}x{n}", (al, x, y),
                      3 * m * n * size_of[dt], 2.0 * m * n,
                      ("torch.add(alpha=)",
                       lambda x=x, y=y: torch.add(y, x, alpha=2.0)),
                      F32_TOL if dt == f32 else TOL))
    for size, m, n in ((PAPER, 768, 128), (CARD, 2097152, 128),
                       (RAGGED, 1001, 77)):
        x, y = rand(m, n), rand(m, n)
        scale = (x * y).abs().sum().item()
        cases.append(("dotp", size, f32, f"{m}x{n}", (x, y),
                      2 * m * n * 4 + 4, 2.0 * m * n,
                      ("torch.dot", lambda x=x, y=y: torch.dot(x.view(-1),
                                                                y.view(-1))),
                      1e-5 * scale))
    for size, h, w_ in ((PAPER, 96, 1024), (CARD, 8192, 8192),
                        (RAGGED, 97, 1023)):
        x, w = rand(h, w_), rand(3, 3)
        cases.append(("conv2d", size, f32, f"{h}x{w_}", (x, w),
                      2 * h * w_ * 4 + 36, 18.0 * h * w_,
                      ("F.conv2d(padding=1)",
                       lambda x=x, w=w: F.conv2d(x[None, None], w[None, None],
                                                 padding=1)),
                      F32_TOL))
    c = torch.from_numpy(ref.dct_matrix(8)).cuda()
    for size, n in ((PAPER, 24576), (CARD, 4194304), (RAGGED, 1001)):
        x = rand(n, 8, 8)
        cases.append(("dct8x8", size, f32, f"{n}blk", (x,),
                      2 * n * 64 * 4 + 256, 4.0 * n * 8 ** 3,
                      ("einsum", lambda x=x: torch.einsum(
                          "ij,njk,lk->nil", c, x, c)),
                      F32_TOL))
    return cases


def suite_phase(launches) -> list[dict]:
    """The Table 1 kernels through `repro_torch.kernels.ops` under the
    default policy, in f32 as the Table 1 bench runs them (and bf16 for
    matmul and axpy). The counts are set to 0 just before every case runs
    once through ops and read just after: each kernel must have launched
    and no plain version run. Then each output is held against the plain
    version on the same inputs and the three are timed: warm, 200
    launches between one pair of events, at the paper's sizes (and the
    same 200 replayed as a CUDA graph: device time without the host's
    dispatch); L2 flushed before each launch at the others (at card sizes
    and the decode shape also replayed as a CUDA graph, flushed). Each f32
    matmul row names its route and the kernels its trace shows, and is
    held to an f64 product. The tensors are freed at the end."""
    from repro_torch.cluster.policy import use_policy
    from repro_torch.kernels import build, ops

    # the plain versions and the library calls must compute in f32, not
    # TF32 (cuDNN's convolutions allow TF32 by default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("suite: float32 matmul precision is "
                             f"{torch.get_float32_matmul_precision()!r}")
    op = {"matmul": ops.matmul, "axpy": ops.axpy, "dotp": ops.dotp,
          "conv2d": ops.conv2d_3x3, "dct8x8": ops.dct8x8}
    cases = suite_cases()
    torch.cuda.synchronize()
    with use_policy(None) as pol:                  # the default policy
        launches.reset_counts()
        outs = [op[c[0]](*c[4]) for c in cases]
        torch.cuda.synchronize()
        counts = launches.counts()
    for name in launches.SUITE:
        if counts[name]["launches"] <= 0 or counts[name]["plain_cuda_calls"]:
            raise AssertionError(f"suite: {name} counts {counts[name]}")
    if pol.stats != {"kernel_calls": len(cases)}:
        raise AssertionError(f"suite: policy routed {pol.stats}")

    timer = Timer()
    rows = {}
    for (name, size, dt, label, args, byts, flops, (lib_name, lib), tol), \
            got in zip(cases, outs):
        plain = launches.PLAIN[name]
        want = plain(*args)
        if name == "dotp":
            err = abs(got.item() - want.item())
            if got.shape != () or got.dtype != torch.float32 or err > tol:
                raise AssertionError(f"suite: dotp {label} err {err} > {tol}")
            tol_s = f"atol={tol:.3g}"
        else:
            err = _compare(f"{name} {label}", got, want, tol)
            tol_s = f"rtol={tol['rtol']},atol={tol['atol']:.3g}"
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"suite: {name} {label} gave {got.dtype} "
                                 f"{tuple(got.shape)}")
        kernel = launches.WRAPPERS[name]
        extra = {}
        if size == PAPER:
            fns = (lambda: kernel(*args), lambda: plain(*args), lib)
            times = [warm_ms(f) for f in fns]
            extra = dict(zip(("graph_ms", "plain_graph_ms",
                              "library_graph_ms"), map(graph_ms, fns)))
        else:
            times = [timer(lambda: kernel(*args)),
                     timer(lambda: plain(*args), 3), timer(lib)]
            if size in (CARD, DECODE):    # also without host dispatch
                extra = {"graph_ms": graph_ms(lambda: kernel(*args), 10,
                                              timer.flush),
                         "library_graph_ms": graph_ms(lib, 10, timer.flush)}
        peak = F32_FLOPS_PER_S if dt == torch.float32 else BF16_FLOPS_PER_S
        bms, by = bound(byts, flops, peak)
        sched = {}
        if name == "matmul" and dt == torch.float32:
            # 3xTF32 does three TF32 products of the work: its bound, and the
            # f32 CUDA cores' beside it; held to an f64 product too
            (m, k), n = args[0].shape, args[1].shape[1]
            sched = {"schedule": f32_schedule(m, k, n)}
            on_tc = sched["schedule"].startswith("tf32x3")
            route = (sched["schedule"].split(",")[1] if on_tc
                     else "cuda_core_tile")
            sched["schedule"] += ",kernel=" + kernel_instance(
                lambda: kernel(*args), F32_KERNELS[route],
                [p for r, ps in F32_KERNELS.items() if r != route
                 for p in ps])
            sched["bound_f32_cores_ms"] = bms
            if on_tc:
                bms, by = bound(byts, 3 * flops, TF32_FLOPS_PER_S)
            want64 = args[0].double() @ args[1].double()
            sched["err_f64"] = (got.double() - want64).abs().max().item()
            sched["plain_err_f64"] = (want.double()
                                      - want64).abs().max().item()
            del want64
            if sched["err_f64"] > 2 * sched["plain_err_f64"]:
                raise AssertionError(
                    f"suite: matmul {label} f32 is {sched['err_f64']} from "
                    f"an f64 product, the plain version "
                    f"{sched['plain_err_f64']}")
        if name == "matmul" and dt == torch.bfloat16:
            (m, k), n = args[0].shape, args[1].shape[1]
            sched = {"schedule": gemm_schedule(name, m, k, n)}
            if on_mainloop(sched["schedule"]):
                sched["schedule"] += (
                    f",kernel={kernel_instance(lambda: kernel(*args))}")
            elif sched["schedule"].startswith("decode"):
                sched["schedule"] += (",kernel=" + kernel_instance(
                    lambda: kernel(*args), (DECODE_KERNEL,), ("skinny::",)))
        if name in ("axpy", "dotp"):      # the launch's blocks (its plan)
            y = args[-1]
            sched = {"schedule": "blocks=" + str(build.entry(
                name, f"{name}_grid")(y.numel(), int(dt == torch.bfloat16),
                                      y.get_device()))}
        timing = "warm" if size == PAPER else "flushed"
        dts = str(dt).replace("torch.", "")
        log("suite", name=name, size=size, dtype=dts, shape=label,
            max_abs_err=f"{err:.3g}", tol=tol_s, kernel_ms=f"{times[0]:.5f}",
            plain_ms=f"{times[1]:.5f}", library_ms=f"{times[2]:.5f}",
            library=f"'{lib_name}'", bound_ms=f"{bms:.5f}", bound_by=by,
            timing=timing, launches=counts[name]["launches"],
            **{k: f"{v:.5f}" for k, v in extra.items()},
            **{k: (f"{v:.5f}" if k.endswith("_ms") else
                   f"{v:.3g}" if isinstance(v, float) else v)
               for k, v in sched.items()})
        rows.setdefault(name, []).append({
            "size": size, "dtype": dts, "shape": label, "max_abs_err": err,
            "ms": times[0], "plain_ms": times[1], "library_ms": times[2],
            "library": lib_name, "bound_ms": bms, "bound_by": by,
            "timing": timing, **extra, **sched})
    records = []
    for name, rs in rows.items():
        # the record of a kernel is its first card-size (f32) row
        head = next(r for r in rs if r["size"] == CARD)
        records.append({
            "name": name, "route": "cuda", "source": f"{SRC}/{name}.cu",
            "replaces": SUITE_REPLACES[name],
            "launches": counts[name]["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "shape", "timing")},
            "rows": rs})
    del cases, outs, timer
    torch.cuda.empty_cache()
    host_phase()
    return records


def host_us(fn, calls: int = 1000) -> float:
    """Mean host wall per call of `fn` over `calls` calls issued back to
    back (after 100 to warm up; the card keeps up at these sizes, so this
    is the host's time to issue a call)."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def host_spans(fn, calls: int = 200) -> tuple[float, dict, dict]:
    """A host profile of `fn`: `calls` calls, each in a `record_function`
    span, under one torch.profiler trace (after 100 calls to warm up).
    Returns the mean host us a call of the whole span; by name, of the
    host events directly inside it (operators such as aten::empty_like,
    CUDA runtime calls such as cudaLaunchKernel, the profiler's own buffer
    requests; the whole less their sum is Python and ctypes); and, by
    name, of the CUDA runtime calls at any depth (a library call's launch
    sits inside its operator). The profiler's own cost inflates each
    span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            with record_function("host_call"):
                fn()
        torch.cuda.synchronize()
    host = sorted(((e.time_range.start, -e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CPU
                   and e.name != "cudaDeviceSynchronize"))
    whole, spans, runtime, end, inner_end = 0.0, {}, {}, None, None
    for start, neg_end, name in host:       # by start; outer spans first
        stop = -neg_end
        if name == "host_call":
            whole += stop - start
            end, inner_end = stop, None
            continue
        if end is None or stop > end:
            end = None
            continue
        if inner_end is None or start >= inner_end:       # not nested
            spans[name] = spans.get(name, 0.0) + stop - start
            inner_end = stop
        if name.startswith("cu"):
            runtime[name] = runtime.get(name, 0.0) + stop - start
    return (whole / calls, {k: v / calls for k, v in spans.items()},
            {k: v / calls for k, v in runtime.items()})


def one_kernel_a_call(what: str, fn, name: str) -> str:
    """The one device kernel a call of `fn` runs, from a torch.profiler
    trace (`traced`); raises unless the trace holds exactly one kernel and
    it is wrapper `name`'s entry kernel."""
    from repro_torch.kernels import launches

    events = device_events(traced(what, fn))
    kernels = [(e.key.replace(" ", ""), e.count) for e in events]
    if (sum(c for _, c in kernels) != 1 or not any(
            p in kernels[0][0] for p in launches.ENTRY_KERNELS[name])):
        raise AssertionError(f"host: {what} ran {kernels}, not one "
                             f"{launches.ENTRY_KERNELS[name]}")
    return re.search(name + r"_kernel<[^>]*>", kernels[0][0]).group(0)


def host_phase() -> None:
    """The host's side of a call at the paper's size (768 x 128 f32), for
    axpy with a number alpha and with a tensor alpha, and for dotp: the
    mean host wall a call over 1,000 calls (`host_us`) through
    `repro_torch.kernels.ops`, through the wrapper, and of the library
    call (`torch.add(y, x, alpha=)`, `torch.dot`), and the wrapper's
    pieces timed alone the same way: the operand and alpha checks, the
    output's allocation, the stream lookup, and the C call with its launch
    (`rest` is the wrapper less the four; `ctypes` is a call of a C
    function of three ints that launches nothing, `axpy_grid`: ctypes' own
    cost). Each is the median of three such means, taken in turn; timed
    alone, the pieces need not add up to the wrapper (`rest` may be
    negative). A `[host_spans]` line a case splits the wrapper's and the
    library call's time from one torch.profiler trace each (`host_spans`),
    where the pieces do add up. A trace of one call shows one device
    kernel, the wrapper's (`one_kernel_a_call`). One line a case."""
    from repro_torch.kernels import axpy, build, dotp, ops

    g = torch.Generator(device="cuda").manual_seed(15)
    x = torch.randn(768, 128, generator=g, device="cuda")
    y = torch.randn(768, 128, generator=g, device="cuda")
    xf, yf = x.view(-1), y.view(-1)
    dev, n, st = x.get_device(), x.numel(), build.stream(x.get_device())
    xp, yp = x.data_ptr(), y.data_ptr()
    f_axpy, f_dotp = axpy.launchers()[0], dotp.launchers()[0]
    f_grid = build.launcher("axpy", "axpy_grid")[0]
    out_a, out_d = torch.empty_like(x), torch.empty((), device="cuda")
    tensor_alpha = torch.tensor(2.0, device="cuda")
    cases = {}
    for kind, alpha in (("number", 2.0), ("tensor", tensor_alpha)):
        ptr = alpha.data_ptr() if kind == "tensor" else None
        cases["axpy", kind] = dict(
            ops=lambda alpha=alpha: ops.axpy(alpha, x, y),
            wrapper=lambda alpha=alpha: axpy.axpy(alpha, x, y),
            library=lambda: torch.add(y, x, alpha=2.0),
            checks=lambda alpha=alpha: (
                build.check_operands("axpy", x, y, dtypes=axpy.DTYPES),
                axpy.alpha_arg(alpha, x)),
            alloc=lambda: torch.empty_like(x),
            stream=lambda: build.stream(dev),
            ctypes=lambda: f_grid(n, 0, dev),
            launch=lambda ptr=ptr: f_axpy(ptr, 2.0, xp, yp,
                                          out_a.data_ptr(), n, dev, st))
    cases["dotp", "-"] = dict(
        ops=lambda: ops.dotp(x, y), wrapper=lambda: dotp.dotp(x, y),
        library=lambda: torch.dot(xf, yf),
        checks=lambda: build.check_operands("dotp", x, y,
                                            dtypes=dotp.DTYPES),
        alloc=lambda: x.new_empty((), dtype=torch.float32),
        stream=lambda: build.stream(dev),
        ctypes=lambda: f_grid(n, 0, dev),
        launch=lambda: f_dotp(xp, yp, out_d.data_ptr(), n, dev, st))
    for (name, kind), fns in cases.items():
        kernel = one_kernel_a_call(f"host {name} {kind}", fns["wrapper"],
                                   name)
        if fns["launch"]() != 0:
            raise AssertionError(f"host: {name} launch failed")
        runs = {k: [] for k in fns}
        for _ in range(3):
            for k, fn in fns.items():
                runs[k].append(host_us(fn))
        us = {k: sorted(v)[1] for k, v in runs.items()}
        rest = us["wrapper"] - sum(us[k] for k in ("checks", "alloc",
                                                   "stream", "launch"))
        log("host", name=name, alpha=kind, shape="768x128", kernel=kernel,
            traced_kernels=1, **{f"{k}_us": f"{v:.3f}" for k, v in us.items()},
            rest_us=f"{rest:.3f}",
            wrapper_over_library=f"{us['wrapper'] / us['library']:.3f}",
            ops_over_library=f"{us['ops'] / us['library']:.3f}")
        for who in ("wrapper", "library"):
            whole, spans, runtime = host_spans(fns[who])
            log("host_spans", name=name, alpha=kind, call=who,
                whole_us=f"{whole:.3f}",
                rest_us=f"{whole - sum(spans.values()):.3f}",
                spans=json.dumps({k: round(v, 3) for k, v in spans.items()},
                                 separators=(",", ":")),
                runtime=json.dumps({k: round(v, 3)
                                    for k, v in runtime.items()},
                                   separators=(",", ":")))


# ----------------------------------------------------------------------------
# the tuning layer: each kernel's plan knobs raced through tuned_call
# ----------------------------------------------------------------------------

BF16, F32 = "bfloat16", "float32"
# (kernel, shape dict, dtype): every (kernel, shape) cell of qwen3-14b's
# fused path (prefill M512 and decode M8; PERF.md §6 rows 1-3), whisper-
# small's encoder MLP (matmul_bias_act, where pick_bn is known to miss)
# and f32 matmul 4096^3 on the 3xTF32 route; the Table 1 suite follows
# (`table1.tune_operands`, the reference bench's sizes)
TUNE_CELLS = (
    *(("rmsnorm_matmul", {"m": 512, "k": 5120, "n": n}, BF16)
      for n in (5120, 7168, 17408)),
    *(("rmsnorm_matmul", {"m": 8, "k": 5120, "n": n}, BF16)
      for n in (1024, 5120, 17408)),
    ("matmul_residual_add", {"m": 512, "k": 17408, "n": 5120}, BF16),
    ("matmul_residual_add", {"m": 8, "k": 5120, "n": 5120}, BF16),
    ("matmul_residual_add", {"m": 8, "k": 17408, "n": 5120}, BF16),
    ("flash_attention_proj", {"b": 1, "h": 40, "kv": 8, "s": 512,
                              "hd": 128, "dm": 5120}, BF16),
    ("matmul_bias_act", {"m": 12000, "k": 3072, "n": 768}, BF16),
    ("matmul_bias_act", {"m": 12000, "k": 768, "n": 3072}, BF16),
    ("matmul", {"m": 4096, "k": 4096, "n": 4096}, F32),
)
GATE_TOL = 0.15          # benchmarks/check_gate.py's --tol default
BAD_PIN = {"mainloop": {"tile_n": 192}, "decode": {"boxes": 9},
           "tf32x3": {"tile_n": 96}}


def _gemm_dims(name: str, s: dict) -> tuple[int, int, int] | None:
    """(M, K, N) of a cell's product on a GEMM kernel, else None."""
    if name == "flash_attention_proj":
        return s["b"] * s["s"], s["h"] * s["hd"], s["dm"]
    if {"m", "k", "n"} <= set(s):
        return s["m"], s["k"], s["n"]
    return None


def _tune_operands(name: str, shapes: dict, dtype) -> tuple:
    """A cell's operands for the tuned call, its check and its timing: the
    race's own factory (`ops.OPS[name].operands`), with a bf16 weight
    scaled by its fan-in so that outputs stay near 1 (the race makes its
    own operands)."""
    from repro_torch.kernels import ops

    args = list(ops.OPS[name].operands(shapes, dtype, "cuda"))
    if dtype == torch.bfloat16:
        w = {"rmsnorm_matmul": 2, "matmul": 1, "matmul_residual_add": 1,
             "matmul_bias_act": 1, "flash_attention_proj": 3}[name]
        fan_in = shapes["k"] if "k" in shapes else shapes["h"] * shapes["hd"]
        args[w] = (args[w].float() * fan_in ** -0.5).to(dtype)
    return tuple(args)


def _retime(timer, winner, default, rounds: int = 3) -> tuple[float, float]:
    """The winner's and the default's ms, each the least of `rounds` means
    of 10 flushed launches, taken in turn after a burst of 50 launches
    (a trace's host pauses before leave the clocks low, and a kernel of a
    few us timed first would pay for it). `timer` is a Timer with a spin
    before each launch: without it a busy host's pauses reach the timed
    span, and equal plans (the same launch on both sides) part by up to
    1.8x (`tools/tune_timing.py --stress`)."""
    for _ in range(50):
        default()
    torch.cuda.synchronize()
    times = ([], [])
    for _ in range(rounds):
        for t, fn in zip(times, (default, winner)):
            t.append(timer(fn))
    return min(times[1]), min(times[0])


def tune_phase(launches, cells=TUNE_CELLS) -> dict[str, list[dict]]:
    """The tuning layer on the card: a kernel-only Cluster with a TuneDB in
    a temporary directory, under KernelPolicy(mode="fused",
    tuning="timed"). Each cell goes through `ops.tuned_call` (a miss: the
    race of the top 3 modeled plans, the kernel's own plan and, for a
    fused op, its composition, 3 flushed reps each), then the Table 1
    suite through `table1.tuned_rows`. Counts are set to 0 before the
    races and read after: every cell's kernel launched, no plain version
    ran. Then each cell's tuned output is held against its plain version,
    the winner (its knobs pinned, or the composition) and the kernel's own
    plan are timed again (`_retime`: flushed, means of 10) and held to the
    gate's tuned <= default x 1.15; on a mainloop
    cell a pinned tile_n must show in the traced kernel's name and in
    `wgmma_plan`, and the Python model's tile_n must equal the kernel's
    own; a pin the kernel cannot take must raise. Last, a fresh process
    importing only repro_torch opens the same DB: every cell is warm-
    started, every tuned_call hits, and nothing is raced. Returns
    {kernel: [cell result, ...]}."""
    import os
    import tempfile

    from repro_torch.cluster import Cluster, KernelPolicy, use_policy
    from repro_torch.configs import registry
    from repro_torch.kernels import gemm_plans, ops, table1, tunedb
    from repro_torch.kernels import pipeline as pp

    t0 = time.perf_counter()
    os.environ["REPRO_TUNE_TOPN"] = "3"
    os.environ["REPRO_TUNE_REPS"] = "3"
    dtypes = {BF16: torch.bfloat16, F32: torch.float32}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_tune_")
    db_path = str(Path(tmp.name) / "tunes.json")
    pol = KernelPolicy(mode="fused", tuning="timed")
    cluster = Cluster(None, policy=pol, tune_db=db_path)
    if cluster.tune_db_warm != 0:
        raise AssertionError(f"tune: a new DB warm-started "
                             f"{cluster.tune_db_warm} records")
    suite_ops = table1.tune_operands(device="cuda")
    # the card's flash attention kernel takes bf16 only
    suite_ops["flash_attention"] = tuple(
        t.bfloat16() for t in suite_ops["flash_attention"])
    runs = [(name, shapes, dtypes[dt], _tune_operands(name, shapes,
                                                      dtypes[dt]))
            for name, shapes, dt in cells]
    torch.cuda.synchronize()
    launches.reset_counts()
    with use_policy(pol):
        outs = [ops.tuned_call(name, *args) for name, _, _, args in runs]
        rows = table1.tuned_rows(device="cuda", operands=suite_ops)
        torch.cuda.synchronize()
    counts = launches.counts()
    race_s = time.perf_counter() - t0
    for name, shapes, dt, args in [
            *runs, *((n, ops.kernel_shapes(n, *a), a[-1].dtype, a)
                     for n, a in suite_ops.items())]:
        if counts[name]["launches"] <= 0 or counts[name]["plain_cuda_calls"]:
            raise AssertionError(f"tune: {name} counts {counts[name]}")
    if pol.stats.get("tune_races") != len(runs) + len(rows) or \
            pol.stats.get("tune_misses") != len(runs) + len(rows):
        raise AssertionError(f"tune: policy stats {pol.stats}")
    with use_policy(pol):
        outs += [ops.tuned_call(n, *a) for n, a in suite_ops.items()]
    runs += [(n, ops.kernel_shapes(n, *a), a[-1].dtype, a)
             for n, a in suite_ops.items()]

    timer = Timer(spin_cycles=pp.SPIN_CYCLES)
    results: dict[str, list[dict]] = {}
    failed = []                   # cells the gate's tuned check refuses
    for (name, shapes, dt, args), got in zip(runs, outs):
        db = torch.tensor([], dtype=dt).element_size()
        key = pp.shape_key(shapes, db)
        rec = registry.get_kernel_tune(name, key)
        res = pp.TUNE_RESULTS[(name, key)]
        if rec is None or rec.source != "timed":
            raise AssertionError(f"tune: {name} {key} record {rec}")
        wrapper = ops.wrapper_for(name)
        plain = launches.PLAIN[name]
        want = plain(*args)
        if name == "dotp":
            err = abs(got.item() - want.item())
            if err > 1e-5 * (args[0] * args[1]).abs().sum().item():
                raise AssertionError(f"tune: dotp err {err}")
        else:
            k = shapes.get("k", shapes.get("d", 1))
            tol = (TOL if dt == torch.bfloat16 else
                   dict(rtol=0.0, atol=1e-4 * k ** 0.5) if name == "matmul"
                   else F32_TOL)
            err = _compare(f"tune {name} {key}", got, want, tol)
        picked, own = dict(rec.blocks), dict(rec.default_blocks)
        if rec.route == "unfused":
            def winner():
                return ops.OPS[name].composition(*args)
        else:
            def winner():
                return wrapper(*args, **picked)
        tuned_ms, default_ms = _retime(timer, winner, lambda: wrapper(*args))
        if tuned_ms > default_ms * (1 + GATE_TOL):
            failed.append(f"{name} {key} ({rec.route}, {dict(rec.blocks)}) "
                          f"tuned {tuned_ms:.5f} ms > default "
                          f"{default_ms:.5f} ms x {1 + GATE_TOL}")
        extra = {}
        dims = _gemm_dims(name, shapes)
        kind = ("mainloop" if name == "flash_attention_proj" and own else
                gemm_plans.route(*dims, db) if dims else "fixed")
        if kind == "mainloop":
            m, _, n = dims
            if gemm_plans.pick_tile_n(m, n) != own["tile_n"]:
                raise AssertionError(
                    f"tune: {name} {key} model tile_n "
                    f"{gemm_plans.pick_tile_n(m, n)} != wgmma_plan "
                    f"{own['tile_n']}")
            pin = 128 if own["tile_n"] != 128 else 256
            inst = kernel_instance(lambda: wrapper(*args, tile_n=pin))
            planned = gemm_plans.wgmma_plan(name, m, n, pin)[0]
            if not inst.startswith(f"tma_wgmma_kernel<{pin},") or \
                    planned != pin:
                raise AssertionError(f"tune: {name} pinned tile_n {pin} "
                                     f"ran {inst}, plan {planned}")
            extra = {"pinned_tile_n": pin, "pinned_kernel": inst}
        if kind in BAD_PIN:
            try:
                wrapper(*args, **BAD_PIN[kind])
                torch.cuda.synchronize()
            except RuntimeError:
                extra["bad_pin_raised"] = BAD_PIN[kind]
            else:
                raise AssertionError(f"tune: {name} took the pin "
                                     f"{BAD_PIN[kind]}")
        cell = {"shape_key": key, "lanes": res.raced, "picked": picked,
                "own_plan": own, "route": rec.route,
                "modeled_us": rec.modeled_seconds * 1e6,
                "default_modeled_us": rec.default_modeled_seconds * 1e6,
                "measured_us": rec.measured_us, "default_us": rec.default_us,
                "tuned_ms": tuned_ms, "default_ms": default_ms,
                "max_abs_err": err, **extra}
        results.setdefault(name, []).append(cell)
        fmt = {k: (f"{v:.5f}" if k.endswith("_ms") else f"{v:.2f}"
                   if isinstance(v, float) else
                   json.dumps(v, separators=(",", ":"))
                   if isinstance(v, dict) else v) for k, v in cell.items()}
        log("tune", kernel=name, **fmt)
    del outs, runs, timer
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("tune: the gate's tuned check failed: "
                             + "; ".join(failed))

    # a fresh process: the same DB warm-starts every cell, zero races
    cells_json = json.dumps([[n, s, dt] for n, s, dt in cells]
                            + [[n, None, None] for n in suite_ops])
    code = f"""
import json, sys
sys.path.insert(0, {str(Path(__file__).resolve().parent / 'src')!r})
import torch
from repro_torch.cluster import Cluster, KernelPolicy, use_policy
from repro_torch.kernels import ops, table1
pol = KernelPolicy(mode="fused", tuning="timed")
c = Cluster(None, policy=pol, tune_db={db_path!r})
suite = table1.tune_operands(device="cuda")
suite["flash_attention"] = tuple(t.bfloat16() for t in
                                 suite["flash_attention"])
dt = {{"bfloat16": torch.bfloat16, "float32": torch.float32}}
with use_policy(pol):
    for name, shapes, d in json.loads({cells_json!r}):
        args = (suite[name] if shapes is None else
                ops.OPS[name].operands(shapes, dt[d], "cuda"))
        ops.tuned_call(name, *args)
torch.cuda.synchronize()
print(json.dumps({{"warm": c.tune_db_warm, "stats": pol.stats,
                  "jax": "jax" in sys.modules,
                  "repro": "repro" in sys.modules}}))
"""
    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"tune: the fresh process failed:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    fresh = json.loads(proc.stdout.strip().splitlines()[-1])
    n_cells = len(cells) + len(suite_ops)
    st = fresh["stats"]
    if (fresh["warm"] != n_cells or st.get("tune_hits") != n_cells
            or st.get("tune_races", 0) or st.get("tune_misses", 0)
            or fresh["jax"] or fresh["repro"]):
        raise AssertionError(f"tune: fresh process {fresh}, {n_cells} "
                             f"cells")
    log("tune", part="fresh_process", warm_started=fresh["warm"],
        tune_hits=st.get("tune_hits"), tune_races=st.get("tune_races", 0),
        tune_misses=st.get("tune_misses", 0),
        seconds=f"{time.perf_counter() - t1:.1f}")
    log("tune", part="done", cells=n_cells, race_seconds=f"{race_s:.1f}",
        seconds=f"{time.perf_counter() - t0:.1f}",
        db_records=len(cluster.tune_db))
    cluster.tune_db = None            # the DB's directory goes next
    tunedb.set_active_db(None)
    tmp.cleanup()
    return results


# ----------------------------------------------------------------------------
# a reduced model: kernels on the card vs plain versions on the CPU
# ----------------------------------------------------------------------------

def agree_phase() -> None:
    """Reduced models, kernels on the card against plain versions on the
    CPU (policy "interpret"), logits within 5e-2 absolute + relative (a
    2-layer bf16 model: sum order flips single bf16 roundings, which the
    next layer carries on): qwen3 through the fused kernels, qwen3 through
    flash_attention ("tuned", attn_schedule="pallas"), whisper-small
    (2 + 2 layers at full width) through matmul_bias_act ("fused"), its
    attention weights rescaled to their true fan-in (`_true_fan_in`), and
    the MoE smoke configs (grok-1-314b with heads of 128, mixtral-8x7b)
    under "fused" in global and in per-row dispatch."""
    from repro_torch.configs import get

    qwen = dataclasses.replace(get("qwen3-14b"), name="qwen3-14b-narrow",
                               n_layers=2, d_model=512, n_heads=4,
                               n_kv_heads=2, d_ff=1024, vocab=2048)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, qwen.vocab, (2, 40)))
    _agree("fused", qwen, "fused", tokens)
    _agree("pallas", dataclasses.replace(qwen, attn_schedule="pallas"),
           "tuned", tokens)
    whisper = dataclasses.replace(get("whisper-small"), n_layers=2,
                                  n_enc_layers=2)
    frames = torch.from_numpy(rng.standard_normal(
        (1, whisper.enc_seq, whisper.d_model)).astype(np.float32)).bfloat16()
    _agree("whisper", whisper, "fused",
           torch.from_numpy(rng.integers(0, whisper.vocab, (1, 16))),
           frames, max_seq=448, rescale=True)
    # the MoE block at smoke size, both dispatch modes: grok (no window:
    # flash_attention_proj, whose kernel takes heads of 128, so grok's 4
    # smoke heads are 128 wide) and mixtral (window 16 < S = 40: banded)
    for name, hd in (("grok-1-314b-smoke", 128), ("mixtral-8x7b-smoke", 16)):
        for local in (False, True):
            cfg = dataclasses.replace(get(name), moe_local_dispatch=local,
                                      head_dim=hd)
            _agree(f"{name}:hd{hd}:{'local' if local else 'global'}", cfg,
                   "fused",
                   torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40))))
    # the three mixed-kind smoke configs under "fused", their attention
    # weights at the true fan-in (none has a qk-norm on its self-attention):
    # recurrentgemma (rglru, local_attn with a window of 16 < S = 40, the
    # geglu MLP on rmsnorm_matmul and matmul_residual_add), xlstm (mlstm
    # and slstm call no kernel, in the reference as in the port) and the
    # vision arch with heads of 128 (flash_attention_proj takes no other)
    # and its cross gates open, against 8 image embeddings
    for name, hd in (("recurrentgemma-9b-smoke", 16),
                     ("xlstm-125m-smoke", 16),
                     ("llama-3.2-vision-90b-smoke", 128)):
        cfg = dataclasses.replace(get(name), head_dim=hd)
        img = None
        if cfg.n_img_tokens:
            img = torch.from_numpy(rng.standard_normal(
                (2, cfg.n_img_tokens, cfg.d_model)).astype(
                    np.float32)).bfloat16()
        _agree(f"{name}:hd{hd}", cfg, "fused",
               torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40))), img,
               rescale=True, kernels=cfg.family != "ssm")


def open_gates(params):
    """The cross blocks' tanh gates are drawn as zeros, which would leave
    the blocks out of the model: open them, in place, to fixed values
    (tanh(0.7) for the attention, tanh(-0.4) for the FFN)."""
    for p in params["blocks"]:
        if "gate_attn" in p:
            p["gate_attn"].fill_(0.7)
            p["gate_ffn"].fill_(-0.4)
    return params


def _true_fan_in(tree):
    """The parameter init draws a 3-D weight with fan-in shape[-2]: wq,
    wk and wv (d, H, hd) with H (12 for whisper), wo (H, hd, d) with hd.
    With no qk-norm (qwen3 has one) whisper's random attention scores are
    then ~64x too large: each softmax picks one key, and a bf16 rounding
    flips which (bf16 against f32 logits differ by up to 4.6 on the CPU).
    Rescaled to the true fan-in (d, and H * hd) they differ by 0.03."""
    if isinstance(tree, list):
        return [_true_fan_in(v) for v in tree]
    out = {}
    for k, v in tree.items():
        if isinstance(v, torch.Tensor) and k in ("wq", "wk", "wv", "wo"):
            fan, true = ((v.shape[1], v.shape[0]) if k != "wo"
                         else (v.shape[1], v.shape[0] * v.shape[1]))
            out[k] = (v.float() * (fan / true) ** 0.5).to(v.dtype)
        elif isinstance(v, (dict, list)):
            out[k] = _true_fan_in(v)
        else:
            out[k] = v
    return out


def _agree(label, cfg, policy, tokens, frames=None, max_seq=4096,
           rescale=False, kernels=True) -> None:
    """`kernels`: whether the model's path launches a kernel (xlstm's
    does not)."""
    from repro_torch.cluster.policy import use_policy
    from repro_torch.kernels import launches
    from repro_torch.models import steps

    params = open_gates(steps.init_params(cfg, 1, device="cpu",
                                          max_seq=max_seq))
    if rescale:
        params = _true_fan_in(params)
    gpu = _to(params, "cuda")
    with torch.inference_mode():
        with use_policy("interpret"):
            h_cpu, _ = steps.forward(cfg, params, tokens, cross_embeds=frames)
        launches.reset_counts()
        with use_policy(policy):
            h_gpu, _ = steps.forward(
                cfg, gpu, tokens.cuda(),
                cross_embeds=None if frames is None else frames.cuda())
        torch.cuda.synchronize()
        ran = {n: c for n, c in _check_counts(launches, "agree", ()).items()
               if c}
        lg_cpu = steps.logits(params, h_cpu)
        lg_gpu = steps.logits(gpu, h_gpu).cpu()
    if kernels and not ran:
        raise AssertionError(f"agree {label}: no kernel launched")
    err = (lg_cpu - lg_gpu).abs().max().item()
    torch.testing.assert_close(lg_gpu, lg_cpu, rtol=5e-2, atol=5e-2)
    agree = (lg_cpu.argmax(-1) == lg_gpu.argmax(-1)).float().mean().item()
    log("agree", model=label, policy=policy, layers=cfg.n_layers,
        logits_max_abs_err=f"{err:.3g}", tol="rtol=5e-2,atol=5e-2",
        argmax_agreement=f"{agree:.3f}",
        launches=json.dumps(ran).replace(" ", ""))


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return [_to(v, device) for v in tree]


# ----------------------------------------------------------------------------
# the fused ops' compositions (their unfused lanes)
# ----------------------------------------------------------------------------

COMPOSE = {   # name -> (shape dict, the kernels its composition launches)
    "rmsnorm_matmul": (dict(m=512, k=5120, n=17408), ("rmsnorm", "matmul")),
    "matmul_residual_add": (dict(m=512, k=17408, n=5120), ("matmul",)),
    "matmul_bias_act": (dict(m=12000, k=768, n=3072), ("matmul",)),
    "flash_attention_proj": (dict(b=1, h=40, kv=8, s=512, hd=128, dm=5120),
                             ("flash_attention",)),
}


def compose_phase(launches) -> dict:
    """Each fused op's composition (`ops.OPS[name].composition`, the
    reference's unfused lane) at a model path's shape, on the op's seeded
    operands, under the default policy: the counts are set to 0 just
    before it runs once and read just after; it must launch its primitive
    kernels and no fused one. Its output is held against the fused
    kernel's (bf16, 2e-2: the same roundings, sums in another order) and
    both are timed (L2 flushed, mean of 10). Returns the summed counts."""
    from repro_torch.cluster.policy import use_policy
    from repro_torch.kernels import ops

    timer = Timer()
    total = dict.fromkeys(launches.WRAPPERS, 0)
    for name, (shapes, parts) in COMPOSE.items():
        desc = ops.OPS[name]
        args = desc.operands(shapes, torch.bfloat16, device="cuda")
        with use_policy(None):
            launches.reset_counts()
            comp = desc.composition(*args)
            torch.cuda.synchronize()
            counts = _check_counts(launches, f"compose {name}", parts)
            if any(counts[n] for n in launches.FUSED):
                raise AssertionError(f"compose {name}: a fused kernel ran "
                                     f"{counts}")
            err = _compare(f"compose {name}", comp, desc.wrapper(*args))
            fused_ms = timer(lambda: desc.wrapper(*args))
            comp_ms = timer(lambda: desc.composition(*args))
        for n, c in counts.items():
            total[n] += c
        log("compose", name=name, shape="x".join(
            f"{k}{v}" for k, v in shapes.items()), max_abs_err=f"{err:.3g}",
            tol=f"rtol={TOL['rtol']},atol={TOL['atol']}",
            fused_ms=f"{fused_ms:.4f}", composition_ms=f"{comp_ms:.4f}",
            launches=_nonzero(counts))
        del args, comp
    del timer
    torch.cuda.empty_cache()
    return total


# ----------------------------------------------------------------------------
# whisper-small at full width: prefill and decode
# ----------------------------------------------------------------------------

def whisper_phase(launches) -> dict:
    """whisper-small, all 12 + 12 layers, random weights from a seeded
    generator on the card, under "fused": make_prefill_step on 8 x 32
    tokens with 8 x 1500 stub frame embeddings (from a seeded generator,
    as the reference's `_encode` takes them), run eagerly, counted and
    traced (exactly 24 matmul_bias_act launches: 12 encoder MLPs x 2
    products, the decoder takes none); then the same step as a CUDA graph
    (`graph_replay`: its token, its traced launches, its walls). Then
    `ServeProgram(batch=8, max_seq=448, max_new=16)` on whisper-small with
    the prefill's tokens as a one-token prompt, at chunk 16 (one graph of
    16 steps) and chunk 1 (a step's graph a token): equal tokens, ms a
    step of a second run of each, one chunk's traced device time. Its
    graphs and weights are freed at the end."""
    from repro_torch.cluster.policy import use_policy
    from repro_torch.cluster.session import Cluster, ServeProgram
    from repro_torch.configs import get
    from repro_torch.models import steps

    cfg = get("whisper-small")
    B, S, MAX_SEQ, STEPS = 8, 32, 448, 16
    torch.cuda.reset_peak_memory_stats()
    params = steps.init_params(cfg, 0, device="cuda", max_seq=MAX_SEQ)
    g = torch.Generator(device="cuda").manual_seed(3)
    frames = torch.randn((B, cfg.enc_seq, cfg.d_model), generator=g,
                         device="cuda").bfloat16()
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, S))).cuda()
    batch = {"tokens": tokens, "enc_embeds": frames}
    prefill = steps.make_prefill_step(cfg, policy="fused")
    prefill.eager(params, batch)                          # warm-up
    counted, tok, dt, top = _counted_and_traced(
        launches, "whisper", lambda: prefill.eager(params, batch),
        ("matmul_bias_act",))
    want = {n: 0 for n in counted} | {"matmul_bias_act": 2 * cfg.n_enc_layers}
    if counted != want:
        raise AssertionError(f"whisper: prefill launches {counted}")
    with torch.inference_mode(), use_policy("fused"):
        hidden, _ = steps.forward(cfg, params, tokens, cross_embeds=frames)
        lg = steps.logits(params, hidden[:, -1])
    if not torch.isfinite(lg).all() or tuple(lg.shape) != (B, cfg.vocab):
        raise AssertionError("whisper: logits not finite or misshapen")
    if not torch.equal(lg.argmax(-1).to(torch.int32), tok):
        raise AssertionError("whisper: argmax disagrees with the step")
    graph = graph_replay(launches, "whisper", lambda: prefill(params, batch),
                         counted, tok)
    del prefill

    cluster = Cluster("whisper-small")
    prompt = tok.cpu().numpy().astype(np.int32)[:, None]
    runs = {}
    for chunk in (16, 1):
        with cluster.policy("fused"):
            prog = cluster.compile(ServeProgram(batch=B, max_seq=MAX_SEQ,
                                                max_new=STEPS, chunk=chunk))
        launches.reset_counts()
        first = prog.run(params=params, prompt=prompt)
        _check_counts(launches, f"whisper decode chunk {chunk}", ())
        again = prog.run(params=params, prompt=prompt)
        if not np.array_equal(first["tokens"], again["tokens"]):
            raise AssertionError(f"whisper: chunk {chunk} reruns differ")
        runs[chunk] = (prog, again)
    dec = runs[16][1]["tokens"]
    if not np.array_equal(dec, runs[1][1]["tokens"]):
        raise AssertionError(f"whisper: chunk 16 tokens {dec} differ from "
                             f"chunk 1's {runs[1][1]['tokens']}")
    if dec.shape != (B, 1 + STEPS) or dec.min() < 0 or dec.max() >= cfg.vocab:
        raise AssertionError(f"whisper: decode tokens {dec}")
    for prog, _ in runs.values():
        for name, c in prog.cache.items():
            if not torch.isfinite(c).all():
                raise AssertionError(f"whisper: non-finite {name} cache")
    prog16 = runs[16][0]
    step_ms = {16: prog16.engine.chunk_latencies[0][0] * 1e3 / STEPS,
               1: runs[1][1]["stats"]["p50_ms"]}
    prof = traced("whisper_chunk", lambda: prog16.engine.generate(
        params, prog16.cache, dec[:, -1:], STEPS, start_pos=1 + STEPS))
    chunk_device_ms = device_busy_ms(prof)
    # the MLP products' mainloop instantiations in the trace, and the
    # prefill's five device kernels with the most time
    mainloop = {m.group(0): n for key, _, n in top
                for m in [re.search(r"tma_wgmma_kernel<[^>]*>",
                                    key.replace(" ", ""))] if m}
    log("whisper", B=B, S=S, enc_frames=cfg.enc_seq,
        layers=f"{cfg.n_enc_layers}+{cfg.n_layers}", policy="fused",
        prefill_ms=f"{dt * 1e3:.1f}",
        traced_device_ms=f"{sum(r[1] for r in top):.1f}",
        mainloop=json.dumps(mainloop).replace(" ", ""),
        prefill_tokens=",".join(map(str, tok.tolist())),
        launches=_nonzero(counted), traced_launches=_nonzero(counted),
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    log("whisper", mode="cuda_graph", **graph_fields(graph, dt))
    log("whisper", decode="ServeProgram", B=B, max_seq=MAX_SEQ,
        steps=STEPS, ms_per_step_chunk16=f"{step_ms[16]:.2f}",
        ms_per_step_chunk1=f"{step_ms[1]:.2f}",
        chunk16_device_ms=f"{chunk_device_ms:.2f}",
        chunk16_device_ms_per_step=f"{chunk_device_ms / STEPS:.2f}",
        tokens_equal_chunk16_chunk1=True,
        decode_tokens_slot0=",".join(map(str, dec[0].tolist())))
    for key, ms, n in top[:5]:
        log("whisper", kernel=f"'{key[:70]}'", device_ms=f"{ms:.2f}",
            launches=n)
    del params, frames, batch, runs, prog, prog16, cluster
    torch.cuda.empty_cache()
    return counted


def graph_replay(launches, phase: str, fn, eager_counts: dict,
                 eager_out: torch.Tensor) -> dict:
    """`fn`, a call of a `Graphed` step on the card: its first call runs
    eagerly and captures, the next replays, and the replay's output must
    equal `eager_out`. One replay, traced between sentinels, must launch
    each kernel as often as the eager run's wrappers counted, through no
    wrapper (the counts set to 0 just before, read just after). Returns
    the replay's mean wall over 10 (CUDA events from before the input
    copies to after the output's copy, and the host clock to a
    synchronize), the traced replay's device time (the sum of its
    kernels' times, as the eager lines add them, and the union of their
    spans) and its counts."""
    fn()                                                  # capture
    got = fn()                                            # replay
    if not torch.equal(got, eager_out):
        raise AssertionError(f"{phase}: the graph replay gave {got}, the "
                             f"eager step {eager_out}")

    def counted_fn():
        launches.reset_counts()
        fn()

    prof = traced(f"{phase}_graph", counted_fn)
    seen = launches.traced_launches(prof)
    wrapped = _check_counts(launches, phase, ())
    if seen != eager_counts or any(wrapped.values()):
        raise AssertionError(f"{phase}: a traced replay launched {seen} "
                             f"(through wrappers {wrapped}); the eager run "
                             f"counted {eager_counts}")
    events, host = [], []
    for _ in range(10):
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
        events.append(s.elapsed_time(e))
    return {"event_ms": float(np.mean(events)),
            "host_ms": float(np.mean(host)) * 1e3,
            "device_ms": sum(e.device_time_total
                             for e in device_events(prof)) / 1e3,
            "busy_ms": device_busy_ms(prof), "launches": seen}


def graph_fields(graph: dict, eager_s: float) -> dict:
    """A graph_replay result as a log line's fields, the eager wall
    beside it."""
    return {"replay_wall_ms": f"{graph['event_ms']:.2f}",
            "replay_host_ms": f"{graph['host_ms']:.2f}",
            "replay_traced_device_ms": f"{graph['device_ms']:.2f}",
            "replay_busy_ms": f"{graph['busy_ms']:.2f}",
            "eager_wall_ms": f"{eager_s * 1e3:.1f}",
            "token_equal_to_eager": True,
            "traced_launches": _nonzero(graph["launches"])}


# ----------------------------------------------------------------------------
# full width: prefill and serve
# ----------------------------------------------------------------------------

def _check_counts(launches, phase: str, must_launch) -> dict:
    counts = launches.counts()
    for name, c in counts.items():
        if c["plain_cuda_calls"]:
            raise AssertionError(f"{phase}: plain {name} ran on CUDA "
                                 f"tensors {c['plain_cuda_calls']} times")
    for name in must_launch:
        if counts[name]["launches"] <= 0:
            raise AssertionError(f"{phase}: {name} never launched")
    return {n: c["launches"] for n, c in counts.items()}


def prefill_phase(launches):
    """One full-width prefill run eagerly (`.eager`), timed with the
    counts set to 0 just before it; then the same prefill traced, whose
    device kernels must match the wrappers' counts (eager: one launch per
    wrapper call); then as a CUDA graph (`graph_replay`), freed after."""
    from repro_torch.cluster.policy import use_policy
    from repro_torch.cluster.session import Cluster
    from repro_torch.models import steps

    cluster = Cluster("qwen3-14b")
    cfg = cluster.arch
    t0 = time.perf_counter()
    params = steps.init_params(cfg, 0, device=cluster.device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log("params", n=n_params, gb=f"{n_params * 2 / 1e9:.1f}",
        init_s=f"{time.perf_counter() - t0:.1f}")

    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, 512))).cuda()
    prefill = steps.make_prefill_step(cfg, policy="fused")
    prefill.eager(params, {"tokens": tokens[:, :16]})    # warm-up
    counted, tok, dt, top = _counted_and_traced(
        launches, "prefill",
        lambda: prefill.eager(params, {"tokens": tokens}), QWEN_FUSED)
    if counted["flash_attention_proj"] != cfg.n_layers:
        raise AssertionError(f"prefill: launches {counted}")
    with torch.inference_mode():
        with use_policy("fused"):
            hidden, _ = steps.forward(cfg, params, tokens)
        lg = steps.logits(params, hidden[:, -1])
    if not torch.isfinite(lg).all() or tuple(lg.shape) != (1, cfg.vocab):
        raise AssertionError("prefill: logits not finite or misshapen")
    if int(lg.argmax(-1)) != int(tok[0]):
        raise AssertionError("prefill: argmax disagrees with the step")
    log("prefill", B=1, S=512, layers=cfg.n_layers, ms=f"{dt * 1e3:.1f}",
        token=int(tok[0]), launches=json.dumps(
            {n: counted[n] for n in QWEN_FUSED}).replace(" ", ""),
        traced_device_ms=f"{sum(r[1] for r in top):.1f}")
    for key, ms, n in top[:5]:
        log("prefill", kernel=f"'{key[:70]}'", device_ms=f"{ms:.2f}",
            launches=n)
    graph = graph_replay(launches, "prefill",
                         lambda: prefill(params, {"tokens": tokens}),
                         counted, tok)
    log("prefill", mode="cuda_graph", **graph_fields(graph, dt))
    del prefill
    torch.cuda.empty_cache()
    return cfg, params, counted, int(tok[0])


def _counted_and_traced(launches, phase, fn, must_launch):
    """Run `fn` with the counts set to 0 just before it and read just after
    (every kernel of `must_launch` must have launched, no plain version on
    the card); then again under torch.profiler, whose trace must see the
    same launches (eager: one device launch per wrapper call). Returns
    (the counts, fn's result, its wall seconds, the traced run's device
    kernels as (name, ms, launches), most time first)."""
    launches.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counted = _check_counts(launches, phase, must_launch)

    def counted_fn():
        launches.reset_counts()         # each trace counts its own run
        fn()

    prof = traced(phase, counted_fn)
    seen = launches.traced_launches(prof)
    if seen != counted or _check_counts(launches, phase,
                                        must_launch) != counted:
        raise AssertionError(f"{phase}: the trace saw {seen}, the "
                             f"wrappers counted {counted}")
    top = sorted(((e.key, e.device_time_total / 1e3, e.count)
                  for e in device_events(prof) if e.device_time_total > 0),
                 key=lambda r: -r[1])
    return counted, out, dt, top


def _nonzero(counts: dict) -> str:
    return json.dumps({n: c for n, c in counts.items() if c}).replace(" ",
                                                                      "")


def pallas_prefill_phase(launches, cfg, params, fused_token: int) -> dict:
    """qwen3-14b's prefill (B=1, S=512) under the default "tuned" policy
    with attn_schedule="pallas": attention through flash_attention, the
    projections as torch products (the reference computes them outside
    any Pallas kernel), eager and then as a CUDA graph. Its token beside
    the fused prefill's is a finding, not a check: bf16 near-ties can
    part the two routes."""
    from repro_torch.models import steps

    pcfg = dataclasses.replace(cfg, attn_schedule="pallas")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, 512))).cuda()
    prefill = steps.make_prefill_step(pcfg, policy="tuned")
    prefill.eager(params, {"tokens": tokens[:, :16]})    # warm-up
    counted, tok, dt, top = _counted_and_traced(
        launches, "pallas_prefill",
        lambda: prefill.eager(params, {"tokens": tokens}),
        ("flash_attention",))
    want = {n: 0 for n in counted} | {"flash_attention": pcfg.n_layers}
    if counted != want:
        raise AssertionError(f"pallas_prefill: launches {counted}")
    token = int(tok[0])
    if not 0 <= token < cfg.vocab:
        raise AssertionError(f"pallas_prefill: token {token} out of range")
    log("pallas_prefill", B=1, S=512, layers=pcfg.n_layers, policy="tuned",
        ms=f"{dt * 1e3:.1f}", token=token,
        token_equal_to_fused=token == fused_token,
        launches=_nonzero(counted),
        traced_device_ms=f"{sum(r[1] for r in top):.1f}")
    for key, ms, n in top[:5]:
        log("pallas_prefill", kernel=f"'{key[:70]}'", device_ms=f"{ms:.2f}",
            launches=n)
    graph = graph_replay(launches, "pallas_prefill",
                         lambda: prefill(params, {"tokens": tokens}),
                         counted, tok)
    log("pallas_prefill", mode="cuda_graph", **graph_fields(graph, dt))
    del prefill
    torch.cuda.empty_cache()
    return counted


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        for v in tree:
            yield from _leaves(v)


def serve_requests(vocab: int) -> list[tuple[np.ndarray, int]]:
    """12 requests, prompts of 8..63 tokens, 4..47 new tokens each. The
    odd ones share a 32-token (two-page) preamble; request 1 finishes
    early and publishes it, so later sharers hit the prefix cache, and
    requests 9 and 11 are the bare preamble (an exact full-coverage hit:
    a COW fork)."""
    rng = np.random.default_rng(7)
    pre = rng.integers(1, vocab, 32)
    reqs = []
    for i in range(12):
        if i in (9, 11):
            prompt = pre.copy()
        elif i % 2:
            prompt = np.concatenate(
                [pre, rng.integers(1, vocab, int(rng.integers(4, 32)))])
        else:
            prompt = rng.integers(1, vocab, int(rng.integers(8, 64)))
        max_new = 4 if i == 1 else int(rng.integers(8, 48))
        reqs.append((prompt.astype(np.int32), max_new))
    return reqs


def _serve(cfg, params, reqs, *, eager: bool = False, launches=None):
    """Serve `reqs` through a fresh session and drain it. `eager` swaps
    the compiled session's chunk program for one that runs every step
    from Python (the graph's check). Given `launches`, the counts are
    set to 0 just before the requests go in and the run is traced;
    returns the wrapper counts and the trace's counts as well."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.cluster.session import Cluster, ServeSessionProgram
    from repro_torch.models import steps
    from repro_torch.runtime import engine

    cluster = Cluster("qwen3-14b")
    spec = ServeSessionProgram(slots=8, max_seq=256, max_prompt=64,
                               chunk=16, paged=True, page_size=16,
                               prefix_cache=True)
    with cluster.policy("fused"):
        prog = cluster.compile(spec)
    if eager:
        prog._chunk_fn = engine.session_chunk_fn(
            steps.make_decode_step(cfg, max_seq=spec.max_seq,
                                   policy="fused"),
            spec.chunk, eos_id=spec.eos_id, cuda_graph=False)
    sess = prog.open(params=params)
    torch.cuda.synchronize()
    prof = None
    if launches is not None:
        launches.reset_counts()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    t0 = time.perf_counter()
    handles = [sess.submit(p, n) for p, n in reqs]
    stats = sess.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if prof is None:
        return sess, handles, stats, dt
    counts = _check_counts(launches, "serve",
                           ("rmsnorm_matmul", "matmul_residual_add"))
    prof.stop()
    return sess, handles, stats, dt, counts, launches.traced_launches(prof)


def serve_phase(launches, cfg, params) -> dict:
    """The main path: the session step replayed as a CUDA graph, as the
    session runs it on the card, under torch.profiler. The wrappers count
    the launches of the session's eager first step and of its capture;
    the trace counts every launch the replays made. Then the same requests
    twice more without the profiler: replayed (the timed run) and run
    eagerly from Python. The tokens of all three must be the same."""
    reqs = serve_requests(cfg.vocab)
    sess, handles, stats, dt, counts, traced = _serve(cfg, params, reqs,
                                                      launches=launches)
    for name in ("rmsnorm_matmul", "matmul_residual_add"):
        if traced[name] < counts[name]:
            raise AssertionError(f"serve: the trace saw {traced[name]} "
                                 f"launches of {name}, the wrapper counted "
                                 f"{counts[name]}")
    log("serve", mode="cuda_graph,traced", wall_s=f"{dt:.2f}",
        tokens_per_s=f"{stats['tokens_per_s']:.2f}",
        wrapper_launches=json.dumps(
            {n: counts[n] for n in QWEN_FUSED}).replace(" ", ""),
        traced_launches=json.dumps(
            {n: traced[n] for n in QWEN_FUSED}).replace(" ", ""))
    for h, (prompt, n) in zip(handles, reqs):
        toks = h.result()
        if not (toks.size == n or (h.hit_eos and toks.size <= n)):
            raise AssertionError(f"request {h.id}: {toks.size} of {n}")
        if toks.min() < 0 or toks.max() >= cfg.vocab:
            raise AssertionError(f"request {h.id}: token out of range")
    for name, pool in sess.state["cache"].items():
        if not torch.isfinite(pool).all():
            raise AssertionError(f"serve: non-finite values in the {name} "
                                 f"pool")
    kv = stats["kv"]
    if kv["prefix_hits"] <= 0 or kv["cow_forks"] <= 0:
        raise AssertionError(f"serve: expected prefix hits and a COW fork, "
                             f"got {kv}")
    traced_tokens = [h.result() for h in handles]
    del sess
    for mode, eager in (("cuda_graph", False), ("eager", True)):
        sess, handles, stats, dt = _serve(cfg, params, reqs, eager=eager)
        same = all(np.array_equal(a, h.result())
                   for a, h in zip(traced_tokens, handles))
        if not same or stats["kv"] != kv:
            raise AssertionError(f"serve: {mode} tokens or kv counters "
                                 f"differ from the traced run's")
        log("serve", mode=mode, requests=len(reqs), wall_s=f"{dt:.2f}",
            tokens_per_s=f"{stats['tokens_per_s']:.2f}",
            emitted=stats["emitted_total"],
            ttft_p50_ms=f"{stats['ttft_ms']['p50']:.1f}",
            occupancy_pct=f"{stats['occupancy_pct']:.1f}",
            stall_pct=f"{stats['stall']['stall_pct']:.2f}",
            kv=json.dumps({k: kv[k] for k in (
                "prefix_hits", "prefix_misses", "pages_shared",
                "prefill_skipped_tokens", "cow_forks", "allocs",
                "used_pages")}).replace(" ", ""),
            peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.1f}",
            tokens_equal_to_traced=same)
        del sess
    return counts, traced


def profile_phase(launches, cfg, params, steps_n: int = 4) -> None:
    """Where a decode step's time goes, run eagerly from Python and
    replayed as a CUDA graph. For each: the wall time per step on the host
    clock, then the same steps under torch.profiler (between sentinels,
    after primers, as `traced` runs every trace), whose device busy time
    (the union of the kernels' spans) over that run's own wall time is the
    device's busy share (idle = 1 - busy), and the top kernels by the sum
    of their spans (which overlap where a kernel waits for the one before
    it). The trace must count each wrapper's launches a step as one eager
    step's wrappers do, and no split-K kernel: every qwen3 decode product
    is one decode-kernel launch."""
    from repro_torch.models import steps

    B, ps, npp = 8, 16, 17
    cache = steps.init_paged_cache(cfg, B, 256, n_pages=B * npp + 1,
                                   page_size=ps, device="cuda")
    pages = (1 + torch.arange(B * npp, device="cuda")).reshape(B, npp)
    step = steps.make_decode_step(cfg, max_seq=256, policy="fused")
    tok = torch.ones(B, 1, dtype=torch.int64, device="cuda")
    pos = torch.full((B,), 100, dtype=torch.int64, device="cuda")

    def run(n):
        nonlocal tok
        for i in range(n):
            _, tok = step(params, cache, {"tokens": tok.long(),
                                          "pos": pos + i, "pages": pages})
        torch.cuda.synchronize()

    run(2)
    launches.reset_counts()                # one eager step's launches
    run(1)
    per_step = {n: c for n, c in _check_counts(
        launches, "profile", ("rmsnorm_matmul", "matmul_residual_add")
    ).items() if c}
    graph = torch.cuda.CUDAGraph()         # the same step, replayed
    batch = {"tokens": tok.long(), "pos": pos, "pages": pages}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side,
                          capture_error_mode="thread_local"):
        step(params, cache, batch)

    def replay(n):
        for _ in range(n):
            graph.replay()
        torch.cuda.synchronize()

    replay(1)
    for mode, fn in (("eager", run), ("cuda_graph", replay)):
        t0 = time.perf_counter()
        fn(steps_n)
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps_n
        timed = {}

        def timed_run():
            t0 = time.perf_counter()
            fn(steps_n)
            timed["ms"] = (time.perf_counter() - t0) * 1e3 / steps_n

        prof = traced(f"profile_{mode}", timed_run)
        traced_ms = timed["ms"]
        seen = {n: c for n, c in launches.traced_launches(prof).items() if c}
        split_k = sum(e.count for e in device_events(prof)
                      if "skinny::" in e.key)
        if seen != {n: c * steps_n for n, c in per_step.items()} or split_k:
            raise AssertionError(
                f"profile {mode}: {steps_n} steps traced {seen} and "
                f"{split_k} split-K kernels; one eager step counted "
                f"{per_step}")
        rows = [(e.key, e.device_time_total / 1e3 / steps_n,
                 e.count // steps_n)
                for e in device_events(prof) if e.device_time_total > 0]
        busy = device_busy_ms(prof) / steps_n
        rows.sort(key=lambda r: -r[1])
        log("profile", mode=mode, step_wall_ms=f"{wall_ms:.2f}",
            traced_step_wall_ms=f"{traced_ms:.2f}",
            device_busy_ms=f"{busy:.2f}",
            kernel_span_sum_ms=f"{sum(r[1] for r in rows):.2f}",
            device_idle_pct=f"{100 * (1 - busy / traced_ms):.1f}",
            launches_per_step=sum(r[2] for r in rows),
            traced_launches_per_step=json.dumps(
                {n: c // steps_n for n, c in seen.items()}).replace(" ", ""))
        for key, ms, n in rows[:8]:
            log("profile", mode=mode, kernel=f"'{key[:60]}'",
                ms_per_step=f"{ms:.3f}", launches_per_step=n)
    del graph


def engine_phase(launches, cfg, params) -> dict:
    """The fixed batch's execution engine at full width: qwen3-14b under
    "fused" through `Cluster.compile(ServeProgram(batch=8, max_seq=256,
    max_new=64))` with an 8 x 32 prompt from a seeded generator, at chunk
    16 (the K-step engine, one CUDA graph of 16 steps a chunk) and chunk 1
    (one step's graph a token). The counts are set to 0 just before the
    first run and read just after. Each program runs twice: a second
    compile of the spec is a cache hit, and its run captures nothing.
    Tokens must be equal across chunks, with 4 and 64 host syncs; with an
    EOS id that slot 0 emits, tokens, emitted_per_slot and finished_slots
    too (the EOS id: a token slot 0 first emits at column 20 or later).
    One steady chunk, traced, must launch each decode kernel 16 times one
    eager step's count. Returns that chunk's traced launches."""
    from repro_torch.cluster.session import Cluster, ServeProgram

    cluster = Cluster("qwen3-14b")
    prompt = np.random.default_rng(11).integers(1, cfg.vocab, (8, 32))
    base = ServeProgram(batch=8, max_seq=256, max_new=64, chunk=16)

    def compiled(**kw):
        with cluster.policy("fused"):
            return cluster.compile(dataclasses.replace(base, **kw))

    launches.reset_counts()
    prog = compiled()
    first = prog.run(params=params, prompt=prompt)
    counts = _check_counts(launches, "engine",
                           ("rmsnorm_matmul", "matmul_residual_add"))
    captured = prog.captures()
    hits = cluster.compile_cache.hits
    if compiled() is not prog or cluster.compile_cache.hits != hits + 1:
        raise AssertionError("engine: a second compile missed the cache")
    runs = {16: prog.run(params=params, prompt=prompt)}
    steady_chunk_ms = np.mean([dt for dt, _ in
                               prog.engine.chunk_latencies]) * 1e3
    if prog.captures() != captured or captured != 2:
        raise AssertionError(f"engine: captures {captured} then "
                             f"{prog.captures()} (want 2, then none)")
    per_token = compiled(chunk=1)
    per_token.run(params=params, prompt=prompt)
    runs[1] = per_token.run(params=params, prompt=prompt)
    toks = runs[16]["tokens"]
    if not (np.array_equal(toks, first["tokens"])
            and np.array_equal(toks, runs[1]["tokens"])):
        raise AssertionError("engine: chunk 16 and chunk 1 tokens differ")
    syncs = {k: r["stats"]["stall"]["host_syncs"] for k, r in runs.items()}
    if syncs != {16: 4, 1: 64}:
        raise AssertionError(f"engine: host syncs {syncs}")
    if toks.shape != (8, 65) or toks.min() < 0 or toks.max() >= cfg.vocab:
        raise AssertionError(f"engine: tokens {toks.shape}")
    # EOS: the first token slot 0 emits from column 20 on that it did not
    # emit before, so that slot 0 ends mid-run, inside a chunk
    eos_id = next((int(t) for c, t in enumerate(toks[0]) if c >= 20
                   and t not in toks[0, 1:c]), int(toks[0, 20]))
    eos = {k: compiled(chunk=k, eos_id=eos_id).run(params=params,
                                                   prompt=prompt)
           for k in (16, 1)}
    for key in ("emitted_per_slot", "finished_slots"):
        if eos[16]["stats"][key] != eos[1]["stats"][key]:
            raise AssertionError(f"engine: EOS {key} differs: "
                                 f"{eos[16]['stats'][key]} vs "
                                 f"{eos[1]['stats'][key]}")
    if (not np.array_equal(eos[16]["tokens"], eos[1]["tokens"])
            or eos[16]["stats"]["finished_slots"] < 1
            or eos[16]["stats"]["emitted_per_slot"][0] >= 64):
        raise AssertionError("engine: EOS tokens differ or slot 0 did not "
                             "end early")

    # one eager step's launches, then one steady chunk replayed, traced
    with torch.inference_mode():
        tok = torch.as_tensor(toks[:, -1:], device="cuda")
        launches.reset_counts()
        prog.decode.eager(params, prog.cache, {"tokens": tok, "pos": 96})
        torch.cuda.synchronize()
    per_step = {n: c for n, c in _check_counts(launches, "engine step",
                                               ()).items() if c}
    eng = prog.engine

    def one_chunk():
        launches.reset_counts()
        eng.generate(params, prog.cache, toks[:, -1:], 16, start_pos=97)

    prof = traced("engine_chunk", one_chunk)
    traced_chunk = launches.traced_launches(prof)
    wrapped = _check_counts(launches, "engine chunk", ())
    seen = {n: c for n, c in traced_chunk.items() if c}
    if seen != {n: 16 * c for n, c in per_step.items()} or any(
            wrapped.values()):
        raise AssertionError(f"engine: a traced chunk launched {seen} "
                             f"(wrappers {wrapped}); one eager step "
                             f"{per_step}")
    busy = device_busy_ms(prof)
    chunk_wall = np.mean([dt for dt, _ in eng.chunk_latencies])
    for k, r in runs.items():
        st = r["stats"]
        log("engine", B=8, prompt=32, max_new=64, chunk=k, policy="fused",
            tokens_per_s_per_slot=f"{st['tokens_per_s_per_slot']:.2f}",
            tokens_per_s=f"{8 * st['tokens_per_s_per_slot']:.2f}",
            p50_ms=f"{st['p50_ms']:.2f}", p99_ms=f"{st['p99_ms']:.2f}",
            decode_steps=st["decode_steps"],
            stall_pct=f"{st['stall']['stall_pct']:.3f}",
            dispatch_gap_s=f"{st['stall']['dispatch_gap_s']:.4f}",
            device_wait_s=f"{st['stall']['device_wait_s']:.3f}",
            wall_s=f"{st['stall']['wall_s']:.3f}",
            host_syncs=st["stall"]["host_syncs"],
            captures=(prog if k == 16 else per_token).captures())
    log("engine", chunk=16, traced_chunk_device_busy_ms=f"{busy:.2f}",
        traced_chunk_wall_ms=f"{chunk_wall * 1e3:.2f}",
        steady_chunk_wall_ms=f"{steady_chunk_ms:.2f}",
        traced_launches_per_chunk=json.dumps(seen).replace(" ", ""),
        eager_step_launches=json.dumps(per_step).replace(" ", ""),
        wrapper_launches_first_run=_nonzero(counts),
        eos_id=eos_id, eos_finished_slots=eos[16]["stats"][
            "finished_slots"],
        eos_emitted_per_slot=json.dumps(eos[16]["stats"][
            "emitted_per_slot"]).replace(" ", ""),
        tokens_equal_chunk16_chunk1=True,
        compile_cache=json.dumps({"hits": cluster.compile_cache.hits,
                                  "misses": cluster.compile_cache.misses}
                                 ).replace(" ", ""),
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.1f}")
    del prog, per_token, eng, cluster, eos
    torch.cuda.empty_cache()
    return traced_chunk


# ----------------------------------------------------------------------------
# chaos: the robustness and durability layer on qwen3-14b's graphed session
# ----------------------------------------------------------------------------

CHAOS_CLASSES = ("latency", "throughput", "throughput", "best_effort")
CHAOS_WATCHDOG_S = 5.0            # bounds every chunk's device wait
CHAOS_SCRUB_PAGES = 8             # stamped pages re-verified a chunk


def ev_ms(fn):
    """(fn(), device ms between CUDA events recorded around it)."""
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    e.synchronize()
    return out, s.elapsed_time(e)


def _bits(t) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def same_bits(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_bits(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        _bits(a), _bits(b))


def chaos_program(cluster, **kw):
    """qwen3-14b's session under "fused": 8 slots, max_seq 256, prompts up
    to 64, chunk 16, the step replayed as a CUDA graph."""
    from repro_torch.cluster.session import ServeSessionProgram

    spec = ServeSessionProgram(slots=8, max_seq=256, max_prompt=64,
                               chunk=16, retry_backoff_s=0.0, **kw)
    with cluster.policy("fused"):
        return cluster.compile(spec)


FAULT_SPEC = dict(paged=True, page_size=16, nan_check=True,
                  watchdog_s=CHAOS_WATCHDOG_S, scrub_pages=CHAOS_SCRUB_PAGES)


def chaos_drive(sess, reqs, *, late=(), before_poll=None, wedged=None):
    """Submit `reqs` (classes cycled), then `late` after the first poll;
    poll to the end. `before_poll(sess)` runs before each poll (it may
    script faults by what it sees); a `wedged` exception is recovered
    from (`recover_wedged`), its wall and the next poll's (which captures
    the fresh state's graph) timed. Returns (handles, wall s, the tokens
    each rid was handed, the recovery times)."""
    handles = [sess.submit(p, n, klass=CHAOS_CLASSES[i % 4])
               for i, (p, n) in enumerate(reqs)]
    delivered = {h.id: [] for h in handles}
    recoveries = []
    gc.collect()            # an earlier session's graph pool goes first
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = True
    while sess.busy or first:
        if before_poll is not None:
            before_poll(sess)
        try:
            events = sess.poll()
        except Exception as e:
            if wedged is None or not isinstance(e, wedged):
                raise
            t1 = time.perf_counter()
            sess.recover_wedged()
            t2 = time.perf_counter()
            events = sess.poll()
            torch.cuda.synchronize()
            recoveries.append((t2 - t1, time.perf_counter() - t2))
        for h, toks, _ in events:
            delivered.setdefault(h.id, []).extend(int(t) for t in toks)
        if first:
            for p, n, k in late:
                h = sess.submit(p, n, klass=k)
                handles.append(h)
                delivered[h.id] = []
            first = False
    torch.cuda.synchronize()
    return handles, time.perf_counter() - t0, delivered, recoveries


def e2e_rate(delivered, wall) -> float:
    """End-to-end tokens/s: every token handed to a caller over the
    drive's wall (admission, checksums, the journal, snapshots and the
    step graph's capture included)."""
    return sum(len(t) for t in delivered.values()) / wall


def _check_finite(tag, sess):
    for name, c in sess.state["cache"].items():
        if not torch.isfinite(c).all():
            raise AssertionError(f"chaos {tag}: non-finite {name} pool")


def chaos_faults(cluster, params, reqs):
    """Part 1: the fault-free run, then one run under a FaultPlan with
    every kind but crash. page_alloc_fail fires at the first boundary;
    the rest are scripted as the run goes, on what the session shows:
    refill_error at the first later boundary that frees a slot for a
    queued request (so its round has admissions to undo), kill_slot at
    chunk 2 and corrupt_nan at chunk 3 on running slots that map no
    shared page, bit_flip on a published (stamped) page that only the
    prefix cache holds, and the wedge once the flip was caught. Every
    completed request must have the fault-free tokens, every fault must
    fire once and be seen by its own path. The rates are end to end
    (`e2e_rate`)."""
    from repro_torch.runtime import FaultPlan, InjectedFault, SessionWedged
    from repro_torch.runtime.kvpool import page_digests

    prog = chaos_program(cluster, **FAULT_SPEC)
    timing = {"nan": [], "chunk": [], "verify": []}

    def instrument(sess):
        scan, chunk, verify = (sess._nan_scan_fn, sess._chunk_fn,
                               sess._verify_pages)
        flagged = set()

        def timed_scan(state):
            flags, ms = ev_ms(lambda: scan(state))
            timing["nan"].append(ms)
            flagged.update(int(s) for s in torch.nonzero(flags).flatten())
            return flags

        def timed_chunk(p, state):
            out, ms = ev_ms(lambda: chunk(p, state))
            timing["chunk"].append(ms)
            return out

        def timed_verify(pages):
            t0 = time.perf_counter()
            bad = verify(pages)
            timing["verify"].append(((time.perf_counter() - t0) * 1e3,
                                     len(pages)))
            return bad

        sess._nan_scan_fn, sess._chunk_fn = timed_scan, timed_chunk
        sess._verify_pages = timed_verify
        return flagged

    clean = prog.open(params=params)
    handles, wall, got_clean, _ = chaos_drive(clean, reqs)
    want = [h.result() for h in handles]
    base_rate = e2e_rate(got_clean, wall)
    _check_finite("fault-free", clean)
    # one chunk's traced device time, in a session of its own
    probe = prog.open(params=params)
    for p, n in reqs[:8]:
        probe.submit(p, n)
    probe.poll()
    probe.poll()
    prof = traced("chaos_chunk", probe.poll)
    traced_chunk_ms = device_busy_ms(prof)
    stamped = sorted(clean.kv.checksums)[:8]
    arrs, read_ms = ev_ms(lambda: clean._page_read_fn(
        clean.state, np.asarray(stamped, np.int64)))
    t0 = time.perf_counter()
    page_digests(arrs, len(stamped))
    digest_ms = (time.perf_counter() - t0) * 1e3 / len(stamped)
    page_bytes = sum(a[0].nbytes for a in arrs)
    del clean, probe

    plan = FaultPlan().page_alloc_fail(at_chunk=0)
    did = {}
    check_refill = plan.check_refill

    def failing_refill(boundary):
        try:
            check_refill(boundary)
        except InjectedFault:
            # the round the failure must undo: this boundary's admissions
            did["granted"] = sorted(
                r.rid for _, r in sess.scheduler.running_requests()
                if r.rid not in did["running_before"])
            raise

    plan.check_refill = failing_refill

    def undone(sess) -> bool:
        """After the failed refill's poll: every request of its round is
        queued again, at the head of its class queue, with no slot, and
        the failure was counted once."""
        granted = did["granted"]
        queued = {r.rid: r for r in sess.scheduler.queued_requests()}
        if (not granted or sess._refill_failures != 1
                or any(g not in queued or queued[g].slot is not None
                       for g in granted)):
            return False
        for klass in {queued[g].klass for g in granted}:
            mine = {g for g in granted if queued[g].klass == klass}
            head = [r.rid for r in sess.scheduler._queues[klass]]
            if set(head[:len(mine)]) != mine:
                return False
        return True

    def unshared(sess, slot):
        kv = sess.kv
        return all(kv.pool.refcount[p] == 1 for p in kv._slot_owned[slot])

    def script(sess):
        c, kv = sess._chunk_index, sess.kv
        if "granted" in did and "undone" not in did:
            did["undone"] = undone(sess)
        elif "undone" in did and "readmitted_at" not in did and not any(
                r.rid in did["granted"]
                for r in sess.scheduler.queued_requests()):
            did["readmitted_at"] = c - 1    # the last poll's boundary
        if ("refill" not in did and c >= 1 and sess._pending_release
                and sess.scheduler.queued):
            did["refill"] = c
            did["running_before"] = {
                r.rid for _, r in sess.scheduler.running_requests()}
            plan.refill_error(at_chunk=c)
        hit = {did.get("kill"), did.get("corrupt")}
        running = [s for s, r in sess.scheduler.running_requests()
                   if r.state == "running" and s not in hit]
        if c == 2 and "kill" not in did:
            did["kill"] = max(running)
            plan.kill_slot(at_chunk=c, slot=did["kill"])
        elif c == 3 and "corrupt" not in did:
            did["corrupt"] = max(s for s in running if unshared(sess, s))
            plan.corrupt_nan(at_chunk=c, slot=did["corrupt"])
        elif c >= 4 and "flip" not in did:
            held = [p for p in sorted(kv.checksums)
                    if kv.pool.refcount[p] == 1]
            if held:
                did["flip"] = held[0]
                plan.bit_flip(at_chunk=c, page=held[0])
        elif ("flip" in did and "wedge" not in did
              and kv.integrity_violations and sess.scheduler.running):
            did["wedge"] = c
            did["quarantined_pages"] = sorted(kv.pool.quarantined)
            plan.wedge(at_chunk=c)

    sess = prog.open(params=params, faults=plan)
    flagged = instrument(sess)
    handles, chaos_wall, got_chaos, recov = chaos_drive(
        sess, reqs, before_poll=script, wedged=SessionWedged)
    st = sess.stats()
    fired = plan.summary()["by_kind"]
    nan_ms = float(np.mean(timing["nan"][1:]))
    chunk_ms = float(np.mean(timing["chunk"][1:]))
    verify = timing["verify"]
    got = [h.result() if h.ok else None for h in handles]
    if not all(h.ok for h in handles) or any(
            not np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"chaos faults: tokens differ from the "
                             f"fault-free run's ({[h.state for h in handles]})")
    if any(fired[k] != 1 for k in fired if k != "crash") or len(recov) != 1:
        raise AssertionError(f"chaos faults: fired {fired}, {did}")
    seen = {"kill_slot": st["quarantined_slots"] == [did["kill"]],
            "corrupt_nan": flagged == {did["corrupt"]},
            # the forced failure un-admits the 8 admissions of that boundary
            "page_alloc_fail": st["kv"]["pool_exhausted"] == 8,
            # its round undone (requeued at the head, no slot, counted
            # once) and admitted again at a later boundary
            "refill_error": (did.get("undone", False)
                             and "readmitted_at" in did),
            "bit_flip": (st["durability"]["integrity_violations"] == 1
                         and did["quarantined_pages"] == [did["flip"]]),
            # one graph captured at the first chunk, one more after the
            # wedge (the fresh state's)
            "wedge": sess.captures == (2 if sess.state["tok"].is_cuda
                                       else 0)}
    if not all(seen.values()):
        raise AssertionError(f"chaos faults: not seen by its path: {seen}, "
                             f"{did}, flagged {flagged}")
    _check_finite("faults", sess)
    log("chaos", part="faults", gpu=f"'{gpu_line()}'", requests=len(reqs),
        tokens_equal=True, faults_fired=json.dumps(fired).replace(" ", ""),
        scripted=json.dumps({k: did[k] for k in (
            "refill", "granted", "readmitted_at", "kill", "corrupt", "flip",
            "wedge")}).replace(" ", ""),
        seen=json.dumps(seen).replace(" ", ""),
        retries=st["retries"], quarantined_slots=st["quarantined_slots"],
        integrity=json.dumps({k: st["durability"][k] for k in (
            "integrity_checks", "integrity_violations",
            "integrity_repairs")}).replace(" ", ""))
    log("chaos", part="faults",
        fault_free_e2e_tokens_per_s=f"{base_rate:.2f}",
        chaos_e2e_tokens_per_s=f"{e2e_rate(got_chaos, chaos_wall):.2f}",
        fault_free_wall_s=f"{wall:.2f}", chaos_wall_s=f"{chaos_wall:.2f}",
        nan_scan_device_ms=f"{nan_ms:.4f}",
        chunk_event_device_ms=f"{chunk_ms:.2f}",
        traced_chunk_device_busy_ms=f"{traced_chunk_ms:.2f}",
        nan_scan_pct_of_chunk=f"{100 * nan_ms / traced_chunk_ms:.4f}",
        nan_scan_bound_ms=f"{pool_bytes(sess) / HBM_BYTES_PER_S * 1e3:.4f}",
        verify_host_ms_per_call=f"{np.mean([v[0] for v in verify]):.3f}",
        verify_pages_per_call=f"{np.mean([v[1] for v in verify]):.2f}",
        verify_calls=len(verify),
        page_read_device_ms_per_page=f"{read_ms / len(stamped):.4f}",
        digest_host_ms_per_page=f"{digest_ms:.4f}",
        page_bytes=page_bytes,
        recover_wedged_ms=f"{recov[0][0] * 1e3:.1f}",
        first_poll_after_recover_ms=f"{recov[0][1] * 1e3:.1f}",
        captures=sess.captures)
    if nan_ms >= 0.01 * traced_chunk_ms:
        raise AssertionError(f"chaos faults: the NaN scan takes {nan_ms:.3f}"
                             f" ms, >= 1% of a chunk's {traced_chunk_ms:.1f}")
    del sess
    return prog, want


def pool_bytes(sess) -> int:
    return sum(c.numel() * c.element_size()
               for c in sess.state["cache"].values())


def chaos_preempt(cluster, params, reqs):
    """Part 2: a private-cache session with preemption: eight bulk
    requests fill the 8 slots, a latency request arrives after the first
    poll and takes the slot of the lowest-priority one, whose rows are
    snapshotted on the card and restored when a slot frees. The snapshot
    must equal the slot's rows and the restore must write them back bit
    for bit; every request's tokens equal a run without preemption. The
    25% limit is held on what the session paid in the run (a call, the
    host's dispatch included) and reported, not enforced: it is open
    while missed. Warm and graph-replayed times are printed beside it
    (where the time goes: host dispatch against device copies)."""
    bulk = [(p, n) for p, n in reqs[:8]]
    classes = ("throughput", "best_effort")
    late = [(reqs[8][0], reqs[8][1], "latency")]
    results, times = {}, {"snap": [], "restore": [], "bytes": []}
    for preempt in (True, False):
        prog = chaos_program(cluster, preempt=preempt)
        sess = prog.open(params=params)
        snap_fn, restore_fn = sess._snapshot_fn, sess._restore_fn

        def snapshot(state, slot):
            rows, ms = ev_ms(lambda: snap_fn(state, slot))
            live = {k: state[k][slot] for k in rows if k != "cache"}
            live["cache"] = {k: c[:, slot] for k, c in
                             state["cache"].items()}
            if not same_bits(rows, live):
                raise AssertionError("chaos preempt: the snapshot differs "
                                     "from the slot's rows")
            times["snap"].append(ms)
            times["bytes"].append(sum(t.numel() * t.element_size()
                                      for t in _leaves(rows)))
            return rows

        def restore(state, slot, rows):
            _, ms = ev_ms(lambda: restore_fn(state, slot, rows))
            live = {k: state[k][slot] for k in rows if k != "cache"}
            live["cache"] = {k: c[:, slot] for k, c in
                             state["cache"].items()}
            if not same_bits(rows, live):
                raise AssertionError("chaos preempt: the restored slot "
                                     "differs from its snapshot")
            times["restore"].append(ms)
            return state

        sess._snapshot_fn, sess._restore_fn = snapshot, restore
        handles = [sess.submit(p, n, klass=classes[i % 2])
                   for i, (p, n) in enumerate(bulk)]
        sess.poll()
        handles.append(sess.submit(*late[0][:2], klass="latency"))
        sess.drain()
        results[preempt] = ([h.result() for h in handles],
                            sess.stats()["preemptions"])
        if preempt:
            # steady state, slot 0: 20 snapshots and 20 restores back to
            # back between CUDA events (the host's dispatch of ~12 small
            # operations a call included), then the same 20 captured as
            # a CUDA graph and replayed: the device's time alone, which
            # the session (eager) never gets
            rows = snap_fn(sess.state, 0)
            torch.cuda.synchronize()
            for key, fn in (("snap", lambda: snap_fn(sess.state, 0)),
                            ("restore", lambda: restore_fn(sess.state, 0,
                                                           rows))):
                def twenty(fn=fn):
                    for _ in range(20):
                        fn()

                twenty()
                times["warm_" + key] = ev_ms(twenty)[1] / 20
                times["graph_" + key] = graph_ms(twenty, iters=1) / 20
        del sess, prog
    (toks, n_pre), (plain, n_plain) = results[True], results[False]
    if n_pre < 1 or n_plain != 0 or any(
            not np.array_equal(a, b) for a, b in zip(toks, plain)):
        raise AssertionError(f"chaos preempt: {n_pre} preemptions; tokens "
                             f"equal to the run without: "
                             f"{[np.array_equal(a, b) for a, b in zip(toks, plain)]}")
    slot_bytes = times["bytes"][0]
    bound_ms = 2 * slot_bytes / HBM_BYTES_PER_S * 1e3
    snap_ms, rest_ms = np.mean(times["snap"]), np.mean(times["restore"])
    g_snap, g_rest = times["graph_snap"], times["graph_restore"]
    limit_met = bound_ms >= 0.25 * max(snap_ms, rest_ms)
    log("chaos", part="preempt", gpu=f"'{gpu_line()}'", preemptions=n_pre,
        tokens_equal_no_preempt=True, snapshots_bit_identical=True,
        slot_bytes=slot_bytes, bound_ms=f"{bound_ms:.4f}",
        in_run_snapshot_ms=f"{snap_ms:.4f}",
        in_run_restore_ms=f"{rest_ms:.4f}",
        in_run_snapshot_pct_of_bound=f"{100 * bound_ms / snap_ms:.1f}",
        in_run_restore_pct_of_bound=f"{100 * bound_ms / rest_ms:.1f}",
        limit_25pct_met=limit_met,
        warm_snapshot_ms=f"{times['warm_snap']:.4f}",
        warm_restore_ms=f"{times['warm_restore']:.4f}",
        graph_snapshot_ms=f"{g_snap:.4f}", graph_restore_ms=f"{g_rest:.4f}",
        graph_snapshot_pct_of_bound=f"{100 * bound_ms / g_snap:.1f}",
        graph_restore_pct_of_bound=f"{100 * bound_ms / g_rest:.1f}",
        warm_snapshot_pct_of_bound=f"{100 * bound_ms / times['warm_snap']:.1f}",
        warm_restore_pct_of_bound=f"{100 * bound_ms / times['warm_restore']:.1f}")


def chaos_durable(prog, params, reqs, want, root):
    """Part 3: the fault-free workload without durability and with the
    journal alone, alternated three times after a warm-up run (a first
    session after other programs runs slow), then with a snapshot every
    4 chunks: tokens equal the fault-free run's. Every rate is end to
    end (`e2e_rate`: the journal's commits and the snapshots' writes
    happen after a chunk's wait, so only the drive's wall sees them),
    and a configuration's rate is the median of its runs (a run's host
    time varies by several percent); journal only must keep 95% of the
    rate without durability. Commit (fsync) and snapshot costs."""
    rates = {}
    runs = ([("warm-up", None)] + [("none", None), ("journal", None)] * 3
            + [("snapshots", 4)])
    for i, (tag, snap) in enumerate(runs):
        d = root / f"durable-{tag}-{i}"
        durable = tag in ("journal", "snapshots")
        sess = (prog.open(params=params, durable_dir=d, snapshot_every=snap)
                if durable else prog.open(params=params))
        commits, snaps = [], []
        if durable:
            commit, save = sess._journal.commit, sess._save_snapshot

            def timed_commit(commit=commit, **kw):
                t0 = time.perf_counter()
                commit(**kw)
                commits.append((time.perf_counter() - t0) * 1e3)

            def timed_save(save=save):
                t0 = time.perf_counter()
                save()
                snaps.append(time.perf_counter() - t0)

            sess._journal.commit = timed_commit
            sess._save_snapshot = timed_save
        handles, wall, got, _ = chaos_drive(sess, reqs)
        st = sess.stats()
        sess.close()
        if any(not np.array_equal(h.result(), w)
               for h, w in zip(handles, want)):
            raise AssertionError(f"chaos durable {tag}: tokens differ")
        rate = e2e_rate(got, wall)
        rates.setdefault(tag, []).append(rate)
        files = sorted((d / "snapshots").glob("session-*.ckpt")) \
            if snap else []
        mb = files[-1].stat().st_size / 1e6 if files else 0.0
        fields = {}
        if durable:
            fields = dict(
                commits=len(commits), commit_ms=f"{np.mean(commits):.3f}",
                commit_ms_total=f"{np.sum(commits):.1f}",
                journal_bytes=st["durability"]["journal_bytes"],
                journal_events=st["durability"]["journal_events"],
                snapshots=len(snaps),
                snapshot_ms=(f"{np.mean(snaps) * 1e3:.1f}" if snaps
                             else "none"),
                snapshot_mb=f"{mb:.1f}",
                snapshot_write_mb_per_s=(f"{mb / np.mean(snaps):.1f}"
                                         if snaps else "none"))
        log("chaos", part="durable", mode=tag, run=i, tokens_equal=True,
            e2e_tokens_per_s=f"{rate:.2f}", wall_s=f"{wall:.3f}",
            stall_pct=f"{st['stall']['stall_pct']:.2f}", **fields)
        del sess
    rate = {k: float(np.median(v)) for k, v in rates.items()}
    base = rate["none"]
    ratios = {k: rate[k] / base for k in ("journal", "snapshots")}
    log("chaos", part="durable", fault_free_e2e_tokens_per_s=f"{base:.2f}",
        journal_e2e_tokens_per_s=f"{rate['journal']:.2f}",
        journal_ratio=f"{ratios['journal']:.4f}",
        snapshots_ratio=f"{ratios['snapshots']:.4f}",
        limit_journal_within_5pct=ratios["journal"] >= 0.95)
    if ratios["journal"] < 0.95:
        raise AssertionError(f"chaos durable: journal-only "
                             f"{rate['journal']:.2f} tokens/s end to end, "
                             f"under 95% of {base:.2f}")


def chaos_scrub(cluster, params, reqs, want):
    """Part 3b: what the page checksums cost the serve phase's session
    (paged, prefix cache, no NaN scan), end to end: the fault-free
    workload with the default scrub (2 pages a chunk) and with none, in
    the order 2, 0, 0, 2. Both stamp the pages they publish. The host
    time of every page readback and digest (stamping and verifying) is
    summed beside the wall."""
    from repro_torch.runtime import serve_loop

    digests = serve_loop.page_digests
    rates = {}
    for i, scrub in enumerate((2, 0, 0, 2)):
        prog = chaos_program(cluster, paged=True, page_size=16,
                             scrub_pages=scrub)
        sess = prog.open(params=params)
        spent = {"read": 0.0, "digest": 0.0, "pages": 0}
        read = sess._page_read_fn

        def timed_read(state, pages, read=read):
            t0 = time.perf_counter()
            out = read(state, pages)
            spent["read"] += time.perf_counter() - t0
            spent["pages"] += len(pages)
            return out

        def timed_digests(arrs, n):
            t0 = time.perf_counter()
            out = digests(arrs, n)
            spent["digest"] += time.perf_counter() - t0
            return out

        sess._page_read_fn = timed_read
        serve_loop.page_digests = timed_digests
        try:
            handles, wall, got, _ = chaos_drive(sess, reqs)
        finally:
            serve_loop.page_digests = digests
        if any(not np.array_equal(h.result(), w)
               for h, w in zip(handles, want)):
            raise AssertionError(f"chaos scrub {scrub}: tokens differ")
        st = sess.stats()
        rate = e2e_rate(got, wall)
        rates.setdefault(scrub, []).append(rate)
        host = spent["read"] + spent["digest"]
        log("chaos", part="scrub", scrub_pages=scrub, run=i,
            e2e_tokens_per_s=f"{rate:.2f}", wall_s=f"{wall:.3f}",
            stall_pct=f"{st['stall']['stall_pct']:.2f}",
            pages_read=spent["pages"],
            read_host_ms=f"{spent['read'] * 1e3:.1f}",
            digest_host_ms=f"{spent['digest'] * 1e3:.1f}",
            checksum_pct_of_wall=f"{100 * host / wall:.2f}")
        del sess, prog
    with_scrub, without = np.mean(rates[2]), np.mean(rates[0])
    log("chaos", part="scrub", e2e_tokens_per_s_scrub2=f"{with_scrub:.2f}",
        e2e_tokens_per_s_scrub0=f"{without:.2f}",
        scrub_cost_pct=f"{100 * (1 - with_scrub / without):.2f}")


def chaos_crash(prog, params, reqs, want, root, crash_at: int = 4):
    """Part 4: a scripted crash at the end of chunk `crash_at`'s poll
    (`SessionCrashed` in this process), then `program.restore`, with a
    snapshot every 4 chunks and journal only. The tokens committed before
    the crash and those delivered after the restore are the fault-free
    run's, each once; the restore's counters are the ones the journal and
    the snapshot call for."""
    from repro_torch.runtime import FaultPlan, SessionCrashed
    from repro_torch.runtime.journal import read_events, replay

    for tag, snap in (("snapshots", 4), ("journal", None)):
        d = root / f"crash-{tag}"
        sess = prog.open(params=params, durable_dir=d, snapshot_every=snap,
                         faults=FaultPlan().crash(at_chunk=crash_at))
        delivered = {}
        for i, (p, n) in enumerate(reqs):
            sess.submit(p, n, klass=CHAOS_CLASSES[i % 4])
        try:
            while sess.busy:
                for h, toks, _ in sess.poll():
                    delivered.setdefault(h.id, []).extend(
                        int(t) for t in toks)
            raise AssertionError("chaos crash: the crash never fired")
        except SessionCrashed:
            pass
        del sess
        summary = replay(read_events(d / "journal.jsonl"))
        committed = {rid: list(r.committed)
                     for rid, r in summary.requests.items()}
        if any(committed[rid][:len(t)] != t for rid, t in delivered.items()):
            raise AssertionError(f"chaos crash {tag}: a token was handed "
                                 f"out before its commit")
        in_flight = [rid for rid, r in summary.requests.items()
                     if r.status is None]
        snap_tokens = {}
        files = sorted((d / "snapshots").glob("session-*.ckpt")) \
            if snap else []
        if files:
            with open(files[-1], "rb") as f:
                meta = json.loads(f.readline())["meta"]
            snap_tokens = {int(q["rid"]): len(q["tokens"])
                           for q in meta["requests"]
                           if q["state"] == "running"}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess = prog.restore(d, params=params)
        final = {rid: list(t) for rid, t in committed.items()}
        for h, toks, _ in sess.stream():
            final.setdefault(h.id, []).extend(int(t) for t in toks)
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t0
        du = sess.stats()["durability"]
        sess.close()
        expect = {"replayed_requests": len(in_flight),
                  "recovered_terminal": len(summary.requests)
                  - len(in_flight),
                  "deduped_tokens": sum(len(committed[r])
                                        - snap_tokens.get(r, 0)
                                        for r in in_flight),
                  "restored_step": (int(files[-1].stem.split("-")[1])
                                    if files else None)}
        got = {k: du[k] for k in expect}
        exact = all(final.get(i, []) == w.tolist() for i, w in enumerate(want))
        if not exact or got != expect:
            raise AssertionError(f"chaos crash {tag}: exactly once {exact}, "
                                 f"counters {got} (want {expect})")
        log("chaos", part="crash", mode=tag, crash_at=crash_at,
            exactly_once=True, tokens_equal=True,
            committed_pre_crash=sum(len(t) for t in committed.values()),
            **{k: got[k] for k in expect},
            restore_s=f"{du['restore_s']:.4f}",
            restore_and_drain_s=f"{drain_s:.2f}")
        del sess


def chaos_drill() -> None:
    """Part 5: examples/serve_chaos_torch.py --crash on the card: its child
    serves xlstm-125m-smoke with the journal and snapshots on and SIGKILLs
    itself; the parent restores and checks exactly-once delivery."""
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable,
                           str(root / "examples" / "serve_chaos_torch.py"),
                           "--crash"], capture_output=True, text=True,
                          timeout=600, cwd=root)
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("# chaos-crash:")), "")
    if (proc.returncode != 0 or "killed -9" not in proc.stdout
            or "bit_identical=yes exactly_once=yes" not in line):
        raise AssertionError(f"chaos drill: rc {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    log("chaos", part="drill", rc=proc.returncode, child_sigkilled=True,
        wall_s=f"{time.perf_counter() - t0:.1f}",
        result=f"'{line[len('# chaos-crash: '):]}'")


def chaos_phase(launches, params) -> dict:
    """The robustness and durability layer on qwen3-14b's graphed paged
    session at full width (see the module docstring's chaos line). The
    counts are set to 0 before the first part and read after the last:
    rmsnorm_matmul and matmul_residual_add must have launched (each
    session's eager first step and capture), no plain version on the
    card."""
    import tempfile

    from repro_torch.cluster.session import Cluster

    cluster = Cluster("qwen3-14b")
    reqs = serve_requests(cluster.arch.vocab)
    launches.reset_counts()
    t0 = time.perf_counter()
    prog, want = chaos_faults(cluster, params, reqs)
    chaos_preempt(cluster, params, reqs)
    with tempfile.TemporaryDirectory() as tmp:
        chaos_durable(prog, params, reqs, want, Path(tmp))
        chaos_scrub(cluster, params, reqs, want)
        chaos_crash(prog, params, reqs, want, Path(tmp))
    counts = _check_counts(launches, "chaos",
                           ("rmsnorm_matmul", "matmul_residual_add"))
    chaos_drill()
    log("chaos", seconds=f"{time.perf_counter() - t0:.1f}",
        wrapper_launches=_nonzero(counts),
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.1f}")
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------------------
# full-width models: bounds, weights on the card, the prefill and decode
# checks (mixtral-8x7b and the mixed-kind archs)
# ----------------------------------------------------------------------------

def weight_bytes(params, rows: int) -> int:
    """The bytes of every weight, the token embedding counted only at the
    `rows` rows a run reads."""
    emb = params["tok_embed"]
    total = sum(t.numel() * t.element_size() for t in _leaves(params))
    return total - emb.numel() * emb.element_size() \
        + rows * emb.shape[1] * emb.element_size()


def prefill_bound(cfg, params, B: int, S: int,
                  n_img: int = 0) -> tuple[float, str, float]:
    """The least time of a prefill of B x S tokens (ms, what sets it,
    TFLOP of bf16 products): every weight read once (the token embedding
    at the prompt's rows), the image embeddings read, per layer the
    products its kind makes over the keys this run needs (causal, and
    within the window), the MoE expert SwiGLU over the E x C capacity rows
    the batched product computes (C = int(K * T * 1.25 / E)), the f32
    router and the mLSTM's and sLSTM's f32 products at the f32 peak (the
    mLSTM chunks' causal halves), and the last tokens' vocabulary
    projection. Elementwise work (the scans, norms, gates) is not
    counted."""
    from repro_torch.models import steps

    d, H, KV, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, \
        cfg.d_ff
    r, di, T = cfg.lru_width, cfg.n_heads * cfg.hd, B * S
    ffn = 3 * 2.0 * T * d * f

    def pairs(w):
        return sum(min(i + 1, w) for i in range(S))

    c = min(cfg.attn_chunk, S)
    bf16 = f32 = 0.0
    for kind in steps.layer_kinds(cfg):
        if kind in ("attn", "local_attn", "attn_moe"):
            bf16 += (2.0 * T * d * (H + 2 * KV) * hd
                     + 4.0 * B * H * hd * pairs(cfg.window or S)
                     + 2.0 * T * H * hd * d)
            if kind != "attn_moe":
                bf16 += ffn
            else:
                E = cfg.n_experts
                C = max(int(cfg.top_k * T * cfg.capacity_factor / E), 1)
                bf16 += 3 * 2.0 * E * C * d * f
                f32 += 2.0 * T * d * E
        elif kind == "cross":
            bf16 += (2.0 * T * d * H * hd + 2.0 * B * n_img * d * 2 * KV * hd
                     + 4.0 * B * H * hd * S * n_img + 2.0 * T * H * hd * d
                     + ffn)
        elif kind == "rglru":
            bf16 += 2 * 2.0 * T * d * r + 2 * 2.0 * T * r * r \
                + 2.0 * T * r * d + ffn
        elif kind == "mlstm":
            bf16 += 2.0 * T * d * 2 * di + 3 * 2.0 * T * di * di \
                + 2.0 * T * di * d
            f32 += 2 * 2.0 * T * di * H + (S // c) * (
                3 * 2.0 * B * H * hd * c * (c + 1) / 2
                + 2 * 2.0 * B * c * H * hd * hd)
        elif kind == "slstm":
            bf16 += 2.0 * T * d * 4 * di + 2.0 * T * di * d
            f32 += 2.0 * T * 4 * H * hd * hd
    bf16 += 2.0 * B * d * cfg.vocab
    moved = weight_bytes(params, T) + B * n_img * d * 2 + T * 8 + B * 4
    t_ops = bf16 / BF16_FLOPS_PER_S + f32 / F32_FLOPS_PER_S
    t_bytes = moved / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", bf16 / 1e12)


def decode_bound(cfg, params, cache, B: int, live: float) -> tuple[float,
                                                                   str]:
    """The least time of one decode step (ms, what sets it): every weight
    read once (the token embedding at B rows) and its products' operations;
    per layer the K/V rows of `live` positions a slot read and one
    written, the recurrent states read and written, the cross blocks'
    image K/V read."""
    from repro_torch.models import steps
    from repro_torch.models.blocks import BLOCKS

    moved = weight_bytes(params, B)
    for prefix, kind, _ in steps.cache_groups(cfg):
        for leaf, spec in BLOCKS[kind]["cache"](cfg, B, 1).items():
            c = cache[prefix + leaf]
            if steps._pageable_leaf(spec):
                rows = min(int(live) + 1, c.shape[2])
                moved += c[:, :, :rows].numel() * c.element_size()
            else:
                moved += c.numel() * c.element_size() * (
                    1 if kind == "cross" else 2)
    weights = sum(t.numel() for t in _leaves(params)) \
        - params["tok_embed"].numel()
    return bound(moved, 2.0 * B * weights)


def init_on_card(tag: str, cfg):
    """Random weights from a seeded generator on the card (the cross
    gates opened), and a line with their count and size."""
    from repro_torch.models import steps

    gc.collect()                      # the last model's weights go first
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = open_gates(steps.init_params(cfg, 0, device="cuda"))
    torch.cuda.synchronize()
    log(tag, arch=cfg.name, layers=cfg.n_layers,
        params=sum(t.numel() for t in _leaves(params)),
        gb=f"{torch.cuda.memory_allocated() / 1e9:.1f}",
        init_s=f"{time.perf_counter() - t0:.1f}")
    return params


def prefill_check(launches, tag: str, cfg, params, batch, must,
                  want: dict, bnd, **fields) -> dict:
    """make_prefill_step under "fused": eagerly, counted and traced
    (`_counted_and_traced`: the counts must equal `want`, other kernels
    0), its token equal to the argmax of finite logits of the right shape
    (and a finite MoE aux loss); then as a CUDA graph (`graph_replay`).
    Logs the times beside the bound (and `fields`) and the six device
    kernels with the most time; returns the eager counts."""
    from repro_torch.cluster.policy import use_policy
    from repro_torch.models import steps

    prefill = steps.make_prefill_step(cfg, policy="fused")
    prefill.eager(params, batch)                          # warm-up
    counted, tok, dt, top = _counted_and_traced(
        launches, f"{tag}_prefill", lambda: prefill.eager(params, batch),
        must)
    if counted != {n: 0 for n in counted} | want:
        raise AssertionError(f"{tag}: prefill launches {counted}, want "
                             f"{want}")
    with torch.inference_mode():
        with use_policy("fused"):
            hidden, aux = steps.forward(cfg, params, batch["tokens"],
                                        cross_embeds=batch.get("img_embeds"))
        lg = steps.logits(params, hidden[:, -1])
    B = batch["tokens"].shape[0]
    if not torch.isfinite(lg).all() or tuple(lg.shape) != (B, cfg.vocab) \
            or not torch.isfinite(torch.as_tensor(aux)):
        raise AssertionError(f"{tag}: logits or aux not finite or "
                             f"misshapen")
    if cfg.n_experts:
        fields["aux"] = f"{float(aux):.4f}"
    if not torch.equal(lg.argmax(-1).to(torch.int32), tok):
        raise AssertionError(f"{tag}: argmax disagrees with the step")
    del hidden, lg
    bms, by, tflop = bnd
    log(tag, part="prefill", B=B, S=batch["tokens"].shape[1], **fields,
        policy="fused", eager_ms=f"{dt * 1e3:.1f}",
        tokens=",".join(map(str, tok.tolist()[:8])),
        launches=_nonzero(counted),
        traced_device_ms=f"{sum(r[1] for r in top):.1f}",
        bound_ms=f"{bms:.2f}", bound_by=by, tflop=f"{tflop:.2f}")
    for key, ms, n in top[:6]:
        log(tag, part="prefill", kernel=f"'{key[:70]}'",
            device_ms=f"{ms:.2f}", launches=n)
    graph = graph_replay(launches, f"{tag}_prefill",
                         lambda: prefill(params, batch), counted, tok)
    log(tag, part="prefill", mode="cuda_graph", **graph_fields(graph, dt),
        bound_ms=f"{bms:.2f}")
    del prefill
    torch.cuda.empty_cache()
    return counted


def serve_program_check(launches, tag: str, cfg, params, *, B: int,
                        S: int, P: int, NEW: int) -> dict:
    """`Cluster.compile(ServeProgram(batch=B, max_seq=S, max_new=NEW))`
    under "fused" from a B x P seeded prompt at chunk 16 and chunk 1, each
    run twice (equal tokens; the counts set to 0 before the first run, no
    plain version on the card): tokens equal across chunks, in range,
    every cache leaf finite, the K/V leaves `decode_cache_len` rows (a
    window's, rolling, where S passes it); tokens/s a slot, p50, stall_pct and the
    step's least time; then one eager step's launches and one steady
    chunk replayed and traced (16 x the eager step's launches), its device
    busy time and top kernels. Returns the traced chunk's launches."""
    from repro_torch.cluster.session import Cluster, ServeProgram
    from repro_torch.models import steps
    from repro_torch.models.blocks import BLOCKS

    cluster = Cluster(cfg)
    prompt = np.random.default_rng(17).integers(1, cfg.vocab, (B, P))
    runs, progs = {}, {}
    for chunk in (16, 1):
        with cluster.policy("fused"):
            prog = cluster.compile(ServeProgram(batch=B, max_seq=S,
                                                max_new=NEW, chunk=chunk))
        launches.reset_counts()
        first = prog.run(params=params, prompt=prompt)
        _check_counts(launches, f"{tag} decode chunk {chunk}", ())
        again = prog.run(params=params, prompt=prompt)
        if not np.array_equal(first["tokens"], again["tokens"]):
            raise AssertionError(f"{tag}: chunk {chunk} reruns differ")
        runs[chunk], progs[chunk] = again, prog
    toks = runs[16]["tokens"]
    if not np.array_equal(toks, runs[1]["tokens"]):
        raise AssertionError(f"{tag}: chunk 16 and chunk 1 tokens differ")
    if toks.shape != (B, 1 + NEW) or toks.min() < 0 \
            or toks.max() >= cfg.vocab:
        raise AssertionError(f"{tag}: decode tokens {toks.shape}")
    # K/V leaves hold decode_cache_len rows: the window's, where max_seq
    # passes it (the cache rolls)
    rows = steps.decode_cache_len(cfg, S)
    kv = [prefix + leaf for prefix, kind, _ in steps.cache_groups(cfg)
          for leaf, spec in BLOCKS[kind]["cache"](cfg, B, 1).items()
          if steps._pageable_leaf(spec)]
    for prog in progs.values():
        for name, c in prog.cache.items():
            if not torch.isfinite(c).all():
                raise AssertionError(f"{tag}: non-finite {name} cache")
            if name in kv and c.shape[2] != rows:
                raise AssertionError(f"{tag}: the {name} cache holds "
                                     f"{c.shape[2]} rows, not {rows}")

    prog = progs[16]
    with torch.inference_mode():
        launches.reset_counts()
        prog.decode.eager(params, prog.cache, {
            "tokens": torch.as_tensor(toks[:, -1:], device="cuda"),
            "pos": P + NEW})
        torch.cuda.synchronize()
    per_step = {n: c for n, c in _check_counts(launches, f"{tag} step",
                                               ()).items() if c}
    eng = prog.engine

    def one_chunk():
        launches.reset_counts()
        eng.generate(params, prog.cache, toks[:, -1:], 16,
                     start_pos=P + NEW + 1)

    prof = traced(f"{tag}_chunk", one_chunk)
    traced_chunk = launches.traced_launches(prof)
    seen = {n: c for n, c in traced_chunk.items() if c}
    if seen != {n: 16 * c for n, c in per_step.items()}:
        raise AssertionError(f"{tag}: a traced chunk launched {seen}; one "
                             f"eager step {per_step}")
    busy = device_busy_ms(prof)
    chunk_wall = np.mean([d for d, _ in eng.chunk_latencies]) * 1e3
    dbms, dby = decode_bound(cfg, params, prog.cache, B, P + NEW / 2)
    top = sorted(((e.key, e.device_time_total / 1e3 / 16, e.count // 16)
                  for e in device_events(prof) if e.device_time_total > 0),
                 key=lambda r: -r[1])
    for k, r in runs.items():
        st = r["stats"]
        log(tag, part="decode", B=B, prompt=P, max_new=NEW, max_seq=S,
            **({"cache_rows": rows} if kv else {}), chunk=k, policy="fused",
            tokens_per_s_per_slot=f"{st['tokens_per_s_per_slot']:.2f}",
            tokens_per_s=f"{B * st['tokens_per_s_per_slot']:.2f}",
            p50_ms=f"{st['p50_ms']:.2f}", p99_ms=f"{st['p99_ms']:.2f}",
            stall_pct=f"{st['stall']['stall_pct']:.3f}",
            host_syncs=st["stall"]["host_syncs"],
            step_bound_ms=f"{dbms:.2f}", step_bound_by=dby)
    log(tag, part="decode", chunk=16,
        traced_chunk_device_busy_ms=f"{busy:.2f}",
        traced_chunk_device_ms_per_step=f"{busy / 16:.2f}",
        traced_chunk_wall_ms=f"{chunk_wall:.2f}",
        traced_launches_per_chunk=json.dumps(seen).replace(" ", ""),
        tokens_equal_chunk16_chunk1=True, caches_finite=True,
        decode_tokens_slot0=",".join(map(str, toks[0, :17].tolist())),
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.1f}")
    for key, ms, n in top[:6]:
        log(tag, part="decode", kernel=f"'{key[:70]}'",
            ms_per_step=f"{ms:.3f}", launches_per_step=n)
    del runs, progs, prog, eng, cluster
    torch.cuda.empty_cache()
    return traced_chunk


# ----------------------------------------------------------------------------
# mixtral-8x7b at full width: the MoE block, banded attention, rolling caches
# ----------------------------------------------------------------------------

MOE_LAYERS = 8            # of mixtral-8x7b's 32: ~23.7 GB of bf16 weights


def moe_cfg():
    from repro_torch.configs import get
    return dataclasses.replace(get("mixtral-8x7b"), n_layers=MOE_LAYERS)


def moe_phase(launches) -> tuple[dict, dict]:
    """mixtral-8x7b at full width (d_model 4096, 32 / 8 heads of 128, 8
    experts top-2, d_ff 14336, window 4096, vocab 32000), 8 of its 32
    layers, random weights from a seeded generator on the card, under
    "fused". The prefill (B=1, S=8192: the window binds, so attention runs
    the banded schedule, chunk 1024, 5 bands) eagerly, counted and traced:
    rmsnorm_matmul 3 times a layer (q, k, v), matmul_residual_add once (the
    out-projection), no other kernel and no plain version on the card (the
    experts are plain bf16 products, as the reference's einsums are); then
    as a CUDA graph (`prefill_check`). Then `ServeProgram(batch=8,
    max_seq=8192, max_new=64)` from an 8 x 32 seeded prompt at chunk 16 and
    chunk 1 (rolling private caches of 4096 rows: max_seq passes the
    window), each run twice: equal tokens, finite caches, tokens/s a slot,
    p50, stall_pct, one steady chunk's traced device busy time
    (`serve_program_check`). Returns the prefill's counts and the traced
    chunk's."""
    from repro_torch.models import attention as attn_lib

    cfg = moe_cfg()
    S = 8192
    params = init_on_card("moe", cfg)
    schedule = attn_lib.resolve_schedule(S, window=cfg.window,
                                         chunk=cfg.attn_chunk,
                                         schedule=cfg.attn_schedule)
    if schedule != "banded":
        raise AssertionError(f"moe: S={S} takes {schedule}, not banded")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab, (1, S))).cuda()}
    counted = prefill_check(
        launches, "moe", cfg, params, batch,
        ("rmsnorm_matmul", "matmul_residual_add"),
        {"rmsnorm_matmul": 3 * cfg.n_layers,
         "matmul_residual_add": cfg.n_layers},
        prefill_bound(cfg, params, 1, S), schedule=schedule,
        chunk=cfg.attn_chunk,
        bands=min(cfg.window // cfg.attn_chunk + 1, S // cfg.attn_chunk))
    del batch
    traced_chunk = serve_program_check(launches, "moe", cfg, params, B=8,
                                       S=S, P=32, NEW=64)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counted, traced_chunk


# ----------------------------------------------------------------------------
# the mixed-kind archs: recurrentgemma-9b, xlstm-125m, llama-3.2-vision-90b
# ----------------------------------------------------------------------------

VLM_LAYERS = 10           # of llama-3.2-vision-90b's 100: two periods of
#                           4 attn + 1 cross, ~21.3 GB of bf16 weights


def session_check(launches, tag: str, cfg, params) -> None:
    """A non-paged ServeSessionProgram(slots=8, max_seq=256,
    max_prompt=64, chunk=16) under "fused" over `serve_requests`' 12
    requests (slots refilled, their recurrent state zeroed at admission):
    the session step replayed as a CUDA graph (the counts set to 0 just
    before the requests go in: rmsnorm_matmul and matmul_residual_add
    must launch, through the eager first step and the capture), then run
    eagerly from Python; tokens equal, every request its length, the
    caches finite."""
    from repro_torch.cluster.session import Cluster, ServeSessionProgram
    from repro_torch.models import steps
    from repro_torch.runtime import engine

    reqs = serve_requests(cfg.vocab)
    spec = ServeSessionProgram(slots=8, max_seq=256, max_prompt=64,
                               chunk=16, paged=False)
    cluster = Cluster(cfg)
    results = {}
    for mode in ("cuda_graph", "eager"):
        with cluster.policy("fused"):
            prog = cluster.compile(spec)
        if mode == "eager":
            prog._chunk_fn = engine.session_chunk_fn(
                steps.make_decode_step(cfg, max_seq=spec.max_seq,
                                       policy="fused"),
                spec.chunk, eos_id=spec.eos_id, cuda_graph=False)
        sess = prog.open(params=params)
        torch.cuda.synchronize()
        launches.reset_counts()
        t0 = time.perf_counter()
        handles = [sess.submit(p, n) for p, n in reqs]
        stats = sess.drain()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _check_counts(launches, f"{tag} session",
                               ("rmsnorm_matmul", "matmul_residual_add"))
        for h, (_, n) in zip(handles, reqs):
            if not (h.result().size == n
                    or (h.hit_eos and h.result().size <= n)):
                raise AssertionError(f"{tag}: request {h.id} "
                                     f"{h.result().size} of {n}")
        for name, c in sess.state["cache"].items():
            if not torch.isfinite(c).all():
                raise AssertionError(f"{tag}: non-finite {name} cache")
        results[mode] = [h.result() for h in handles]
        log(tag, part="session", mode=mode, slots=8, paged=False,
            requests=len(reqs), wall_s=f"{dt:.2f}",
            tokens_per_s=f"{stats['tokens_per_s']:.2f}",
            emitted=stats["emitted_total"],
            ttft_p50_ms=f"{stats['ttft_ms']['p50']:.1f}",
            occupancy_pct=f"{stats['occupancy_pct']:.1f}",
            stall_pct=f"{stats['stall']['stall_pct']:.2f}",
            wrapper_launches=_nonzero(counts))
        del sess, prog
    same = all(np.array_equal(a, b) for a, b in zip(results["cuda_graph"],
                                                    results["eager"]))
    if not same:
        raise AssertionError(f"{tag}: the session's graph and eager tokens "
                             f"differ")
    log(tag, part="session", tokens_equal_graph_eager=True)
    torch.cuda.empty_cache()


def split_prefill(cfg, S: int) -> None:
    """Two of the prefill's plain parts alone, at its shapes, with seeded
    inputs (CUDA events, mean of 10): one rglru layer's doubling scan over
    (1, S, lru_width) f32 (`blocks.linear_scan`, the two input copies it
    consumes timed apart and taken off) and one local_attn layer's banded
    attention (16 heads of 256 over one KV head, window 2048, chunk
    1024), each also times its layers."""
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import blocks, steps

    timer = Timer()
    g = torch.Generator(device="cuda").manual_seed(31)
    shape = (1, S, cfg.lru_width)
    a = torch.rand(shape, generator=g, device="cuda")
    b = torch.randn(shape, generator=g, device="cuda")
    copies = timer(lambda: (a.clone(), b.clone()))
    scan = timer(lambda: blocks.linear_scan(a.clone(), b.clone())) - copies
    q = torch.randn((1, S, cfg.n_heads, cfg.hd), generator=g,
                    device="cuda").bfloat16()
    k, v = (torch.randn((1, S, cfg.n_kv_heads, cfg.hd), generator=g,
                        device="cuda").bfloat16() for _ in range(2))
    attn = timer(lambda: attn_lib.attention(
        q, k, v, n_kv=cfg.n_kv_heads, window=cfg.window,
        chunk=cfg.attn_chunk, schedule=cfg.attn_schedule))
    kinds = steps.layer_kinds(cfg)
    log("hybrid", part="split", scan_ms_a_layer=f"{scan:.3f}",
        scan_ms_all=f"{scan * kinds.count('rglru'):.1f}",
        banded_attention_ms_a_layer=f"{attn:.3f}",
        banded_attention_ms_all=f"{attn * kinds.count('local_attn'):.1f}")
    del a, b, q, k, v, timer
    torch.cuda.empty_cache()


def hybrid_phase(launches) -> dict:
    """recurrentgemma-9b at full width and full depth (38 layers: 26
    rglru, 12 local_attn; d_model 4096, 16 heads of 256 over one KV head,
    window 2048, lru_width 4096, geglu d_ff 12288, vocab 256000), random
    weights, under "fused". The prefill (B=1, S=8192: the window binds,
    so attention runs the banded schedule, chunk 1024, 3 bands; the
    recurrence a log-depth doubling scan) eagerly, counted and traced:
    rmsnorm_matmul 3 times a local_attn layer (q, k, v) and twice a layer
    (gate, up), matmul_residual_add once a local_attn layer (out) and once
    a layer (down), nothing else (flash_attention_proj stays off: the
    window), no plain version on the card; then as a CUDA graph. Then
    `ServeProgram(batch=8, max_seq=8192, max_new=64)` from an 8 x 32
    prompt at chunk 16 and chunk 1 (rolling 2048-row local caches, the
    recurrent state in place), and a non-paged session over 12 requests.
    Returns the prefill's counts."""
    from repro_torch.configs import get
    from repro_torch.models import attention as attn_lib

    cfg = get("recurrentgemma-9b")
    S = 8192
    params = init_on_card("hybrid", cfg)
    schedule = attn_lib.resolve_schedule(S, window=cfg.window,
                                         chunk=cfg.attn_chunk,
                                         schedule=cfg.attn_schedule)
    if schedule != "banded":
        raise AssertionError(f"hybrid: S={S} takes {schedule}, not banded")
    n_attn = cfg.n_layers // 3
    batch = {"tokens": torch.from_numpy(np.random.default_rng(19).integers(
        0, cfg.vocab, (1, S))).cuda()}
    counted = prefill_check(
        launches, "hybrid", cfg, params, batch,
        ("rmsnorm_matmul", "matmul_residual_add"),
        {"rmsnorm_matmul": 3 * n_attn + 2 * cfg.n_layers,
         "matmul_residual_add": n_attn + cfg.n_layers},
        prefill_bound(cfg, params, 1, S))
    del batch
    split_prefill(cfg, S)
    serve_program_check(launches, "hybrid", cfg, params, B=8, S=S, P=32,
                        NEW=64)
    session_check(launches, "hybrid", cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counted


def xlstm_phase(launches) -> None:
    """xlstm-125m, the whole config (12 layers: 9 mlstm, 3 slstm; d_model
    768, 4 heads of 192), random weights, under "fused", which its blocks
    do not take (none of them calls a fused op, in the reference as in the
    port): the prefill on B=8, S=512 (the mLSTM in one chunk of 512, the
    sLSTM a sequential scan of 512 steps), eager, traced and as a CUDA
    graph; then ServeProgram(batch=8, max_seq=512, max_new=64) from an 8 x
    32 prompt at chunk 16 and chunk 1."""
    from repro_torch.configs import get

    cfg = get("xlstm-125m")
    B, S = 8, 512
    params = init_on_card("xlstm", cfg)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(23).integers(
        0, cfg.vocab, (B, S))).cuda()}
    prefill_check(launches, "xlstm", cfg, params, batch, (), {},
                  prefill_bound(cfg, params, B, S))
    del batch
    serve_program_check(launches, "xlstm", cfg, params, B=8, S=512, P=32,
                        NEW=64)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def vlm_phase(launches) -> dict:
    """llama-3.2-vision-90b at full width (d_model 8192, 64 / 8 heads of
    128, d_ff 28672, vocab 128256, 1,601 image tokens), 10 of its 100
    layers (two periods of 4 attn + 1 cross), random weights with the
    cross gates open, under "fused": the prefill on B=1, S=512 with 1,601
    seeded image embeddings (cross-attention direct), eagerly, counted and
    traced: flash_attention_proj once an attn layer, rmsnorm_matmul 5
    times (q, k, v, gate, up) and matmul_residual_add once (down) an attn
    layer, the cross layers on the plain route; then as a CUDA graph.
    Then ServeProgram(batch=8, max_seq=256, max_new=64) from an 8 x 32
    prompt at chunk 16 and chunk 1 (the cross K/V: the zero cache, as in
    the reference). Returns the prefill's counts."""
    from repro_torch.configs import get

    cfg = dataclasses.replace(get("llama-3.2-vision-90b"),
                              n_layers=VLM_LAYERS)
    S = 512
    params = init_on_card("vlm", cfg)
    g = torch.Generator(device="cuda").manual_seed(29)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(29).integers(
        0, cfg.vocab, (1, S))).cuda(),
        "img_embeds": torch.randn((1, cfg.n_img_tokens, cfg.d_model),
                                  generator=g, device="cuda").bfloat16()}
    n_attn = VLM_LAYERS - VLM_LAYERS // cfg.cross_every
    counted = prefill_check(
        launches, "vlm", cfg, params, batch, QWEN_FUSED,
        {"flash_attention_proj": n_attn, "rmsnorm_matmul": 5 * n_attn,
         "matmul_residual_add": n_attn},
        prefill_bound(cfg, params, 1, S, cfg.n_img_tokens))
    del batch
    serve_program_check(launches, "vlm", cfg, params, B=8, S=256, P=32,
                        NEW=64)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counted


# ----------------------------------------------------------------------------
# train: qwen3-14b at full width through TrainProgram under "fused"
# ----------------------------------------------------------------------------

TRAIN_LAYERS = 4          # of qwen3-14b's 40: 2.88B parameters, ~46 GB of
                          # train state (bf16 weights, f32 moments and the
                          # f32 gradient accumulator)
TRAIN_B, TRAIN_S = 8, 512  # the global batch: grad_accum 4 microbatches of
                           # 2 x 512 = 1,024 rows
TRAIN_STEPS = 4           # steps through .step, then one chunk of as many
TRAIN_TOL = 2e-2          # relative L2 error of a leaf's gradient between
                          # the kernel route and the "reference" route: two
                          # bf16 computations of a 4-layer model


def train_cfg():
    from repro_torch.configs import get
    return dataclasses.replace(get("qwen3-14b"), n_layers=TRAIN_LAYERS)


def train_launches(cfg, microbatches: int) -> dict:
    """Rows 1-3's launches in a train step's `microbatches` forward passes:
    per layer q, k, v, gate and up (rmsnorm_matmul), the attention
    (flash_attention_proj) and down (matmul_residual_add), each twice
    under cfg.remat "nothing": the forward, then the recompute in
    backward; the backward itself launches none of them."""
    n = 2 * cfg.n_layers * microbatches
    return {"rmsnorm_matmul": 5 * n, "flash_attention_proj": n,
            "matmul_residual_add": n}


def train_bound(cfg, B: int, S: int, n_params: int) -> tuple[float, float,
                                                             float]:
    """(model FLOPs, its bound in ms, the optimizer's bound in ms) of one
    train step on B x S tokens: 6 x the product parameters (every layer
    weight and the unembedding; the embedding is a gather) x tokens, plus
    the recomputed forward of the layers (2 x their weights x tokens),
    plus causal attention (4 x B x H x hd x S(S+1)/2 a forward, taken
    four times: forward, recompute, and a backward of twice the forward),
    at the bf16 peak; the optimizer reads each parameter (bf16), its f32
    gradient and f32 moments and writes the parameter and moments back:
    24 bytes a parameter at HBM's rate."""
    d, hd, L = cfg.d_model, cfg.hd, cfg.n_layers
    layer = (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
             + cfg.n_heads * hd * d + 3 * d * cfg.d_ff)
    tokens = B * S
    attn = 4 * (4.0 * B * cfg.n_heads * hd * S * (S + 1) / 2) * L
    flops = (6.0 * (L * layer + d * cfg.vocab) * tokens
             + 2.0 * L * layer * tokens + attn)
    return (flops, flops / BF16_FLOPS_PER_S * 1e3,
            24.0 * n_params / HBM_BYTES_PER_S * 1e3)


def _stream_batches(cfg, B: int, S: int, n: int, seed: int = 0) -> list:
    """Batches 0..n-1 of the synthetic stream on the card (the feed
    `CompiledTrain` reads without double buffering)."""
    import itertools

    from repro_torch.data import (BatchSpec, Distributor, Splitter,
                                  SyntheticLMStream, stream_batches)
    stream = SyntheticLMStream(BatchSpec(B, S, cfg.vocab), seed=seed)
    dist = Distributor(["cuda"], Splitter(["cuda"]))
    return list(itertools.islice(stream_batches(stream, dist, "cuda"), n))


def train_phase(launches) -> dict:
    """qwen3-14b trained at full width on the card (part=step, part=grads)
    and a reduced qwen3 through TrainProgram.run() with checkpoint and
    resume (part=run). Returns part=step's counts a step."""
    counts = train_step_part(launches)
    train_grads_part(launches)
    train_run_part(launches)
    return counts


def train_step_part(launches) -> dict:
    """TrainProgram(batch=8, seq=512, steps_per_sync=4) on qwen3-14b at
    full width, TRAIN_LAYERS layers, "fused": TRAIN_STEPS steps through
    `.step` from the seeded initial state, counted (rows 1-3 launched the
    counts `train_launches` gives, no plain version on the card); the
    state made again from the seed and the same batches through `.chunk`
    (one host sync): its losses equal the steps' bit for bit. Then one
    step's halves timed with CUDA events (`accumulate`: the four
    microbatches' forward and backward; `update`: AdamW) beside a
    forward-only pass of the same microbatches, and one step traced (its
    launches equal to the count, the device's busy share, its kernels
    with the most time)."""
    from repro_torch.cluster.policy import use_policy
    from repro_torch.cluster.session import Cluster, TrainProgram
    from repro_torch.models import steps
    from repro_torch.runtime.engine import stack_batches

    cfg = train_cfg()
    k = TRAIN_STEPS
    prog = Cluster(cfg, policy="fused").compile(TrainProgram(
        num_steps=2 * k, batch=TRAIN_B, seq=TRAIN_S, steps_per_sync=k,
        warmup=2))
    batches = _stream_batches(cfg, TRAIN_B, TRAIN_S, k + 1)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = prog.init_state(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    log("train", part="state", arch=cfg.name, layers=cfg.n_layers,
        params=n_params, state_gb=f"{torch.cuda.memory_allocated() / 1e9:.1f}",
        init_s=f"{time.perf_counter() - t0:.1f}",
        grad_accum=cfg.grad_accum, remat=cfg.remat)

    want = {n: c * k for n, c in train_launches(cfg, cfg.grad_accum).items()}
    launches.reset_counts()
    walls, losses = [], []
    for b in batches[:k]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = prog.step(state, b)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
    counted = _check_counts(launches, "train", QWEN_FUSED)
    if {n: counted[n] for n in QWEN_FUSED} != want:
        raise AssertionError(f"train: launches {counted}, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9

    del state
    gc.collect()
    state = prog.init_state(0)
    stacked = stack_batches(batches[:k])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, mc = prog.chunk(state, stacked)
    chunk_losses = mc["loss"].tolist()                # the one host sync
    chunk_wall = time.perf_counter() - t0
    if chunk_losses != losses:
        raise AssertionError(f"train: chunk losses {chunk_losses} against "
                             f"the steps' {losses}")

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    _, _, grads = prog.step.accumulate(state["params"], batches[k])
    ev[1].record()
    prog.step.update(state, grads)
    ev[2].record()
    del grads
    micro = {key: v.reshape(cfg.grad_accum, -1, *v.shape[1:])
             for key, v in batches[k].items()}
    with torch.no_grad(), use_policy(prog.policy):
        ev[3].record()
        for i in range(cfg.grad_accum):
            steps.loss_fn(cfg, state["params"],
                          {key: v[i] for key, v in micro.items()})
        ev[4].record()
    torch.cuda.synchronize()
    fwd_bwd, opt = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    fwd = ev[3].elapsed_time(ev[4])

    def one_step():
        launches.reset_counts()
        prog.step(state, batches[0])

    prof = traced("train_step", one_step)
    seen = {n: launches.traced_launches(prof)[n] for n in QWEN_FUSED}
    per_step = train_launches(cfg, cfg.grad_accum)
    if seen != per_step or _check_counts(
            launches, "train", QWEN_FUSED) != {
                **{n: 0 for n in launches.WRAPPERS}, **per_step}:
        raise AssertionError(f"train: the trace saw {seen}, expected "
                             f"{per_step}")
    busy = device_busy_ms(prof)
    wall = float(np.median(walls)) * 1e3
    flops, bound_ms, opt_bound = train_bound(cfg, TRAIN_B, TRAIN_S, n_params)
    log("train", part="step", B=TRAIN_B, S=TRAIN_S, steps=k,
        wall_ms_median=f"{wall:.2f}",
        wall_ms=json.dumps([round(w * 1e3, 2) for w in walls]).replace(
            " ", ""),
        tokens_per_s=f"{TRAIN_B * TRAIN_S / (wall / 1e3):.1f}",
        fwd_bwd_ms=f"{fwd_bwd:.2f}", optimizer_ms=f"{opt:.2f}",
        forward_ms=f"{fwd:.2f}", peak_gb=f"{peak:.1f}",
        model_tflop=f"{flops / 1e12:.2f}", bound_ms=f"{bound_ms:.2f}",
        bound_share=f"{bound_ms / wall:.3f}",
        optimizer_bound_ms=f"{opt_bound:.2f}",
        optimizer_bound_share=f"{opt_bound / opt:.3f}",
        device_busy_ms=f"{busy:.2f}",
        idle_share=f"{max(0.0, 1 - busy / wall):.3f}",
        device_kernels=sum(e.count for e in device_events(prof)),
        launches=json.dumps(want).replace(" ", ""),
        traced_step=json.dumps(seen).replace(" ", ""),
        losses=json.dumps([round(x, 5) for x in losses]).replace(" ", ""))
    log("train", part="chunk", steps=k, wall_ms=f"{chunk_wall * 1e3:.2f}",
        ms_a_step=f"{chunk_wall * 1e3 / k:.2f}", losses_equal=True)
    top = sorted(((e.key, e.device_time_total / 1e3, e.count)
                  for e in device_events(prof) if e.device_time_total > 0),
                 key=lambda r: -r[1])
    for key, ms, n in top[:8]:
        log("train", kernel=f"'{key[:70]}'", device_ms=f"{ms:.2f}",
            launches=n)
    del state, prog, batches, stacked
    gc.collect()
    torch.cuda.empty_cache()
    return per_step


def train_grads_part(launches) -> None:
    """One microbatch (2 x 512) at full width, TRAIN_LAYERS layers, from
    one set of seeded weights: gradients through the kernel route
    ("fused": rows 1-3 and their autograd Functions) and through the
    "reference" route (the plain products, plain autograd). Every leaf's
    gradient is finite and non-zero on both, and within TRAIN_TOL
    relative L2 error of the other route's."""
    from torch.utils import _pytree as pytree

    from repro_torch.models import steps

    cfg = dataclasses.replace(train_cfg(), grad_accum=1)
    params = steps.init_params(cfg, 0, device="cuda")
    batch = _stream_batches(cfg, 2, TRAIN_S, 1, seed=1)[0]
    launches.reset_counts()
    lk, _, gk = steps.make_train_step(cfg, policy="fused").accumulate(
        params, batch)
    counted = _check_counts(launches, "train", QWEN_FUSED)
    want = train_launches(cfg, 1)
    if {n: counted[n] for n in QWEN_FUSED} != want:
        raise AssertionError(f"train grads: launches {counted}")
    lr_, _, gr = steps.make_train_step(cfg, policy="reference").accumulate(
        params, batch)
    worst, n_leaves = ("", 0.0), 0
    for (path, a), b in zip(pytree.tree_flatten_with_path(gk)[0],
                            pytree.tree_leaves(gr)):
        name = pytree.keystr(path)
        a, b = a.float(), b.float()
        for tag, t in (("fused", a), ("reference", b)):
            if not torch.isfinite(t).all() or not t.abs().max() > 0:
                raise AssertionError(f"train grads: {tag} gradient of "
                                     f"{name} not finite or all zero")
        rel = float((a - b).norm() / b.norm())
        if rel > worst[1]:
            worst = (name, rel)
        n_leaves += 1
    if worst[1] > TRAIN_TOL:
        raise AssertionError(f"train grads: {worst[0]} differs by "
                             f"{worst[1]:.3g} (relative L2) between routes")
    log("train", part="grads", B=2, S=TRAIN_S, leaves=n_leaves,
        loss_fused=f"{float(lk):.5f}", loss_reference=f"{float(lr_):.5f}",
        worst_leaf=f"'{worst[0]}'", worst_rel_l2=f"{worst[1]:.3g}",
        tol=TRAIN_TOL, launches=json.dumps(want).replace(" ", ""))
    del params, gk, gr
    gc.collect()
    torch.cuda.empty_cache()


def train_run_part(launches) -> None:
    """A reduced qwen3 (2 layers, d_model 1024, 8 heads of 128 over 2 KV
    heads, d_ff 3456, vocab 8192; flash_attention_proj takes heads of 128)
    through Cluster.compile(TrainProgram(...)).run() under "fused":
    12 steps of 8 x 256 tokens with the double-buffered feed and a
    checkpoint every 4 steps; the same program again in another directory,
    preempted by SIGTERM after step 6 (the loop's final checkpoint), then
    a third with resume=True from there. The resumed run's losses (steps
    7-12) equal the uninterrupted run's bit for bit, and the loss falls.
    Then api.train on qwen3-14b-smoke (the default policy) as the one-call
    entry point."""
    import os
    import signal
    import tempfile

    from repro_torch import api
    from repro_torch.cluster.session import Cluster, TrainProgram
    from repro_torch.configs import get

    cfg = dataclasses.replace(get("qwen3-14b"), n_layers=2, d_model=1024,
                              n_heads=8, n_kv_heads=2, head_dim=128,
                              d_ff=3456, vocab=8192)
    kw = dict(num_steps=12, batch=8, seq=256, warmup=2, log_every=1,
              checkpoint_every=4, double_buffer=True)
    cluster = Cluster(cfg, policy="fused")
    with tempfile.TemporaryDirectory() as root:
        launches.reset_counts()
        t0 = time.perf_counter()
        full = cluster.compile(TrainProgram(
            checkpoint_dir=f"{root}/full", **kw)).run()
        wall = time.perf_counter() - t0
        counted = _check_counts(launches, "train", QWEN_FUSED)
        cut = cluster.compile(TrainProgram(checkpoint_dir=f"{root}/cut",
                                           **kw))
        step, calls = cut.step, []

        def preempted_after_6(state, batch):
            out = step(state, batch)
            calls.append(1)
            if len(calls) == 6:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        cut.step = preempted_after_6
        first = cut.run()
        resumed = cluster.compile(TrainProgram(
            checkpoint_dir=f"{root}/cut", resume=True, **kw)).run()
        one_call = api.train("qwen3-14b", num_steps=2, batch=2, seq=32,
                             checkpoint_dir=f"{root}/api")
    whole = {m["step"]: m["loss"] for m in full["metrics"]}
    parts = {m["step"]: m["loss"] for m in first["metrics"]
             + resumed["metrics"]}
    if not (first["preempted"] and first["final_step"] == 6
            and resumed["final_step"] == 12 and full["final_step"] == 12):
        raise AssertionError(f"train run: final steps {first['final_step']}"
                             f" / {resumed['final_step']}")
    if parts != whole:
        raise AssertionError(f"train run: resumed losses {parts} against "
                             f"{whole}")
    if not all(np.isfinite(list(whole.values()))) or not whole[12] < whole[1]:
        raise AssertionError(f"train run: losses {whole}")
    if one_call["final_step"] != 2 or not np.isfinite(
            one_call["metrics"][-1]["loss"]):
        raise AssertionError(f"train run: api.train {one_call}")
    feed = full["feed"]
    log("train", part="run", arch="qwen3-14b-reduced", layers=2, d=1024,
        heads="8/2x128", vocab=8192, steps=12, B=8, S=256,
        wall_s=f"{wall:.2f}", loss_first=f"{whole[1]:.4f}",
        loss_last=f"{whole[12]:.4f}", preempted_at=first["final_step"],
        resumed_losses_equal=True,
        feed_overlap_pct=f"{feed['overlap_pct']:.1f}",
        feed_produce_s=f"{feed['produce_s']:.3f}",
        feed_wait_s=f"{feed['consumer_wait_s']:.3f}",
        host_syncs=full["stall"]["host_syncs"],
        launches=_nonzero({n: counted[n] for n in QWEN_FUSED}),
        api_train_loss=f"{one_call['metrics'][-1]['loss']:.4f}")


if __name__ == "__main__":
    sys.exit(main())
