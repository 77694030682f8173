"""repro_torch's CUDA kernels against their plain versions, on the GPU.

Every test here is marked `cuda` and skips without a CUDA device (the
kernels have no CPU mode). It imports no jax, so it runs on a machine
with only PyTorch: `python -m pytest -q tests/test_torch_cuda.py`.
Tolerance: bf16 outputs within 2e-2 absolute + relative (one output
rounding, and f32 sums taken in another order); f32 within 1e-5 (sum
order), matmul within 1e-4 * sqrt(K) absolute (and, on its 3xTF32 route,
at most twice the plain version's error against an f64 product; with
inf, NaN and FLT_MAX inputs, the plain version's infs and NaNs and 1e-5
relative at 1e38-size outputs), dotp within 1e-5 of sum|x*y|; axpy's
card tests ask for the plain version's bits (the kernel rounds the product
and the sum apart, as the plain version does).
"""

import pytest
import torch

from repro_torch.kernels import axpy, conv2d, dct8x8, dotp, fused, launches
from repro_torch.kernels import matmul
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (8, 5120, 1024), (1, 5120, 17408), (3, 200, 72), (12, 300, 130),
    # the wgmma path: qwen3-14b's prefill (qkv, gate/up), a ragged M, and
    # edges of M, K and N that divide no tile
    (512, 5120, 7168), (512, 5120, 17408), (1000, 5120, 5120),
    # recurrentgemma-9b's k / v of one head of 256 and its gate / up, at
    # prefill and decode M
    (1000, 4096, 256), (8, 4096, 256), (8, 4096, 12288),
    (17, 136, 72), (64, 136, 136), (200, 136, 72),
    # K or N not a multiple of 8: the wmma tile
    (70, 256, 130), (100, 136, 134), (40, 130, 72)])
def test_cuda_rmsnorm_matmul(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    s = (0.1 * torch.randn(k, generator=g, device=cuda)).bfloat16()
    w = (torch.randn(k, n, generator=g, device=cuda) * k ** -0.5).bfloat16()
    before = fused.rmsnorm_matmul.launches
    got = fused.rmsnorm_matmul(x, s, w)
    torch.cuda.synchronize()
    assert fused.rmsnorm_matmul.launches == before + 1
    torch.testing.assert_close(got.float(), fused.rmsnorm_matmul_plain(
        x, s, w).float(), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 5120, 5120), (8, 17408, 5120),
                                   (5, 100, 36), (16, 72, 264),
                                   (40, 128, 96),
                                   # the mainloop: qwen3-14b's down
                                   # projection, and edges no tile divides
                                   (512, 17408, 5120), (130, 200, 200),
                                   # recurrentgemma-9b's down projection
                                   (300, 12288, 4096), (8, 12288, 4096),
                                   # K % 8 != 0: the wmma tile
                                   (64, 100, 96)])
def test_cuda_matmul_residual_add(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    b = (torch.randn(k, n, generator=g, device=cuda) * k ** -0.5).bfloat16()
    r = torch.randn(m, n, generator=g, device=cuda).bfloat16()
    got = fused.matmul_residual_add(a, b, r)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), fused.matmul_residual_add_plain(
        a, b, r).float(), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (64, 16, 64),          # the mainloop, one k step
    (64, 520, 64),         # the mainloop, 9 k steps
    (2000, 16, 3000),      # persistent: 384 tiles, one k step each
    (2000, 520, 3000),     # persistent, 9 k steps a tile
    (8, 16, 64),           # the decode kernel: one k box
    (8, 5120, 5120),       # qwen3's out projection, split over a cluster
    (8, 520, 264),         # the decode kernel at K and N no box divides
    (16, 5128, 72),        # two slot tiles, K no cluster splits evenly
    (5, 100, 36)])         # K % 8 != 0: split-K
def test_cuda_matmul_residual_add_rounds_twice_like_the_kernel(cuda, m, k,
                                                               n):
    """The Pallas kernel's two roundings, bf16(f32(bf16(acc)) + f32(res)),
    bit for bit: with small integers every f32 sum is exact in any order,
    so the kernel must equal the plain version exactly (the CPU tests hold
    the plain version to the Pallas kernel on the same kind of input)."""
    g = torch.Generator(device=cuda).manual_seed(14)
    a = torch.randint(-32, 33, (m, k), generator=g, device=cuda).bfloat16()
    b = torch.randint(-32, 33, (k, n), generator=g, device=cuda).bfloat16()
    r = (torch.randint(-64, 65, (m, n), generator=g, device=cuda)
         + 0.375).bfloat16()
    got = fused.matmul_residual_add(a, b, r)
    torch.cuda.synchronize()
    want = fused.matmul_residual_add_plain(a, b, r)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()
    once = (a.float() @ b.float() + r.float()).bfloat16()   # one rounding
    assert not torch.equal(got, once)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,dm,causal", [
    (1, 40, 8, 512, 256, True), (1, 4, 2, 100, 256, True),
    (1, 6, 3, 70, 256, False), (1, 10, 2, 130, 144, True),
    (1, 40, 8, 512, 5120, True), (1, 40, 8, 512, 5120, False),
    (2, 4, 2, 1000, 264, True), (2, 6, 3, 1000, 136, False),
    # lengths no key or query tile divides, several batches and heads: a
    # TMA box that read the next head's rows would show here
    (3, 8, 2, 200, 256, False), (2, 5, 1, 33, 128, True),
    (2, 4, 4, 1, 64, True)])
def test_cuda_flash_attention_proj(cuda, b, h, kv, s, dm, causal):
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(b, h, s, 128, generator=g, device=cuda).bfloat16()
    k = torch.randn(b, kv, s, 128, generator=g, device=cuda).bfloat16()
    v = torch.randn(b, kv, s, 128, generator=g, device=cuda).bfloat16()
    wo = (torch.randn(h, 128, dm, generator=g, device=cuda)
          * (h * 128) ** -0.5).bfloat16()
    got = fused.flash_attention_proj(q, k, v, wo, causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), fused.flash_attention_proj_plain(
        q, k, v, wo, causal).float(), **BF16_TOL)


@pytest.mark.cuda
def test_cuda_graph_session_matches_eager(cuda):
    """The session step replayed as a CUDA graph gives the eager step's
    tokens, and a device trace of the graphed run sees as many kernel
    launches as the wrappers counted in the eager run."""
    import dataclasses

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.cluster.session import Cluster, ServeSessionProgram
    from repro_torch.configs import get
    from repro_torch.models import steps
    from repro_torch.runtime import engine

    cfg = dataclasses.replace(get("qwen3-14b"), n_layers=2, d_model=256,
                              n_heads=4, n_kv_heads=2, d_ff=512, vocab=512)
    cluster = Cluster(cfg)
    spec = ServeSessionProgram(slots=4, max_seq=64, max_prompt=32, chunk=8,
                               paged=True, page_size=8)
    rng = np.random.default_rng(0)
    pre = rng.integers(1, 512, 16)
    reqs = [(np.concatenate([pre, rng.integers(1, 512, i)]), 6 + i)
            for i in range(1, 7)]
    out, counted = [], []
    for graph in (True, False):
        with cluster.policy("fused"):
            prog = cluster.compile(spec)
        if not graph:
            prog._chunk_fn = engine.session_chunk_fn(
                steps.make_decode_step(cfg, max_seq=spec.max_seq,
                                       policy="fused"),
                spec.chunk, cuda_graph=False)
        sess = prog.open(params=prog.init_params(3))
        launches.reset_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            handles = [sess.submit(p, n) for p, n in reqs]
            sess.drain()
            torch.cuda.synchronize()
        out.append([h.result() for h in handles])
        counted.append((launches.counts(), launches.traced_launches(prof)))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    (g_counts, g_traced), (e_counts, e_traced) = counted
    eager = {k: c["launches"] for k, c in e_counts.items()}
    assert eager["rmsnorm_matmul"] > 0 and eager["matmul_residual_add"] > 0
    assert e_traced == eager == g_traced
    assert 0 < g_counts["rmsnorm_matmul"]["launches"] < eager[
        "rmsnorm_matmul"]


# ----------------------------------------------------------------------------
# the robustness layer on a captured session: every write in place
# ----------------------------------------------------------------------------

def _chaos_session(paged, **kw):
    """A 2-layer qwen3-shaped session under "fused" on the card (4 slots,
    chunk 8) with four requests in; the first poll captures the step."""
    import dataclasses

    import numpy as np

    from repro_torch.cluster.session import Cluster, ServeSessionProgram
    from repro_torch.configs import get

    cfg = dataclasses.replace(get("qwen3-14b"), n_layers=2, d_model=256,
                              n_heads=4, n_kv_heads=2, d_ff=512, vocab=512)
    cluster = Cluster(cfg)
    extra = dict(paged=True, page_size=8) if paged else {}
    with cluster.policy("fused"):
        prog = cluster.compile(ServeSessionProgram(
            slots=4, max_seq=64, max_prompt=16, chunk=8,
            retry_backoff_s=0.0, **extra, **kw))
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(1, 512, 3 + i), 20 + i) for i in range(4)]
    return prog, prog.init_params(5), reqs


def _serve(sess, reqs):
    handles = [sess.submit(p, n) for p, n in reqs]
    sess.drain()
    return [h.result().tolist() for h in handles]


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_cuda_nan_corruption_seen_by_the_next_replay_in_its_slot(cuda,
                                                                 paged):
    """NaN written into slot 2 of a captured session's state (rows, or the
    pages its table maps) is what the next graph replay reads: the NaN
    scan after it flags slot 2 and no other."""
    import numpy as np

    prog, params, reqs = _chaos_session(paged)
    sess = prog.open(params=params)
    for p, n in reqs:
        sess.submit(p, n)
    sess.poll()
    assert sess.captures == 1
    mask = np.array([False, False, True, False])
    sess._fault_fn("corrupt_fn")(sess.state, mask)
    sess._chunk_fn(sess.params, sess.state)         # a replay
    assert sess.captures == 1 and "step_graph" in sess.state
    flags = sess._fault_fn("nan_scan_fn")(sess.state).cpu().numpy()
    np.testing.assert_array_equal(flags, mask)


@pytest.mark.cuda
def test_cuda_slot_snapshot_restore_across_replays(cuda):
    """Snapshot every slot of a captured private session, replay a chunk,
    restore the snapshots in place, replay again: the second chunk's
    tokens equal the first's (the uninterrupted run), and no state
    tensor moved."""
    prog, params, reqs = _chaos_session(False)
    sess = prog.open(params=params)
    for p, n in reqs:
        sess.submit(p, n)
    sess.poll()
    ptrs = [t.data_ptr() for k, t in sess.state.items()
            if isinstance(t, torch.Tensor)]
    snaps = [sess._fault_fn("snapshot_fn")(sess.state, s) for s in range(4)]
    age = sess.state["age"].clone()
    _, want, emit, _, _ = sess._chunk_fn(sess.params, sess.state)
    for s, rows in enumerate(snaps):
        sess._fault_fn("restore_fn")(sess.state, s, rows)
    assert torch.equal(sess.state["age"], age + 1)
    _, got, emit2, _, _ = sess._chunk_fn(sess.params, sess.state)
    assert torch.equal(got, want) and torch.equal(emit2, emit)
    assert sess.captures == 1 and ptrs == [
        t.data_ptr() for k, t in sess.state.items()
        if isinstance(t, torch.Tensor)]


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_cuda_restore_session_keeps_data_ptrs(cuda, tmp_path, paged):
    """`restore_session` into a captured session's state writes every
    leaf in place (its data_ptr kept) and skips the step graph; a crash
    then `restore` on the card delivers every token once, equal to a
    fault-free run."""
    from repro_torch.runtime import FaultPlan, SessionCrashed
    from repro_torch.runtime.journal import read_events, replay

    prog, params, reqs = _chaos_session(paged)
    want = _serve(prog.open(params=params), reqs)
    sess = prog.open(params=params, durable_dir=tmp_path / "a",
                     snapshot_every=1)
    for p, n in reqs:
        sess.submit(p, n)
    sess.poll()
    sess.poll()
    saved = {k: t.clone() for k, t in sess.state["cache"].items()}
    ptrs = {k: t.data_ptr() for k, t in sess.state["cache"].items()}
    ckpt = sess._get_ckpt()
    for t in sess.state["cache"].values():
        t.zero_()
    out, _ = ckpt.restore_session(ckpt.latest_session_step(),
                                  like=sess.state)
    assert out["step_graph"] is sess.state["step_graph"]
    for k, t in sess.state["cache"].items():
        assert t.data_ptr() == ptrs[k] and torch.equal(t, saved[k])
    sess.close()
    d = tmp_path / "b"
    sess = prog.open(params=params, durable_dir=d, snapshot_every=2,
                     faults=FaultPlan().crash(at_chunk=2))
    for p, n in reqs:
        sess.submit(p, n)
    with pytest.raises(SessionCrashed):
        sess.drain()
    final = {rid: list(r.committed) for rid, r in replay(
        read_events(d / "journal.jsonl")).requests.items()}
    restored = prog.restore(d, params=params)
    assert restored.stats()["durability"]["restored_step"] == 2
    for h, toks, _ in restored.stream():
        final[h.id].extend(int(t) for t in toks)
    assert [final[i] for i in range(4)] == want


@pytest.mark.cuda
def test_cuda_recover_wedged_captures_a_new_graph(cuda):
    """A scripted wedge on the card: the watchdog raises SessionWedged,
    `recover_wedged` gives up the wedged buffers, the next chunk captures
    a new graph over the fresh state, and every request's tokens equal a
    fresh session's."""
    from repro_torch.runtime import FaultPlan, SessionWedged

    prog, params, reqs = _chaos_session(True, watchdog_s=5.0)
    want = _serve(prog.open(params=params), reqs)
    sess = prog.open(params=params, faults=FaultPlan().wedge(at_chunk=1))
    handles = [sess.submit(p, n) for p, n in reqs]
    sess.poll()
    old = sess.state
    with pytest.raises(SessionWedged):
        sess.poll()
    sess.recover_wedged()
    assert sess.state is not old and "step_graph" not in sess.state
    sess.drain()
    assert sess.captures == 2
    assert [h.result().tolist() for h in handles] == want


# ----------------------------------------------------------------------------
# the execution engine and the prefill as CUDA graphs
# ----------------------------------------------------------------------------

def _smoke(cuda, seed=1, max_seq=64):
    from repro_torch.configs import get
    from repro_torch.models import steps

    cfg = get("qwen3-14b-smoke")
    return cfg, steps.init_params(cfg, seed, device=cuda, max_seq=max_seq)


@pytest.mark.cuda
@pytest.mark.parametrize("eos", [False, True], ids=["no_eos", "eos"])
def test_cuda_engine_graph_equals_eager(cuda, eos):
    """`DecodeEngine` replaying its chunks as CUDA graphs gives the eager
    engine's tokens, finished, emitted and cache rows [0, pos) bit for
    bit, in a first generate (each chunk length's first chunk runs eagerly
    and captures) and a second one (replays only); the steady chunk and
    the tail are captured once each."""
    import numpy as np

    from repro_torch.models import steps
    from repro_torch.runtime.engine import DecodeEngine

    cfg, params = _smoke(cuda)
    step = steps.make_decode_step(cfg, max_seq=64, policy="fused")
    start = np.random.default_rng(0).integers(1, cfg.vocab, (4, 1))

    def generate_twice(eng):
        cache = steps.init_cache(cfg, 4, 64, device=cuda)
        runs = []
        for _ in range(2):
            for c in cache.values():
                c.zero_()
            out, cache, fin, em = eng.generate(params, cache, start, 20,
                                               start_pos=3)
            end = 3 + out.shape[1] - 1
            runs.append((out, fin, em, {k: c[:, :, :end].clone()
                                        for k, c in cache.items()}))
        return runs

    eos_id = None
    if eos:                                         # slot 0 ends mid-run
        eos_id = int(generate_twice(DecodeEngine(
            step, 8, cuda_graph=False))[0][0][0, 5])
    eager_eng = DecodeEngine(step, 8, eos_id=eos_id, cuda_graph=False)
    graph_eng = DecodeEngine(step, 8, eos_id=eos_id)
    eager, graphed = generate_twice(eager_eng), generate_twice(graph_eng)
    assert all(fn.graphs.misses == 0 for fn in eager_eng._chunk_fns.values())
    if not eos:
        assert {k: fn.graphs.misses
                for k, fn in graph_eng._chunk_fns.items()} == {8: 1, 4: 1}
    for (o1, f1, e1, c1), (o2, f2, e2, c2) in zip(eager, graphed):
        np.testing.assert_array_equal(o1, o2)
        np.testing.assert_array_equal(f1, f2)
        np.testing.assert_array_equal(e1, e2)
        for k in c1:
            assert torch.equal(c1[k], c2[k]), k
    if eos:
        assert graphed[0][1][0]                     # slot 0 finished


@pytest.mark.cuda
def test_cuda_compiled_serve_reruns_without_capturing(cuda):
    """A compiled `ServeProgram` captures its graphs (the prompt's step,
    the steady chunk, the tail) in its first run only; a second run and a
    second compile of the same spec capture nothing and give the same
    tokens; chunk 1 gives chunk 8's tokens with one host sync a token."""
    import dataclasses

    import numpy as np

    from repro_torch.cluster.session import Cluster, ServeProgram

    cluster = Cluster("qwen3-14b-smoke")
    params = _smoke(cuda)[1]
    prompt = np.random.default_rng(2).integers(1, 256, (4, 6))
    spec = ServeProgram(batch=4, max_seq=64, max_new=20, chunk=8)
    with cluster.policy("fused"):
        prog = cluster.compile(spec)
    first = prog.run(params=params, prompt=prompt)
    assert prog.captures() == 3
    again = prog.run(params=params, prompt=prompt)
    with cluster.policy("fused"):
        assert cluster.compile(spec) is prog
        per_token = cluster.compile(dataclasses.replace(spec, chunk=1))
    assert prog.captures() == 3
    np.testing.assert_array_equal(first["tokens"], again["tokens"])
    one = per_token.run(params=params, prompt=prompt)
    np.testing.assert_array_equal(one["tokens"], first["tokens"])
    assert again["stats"]["stall"]["host_syncs"] == 3
    assert one["stats"]["stall"]["host_syncs"] == 20
    assert per_token.captures() == 1


def _prefill_cases(cuda):
    import dataclasses as dc

    from repro_torch.configs import get
    from repro_torch.models import steps

    wide = dc.replace(get("qwen3-14b"), n_layers=2, d_model=256, n_heads=4,
                      n_kv_heads=2, head_dim=128, d_ff=512, vocab=512)
    return {"smoke_tuned": (get("qwen3-14b-smoke"), "tuned"),
            "hd128_fused": (wide, "fused"),
            "hd128_pallas": (dc.replace(wide, attn_schedule="pallas"),
                             "tuned")}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["smoke_tuned", "hd128_fused",
                                  "hd128_pallas"])
def test_cuda_graphed_prefill_equals_eager(cuda, case):
    """The prefill step replays a graph per batch shape and parameter
    tree: its tokens equal the eager step's for two shapes; a shape seen
    before replays, a new one or a new parameter tree captures anew (the
    old tree's graphs dropped); a replay's tokens survive the next
    replay."""
    import numpy as np

    from repro_torch.models import steps

    cfg, policy = _prefill_cases(cuda)[case]
    params = steps.init_params(cfg, 0, device=cuda)
    prefill = steps.make_prefill_step(cfg, policy=policy)
    rng = np.random.default_rng(0)

    def batch(shape):
        return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, shape),
                                          device=cuda)}

    for shape in ((2, 16), (1, 40)):
        b = batch(shape)
        want = prefill.eager(params, b)
        assert torch.equal(prefill(params, b), want)      # capture
        assert torch.equal(prefill(params, b), want)      # replay
    assert prefill.graphs.misses == 2 and len(prefill.graphs) == 2
    b1, b2 = batch((2, 16)), batch((2, 16))
    t1 = prefill(params, b1)
    kept = t1.clone()
    t2 = prefill(params, b2)
    torch.cuda.synchronize()
    assert prefill.graphs.misses == 2
    assert torch.equal(t1, kept) and t1.data_ptr() != t2.data_ptr()
    assert torch.equal(t2, prefill.eager(params, b2))
    params2 = steps.init_params(cfg, 1, device=cuda)
    want = prefill.eager(params2, b1)
    assert torch.equal(prefill(params2, b1), want)
    assert torch.equal(prefill(params2, b1), want)
    assert prefill.graphs.misses == 3 and len(prefill.graphs) == 1


# ----------------------------------------------------------------------------
# the Table 1 suite
# ----------------------------------------------------------------------------

F32_TOL = dict(rtol=1e-5, atol=1e-5)
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _randn(g, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(1000, 136, 200), (5, 520, 300),
                                   (130, 7, 129), (256, 256, 256)])
def test_cuda_matmul(cuda, dtype, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(3)
    a = _randn(g, m, k, dtype=DT[dtype])
    b = _randn(g, k, n, dtype=DT[dtype], scale=k ** -0.5)
    before = matmul.matmul.launches
    got = matmul.matmul(a, b)
    torch.cuda.synchronize()
    assert matmul.matmul.launches == before + 1
    assert got.dtype == a.dtype and got.shape == (m, n)
    tol = (dict(rtol=0.0, atol=1e-4 * k ** 0.5) if dtype == "float32"
           else BF16_TOL)
    torch.testing.assert_close(got.float(), matmul.matmul_plain(
        a, b).float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (4096, 4096, 4096),    # the suite's card size: 1,024 tiles, persistent
    (2000, 512, 3000),     # 384 tiles, no multiple of the 132 SMs
    (300, 4096, 1000)])    # one wave
def test_cuda_matmul_bf16_on_the_mainloop(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(15)
    a = _randn(g, m, k, dtype=torch.bfloat16)
    b = _randn(g, k, n, dtype=torch.bfloat16, scale=k ** -0.5)
    before = matmul.matmul.launches
    got = matmul.matmul(a, b)
    torch.cuda.synchronize()
    assert matmul.matmul.launches == before + 1
    assert got.dtype == a.dtype and got.shape == (m, n)
    torch.testing.assert_close(got.float(), matmul.matmul_plain(
        a, b).float(), **BF16_TOL)


def _f32_plan(m, k, n):
    """matmul_f32_plan: [route (3xTF32 on the tensor cores, 1: after the
    split pass, 2: b split in the product; 0: the CUDA-core tile), N tile,
    cluster, tiles, blocks, k a block, stages]."""
    import ctypes

    from repro_torch.kernels import build

    plan = (ctypes.c_int * 7)()
    build.check("matmul", build.entry("matmul", "matmul_f32_plan")(
        m, n, k, 0, 0, plan))
    return list(plan)


def _traced_kernels(fn):
    """{device kernel name (spaces removed): runs} of one call of `fn`
    under torch.profiler, between two kernels that mark the trace's
    edges."""
    from torch.profiler import ProfilerActivity, profile

    edge = torch.ones(4, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        edge = edge * 2.0
        fn()
        edge = edge * 2.0
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "CUDA" in str(getattr(e, "device_type", "")):
            key = e.key.replace(" ", "")
            out[key] = out.get(key, 0) + e.count
    return out, launches.traced_launches(prof)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,cluster", [
    (4096, 4096, 4096, 1),    # the suite's card size: persistent
    (2000, 512, 3000, 1),     # tiles no multiple of the 132 SMs
    (300, 4096, 1000, 2),     # under a wave: K split in a cluster
    (256, 256, 256, 2),       # the paper's size: K split in a cluster
    (1000, 136, 200, 0),      # ragged M, N and K
    # K and N 4 past a multiple of 8: a last k8 slice half past K, and a
    # last 8-column group half past N, in the cluster's reduction ...
    (256, 132, 260, 2),
    # ... and in the store of a block alone
    (2000, 132, 204, 1),
    (1000, 132, 204, 0)])
def test_cuda_matmul_f32_on_the_tensor_cores(cuda, m, k, n, cluster):
    """f32 with K, N % 4 == 0 runs three TF32 products: within 1e-4 *
    sqrt(K) of the plain version, at most twice the plain version's error
    against an f64 product, and the same bits twice. `cluster`: 1, the
    plan splits no K; 2, it splits K in a cluster; 0, either."""
    assert not torch.backends.cuda.matmul.allow_tf32
    plan = _f32_plan(m, k, n)
    assert plan[0] == (2 if m <= 256 else 1)
    assert cluster == 0 or (plan[2] > 1) == (cluster == 2), plan
    g = torch.Generator(device=cuda).manual_seed(19)
    a = _randn(g, m, k)
    b = _randn(g, k, n)
    before = matmul.matmul.launches
    got = matmul.matmul(a, b)
    again = matmul.matmul(a, b)
    torch.cuda.synchronize()
    assert matmul.matmul.launches == before + 2
    assert got.dtype == torch.float32 and got.shape == (m, n)
    plain = matmul.matmul_plain(a, b)
    torch.testing.assert_close(got, plain, rtol=0.0, atol=1e-4 * k ** 0.5)
    want = a.double() @ b.double()
    err = (got.double() - want).abs().max().item()
    plain_err = (plain.double() - want).abs().max().item()
    assert err <= 2 * plain_err, (err, plain_err)
    assert torch.equal(got, again)


def _nonfinite_operands(g, m, k, n):
    """Unit normal (m, k) and (k, n) f32 operands with +-inf, NaN, FLT_MAX
    and 3.4e38 entries: inf against a b value TF32 holds exactly (1.0, so
    its lo part is 0) and against 0.0 (NaN in f32), inf against inf of
    either sign, NaN, and the two largest values against b rows of 0.25
    (a finite 1e38-size output) and 2.0 (inf in f32)."""
    a, b = _randn(g, m, k), _randn(g, k, n)
    big = torch.tensor([0.25, 2.0, -0.5, -3.0], device="cuda").repeat(
        (n + 3) // 4)[:n]
    inf = float("inf")
    a[0, 3], b[3, 0], b[3, 1] = inf, 1.0, 0.0
    a[1, 5] = -inf
    a[2, 7] = float("nan")
    b[9, 2], a[3, 9] = inf, -inf
    a[4, 11], b[11] = torch.finfo(torch.float32).max, big
    a[5, 13], b[13] = 3.4e38, big
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(130, 132, 260), (600, 132, 260)])
def test_cuda_matmul_f32_keeps_inf_and_nan_like_f32(cuda, m, k, n):
    """With +-inf, NaN and near-FLT_MAX entries the 3xTF32 route (b split
    in the product at M 130, by the split pass at M 600) gives the plain
    f32 product's NaNs and infs, with their signs, and its finite outputs
    within 1e-4 * sqrt(K), or 1e-5 relative for the 1e38-size ones."""
    assert _f32_plan(m, k, n)[0] == (2 if m <= 256 else 1)
    g = torch.Generator(device=cuda).manual_seed(21)
    a, b = _nonfinite_operands(g, m, k, n)
    plain = matmul.matmul_plain(a, b)
    assert plain.isnan().any() and (plain == float("inf")).any()
    assert (plain == -float("inf")).any()
    assert (plain[torch.isfinite(plain)].abs() > 1e37).any()
    got = matmul.matmul(a, b)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-4 * k ** 0.5,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,kernels", [
    (1000, 256, 256, ("tf32x3::split_kernel", "tf32x3::gemm_kernel<")),
    (256, 256, 256, ("tf32x3::fused_kernel<",)),
    (130, 7, 129, ("matmul_f32_kernel",))])
def test_cuda_matmul_f32_routes_by_shape(cuda, m, k, n, kernels):
    """An f32 call runs its route's kernels once each and no other f32
    kernel, and a trace counts it once: K, N % 4 == 0 on the tensor cores
    (the split pass and the product, or at M <= 256 the product that
    splits b itself), (130, 7, 129) on `matmul_f32_kernel`."""
    route = _f32_plan(m, k, n)[0]
    assert route == {"tf32x3::split_kernel": 1, "tf32x3::fused_kernel<": 2,
                     "matmul_f32_kernel": 0}[kernels[0]]
    g = torch.Generator(device=cuda).manual_seed(20)
    a, b = _randn(g, m, k), _randn(g, k, n)
    names, traced = _traced_kernels(lambda: matmul.matmul(a, b))
    assert traced["matmul"] == 1, (traced, names)
    f32 = ("tf32x3::", "matmul_f32_kernel")
    ran = {k: v for k, v in names.items() if any(f in k for f in f32)}
    assert len(ran) == len(kernels), names
    for kernel in kernels:
        assert [v for k, v in ran.items() if kernel in k] == [1], names


# lengths below one 16-byte vector, each remainder past the last vector (4
# f32 or 8 bf16 a vector), 8k+5 for bf16, and more than a wave's rounds
TAILS = [(1,), (3,), (5,), (7,), (4001,), (4002,), (4003,), (8005,),
         ((1 << 20) + 7,)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1001, 77), (768, 128), (3, 5), *TAILS])
def test_cuda_axpy(cuda, dtype, shape):
    """The plain version's bits, alpha a number and a device f32 (the
    kernel rounds the product and the sum apart, as the plain version
    does)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = _randn(g, *shape, dtype=DT[dtype])
    y = _randn(g, *shape, dtype=DT[dtype])
    want = axpy.axpy_plain(1.7, x, y)
    for alpha in (1.7, torch.tensor(1.7, device=cuda)):
        got = axpy.axpy(alpha, x, y)
        torch.cuda.synchronize()
        assert got.dtype == x.dtype and got.shape == x.shape
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1001, 77), (768, 128), (2, 3), *TAILS])
def test_cuda_dotp_is_deterministic(cuda, dtype, shape):
    g = torch.Generator(device=cuda).manual_seed(5)
    x = _randn(g, *shape, dtype=DT[dtype])
    y = _randn(g, *shape, dtype=DT[dtype])
    first, second = dotp.dotp(x, y), dotp.dotp(x, y)
    torch.cuda.synchronize()
    assert first.shape == () and first.dtype == torch.float32
    assert torch.equal(_bits(first), _bits(second))    # the same bits
    scale = (x.float() * y.float()).abs().sum().item()
    assert abs(first.item() - dotp.dotp_plain(x, y).item()) <= 1e-5 * scale


def _bits(t):
    """t's bits as integers (NaN payloads and the sign of zero count)."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("alpha", [1.7, -0.0, float("inf"), -float("inf"),
                                   float("nan"), 1e-40, 3.4e38], ids=repr)
def test_cuda_axpy_number_and_tensor_alpha_give_the_same_bits(cuda, dtype,
                                                              alpha):
    """alpha by value and alpha read from a device f32 give the same bits,
    and the plain version's values (NaN where it has NaN; 1e-40 is an f32
    subnormal, which the kernel keeps)."""
    g = torch.Generator(device=cuda).manual_seed(9)
    x = _randn(g, 1001, 77, dtype=DT[dtype])
    y = _randn(g, 1001, 77, dtype=DT[dtype])
    by_value = axpy.axpy(alpha, x, y)
    by_pointer = axpy.axpy(torch.tensor(alpha, device=cuda), x, y)
    torch.cuda.synchronize()
    assert torch.equal(_bits(by_value), _bits(by_pointer))
    torch.testing.assert_close(by_value, axpy.axpy_plain(alpha, x, y),
                               rtol=0, atol=0, equal_nan=True)


def _kernels_of_one_call(fn):
    """[device kernel name (spaces removed)] one call of `fn` runs, from a
    torch.profiler trace: the kernels between two edge kernels, after
    primer kernels (a trace's first device records can go missing on the
    H100); taken again, up to three times, when an edge is missing."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                torch.zeros(1, dtype=torch.float64, device="cuda")
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        dev = sorted((e for e in prof.events()
                      if "CUDA" in str(getattr(e, "device_type", ""))),
                     key=lambda e: e.time_range.start)
        edges = [i for i, e in enumerate(dev) if "spin_kernel" in e.name]
        if len(edges) == 2:
            return [e.name.replace(" ", "") for e in dev[edges[0] + 1:
                                                          edges[1]]]
    raise AssertionError("three traces each lost an edge kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["axpy_number", "axpy_tensor", "dotp",
                                  "axpy_bf16", "dotp_bf16"])
def test_cuda_axpy_and_dotp_run_one_kernel_a_call(cuda, case):
    """No fill for a number alpha, no second pass for dotp: one traced
    device kernel a call, the wrapper's entry kernel."""
    g = torch.Generator(device=cuda).manual_seed(12)
    dt = torch.bfloat16 if case.endswith("bf16") else torch.float32
    x, y = _randn(g, 768, 128, dtype=dt), _randn(g, 768, 128, dtype=dt)
    alpha = torch.tensor(2.0, device=cuda) if case == "axpy_tensor" else 2.0
    name = case.split("_")[0]
    call = ((lambda: axpy.axpy(alpha, x, y)) if name == "axpy"
            else (lambda: dotp.dotp(x, y)))
    kernels = _kernels_of_one_call(call)
    assert len(kernels) == 1, kernels
    assert any(p in kernels[0] for p in launches.ENTRY_KERNELS[name]), kernels


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_dotp_same_bits_in_graph_replays_and_on_two_streams(cuda,
                                                                  dtype):
    """The same bits eager, in two replays of a captured graph, and from
    two streams running dotp at once (each stream, and each capture, has
    partials and a counter of its own)."""
    g = torch.Generator(device=cuda).manual_seed(13)
    xs = [_randn(g, 1 << 22, dtype=DT[dtype]) for _ in range(2)]
    ys = [_randn(g, 1 << 22, dtype=DT[dtype]) for _ in range(2)]
    want = [dotp.dotp(x, y) for x, y in zip(xs, ys)]
    again = [dotp.dotp(x, y) for x, y in zip(xs, ys)]
    torch.cuda.synchronize()
    assert [w.item() for w in want] != [0.0, 0.0]
    assert all(torch.equal(_bits(a), _bits(w)) for a, w in zip(again, want))

    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        outs = [dotp.dotp(x, y) for x, y in zip(xs, ys)]
    for _ in range(2):
        for o in outs:
            o.fill_(7.0)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(_bits(o), _bits(w))
                   for o, w in zip(outs, want))

    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(20):            # interleaved: the two streams overlap
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(dotp.dotp(xs[i], ys[i]))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(_bits(r), _bits(want[i])) for r in got[i])


def _cudart():
    """The CUDA runtime this process loaded, for the stream calls torch
    keeps to itself: raw captures (its own capture also arms its RNG) and
    streams outside its pool."""
    import ctypes

    with open("/proc/self/maps") as maps:
        for line in maps:
            if "libcudart.so" in line:
                rt = ctypes.CDLL(line.split()[-1])
                break
        else:
            raise AssertionError("no libcudart in this process")
    P = ctypes.c_void_p
    for fn, args in (("cudaStreamBeginCapture", [P, ctypes.c_int]),
                     ("cudaStreamCreateWithFlags",
                      [ctypes.POINTER(P), ctypes.c_uint]),
                     ("cudaStreamDestroy", [P]),
                     ("cudaStreamSynchronize", [P]),
                     ("cudaStreamEndCapture", [P, ctypes.POINTER(P)]),
                     ("cudaGraphDestroy", [P]), ("cudaGetLastError", [])):
        getattr(rt, fn).argtypes = args
        getattr(rt, fn).restype = ctypes.c_int
    return rt


@pytest.mark.cuda
def test_cuda_dotp_works_after_a_refused_launch(cuda):
    """A launch the runtime refuses (on a stream whose capture a forbidden
    call invalidated) raises, never runs, and leaves no counter that spoils
    the next call: the calls after it give the first call's bits."""
    import ctypes

    g = torch.Generator(device=cuda).manual_seed(14)
    x, y = _randn(g, 1 << 20), _randn(g, 1 << 20)
    want = dotp.dotp(x, y)
    side = torch.cuda.Stream()            # this test's own capture stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):         # its 0-d output block, cached
        dotp.dotp(x, y)
    torch.cuda.synchronize()
    rt, handle = _cudart(), ctypes.c_void_p(side.cuda_stream)
    assert rt.cudaStreamBeginCapture(handle, 2) == 0      # relaxed mode
    assert rt.cudaStreamSynchronize(handle) != 0  # forbidden: invalidates
    with torch.cuda.stream(side):
        with pytest.raises(RuntimeError, match="dotp: CUDA launch failed"):
            dotp.dotp(x, y)
    graph = ctypes.c_void_p()
    assert rt.cudaStreamEndCapture(handle, ctypes.byref(graph)) != 0
    if graph.value:
        rt.cudaGraphDestroy(graph)
    rt.cudaGetLastError()
    for stream in (side, torch.cuda.current_stream()):
        with torch.cuda.stream(stream):
            got = dotp.dotp(x, y)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_cuda_dotp_on_more_streams_than_slots_never_shares_a_slot(cuda):
    """80 streams of their own (torch's pool holds 32 a priority), more
    than dotp's 64 slots for streams, each holding a dotp behind a long
    sleep so that all of them are in flight at once: the streams past the
    64th wait for a slot's old holder instead of sharing its partials and
    counter, so every result has its own inputs' bits (two input pairs,
    alternating). Twice, so that evicted streams come back."""
    import ctypes

    g = torch.Generator(device=cuda).manual_seed(16)
    xs = [_randn(g, 1 << 20) for _ in range(2)]
    ys = [_randn(g, 1 << 20) for _ in range(2)]
    want = [dotp.dotp(x, y) for x, y in zip(xs, ys)]
    torch.cuda.synchronize()
    assert not torch.equal(want[0], want[1])
    rt, handles = _cudart(), []
    try:
        for _ in range(80):
            handle = ctypes.c_void_p()
            assert rt.cudaStreamCreateWithFlags(ctypes.byref(handle), 1) == 0
            handles.append(handle)
        streams = [torch.cuda.ExternalStream(h.value) for h in handles]
        assert len({s.cuda_stream for s in streams}) == 80
        for _ in range(2):
            got = []
            for i, s in enumerate(streams):
                s.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(s):
                    torch.cuda._sleep(20_000_000)
                    got.append(dotp.dotp(xs[i % 2], ys[i % 2]))
            torch.cuda.synchronize()
            assert all(torch.equal(_bits(r), _bits(want[i % 2]))
                       for i, r in enumerate(got))
    finally:
        torch.cuda.synchronize()
        for handle in handles:
            rt.cudaStreamDestroy(handle)


@pytest.mark.cuda
def test_cuda_dotp_refuses_a_capture_when_every_graph_slot_is_held(cuda):
    """Each capture of a dotp holds a slot of its own until its graph is
    destroyed: with every slot held by a live graph the next capture's
    dotp raises (never shares a slot), and once a graph is destroyed a
    capture runs again."""
    import ctypes
    import time

    g = torch.Generator(device=cuda).manual_seed(17)
    x, y = _randn(g, 4096), _randn(g, 4096)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):         # its outputs' pool, cached
        dotp.dotp(x, y)
    torch.cuda.synchronize()
    rt, handle = _cudart(), ctypes.c_void_p(side.cuda_stream)

    def capture():
        """(graph, whether its dotp raised)"""
        assert rt.cudaStreamBeginCapture(handle, 2) == 0     # relaxed mode
        try:
            with torch.cuda.stream(side):
                dotp.dotp(x, y)
            refused = False
        except RuntimeError as e:
            assert "dotp: CUDA launch failed" in str(e)
            refused = True
        graph = ctypes.c_void_p()
        assert rt.cudaStreamEndCapture(handle, ctypes.byref(graph)) == 0
        return graph, refused

    graphs = []
    try:
        for _ in range(256):
            graph, refused = capture()
            if refused:
                rt.cudaGraphDestroy(graph)
                break
            graphs.append(graph)
        assert refused and 0 < len(graphs) <= 192, len(graphs)
        rt.cudaGraphDestroy(graphs.pop())
        for _ in range(200):              # its slot, freed once released
            graph, refused = capture()
            rt.cudaGraphDestroy(graph)
            if not refused:
                break
            time.sleep(0.01)
        assert not refused
    finally:
        for graph in graphs:
            rt.cudaGraphDestroy(graph)
    want = dotp.dotp(x, y)
    torch.cuda.synchronize()
    assert torch.equal(_bits(want), _bits(dotp.dotp(x, y)))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(97, 1023), (96, 1024), (1, 1), (17, 65)])
def test_cuda_conv2d(cuda, h, w):
    g = torch.Generator(device=cuda).manual_seed(6)
    x, wt = _randn(g, h, w), _randn(g, 3, 3)
    got = conv2d.conv2d_3x3(x, wt)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, conv2d.conv2d_3x3_plain(x, wt),
                               **F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1001, 24576, 1, 17])
def test_cuda_dct8x8(cuda, n):
    g = torch.Generator(device=cuda).manual_seed(7)
    x = _randn(g, n, 8, 8)
    got = dct8x8.dct8x8(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, dct8x8.dct8x8_plain(x), **F32_TOL)


@pytest.mark.cuda
def test_cuda_suite_rejects_what_the_kernels_do_not_take(cuda):
    x = torch.randn(64, 32, device=cuda)
    with pytest.raises(TypeError):
        conv2d.conv2d_3x3(x.half(), torch.randn(3, 3, device=cuda).half())
    with pytest.raises(TypeError):
        dct8x8.dct8x8(torch.randn(4, 8, 8, device=cuda).bfloat16())
    with pytest.raises(TypeError):
        axpy.axpy(2.0, x, x.bfloat16())
    with pytest.raises(ValueError):
        matmul.matmul(x, torch.randn(40, 32, device=cuda).t())
    with pytest.raises(ValueError):
        dotp.dotp(x.t(), x.t())


@pytest.mark.cuda
def test_cuda_traced_matmul_launches_stay_apart_from_the_fused(cuda):
    """The plain matmul instantiates the fused kernels' templates: a trace
    counts its launches as matmul's, not matmul_residual_add's or
    rmsnorm_matmul's, on every path, the Hopper mainloop included (each
    wrapper's mainloop instantiations carry an owner of their own)."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda).manual_seed(8)
    a = _randn(g, 8, 256, dtype=torch.bfloat16)
    big = _randn(g, 64, 256, dtype=torch.bfloat16)
    odd = _randn(g, 64, 250, dtype=torch.bfloat16)
    b = _randn(g, 256, 128, dtype=torch.bfloat16, scale=1 / 16)
    b_odd = _randn(g, 250, 128, dtype=torch.bfloat16, scale=1 / 16)
    r = _randn(g, 8, 128, dtype=torch.bfloat16)
    r_big = _randn(g, 64, 128, dtype=torch.bfloat16)
    s = _randn(g, 256, dtype=torch.bfloat16, scale=0.1)
    af, bf = a.float(), b.float()

    def run():
        for _ in range(3):
            matmul.matmul(a, b)             # the decode kernel
        matmul.matmul(big, b)               # the mainloop
        matmul.matmul(odd, b_odd)           # K % 8 != 0: the wmma tile
        matmul.matmul(af, bf)               # f32: split pass + 3xTF32
        fused.matmul_residual_add(a, b, r)            # the decode kernel
        fused.matmul_residual_add(big, b, r_big)      # the mainloop
        fused.matmul_residual_add(big, b, r_big)
        fused.rmsnorm_matmul(big, s, b)               # norm + the mainloop

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        edge = r.float().sum()              # kernels at the trace's edges
        run()
        edge = edge + r.float().sum()
        torch.cuda.synchronize()
    traced = launches.traced_launches(prof)
    kernels = sorted({e.key for e in prof.key_averages()
                      if "CUDA" in str(getattr(e, "device_type", ""))})
    assert traced["matmul"] == 6, (traced, kernels)
    assert traced["matmul_residual_add"] == 3, (traced, kernels)
    assert traced["rmsnorm_matmul"] == 1, (traced, kernels)
    assert traced["flash_attention_proj"] == 0, (traced, kernels)
    names = {k.replace(" ", "") for k in kernels}
    for inst in ("<128,0,2>", "<128,1,3>", "<128,0,0>"):
        assert any(f"tma_wgmma_kernel{inst}" in k for k in names), kernels


# ----------------------------------------------------------------------------
# rmsnorm, flash_attention, matmul_bias_act
# ----------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d", [(8, 5120), (512, 5120), (512, 512),
                                 (7, 100), (3, 13),
                                 # a row a block on 1, 8, 132 and 4096
                                 # blocks; rows longer than the 8192 a
                                 # block holds (read twice); short rows,
                                 # four a block
                                 (1, 5120), (132, 5120), (4096, 5120),
                                 (5, 8200), (129, 13), (33, 100)])
def test_cuda_rmsnorm(cuda, dtype, m, d):
    g = torch.Generator(device=cuda).manual_seed(9)
    x = _randn(g, m, d, dtype=DT[dtype])
    s = _randn(g, d, dtype=DT[dtype], scale=0.1)
    before = rmsnorm.launches
    got = rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    assert got.dtype == x.dtype and got.shape == (m, d)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    torch.testing.assert_close(got.float(), rmsnorm_plain(x, s).float(),
                               **tol)
    again = rmsnorm(x, s)                   # a fixed sum order: same bits
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(512, 5120), (64, 136), (20, 8200)])
def test_cuda_rmsnorm_normalises_like_the_fused_prologue(cuda, m, k):
    """rmsnorm sums the squares in the order of rmsnorm_matmul's prologue
    (norm_rows_kernel): the composition matmul(rmsnorm(x), w) equals the
    fused kernel bit for bit, on operands as large as the ops factories
    make (unscaled weights, where a single flipped bf16 rounding of the
    normalised rows would show)."""
    g = torch.Generator(device=cuda).manual_seed(18)
    x = _randn(g, m, k, dtype=torch.bfloat16)
    s = _randn(g, k, dtype=torch.bfloat16, scale=0.1)
    w = _randn(g, k, 264, dtype=torch.bfloat16)
    fused_out = fused.rmsnorm_matmul(x, s, w)
    composed = matmul.matmul(rmsnorm(x, s), w)
    torch.cuda.synchronize()
    assert torch.equal(fused_out, composed)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,hd,causal", [
    (1, 40, 8, 512, 128, True), (1, 40, 8, 512, 128, False),
    (1, 12, 12, 1000, 64, False), (1, 12, 12, 1000, 64, True),
    (2, 4, 2, 70, 128, True), (2, 6, 3, 33, 64, False),
    # B > 1, H > KV, S no 64-key or 128-row tile divides, both head sizes,
    # causal and full: a K/V box reading the next head's rows shows here
    (2, 8, 2, 200, 128, True), (2, 8, 2, 200, 128, False),
    (3, 6, 3, 130, 64, True), (3, 6, 3, 130, 64, False),
    # one query, one exact tile, a key tile of one key
    (2, 2, 1, 1, 128, True), (1, 4, 2, 64, 64, False),
    (1, 4, 1, 129, 128, True), (2, 3, 3, 4096, 64, True)])
def test_cuda_flash_attention(cuda, b, h, kv, s, hd, causal):
    g = torch.Generator(device=cuda).manual_seed(10)
    q = _randn(g, b, h, s, hd, dtype=torch.bfloat16)
    k = _randn(g, b, kv, s, hd, dtype=torch.bfloat16)
    v = _randn(g, b, kv, s, hd, dtype=torch.bfloat16)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), flash_attention_plain(
        q, k, v, causal).float(), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,act", [(12000, 768, 3072, "gelu"),
                                       (300, 3072, 768, "none"),
                                       (70, 256, 130, "silu"),
                                       (5, 520, 300, "none"),
                                       (16, 72, 264, "gelu"),
                                       (1, 768, 3072, "silu"),
                                       # the mainloop at ragged M, all
                                       # three activations; whisper's
                                       # second MLP product (persistent)
                                       (17, 136, 72, "gelu"),
                                       (200, 136, 72, "silu"),
                                       (130, 200, 200, "none"),
                                       (2000, 520, 3000, "silu"),
                                       (12000, 3072, 768, "none")])
def test_cuda_matmul_bias_act(cuda, m, k, n, act):
    g = torch.Generator(device=cuda).manual_seed(11)
    a = _randn(g, m, k, dtype=torch.bfloat16)
    b = _randn(g, k, n, dtype=torch.bfloat16, scale=k ** -0.5)
    bias = _randn(g, n, dtype=torch.bfloat16)
    before = fused.matmul_bias_act.launches
    got = fused.matmul_bias_act(a, b, bias, act)
    torch.cuda.synchronize()
    assert fused.matmul_bias_act.launches == before + 1
    assert got.dtype == a.dtype and got.shape == (m, n)
    torch.testing.assert_close(got.float(), fused.matmul_bias_act_plain(
        a, b, bias, act).float(), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (64, 16, 64),          # the mainloop, one k step
    (64, 520, 64),         # the mainloop, 9 k steps
    (2000, 16, 3000),      # persistent: 384 tiles, one k step each
    (2000, 520, 3000),     # persistent, 9 k steps a tile
    (8, 16, 64),           # the decode kernel: one k box
    (8, 3072, 768),        # whisper's second MLP product at decode
    (8, 520, 264),         # the decode kernel at K and N no box divides
    (12, 5128, 72),        # two slot tiles, K no cluster splits evenly
    (5, 100, 36)])         # K % 8 != 0: split-K
def test_cuda_matmul_bias_act_rounds_twice_like_the_kernel(cuda, m, k, n):
    """The Pallas kernel's two roundings, bf16(f32(bf16(acc)) + f32(bias)),
    bit for bit (act none: with small integers every f32 sum is exact in
    any order, so the kernel must equal the plain version exactly)."""
    g = torch.Generator(device=cuda).manual_seed(16)
    a = torch.randint(-32, 33, (m, k), generator=g, device=cuda).bfloat16()
    b = torch.randint(-32, 33, (k, n), generator=g, device=cuda).bfloat16()
    bias = (torch.randint(-64, 65, (n,), generator=g, device=cuda)
            + 0.375).bfloat16()
    got = fused.matmul_bias_act(a, b, bias, "none")
    torch.cuda.synchronize()
    want = fused.matmul_bias_act_plain(a, b, bias, "none")
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()
    once = (a.float() @ b.float() + bias.float()).bfloat16()  # one rounding
    assert not torch.equal(got, once)


@pytest.mark.cuda
def test_cuda_matmul_bias_act_runs_the_mainloop_under_its_owner(cuda):
    """At M > 16 (K, N % 8 == 0) each activation runs one
    `tma_wgmma_kernel<BN,EPI,4>` (EPI 2 bias, 3 gelu, 4 silu), which the
    trace counts as matmul_bias_act's and no other wrapper's."""
    import re

    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda).manual_seed(17)
    bf = torch.bfloat16
    a = _randn(g, 300, 768, dtype=bf)
    w = _randn(g, 768, 3072, dtype=bf, scale=768 ** -0.5)
    bias = _randn(g, 3072, dtype=bf)

    def run():
        for act in fused.ACTS:
            fused.matmul_bias_act(a, w, bias, act)

    run()
    torch.cuda.synchronize()
    launches.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        edge = bias.float().sum()           # kernels at the trace's edges
        run()
        edge = edge + bias.float().sum()
        torch.cuda.synchronize()
    traced = launches.traced_launches(prof)
    found = {}
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        m = re.search(r"tma_wgmma_kernel<(\d+),(\d+),(\d+)>",
                      e.key.replace(" ", ""))
        if m:
            found[m.group(2), m.group(3)] = found.get(
                (m.group(2), m.group(3)), 0) + e.count
    assert found == {("2", "4"): 1, ("3", "4"): 1, ("4", "4"): 1}, found
    assert traced["matmul_bias_act"] == 3 == fused.matmul_bias_act.launches
    assert sum(traced.values()) == 3, traced


@pytest.mark.cuda
def test_cuda_new_kernels_raise_rather_than_fall_back(cuda):
    """What the kernels do not take raises; no plain version runs."""
    launches.reset_counts()
    q = torch.randn(1, 2, 16, 128, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)                       # f32
    q32 = torch.randn(1, 2, 16, 32, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="hd"):
        flash_attention(q32, q32, q32)                 # hd 32
    a = torch.randn(16, 32, device=cuda)
    with pytest.raises(TypeError):
        fused.matmul_bias_act(a, a.t().contiguous(), torch.zeros(16,
                                                                 device=cuda))
    with pytest.raises(TypeError):
        rmsnorm(a.half(), torch.zeros(32, device=cuda).half())
    with pytest.raises(ValueError, match="act"):
        fused.matmul_bias_act(a.bfloat16(), a.t().contiguous().bfloat16(),
                              torch.zeros(16, device=cuda).bfloat16(), "relu")
    # the decode kernel's operands (M <= 16): f32, and a strided weight
    x8 = torch.randn(8, 64, device=cuda)
    with pytest.raises(TypeError):
        fused.rmsnorm_matmul(x8, torch.zeros(64, device=cuda),
                             torch.randn(64, 64, device=cuda))
    w = torch.randn(64, 128, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="contiguous"):
        fused.matmul_residual_add(x8.bfloat16(), w[:, ::2],
                                  torch.zeros(8, 64, device=cuda).bfloat16())
    # f32 matmul on the tensor-core route with the split pass (M > 256): a
    # launch that fails (a tensor map refused for a misaligned workspace)
    # raises; nothing falls back to the CUDA-core tile or the plain version
    from repro_torch.kernels import build

    real = build.workspace

    def misaligned(*args):
        return real(*args)[1:]

    a32, b32 = torch.randn(600, 64, device=cuda), torch.randn(64, 32,
                                                              device=cuda)
    build.workspace = misaligned
    try:
        with pytest.raises(RuntimeError, match="matmul"):
            matmul.matmul(a32, b32)
    finally:
        build.workspace = real
    counts = launches.counts()
    assert all(c == {"launches": 0, "plain_cuda_calls": 0}
               for c in counts.values()), counts


@pytest.mark.cuda
def test_cuda_traced_launches_of_the_new_kernels(cuda):
    """A trace counts each new kernel's launches by its entry kernel:
    matmul_bias_act's three activations on the decode kernel and on the
    mainloop apart from matmul's and matmul_residual_add's."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda).manual_seed(12)
    bf = torch.bfloat16
    small, big = _randn(g, 8, 256, dtype=bf), _randn(g, 64, 256, dtype=bf)
    w = _randn(g, 256, 128, dtype=bf, scale=1 / 16)
    bias = _randn(g, 128, dtype=bf)
    q = _randn(g, 1, 4, 64, 64, dtype=bf)
    x = _randn(g, 8, 256)

    def run():
        for act in fused.ACTS:
            fused.matmul_bias_act(small, w, bias, act)   # decode kernel
            fused.matmul_bias_act(big, w, bias, act)     # the mainloop
        matmul.matmul(big, w)
        rmsnorm(x, x[0])
        rmsnorm(small, small[0])
        flash_attention(q, q, q)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        edge = x.sum()                      # kernels at the trace's edges
        run()
        edge = edge + x.sum()
        torch.cuda.synchronize()
    traced = launches.traced_launches(prof)
    kernels = sorted({e.key for e in prof.key_averages()
                      if "CUDA" in str(getattr(e, "device_type", ""))})
    assert traced["matmul_bias_act"] == 6, (traced, kernels)
    assert traced["matmul"] == 1, (traced, kernels)
    assert traced["rmsnorm"] == 2, (traced, kernels)
    assert traced["flash_attention"] == 1, (traced, kernels)
    assert traced["matmul_residual_add"] == 0, (traced, kernels)
    assert traced["rmsnorm_matmul"] == 0, (traced, kernels)
    assert traced["flash_attention_proj"] == 0, (traced, kernels)


@pytest.mark.cuda
def test_cuda_traced_launches_of_the_wgmma_paths(cuda):
    """rmsnorm_matmul's and flash_attention_proj's wgmma paths open with
    kernels of their own: a trace counts each launch on its own wrapper,
    beside flash_attention's and matmul's, and rmsnorm_matmul's three
    paths (the decode kernel, wgmma, the wmma tile for N % 8 != 0) all
    count as rmsnorm_matmul's."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda).manual_seed(13)
    bf = torch.bfloat16
    x = _randn(g, 64, 256, dtype=bf)
    s = _randn(g, 256, dtype=bf, scale=0.1)
    w = _randn(g, 256, 128, dtype=bf, scale=1 / 16)
    w_odd = _randn(g, 256, 130, dtype=bf, scale=1 / 16)
    q = _randn(g, 1, 4, 64, 128, dtype=bf)
    kv = _randn(g, 1, 2, 64, 128, dtype=bf)
    wo = _randn(g, 4, 128, 256, dtype=bf, scale=1 / 16)

    def run():
        fused.rmsnorm_matmul(x, s, w)                 # wgmma path
        fused.rmsnorm_matmul(x, s, w)
        fused.rmsnorm_matmul(x[:8], s, w)             # the decode kernel
        fused.rmsnorm_matmul(x, s, w_odd)             # the wmma tile
        fused.flash_attention_proj(q, kv, kv, wo)
        flash_attention(q, kv, kv)
        matmul.matmul(x, w)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        edge = x.float().sum()              # kernels at the trace's edges
        run()
        edge = edge + x.float().sum()
        torch.cuda.synchronize()
    traced = launches.traced_launches(prof)
    kernels = sorted({e.key for e in prof.key_averages()
                      if "CUDA" in str(getattr(e, "device_type", ""))})
    assert traced["rmsnorm_matmul"] == 4, (traced, kernels)
    assert traced["flash_attention_proj"] == 1, (traced, kernels)
    assert traced["flash_attention"] == 1, (traced, kernels)
    assert traced["matmul"] == 1, (traced, kernels)
    assert traced["rmsnorm"] == 0, (traced, kernels)
    assert traced["matmul_residual_add"] == 0, (traced, kernels)
    assert any("tma_wgmma_kernel" in k for k in kernels), kernels


# ----------------------------------------------------------------------------
# the decode kernel (csrc/decode_gemm.cuh): every M <= 16 product with K and
# N multiples of 8
# ----------------------------------------------------------------------------

# op -> (wrapper, the plain version's extra operand, act)
DECODE_OPS = ("rmsnorm_matmul", "matmul_residual_add", "bias_none",
              "bias_gelu", "bias_silu", "matmul")
# qwen3-14b's decode products (k and v, q and o, gate and up, down) and
# whisper-small's MLP pair, each under the op that runs it
DECODE_MODEL = [(5120, 1024, "rmsnorm_matmul"), (5120, 5120, "rmsnorm_matmul"),
                (5120, 5120, "matmul_residual_add"),
                (5120, 17408, "rmsnorm_matmul"),
                (17408, 5120, "matmul_residual_add"),
                (768, 3072, "bias_gelu"), (3072, 768, "bias_none")]
# K that no cluster splits evenly, N that no 64-column box divides
DECODE_RAGGED = [(5128, 264), (5128, 72), (136, 72)]


def _decode_case(cuda, seed, m, k, n, op):
    """(call, plain call, wrapper name) of one decode product on seeded
    bf16 operands."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    bf = torch.bfloat16
    a = _randn(g, m, k, dtype=bf)
    w = _randn(g, k, n, dtype=bf, scale=k ** -0.5)
    if op == "rmsnorm_matmul":
        s = _randn(g, k, dtype=bf, scale=0.1)
        return (lambda: fused.rmsnorm_matmul(a, s, w),
                lambda: fused.rmsnorm_matmul_plain(a, s, w), op)
    if op == "matmul_residual_add":
        r = _randn(g, m, n, dtype=bf)
        return (lambda: fused.matmul_residual_add(a, w, r),
                lambda: fused.matmul_residual_add_plain(a, w, r), op)
    if op == "matmul":
        return (lambda: matmul.matmul(a, w),
                lambda: matmul.matmul_plain(a, w), op)
    act = op.split("_")[1]
    bias = _randn(g, n, dtype=bf)
    return (lambda: fused.matmul_bias_act(a, w, bias, act),
            lambda: fused.matmul_bias_act_plain(a, w, bias, act),
            "matmul_bias_act")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 5, 8, 12, 16])
@pytest.mark.parametrize("k,n,op", DECODE_MODEL)
def test_cuda_decode_products_at_model_shapes(cuda, m, k, n, op):
    """Each model shape against its plain version, one launch a call, no
    workspace, the same bits on a second run."""
    call, plain, name = _decode_case(cuda, 20, m, k, n, op)
    wrapper = launches.WRAPPERS[name]
    before = wrapper.launches
    got = call()
    again = call()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), plain().float(), **BF16_TOL)
    from repro_torch.kernels import build
    assert build.entry(name, f"{name}_workspace_floats")(m, n, k) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 12])
@pytest.mark.parametrize("op", DECODE_OPS)
@pytest.mark.parametrize("k,n", DECODE_RAGGED)
def test_cuda_decode_products_at_ragged_edges(cuda, k, n, op, m):
    """Every prologue and epilogue at K no cluster splits evenly (a
    cluster's last CTA streams fewer k boxes, zero-filled past K) and N no
    box divides (columns past N zero-filled, not stored)."""
    call, plain, name = _decode_case(cuda, 21, m, k, n, op)
    got = call()
    again = call()
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), plain().float(), **BF16_TOL)


@pytest.mark.cuda
def test_cuda_decode_graph_replay_equals_eager(cuda):
    """The decode kernel captured in a CUDA graph (a cluster launch with
    its tensor map passed by value) gives the eager call's bits."""
    calls = [_decode_case(cuda, 22, 8, 5120, n, op)[0]
             for n, op in ((5120, "rmsnorm_matmul"),
                           (5120, "matmul_residual_add"),
                           (3072, "bias_silu"), (1024, "matmul"))]
    eager = [c() for c in calls]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        outs = [c() for c in calls]
    for o in outs:
        o.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(outs, eager):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_decode_runs_one_kernel_a_call(cuda):
    """At M <= 16 (K, N % 8 == 0) each wrapper launches one
    `decode::tma_gemv_kernel<NORM,EPI>` a call and no split-K kernel; at K
    % 8 != 0 the split-K pair runs instead."""
    from torch.profiler import ProfilerActivity, profile

    cases = [_decode_case(cuda, 23, 8, 512, 256, op) for op in DECODE_OPS]
    odd = _decode_case(cuda, 23, 8, 100, 256, "matmul_residual_add")

    def run():
        for call, _, _ in cases:
            call()
        odd[0]()

    run()
    torch.cuda.synchronize()
    launches.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        edge = torch.zeros(8, device=cuda).sum()   # kernels at the edges
        run()
        edge = edge + torch.zeros(8, device=cuda).sum()
        torch.cuda.synchronize()
    found = {}
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        key = e.key.replace(" ", "")
        for kind in ("decode::tma_gemv_kernel<", "skinny::partial_kernel<",
                     "skinny::finish_kernel<"):
            if kind in key:
                inst = key[key.index(kind):key.index(">", key.index(kind)) + 1]
                found[inst] = found.get(inst, 0) + e.count
    assert found == {"decode::tma_gemv_kernel<true,0>": 1,
                     "decode::tma_gemv_kernel<false,1>": 1,
                     "decode::tma_gemv_kernel<false,2>": 1,
                     "decode::tma_gemv_kernel<false,3>": 1,
                     "decode::tma_gemv_kernel<false,4>": 1,
                     "decode::tma_gemv_kernel<false,0>": 1,
                     "skinny::partial_kernel<false,1>": 1,
                     "skinny::finish_kernel<1>": 1}, found
    traced = launches.traced_launches(prof)
    assert traced["matmul_residual_add"] == 2
    assert traced["matmul_bias_act"] == 3
    assert traced["rmsnorm_matmul"] == traced["matmul"] == 1


@pytest.mark.cuda
def test_cuda_decode_chain_reads_what_the_kernel_before_wrote(cuda):
    """Decode products chained back to back, eager and replayed from a
    CUDA graph: each reads, as its weight, its x or its residual, the
    output of the decode launch just before it (which lets it start early,
    programmatic dependent launch). Each step equals its plain version on
    the inputs the kernels gave it, so a load made before the kernel before
    had finished shows as a wrong step."""
    g = torch.Generator(device=cuda).manual_seed(24)
    bf = torch.bfloat16
    b = _randn(g, 16, 17408, dtype=bf)           # a long first launch
    c = _randn(g, 17408, 256, dtype=bf, scale=17408 ** -0.5)
    a = _randn(g, 8, 16, dtype=bf)
    s = _randn(g, 256, dtype=bf, scale=0.1)
    w2 = _randn(g, 256, 512, dtype=bf, scale=256 ** -0.5)
    w3 = _randn(g, 512, 512, dtype=bf, scale=512 ** -0.5)
    a4 = _randn(g, 4, 8, dtype=bf)
    bias = _randn(g, 512, dtype=bf)

    def chain():
        w1 = matmul.matmul(b, c)                  # (16, 256)
        y = matmul.matmul(a, w1)                  # w1 as the weight, K 16
        z = fused.rmsnorm_matmul(y, s, w2)        # y as x
        r = fused.matmul_residual_add(z, w3, z)   # z as x and residual
        o = fused.matmul_bias_act(a4, r, bias, "silu")   # r as the weight
        return w1, y, z, r, o

    def check(outs):
        w1, y, z, r, o = outs
        want = (matmul.matmul_plain(b, c), matmul.matmul_plain(a, w1),
                fused.rmsnorm_matmul_plain(y, s, w2),
                fused.matmul_residual_add_plain(z, w3, z),
                fused.matmul_bias_act_plain(a4, r, bias, "silu"))
        for i, (got, ref) in enumerate(zip(outs, want)):
            torch.testing.assert_close(got.float(), ref.float(), **BF16_TOL,
                                       msg=lambda m, i=i: f"step {i}: {m}")

    for _ in range(3):
        eager = chain()
        torch.cuda.synchronize()
        check(eager)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        outs = chain()
    for _ in range(3):
        for t in outs:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        check(outs)
        for got, want in zip(outs, eager):
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_decode_leaves_k_past_its_limit_to_split_k(cuda):
    """Past K = 32768 x's slice no longer fits a CTA of an eight-CTA
    cluster: such an M <= 16 product keeps the split-K pair (with its f32
    workspace) and still matches the plain version."""
    from repro_torch.kernels import build

    k = 32768 + 8
    for op in ("rmsnorm_matmul", "matmul_residual_add"):
        call, plain, name = _decode_case(cuda, 25, 8, k, 64, op)
        assert build.entry(name, f"{name}_workspace_floats")(8, 64, k) > 0
        assert build.entry(name, f"{name}_workspace_floats")(8, 64,
                                                             32768) == 0
        torch.testing.assert_close(call().float(), plain().float(),
                                   **BF16_TOL)


# ----------------------------------------------------------------------------
# the plain route's products on the tensor cores, and the MoE step's graph
# ----------------------------------------------------------------------------

def _narrow(schedule="auto"):
    import dataclasses

    from repro_torch.configs import get
    return dataclasses.replace(get("qwen3-14b"), n_layers=2, d_model=256,
                               n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
                               attn_chunk=8, attn_schedule=schedule)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["auto", "direct"])
def test_cuda_plain_route_runs_bf16_products(cuda, schedule, monkeypatch):
    """The plain route ("tuned"; at S = 40 and chunk 8 "auto" is the
    masked schedule) on the card: every product outside a kernel is one
    `mm` / `bmm` on bf16 operands (no einsum, no f32 operand), and the
    logits agree with the CPU's f32 products within the agree lines'
    5e-2; so do a decode step's cache rows, at 2e-2 (one layer's bf16
    rounding)."""
    import numpy as np

    from repro_torch.cluster.policy import use_policy
    from repro_torch.models import steps

    cfg = _narrow(schedule)
    params = steps.init_params(cfg, 1, device="cpu")
    gpu = _to_cuda(params, cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)))
    with torch.inference_mode(), use_policy("tuned"):
        want = steps.logits(params, steps.forward(cfg, params, tokens)[0])
        seen = []
        for name in ("mm", "bmm", "einsum"):
            real = getattr(torch, name)

            def spy(*a, _real=real, _name=name, **kw):
                ts = [t for t in a if isinstance(t, torch.Tensor)]
                seen.append((_name, tuple(t.dtype for t in ts),
                             ts[0].is_cuda if ts else False))
                return _real(*a, **kw)

            monkeypatch.setattr(torch, name, spy)
        got = steps.logits(gpu, steps.forward(cfg, gpu, tokens.to(cuda))[0])
        monkeypatch.undo()
    on_card = [s for s in seen if s[2]]
    assert on_card and all(n in ("mm", "bmm") for n, _, _ in on_card)
    # the vocabulary projection takes f32 hidden states nowhere: bf16 only
    assert all(d == (torch.bfloat16, torch.bfloat16) for _, d, _ in on_card)
    torch.testing.assert_close(got.cpu(), want, rtol=5e-2, atol=5e-2)

    with torch.inference_mode(), use_policy("tuned"):
        step = steps.make_decode_step(cfg, max_seq=16)
        caches = [steps.init_cache(cfg, 2, 16, device=d)
                  for d in ("cpu", cuda)]
        for pos in range(5):
            for c, p in zip(caches, (params, gpu)):
                step(p, c, {"tokens": tokens[:, pos:pos + 1].to(
                    c["k"].device), "pos": pos})
    for key in ("k", "v"):
        torch.testing.assert_close(caches[1][key].cpu().float(),
                                   caches[0][key].float(), **BF16_TOL)


def _to_cuda(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_cuda(v, device) for k, v in tree.items()}
    return [_to_cuda(v, device) for v in tree]


@pytest.mark.cuda
def test_cuda_score_product_has_an_f32_result(cuda):
    """The scores' product (`preferred_element_type=F32` in the
    reference) on bf16 operands: an f32 tensor equal to the f64 product
    of the same values within 1e-5 (bf16 products are exact in f32; sum
    order only); asked for bf16, the rounded result (one bf16 rounding)."""
    from repro_torch.models.layers import product

    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(2, 64, 2, 4, 128, generator=g, device=cuda).bfloat16()
    k = torch.randn(2, 96, 2, 128, generator=g, device=cuda).bfloat16()
    eq = "bqkgd,bskd->bkgqs"
    s = product(eq, q, k, torch.float32)
    assert s.dtype == torch.float32 and s.shape == (2, 2, 4, 64, 96)
    want = torch.einsum(eq, q.double(), k.double())
    torch.testing.assert_close(s.double(), want, rtol=1e-5, atol=1e-5)
    b = product(eq, q, k, torch.bfloat16)
    assert b.dtype == torch.bfloat16
    torch.testing.assert_close(b.float(), s.bfloat16().float(), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
def test_cuda_graphed_moe_step_equals_eager(cuda, local):
    """mixtral-8x7b-smoke's decode step (the MoE dispatch: top-k, the
    capacity scatter to a scratch column, the gathers and the index_add
    combine) captured as a CUDA graph gives the eager step's tokens and
    caches bit for bit, over 24 positions (the 16-row cache rolls); so
    does its 24-token prefill (banded attention) under "fused"."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get
    from repro_torch.models import steps
    from repro_torch.runtime.compile_cache import Graphed

    cfg = dataclasses.replace(get("mixtral-8x7b-smoke"),
                              moe_local_dispatch=local)
    params = steps.init_params(cfg, 0, device=cuda, max_seq=64)
    step = steps.make_decode_step(cfg, max_seq=64, policy="fused")
    graphed = Graphed(step, copied=(2,))
    clen = steps.decode_cache_len(cfg, 64)
    assert clen == 16
    caches = [steps.init_cache(cfg, 4, clen, device=cuda) for _ in range(2)]
    rng = np.random.default_rng(0)
    toks = [torch.as_tensor(rng.integers(1, cfg.vocab, (4, 1)),
                            dtype=torch.int32, device=cuda)] * 2
    for pos in range(24):
        _, a = step(params, caches[0], {"tokens": toks[0], "pos": pos})
        _, b = graphed(params, caches[1], {"tokens": toks[1], "pos": pos})
        assert torch.equal(a, b)
        toks = [a, b]
    assert graphed.graphs.misses == 1
    for key in ("k", "v"):
        assert torch.equal(caches[0][key], caches[1][key])
    prefill = steps.make_prefill_step(cfg, policy="fused")
    batch = {"tokens": torch.as_tensor(rng.integers(1, cfg.vocab, (2, 24)),
                                       device=cuda)}
    eager = prefill.eager(params, batch)
    prefill(params, batch)                          # capture
    assert torch.equal(prefill(params, batch), eager)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma-9b-smoke",
                                  "xlstm-125m-smoke",
                                  "llama-3.2-vision-90b-smoke"])
def test_cuda_graphed_recurrent_step_equals_eager(cuda, arch):
    """The decode step of each mixed-kind arch (rglru + local_attn;
    mlstm + slstm; attn + cross) captured as a CUDA graph gives the eager
    step's tokens and caches bit for bit over 24 positions (recurrentgemma's
    16-row local caches roll), under "fused". The graph writes every state
    in place: each cache tensor keeps its address, and the recurrent
    leaves change from replay to replay. The 24-token prefill (with 8
    image embeddings for the vision arch, its heads widened to 128 for
    flash_attention_proj) replays the eager tokens."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get
    from repro_torch.models import steps
    from repro_torch.runtime.compile_cache import Graphed

    cfg = get(arch)
    if cfg.n_img_tokens:        # flash_attention_proj takes heads of 128
        cfg = dataclasses.replace(cfg, head_dim=128)
    params = steps.init_params(cfg, 0, device=cuda, max_seq=64)
    step = steps.make_decode_step(cfg, max_seq=64, policy="fused")
    graphed = Graphed(step, copied=(2,))
    clen = steps.decode_cache_len(cfg, 64)
    caches = [steps.init_cache(cfg, 4, clen, device=cuda) for _ in range(2)]
    ptrs = {k: v.data_ptr() for k, v in caches[1].items()}
    rng = np.random.default_rng(0)
    toks = [torch.as_tensor(rng.integers(1, cfg.vocab, (4, 1)),
                            dtype=torch.int32, device=cuda)] * 2
    before = None
    for pos in range(24):
        _, a = step(params, caches[0], {"tokens": toks[0], "pos": pos})
        _, b = graphed(params, caches[1], {"tokens": toks[1], "pos": pos})
        assert torch.equal(a, b)
        toks = [a, b]
        now = {k: v.clone() for k, v in caches[1].items()}
        if before is not None and pos > 2:
            moved = [k for k in now if not torch.equal(now[k], before[k])]
            assert moved, f"position {pos}: no cache leaf changed"
        before = now
    assert graphed.graphs.misses == 1
    assert {k: v.data_ptr() for k, v in caches[1].items()} == ptrs
    for key in caches[0]:
        assert torch.equal(caches[0][key], caches[1][key]), key
    state = [k for k in caches[1] if k.split(".")[-1] in
             ("h", "conv", "C", "n", "m", "c")]
    assert all(caches[1][k].abs().sum() > 0 for k in state)
    prefill = steps.make_prefill_step(cfg, policy="fused")
    batch = {"tokens": torch.as_tensor(rng.integers(1, cfg.vocab, (2, 24)),
                                       device=cuda)}
    if cfg.n_img_tokens:
        batch["img_embeds"] = torch.randn(
            2, cfg.n_img_tokens, cfg.d_model, device=cuda).bfloat16()
    eager = prefill.eager(params, batch)
    prefill(params, batch)                          # capture
    assert torch.equal(prefill(params, batch), eager)


# ----------------------------------------------------------------------------
# the tuning layer: pinned plans reach the launch
# ----------------------------------------------------------------------------

GEMMS = ("matmul", "rmsnorm_matmul", "matmul_residual_add",
         "matmul_bias_act")


def _gemm_call(name, m, k, n, g):
    """(kernel call taking the plan knobs, plain version) of GEMM `name`
    on seeded bf16 operands."""
    x = _randn(g, m, k, dtype=torch.bfloat16)
    w = _randn(g, k, n, dtype=torch.bfloat16, scale=k ** -0.5)
    extra = {"rmsnorm_matmul": _randn(g, k, dtype=torch.bfloat16, scale=0.1),
             "matmul_residual_add": _randn(g, m, n, dtype=torch.bfloat16),
             "matmul_bias_act": _randn(g, n, dtype=torch.bfloat16)}.get(name)
    if name == "matmul":
        return (lambda **kw: matmul.matmul(x, w, **kw),
                lambda: matmul.matmul_plain(x, w))
    if name == "rmsnorm_matmul":
        return (lambda **kw: fused.rmsnorm_matmul(x, extra, w, **kw),
                lambda: fused.rmsnorm_matmul_plain(x, extra, w))
    fn, plain = {"matmul_residual_add": (fused.matmul_residual_add,
                                         fused.matmul_residual_add_plain),
                 "matmul_bias_act": (fused.matmul_bias_act,
                                     fused.matmul_bias_act_plain)}[name]
    return (lambda **kw: fn(x, w, extra, **kw), lambda: plain(x, w, extra))


@pytest.mark.cuda
@pytest.mark.parametrize("name", GEMMS)
def test_cuda_pinned_tile_n_reaches_the_launch(cuda, name):
    """Every N tile of the mainloop's tune space, pinned, runs that tile
    (the traced instantiation and `wgmma_plan` name it) and equals the
    plain version; a tile outside TILE_N raises."""
    from repro_torch.kernels import gemm_plans, pipeline

    m, k, n = 512, 1024, 1280
    g = torch.Generator(device="cuda").manual_seed(3)
    call, plain = _gemm_call(name, m, k, n, g)
    want = plain()
    space = list(pipeline.KERNELS[name].tune_space(
        {"m": m, "k": k, "n": n}, 2))
    assert [c["tile_n"] for c in space] == list(gemm_plans.TILE_N)
    for cand in space:
        torch.testing.assert_close(call(**cand).float(), want.float(),
                                   **BF16_TOL)
        names, _ = _traced_kernels(lambda: call(**cand))
        mainloop = [k for k in names if "tma_wgmma_kernel<" in k]
        assert len(mainloop) == 1 and \
            f"tma_wgmma_kernel<{cand['tile_n']}," in mainloop[0], names
        assert gemm_plans.wgmma_plan(name, m, n, cand["tile_n"])[0] == \
            cand["tile_n"]
    for bad in ({"tile_n": 192}, {"boxes": 2}, {"cluster": 2}):
        with pytest.raises(RuntimeError):
            call(**bad)
            torch.cuda.synchronize()
    with pytest.raises(RuntimeError):
        gemm_plans.wgmma_plan(name, m, n, 192)


@pytest.mark.cuda
@pytest.mark.parametrize("name", GEMMS)
def test_cuda_pinned_decode_plan_reaches_the_launch(cuda, name):
    """Each (boxes, cluster) of the decode kernel's tune space runs with
    the N tile and cluster the plan report names and equals the plain
    version; a plan `fit` rejects, or a mainloop knob, raises."""
    from repro_torch.kernels import gemm_plans, pipeline

    m, k, n = 8, 2048, 1024
    g = torch.Generator(device="cuda").manual_seed(4)
    call, plain = _gemm_call(name, m, k, n, g)
    want = plain()
    space = list(pipeline.KERNELS[name].tune_space(
        {"m": m, "k": k, "n": n}, 2))
    assert len(space) > 8
    for cand in space:
        torch.testing.assert_close(call(**cand).float(), want.float(),
                                   **BF16_TOL)
        bn, cluster = gemm_plans.decode_plan(name, m, k, n, **cand)[:2]
        assert (bn, cluster) == (cand["boxes"] * 64, cand["cluster"])
    own = pipeline.KERNELS[name].own_plan({"m": m, "k": k, "n": n}, 2)
    assert own in space
    for bad in ({"boxes": 9}, {"cluster": 9}, {"tile_n": 128}):
        with pytest.raises(RuntimeError):
            call(**bad)
            torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_pinned_f32_plan_and_projection(cuda):
    """The 3xTF32 product's (tile_n, cluster) and flash_attention_proj's
    projection tile, pinned, equal their plain versions; pins the kernel
    cannot take raise."""
    from repro_torch.kernels import gemm_plans, pipeline

    g = torch.Generator(device="cuda").manual_seed(5)
    a, b = _randn(g, 256, 512), _randn(g, 512, 256)
    want = matmul.matmul_plain(a, b)
    shapes = {"m": 256, "k": 512, "n": 256}
    for cand in pipeline.KERNELS["matmul"].tune_space(shapes, 4):
        torch.testing.assert_close(matmul.matmul(a, b, **cand), want,
                                   rtol=0, atol=1e-4 * 512 ** 0.5)
        plan = gemm_plans.f32_plan(256, 512, 256, **cand)
        assert (plan[1], plan[2]) == (cand["tile_n"], cand["cluster"])
    for bad in ({"tile_n": 96}, {"boxes": 1}, {"cluster": 9}):
        with pytest.raises(RuntimeError):
            matmul.matmul(a, b, **bad)
    q = _randn(g, 1, 4, 128, 128, dtype=torch.bfloat16)
    kv = [_randn(g, 1, 2, 128, 128, dtype=torch.bfloat16) for _ in range(2)]
    wo = _randn(g, 4, 128, 256, dtype=torch.bfloat16, scale=0.05)
    want = fused.flash_attention_proj_plain(q, *kv, wo)
    for bn in gemm_plans.TILE_N:
        torch.testing.assert_close(
            fused.flash_attention_proj(q, *kv, wo, tile_n=bn).float(),
            want.float(), **BF16_TOL)
    with pytest.raises(RuntimeError):
        fused.flash_attention_proj(q, *kv, wo, tile_n=100)


@pytest.mark.cuda
def test_cuda_tuned_call_races_then_hits_and_refuses_a_capture_miss(cuda):
    """A timed tuned_call on the card races (CUDA events), keeps a record
    naming the kernel's own plan as its default, matches the plain
    version, and hits inside a CUDA-graph capture; a miss inside a
    capture raises."""
    from repro_torch.cluster import KernelPolicy, use_policy
    from repro_torch.configs import registry
    from repro_torch.kernels import ops, pipeline

    registry.KERNEL_TUNES.clear()
    g = torch.Generator(device="cuda").manual_seed(6)
    call, plain = _gemm_call("matmul_residual_add", 256, 512, 768, g)
    x = _randn(g, 256, 512, dtype=torch.bfloat16)
    w = _randn(g, 512, 768, dtype=torch.bfloat16, scale=512 ** -0.5)
    r = _randn(g, 256, 768, dtype=torch.bfloat16)
    pol = KernelPolicy(mode="fused", tuning="timed")
    with use_policy(pol):
        got = ops.tuned_call("matmul_residual_add", x, w, r)
    torch.testing.assert_close(
        got.float(), fused.matmul_residual_add_plain(x, w, r).float(),
        **BF16_TOL)
    rec = registry.get_kernel_tune("matmul_residual_add", pipeline.shape_key(
        {"m": 256, "k": 512, "n": 768}, 2))
    assert rec.source == "timed" and pol.stats["tune_races"] == 1
    assert dict(rec.default_blocks) == pipeline.KERNELS[
        "matmul_residual_add"].own_plan({"m": 256, "k": 512, "n": 768}, 2)
    assert rec.measured_us <= rec.default_us
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with use_policy(pol), torch.cuda.graph(graph, stream=side,
                                           capture_error_mode="thread_local"):
        out = ops.tuned_call("matmul_residual_add", x, w, r)
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, got)
    assert pol.stats["tune_hits"] == 1
    # a miss inside a capture (a raw one: a failed torch capture leaves
    # torch's generator capturing) raises before anything is captured
    import ctypes

    x2, r2 = x[:128].contiguous(), r[:128].contiguous()
    rt, handle = _cudart(), ctypes.c_void_p(side.cuda_stream)
    torch.cuda.synchronize()
    assert rt.cudaStreamBeginCapture(handle, 2) == 0      # relaxed mode
    with torch.cuda.stream(side), use_policy(pol):
        with pytest.raises(RuntimeError, match="capture"):
            ops.tuned_call("matmul_residual_add", x2, w, r2)
    raw = ctypes.c_void_p()
    assert rt.cudaStreamEndCapture(handle, ctypes.byref(raw)) == 0
    if raw.value:
        rt.cudaGraphDestroy(raw)
    assert pol.stats["tune_misses"] == 1         # the refused miss: none
    registry.KERNEL_TUNES.clear()


# ----------------------------------------------------------------------------
# Training: the fused ops' autograd Functions, the f32-result product's
# VJP, a train step at qwen3-14b's width
# ----------------------------------------------------------------------------

def _fused_case(name, cuda):
    """(op, its operands: bf16 on the card, requiring grad) at a shape of
    the train path's kind (flash_attention_proj: heads of 128)."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=cuda).manual_seed(7)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=cuda)
                * scale).bfloat16().requires_grad_()

    if name == "rmsnorm_matmul":
        return ops.rmsnorm_matmul, (r(256, 512), r(512, scale=0.1),
                                    r(512, 384, scale=512 ** -0.5))
    if name == "matmul_residual_add":
        return ops.matmul_residual_add, (r(256, 768),
                                         r(768, 512, scale=768 ** -0.5),
                                         r(256, 512))
    if name == "matmul_bias_act":
        return (lambda a, b, bias: ops.matmul_bias_act(a, b, bias,
                                                       act="silu"),
                (r(256, 512), r(512, 384, scale=512 ** -0.5), r(384)))
    return ops.flash_attention_proj, (r(2, 8, 256, 128), r(2, 2, 256, 128),
                                      r(2, 2, 256, 128),
                                      r(8, 128, 512, scale=1024 ** -0.5))


_FUSED_FN = {"rmsnorm_matmul": "RmsnormMatmulFn",
             "matmul_residual_add": "MatmulResidualAddFn",
             "matmul_bias_act": "MatmulBiasActFn",
             "flash_attention_proj": "FlashAttentionProjFn"}


def _composition(name):
    """The reference's `_ref_*` composition of `name` through
    `layers.product` (the function the fused op's VJP differentiates)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.models.layers import product
    f32 = torch.float32
    return {
        "rmsnorm_matmul": lambda x, s, w: product(
            "mk,kn->mn", kref.rmsnorm(x, s), w, x.dtype),
        "matmul_residual_add": lambda a, b, r: (
            product("mk,kn->mn", a, b, f32) + r.to(f32)).to(a.dtype),
        "matmul_bias_act": lambda a, b, bias: kref.ACTIVATIONS["silu"](
            product("mk,kn->mn", a, b, f32) + bias.to(f32)).to(a.dtype),
        "flash_attention_proj": lambda q, k, v, wo: product(
            "bhsk,hkd->bsd", ops._attention(True, q, k, v), wo, q.dtype),
    }[name]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_attention_proj", "matmul_bias_act",
                                  "matmul_residual_add", "rmsnorm_matmul"])
def test_cuda_fused_op_backward_is_its_composition(cuda, name):
    """Under "fused" the op launches its kernel once, its output's grad_fn
    is its autograd Function's, and its gradients are the VJP of the
    reference composition on the card: bit for bit the Function's `vjp`,
    within 1e-2 relative L2 of autograd through the composition itself
    (the VJP's transposed products are other cuBLAS calls than autograd's
    of the forward one), and within bf16 tolerance (2e-2) of f32 autograd
    through the plain oracle on the upcast inputs."""
    from repro_torch.cluster.policy import use_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref

    op, xs = _fused_case(name, cuda)
    fn_cls = getattr(ops, _FUSED_FN[name])
    vjp = {"rmsnorm_matmul": ops._vjp_rmsnorm_matmul,
           "matmul_residual_add": ops._vjp_matmul_residual_add,
           "matmul_bias_act": lambda *a: ops._vjp_matmul_bias_act("silu", *a),
           "flash_attention_proj": lambda *a: ops._vjp_flash_attention_proj(
               True, *a)}[name]
    oracle = {"rmsnorm_matmul": kref.rmsnorm_matmul,
              "matmul_residual_add": kref.matmul_residual_add,
              "matmul_bias_act": lambda *a: kref.matmul_bias_act(*a, "silu"),
              "flash_attention_proj": kref.flash_attention_proj}[name]
    launches.reset_counts()
    with use_policy("fused"):
        out = op(*xs)
    torch.cuda.synchronize()
    c = launches.counts()[name]
    assert c == {"launches": 1, "plain_cuda_calls": 0}, c
    assert type(out.grad_fn).__name__ == fn_cls.__name__ + "Backward"
    gout = torch.randn(out.shape, generator=torch.Generator(
        device=cuda).manual_seed(8), device=cuda).bfloat16()
    got = torch.autograd.grad(out, xs, gout)
    own = vjp(gout, (True,) * len(xs), *[x.detach() for x in xs])
    comp = torch.autograd.grad(_composition(name)(*xs), xs, gout)
    x32 = [x.detach().float().requires_grad_() for x in xs]
    f32 = torch.autograd.grad(oracle(*x32), x32, gout.float())
    for a, b, c, d in zip(got, own, comp, f32):
        assert torch.equal(a, b)
        assert float((a.float() - c.float()).norm() / c.float().norm()) \
            < 1e-2
        assert torch.isfinite(a).all() and a.abs().max() > 0
        rel = float((a.float() - d).norm() / d.norm())
        assert rel < 2e-2, rel


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_attention_proj", "matmul_bias_act",
                                  "matmul_residual_add", "rmsnorm_matmul"])
def test_cuda_unfused_route_under_grad(cuda, name, monkeypatch):
    """A tune record whose race picked the composition: `tuned_call` under
    grad launches the composition's primitive kernels inside the op's
    Function (no refusal, no plain version on the card), and its
    gradients equal the fused route's bit for bit (the same VJP of the
    same inputs)."""
    from repro_torch.cluster.policy import KernelPolicy, use_policy
    from repro_torch.configs import registry
    from repro_torch.kernels import ops

    def unfused(kernel, key):
        route = "unfused" if ops.OPS[kernel].fused else "fused"
        return registry.KernelTuneRecord(kernel, key, (), 0.0, route=route)

    monkeypatch.setattr(registry, "get_kernel_tune", unfused)
    op, xs = _fused_case(name, cuda)
    kw = {"act": "silu"} if name == "matmul_bias_act" else {}
    gout = None
    grads = []
    for tuned in (True, False):
        x = [t.detach().clone().requires_grad_() for t in xs]
        pol = KernelPolicy(mode="tuned" if tuned else "fused")
        launches.reset_counts()
        with use_policy(pol):
            out = ops.tuned_call(name, *x, **kw) if tuned else op(*x)
        torch.cuda.synchronize()
        counts = launches.counts()
        assert not any(c["plain_cuda_calls"] for c in counts.values())
        assert type(out.grad_fn).__name__ == _FUSED_FN[name] + "Backward"
        if tuned:
            assert pol.stats["unfused_routes"] == 1
            assert counts[name]["launches"] == 0
            prims = ("flash_attention",) if name == "flash_attention_proj" \
                else ("matmul",) + (("rmsnorm",) if name == "rmsnorm_matmul"
                                    else ())
            assert all(counts[p]["launches"] == 1 for p in prims), counts
        if gout is None:
            gout = torch.randn(out.shape, generator=torch.Generator(
                device=cuda).manual_seed(8), device=cuda).bfloat16()
        grads.append(torch.autograd.grad(out, x, gout))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_kernel_wrapper_refuses_operands_that_require_grad(cuda):
    """A launch outside its autograd Function would return a result with
    no gradient: the wrapper raises instead (and launches nothing)."""
    x = torch.randn(32, 64, device=cuda).bfloat16().requires_grad_()
    s = torch.zeros(64, device=cuda).bfloat16()
    w = torch.randn(64, 32, device=cuda).bfloat16()
    before = fused.rmsnorm_matmul.launches
    with pytest.raises(RuntimeError, match="requires grad"):
        fused.rmsnorm_matmul(x, s, w)
    assert fused.rmsnorm_matmul.launches == before
    with torch.no_grad():
        assert fused.rmsnorm_matmul(x, s, w).grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("eq,sa,sb", [
    ("...d,dv->...v", (2, 64, 256), (256, 1000)),        # the logits
    ("bqkgd,bskd->bkgqs", (2, 32, 2, 3, 64), (2, 48, 2, 64))])  # scores
def test_cuda_f32_result_product_derivative(cuda, eq, sa, sb):
    """`layers.product` with an f32 result from bf16 operands runs
    `F32Product` under grad: its gradients match f32 autograd of the
    upcast operands (relative L2 1e-2: the cotangent is rounded to bf16
    before the tensor-core products, the gradients to bf16 after). What
    the out_dtype `mm` overload itself does under autograd is recorded:
    a derivative that matches, or an error naming the missing one."""
    from repro_torch.models.layers import product
    g = torch.Generator(device=cuda).manual_seed(9)
    a = torch.randn(sa, generator=g, device=cuda).bfloat16().requires_grad_()
    b = (torch.randn(sb, generator=g, device=cuda)
         * sb[-1] ** -0.5).bfloat16().requires_grad_()
    y = product(eq, a, b, torch.float32)
    assert y.dtype == torch.float32
    seen, todo = {}, [y.grad_fn]
    while todo:
        node = todo.pop()
        if node is not None and id(node) not in seen:
            seen[id(node)] = type(node).__name__
            todo.extend(n for n, _ in node.next_functions)
    assert "F32ProductBackward" in seen.values(), seen
    gy = torch.randn(y.shape, generator=g, device=cuda)
    got = torch.autograd.grad(y, (a, b), gy)
    a32, b32 = (t.detach().float().requires_grad_() for t in (a, b))
    want = torch.autograd.grad(torch.einsum(eq, a32, b32), (a32, b32), gy)
    for x, w in zip(got, want):
        assert x.dtype == torch.bfloat16
        assert float((x.float() - w).norm() / w.norm()) < 1e-2
    a2 = a.detach().reshape(-1, sa[-1]).requires_grad_()
    b2 = b.detach().reshape(sb[0], -1).requires_grad_() if eq.startswith(
        "...") else None
    if b2 is not None:
        try:
            own = torch.autograd.grad(
                torch.mm(a2, b2, out_dtype=torch.float32),
                (a2, b2), gy.reshape(-1, sb[-1]))
        except RuntimeError as e:
            assert "derivative" in str(e) or "not implemented" in str(e)
        else:
            for x, w in zip(own, want):
                assert float((x.float() - w.reshape(x.shape)).norm()
                             / w.norm()) < 1e-2


@pytest.mark.cuda
def test_cuda_flash_vjp_matches_direct_attention(cuda):
    """The chunked schedules' FlashFn on the card, f32: gradients equal
    direct attention's autograd within 1e-4 (sum order)."""
    from repro_torch.models import attention as attn
    g = torch.Generator(device=cuda).manual_seed(10)
    q, k, v = (torch.randn(s, generator=g, device=cuda).requires_grad_()
               for s in ((2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32)))
    gy = torch.randn((2, 64, 4, 32), generator=g, device=cuda)
    want = torch.autograd.grad(attn.direct_attention(q, k, v, n_kv=2,
                                                     window=32),
                               (q, k, v), gy)
    for schedule in ("masked", "banded"):
        out = attn.attention(q, k, v, n_kv=2, window=32, chunk=16,
                             schedule=schedule)
        assert type(out.grad_fn).__name__ == "FlashFnBackward"
        for x, w in zip(torch.autograd.grad(out, (q, k, v), gy), want):
            torch.testing.assert_close(x, w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_train_step_qwen3_width_two_layers(cuda):
    """qwen3-14b at full width, 2 layers, one microbatch (1 x 256) under
    "fused": rows 1-3 launch (5, 1 and 1 a layer, twice: the forward and
    its recompute), no plain version runs on the card, and every
    parameter leaf gets a finite, non-zero gradient."""
    import dataclasses

    from torch.utils import _pytree as pytree

    from repro_torch.configs import get
    from repro_torch.models import steps

    cfg = dataclasses.replace(get("qwen3-14b"), n_layers=2, grad_accum=1)
    params = steps.init_params(cfg, 0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(11)
    batch = {k: torch.randint(0, cfg.vocab, (1, 256), generator=gen,
                              device=cuda) for k in ("tokens", "labels")}
    launches.reset_counts()
    loss, _, grads = steps.make_train_step(cfg, policy="fused").accumulate(
        params, batch)
    torch.cuda.synchronize()
    counts = launches.counts()
    assert {n: counts[n]["launches"] for n in
            ("rmsnorm_matmul", "flash_attention_proj",
             "matmul_residual_add")} == {"rmsnorm_matmul": 20,
                                         "flash_attention_proj": 4,
                                         "matmul_residual_add": 4}
    assert not any(c["plain_cuda_calls"] for c in counts.values())
    assert torch.isfinite(loss)
    for path, g in pytree.tree_flatten_with_path(grads)[0]:
        assert torch.isfinite(g).all() and g.abs().max() > 0, \
            pytree.keystr(path)


@pytest.mark.cuda
def test_cuda_train_step_tuned_is_the_plain_route(cuda):
    """qwen3-14b at full width, 2 layers, one microbatch of 2 x 512 (the
    train phase's M1024) under "tuned": the model's forward takes the
    plain product route, so no fused op, race or composition runs and no
    kernel of rows 1-7 launches; every leaf's gradient is finite, non-zero
    and within 2e-2 relative L2 of the "fused" route's."""
    import dataclasses

    from torch.utils import _pytree as pytree

    from repro_torch.cluster.policy import KernelPolicy
    from repro_torch.configs import get
    from repro_torch.models import steps

    cfg = dataclasses.replace(get("qwen3-14b"), n_layers=2, grad_accum=1)
    params = steps.init_params(cfg, 0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(11)
    batch = {k: torch.randint(0, cfg.vocab, (2, 512), generator=gen,
                              device=cuda) for k in ("tokens", "labels")}
    pol = KernelPolicy(mode="tuned")
    launches.reset_counts()
    loss, _, grads = steps.make_train_step(cfg, policy=pol).accumulate(
        params, batch)
    torch.cuda.synchronize()
    counts = launches.counts()
    assert not any(c["launches"] or c["plain_cuda_calls"]
                   for c in counts.values()), counts
    assert not {"unfused_routes", "tune_hits", "tune_misses"} & set(
        pol.stats), pol.stats
    assert torch.isfinite(loss)
    _, _, want = steps.make_train_step(cfg, policy="fused").accumulate(
        params, batch)
    for (path, g), w in zip(pytree.tree_flatten_with_path(grads)[0],
                            pytree.tree_leaves(want)):
        assert torch.isfinite(g).all() and g.abs().max() > 0, \
            pytree.keystr(path)
        rel = float((g.float() - w.float()).norm() / w.float().norm())
        assert rel < 2e-2, (pytree.keystr(path), rel)
