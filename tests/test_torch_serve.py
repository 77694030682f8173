"""repro_torch's ServeSession against the reference ServeSession.

One request script goes through both sessions — private caches and the
paged KV pool — at smoke size: mixed prompt and output lengths, a shared
12-token preamble (three 4-token pages, so later requests hit the prefix
cache) and two identical page-aligned prompts (an exact full-coverage hit
COW-forks its last page). The tokens of every request must be equal, and
so must the pool counters (prefix hits and misses, pages shared, prefill
tokens skipped, COW forks, page allocations). Parameters are the
reference's, and parameters and KV caches are cast to f32 on both sides
so that no greedy argmax sits near a tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster.session import Cluster as JCluster
from repro.cluster.session import ServeSessionProgram as JProgram
from repro_torch import weights
from repro_torch.cluster import session as tsession
from repro_torch.cluster.session import Cluster as TCluster
from repro_torch.cluster.session import ServeSessionProgram as TProgram
from repro_torch.configs import registry as treg
from repro_torch.models import steps as tsteps
from repro_torch.runtime import engine

ARCH = "qwen3-14b-smoke"
COMMON = dict(slots=4, max_seq=48, max_prompt=16, chunk=4)
KV_KEYS = ("prefix_hits", "prefix_misses", "pages_shared",
           "prefill_skipped_tokens", "cow_forks", "allocs",
           "alloc_failures", "used_pages", "prefix_entries", "evictions",
           "pool_exhausted")


def _script():
    rng = np.random.default_rng(0)
    pre = rng.integers(1, 200, 12).astype(np.int32)
    reqs = []
    for i in range(10):
        if i in (6, 9):                       # exact page cover: COW fork
            prompt = pre.copy()
        elif i % 2:
            prompt = np.concatenate(
                [pre, rng.integers(1, 200, int(rng.integers(1, 4)))])
        else:
            prompt = rng.integers(1, 200, int(rng.integers(2, 10)))
        reqs.append((prompt.astype(np.int32), int(rng.integers(3, 9))))
    return reqs


@pytest.fixture(scope="module")
def params():
    jc = JCluster(ARCH)
    jp = jc.compile(JProgram(preempt=False, **COMMON)).init_params()
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jp, weights.from_jax_params(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _serve(prog, p, reqs):
    sess = prog.open(params=p)
    cache = sess.state["cache"]                 # cast the KV cache to f32
    if isinstance(next(iter(cache.values())), torch.Tensor):
        sess.state["cache"] = {k: v.float() for k, v in cache.items()}
    else:
        sess.state = dict(sess.state, cache=jax.tree.map(
            lambda c: c.astype(jnp.float32), cache))
    handles = [sess.submit(prompt, n) for prompt, n in reqs]
    stats = sess.drain()
    return [h.result() for h in handles], stats


@pytest.mark.parametrize("policy,paged", [("tuned", False), ("tuned", True),
                                          ("fused", True)])
def test_session_matches_reference(params, policy, paged):
    jp, tp = params
    extra = dict(paged=True, page_size=4) if paged else {}
    jc = JCluster(ARCH)
    with jc.policy(policy):
        jprog = jc.compile(JProgram(preempt=False, **COMMON, **extra))
    tc = TCluster(ARCH, device="cpu")
    with tc.policy(policy):
        tprog = tc.compile(TProgram(**COMMON, **extra))
    reqs = _script()
    jtoks, jst = _serve(jprog, jp, reqs)
    ttoks, tst = _serve(tprog, tp, reqs)
    for (prompt, n), a, b in zip(reqs, jtoks, ttoks):
        assert b.dtype == np.int32 and b.size == n
        np.testing.assert_array_equal(b, a)
    for key in ("requests_done", "emitted_total", "admitted_order",
                "occupancy_pct"):
        assert tst[key] == jst[key], key
    if paged:
        for key in KV_KEYS:
            assert tst["kv"][key] == jst["kv"][key], key
        assert tst["kv"]["prefix_hits"] > 0 and tst["kv"]["cow_forks"] > 0


def test_one_shot_run():
    """`run()` with bf16 parameters and caches as the programs make them:
    without a prompt (every slot starts from token 0) the legacy (B, W)
    token block equals the reference's; with a prompt, column 0 is the
    first sampled token and the row is what a session gives the same
    request. (Prompted bf16 runs of the two packages part at a near-tie
    argmax, a 0.01 logit gap, so they are compared within the port.)"""
    jprog = JCluster(ARCH).compile(JProgram(preempt=False, **COMMON))
    jp = jprog.init_params()
    tp = weights.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    tprog = TCluster(ARCH, device="cpu").compile(TProgram(**COMMON))
    want = jprog.run(params=jp, max_new=6)["tokens"]
    got = tprog.run(params=tp, max_new=6)["tokens"]
    assert got.shape == (4, 7) and (got[:, 0] == 0).all()
    np.testing.assert_array_equal(got, want)
    prompt = np.random.default_rng(5).integers(1, 200, (4, 5))
    got = tprog.run(params=tp, prompt=prompt, max_new=6)["tokens"]
    sess = tprog.open(params=tp)
    handles = [sess.submit(row, 7) for row in prompt]
    sess.drain()
    np.testing.assert_array_equal(got, np.stack([h.result()
                                                 for h in handles]))


def test_stream_and_cancel():
    tc = TCluster(ARCH, device="cpu")
    prog = tc.compile(TProgram(**COMMON, max_queue=8))
    sess = prog.open()
    a = sess.submit(np.arange(1, 5), 6)
    b = sess.submit(np.arange(1, 7), 6)
    assert sess.cancel(b)
    got = [t for h, toks, done in sess.stream() if h is a for t in toks]
    assert np.array_equal(np.asarray(got, np.int32), a.result())
    assert a.result().size == 6 and b.state == "cancelled"
    assert sess.stats()["requests_done"] == 1


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TCluster(ARCH)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsession.resolve_device(None)
    assert TCluster(ARCH, device="cpu").device.type == "cpu"


def _allocating_entry_points():
    cfg = treg.get(ARCH)
    leaf = np.zeros((2, 3), np.float32)
    return {
        "init_params": lambda **kw: tsteps.init_params(cfg, **kw),
        "init_cache": lambda **kw: tsteps.init_cache(cfg, 2, 8, **kw),
        "init_paged_cache": lambda **kw: tsteps.init_paged_cache(
            cfg, 2, 8, n_pages=5, page_size=4, **kw),
        "init_session_state": lambda **kw: engine.init_session_state(
            {}, 2, 4, pages_per_slot=2, **kw),
        "from_jax_params": lambda **kw: weights.from_jax_params(
            {"blocks": {"sub0": {"w": np.zeros((1, 2))}}, "ln_f": leaf},
            **kw),
    }


@pytest.mark.parametrize("name", sorted(_allocating_entry_points()))
def test_allocating_entry_points_default_to_cuda(monkeypatch, name):
    """Without a device the allocating functions take the GPU: with CUDA
    absent they raise instead of quietly building CPU tensors, so that
    `make_prefill_step(cfg)(init_params(cfg), batch)` never runs the
    plain versions on the CPU by accident."""
    fn = _allocating_entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn()
    out = fn(device="cpu")
    leaves = [out] if isinstance(out, torch.Tensor) else list(
        _tensor_leaves(out))
    assert leaves and all(t.device.type == "cpu" for t in leaves)


def _tensor_leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensor_leaves(v)


def test_unported_knobs_raise():
    """The SLO knobs that raised NotImplementedError until the robustness
    layer was ported (preempt, shed_watermark, nan_check,
    admission="longest_prefix", a non-latency class) are accepted, and
    each acts as the reference's does: one script of mixed classes
    through both packages' sessions with the knob on gives the same
    events, tokens and counters (timings aside). f32 parameters and
    caches, as above; `retry_backoff_s=0` on both sides."""
    from torch_parity import counters, drive, f32_state_factory

    jp, tp = _f32_params()
    rng = np.random.default_rng(3)
    classes = ("throughput", "best_effort", "latency", "throughput")
    arrivals = {0: [(rng.integers(1, 200, int(rng.integers(2, 12))).astype(
        np.int32), int(rng.integers(3, 9)), classes[i % 4])
        for i in range(7)],
        1: [(np.arange(1, 6, dtype=np.int32), 4, "latency")]}
    acted = {}
    for knob in (dict(preempt=True), dict(shed_watermark=2),
                 dict(nan_check=True), dict(admission="longest_prefix")):
        spec = dict(COMMON, retry_backoff_s=0.0, **knob)
        jprog = f32_state_factory(JCluster(ARCH).compile(JProgram(**spec)))
        tprog = f32_state_factory(TCluster(ARCH, device="cpu").compile(
            TProgram(**spec)))
        jev, jh = drive(jprog.open(params=jp), arrivals)
        tev, th = drive(tprog.open(params=tp), arrivals)
        assert tev == jev, knob
        assert counters(tprog._last_session.stats()) == counters(
            jprog._last_session.stats()), knob
        assert [h.klass for h in th.values()] == [h.klass
                                                  for h in jh.values()]
        st = tprog._last_session.stats()
        acted[next(iter(knob))] = (st["preemptions"], st["requests_shed"])
    assert acted["preempt"][0] > 0 and acted["shed_watermark"][1] > 0
    assert TProgram().preempt is True


def _f32_params():
    jp = JCluster(ARCH).compile(JProgram(**COMMON)).init_params()
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jp, weights.from_jax_params(jax.tree.map(np.asarray, jp),
                                       device="cpu")
