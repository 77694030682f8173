"""repro_torch's execution engine against the reference's.

* Scripted decode steps (a torch function and the reference's jax one
  emitting the same script) through both packages' `ServeLoop`: the
  K-step engine equals the per-token loop and the reference bit for bit
  (tokens, EOS masking and early stop, emitted_per_slot) with O(T/K) host
  syncs; the tail chunk builds its short variant once.
* `ServeProgram` on qwen3-14b-smoke in both packages, parameters and KV
  caches in f32 on both sides (no greedy argmax near a tie): tokens,
  emitted_per_slot, finished_slots and host_syncs are equal at chunk 1
  and 4, with and without a prompt and an EOS id.
* `api.serve`, the compile cache, `Program.report()`, the spec types the
  port does not define yet, and the one-shot session `run`'s legacy
  stats, against the reference.

Everything runs on the CPU (``device="cpu"``); the CUDA-graph path is
held to the eager one by the card tests in `test_torch_cuda.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.cluster import session as jsession
from repro.kernels import tunedb as jtunedb
from repro.models import steps as jsteps
from repro.runtime import serve_loop as jserve_loop
from repro.runtime.engine import DecodeEngine as JEngine
from repro_torch import api as tapi
from repro_torch import weights
from repro_torch.cluster import session as tsession
from repro_torch.configs import get as tget
from repro_torch.kernels import tunedb as ttunedb
from repro_torch.models import steps as tsteps
from repro_torch.runtime import serve_loop as tserve_loop
from repro_torch.runtime.engine import DecodeEngine, make_decode_chunk

ARCH = "qwen3-14b-smoke"


# ----------------------------------------------------------------------------
# Scripted decode: the K-step path == the per-token loop == the reference
# ----------------------------------------------------------------------------

def scripted_step(script: np.ndarray):
    """decode_step emitting script[pos] (a (B,) row) per position."""
    table = torch.as_tensor(script)

    def decode_step(params, cache, batch):
        return cache, table[torch.as_tensor(batch["pos"])][:, None]

    return decode_step


def jscripted_step(script: np.ndarray):
    table = jnp.asarray(script, jnp.int32)

    def decode_step(params, cache, batch):
        return cache, jnp.take(table, batch["pos"], axis=0)[:, None]

    return decode_step


SCRIPT = np.array([[7, 1, 2], [3, 7, 4], [5, 6, 8], [9, 9, 9]], np.int32)


def run_loop(chunk: int, *, eos_id=7, max_new=4, script=SCRIPT):
    B = script.shape[1]
    loop = tserve_loop.ServeLoop(scripted_step(script), None,
                                 {"kv": torch.zeros(B, 4)}, batch_size=B,
                                 eos_id=eos_id, chunk=chunk)
    out = loop.generate(np.zeros((B, 1), np.int32), max_new=max_new)
    return out, loop.stats()


def jrun_loop(chunk: int, *, eos_id=7, max_new=4, script=SCRIPT):
    B = script.shape[1]
    loop = jserve_loop.ServeLoop(jscripted_step(script), None,
                                 {"kv": jnp.zeros((B, 4), jnp.float32)},
                                 batch_size=B, eos_id=eos_id, chunk=chunk)
    out = loop.generate(np.zeros((B, 1), np.int32), max_new=max_new)
    return out, loop.stats()


@pytest.mark.parametrize("chunk", [2, 3, 4, 16])
def test_scan_decode_matches_per_token_loop(chunk):
    ref_out, ref_st = run_loop(1)
    out, st = run_loop(chunk)
    jout, jst = jrun_loop(chunk)
    np.testing.assert_array_equal(out, ref_out)
    np.testing.assert_array_equal(out, jout)
    assert st["emitted_per_slot"] == ref_st["emitted_per_slot"] == \
        jst["emitted_per_slot"]
    assert st["finished_slots"] == ref_st["finished_slots"] == \
        jst["finished_slots"]
    assert st["stall"]["host_syncs"] == jst["stall"]["host_syncs"] <= \
        -(-4 // chunk)
    assert ref_st["stall"]["host_syncs"] == 4


def test_scan_decode_eos_early_stop_and_masking():
    out, st = run_loop(2)
    # slot 0 finishes at step 1, slot 1 at step 2; slot 2 never does
    np.testing.assert_array_equal(out[0], [0, 7, 7, 7, 7])
    np.testing.assert_array_equal(out[1], [0, 1, 7, 7, 7])
    np.testing.assert_array_equal(out[2], [0, 2, 4, 8, 9])
    assert st["emitted_per_slot"] == [1, 2, 4]

    all_eos = np.full((4, 2), 7, np.int32)
    ref_out, ref_st = run_loop(1, script=all_eos, max_new=10)
    out, st = run_loop(4, script=all_eos, max_new=10)
    jout, jst = jrun_loop(4, script=all_eos, max_new=10)
    np.testing.assert_array_equal(out, ref_out)
    np.testing.assert_array_equal(out, jout)
    assert out.shape == (2, 2)                  # stopped after one step
    assert st["emitted_per_slot"] == ref_st["emitted_per_slot"] == [1, 1]
    assert st["stall"]["host_syncs"] == jst["stall"]["host_syncs"] == 1


def test_scan_decode_no_eos_and_partial_chunk():
    ref_out, _ = run_loop(1, eos_id=None, max_new=3)
    out, st = run_loop(4, eos_id=None, max_new=3)      # K > max_new
    np.testing.assert_array_equal(out, ref_out)
    assert out.shape == (3, 4)
    assert st["emitted_per_slot"] == [3, 3, 3]
    assert "finished_slots" not in st
    assert st["stall"]["host_syncs"] == 1


@pytest.mark.parametrize("build", [
    lambda step: DecodeEngine(step, 0),
    lambda step: make_decode_chunk(step, -1),
    lambda step: tsteps.make_decode_chunk(tget(ARCH), 0)],
    ids=["engine", "engine.make_decode_chunk", "steps.make_decode_chunk"])
def test_decode_chunk_rejects_bad_k(build):
    with pytest.raises(ValueError):
        build(scripted_step(SCRIPT))


def test_tail_chunk_builds_short_variant_once():
    """max_new % chunk != 0: the final chunk runs a short variant (exactly
    the remaining steps), built once and reused by the next generate."""
    script = np.tile(np.arange(24, dtype=np.int32)[:, None], (1, 2))
    eng = DecodeEngine(scripted_step(script), 16, eos_id=None)
    out, _, _, emitted = eng.generate(None, {"kv": torch.zeros(2, 4)},
                                      np.zeros((2, 1), np.int32),
                                      max_new=20)
    assert out.shape == (2, 21)
    assert sorted(eng._chunk_fns) == [4, 16]        # steady + tail variant
    assert [n for _, n in eng.chunk_latencies] == [16, 4]
    assert emitted.tolist() == [20, 20]
    ref, _ = run_loop(1, eos_id=None, max_new=20, script=script)
    np.testing.assert_array_equal(out, ref)
    jeng = JEngine(jscripted_step(script), 16, eos_id=None)
    jout, _, _, jemitted = jeng.generate(
        None, {"kv": jnp.zeros((2, 4), jnp.float32)},
        np.zeros((2, 1), np.int32), max_new=20)
    np.testing.assert_array_equal(out, jout)
    tail = eng._chunk_fns[4]
    eng.generate(None, {"kv": torch.zeros(2, 4)}, np.zeros((2, 1), np.int32),
                 max_new=20)
    assert sorted(eng._chunk_fns) == [4, 16] and eng._chunk_fns[4] is tail


def test_tail_chunk_shorter_than_one_chunk():
    out, st = run_loop(16, eos_id=None, max_new=3)  # K > max_new: one short
    ref, _ = run_loop(1, eos_id=None, max_new=3)
    np.testing.assert_array_equal(out, ref)
    assert st["stall"]["host_syncs"] == 1


@pytest.mark.parametrize("chunk", [1, 4])
def test_serve_stats_report_stall_and_chunk(chunk):
    _, st = run_loop(chunk)
    _, jst = jrun_loop(chunk)
    assert st["chunk"] == chunk
    assert sorted(st) == sorted(jst)
    assert sorted(st["stall"]) == sorted(jst["stall"])
    assert st["decode_steps"] == jst["decode_steps"]


@pytest.mark.parametrize("samples", [
    [], [(0.5, 16)], [(0.5, 16), (0.016, 16), (0.008, 4)],
    [(0.2, 4), (0.0, 0), (0.04, 4), (0.03, 2)]])
def test_chunked_latency_stats_matches_reference(samples):
    assert tserve_loop.chunked_latency_stats(samples) == \
        jserve_loop.chunked_latency_stats(samples)


# ----------------------------------------------------------------------------
# qwen3-14b-smoke through both packages
# ----------------------------------------------------------------------------

SERVE = dict(batch=4, max_seq=48, max_new=6)


@pytest.fixture(scope="module")
def params():
    jc = jsession.Cluster(ARCH)
    jp = jc.compile(jsession.ServeProgram(**SERVE)).init_params()
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp32 = weights.from_jax_params(jax.tree.map(np.asarray, jp32),
                                   device="cpu")
    tp = weights.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return {"jax": jp32, "torch": tp32, "jax_bf16": jp, "torch_bf16": tp}


@pytest.fixture
def f32_caches(monkeypatch):
    """Both packages' decode caches in f32 (the parameters are f32 too)."""
    jinit, tinit = jsteps.init_cache, tsteps.init_cache
    monkeypatch.setattr(jsteps, "init_cache", lambda *a, **k: jax.tree.map(
        lambda c: c.astype(jnp.float32), jinit(*a, **k)))
    monkeypatch.setattr(tsteps, "init_cache", lambda *a, **k: {
        n: c.float() for n, c in tinit(*a, **k).items()})


@pytest.fixture(scope="module")
def clusters():
    return jsession.Cluster(ARCH), tsession.Cluster(ARCH, device="cpu")


PROMPT = np.random.default_rng(5).integers(1, 200, (4, 5))


def _eos(tokens) -> int:
    """An EOS id that slot 0 emits mid-run (so that it finishes early)."""
    return int(tokens[0, 3])


@pytest.fixture(scope="module")
def eos_ids(params, clusters):
    """The EOS id of each prompt case, from the reference's own run."""
    mp = pytest.MonkeyPatch()
    jinit = jsteps.init_cache
    mp.setattr(jsteps, "init_cache", lambda *a, **k: jax.tree.map(
        lambda c: c.astype(jnp.float32), jinit(*a, **k)))
    try:
        jprog = clusters[0].compile(jsession.ServeProgram(chunk=4, **SERVE))
        return {prompted: _eos(jprog.run(
            params=params["jax"],
            prompt=PROMPT if prompted else None)["tokens"])
            for prompted in (False, True)}
    finally:
        mp.undo()


@pytest.mark.parametrize("eos", [False, True], ids=["no_eos", "eos"])
@pytest.mark.parametrize("prompted", [False, True],
                         ids=["no_prompt", "prompt"])
@pytest.mark.parametrize("chunk", [1, 4])
def test_serve_program_matches_reference(params, clusters, eos_ids,
                                         f32_caches, chunk, prompted, eos):
    eos_id = eos_ids[prompted] if eos else None
    prompt = PROMPT if prompted else None
    jc, tc = clusters
    spec = dict(chunk=chunk, eos_id=eos_id, **SERVE)
    want = jc.compile(jsession.ServeProgram(**spec)).run(
        params=params["jax"], prompt=prompt)
    prog = tc.compile(tsession.ServeProgram(**spec))
    got = prog.run(params=params["torch"], prompt=prompt)
    assert got["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    st, jst = got["stats"], want["stats"]
    assert sorted(st) == sorted(jst)
    assert sorted(st["stall"]) == sorted(jst["stall"])
    for key in ("emitted_per_slot", "finished_slots", "chunk",
                "decode_steps"):
        assert st.get(key) == jst.get(key), key
    assert st["stall"]["host_syncs"] == jst["stall"]["host_syncs"]
    if eos:
        assert st["finished_slots"] >= 1
        assert got["tokens"].shape[1] <= SERVE["max_new"] + 1
    assert prog.captures() == 0                     # the CPU runs eagerly


def test_serve_program_reruns_on_a_fresh_cache(params, clusters, f32_caches):
    """A second run of one compiled program starts from a zeroed cache
    (the program keeps one cache) and gives the same tokens."""
    prog = clusters[1].compile(tsession.ServeProgram(chunk=4, **SERVE))
    a = prog.run(params=params["torch"], prompt=PROMPT)["tokens"]
    cache = prog.cache
    b = prog.run(params=params["torch"], prompt=PROMPT)["tokens"]
    assert prog.cache is cache
    np.testing.assert_array_equal(a, b)


def test_make_decode_chunk_matches_reference(params, f32_caches):
    """The chunk program of `steps.make_decode_chunk` itself: one 4-step
    chunk from a prompt-fed cache, state in and out, in both packages."""
    jcfg = jsession.Cluster(ARCH).arch
    tcfg = tsession.Cluster(ARCH, device="cpu").arch
    eos = 7
    jfn = jsteps.make_decode_chunk(jcfg, 4, 48, eos_id=eos)
    tfn = tsteps.make_decode_chunk(tcfg, 4, 48, eos_id=eos)
    jcache = jsteps.init_cache(jcfg, 4, 48)
    tcache = tsteps.init_cache(tcfg, 4, 48, device="cpu")
    tok = PROMPT[:, :1].astype(np.int32)
    finished = np.array([False, True, False, False])
    emitted = np.array([2, 1, 0, 3], np.int32)
    jout = jfn(params["jax"], jcache, jnp.asarray(tok), jnp.asarray(finished),
               jnp.asarray(emitted), jnp.asarray(3, jnp.int32),
               jnp.asarray(10, jnp.int32))
    ttok = torch.as_tensor(tok.astype(np.int64))
    tfin = torch.as_tensor(finished)
    tem = torch.as_tensor(emitted.astype(np.int64))
    tpos = torch.tensor(3)
    tout = tfn(params["torch"], tcache, ttok, tfin, tem, tpos, torch.tensor(10))
    _, jtok, jfin, jem, jpos, jn, jdone, jtoks = jout
    _, otok, ofin, oem, opos, on, odone, otoks = tout
    assert otok is ttok and ofin is tfin and oem is tem and opos is tpos
    np.testing.assert_array_equal(otoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(otok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(ofin.numpy(), np.asarray(jfin))
    np.testing.assert_array_equal(oem.numpy(), np.asarray(jem))
    assert int(opos) == int(jpos) and int(on) == int(jn) == 4
    assert bool(odone) == bool(jdone)


@pytest.mark.parametrize("chunk", [1, 4])
def test_api_serve_matches_reference(params, chunk):
    """bf16 parameters and caches as the programs make them; no prompt
    (every slot starts from token 0), where the two packages agree."""
    kw = dict(batch=4, max_seq=48, max_new=6, chunk=chunk)
    want = japi.serve("qwen3-14b", params["jax_bf16"], **kw)
    got = tapi.serve("qwen3-14b", params["torch_bf16"], device="cpu", **kw)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert sorted(got) == sorted(want)
    assert sorted(got["stats"]) == sorted(want["stats"])
    for key in ("emitted_per_slot", "chunk", "decode_steps"):
        assert got["stats"][key] == want["stats"][key], key
    assert got["stats"]["stall"]["host_syncs"] == \
        want["stats"]["stall"]["host_syncs"]


@pytest.mark.parametrize("name,kwargs,item", [
    ("train", {"mesh": object(), "device": "cpu"}, "Queue 1 I"),
    ("plan", {}, "Queue 1 K")])
def test_api_unported_entry_points_raise(name, kwargs, item):
    """What the port's entry points still refuse names its ROADMAP item:
    `plan` (the addressing plan) and, since training is ported,
    `train`'s `mesh=` (meshes come with groups)."""
    with pytest.raises(NotImplementedError, match=item):
        getattr(tapi, name)("qwen3-14b", **kwargs)


# ----------------------------------------------------------------------------
# Cluster.compile: the program cache, reports, specs not ported yet
# ----------------------------------------------------------------------------

def test_cluster_compile_cache_memoizes_programs():
    cluster = tsession.Cluster(ARCH, device="cpu")
    spec = tsession.ServeProgram(batch=2, max_seq=16, max_new=2)
    p1 = cluster.compile(spec)
    p2 = cluster.compile(tsession.ServeProgram(batch=2, max_seq=16,
                                               max_new=2))
    assert p1 is p2
    assert cluster.compile_cache.hits == 1
    # a different spec, and a different policy scope, compile fresh
    p3 = cluster.compile(tsession.ServeProgram(batch=4, max_seq=16,
                                               max_new=2))
    assert p3 is not p1
    with cluster.policy("fused"):
        p4 = cluster.compile(tsession.ServeProgram(batch=2, max_seq=16,
                                                   max_new=2))
    assert p4 is not p1
    assert p4.policy.fused
    s1 = cluster.compile(tsession.ServeSessionProgram(slots=2))
    assert cluster.compile(tsession.ServeSessionProgram(slots=2)) is s1
    assert cluster.compile_cache.misses == 4


def test_cluster_rejects_unknown_program():
    with pytest.raises(TypeError):
        tsession.Cluster(ARCH, device="cpu").compile({"not": "a program"})


@pytest.mark.parametrize("spec,item", [
    (tsession.TrainProgram(num_steps=1), None),
    (jsession.ShardedServeSessionProgram(), "Queue 1 I"),
    (jsession.BenchProgram(), "Queue 1 J"),
    (jsession.DryRunProgram(), "Queue 1 K")],
    ids=lambda x: type(x).__name__ if not isinstance(x, str) else x)
def test_unported_program_specs_name_their_roadmap_item(spec, item):
    """Each spec the port does not define names its ROADMAP item;
    TrainProgram is ported (Queue 1 H) and compiles to a CompiledTrain."""
    cluster = tsession.Cluster(ARCH, device="cpu")
    if item is None:
        assert type(spec).__name__ not in tsession.UNPORTED
        assert isinstance(cluster.compile(spec), tsession.CompiledTrain)
        return
    with pytest.raises(NotImplementedError, match=item):
        cluster.compile(spec)


@pytest.mark.parametrize("with_db", [False, True])
@pytest.mark.parametrize("kind", ["serve", "serve_session"])
def test_program_report_keys_match_reference(params, kind, with_db,
                                             tmp_path):
    jspec, tspec = {
        "serve": (jsession.ServeProgram(chunk=4, **SERVE),
                  tsession.ServeProgram(chunk=4, **SERVE)),
        "serve_session": (jsession.ServeSessionProgram(preempt=False,
                                                       slots=4, max_seq=48,
                                                       max_new=6, chunk=4),
                          tsession.ServeSessionProgram(slots=4, max_seq=48,
                                                       max_new=6, chunk=4))}[
        kind]
    db = {"tune_db": str(tmp_path / "tunes.json")} if with_db else {}
    for tunedb in (jtunedb, ttunedb):     # no DB left active by another test
        tunedb.set_active_db(None)
    jprog = jsession.Cluster(ARCH, **db).compile(jspec)
    tprog = tsession.Cluster(ARCH, device="cpu", **db).compile(tspec)
    for tunedb in (jtunedb, ttunedb):
        tunedb.reset_active_db()
    # the reference's mesh is the port's device; with a tune database both
    # report it ("tunedb"), without one neither does
    port_only = {"device"} | ({"captures"} if kind == "serve" else set())
    ref_only = {"mesh"}
    for ran in (False, True):
        if ran:
            jprog.run(params=params["jax_bf16"])
            tprog.run(params=params["torch_bf16"])
        jrep, trep = jprog.report(), tprog.report()
        assert set(trep) - port_only == set(jrep) - ref_only
        assert trep["kind"] == jrep["kind"] == kind
        assert trep["arch"] == jrep["arch"] == ARCH
        assert trep["device"] == "cpu"
        assert trep["compile_cache"] == {"hits": 0, "misses": 1}
        assert trep["policy"]["mode"] == jrep["policy"]["mode"]
        assert ("tunedb" in trep) == ("tunedb" in jrep) == with_db
        if with_db:
            assert trep["tunedb"].keys() == jrep["tunedb"].keys()
            assert trep["tunedb"]["warm_started"] == 0
        assert ("result" in trep) == ran
        if ran:
            assert set(trep["result"]) == set(jrep["result"])
            assert trep["result"]["tokens_shape"] == \
                jrep["result"]["tokens_shape"]


# ----------------------------------------------------------------------------
# The one-shot session run returns the reference's legacy stats
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("eos", [False, True], ids=["no_eos", "eos"])
@pytest.mark.parametrize("prompted", [False, True],
                         ids=["no_prompt", "prompt"])
def test_one_shot_session_stats_match_reference(params, eos_ids, f32_caches,
                                                prompted, eos):
    eos_id = eos_ids[prompted] if eos else None
    prompt = PROMPT if prompted else None
    common = dict(slots=4, max_seq=48, max_prompt=8, max_new=6, chunk=4,
                  eos_id=eos_id)
    want = jsession.Cluster(ARCH).compile(jsession.ServeSessionProgram(
        preempt=False, **common)).run(params=params["jax"], prompt=prompt)
    got = tsession.Cluster(ARCH, device="cpu").compile(
        tsession.ServeSessionProgram(**common)).run(params=params["torch"],
                                                    prompt=prompt)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    st, jst = got["stats"], want["stats"]
    assert sorted(st) == sorted(jst)
    assert sorted(st["stall"]) == sorted(jst["stall"])
    assert "session" in st and "requests_done" in st["session"]
    for key in ("emitted_per_slot", "finished_slots", "chunk",
                "decode_steps"):
        assert st.get(key) == jst.get(key), key
    assert ("finished_slots" in st) == eos
