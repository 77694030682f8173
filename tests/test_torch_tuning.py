"""repro_torch's tuning layer against the reference's, on the CPU.

* the pipeline's tune spaces, cost model, records and registry (after
  `tests/test_pipeline.py`'s tuning tests), with the Hopper kernels' plan
  knobs in place of the Pallas blocking, and the policy's dispatch (after
  `tests/test_cluster.py::test_tuned_call_respects_policy`);
* cross-package parity: `kernel_shapes` / `shape_key` on the same numpy
  inputs, the TuneDB file format both ways (a reference DB survives the
  port's save byte for byte and warm-starts none of the port's kernels; a
  port "cuda" record survives the reference's round trip), `tune_mode`
  under the same env and policies, the same sequence of `tuned_call`s
  giving the same routes, counters and outputs, and corrupt or stale DB
  files counted once in both;
* the H100 constants (`core/mesh.py`), the roofline on them, and the GEMM
  plan models' constants against the CUDA headers.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster.policy import KernelPolicy as JPolicy
from repro.cluster.policy import use_policy as juse
from repro.configs import registry as jregistry
from repro.kernels import ops as jops
from repro.kernels import pipeline as jpp
from repro.kernels import tunedb as jtunedb
from repro_torch.cluster.policy import KernelPolicy, use_policy
from repro_torch.configs import registry
from repro_torch.core import mesh as hw
from repro_torch.kernels import gemm_plans as gp
from repro_torch.kernels import ops, pipeline as pp, tunedb
from repro_torch.launch import roofline

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
DEV = "cpu"
COUNTERS = ("tune_hits", "tune_misses", "tune_races", "block_overrides",
            "unfused_routes", "ref_calls")


@pytest.fixture(autouse=True)
def _clean_tunes():
    for reg in (registry, jregistry):
        reg.KERNEL_TUNES.clear()
    for db in (tunedb, jtunedb):
        db.set_active_db(None)
    yield
    for reg in (registry, jregistry):
        reg.KERNEL_TUNES.clear()
    for db in (tunedb, jtunedb):
        db.reset_active_db()


# the reference's shape dicts, one cell a kernel (small: the Pallas
# interpreter runs the reference on the CPU)
SHAPES = {
    "matmul": {"m": 64, "k": 128, "n": 96},
    "axpy": {"m": 64, "n": 128},
    "dotp": {"m": 64, "n": 128},
    "conv2d": {"h": 32, "w": 128},
    "dct8x8": {"n": 64},
    "rmsnorm": {"m": 32, "d": 128},
    "flash_attention": {"b": 1, "h": 4, "kv": 2, "s": 64, "hd": 32},
    "rmsnorm_matmul": {"m": 32, "k": 128, "n": 64},
    "matmul_bias_act": {"m": 32, "k": 128, "n": 64},
    "matmul_residual_add": {"m": 32, "k": 128, "n": 64},
    "flash_attention_proj": {"b": 1, "h": 4, "kv": 2, "s": 64, "hd": 32,
                             "dm": 64},
}
KERNELS = sorted(SHAPES)
# a cell of each GEMM route: the mainloop, the decode kernel, 3xTF32
ROUTES = {"mainloop": ({"m": 512, "k": 5120, "n": 5120}, 2),
          "decode": ({"m": 8, "k": 5120, "n": 1024}, 2),
          "tf32x3": ({"m": 512, "k": 512, "n": 512}, 4)}


def operand_arrays(name: str, shapes: dict, seed: int = 0) -> tuple:
    """Numpy operands in each wrapper's order (alpha a float for axpy)."""
    rng = np.random.default_rng(seed)
    s = shapes

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {
        "matmul": lambda: (r(s["m"], s["k"]), r(s["k"], s["n"])),
        "axpy": lambda: (2.0, r(s["m"], s["n"]), r(s["m"], s["n"])),
        "dotp": lambda: (r(s["m"], s["n"]), r(s["m"], s["n"])),
        "conv2d": lambda: (r(s["h"], s["w"]), r(3, 3)),
        "dct8x8": lambda: (r(s["n"], 8, 8),),
        "rmsnorm": lambda: (r(s["m"], s["d"]), r(s["d"], scale=0.1)),
        "flash_attention": lambda: (
            r(s["b"], s["h"], s["s"], s["hd"]),
            r(s["b"], s["kv"], s["s"], s["hd"]),
            r(s["b"], s["kv"], s["s"], s["hd"])),
        "rmsnorm_matmul": lambda: (r(s["m"], s["k"]), r(s["k"], scale=0.1),
                                   r(s["k"], s["n"], scale=s["k"] ** -0.5)),
        "matmul_bias_act": lambda: (r(s["m"], s["k"]),
                                    r(s["k"], s["n"], scale=s["k"] ** -0.5),
                                    r(s["n"])),
        "matmul_residual_add": lambda: (
            r(s["m"], s["k"]), r(s["k"], s["n"], scale=s["k"] ** -0.5),
            r(s["m"], s["n"])),
        "flash_attention_proj": lambda: (
            r(s["b"], s["h"], s["s"], s["hd"]),
            r(s["b"], s["kv"], s["s"], s["hd"]),
            r(s["b"], s["kv"], s["s"], s["hd"]),
            r(s["h"], s["hd"], s["dm"], scale=0.1)),
    }[name]()


def pair(arrays, dtype="float32"):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    j = tuple(a if isinstance(a, float) else jnp.asarray(a).astype(jdt)
              for a in arrays)
    t = tuple(a if isinstance(a, float) else torch.from_numpy(a).to(tdt)
              for a in arrays)
    return j, t


def close(got, want, tol=1e-4):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want, np.float32), rtol=tol, atol=tol)


def counters(stats: dict) -> dict:
    return {k: stats[k] for k in COUNTERS if k in stats}


# ----------------------------------------------------------------------------
# the pipeline: tune spaces, cost model, records (after test_pipeline.py)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", KERNELS)
def test_kernel_matches_reference_through_tuned_call(name):
    """Every kernel through `tuned_call` (the port's plain versions on the
    CPU) equals the reference's `tuned_call` (Pallas, interpreted)."""
    jargs, targs = pair(operand_arrays(name, SHAPES[name]))
    with juse(JPolicy(mode="tuned")):
        want = jops.tuned_call(name, *jargs)
    with use_policy(KernelPolicy(mode="tuned")) as pol:
        got = ops.tuned_call(name, *targs)
    assert pol.stats["tune_misses"] == 1 and pol.stats["kernel_calls"] == 1
    close(got, want, 2e-3)


@pytest.mark.parametrize("name", KERNELS)
def test_autotune_knobs_in_space_and_fit(name):
    for dtype_bytes in (2, 4):
        r = pp.autotune(name, SHAPES[name], dtype_bytes=dtype_bytes,
                        device=DEV)
        space = list(pp.KERNELS[name].tune_space(SHAPES[name], dtype_bytes))
        assert r.blocks in space
        t = pp.KERNELS[name].traffic(SHAPES[name], r.blocks, dtype_bytes)
        assert t.smem_bytes <= pp.SMEM_BUDGET_BYTES
        assert r.cost.total_s <= r.default_cost.total_s * (1 + 1e-9)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_gemm_tune_space_names_the_routes_knobs(route):
    """Every candidate of a GEMM route pins that route's kernel's knobs
    and fits a block's shared memory; the model's own pick is one of
    them."""
    shapes, db = ROUTES[route]
    assert gp.route(shapes["m"], shapes["k"], shapes["n"], db) == route
    knobs = {"mainloop": {"tile_n"}, "decode": {"boxes", "cluster"},
             "tf32x3": {"tile_n", "cluster"}}[route]
    for name in ("matmul", "rmsnorm_matmul", "matmul_residual_add",
                 "matmul_bias_act"):
        if db == 4 and name != "matmul":
            assert list(pp.KERNELS[name].tune_space(shapes, db)) == [{}]
            continue
        space = list(pp.KERNELS[name].tune_space(shapes, db))
        assert len(space) > 1 and len({tuple(sorted(c.items()))
                                       for c in space}) == len(space)
        for cand in space:
            assert set(cand) == knobs
            t = pp.KERNELS[name].traffic(shapes, cand, db)
            assert 0 < t.smem_bytes <= hw.SMEM_PER_BLOCK
        own = gp._model_pick(shapes["m"], shapes["k"], shapes["n"], db,
                             route)
        assert own in space


def test_one_point_kernels_have_no_knob():
    for name in ("axpy", "dotp", "conv2d", "dct8x8", "rmsnorm",
                 "flash_attention"):
        for db in (2, 4):
            assert list(pp.KERNELS[name].tune_space(SHAPES[name], db)) == \
                [{}]
    # flash_attention_proj: the projection's N tile at heads of 128 only
    s = dict(SHAPES["flash_attention_proj"])
    assert list(pp.KERNELS["flash_attention_proj"].tune_space(s, 2)) == [{}]
    s["hd"] = 128
    assert [c["tile_n"] for c in pp.KERNELS["flash_attention_proj"]
            .tune_space(s, 2)] == list(gp.TILE_N)


def test_autotune_registers_record():
    shapes, db = ROUTES["mainloop"]
    r = pp.autotune("matmul", shapes, dtype_bytes=db, device=DEV)
    rec = registry.get_kernel_tune("matmul", pp.shape_key(shapes, db))
    assert rec is not None and dict(rec.blocks) == r.blocks
    assert rec.modeled_seconds == pytest.approx(r.cost.total_s)
    assert registry.kernel_tunes() == [rec]
    assert pp.tuned_blocks("matmul", shapes, dtype_bytes=db) == r.blocks


def test_tune_records_keyed_by_dtype():
    """f32 and bf16 operands run different kernels: a bf16 record must not
    serve an f32 call."""
    shapes = ROUTES["tf32x3"][0]
    pp.autotune("matmul", shapes, dtype_bytes=2, device=DEV)
    assert registry.get_kernel_tune(
        "matmul", pp.shape_key(shapes, 2)) is not None
    assert registry.get_kernel_tune(
        "matmul", pp.shape_key(shapes, 4)) is None


def test_default_lane_is_the_kernels_own_pick():
    for name, shapes in SHAPES.items():
        assert pp.KERNELS[name].default_blocks(shapes) == {}
    # {} scores as the model's own pick: pick_bn's tile on the mainloop
    shapes, db = ROUTES["mainloop"]
    own = pp.KERNELS["matmul"].traffic(shapes, {}, db)
    pick = pp.KERNELS["matmul"].traffic(
        shapes, {"tile_n": gp.pick_tile_n(shapes["m"], shapes["n"])}, db)
    assert own == pick


def test_traffic_streamed_at_least_ideal():
    for name, shapes in SHAPES.items():
        for db in (2, 4):
            defn = pp.KERNELS[name]
            t = defn.traffic(shapes, defn.default_blocks(shapes), db)
            assert t.hbm_bytes >= t.ideal_bytes - 1e-9, name
            assert t.flops > 0 and t.grid_steps >= 1, name


def test_no_locality_factor_on_the_card():
    """There is no Top_H model on the card: locality stays 1.0 and the
    score is the wave-quantised roofline plus the fixed time."""
    t = pp.Traffic(flops=1e9, hbm_bytes=4e6, ideal_bytes=1e6, grid_steps=8,
                   smem_bytes=1 << 20, quantization=1.5, fixed_s=1e-6)
    c = pp.score(t)
    assert c.locality == 1.0 and c.p_local == pytest.approx(0.25)
    assert c.compute_s == pytest.approx(1e9 / hw.PEAK_FLOPS_BF16 * 1.5)
    assert c.total_s == pytest.approx(max(c.compute_s, c.memory_s) + 1e-6)


@pytest.mark.parametrize("m,n,want", [(12000, 768, 160), (12000, 3072, 224),
                                      (512, 5120, 160), (4096, 4096, 256)])
def test_pick_tile_n_mirrors_pick_bn(m, n, want):
    """`gemm_plans.pick_tile_n` is `hopper::pick_bn` (the tiles the
    kernels' notes name; chip_smoke holds it to `wgmma_plan` on the card),
    and the score ranks the mainloop's tiles by its count."""
    assert gp.pick_tile_n(m, n) == want
    shapes = {"m": m, "k": 1024, "n": n}
    cost = {bn: pp.score(pp.KERNELS["matmul"].traffic(
        shapes, {"tile_n": bn}, 2)).total_s for bn in gp.TILE_N}
    assert min(cost.values()) == pytest.approx(cost[want])


def test_smem_budget_respected_by_autotuner():
    """A budget nothing fits leaves the first candidate; one the big
    tiles miss drops them."""
    shapes, db = ROUTES["mainloop"]
    r = pp.autotune("matmul", shapes, dtype_bytes=db, smem_budget=1 << 10,
                    register_record=False, device=DEV)
    assert r.blocks == {"tile_n": gp.TILE_N[0]}
    budget = gp.mainloop_smem(160)
    r = pp.autotune("matmul", shapes, dtype_bytes=db, smem_budget=budget,
                    register_record=False, device=DEV)
    assert gp.mainloop_smem(r.blocks["tile_n"]) <= budget


def test_gemm_constants_mirror_the_headers():
    """gemm_plans' constants are the CUDA headers' (TILE_N, the shared
    memory caps, the decode and 3xTF32 counts)."""
    wg = (CSRC / "wgmma_gemm.cuh").read_text()
    dec = (CSRC / "decode_gemm.cuh").read_text()
    tf = (CSRC / "tf32x3_gemm.cuh").read_text()

    def const(src, name):
        return int(eval(re.search(rf"\b{name} = ([^,;]+)[,;]",
                                  src).group(1).replace("hopper::", "")
                        .replace("SMEM_CAP", str(gp.SMEM_CAP))
                        .replace("MAX_CLUSTER", str(gp.MAX_CLUSTER))))

    assert tuple(int(v) for v in re.findall(r"\d+", re.search(
        r"TILE_N\[\] = \{([^}]*)\}", wg).group(1))) == gp.TILE_N
    assert const(wg, "SMEM_CAP") == gp.SMEM_CAP
    assert const(dec, "PAIR_SMEM") == gp.PAIR_SMEM
    assert const(dec, "MAX_BOXES") == gp.MAX_BOXES
    assert const(dec, "WAVE_BOXES") == gp.WAVE_BOXES
    assert const(dec, "MAX_K") == gp.MAX_K
    assert (const(dec, "MIN_STAGES"), const(dec, "PAIR_STAGES"),
            const(dec, "SOLO_STAGES")) == (gp.MIN_STAGES, gp.PAIR_STAGES,
                                           gp.SOLO_STAGES)
    assert tuple(int(v) for v in re.findall(r"\d+", re.search(
        r"TILE_N\[\] = \{([^}]*)\}", tf).group(1))) == gp.TF32_TILE_N
    assert const(tf, "TILE_FIXED") == gp.TF32_TILE_FIXED
    assert const(tf, "REDUCE_FIXED") == gp.TF32_REDUCE_FIXED
    assert const(tf, "MAX_STAGES") == gp.TF32_MAX_STAGES
    # Tile<BN>::SMEM, by the header's formula
    assert gp.mainloop_smem(256) == 4 * (16384 + 4 * 8192) + 1024


def test_block_candidates_properties():
    cands = pp.block_candidates(1024, align=128, cap=5)
    assert len(cands) <= 5
    assert all(1024 % c == 0 and c % 128 == 0 for c in cands)
    assert pp.block_candidates(7, align=8) == [7]
    assert pp.block_candidates(1024, align=128) == \
        jpp.block_candidates(1024, align=128)
    assert pp.snap_block(768, 512) == jpp.snap_block(768, 512) == 384
    with pytest.raises(ValueError):
        pp.resolve_block(96, 40, 64)


# ----------------------------------------------------------------------------
# the policy's dispatch (test_cluster.py::test_tuned_call_respects_policy)
# ----------------------------------------------------------------------------

def test_tuned_call_respects_policy():
    a = torch.from_numpy(operand_arrays("matmul", {"m": 48, "k": 32,
                                                   "n": 40})[0])
    b = torch.randn(32, 40, generator=torch.Generator().manual_seed(5))
    want = (a.double() @ b.double()).float()

    with use_policy(KernelPolicy(overrides={"matmul": "reference"})) as pol:
        got = ops.tuned_call("matmul", a, b)
    assert pol.stats == {"ref_calls": 1}
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

    # a pinned plan skips the registry: the reference's Pallas names are
    # checked and dropped, the Hopper knobs checked against the space
    pinned = KernelPolicy(overrides={"matmul": {"bm": 16, "bn": 8, "bk": 32,
                                                "tile_n": 64}})
    assert pinned.blocks_for("matmul") == {"bm": 16, "bn": 8, "bk": 32,
                                           "tile_n": 64}
    with use_policy(pinned):
        got = ops.tuned_call("matmul", a, b)
    assert pinned.stats["block_overrides"] == 1
    assert "tune_hits" not in pinned.stats
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

    with use_policy("tuned") as pol:
        ops.tuned_call("matmul", a, b)
        ops.tuned_call("matmul", a, b)
    assert pol.stats["tune_misses"] == 1 and pol.stats["tune_hits"] == 1
    assert registry.get_kernel_tune(
        "matmul", pp.shape_key({"m": 48, "k": 32, "n": 40})) is not None


@pytest.mark.parametrize("override,err", [
    ({"tile_n": 192}, "tune space"),            # not one of TILE_N
    ({"boxes": 2}, "tune space"),               # the decode kernel's knob
    ({"bm": 40}, "does not divide"),            # the reference's check
])
def test_pinned_plan_the_kernel_cannot_take_raises(override, err):
    g = torch.Generator().manual_seed(0)
    a = torch.randn(96, 256, generator=g).to(torch.bfloat16)
    b = torch.randn(256, 128, generator=g).to(torch.bfloat16)
    pol = KernelPolicy(overrides={"matmul": override})
    with use_policy(pol), pytest.raises(ValueError, match=err):
        ops.tuned_call("matmul", a, b)
    # a plan of the space, and a partial pin, run
    for ok in ({"tile_n": 160}, {}):
        with use_policy(KernelPolicy(overrides={"matmul": ok})):
            ops.tuned_call("matmul", a, b)
    with use_policy(KernelPolicy(overrides={"matmul": {"cluster": 2}})):
        ops.tuned_call("matmul", a[:8], b)      # the decode kernel's


def test_policy_fields_match_reference():
    pol = KernelPolicy(mode="fused", tuning="frozen",
                       overrides={"matmul": {"tile_n": 128}, "rmsnorm":
                                  "reference"})
    jpol = JPolicy(mode="fused", tuning="frozen",
                   overrides={"matmul": {"bm": 64}, "rmsnorm": "reference"})
    assert set(pol.describe()) == set(jpol.describe())
    assert pol.blocks_for("rmsnorm") is None and pol.mode_for("matmul") == \
        "fused"
    assert not pol.interpret_for("matmul") and pol.interpret_for(
        "matmul", "cpu")
    assert KernelPolicy(mode="interpret").interpret_for("matmul")
    with pytest.raises(ValueError):
        KernelPolicy(tuning="warp")
    with pytest.raises(TypeError):
        KernelPolicy(overrides={"matmul": 3})


# ----------------------------------------------------------------------------
# cross-package parity
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(set(ops.OPS) | set(jops.OPS)))
def test_kernel_shapes_and_shape_key_match(name, dtype):
    assert name in ops.OPS and name in jops.OPS
    jargs, targs = pair(operand_arrays(name, SHAPES[name]), dtype)
    js, ts = jops.kernel_shapes(name, *jargs), ops.kernel_shapes(name, *targs)
    assert ts == js == SHAPES[name]
    db = 2 if dtype == "bfloat16" else 4
    jlead = jargs[jops.OPS[name].streamed_operand]
    tlead = targs[ops.OPS[name].streamed_operand]
    assert jlead.dtype.itemsize == tlead.dtype.itemsize == db
    assert pp.shape_key(ts, db) == jpp.shape_key(js, db)


def _jrecord(source="timed") -> "jregistry.KernelTuneRecord":
    return jregistry.KernelTuneRecord(
        kernel="matmul", shape_key="b4_k512_m512_n512",
        blocks=(("bk", 128), ("bm", 256), ("bn", 256)),
        modeled_seconds=1e-5, default_blocks=(("bk", 256), ("bm", 256),
                                              ("bn", 256)),
        default_modeled_seconds=2e-5, measured_us=120.5, default_us=130.25,
        source=source)


def test_reference_db_survives_the_ports_save_byte_for_byte(tmp_path):
    path = tmp_path / "tunes.json"
    jdb = jtunedb.TuneDB(path)
    jdb.record(_jrecord(), backend="cpu", mode="tuned")
    jdb.record(_jrecord(), backend="tpu", mode="fused")
    before = path.read_bytes()
    db = tunedb.TuneDB(path)
    assert len(db) == 2 and db.load_errors == 0
    # the port's warm start takes none of the reference's records
    for backend in ("cuda", "torch_cpu"):
        for mode in ("tuned", "fused"):
            assert db.warm_start(backend=backend, mode=mode) == 0
    assert registry.kernel_tunes() == []
    db.save()
    assert path.read_bytes() == before


def test_port_record_survives_the_references_round_trip(tmp_path):
    path = tmp_path / "tunes.json"
    rec = registry.KernelTuneRecord(
        kernel="rmsnorm_matmul", shape_key="b2_k5120_m512_n17408",
        blocks=(("tile_n", 128),), modeled_seconds=1e-4,
        default_blocks=(("tile_n", 160),), default_modeled_seconds=1.1e-4,
        saved_bytes=1e7, measured_us=99.5, default_us=101.0,
        source="timed", route="fused")
    tunedb.TuneDB(path).record(rec, backend="cuda", mode="fused")
    before = path.read_bytes()
    jdb = jtunedb.TuneDB(path)
    assert len(jdb) == 1 and jdb.load_errors == 0
    jrec = jtunedb._record_from_json(json.loads(before)["records"][0])
    assert jrec.blocks == rec.blocks and jrec.route == "fused"
    assert jdb.warm_start(backend=jax.default_backend(), mode="fused") == 0
    jdb.save()
    assert path.read_bytes() == before
    got = tunedb.TuneDB(path).get("cuda", "fused", "rmsnorm_matmul",
                                  rec.shape_key)
    assert got == rec


@pytest.mark.parametrize("env", [None, "timed", "modeled", "frozen"])
@pytest.mark.parametrize("tuning", ("auto", "timed", "modeled",
                                               "frozen"))
def test_tune_mode_resolves_the_same(monkeypatch, env, tuning):
    if env is None:
        monkeypatch.delenv("REPRO_TUNE_MODE", raising=False)
    else:
        monkeypatch.setenv("REPRO_TUNE_MODE", env)
    assert tunedb.tune_mode() == jtunedb.tune_mode()
    with use_policy(KernelPolicy(tuning=tuning)), \
            juse(JPolicy(tuning=tuning)):
        assert tunedb.tune_mode() == jtunedb.tune_mode()
        for explicit in ("timed", "modeled", "frozen"):
            assert tunedb.tune_mode(explicit) == jtunedb.tune_mode(explicit)


@pytest.mark.parametrize("content", [
    "{not json", json.dumps({"version": 999, "records": []}),
    json.dumps({"version": 1, "records": [{"kernel": "matmul"}]}),
    json.dumps({"version": 1})])
def test_corrupt_or_stale_db_counted_once_in_both(tmp_path, content):
    path = tmp_path / "tunes.json"
    path.write_text(content)
    db, jdb = tunedb.TuneDB(path), jtunedb.TuneDB(path)
    assert db.load_errors == jdb.load_errors == 1
    assert len(db) == len(jdb) == 0
    assert db.describe().keys() == jdb.describe().keys()


def _scripted(script: dict, default: float = 1.0):
    def timer(fn, blocks):
        return script.get(tuple(sorted(blocks.items())), default)
    return timer


@pytest.mark.parametrize("tuning", ["auto", "timed"])
def test_tuned_call_sequence_matches_reference(monkeypatch, tuning):
    """The same sequence of tuned_calls, with the same races scripted in
    both packages, takes the same routes, bumps the same counters and
    gives the same outputs. "auto" takes tests/conftest.py's
    REPRO_TUNE_MODE=modeled (the reference's modeled default); "timed"
    races every miss (real timers, on an op with no composition lane)."""
    monkeypatch.setenv("REPRO_TUNE_REPS", "1")
    comp = tuple(sorted(pp.COMPOSITION_LANE.items()))
    for name, comp_s in (("rmsnorm_matmul", 0.1), ("matmul_residual_add",
                                                   5.0)):
        shapes = SHAPES[name]
        jpp.autotune(name, shapes, mode="timed",
                     timer=_scripted({comp: comp_s}))
        pp.autotune(name, shapes, mode="timed", device=DEV,
                    timer=_scripted({comp: comp_s}))
    calls = [("matmul", None), ("matmul", None), ("rmsnorm_matmul", None),
             ("matmul_residual_add", None), ("axpy", None),
             ("rmsnorm", "reference"),
             ("matmul", {"bm": 16, "bn": 32, "bk": 32})]
    if tuning == "auto":
        # a miss of a fused op: a real race would time its composition
        calls.append(("matmul_bias_act", None))
    for i, (name, override) in enumerate(calls):
        overrides = {} if override is None else {name: override}
        jpol = JPolicy(mode="tuned", tuning=tuning, overrides=overrides)
        pol = KernelPolicy(mode="tuned", tuning=tuning, overrides=overrides)
        jargs, targs = pair(operand_arrays(name, SHAPES[name], seed=i))
        with juse(jpol):
            want = jops.tuned_call(name, *jargs)
        with use_policy(pol):
            got = ops.tuned_call(name, *targs)
        assert counters(pol.stats) == counters(jpol.stats), (i, name)
        close(got, want, 2e-3)
    jrecs = {(r.kernel, r.shape_key, r.route, r.source)
             for r in jregistry.kernel_tunes()}
    recs = {(r.kernel, r.shape_key, r.route, r.source)
            for r in registry.kernel_tunes()}
    assert recs == jrecs


# ----------------------------------------------------------------------------
# the H100 constants and the roofline on them
# ----------------------------------------------------------------------------

def test_h100_constants_and_roofline():
    assert (hw.SMS, hw.SMEM_PER_BLOCK, hw.L2_BYTES) == (132, 227 * 1024,
                                                        50 * 1024 ** 2)
    assert (hw.HBM_BW, hw.HBM_BYTES) == (3.35e12, 80e9)
    assert (hw.PEAK_FLOPS_BF16, hw.PEAK_FLOPS_TF32, hw.PEAK_FLOPS_F32) == \
        (989e12, 495e12, 67e12)
    r = roofline.kernel_roofline(2 * 4096 ** 3, 3 * 4096 ** 2 * 2)
    assert r["dominant"] == "compute_s"
    assert r["compute_s"] == pytest.approx(2 * 4096 ** 3 / 989e12)
    f = roofline.fused_roofline(3 * 2 * 4096 ** 3, 3 * 4096 ** 2 * 4,
                                4096 ** 2 * 8, hw.PEAK_FLOPS_TF32)
    assert f["compute_s"] == pytest.approx(6 * 4096 ** 3 / 495e12)
    assert f["traffic_reduction"] == pytest.approx(5 / 3)
    assert f["saved_s"] == pytest.approx(4096 ** 2 * 8 / 3.35e12)


def test_chip_smoke_reads_the_constants():
    """chip_smoke.py's bound() and rates come from core/mesh.py: one copy
    of the H100 numbers."""
    src = (ROOT / "chip_smoke.py").read_text()
    assert "from repro_torch.core import mesh" in src
    for literal in ("3.35e12", "989e12", "495e12", "67e12"):
        assert literal not in src, literal
