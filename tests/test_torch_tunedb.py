"""repro_torch's timed autotuning and TuneDB, after `tests/test_tunedb.py`.

The race runs with *scripted* timers (`timer(fn, knobs)`), so who wins
is the script's choice: under test is the selection logic (the measured
winner is kept, the default lane can win, a lane that throws cannot,
tuned <= default by construction), the composition lane, the DB's
persistence contract (round trip, warm start without re-racing, corrupt
and stale files starting cold, frozen mode never writing), the cluster's
counters and report, the second run of the Table 1 rows racing nothing,
and the port's `table1_tuned/*` rows through the reference's gate
(`benchmarks/check_gate.py`). Everything runs on the CPU: the wrappers'
plain versions, the TuneDB backend key "torch_cpu".
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from repro_torch.cluster import (Cluster, KernelPolicy,  # noqa: E402
                                 ServeProgram, use_policy)
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import ops, pipeline as pp, table1  # noqa: E402
from repro_torch.kernels import tunedb  # noqa: E402

DEV = "cpu"
SHAPES = {"m": 512, "n": 512, "k": 512}
KEY = pp.shape_key(SHAPES, 4)
BACKEND = pp.backend_of(DEV)
ARCH = "qwen3-14b-smoke"


@pytest.fixture(autouse=True)
def _clean_tunes():
    registry.KERNEL_TUNES.clear()
    tunedb.set_active_db(None)
    yield
    registry.KERNEL_TUNES.clear()
    tunedb.reset_active_db()


def scripted_timer(script: dict, default: float = 1.0):
    """timer(fn, knobs) that never runs fn — returns scripted seconds."""
    def timer(fn, blocks):
        return script.get(tuple(sorted(blocks.items())), default)
    return timer


def modeled_pick(kernel: str = "matmul", shapes: dict = SHAPES) -> dict:
    return dict(pp.autotune(kernel, shapes, mode="modeled",
                            register_record=False, device=DEV).blocks)


def autotune(kernel="matmul", shapes=SHAPES, **kw):
    return pp.autotune(kernel, shapes, device=DEV, **kw)


def test_backend_key_is_the_ports_own():
    assert BACKEND == "torch_cpu"
    assert BACKEND not in ("cpu", "gpu", "tpu")
    assert pp.backend_of(torch.device("cuda", 0)) == "cuda"


# ----------------------------------------------------------------------------
# the race
# ----------------------------------------------------------------------------

def test_race_picks_fastest_candidate():
    best = modeled_pick()
    default = pp.KERNELS["matmul"].default_blocks(SHAPES)
    assert best != default and default == {}    # the kernel's own pick
    script = {tuple(sorted(best.items())): 0.5,
              tuple(sorted(default.items())): 2.0}
    r = autotune(mode="timed", timer=scripted_timer(script))
    assert r.source == "timed" and r.raced >= 2
    assert r.blocks == best
    assert r.measured_us == pytest.approx(0.5e6)
    assert r.default_us == pytest.approx(2.0e6)
    assert r.measured_speedup == pytest.approx(4.0)
    rec = registry.get_kernel_tune("matmul", KEY)
    assert rec.timed and rec.source == "timed"
    assert rec.measured_speedup == pytest.approx(4.0)


def test_race_default_lane_can_win():
    default = pp.KERNELS["matmul"].default_blocks(SHAPES)
    script = {tuple(sorted(default.items())): 0.1}
    r = autotune(mode="timed", timer=scripted_timer(script, default=1.0))
    assert r.blocks == dict(default)
    assert r.measured_us == r.default_us == pytest.approx(0.1e6)
    assert r.measured_speedup == pytest.approx(1.0)


def test_race_erroring_lane_cannot_win():
    default_key = tuple(sorted(
        pp.KERNELS["matmul"].default_blocks(SHAPES).items()))

    def timer(fn, blocks):
        if tuple(sorted(blocks.items())) != default_key:
            raise RuntimeError("candidate refused to launch")
        return 0.3
    r = autotune(mode="timed", timer=timer)
    assert r.source == "timed" and r.blocks == {}


def test_race_all_lanes_failing_falls_back_to_modeled():
    def timer(fn, blocks):
        raise RuntimeError("no lane runs")
    r = autotune(mode="timed", timer=timer)
    assert r.source == "modeled" and not r.timed and r.raced == 0
    assert r.blocks == modeled_pick()


def test_modeled_mode_never_races():
    def timer(fn, blocks):
        raise AssertionError("modeled mode raced")
    r = autotune(mode="modeled", timer=timer)
    assert r.source == "modeled" and r.raced == 0 and r.measured_us == 0.0


def test_timed_race_on_device_tuned_not_slower(monkeypatch):
    """One real (unscripted) race on the CPU's plain versions."""
    monkeypatch.setenv("REPRO_TUNE_REPS", "1")
    r = autotune(shapes={"m": 256, "n": 256, "k": 256}, mode="timed")
    assert r.source == "timed" and r.raced >= 1
    assert r.measured_us <= r.default_us * (1 + 1e-9)
    assert r.measured_speedup >= 1.0


# ----------------------------------------------------------------------------
# the composition lane: fused-vs-unfused routing
# ----------------------------------------------------------------------------

COMP_KEY = tuple(sorted(pp.COMPOSITION_LANE.items()))
BF16_CELL = {"m": 64, "k": 256, "n": 256}       # bf16: the mainloop's knobs


def test_composition_lane_wins_routes_unfused():
    best = modeled_pick("rmsnorm_matmul")
    r = autotune("rmsnorm_matmul", mode="timed",
                 timer=scripted_timer({COMP_KEY: 0.1}, default=1.0))
    assert r.source == "timed" and r.route == "unfused"
    assert r.measured_us == pytest.approx(0.1e6)
    assert r.blocks == best
    rec = registry.get_kernel_tune("rmsnorm_matmul", KEY)
    assert rec.route == "unfused" and rec.timed


def test_composition_lane_losing_keeps_fused_route():
    best = pp.autotune("rmsnorm_matmul", BF16_CELL, dtype_bytes=2,
                       mode="modeled", register_record=False,
                       device=DEV).blocks
    assert "tile_n" in best
    script = {COMP_KEY: 5.0, tuple(sorted(best.items())): 0.5}
    r = pp.autotune("rmsnorm_matmul", BF16_CELL, dtype_bytes=2, mode="timed",
                    timer=scripted_timer(script, default=1.0), device=DEV)
    assert r.route == "fused" and r.blocks == best
    assert r.measured_us == pytest.approx(0.5e6)
    rec = registry.get_kernel_tune("rmsnorm_matmul",
                                   pp.shape_key(BF16_CELL, 2))
    assert rec.route == "fused"


def test_composition_lane_erroring_keeps_fused_route():
    def timer(fn, blocks):
        if tuple(sorted(blocks.items())) == COMP_KEY:
            raise RuntimeError("composition refused to run")
        return 1.0
    r = autotune("rmsnorm_matmul", mode="timed", timer=timer)
    assert r.source == "timed" and r.route == "fused"


def test_unfused_kernel_has_no_composition_lane():
    def timer(fn, blocks):
        assert "route" not in blocks
        return 1.0
    r = autotune(mode="timed", timer=timer)
    assert r.source == "timed" and r.route == "fused"


def test_route_survives_db_round_trip(tmp_path):
    autotune("rmsnorm_matmul", mode="timed",
             timer=scripted_timer({COMP_KEY: 0.1}, default=1.0))
    rec = registry.get_kernel_tune("rmsnorm_matmul", KEY)
    assert rec.route == "unfused"
    path = tmp_path / "tunes.json"
    tunedb.TuneDB(path).record(rec, backend=BACKEND, mode="tuned")
    got = tunedb.TuneDB(path).get(BACKEND, "tuned", "rmsnorm_matmul", KEY)
    assert got == rec and got.route == "unfused"


def test_policy_dispatches_composition_on_unfused_route():
    g = torch.Generator().manual_seed(0)
    m = k = n = 256
    x = torch.randn(m, k, generator=g)
    scale = torch.ones(k) * 0.1
    w = torch.randn(k, n, generator=g)
    shapes = ops.kernel_shapes("rmsnorm_matmul", x, scale, w)
    pp.autotune("rmsnorm_matmul", shapes, mode="timed", device=DEV,
                timer=scripted_timer({COMP_KEY: 0.1}, default=1.0))
    pol = KernelPolicy(mode="tuned")
    with use_policy(pol):
        out = ops.tuned_call("rmsnorm_matmul", x, scale, w)
    assert pol.stats.get("unfused_routes") == 1
    assert pol.stats.get("tune_hits") == 1
    # the composition launched its primitives (rmsnorm, matmul)
    assert pol.stats.get("kernel_calls") == 2
    want = ops.OPS["rmsnorm_matmul"].reference(x, scale, w)
    torch.testing.assert_close(out, want, atol=2e-2, rtol=2e-2)


# ----------------------------------------------------------------------------
# TuneDB persistence
# ----------------------------------------------------------------------------

def _timed_record() -> registry.KernelTuneRecord:
    script = {tuple(sorted(modeled_pick().items())): 0.5}
    autotune(mode="timed", timer=scripted_timer(script, default=2.0))
    return registry.get_kernel_tune("matmul", KEY)


def test_db_round_trip(tmp_path):
    rec = _timed_record()
    path = tmp_path / "tunes.json"
    db = tunedb.TuneDB(path)
    db.record(rec, backend=BACKEND, mode="tuned")
    assert path.exists() and db.stores == 1
    db2 = tunedb.TuneDB(path)
    assert len(db2) == 1 and db2.loads == 1 and db2.load_errors == 0
    got = db2.get(BACKEND, "tuned", "matmul", KEY)
    assert got == rec
    assert got.measured_speedup == pytest.approx(rec.measured_speedup)
    assert db2.get(BACKEND, "fused", "matmul", KEY) is None
    assert db2.get("cuda", "tuned", "matmul", KEY) is None
    assert db2.get("cpu", "tuned", "matmul", KEY) is None


def test_db_warm_start_no_rerace(tmp_path):
    rec = _timed_record()
    path = tmp_path / "tunes.json"
    tunedb.TuneDB(path).record(rec, backend=BACKEND, mode="tuned")
    registry.KERNEL_TUNES.clear()
    db = tunedb.TuneDB(path)
    assert db.warm_start(backend=BACKEND, mode="tuned") == 1
    warm = registry.get_kernel_tune("matmul", KEY)
    assert warm.source == "db" and warm.timed
    assert dict(warm.blocks) == dict(rec.blocks)

    def timer(fn, blocks):
        raise AssertionError("warm-started record re-raced")
    with tunedb.use_db(db):
        got = pp.tuned_record("matmul", SHAPES, timer=timer, mode="timed",
                              device=DEV)
    assert got is warm
    assert db.warm_start(backend=BACKEND, mode="tuned") == 0


def test_corrupt_db_falls_back_cold(tmp_path):
    path = tmp_path / "tunes.json"
    path.write_text("{not json")
    db = tunedb.TuneDB(path)
    assert len(db) == 0 and db.load_errors == 1
    assert db.warm_start(backend=BACKEND, mode="tuned") == 0
    db.record(_timed_record(), backend=BACKEND, mode="tuned")
    assert len(tunedb.TuneDB(path)) == 1


def test_stale_schema_db_ignored(tmp_path):
    path = tmp_path / "tunes.json"
    path.write_text(json.dumps({"version": 999, "records": [{"bogus": 1}]}))
    db = tunedb.TuneDB(path)
    assert len(db) == 0 and db.load_errors == 1
    db.save()
    assert json.loads(path.read_text())["version"] == tunedb.SCHEMA_VERSION


def test_frozen_db_never_writes(tmp_path):
    rec = _timed_record()
    path = tmp_path / "tunes.json"
    db = tunedb.TuneDB(path, frozen=True)
    db.record(rec, backend=BACKEND, mode="tuned")
    db.save()
    assert not path.exists()
    assert db.stores == 0 and db.write_skips == 2


def test_frozen_mode_autotune_no_race_no_write(tmp_path):
    path = tmp_path / "tunes.json"
    db = tunedb.TuneDB(path)

    def timer(fn, blocks):
        raise AssertionError("frozen mode raced")
    with tunedb.use_db(db):
        r = autotune(mode="frozen", timer=timer)
    assert r.source == "modeled" and r.raced == 0
    assert len(db) == 0 and not path.exists()


def test_autotune_writes_through_active_db(tmp_path):
    path = tmp_path / "tunes.json"
    db = tunedb.TuneDB(path)
    script = {tuple(sorted(modeled_pick().items())): 0.5}
    with tunedb.use_db(db):
        autotune(mode="timed", timer=scripted_timer(script, default=2.0))
    assert len(db) == 1 and path.exists()
    got = db.get(BACKEND, "tuned", "matmul", KEY)
    assert got is not None and got.source == "timed"
    assert json.loads(path.read_text())["records"][0]["backend"] == \
        "torch_cpu"


def test_modeled_pick_not_written_to_db(tmp_path):
    db = tunedb.TuneDB(tmp_path / "tunes.json")
    with tunedb.use_db(db):
        autotune(mode="modeled")
    assert len(db) == 0


def test_tune_mode_resolution(monkeypatch):
    monkeypatch.delenv("REPRO_TUNE_MODE", raising=False)
    assert tunedb.tune_mode() == "timed"
    monkeypatch.setenv("REPRO_TUNE_MODE", "frozen")
    assert tunedb.tune_mode() == "frozen"
    assert tunedb.tune_mode("modeled") == "modeled"
    with use_policy(KernelPolicy(mode="tuned", tuning="timed")):
        assert tunedb.tune_mode() == "timed"
    with pytest.raises(ValueError):
        tunedb.tune_mode("warp")


# ----------------------------------------------------------------------------
# Cluster integration: counters + warm start
# ----------------------------------------------------------------------------

def test_cluster_counters_and_warm_start(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_REPS", "1")
    path = tmp_path / "tunes.json"
    a = torch.ones(256, 256)
    b = torch.ones(256, 256)
    c1 = Cluster(device=DEV, policy=KernelPolicy(mode="tuned",
                                                 tuning="timed"),
                 tune_db=str(path))
    assert c1.arch is None and c1.tune_db_warm == 0
    with use_policy(c1.kernel_policy):
        ops.tuned_call("matmul", a, b)      # miss -> race
        ops.tuned_call("matmul", a, b)      # registry hit
    st = c1.kernel_policy.stats
    assert st["tune_misses"] == 1 and st["tune_races"] == 1
    assert st["tune_hits"] == 1
    assert len(c1.tune_db) == 1 and len(c1.tunes("matmul")) == 1

    registry.KERNEL_TUNES.clear()
    tunedb.set_active_db(None)
    c2 = Cluster(device=DEV, policy=KernelPolicy(mode="tuned",
                                                 tuning="timed"),
                 tune_db=str(path))
    assert c2.tune_db_warm == 1
    with use_policy(c2.kernel_policy):
        ops.tuned_call("matmul", a, b)
    st2 = c2.kernel_policy.stats
    assert st2.get("tune_hits") == 1
    assert "tune_misses" not in st2 and "tune_races" not in st2
    with pytest.raises(ValueError, match="arch"):
        c2.compile(ServeProgram())


def test_program_report_carries_tunedb(tmp_path):
    path = tmp_path / "tunes.json"
    cluster = Cluster(ARCH, device=DEV, policy="tuned", tune_db=str(path))
    rep = cluster.compile(ServeProgram(batch=2, max_seq=16)).report()
    assert rep["tunedb"]["path"] == str(path)
    assert rep["tunedb"]["warm_started"] == 0
    assert rep["policy"]["tuning"] == "auto"


def test_cluster_without_db_has_no_tunedb_report(monkeypatch):
    monkeypatch.delenv("REPRO_TUNE_DB", raising=False)
    tunedb.reset_active_db()
    cluster = Cluster(ARCH, device=DEV, policy="tuned")
    assert cluster.tune_db is None
    rep = cluster.compile(ServeProgram(batch=2, max_seq=16)).report()
    assert "tunedb" not in rep


# ----------------------------------------------------------------------------
# the second run of the Table 1 rows is race-free
# ----------------------------------------------------------------------------

def test_second_bench_run_zero_races(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_REPS", "1")
    path = tmp_path / "tunes.json"
    db = tunedb.TuneDB(path)
    pol1 = KernelPolicy(mode="tuned", tuning="timed")
    with tunedb.use_db(db), use_policy(pol1):
        rows1 = table1.tuned_rows(smoke=True, device=DEV)
    assert pol1.stats["tune_races"] == len(rows1) == 7
    assert pol1.stats["tune_misses"] == len(rows1)
    for r in rows1:
        assert r["source"] == "timed"
        assert r["us_tuned"] <= r["us_default"] * (1 + 1e-9), r
        assert r["measured_speedup"] >= 1.0

    registry.KERNEL_TUNES.clear()
    db2 = tunedb.TuneDB(path)
    assert db2.warm_start(backend=BACKEND, mode="tuned") == len(rows1)
    pol2 = KernelPolicy(mode="tuned", tuning="timed")
    with tunedb.use_db(db2), use_policy(pol2):
        rows2 = table1.tuned_rows(smoke=True, device=DEV)
    assert "tune_races" not in pol2.stats and "tune_misses" not in pol2.stats
    assert pol2.stats["tune_hits"] == len(rows2)
    assert [r["blocks"] for r in rows2] == [r["blocks"] for r in rows1]
    assert db2.stores == 0


# ----------------------------------------------------------------------------
# the port's table1_tuned rows through the reference's gate
# ----------------------------------------------------------------------------

def _port_rows(tuned_s: float, default_s: float) -> list[dict]:
    """The port's matmul row, raced with a script: the pick at tuned_s,
    the kernel's own plan at default_s (either may be the faster)."""
    best = tuple(sorted(modeled_pick().items()))
    timer = scripted_timer({best: tuned_s, (): default_s})
    pp.autotune("matmul", SHAPES, mode="timed", timer=timer, device=DEV)
    rec = registry.get_kernel_tune("matmul", KEY)
    return table1.gate_rows([{
        "name": "table1_tuned/matmul", "blocks": dict(rec.blocks),
        "us_tuned": tuned_s * 1e6, "us_default": rec.default_us,
        "measured_speedup": rec.measured_speedup, "source": rec.source,
        "p_local": 1.0}])


def _gate_record(tuned_us: float, default_us: float) -> dict:
    return {
        "rows": _port_rows(tuned_us * 1e-6, default_us * 1e-6) + [
            {"name": "table1_fused/rmsnorm_matmul", "us_per_call": 100.0,
             "derived": "unfused_us=150.0;bytes_reduction=2.5"}],
        "decode": [
            {"name": "decode/K1", "us_per_call": 1000.0,
             "derived": "tokens_per_s=1500.0;stall_pct=0.2;host_syncs=32"},
            {"name": "decode/K16", "us_per_call": 500.0,
             "derived": "tokens_per_s=3800.0;stall_pct=0.5;host_syncs=2"}],
        "serve_continuous": [
            {"name": "serve/continuous", "us_per_call": 180.0,
             "derived": "tokens_per_s=5400.0;occupancy_pct=79.0;p99_ms=90"},
            {"name": "serve/static", "us_per_call": 340.0,
             "derived": "tokens_per_s=2900.0;occupancy_pct=45.0;p99_ms=180"}],
    }


def _run_gate(tmp_path, record, baseline=None, require="tuned", tol=0.15):
    from benchmarks import check_gate
    bench = tmp_path / "bench.json"
    bench.write_text(json.dumps(record))
    argv = ["--bench", str(bench), "--require", require, "--tol", str(tol)]
    if baseline is not None:
        base = tmp_path / "baseline.json"
        base.write_text(json.dumps(baseline))
        argv += ["--baseline", str(base)]
    return check_gate.main(argv)


def test_gate_passes_when_tuned_not_slower(tmp_path):
    assert _run_gate(tmp_path, _gate_record(90.0, 100.0),
                     require="tuned,fused,decode,serve") == 0


def test_gate_fails_when_tuned_slower(tmp_path):
    assert _run_gate(tmp_path, _gate_record(130.0, 100.0)) == 1


def test_gate_tolerance_absorbs_timer_noise(tmp_path):
    assert _run_gate(tmp_path, _gate_record(110.0, 100.0), tol=0.15) == 0
    assert _run_gate(tmp_path, _gate_record(110.0, 100.0), tol=0.05) == 1


def test_gate_fails_on_missing_sections(tmp_path):
    record = _gate_record(90.0, 100.0)
    del record["serve_continuous"]
    assert _run_gate(tmp_path, record,
                     require="tuned,fused,decode,serve") == 1


def test_gate_baseline_regressions(tmp_path):
    good = _gate_record(90.0, 100.0)
    worse = json.loads(json.dumps(good))
    worse["decode"][1]["derived"] = \
        "tokens_per_s=3800.0;stall_pct=9.5;host_syncs=2"
    assert _run_gate(tmp_path, worse, baseline=good) == 1
    worse2 = json.loads(json.dumps(good))
    worse2["serve_continuous"][0]["derived"] = \
        "tokens_per_s=5400.0;occupancy_pct=40.0;p99_ms=90"
    assert _run_gate(tmp_path, worse2, baseline=good) == 1
    assert _run_gate(tmp_path, good, baseline=good) == 0


def test_gate_holds_the_real_rows(tmp_path, monkeypatch):
    """The Table 1 rows of a real (unscripted) race on the CPU pass the
    gate's `tuned` check: tuned <= default by construction."""
    monkeypatch.setenv("REPRO_TUNE_REPS", "1")
    with use_policy(KernelPolicy(mode="tuned", tuning="timed")):
        rows = table1.tuned_rows(smoke=True, device=DEV)
    # default_us is written to 0.1 us: a 1% tolerance covers the rounding
    assert _run_gate(tmp_path, {"rows": table1.gate_rows(rows)},
                     tol=0.01) == 0
