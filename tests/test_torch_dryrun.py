"""repro_torch's dry run (`DryRunProgram` / `CompiledDryRun`,
`launch/dryrun.py`, `core/op_cost.py`, `core/locality.py`,
`core/compat.abstract_mesh`) on the CPU, where it needs no card.

* Record: qwen3-14b-smoke's train, prefill, decode, decode-chunk (K 4),
  session and paged session cells on the (2, 4) and (2, 2, 2) fake
  worlds give a record with every key of the reference's
  (`src/repro/cluster/session.py:930-962`), each with a value or a line
  under ``notes``.
* Route: under "fused" (heads widened to 128, the card's head size of
  `flash_attention_proj`) inside `tracing_card()` no plain version runs
  (`traced.PLAIN_CALLS` stays 0) and rows 1-3's records are the cell's;
  each of rows 1-3 and 5-7 called on meta operands records its route
  and workspace (the library's sizes in Python) and launches nothing;
  outside `tracing_card()` a meta cell takes the plain route.
* Undercount: on a fused train cell `cost_analysis_builtin` alone gives
  model_flops / (flops x chips) above 1, the dry run's count at most 1
  (the counterpart of `test_hlo_cost.py::
  test_builtin_cost_analysis_undercounts_loops`).
* Accumulation: grad_accum 4 counts 4x the microbatch's flops, within
  the optimizer's share (`test_scan_trip_count_multiplies`).
* Arithmetic: `_op_bytes`, `p_local` and `peak_device_bytes` equal the
  reference's on a table of cases.
* MoE: mixtral-8x7b-smoke's train and decode cells trace (the
  `bincount` repair).
* Production meshes: qwen3-14b `decode_32k` on (16, 16) and
  (2, 16, 16), whisper-small `decode_32k` on (16, 16) (the reference's
  own failing CI cell) come out "ok".
* xlstm under the tponly rules records "ok" (its mLSTM / sLSTM leaves
  split over "model"); a plan the step does not compute (the embedding
  dim over "model") records "refused" naming its ROADMAP entry, which
  exists, and the CLI exits 1 for it.
* Variants: the table equals the reference's `VARIANTS`.
* Process groups: a dry run leaves none behind and refuses to start
  while one is initialised; the roofline tables render the records.

The fake-against-real check (collectives and plain-route flops of a
meta trace equal to a real gloo (2, 2) run) is in
`tests/test_torch_serve_mesh.py`, beside its worlds.

Tolerance: none (integers and exact float sums); the accumulation check
allows the optimizer's share.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import ast
import dataclasses
import datetime
import json
import math
import re
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro.core import locality as jloc
from repro_torch.cluster import cells
from repro_torch.cluster.session import (Cluster, CompiledDryRun,
                                         DryRunProgram)
from repro_torch.configs import get as tget
from repro_torch.configs.registry import ShapeConfig
from repro_torch.core import addressing, compat, locality, op_cost
from repro_torch.core.addressing import MeshSpec
from repro_torch.device import tracing_card
from repro_torch.kernels import fused, launches, traced
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import rmsnorm as trms
from repro_torch.launch import dryrun, roofline

ROOT = Path(__file__).resolve().parents[1]
DENSE, MOE, XLSTM = ("qwen3-14b-smoke", "mixtral-8x7b-smoke",
                     "xlstm-125m-smoke")
MESHES = {"2x4": MeshSpec((2, 4), ("data", "model")),
          "2x2x2": MeshSpec((2, 2, 2), ("pod", "data", "model"))}
ONE = MeshSpec((1, 1), ("data", "model"))
CELLS = {"train": ("train", {}), "prefill": ("prefill", {}),
         "decode": ("decode", {}), "chunk": ("decode", {"decode_chunk": 4}),
         "session": ("decode", {"decode_chunk": 4, "session": True}),
         "paged": ("decode", {"decode_chunk": 4, "session": True,
                              "paged": True})}
# the reference's record (`src/repro/cluster/session.py:930-962`,
# `locality.extract_memory` / `extract_costs`)
REFERENCE_KEYS = {
    "status": None, "n_chips": None,
    "seconds": ("lower", "compile", "analyze"),
    "memory_analysis": ("argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes", "alias_size_in_bytes",
                        "generated_code_size_in_bytes"),
    "peak_device_bytes": None,
    "cost_analysis_builtin": ("flops", "bytes_accessed", "transcendentals"),
    "hlo": ("flops_per_device", "bytes_per_device",
            "transcendentals_per_device",
            "collective_operand_bytes_per_device",
            "collective_wire_bytes_per_device", "collectives"),
    "model": ("n_params", "n_active_params", "tokens", "model_flops"),
    "roofline": ("compute_s", "memory_s", "collective_s",
                 "collective_wire3_s", "useful_flops_ratio", "dominant"),
}


def _run(arch, mesh, kind, policy="tuned", seq=32, batch=8, cfg=None,
         **kw) -> tuple[dict, CompiledDryRun]:
    cfg = cfg or tget(arch)
    cluster = Cluster(cfg, mesh, device="meta")
    with cluster.policy(policy):
        prog = cluster.compile(DryRunProgram(
            shape=ShapeConfig("t", seq, batch, kind), **kw))
    return prog.run(), prog


def _wide(arch=DENSE):
    """The smoke config with heads of 128 (flash_attention_proj's card
    head size, which the fused route needs on the card)."""
    return dataclasses.replace(tget(arch), head_dim=128)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_record_has_the_reference_keys(cell, mesh):
    kind, kw = CELLS[cell]
    rec, _ = _run(DENSE, MESHES[mesh], kind, **kw)
    assert rec["status"] == "ok" and rec["n_chips"] == 8
    notes = rec["notes"]
    for key, sub in REFERENCE_KEYS.items():
        assert key in rec or key in notes, key
        for s in sub or ():
            assert s in rec[key] or f"{key}.{s}" in notes, f"{key}.{s}"
    assert "hlo" in notes and all(isinstance(v, str) and v
                                  for v in notes.values())
    h = rec["hlo"]
    assert h["flops_per_device"] > 0 and h["bytes_per_device"] > 0
    assert rec["cost_analysis_builtin"]["flops"] <= h["flops_per_device"]
    assert set(h["collectives"]) <= {"all-gather", "all-reduce",
                                     "reduce-scatter", "all-to-all"}
    assert h["collective_operand_bytes_per_device"] == pytest.approx(
        sum(v["operand_bytes"] for v in h["collectives"].values()))
    mem = rec["memory_analysis"]
    assert rec["peak_device_bytes"] == locality.peak_device_bytes(mem)
    assert mem["argument_size_in_bytes"] > 0
    if cell == "prefill":
        assert mem["alias_size_in_bytes"] == 0
    else:              # the state / the cache, updated in place
        assert mem["alias_size_in_bytes"] > 0
    r = rec["roofline"]
    assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert r["compute_s"] > 0 and r["memory_s"] > 0 and r["collective_s"] > 0
    assert rec["model"] == cells.model_flops(tget(DENSE),
                                             ShapeConfig("t", 32, 8, kind))
    json.dumps(rec)
    assert not dist.is_initialized()


def test_fused_trace_runs_no_plain_version():
    """Every cell under "fused" inside `tracing_card()`: no plain version
    runs, rows 1-3 are recorded (prefill and train: the mainloop and the
    attention; decode: the decode kernel), and no wrapper launches."""
    traced.PLAIN_CALLS.clear()
    launches.reset_counts()
    seen = {}
    for cell, (kind, kw) in CELLS.items():
        rec, prog = _run(DENSE, MESHES["2x4"], kind, "fused", cfg=_wide(),
                         **kw)
        assert rec["status"] == "ok"
        seen[cell] = set(rec["kernels"])
        assert prog.policy.stats.get("plain_calls", 0) == 0
    assert sum(traced.PLAIN_CALLS.values()) == 0
    assert all(c["launches"] == 0 and c["plain_cuda_calls"] == 0
               for c in launches.counts().values())
    assert seen["prefill"] == seen["train"] == {
        "rmsnorm_matmul:mainloop", "matmul_residual_add:mainloop",
        "flash_attention_proj:attention+mainloop"}
    assert seen["decode"] == seen["paged"] == {
        "rmsnorm_matmul:decode", "matmul_residual_add:decode"}


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _wrapper_calls(m):
    """Rows 1-3 and 5-7 at M = m (16: the decode kernel; 64: the
    mainloop), and the f32 matmul (3xTF32) at M = 64."""
    return {
        "rmsnorm_matmul": lambda: fused.rmsnorm_matmul(
            _meta(m, 256), _meta(256), _meta(256, 512)),
        "matmul_residual_add": lambda: fused.matmul_residual_add(
            _meta(m, 256), _meta(256, 512), _meta(m, 512)),
        "flash_attention_proj": lambda: fused.flash_attention_proj(
            _meta(1, 4, m, 128), _meta(1, 2, m, 128), _meta(1, 2, m, 128),
            _meta(4, 128, 256)),
        "matmul": lambda: tmm.matmul(_meta(m, 256), _meta(256, 512)),
        "rmsnorm": lambda: trms.rmsnorm(_meta(m, 256), _meta(256)),
        "matmul_bias_act": lambda: fused.matmul_bias_act(
            _meta(m, 256), _meta(256, 512), _meta(512), "gelu"),
        "flash_attention": lambda: tfa.flash_attention(
            _meta(1, 4, m, 128), _meta(1, 2, m, 128), _meta(1, 2, m, 128))}


@pytest.mark.parametrize("m", [16, 64])
def test_wrappers_record_their_route_on_meta(m):
    """Each wrapper on meta operands inside `tracing_card()` records its
    route, its traffic and its workspace, and launches nothing; outside
    it the plain version runs (its result's shape, no record)."""
    launches.reset_counts()
    traced.PLAIN_CALLS.clear()
    route = "decode" if m <= 16 else "mainloop"
    want = {"rmsnorm_matmul": route, "matmul_residual_add": route,
            "matmul_bias_act": route, "matmul": route,
            "flash_attention_proj": "attention+mainloop",
            "rmsnorm": "rmsnorm", "flash_attention": "flash_attention"}
    ws = {"rmsnorm_matmul": 0 if m <= 16 else m * 256 // 2,
          "flash_attention_proj": m * 4 * 128 // 2}
    for name, call in _wrapper_calls(m).items():
        with traced.ledger() as recs, tracing_card():
            out = call()
        assert out.is_meta
        assert [(r.name, r.route) for r in recs] == [(name, want[name])]
        assert recs[0].flops > 0 and recs[0].hbm_bytes > 0
        floats = ws.get(name, 0)
        if name not in ("rmsnorm", "flash_attention"):
            assert recs[0].workspace_bytes == 4 * max(floats, 1)
        with traced.ledger() as recs:
            plain = call()
        assert not recs and plain.shape == out.shape
    with traced.ledger() as recs, tracing_card():
        tmm.matmul(_meta(300, 256, dtype=torch.float32),
                   _meta(256, 512, dtype=torch.float32))
    assert recs[0].route == "tf32x3"
    assert recs[0].workspace_bytes == 4 * 2 * 512 * 256
    assert sum(traced.PLAIN_CALLS.values()) == 0
    assert all(c["launches"] == 0 for c in launches.counts().values())


def test_workspace_floats_mirror_the_libraries():
    """`traced.workspace_floats` follows each `<name>_workspace_floats`:
    the mainloop's normalised rows, the attention's head outputs, 3xTF32's
    split of b above the fused threshold, the split-K partials (M <= 16
    with K or N off the decode kernel), and none on the decode kernel."""
    wf = traced.workspace_floats
    assert wf("rmsnorm_matmul", 64, 512, 256) == 64 * 256 // 2
    assert wf("rmsnorm_matmul", 8, 512, 256) == 0
    assert wf("matmul_residual_add", 64, 512, 256) == 0
    assert wf("flash_attention_proj", 2, 4, 33, 256) == (2 * 33 * 4 * 128
                                                         + 1) // 2
    assert wf("matmul", 257, 512, 256, 1) == 2 * 512 * 256
    assert wf("matmul", 256, 512, 256, 1) == 0
    # split-K: K not a multiple of 8 keeps M <= 16 off the decode kernel
    got = wf("matmul_bias_act", 8, 512, 1004)
    assert got > 0 and got % (8 * 512) == 0 and got <= 16 * 8 * 512


def test_meta_cell_outside_tracing_takes_the_plain_route():
    """A meta cell run outside `tracing_card()` under "fused": the plain
    versions serve it (nothing recorded); the products are plain f32
    ones."""
    cfg = _wide()
    with compat.abstract_mesh((2, 4), ("data", "model")) as mesh:
        rules = addressing.default_rules(mesh)
        fn, args, _, _, _ = cells.build_cell(
            cfg, ShapeConfig("t", 32, 8, "prefill"), mesh, rules,
            policy="fused")
        with op_cost.tracked() as tr:
            out = fn(*cells.meta_args(args))
    assert out.is_meta and not tr.kernels
    assert tr.ops.products > 0
    assert not dist.is_initialized()


def test_builtin_count_misses_the_kernels():
    """The counterpart of the reference's undercount test: on a fused
    train cell FlopCounterMode alone misses the kernels' products, so
    model_flops over its count passes 1; the dry run's count does not.
    (At 32 tokens a row the projections, which the kernels run forward
    and again in the recompute, outweigh attention's backward.)"""
    rec, _ = _run(DENSE, ONE, "train", "fused", seq=32, batch=8,
                  cfg=_wide())
    mf, n = rec["model"]["model_flops"], rec["n_chips"]
    assert mf / (rec["cost_analysis_builtin"]["flops"] * n) > 1.0
    assert mf / (rec["hlo"]["flops_per_device"] * n) <= 1.0
    assert rec["roofline"]["useful_flops_ratio"] <= 1.0


def test_accumulation_counts_every_microbatch():
    """grad_accum 4 at batch 8 traces 4x the flops of one microbatch of 2
    (grad_accum 1), less 3 optimizer updates: the step's Python loop
    counts each microbatch as it runs."""
    cfg = tget(DENSE)
    r4, _ = _run(DENSE, ONE, "train", seq=32, batch=8,
                 cfg=dataclasses.replace(cfg, grad_accum=4))
    r1, _ = _run(DENSE, ONE, "train", seq=32, batch=2,
                 cfg=dataclasses.replace(cfg, grad_accum=1))
    f4, f1 = r4["hlo"]["flops_per_device"], r1["hlo"]["flops_per_device"]
    optimizer = (4 * f1 - f4) / 3      # an AdamW update's flops
    assert 0 <= optimizer <= 40 * cfg.n_params()


CASES = [(k, b, g) for k in ("all-gather", "all-reduce", "reduce-scatter",
                             "all-to-all", "collective-permute")
         for b in (0.0, 4096.0, 1e9 + 3) for g in (1, 2, 16, 512)]


def test_locality_arithmetic_equals_the_references():
    for kind, b, g in CASES:
        assert locality._op_bytes(kind, b, g) == jloc._op_bytes(kind, b, g)
    stats = {"all-gather": (3, 100.0, 700.0), "all-reduce": (2, 50.0, 75.0)}
    mine = locality.LocalityReport({k: locality.CollectiveStats(*v)
                                    for k, v in stats.items()})
    ref = jloc.LocalityReport({k: jloc.CollectiveStats(*v)
                               for k, v in stats.items()})
    for total in (0.0, 100.0, 775.0, 1e6):
        assert mine.p_local(total) == ref.p_local(total)
    assert mine.as_dict() == ref.as_dict()
    for mem in ({}, {"argument_size_in_bytes": 10.0,
                     "output_size_in_bytes": 7.0, "temp_size_in_bytes": 3.0,
                     "alias_size_in_bytes": 5.0}):
        assert locality.peak_device_bytes(mem) == jloc.peak_device_bytes(mem)


def test_moe_cells_trace():
    """mixtral's dispatch counts experts with `index_add_` (no
    `bincount`, which a meta trace cannot run); its train and decode
    cells trace on (2, 4) with the dispatch's collectives."""
    for kind in ("train", "decode"):
        rec, _ = _run(MOE, MESHES["2x4"], kind)
        assert rec["status"] == "ok"
        assert rec["hlo"]["collectives"]["all-gather"]["count"] > 0


@pytest.mark.parametrize("arch,multi", [("qwen3-14b", False),
                                        ("qwen3-14b", True),
                                        ("whisper-small", False)])
def test_production_decode_cells_are_ok(arch, multi, tmp_path):
    """`launch/dryrun.run_cell` on the 256- and 512-rank production
    meshes; whisper-small's is the reference's own failing CI cell
    (`tests/test_dryrun_ci.py::test_dryrun_whisper_decode`)."""
    rec = dryrun.run_cell(arch, "decode_32k", "multi" if multi else
                          "single", out_dir=tmp_path)
    assert rec["status"] == "ok"
    assert rec["n_chips"] == (512 if multi else 256)
    assert rec["hlo"]["flops_per_device"] > 0
    assert (tmp_path / f"{arch}__decode_32k__"
            f"{'multi' if multi else 'single'}.json").exists()
    assert not dist.is_initialized()


# rules that split the embedding dim over "model" (the hidden states'
# width), a split the step does not compute for any arch
EMBED_TP = (("embed", "model"),)


def test_tponly_xlstm_is_refused_naming_its_label(tmp_path, monkeypatch):
    """xlstm under the tponly rules (its mLSTM / sLSTM leaves split over
    "model", ROADMAP Queue 1 Q) records "ok" for its train, prefill and
    decode cells on the (2, 4) fake world. A plan the step still refuses
    (the embedding dim over "model") records "refused" naming the ROADMAP
    entry, which exists, and the CLI exits 1 for it (a variant of those
    rules added to the table here)."""
    tponly = dataclasses.replace(
        tget(XLSTM), **{k: v for k, v in dryrun.VARIANTS["tponly"].items()})
    for kind in ("train", "prefill", "decode"):
        rec, _ = _run(XLSTM, MESHES["2x4"], kind, cfg=tponly)
        assert rec["status"] == "ok", (kind, rec.get("reason"))
        assert rec["hlo"]["flops_per_device"] > 0
    refused = dataclasses.replace(tget(XLSTM), rules_overrides=EMBED_TP)
    rec, _ = _run(XLSTM, MESHES["2x4"], "train", cfg=refused)
    assert rec["status"] == "refused"
    entry = re.search(r'ROADMAP Queue 3, "([^"]+)"', rec["reason"]).group(1)
    assert entry in (ROOT / "ROADMAP.md").read_text()
    monkeypatch.setitem(dryrun.VARIANTS, "embed_tp",
                        {"rules_overrides": EMBED_TP})
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "xlstm-125m", "--shape", "train_4k",
                     "--variant", "embed_tp", "--out", str(tmp_path)])
    assert e.value.code == 1
    assert json.loads((tmp_path / "xlstm-125m__train_4k__single__embed_tp"
                       ".json").read_text())["status"] == "refused"
    assert not dist.is_initialized()


def test_variants_equal_the_references():
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    ref = next(ast.literal_eval(n.value) for n in tree.body
               if isinstance(n, ast.AnnAssign)
               and getattr(n.target, "id", "") == "VARIANTS")
    assert dryrun.VARIANTS == ref and len(ref) == 13


def test_dry_run_refuses_a_live_group_and_leaves_none(tmp_path):
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=30))
    try:
        with pytest.raises(RuntimeError, match="process group"):
            _run(DENSE, MESHES["2x4"], "decode")
    finally:
        dist.destroy_process_group()
    rec, _ = _run(DENSE, MESHES["2x4"], "decode")
    assert rec["status"] == "ok" and not dist.is_initialized()


def test_roofline_tables_render_the_records(tmp_path):
    """Records of two meshes, one refused: the baseline, multi-pod and
    variant tables of `launch/roofline.py`."""
    for mesh, name in (("single", "2x4"), ("multi", "2x2x2")):
        rec, _ = _run(DENSE, MESHES[name], "decode")
        dryrun._write({"arch": DENSE, "shape": "t", "mesh": mesh,
                       "variant": None} | rec, tmp_path)
    refused = dataclasses.replace(tget(XLSTM), rules_overrides=EMBED_TP)
    rec, _ = _run(XLSTM, MESHES["2x4"], "train", cfg=refused)
    assert rec["status"] == "refused"
    dryrun._write({"arch": XLSTM, "shape": "t", "mesh": "single",
                   "variant": "embed_tp"} | rec, tmp_path)
    base = roofline.baseline_table("single", tmp_path).splitlines()
    assert len(base) == 3 and DENSE in base[2]
    multi = roofline.multi_pod_table(tmp_path).splitlines()
    assert len(multi) == 3 and multi[2].startswith(f"| {DENSE} | t |")
    assert len(roofline.variant_table(tmp_path).splitlines()) == 2
    sweep = roofline.sweep_table(tmp_path).splitlines()
    assert len(sweep) == 3 and sweep[2].startswith(f"| {DENSE} | t | ")
    assert math.isfinite(float(base[2].split("|")[10]))
