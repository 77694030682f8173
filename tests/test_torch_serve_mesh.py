"""repro_torch's serving cells on a mesh (`cluster/cells.build_cell`,
`steps.make_sharded_prefill_step` / `make_sharded_decode_step`, the
engine's chunk and session cells over them) against the port's
one-process steps and cells and the reference's, in spawned gloo ranks
on the CPU (`tests/torch_ranks.py`).

* Worlds (1, 2), (2, 2), (1, 4) and (2, 1, 2) for qwen3-14b-smoke and
  mixtral-8x7b-smoke (window 16 below the cache length of 24: its
  rolling buffer splits over kv_seq), qwen3 with a cache of 66 rows at
  model 4 (66 % 4 != 0: the plan's fallback puts "model" on kv_heads),
  and both with 8 query and 2 KV heads at model 4 (the KV heads whole:
  every rank computes every KV head's row; qwen3's pool is then whole
  too). Four slots at start positions in different ranks' blocks of the
  rows. Against the one-process step on the whole batch: the prefill's
  tokens, then 8 teacher-forced decode steps' tokens equal, their
  logits within 1e-5 relative L2, and against the reference's
  unsharded `make_prefill_step` / `make_decode_step` (their logits read
  where their greedy argmax takes them) within 1e-5 relative L2.
* Each rank's blocks of the cache and of the pool are the plan's
  `local_block` of the one-process cache (1e-5 relative L2 a leaf: the
  K/V rows are products of a rank's column block of wk / wv); at model >
  1 no rank holds a whole K/V leaf unless the plan keeps both its dims
  whole.
* The decode-chunk (K = 4), session and paged session cells of
  `build_cell` give the one-process cells' tokens and emit flags; the
  chunk starts 4 rows before the middle of the cache's rows, so that it
  writes and attends across two ranks' row blocks.
* The reference's own qwen3 prefill and session (private and paged)
  cells on its (2, 4) test mesh, in a subprocess with 8 host devices
  (lowered from their abstract arguments as its dry run does, then
  called on the same f32 parameters and inputs), give the port's (2, 4)
  world's tokens. The reference's decode and decode-chunk cells do not
  lower there (ShardingTypeError in `dynamic_update_slice`) nor do
  mixtral's prefill and session cells (`jnp.repeat` asks for an
  out_sharding; ROADMAP Queue 3), so those are held to the unsharded
  reference above. In the same subprocess the reference's qwen3 train
  cell with `fsdp_gather` (its per-layer gather) lowers and takes two
  steps; the port's (2, 4) train cell with `fsdp_gather` gives its
  metrics and state within 1e-5.
* On a (1, 1) mesh (a one-rank group of this process) the train cell
  with `fsdp_gather` steps bit for bit as the one without it, and a
  decode cell is the same with the flag; every cell is bit
  for bit the plain step's or cell's in bf16, and a decode step issues
  its model collectives (a layer: one heads_all_gather, lse_max,
  lse_sum, lse_out, two reduce_from_ranks; one argmax_all_gather).
* On a data-only mesh (("data",) of 2) every arch of the registry runs
  its prefill and decode cells with the one-process tokens, and on (2,
  1) (a model axis of 1) the kinds the model axis does not split.
* The cache's plan (`abstract_cache`, `abstract_paged_cache`) is the
  reference's leaf for leaf on the production meshes.
* The other block kinds (`KINDS`: whisper-, xlstm-, recurrentgemma- and
  llama-3.2-vision-smoke) on (1, 2), (2, 2), (1, 4) and (2, 1, 2), and
  whisper with 6 query and 6 KV heads at model 4 (the heads whole, d_ff
  split), as the cases above: whisper's self K/V over kv_seq (its pool
  over kv_heads) and its cross K/V over kv_heads, recurrentgemma's
  rolling window over kv_seq and its RG-LRU state (h, conv) over the lru
  width, vision's attention K/V over kv_seq and its image K/V over
  kv_heads, xlstm's recurrent state whole (its own rules keep its heads
  whole); the vision gates opened (`torch_parity.open_gates`) and each
  prefill given the encoder's stub frames or the image embeddings (so
  is the reference's).
* On a (1, 1) mesh the four archs' cells are bit for bit the plain ones
  in bf16, as qwen3's and mixtral's are.

The weights are the port's seeded draw in f32, the attention weights at
their true fan-in (`torch_parity.true_fan_in`); the caches are f32 on
both sides.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import contextlib
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.utils import _pytree as pytree

import torch_parity
import torch_ranks as tr
from repro.configs import get as jget
from repro.core import addressing as jaddr
from repro.models import steps as jsteps
from repro_torch import weights
from repro_torch.cluster import cells
from repro_torch.configs import ARCHS, get as tget
from repro_torch.configs.registry import SHAPES, ShapeConfig
from repro_torch.core import addressing, collectives
from repro_torch.core.addressing import MeshSpec
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.models import steps as tsteps
from repro_torch.runtime import engine

SRC = Path(__file__).resolve().parents[1] / "src"
DENSE, MOE = "qwen3-14b-smoke", "mixtral-8x7b-smoke"
KV_WHOLE = (("n_heads", 8), ("n_kv_heads", 2))
# (mesh sizes, arch, max_seq, config changes)
CASES = [((1, 2), DENSE, 24, ()), ((1, 2), MOE, 24, ()),
         ((2, 2), DENSE, 24, ()), ((2, 2), MOE, 24, ()),
         ((1, 4), DENSE, 24, ()), ((1, 4), DENSE, 66, ()),
         ((1, 4), DENSE, 24, KV_WHOLE), ((1, 4), MOE, 24, KV_WHOLE),
         ((2, 1, 2), DENSE, 24, ())]
WHISPER, XLSTM, RGEMMA, VISION = (
    "whisper-small-smoke", "xlstm-125m-smoke", "recurrentgemma-9b-smoke",
    "llama-3.2-vision-90b-smoke")
KINDS = [WHISPER, XLSTM, RGEMMA, VISION]
CASES += [(sizes, arch, 24, ()) for arch in KINDS
          for sizes in ((1, 2), (2, 2), (1, 4), (2, 1, 2))]
CASES += [((1, 4), WHISPER, 24, (("n_heads", 6), ("n_kv_heads", 6)))]
# xlstm under the dry run's tponly rules (its mLSTM / sLSTM leaves and
# recurrent state split over "model"), and with 2 heads of 32 at model 4
# (the cells' heads whole, the inner width split)
TPONLY = (("embed", None),)
XLSTM_TP = (("rules_overrides", TPONLY),)
XLSTM_TP_WHOLE = XLSTM_TP + (("n_heads", 2), ("n_kv_heads", 2),
                             ("head_dim", 32))
CASES += [(sizes, XLSTM, 24, XLSTM_TP)
          for sizes in ((1, 2), (2, 2), (1, 4), (2, 1, 2))]
CASES += [((1, 4), XLSTM, 24, XLSTM_TP_WHOLE)]
ALL_ARCHS = sorted(ARCHS)
REF_SHAPE = (64, 8)                     # (seq, slots) of the (2, 4) cells
TRAIN_SHAPE = (16, 8)                   # (seq, batch) of the train cells
DRY_SHAPE = (16, 8)                     # (seq, batch) of the dry-run check
KINDS_START, KINDS_DECODE = 20, 4       # the kinds' (2, 4) decode cells
TOL = 1e-5
# xlstm's f32 logits against the reference's: the port runs the mLSTM
# heads of an f32 run in float64 (`blocks.mlstm_block_apply`), and the
# two part by up to 6.3e-5 here; tests/test_torch_recurrent.py holds the
# recurrent archs' f32 logits to the reference within 1e-4 too
REF_TOL = {XLSTM: 1e-4}


def _names(sizes):
    return ("pod", "data", "model") if len(sizes) == 3 else ("data", "model")


def _case_id(case):
    sizes, arch, max_seq, change = case
    tail = "".join("-tponly" if k == "rules_overrides" else f"-{k[2:]}{v}"
                   for k, v in change)
    return f"{'x'.join(map(str, sizes))}-{arch.split('-')[0]}-s{max_seq}{tail}"


def _cfg(arch, change=()):
    return dataclasses.replace(tget(arch), **dict(change))


def _plain(change) -> tuple:
    """`change` less the rules (which one process does not read)."""
    return tuple((k, v) for k, v in change if k != "rules_overrides")


def _tponly(case) -> bool:
    return any(k == "rules_overrides" for k, _ in case[3])


def _paged(cfg) -> bool:
    """Does the arch page its K/V (positional attention, no window)?"""
    return any(tsteps.paged_cache_mask(cfg, 1, 1).values())


_PARAMS = {}


def _params(arch, change, max_seq):
    """The port's f32 draw (attention weights at their true fan-in) and
    the reference's copy of it."""
    change = _plain(change)
    key = (arch, change, max_seq)
    if key not in _PARAMS:
        cfg = _cfg(arch, change)
        drawn = tsteps.init_params(cfg, 0, device="cpu", max_seq=max_seq)
        ref = torch_parity.open_gates(torch_parity.true_fan_in(
            torch_parity.reference_tree(cfg, drawn)))
        ref = jax.tree.map(lambda a: np.asarray(a, np.float32), ref)
        _PARAMS[key] = (weights.from_jax_params(ref, device="cpu"), ref)
    return _PARAMS[key]


def _save_params(tmp, arch, change, max_seq):
    path = tmp / f"{arch}-{max_seq}-{len(_plain(change))}.pt"
    if not path.exists():
        torch.save(_params(arch, change, max_seq)[0], path)
    return str(path)


REF_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, pickle, sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.cluster import cells
    from repro.configs import get
    from repro.configs.registry import ShapeConfig
    from repro.core import addressing, compat
    from repro.launch.mesh import make_test_mesh

    with open(sys.argv[1], "rb") as f:
        data = pickle.load(f)
    cfg = get(data["arch"])
    mesh = make_test_mesh()
    rules = addressing.default_rules(mesh, overrides=cfg.rules_overrides)
    S, B = data["seq"], data["batch"]

    def compiled(cell):
        # lowered from its abstract arguments (in f32) as the dry run
        # lowers it, then called on arguments placed by its shardings
        fn, args, in_sh, out_sh, donate = cell
        args = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
            s.shape, jnp.float32 if jnp.issubdtype(s.dtype, jnp.floating)
            else s.dtype), args)
        with compat.set_mesh(mesh):
            exe = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                          donate_argnums=donate).lower(*args).compile()
        return (lambda *a: exe(*jax.tree.map(jax.device_put, a, in_sh)),
                args)

    params = jax.tree.map(jnp.asarray, data["params"])
    out = {}
    f, _ = compiled(cells.build_cell(cfg, ShapeConfig("t", S, B, "prefill"),
                                     mesh, rules))
    out["prefill"] = np.asarray(f(params, {"tokens": jnp.asarray(
        data["prefill"])})).tolist()
    for paged in (False, True):
        f, args = compiled(cells.build_cell(
            cfg, ShapeConfig("t", S, B, "decode"), mesh, rules,
            decode_chunk=data["chunk"], session=True, paged=paged,
            page_size=data["page"]))
        state = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), args[1])
        for k in ("prompt_buf", "prompt_len", "budget"):
            state[k] = jnp.asarray(data[k], state[k].dtype)
        state["active"] = jnp.ones((B,), bool)
        if paged:
            pps = state["pages"].shape[1]
            state["pages"] = jnp.asarray(
                1 + np.arange(B)[:, None] * pps + np.arange(pps), jnp.int32)
        toks, emits = [], []
        for _ in range(data["rounds"]):
            state, t, e, _, _ = f(params, state)
            toks.append(np.asarray(t))
            emits.append(np.asarray(e))
        out["paged" if paged else "session"] = [
            np.concatenate(toks, 1).tolist(),
            np.concatenate(emits, 1).tolist()]
    train = data["train"]
    f, _ = compiled(cells.build_cell(
        cfg, ShapeConfig("t", train["seq"], train["batch"], "train"), mesh,
        rules, fsdp_gather=True))
    state, metrics = jax.tree.map(jnp.asarray, train["state"]), []
    for b in train["batches"]:
        state, m = f(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    with open(sys.argv[1] + ".train", "wb") as f:
        pickle.dump({"metrics": metrics, "state": jax.tree.map(
            lambda a: np.asarray(a, np.float32), state)}, f)
    # the other block kinds: the train cell (two steps) and the decode
    # cell (teacher-forced steps from one position), or the name of the
    # error the decode cell raises as it lowers
    out["kinds"] = {}
    for arch, kd in data["kinds"].items():
        kcfg = get(arch)
        krules = addressing.default_rules(mesh,
                                          overrides=kcfg.rules_overrides)
        t, d, res = kd["train"], kd["decode"], {}
        f, _ = compiled(cells.build_cell(
            kcfg, ShapeConfig("t", t["seq"], t["batch"], "train"), mesh,
            krules))
        state, res["train"] = jax.tree.map(jnp.asarray, t["state"]), []
        for b in t["batches"]:
            state, m = f(state, {k: jnp.asarray(v) for k, v in b.items()})
            res["train"].append({k: float(v) for k, v in m.items()})
        with open(sys.argv[1] + "." + arch, "wb") as fh:
            pickle.dump(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                     state), fh)
        try:
            f, args = compiled(cells.build_cell(
                kcfg, ShapeConfig("t", d["seq"], d["batch"], "decode"), mesh,
                krules))
        except Exception as e:
            res["decode"] = type(e).__name__
        else:
            kp = jax.tree.map(jnp.asarray, d["params"])
            cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                                 args[1])
            toks = []
            for i in range(d["tokens"].shape[1]):
                cache, tok = f(kp, cache, {
                    "tokens": jnp.asarray(d["tokens"][:, i:i + 1]),
                    "pos": jnp.asarray(d["start"] + i, jnp.int32)})
                toks.append(np.asarray(tok))
            res["decode"] = np.concatenate(toks, 1).tolist()
        out["kinds"][arch] = res
    # xlstm under the tponly rules: its train, prefill and decode cells
    tp = data["tponly"]
    tcfg = dataclasses.replace(get(tp["arch"]), rules_overrides=tp["rules"])
    trules = addressing.default_rules(mesh, overrides=tcfg.rules_overrides)
    t, d, res = tp["train"], tp["decode"], {}
    f, _ = compiled(cells.build_cell(
        tcfg, ShapeConfig("t", t["seq"], t["batch"], "train"), mesh, trules))
    state, res["train"] = jax.tree.map(jnp.asarray, t["state"]), []
    for b in t["batches"]:
        state, m = f(state, {k: jnp.asarray(v) for k, v in b.items()})
        res["train"].append({k: float(v) for k, v in m.items()})
    with open(sys.argv[1] + ".tponly", "wb") as fh:
        pickle.dump(jax.tree.map(lambda a: np.asarray(a, np.float32), state),
                    fh)
    kp = jax.tree.map(jnp.asarray, d["params"])
    f, _ = compiled(cells.build_cell(
        tcfg, ShapeConfig("t", d["seq"], d["batch"], "prefill"), mesh,
        trules))
    res["prefill"] = np.asarray(f(kp, {"tokens": jnp.asarray(
        tp["prefill"])})).tolist()
    f, args = compiled(cells.build_cell(
        tcfg, ShapeConfig("t", d["seq"], d["batch"], "decode"), mesh,
        trules))
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), args[1])
    toks = []
    for i in range(d["tokens"].shape[1]):
        cache, tok = f(kp, cache, {
            "tokens": jnp.asarray(d["tokens"][:, i:i + 1]),
            "pos": jnp.asarray(d["start"] + i, jnp.int32)})
        toks.append(np.asarray(tok))
    res["decode"] = np.concatenate(toks, 1).tolist()
    out["tponly"] = res
    print(json.dumps(out))
""")


def _ref_inputs(cfg):
    """The (2, 4) cells' inputs: REF_SHAPE's prefill tokens, and a session
    of prompts and budgets, every slot admitted."""
    S, B = REF_SHAPE
    rng = np.random.default_rng(3)
    lens = rng.integers(2, tr.MAX_PROMPT + 1, B)
    buf = np.zeros((B, tr.MAX_PROMPT), np.int64)
    for b in range(B):
        buf[b, :lens[b]] = rng.integers(0, cfg.vocab, lens[b])
    return {"prefill": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "prompt_buf": buf, "prompt_len": lens,
            "budget": rng.integers(3, 7, B)}


def _train_inputs(arch=DENSE):
    """The (2, 4) train cells' inputs: the initial state in the
    reference's layout (the port's f32 draw at TRAIN_SHAPE's seq, the
    attention weights at their true fan-in, the cross gates open, zero
    moments) and two seeded global batches (with the encoder's stub
    frames or the image embeddings where the arch takes them)."""
    S, B = TRAIN_SHAPE
    cfg = tget(arch)
    params = _params(arch, (), S)[1]
    zeros = jax.tree.map(np.zeros_like, params)
    state = {"params": params, "opt": {"m": zeros, "v": zeros,
                                       "step": np.zeros((), np.int32)}}
    rng = np.random.default_rng(9)
    batches = [{k: rng.integers(0, cfg.vocab, (B, S)).astype(
        np.int32) for k in ("tokens", "labels")} for _ in range(2)]
    n, key = ((cfg.enc_seq, "enc_embeds") if cfg.family == "encdec" else
              (cfg.n_img_tokens, "img_embeds") if cfg.family == "vlm"
              else (0, None))
    for b in batches if n else ():
        b[key] = (0.5 * rng.standard_normal((B, n, cfg.d_model))).astype(
            np.float32)
    return state, batches


def _kinds_inputs(arch):
    """The (2, 4) cells' inputs of an arch of `KINDS`: its train cell's
    (`_train_inputs`, each batch with its cross context) and its decode
    cell's (REF_SHAPE's f32 parameters, teacher-forced tokens of
    `KINDS_DECODE` steps from `KINDS_START`, every slot at one
    position)."""
    state, batches = _train_inputs(arch)
    S, B = REF_SHAPE
    rng = np.random.default_rng(13)
    return {"train": dict(seq=TRAIN_SHAPE[0], batch=TRAIN_SHAPE[1],
                          state=state, batches=batches),
            "decode": dict(seq=S, batch=B, start=KINDS_START,
                           params=_params(arch, (), S)[1],
                           tokens=rng.integers(0, tget(arch).vocab,
                                               (B, KINDS_DECODE)).astype(
                                                   np.int32))}


def _tponly_inputs():
    """The (2, 4) cells' inputs of xlstm under the tponly rules: its own
    rules' train and decode inputs (`_kinds_inputs`) and REF_SHAPE's
    prefill prompts."""
    S, B = REF_SHAPE
    rng = np.random.default_rng(17)
    return _kinds_inputs(XLSTM) | {
        "arch": XLSTM, "rules": TPONLY,
        "prefill": rng.integers(0, tget(XLSTM).vocab, (B, S)).astype(
            np.int32)}


def _start_reference_cells(tmp):
    """The reference's qwen3 (2, 4) cells, the other block kinds' train
    and decode cells and xlstm's under the tponly rules in a subprocess
    (started, not waited for)."""
    cfg = tget(DENSE)
    state, batches = _train_inputs()
    data = dict(arch=DENSE, params=_params(DENSE, (), REF_SHAPE[0])[1],
                seq=REF_SHAPE[0], batch=REF_SHAPE[1], chunk=tr.CHUNK,
                page=tr.PAGE, rounds=2, **_ref_inputs(cfg),
                train=dict(seq=TRAIN_SHAPE[0], batch=TRAIN_SHAPE[1],
                           state=state, batches=batches),
                kinds={a: _kinds_inputs(a) for a in KINDS},
                tponly=_tponly_inputs())
    path = tmp / "ref_cells.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(path)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world of this module and the reference's (2, 4) cells,
    started together: 2 gloo ranks (the (1, 2) cases), 4 (the 4-rank
    cases), 8 (the (2, 4) cells of qwen3), 2 on a data-only mesh (every
    arch's prefill and decode cells)."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    jobs = {2: [], 4: []}
    for sizes, arch, max_seq, change in CASES:
        jobs[int(np.prod(sizes))].append(("serve_case", dict(
            arch=arch, params=_save_params(tmp, arch, change, max_seq),
            max_seq=max_seq, mesh=sizes, names=_names(sizes),
            replace=dict(change) or None,
            paged=_paged(_cfg(arch, change)))))
    data_only = [("serve_case", dict(
        arch=a + "-smoke", params=_save_params(tmp, a + "-smoke", (), 24),
        max_seq=24, mesh=(2,), names=("data",), cells=False))
        for a in ALL_ARCHS] + [("serve_case", dict(
            arch=a, params=_save_params(tmp, a, (), 24), max_seq=24,
            mesh=(2, 1), cells=False)) for a in KINDS]
    # last in the 4-rank world: the dry run's fake-against-real check
    jobs[4].append(("dryrun_cells", dict(arch=DENSE, seq=DRY_SHAPE[0],
                                         batch=DRY_SHAPE[1])))
    S, B = REF_SHAPE
    ref_cells = _start_reference_cells(tmp)
    kinds_jobs = []
    for arch in (DENSE, *KINDS):
        state, batches = _train_inputs(arch)
        torch.save(weights.from_jax_train_state(state, device="cpu"),
                   tmp / f"train_state-{arch}.pt")
        torch.save([{k: torch.from_numpy(v) for k, v in b.items()}
                    for b in batches], tmp / f"train_batches-{arch}.pt")
        if arch != DENSE:
            d = _kinds_inputs(arch)["decode"]
            kinds_jobs += [
                ("train_cell", dict(
                    arch=arch, state=str(tmp / f"train_state-{arch}.pt"),
                    batches=str(tmp / f"train_batches-{arch}.pt"),
                    seq=TRAIN_SHAPE[0], batch=TRAIN_SHAPE[1],
                    fsdp_gather=False)),
                ("decode_cell", dict(
                    arch=arch, params=_save_params(tmp, arch, (), S),
                    seq=S, batch=B, start=KINDS_START,
                    tokens=torch.from_numpy(d["tokens"])))]
    tp = _tponly_inputs()
    kinds_jobs += [
        ("train_cell", dict(
            arch=XLSTM, state=str(tmp / f"train_state-{XLSTM}.pt"),
            batches=str(tmp / f"train_batches-{XLSTM}.pt"),
            seq=TRAIN_SHAPE[0], batch=TRAIN_SHAPE[1], fsdp_gather=False,
            replace=dict(XLSTM_TP))),
        ("prefill_cell", dict(
            arch=XLSTM, params=_save_params(tmp, XLSTM, (), S),
            tokens=torch.from_numpy(tp["prefill"]), replace=dict(XLSTM_TP))),
        ("decode_cell", dict(
            arch=XLSTM, params=_save_params(tmp, XLSTM, (), S), seq=S,
            batch=B, start=KINDS_START,
            tokens=torch.from_numpy(tp["decode"]["tokens"]),
            replace=dict(XLSTM_TP)))]
    worlds = {
        2: tr.start_ranks(jobs[2], 2, tmp / "two", timeout=300),
        4: tr.start_ranks(jobs[4], 4, tmp / "four", timeout=300),
        8: tr.start_ranks([("serve_ref_cells", dict(
            arch=DENSE, params=_save_params(tmp, DENSE, (), S),
            inputs={k: torch.from_numpy(np.asarray(v)) for k, v in
                    _ref_inputs(tget(DENSE)).items()})),
            ("train_cell", dict(arch=DENSE,
                                state=str(tmp / f"train_state-{DENSE}.pt"),
                                batches=str(tmp / f"train_batches-{DENSE}.pt"),
                                seq=TRAIN_SHAPE[0], batch=TRAIN_SHAPE[1]))]
            + kinds_jobs, 8, tmp / "eight", timeout=300),
        "data": tr.start_ranks(data_only, 2, tmp / "data", timeout=300)}
    out = {k: w.wait() for k, w in worlds.items()}
    stdout, stderr = ref_cells.communicate(timeout=600)
    assert ref_cells.returncode == 0, stderr[-3000:]
    out["ref_cells"] = json.loads(stdout.strip().splitlines()[-1])
    with open(tmp / "ref_cells.pkl.train", "rb") as f:
        out["ref_train"] = pickle.load(f)
    out["ref_kinds_state"] = {}
    for arch in KINDS:
        with open(tmp / f"ref_cells.pkl.{arch}", "rb") as f:
            out["ref_kinds_state"][arch] = pickle.load(f)
    with open(tmp / "ref_cells.pkl.tponly", "rb") as f:
        out["ref_tponly_state"] = pickle.load(f)
    return out


def test_dry_run_equals_a_real_run_of_its_rank(runs):
    """A dry run's meta trace of each rank of a (2, 2) fake world
    (`core.compat.abstract_mesh(rank=)`) against the gloo world's real
    run of the same rank (`torch_ranks.dryrun_cells`): qwen3-14b-smoke's
    train and decode cells of `build_cell` issue the same collectives by
    name, count and bytes, and their products the same flops
    (FlopCounterMode's formulas; both on the plain route: the real run's
    tensors are on the CPU, the trace runs outside `tracing_card`)."""
    from repro_torch.core import compat, op_cost
    cfg = tget(DENSE)
    for rank, res in enumerate(runs[4]):
        real = res[-1]
        with compat.abstract_mesh((2, 2), ("data", "model"),
                                  rank=rank) as mesh:
            rules = addressing.default_rules(
                mesh, overrides=cfg.rules_overrides)
            for kind in ("train", "decode"):
                fn, args = cells.build_cell(cfg, ShapeConfig(
                    "t", *DRY_SHAPE, kind), mesh, rules)[:2]
                collectives.reset_counts()
                with op_cost.tracked() as tr:
                    fn(*cells.meta_args(args))
                got = collectives.counts()
                assert got == real[kind]["collectives"], (rank, kind)
                assert any(got.values())
                assert tr.ops.products == real[kind]["products"] > 0
    assert not dist.is_initialized()


def _result(runs, case):
    world = int(np.prod(case[0]))
    index = [c for c in CASES if np.prod(c[0]) == world].index(case)
    return [r[index] for r in runs[world]]


_ONE = {}


def _one_process(arch, change, max_seq, cells=True):
    """The port's one-process results of a case (`serve_reference`)."""
    change = _plain(change)
    key = (arch, change, max_seq, cells)
    if key not in _ONE:
        cfg = _cfg(arch, change)
        _ONE[key] = tr.serve_reference(
            cfg, _params(arch, change, max_seq)[0], max_seq,
            tr.serve_inputs(cfg, max_seq), paged=_paged(cfg),
            cross=tr.serve_cross(cfg), cells=cells)
    return _ONE[key]


class _Argmaxes:
    """`jnp` for the reference's step module, recording the logits its
    greedy `argmax` reads."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def argmax(self, x, *a, **k):
        self.seen.append(np.asarray(x))
        return jnp.argmax(x, *a, **k)


@contextlib.contextmanager
def _reading_logits():
    rec, old = _Argmaxes(), jsteps.jnp
    jsteps.jnp = rec
    try:
        yield rec
    finally:
        jsteps.jnp = old


_REF = {}


def _reference(arch, change, max_seq):
    """The reference's unsharded prefill and decode steps (run op by op,
    their logits read): (prefill logits, each decode step's logits)."""
    change = _plain(change)
    key = (arch, change, max_seq)
    if key not in _REF:
        cfg = dataclasses.replace(jget(arch), **dict(change))
        jp = jax.tree.map(jnp.asarray, _params(arch, change, max_seq)[1])
        inputs = tr.serve_inputs(_cfg(arch, change), max_seq)
        clen = jsteps.decode_cache_len(cfg, max_seq)
        cache = jax.tree.map(lambda c: c.astype(jnp.float32),
                             jsteps.init_cache(cfg, tr.SERVE_B, clen))
        batch = {"tokens": jnp.asarray(inputs["prefill"].numpy())}
        cross = tr.serve_cross(_cfg(arch, change))
        if cross is not None:
            batch["enc_embeds" if cfg.family == "encdec" else
                  "img_embeds"] = jnp.asarray(cross.numpy())
        with _reading_logits() as rec:
            jsteps.make_prefill_step(cfg)(jp, batch)
            step = jsteps.make_decode_step(cfg, max_seq)
            for t in range(tr.DECODE_STEPS):
                cache, _ = step(jp, cache, {
                    "tokens": jnp.asarray(inputs["decode"][:, t:t + 1]
                                          .numpy()),
                    "pos": jnp.asarray((inputs["starts"] + t).numpy(),
                                       jnp.int32)})
        _REF[key] = rec.seen[0], rec.seen[1:]
    return _REF[key]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


_FLOOR = {}


def _logits_floor(arch, change, max_seq) -> float:
    """The noise floor of a case's f32 logits: the largest relative L2
    change of the one-process prefill's or a decode step's logits when
    every parameter moves by 1e-7 relative (three seeded normal draws).
    xlstm's mLSTM decode, whose head outputs are normalised by sums that
    cancel, moves its logits by up to ~6e-5 so; a split's sum order moves
    them as much."""
    change = _plain(change)
    key = (arch, change, max_seq)
    if key not in _FLOOR:
        cfg = _cfg(arch, change)
        params = _params(arch, change, max_seq)[0]
        base, worst = _one_process(arch, change, max_seq), 0.0
        for seed in range(3):
            gen = torch.Generator().manual_seed(seed)
            moved = tr.serve_reference(
                cfg, pytree.tree_map(lambda t: t * (1 + 1e-7 * torch.randn(
                    t.shape, generator=gen)), params), max_seq,
                tr.serve_inputs(cfg, max_seq), paged=False,
                cross=tr.serve_cross(cfg), cells=False)
            for a, b in zip([moved["prefill_logits"]]
                            + moved["decode_logits"],
                            [base["prefill_logits"]]
                            + base["decode_logits"]):
                worst = max(worst, _rel(a, b))
        _FLOOR[key] = worst
    return _FLOOR[key]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_serve_steps_equal_one_process_and_reference(runs, case):
    """Prefill tokens, 8 decode steps' tokens (equal) and logits (1e-5)
    against the one-process step, logits against the reference's
    unsharded steps (1e-5); every rank of a batch row gives the same.
    xlstm under the tponly rules, whose mLSTM sums its split products in
    another order, holds its logits within twice their noise floor
    (`_logits_floor`) where that is above 1e-5."""
    _, arch, max_seq, change = case
    one = _one_process(arch, change, max_seq)
    ref_prefill, ref_decode = _reference(arch, change, max_seq)
    ref_tol = REF_TOL.get(arch, TOL)
    tol = TOL
    if _tponly(case):
        tol = max(TOL, 2 * _logits_floor(arch, change, max_seq))
        ref_tol += tol
    assert len(ref_decode) == tr.DECODE_STEPS
    for r in _result(runs, case):
        rows = slice(*r["rows"])
        assert torch.equal(r["prefill"], one["prefill"][rows])
        assert _rel(r["prefill_logits"], one["prefill_logits"][rows]) < tol
        assert _rel(r["prefill_logits"], ref_prefill[rows]) < ref_tol
        for t in range(tr.DECODE_STEPS):
            assert torch.equal(r["decode"][t], one["decode"][t][rows]), t
            assert _rel(r["decode_logits"][t],
                        one["decode_logits"][t][rows]) < tol, t
            assert _rel(r["decode_logits"][t],
                        ref_decode[t][rows]) < ref_tol, t


def _blocks_close(cfg, mesh_sizes, names, r, whole, sds, log, tol=TOL):
    """Each leaf of a rank's cache `r` is the plan's local block of
    `whole` (`tol` relative L2) at its shard shape; at model > 1 none is
    whole unless the plan keeps both K/V dims whole."""
    mesh = MeshSpec(mesh_sizes, names)
    rules = addressing.default_rules(mesh, overrides=cfg.rules_overrides)
    split_any = False
    for k in sds:
        spec = rules.spec_for(log[k], sds[k].shape, mesh)
        block = addressing.local_block(spec, sds[k].shape, mesh,
                                       r["coords"])
        assert tuple(r[k].shape) == addressing.shard_shape(
            spec, sds[k].shape, mesh), k
        want = whole[k][block]
        assert _rel(r[k], want) < tol if want.abs().sum() else \
            not r[k].abs().sum(), k
        if "model" in {a for d in range(len(spec))
                       for a in addressing.spec_axes(spec, d)}:
            split_any = True
            assert r[k].numel() < whole[k].numel(), k
    return split_any


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_cache_blocks_are_the_plans_local_block(runs, case):
    """Each rank's cache and pool blocks after the steps are the plan's
    `local_block` of the one-process cache and pool: the private K/V over
    kv_seq (or kv_heads at 66 rows), the pool over kv_heads; at model > 1
    no rank holds a whole K/V leaf unless the plan keeps it whole."""
    sizes, arch, max_seq, change = case
    cfg = _cfg(arch, change)
    one = _one_process(arch, change, max_seq)
    B, clen = tr.SERVE_B, tsteps.decode_cache_len(cfg, max_seq)
    kv = arch != XLSTM                  # xlstm's caches hold no K/V
    tol = TOL
    if _tponly(case):
        tol = max(TOL, 2 * _logits_floor(arch, change, max_seq))
    for r in _result(runs, case):
        split = r["split"]
        sds, log = tsteps.abstract_cache(cfg, B, clen)
        cut = _blocks_close(cfg, sizes, _names(sizes),
                            dict(r["cache"], coords=r["coords"]),
                            one["cache"], sds, log, tol)
        # xlstm's recurrent state splits with its leaves under tponly
        assert cut == (kv and (split.rows is not None
                               or split.heads is not None)
                       or _tponly(case))
        if max_seq == 66:
            assert split.rows is None and split.heads is not None
        elif not change:
            assert split.rows is not None
        if arch in (WHISPER, VISION):
            assert (split.cross_heads is not None) == (not change)
        if _paged(cfg):
            pps = -((max_seq + 1) // -tr.PAGE)
            sds, log = tsteps.abstract_paged_cache(
                cfg, B, clen, n_pages=B * pps + 1, page_size=tr.PAGE)
            cut = _blocks_close(cfg, sizes, _names(sizes),
                                dict(r["pool"], coords=r["coords"]),
                                one["pool"], sds, log)
            assert cut == (split.pool_heads is not None)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_cells_give_the_plain_cells_tokens(runs, case):
    """The decode-chunk, session and (without a window) paged session
    cells of `build_cell`: each rank's tokens and emit flags are its rows
    of the one-process cells'. The chunk's 8 steps start CHUNK rows
    before the middle of the cache's rows (`torch_ranks.chunk_start`):
    at model 2 or 4 they cross from one rank's row block into the
    next's."""
    _, arch, max_seq, change = case
    one = _one_process(arch, change, max_seq)
    for r in _result(runs, case):
        rows = slice(*r["rows"])
        assert torch.equal(r["chunk"], one["chunk"][rows])
        for kind in ("session", "paged") if _paged(_cfg(arch, change)) \
                else ("session",):
            toks, emit = r[kind]
            assert torch.equal(emit, one[kind][1][rows]), kind
            assert emit.any(), kind
            assert torch.equal(toks[emit], one[kind][0][rows][emit]), kind


def test_reference_cells_at_2x4_give_the_ports_tokens(runs):
    """The reference's own qwen3 prefill, session and paged session cells
    on its (2, 4) test mesh (lowered from their abstract arguments, as
    its dry run lowers them) against the port's (2, 4) world on the same
    f32 parameters and inputs: the prefill tokens, the session's emit
    flags and emitted tokens equal. (The reference's decode and
    decode-chunk cells raise ShardingTypeError there, and mixtral's
    prefill and session cells ask `jnp.repeat` for an out_sharding: those
    are held to the unsharded reference in
    `test_serve_steps_equal_one_process_and_reference`.)"""
    ref = runs["ref_cells"]
    S, B = REF_SHAPE
    got = {"prefill": [None] * B, "session": {}, "paged": {}}
    for r in (ranks[0] for ranks in runs[8]):
        rows = range(*r["rows"])
        for i, b in enumerate(rows):
            got["prefill"][b] = int(r["prefill"][i])
            for kind in ("session", "paged"):
                got[kind][b] = (r[kind][0][i], r[kind][1][i])
    assert got["prefill"] == ref["prefill"]
    for kind in ("session", "paged"):
        toks, emit = (np.asarray(a) for a in ref[kind])
        for b in range(B):
            t, e = (x.numpy() for x in got[kind][b])
            steps = min(e.shape[0], emit.shape[1])
            assert not emit[b, steps:].any() and not e[steps:].any()
            np.testing.assert_array_equal(e[:steps], emit[b, :steps])
            np.testing.assert_array_equal(t[:steps][e[:steps]],
                                          toks[b, :steps][emit[b, :steps]])
        assert emit.any()


def test_reference_fsdp_gather_train_cell_at_2x4(runs):
    """The reference's own qwen3 train cell with `fsdp_gather` (each
    super-block's weights constrained to `layer_gather_specs` inside its
    scan) on its (2, 4) test mesh, lowered from its abstract arguments
    in f32 and called on placed arrays, against the port's
    `build_cell(fsdp_gather=True)` train cell on a (2, 4) world from the
    same f32 state on the same two global batches: every rank's metrics
    equal, and each step's metrics within 1e-5 relative of the
    reference's, every leaf of the state after them within 1e-5 relative
    L2."""
    ref = runs["ref_train"]
    got = [r[1] for r in runs[8]]
    for r in got[1:]:
        assert r["metrics"] == got[0]["metrics"]
    for g, w in zip(got[0]["metrics"], ref["metrics"]):
        assert sorted(g) == sorted(w)
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-5 * max(abs(w[k]), 1.0), (k, g, w)
    want = weights.from_jax_train_state(ref["state"], device="cpu")
    assert int(got[0]["state"]["opt"]["step"]) == int(
        want["opt"]["step"]) == len(ref["metrics"])

    def close(path, a, b):
        a, b = a.double(), b.double()
        rel = float((a - b).norm() / max(float(b.norm()), 1e-30))
        assert rel < 1e-5, (pytree.keystr(path), rel)

    for part in ("params", "m", "v"):
        pytree.tree_map_with_path(
            close, *(s["params"] if part == "params" else s["opt"][part]
                     for s in (got[0]["state"], want)))


# the decode cells of the reference that raise as they lower on its
# (2, 4) test mesh under jax 0.9.0 (ShardingTypeError in
# `dynamic_update_slice`, as qwen3's decode cell does; ROADMAP Queue 3)
REF_DECODE_RAISES = {WHISPER: "ShardingTypeError",
                     RGEMMA: "ShardingTypeError",
                     VISION: "ShardingTypeError"}


def _reference_decode(arch):
    """The reference's unsharded decode step on the (2, 4) decode cells'
    inputs (`_kinds_inputs`): the tokens of every step."""
    d = _kinds_inputs(arch)["decode"]
    cfg = jget(arch)
    step = jsteps.make_decode_step(cfg, d["seq"])
    cache = jax.tree.map(lambda c: c.astype(jnp.float32), jsteps.init_cache(
        cfg, d["batch"], jsteps.decode_cache_len(cfg, d["seq"])))
    params, toks = jax.tree.map(jnp.asarray, d["params"]), []
    for i in range(d["tokens"].shape[1]):
        cache, tok = step(params, cache, {
            "tokens": jnp.asarray(d["tokens"][:, i:i + 1]),
            "pos": jnp.asarray(d["start"] + i, jnp.int32)})
        toks.append(np.asarray(tok))
    return np.concatenate(toks, 1)


@pytest.mark.parametrize("arch", KINDS, ids=lambda a: a.split("-")[0])
def test_reference_kinds_cells_at_2x4(runs, arch):
    """The reference's own train cell of each other block kind on its (2,
    4) test mesh (lowered from its abstract arguments in f32, called on
    placed arrays) against the port's (2, 4) train cell from the same f32
    state on the same two global batches (with the cross context): every
    rank's metrics equal; the losses within 1e-5 relative at each step,
    the first step's grad norm within 1e-5 and the second's within 2e-4
    (xlstm's only at the first step, within 7e-5, its gradients' bound
    against the reference in `tests/test_torch_grads.py`; see
    `tests/test_torch_tp.py`'s docstring), the parameters after them within 1e-5 relative L2 as a
    whole tree and the moments within 2e-4. The reference's decode cell
    lowers for xlstm only: there the port's (2, 4) decode cell gives its
    tokens; for the others the raise is pinned (`REF_DECODE_RAISES`) and
    the port's decode cell is held to the reference's unsharded decode
    step instead, its tokens equal."""
    k = 2 + 2 * KINDS.index(arch)        # after qwen3's two (2, 4) jobs
    ref = runs["ref_cells"]["kinds"][arch]
    got = [r[k] for r in runs[8]]
    for r in got[1:]:
        assert r["metrics"] == got[0]["metrics"]
    for i, (g, w) in enumerate(zip(got[0]["metrics"], ref["train"])):
        assert sorted(g) == sorted(w)
        assert abs(g["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"]), (i, g, w)
        if i == 0 or arch != XLSTM:
            tol = (7e-5 if arch == XLSTM else 1e-5) if i == 0 else 2e-4
            assert abs(g["grad_norm"] - w["grad_norm"]) <= \
                tol * abs(w["grad_norm"]), (i, g, w)
    want = weights.from_jax_train_state(runs["ref_kinds_state"][arch],
                                        device="cpu")
    for part, tol in (("params", 1e-5), ("m", 2e-4), ("v", 2e-4)):
        a, b = ((s["params"] if part == "params" else s["opt"][part])
                for s in (got[0]["state"], want))
        num = sum(pytree.tree_leaves(pytree.tree_map(
            lambda x, y: float(((x.double() - y.double()) ** 2).sum()),
            a, b)))
        den = sum(float((y.double() ** 2).sum())
                  for y in pytree.tree_leaves(b))
        assert (num / den) ** 0.5 < tol, (part, (num / den) ** 0.5)
    toks = np.zeros((REF_SHAPE[1], KINDS_DECODE), np.int64)
    for r in runs[8]:
        cell = r[k + 1]
        toks[slice(*cell["rows"])] = cell["decode"].numpy()
    if arch in REF_DECODE_RAISES:
        assert ref["decode"] == REF_DECODE_RAISES[arch]
        np.testing.assert_array_equal(toks, _reference_decode(arch))
    else:
        np.testing.assert_array_equal(toks, np.asarray(ref["decode"]))


def test_reference_xlstm_tponly_cells_at_2x4(runs):
    """xlstm under the tponly rules: the reference's own train, prefill
    and decode cells on its (2, 4) test mesh (lowered from their abstract
    arguments in f32, called on placed arrays) against the port's (2, 4)
    cells, which split the mLSTM / sLSTM leaves and state as the plan
    does, on the same f32 state, parameters and inputs: every rank's
    train metrics equal; the losses within 1e-5 relative at each step,
    the first grad norm within 7e-5 (xlstm's gradients' bound against
    the reference, as for its own rules), the parameters after two steps
    within 1e-5 relative L2 as a whole tree and the moments within 2e-4;
    the prefill's tokens and the decode steps' tokens equal."""
    at = 2 + 2 * len(KINDS)            # after qwen3's and the kinds' jobs
    ref = runs["ref_cells"]["tponly"]
    got = [r[at] for r in runs[8]]
    for r in got[1:]:
        assert r["metrics"] == got[0]["metrics"]
    for i, (g, w) in enumerate(zip(got[0]["metrics"], ref["train"])):
        assert sorted(g) == sorted(w)
        assert abs(g["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"]), (i, g, w)
        if i == 0:
            assert abs(g["grad_norm"] - w["grad_norm"]) <= \
                7e-5 * abs(w["grad_norm"]), (g, w)
    want = weights.from_jax_train_state(runs["ref_tponly_state"],
                                        device="cpu")
    for part, tol in (("params", 1e-5), ("m", 2e-4), ("v", 2e-4)):
        a, b = ((s["params"] if part == "params" else s["opt"][part])
                for s in (got[0]["state"], want))
        num = sum(pytree.tree_leaves(pytree.tree_map(
            lambda x, y: float(((x.double() - y.double()) ** 2).sum()),
            a, b)))
        den = sum(float((y.double() ** 2).sum())
                  for y in pytree.tree_leaves(b))
        assert (num / den) ** 0.5 < tol, (part, (num / den) ** 0.5)
    S, B = REF_SHAPE
    pre = np.zeros((B,), np.int64)
    toks = np.zeros((B, KINDS_DECODE), np.int64)
    for r in runs[8]:
        pre[slice(*r[at + 1]["rows"])] = r[at + 1]["prefill"].numpy().ravel()
        toks[slice(*r[at + 2]["rows"])] = r[at + 2]["decode"].numpy()
    np.testing.assert_array_equal(pre, np.asarray(ref["prefill"]).ravel())
    np.testing.assert_array_equal(toks, np.asarray(ref["decode"]))


def _one_rank_mesh(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    return make_device_mesh(MeshSpec((1, 1), ("data", "model")), "cpu")


def _one_rank_cells(cfg, mesh):
    """Every cell of `cfg` on the (1, 1) `mesh` (bf16, "fused") against
    the plain step or cell, bit for bit: the prefill's tokens; 6 decode
    steps' tokens and cache; the decode-chunk's, the session's and
    (where the arch pages) the paged session's tokens. -> the last
    decode step's collective counts."""
    S, B = 16, tr.SERVE_B
    rules = addressing.default_rules(mesh, overrides=cfg.rules_overrides)
    params = tsteps.init_params(cfg, 0, device="cpu", max_seq=S)
    inputs = tr.serve_inputs(cfg, S)
    pre = cells.build_cell(cfg, ShapeConfig("t", S, B, "prefill"),
                           mesh, rules, policy="fused")[0]
    plain_pre = tsteps.make_prefill_step(cfg, policy="fused")
    batch = {"tokens": inputs["prefill"]}
    cross = tr.serve_cross(cfg)
    if cross is not None:
        batch["enc_embeds" if cfg.family == "encdec" else "img_embeds"] = \
            cross.to(torch.bfloat16)
    assert torch.equal(pre(params, batch), plain_pre(params, batch))
    shape = ShapeConfig("t", S, B, "decode")
    step = cells.build_cell(cfg, shape, mesh, rules, policy="fused")[0]
    plain = tsteps.make_decode_step(cfg, S, policy="fused")
    clen = tsteps.decode_cache_len(cfg, S)
    a = tsteps.init_cache(cfg, B, clen, device="cpu",
                          shards=step.cache_shards)
    b = tsteps.init_cache(cfg, B, clen, device="cpu")
    for t in range(6):
        batch = {"tokens": inputs["decode"][:, t:t + 1],
                 "pos": inputs["starts"] + t}
        collectives.reset_counts()
        a, ta = step(params, a, batch)
        counts = collectives.counts()
        b, tb = plain(params, b, batch)
        assert torch.equal(ta, tb), (cfg.name, t)
    for k in b:
        assert torch.equal(a[k], b[k]), (cfg.name, k)
    chunk = cells.build_cell(cfg, shape, mesh, rules, policy="fused",
                             decode_chunk=tr.CHUNK)[0]
    got = tr.run_chunk(chunk, params, tsteps.init_cache(
        cfg, B, clen, device="cpu", shards=chunk.cache_shards),
        inputs["decode"][:, :1])
    want = tr.run_chunk(engine.decode_chunk_fn(plain, tr.CHUNK),
                        params, tsteps.init_cache(cfg, B, clen,
                                                  device="cpu"),
                        inputs["decode"][:, :1])
    assert torch.equal(got, want)
    for paged in (False, True) if _paged(cfg) else (False,):
        fn, args = cells.build_cell(
            cfg, shape, mesh, rules, policy="fused",
            decode_chunk=tr.CHUNK, session=True, paged=paged,
            page_size=tr.PAGE)[:2]
        pps = args[1]["pages"].shape[1] if paged else None
        n_pages = None if pps is None else B * pps + 1

        def fresh(shards=None):
            c = (tsteps.init_paged_cache(
                cfg, B, clen, n_pages=n_pages, page_size=tr.PAGE,
                device="cpu", shards=shards) if paged else
                tsteps.init_cache(cfg, B, clen, device="cpu",
                                  shards=shards))
            return _bf16_state(c, inputs, pps)

        got = tr.run_session(fn, params, fresh(fn.cache_shards))
        want = tr.run_session(engine.session_chunk_fn(
            plain, tr.CHUNK, cuda_graph=False), params, fresh())
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert got[1].any()
    return counts


def test_one_rank_cells_are_bit_equal_and_count_collectives(tmp_path):
    """On a (1, 1) mesh every cell of qwen3 and mixtral (bf16, "fused")
    goes through the split code at size 1 and equals the plain step or
    cell bit for bit (`_one_rank_cells`); a decode step of qwen3 issues
    one heads_all_gather, lse_max, lse_sum and lse_out a layer,
    reduce_from_ranks twice a layer and once for the embedding, and one
    argmax_all_gather."""
    mesh = _one_rank_mesh(tmp_path)
    try:
        for arch in (DENSE, MOE):
            cfg = tget(arch)
            counts = _one_rank_cells(cfg, mesh)
            if arch == DENSE:
                L = cfg.n_layers
                for name in ("heads_all_gather", "lse_max", "lse_sum",
                             "lse_out"):
                    assert counts[name] == L, (name, counts)
                assert counts["reduce_from_ranks"] == 2 * L + 1
                assert counts["argmax_all_gather"] == 1
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", KINDS, ids=lambda a: a.split("-")[0])
def test_one_rank_kinds_cells_are_bit_equal(tmp_path, arch):
    """On a (1, 1) mesh the other block kinds' cells (bf16, "fused") go
    through their split code at size 1 and equal the plain ones bit for
    bit (`_one_rank_cells`); a decode step issues its model collectives:
    recurrentgemma's RG-LRU layers one gates_reduce_scatter a gate, and
    every arch one argmax_all_gather."""
    mesh = _one_rank_mesh(tmp_path)
    try:
        cfg = tget(arch)
        counts = _one_rank_cells(cfg, mesh)
        assert counts["argmax_all_gather"] == 1
        rglru = tsteps.layer_kinds(cfg).count("rglru")
        assert counts["gates_reduce_scatter"] == 2 * rglru
        assert counts["reduce_from_ranks"] > 0
    finally:
        dist.destroy_process_group()


def test_one_rank_xlstm_tponly_cells_are_bit_equal(tmp_path):
    """xlstm under the tponly rules on a (1, 1) mesh: its cells (bf16,
    "fused") go through the mLSTM / sLSTM split at size 1 and equal the
    plain ones bit for bit (`_one_rank_cells`); a decode step gathers
    each layer's w_up or w_in columns once (inner_all_gather), sums the
    mLSTM's five head products (gates_reduce_scatter) and no collective
    runs a step of the sLSTM's scan."""
    mesh = _one_rank_mesh(tmp_path)
    try:
        cfg = _cfg(XLSTM, XLSTM_TP)
        counts = _one_rank_cells(cfg, mesh)
        kinds = tsteps.layer_kinds(cfg)
        assert counts["inner_all_gather"] == cfg.n_layers
        assert counts["gates_reduce_scatter"] == 5 * kinds.count("mlstm")
        assert counts["reduce_from_ranks"] == cfg.n_layers + 1
        assert counts["argmax_all_gather"] == 1
    finally:
        dist.destroy_process_group()


def test_one_rank_collectives_skip_the_backend(tmp_path, monkeypatch):
    """On a group of one rank every collective is answered without the
    backend (each backend entry point raises here) and still counted
    with its bytes: a sum or max is the tensor's own values, a gather or
    reduce-scatter a new contiguous copy; with gradients off
    `copy_to_ranks` is the tensor itself and `reduce_from_ranks` a copy;
    with gradients on both keep their autograd Functions (the gradient
    flows through unchanged)."""
    mesh = _one_rank_mesh(tmp_path)
    try:
        group = mesh.get_group("model")

        def refuse(*a, **k):
            raise AssertionError("a one-rank collective called the backend")

        for name in ("all_reduce", "all_gather_into_tensor",
                     "reduce_scatter_tensor"):
            monkeypatch.setattr(dist, name, refuse)
        monkeypatch.setattr(collectives, "_GATHER", refuse)
        monkeypatch.setattr(collectives, "_SCATTER", refuse)
        t = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
        collectives.reset_counts()
        summed = collectives.all_reduce(t, group)
        assert summed is t
        gathered = collectives.all_gather_dim(t.transpose(0, 2), 1, group,
                                              name="heads_all_gather")
        assert torch.equal(gathered, t.transpose(0, 2))
        assert gathered.is_contiguous()
        assert gathered.data_ptr() != t.data_ptr()
        scattered = collectives.reduce_scatter_dim(t, 0, group)
        assert torch.equal(scattered, t) and scattered.data_ptr() != \
            t.data_ptr()
        top = collectives.max_over_ranks(t, group, name="lse_max")
        assert torch.equal(top, t) and top.data_ptr() != t.data_ptr()
        index = collectives.argmax_over_ranks(
            torch.tensor([0.5, 2.0]), torch.tensor([7, 3]), group)
        assert index.tolist() == [7, 3]
        with torch.inference_mode():
            assert collectives.copy_to_ranks(t, group) is t
            part = collectives.reduce_from_ranks(t, group)
            assert torch.equal(part, t) and part.data_ptr() != t.data_ptr()
        x = t.clone().requires_grad_()
        y = collectives.reduce_from_ranks(
            collectives.copy_to_ranks(x, group), group)
        assert y.grad_fn is not None
        y.sum().backward()
        assert torch.equal(x.grad, torch.ones_like(t))
        counts = collectives.counts()
        nbytes = t.numel() * 4
        assert counts["all_reduce"] == 1
        assert counts["all_reduce_bytes"] == nbytes
        assert counts["heads_all_gather_bytes"] == nbytes
        assert counts["reduce_scatter_bytes"] == nbytes
        assert counts["lse_max"] == 1
        assert counts["argmax_all_gather"] == 1
        assert counts["reduce_from_ranks"] == 2
        assert counts["copy_to_ranks"] == 1         # the backward's
    finally:
        dist.destroy_process_group()


def _specs(tree):
    """The specs of a tree of `addressing.Sharding`s (None kept)."""
    return pytree.tree_map(lambda s: None if s is None else s.spec, tree,
                           is_leaf=lambda x: isinstance(
                               x, addressing.Sharding))


def test_build_cell_train_kind_and_shapes(tmp_path):
    """`build_cell`'s train kind is `make_sharded_train_step`: its
    arguments' local shapes are those of the state `init_train_state
    (shards=)` draws and of the batch, donating the state; the decode
    cells' arguments hold this rank's shapes of the parameters, the
    cache and the slot state. With `fsdp_gather` (the per-layer gather)
    the train cell has the same arguments, placements and donation, and
    its two steps (bf16, "fused") equal the whole-tree cell's bit for bit,
    losses and state; a decode cell's arguments, placements, donation
    and tokens are the same with the flag as without it."""
    mesh = _one_rank_mesh(tmp_path)
    try:
        cfg = tget(DENSE)
        rules = addressing.default_rules(mesh)
        train = ShapeConfig("t", 16, 4, "train")
        fn, args, in_sh, out_sh, donate = cells.build_cell(
            cfg, train, mesh, rules)
        assert donate == (0,) and fn.axis is not None
        state = tsteps.init_train_state(cfg, 0, device="cpu", max_seq=16,
                                        shards=fn.shards)
        pytree.tree_map(lambda spec, t: None if (
            tuple(t.shape) == spec.shape and t.dtype == spec.dtype)
            else pytest.fail(f"{spec} != {t.shape}"), args[0], state)
        assert args[1]["tokens"].shape == (4, 16)
        assert in_sh[1]["tokens"].spec == ("data",)
        fn, args, in_sh, _, donate = cells.build_cell(
            cfg, ShapeConfig("t", 16, 4, "decode"), mesh, rules,
            session=True, paged=True, page_size=4)
        assert donate == (1,)
        assert args[1]["pages"].shape == (4, 5)
        assert args[1]["cache"]["k"].shape[1] == 4 * 5 + 1
        assert in_sh[1]["cache"]["k"].spec == (None, None, None, "model")
        same = cells.build_cell(cfg, ShapeConfig("t", 16, 4, "decode"),
                                mesh, rules, session=True, paged=True,
                                page_size=4, fsdp_gather=True)
        assert same[1] == args and same[4] == donate
        assert _specs(same[2]) == _specs(in_sh)

        whole = cells.build_cell(cfg, train, mesh, rules, policy="fused")
        layered = cells.build_cell(cfg, train, mesh, rules, policy="fused",
                                   fsdp_gather=True)
        assert layered[1] == whole[1] and layered[4] == whole[4] == (0,)
        assert _specs(layered[2]) == _specs(whole[2])
        assert _specs(layered[3]) == _specs(whole[3])
        a, b = (tsteps.init_train_state(cfg, 0, device="cpu", max_seq=16,
                                        shards=c[0].shards)
                for c in (whole, layered))
        rng = np.random.default_rng(5)
        for _ in range(2):
            batch = {k: torch.from_numpy(rng.integers(
                0, cfg.vocab, (4, 16)).astype(np.int32))
                for k in ("tokens", "labels")}
            a, ma = whole[0](a, batch)
            b, mb = layered[0](b, batch)
            assert {k: float(v) for k, v in ma.items()} == \
                {k: float(v) for k, v in mb.items()}
        pytree.tree_map_with_path(
            lambda path, x, y: None if torch.equal(x, y)
            else pytest.fail(f"{pytree.keystr(path)} differs"), a, b)

        decode = ShapeConfig("t", 16, tr.SERVE_B, "decode")
        inputs = tr.serve_inputs(cfg, 16)
        params = tsteps.init_params(cfg, 0, device="cpu", max_seq=16)
        clen = tsteps.decode_cache_len(cfg, 16)
        toks = []
        for flag in (False, True):
            cell = cells.build_cell(cfg, decode, mesh, rules, policy="fused",
                                    fsdp_gather=flag)
            cache = tsteps.init_cache(cfg, tr.SERVE_B, clen, device="cpu",
                                      shards=cell[0].cache_shards)
            _, tok = cell[0](params, cache, {
                "tokens": inputs["decode"][:, :1], "pos": inputs["starts"]})
            toks.append((tok, cell[1], _specs(cell[2]), cell[4]))
        assert torch.equal(toks[0][0], toks[1][0])
        assert toks[0][1:] == toks[1][1:]
    finally:
        dist.destroy_process_group()


def _bf16_state(cache, inputs, pps):
    """`torch_ranks.serve_state` keeping the cache's own (bf16) dtype."""
    state = tr.serve_state(cache, inputs, pages_per_slot=pps)
    state["cache"] = cache
    return state


DATA_ONLY = [(a + "-smoke", (2,)) for a in ALL_ARCHS] + [
    (a, (2, 1)) for a in KINDS]


@pytest.mark.parametrize("arch,mesh", DATA_ONLY,
                         ids=[f"{a.split('-')[0]}-{'x'.join(map(str, m))}"
                              for a, m in DATA_ONLY])
def test_data_only_mesh_runs_every_arch(runs, arch, mesh):
    """On ("data",) of 2 (no model axis) every arch's sharded prefill and
    decode, and on (2, 1) (a model axis of 1) those of the other block
    kinds (their splits at size 1), give the one-process tokens on each
    rank's rows (its logits within 1e-5)."""
    res = [r[DATA_ONLY.index((arch, mesh))] for r in runs["data"]]
    one = _one_process(arch, (), 24, cells=False)
    for r in res:
        rows = slice(*r["rows"])
        assert r["rows"][1] - r["rows"][0] == tr.SERVE_B // 2
        assert torch.equal(r["prefill"], one["prefill"][rows])
        for t in range(tr.DECODE_STEPS):
            assert torch.equal(r["decode"][t], one["decode"][t][rows]), t
            assert _rel(r["decode_logits"][t],
                        one["decode_logits"][t][rows]) < TOL, t


MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_plan_equals_the_references(arch, mesh):
    """`abstract_cache` (and, where the arch pages, `abstract_paged_cache`)
    of decode_32k planned on a production mesh: each of the port's
    stacked leaves takes the reference's spec of every layer group it
    stacks (`sub{i}` with the layers dim, `rem{i}` without)."""
    sizes, names = MESHES[mesh]
    tcfg, jcfg = tget(arch), jget(arch)
    shape = SHAPES["decode_32k"]
    B, clen = shape.global_batch, tsteps.decode_cache_len(
        tcfg, shape.seq_len)
    jm, tm = AbstractMesh(sizes, names), MeshSpec(sizes, names)
    jr = jaddr.default_rules(jm, overrides=jcfg.rules_overrides)
    trl = addressing.default_rules(tm, overrides=tcfg.rules_overrides)
    pattern, n_super, remainder = tsteps.block_plan(tcfg)
    pairs = [(tsteps.abstract_cache(tcfg, B, clen),
              jsteps.abstract_cache(jcfg, B, clen))]
    try:
        pps = -((shape.seq_len + 1) // -16)
        pairs.append((tsteps.abstract_paged_cache(
            tcfg, B, clen, n_pages=B * pps + 1, page_size=16),
            jsteps.abstract_paged_cache(jcfg, B, clen, n_pages=B * pps + 1,
                                        page_size=16)))
    except ValueError:
        assert not any(tsteps.paged_cache_mask(tcfg, B, clen).values())
    for (t_sds, t_log), (j_sds, j_log) in pairs:
        j_spec = jaddr.spec_tree(j_sds, j_log, jm, jr)
        seen = 0
        for prefix, kind, _ in tsteps.cache_groups(tcfg):
            for leaf in tsteps.BLOCKS[kind]["cache"](tcfg, 1, 1):
                key = prefix + leaf
                got = trl.spec_for(t_log[key], t_sds[key].shape, tm)
                for i, k in enumerate(pattern):
                    if k == kind:
                        assert got == tuple(j_spec["blocks"][f"sub{i}"][leaf]
                                            ), (key, i)
                        seen += 1
                for i, k in enumerate(remainder):
                    if k == kind:
                        assert got[1:] == tuple(j_spec["rem"][f"rem{i}"][
                            leaf]), (key, i)
                        seen += 1
        assert seen == len(pytree.tree_leaves(
            j_spec, is_leaf=lambda x: isinstance(x, tuple)))
