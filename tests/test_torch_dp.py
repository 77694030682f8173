"""repro_torch's data-parallel train step against its one-process step
and the reference's, in spawned gloo ranks on the CPU
(`tests/torch_ranks.py`: a `FileStore` under `tmp_path`, one thread a
rank, every spawn joined against its own deadline and killed past it).

* 2- and 4-rank sharded steps on qwen3-14b-smoke (f32, 3 steps, a global
  batch of 8 x 16, each rank its rows), at grad_accum 1 and 2, and on
  mixtral-8x7b-smoke at grad_accum 1 and 2 (MoE: the dispatch's capacity,
  slot places and load-balance loss span every rank's tokens): losses,
  grad norms and the whole state after the steps equal the port's
  one-process step and the reference's jitted step with the same
  grad_accum on the same global batch. Each rank's shards have the plan's
  shard shapes; a step issues one all_gather and one reduce_scatter a
  split parameter and one all_reduce a replicated one, plus the norm's
  and the metrics', and an MoE step its dispatch's and (grad_accum 2) its
  exchange of rows.
* `TrainProgram` on a (2, 1) mesh: a run preempted after step 2 (SIGTERM
  to every rank) writes whole leaves once; resumed at 4 ranks and at 1
  it logs the uninterrupted 2-rank run's losses for steps 3-4.
* whisper-small-smoke and recurrentgemma-9b-smoke on a (2, 1) mesh:
  their plan names "model" at size 1 on their heads, d_ff and lru
  dims, and the step computes those splits at size 1 (whole there); the first batch's gradients (every leaf),
  the losses, grad norms and the state after the steps equal the port's
  one-process step.
* The per-layer gather (`make_sharded_train_step(fsdp_gather=True)`,
  `FSDP`) in the same worlds: at grad_accum 1 the state, metrics and
  shard shapes bit-equal to the whole-tree step's (f32, and bf16 from
  the port's bf16 draw, which catches a gradient rounded to bf16); at
  grad_accum 2 within 1e-5 relative L2 a leaf (the microbatches' means
  summed in another order); against the one-process step and the
  reference's at the tolerances below. A step gathers each split block
  leaf once a pass of each microbatch (twice under remat "nothing") and
  reduce-scatters it once a microbatch; no `torch.autograd.grad` call
  returns a gradient of such a leaf. With no process group: on both
  production meshes each layer's leaves after the per-layer gather have
  the shapes of the reference's `cells.layer_gather_specs`.
* `api.train(mesh=...)` at 2 ranks, `launch/train.py` under a torchrun
  environment at 2 ranks, and `--data-axis 1` in this process (its own
  one-rank group): bit-equal to the plain run there; a model axis above
  1 raises where the plan splits a leaf the step does not compute
  (xlstm under rules that split its heads and keep its inner width
  whole).

Tolerances: f32 losses, grad norms and lr scales within 1e-5 relative
(mixtral's later steps against the reference 5e-5: `MOE_LATER`); the
whole state within 1e-5 relative L2 (mixtral's against the reference
5e-5) (sum order alone moves it: the
ranks reduce in another order than one process accumulates). bf16 runs
(the programs, the API and the launcher, whose parameters are bf16):
losses within 2e-3 relative across world sizes, equal within one.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

import torch_parity
import torch_ranks
from repro.configs import get as jget
from repro.models import steps as jsteps
from repro_torch import api as tapi
from repro_torch import weights
from repro_torch.cluster import Cluster, TrainProgram
from repro_torch.configs import ARCHS, get as tget
from repro_torch.core import addressing
from repro_torch.core.addressing import MeshSpec
from repro_torch.launch import train as cli
from repro_torch.models import steps as tsteps

DENSE, MOE = "qwen3-14b-smoke", "mixtral-8x7b-smoke"
SCHED = {"warmup": 1, "total": 10}
B, S, N_STEPS = 8, 16, 3
# (ranks, arch, grad_accum a rank)
CASES = [(2, DENSE, 1), (2, DENSE, 2), (2, MOE, 1), (2, MOE, 2),
         (4, DENSE, 1)]
# (ranks, arch, grad_accum a rank, dtype) of the per-layer gather's
# steps; "bf16" starts from the port's bf16 draw and has a whole-tree
# step from that draw beside it in its world
FSDP = [(2, DENSE, 1, "f32"), (2, DENSE, 2, "f32"), (2, MOE, 1, "f32"),
        (2, MOE, 2, "f32"), (2, DENSE, 1, "bf16"), (4, DENSE, 1, "f32"),
        (4, MOE, 2, "f32")]
# mixtral against the reference after step 1: AdamW's first update
# moves each element by about lr x sign(g), and the router's near-zero
# gradients take either sign in the two packages' sum orders, so the
# second step's gradient norm parts by ~1.1e-5 and the first moments by
# 1.8e-5 relative L2 after three steps (the port's one-process step parts
# from the reference's by as much)
MOE_LATER = 5e-5
# archs with block kinds outside the model axis's, on a data-only mesh
OTHER = ("whisper-small-smoke", "recurrentgemma-9b-smoke")
# their grad norms after step 1 against the one-process step: the first
# step's gradients agree within 1e-7, but AdamW's first update moves
# each element by about lr x sign(g), and the zero-initialised biases'
# and norm scales' near-zero gradients take either sign in the two sum
# orders, so the norm parts by up to 1.7e-6 at step 2 and 7.8e-5 (whisper)
# / 1.6e-5 (recurrentgemma) at step 3, and the first moments after three
# steps by 7.6e-5 / 3.1e-5 relative L2, while every loss agrees within
# 1e-7 and the parameters within 1e-5
OTHER_LATER = 2e-4
PROG = dict(num_steps=4, batch=8, seq=16, warmup=1, log_every=1,
            checkpoint_every=2)
CLI = ["--device", "cpu", "--arch", "qwen3-14b", "--smoke", "--steps", "3",
       "--batch", "4", "--seq", "16", "--no-resume"]


def _batches():
    rng = np.random.default_rng(40)
    return [{k: torch.from_numpy(rng.integers(0, 256, (B, S)).astype(
        np.int32)) for k in ("tokens", "labels")} for _ in range(N_STEPS)]


def _arch_batches(arch):
    """`_batches()`, with an encoder-decoder's stub frame embeddings."""
    cfg = tget(arch)
    if cfg.family != "encdec":
        return _batches()
    rng = np.random.default_rng(41)
    return [b | {"enc_embeds": torch.from_numpy(rng.standard_normal(
        (B, cfg.enc_seq, cfg.d_model)).astype(np.float32))}
        for b in _batches()]


_INIT = {}


def _initial(arch):
    """The initial train state of `arch` (the port's seeded draw in f32,
    zero moments) for the reference and a fresh port copy of it (the
    port's step updates it in place)."""
    if arch not in _INIT:
        drawn = tsteps.init_params(tget(arch), 0, device="cpu", max_seq=S)
        params = torch_parity.reference_tree(tget(arch), drawn)
        zeros = jax.tree.map(np.zeros_like, params)
        host = {"params": params, "opt": {"m": zeros, "v": zeros,
                                          "step": np.zeros((), np.int32)}}
        _INIT[arch] = jax.tree.map(jnp.asarray, host), host
    js, host = _INIT[arch]
    return js, weights.from_jax_train_state(host, device="cpu")


def _case_id(case):
    ranks, arch, ga = case
    return f"{ranks}-{arch.split('-')[0]}-accum{ga}"


def _other_jobs(tmp):
    """The 2-rank jobs of `OTHER` (last in the 2-rank world)."""
    jobs = []
    for arch in OTHER:
        torch.save(_initial(arch)[1], tmp / f"{arch}-state.pt")
        torch.save(_arch_batches(arch), tmp / f"{arch}-batches.pt")
        jobs.append(("sharded_steps", dict(
            arch=arch, grad_accum=1, state=str(tmp / f"{arch}-state.pt"),
            batches=str(tmp / f"{arch}-batches.pt"),
            schedule_kwargs=SCHED)))
    return jobs


def _jobs(tmp, ranks):
    jobs = []
    for case in [c for c in CASES if c[0] == ranks]:
        _, arch, ga = case
        state = tmp / f"{arch}-state.pt"
        if not state.exists():
            torch.save(_initial(arch)[1], state)
        jobs.append(("sharded_steps", dict(
            arch=arch, grad_accum=ga, state=str(state),
            batches=str(tmp / "batches.pt"), schedule_kwargs=SCHED)))
    return jobs


def _fsdp_id(case):
    ranks, arch, ga, dtype = case
    return f"{ranks}-{arch.split('-')[0]}-accum{ga}-{dtype}"


def _fsdp_jobs(tmp, ranks):
    """{(case, fsdp_gather): position among them} and the jobs of the
    `FSDP` cases of a world (a bf16 case also its whole-tree step)."""
    at, jobs = {}, []
    for case in [c for c in FSDP if c[0] == ranks]:
        _, arch, ga, dtype = case
        state = tmp / f"{arch}-{dtype}-state.pt"
        if not state.exists():
            torch.save(_initial(arch)[1] if dtype == "f32" else
                       tsteps.init_train_state(tget(arch), 0, device="cpu",
                                               max_seq=S), state)
        for fsdp in (True, False) if dtype == "bf16" else (True,):
            at[(case, fsdp)] = len(jobs)
            jobs.append(("sharded_steps", dict(
                arch=arch, grad_accum=ga, state=str(state),
                batches=str(tmp / "batches.pt"), schedule_kwargs=SCHED,
                fsdp_gather=fsdp)))
    return at, jobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawned run of this module, the three worlds at once (2 and
    4 gloo ranks, and 2 launcher processes): {2: rank results, 4: ...,
    "cli": ..., "resumed_1": the 1-rank resume, run in this process}. The
    4-rank resume waits for the 2-rank run's copy of its checkpoint."""
    tmp = tmp_path_factory.mktemp("dp")
    torch.save(_batches(), tmp / "batches.pt")
    cut = str(tmp / "cut")
    two = [
        ("program", dict(arch=DENSE, checkpoint_dir=cut, preempt_after=2,
                         copies=(cut + "4", cut + "1"), **PROG)),
        ("program", dict(arch=DENSE, checkpoint_dir=str(tmp / "whole"),
                         **PROG)),
        ("api_train", dict(checkpoint_dir=str(tmp / "api"), num_steps=2,
                           batch=4, seq=16)),
        ("model_axis", {"overrides": (("ffn", None),)})] + _jobs(tmp, 2)
    four = _jobs(tmp, 4)
    at = {}
    for world in (two, four):
        ranks = 2 if world is two else 4
        index, jobs = _fsdp_jobs(tmp, ranks)
        at |= {key: len(world) + i for key, i in index.items()}
        world += jobs
    two += _other_jobs(tmp)
    four += [("program", dict(arch=DENSE, checkpoint_dir=cut + "4",
                              resume=True, wait_for=cut + "4.done", **PROG))]
    worlds = {2: torch_ranks.start_ranks(two, 2, tmp / "two"),
              4: torch_ranks.start_ranks(four, 4, tmp / "four"),
              "cli": torch_ranks.start_ranks(
                  [("cli", dict(port=torch_ranks.free_port(), argv=CLI + [
                      "--checkpoint-dir", str(tmp / "cli2")]))], 2,
                  tmp / "cli", group=False)}
    out = {k: w.wait() for k, w in worlds.items()}
    out["resumed_1"] = torch_ranks.in_process(
        [("program", dict(arch=DENSE, checkpoint_dir=cut + "1", resume=True,
                          **PROG))], tmp / "one")[0]
    out["cut"] = tmp / "cut"
    out["at"] = at
    return out


def _result(runs, case):
    ranks, arch, ga = case
    index = [c for c in CASES if c[0] == ranks].index(case)
    first = 4 if ranks == 2 else 0           # the 2-rank world's 4 others
    return [r[first + index] for r in runs[ranks]]


_ONE = {}


def _one_process(arch, ga, ref: bool):
    """(metrics of each step, final state) of the port's step (`ref`
    False) or the reference's jitted step (`FAST_COMPILE`) on the whole
    batches."""
    key = (arch, ga, ref)
    if key not in _ONE:
        js, ts = _initial(arch)
        kw = {"schedule_kwargs": SCHED, "policy": "fused"}
        rows = []
        if ref:
            jbs = [{k: jnp.asarray(v.numpy()) for k, v in b.items()}
                   for b in _batches()]
            step = jax.jit(jsteps.make_train_step(
                dataclasses.replace(jget(arch), grad_accum=ga), **kw)).lower(
                    js, jbs[0]).compile(
                        compiler_options=torch_parity.FAST_COMPILE)
            for jb in jbs:
                js, m = step(js, jb)
                rows.append({k: float(v) for k, v in m.items()})
            state = weights.from_jax_train_state(
                jax.tree.map(lambda a: np.asarray(a, np.float32), js),
                device="cpu")
        else:
            step = tsteps.make_train_step(
                dataclasses.replace(tget(arch), grad_accum=ga), **kw)
            for b in _arch_batches(arch):
                ts, m = step(ts, b)
                rows.append({k: float(v) for k, v in m.items()})
            state = ts
        _ONE[key] = rows, state
    return _ONE[key]


def _close_states(got, want, tol=1e-5, moments=None):
    """The whole state within `tol` relative L2 a part (the moments
    within `moments` when given)."""
    for part in ("params", "m", "v"):
        g = got["params"] if part == "params" else got["opt"][part]
        w = want["params"] if part == "params" else want["opt"][part]
        num = sum(pytree.tree_leaves(pytree.tree_map(
            lambda a, b: float(((a.float() - b.float()) ** 2).sum()), g, w)))
        den = sum(float((b.float() ** 2).sum())
                  for b in pytree.tree_leaves(w))
        lim = tol if part == "params" or moments is None else moments
        assert (num / den) ** 0.5 < lim, (part, (num / den) ** 0.5)
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == N_STEPS


def _close_metrics(got, want, keys, later=1e-5):
    """Step 1 within 1e-5; later steps within `later`."""
    for i, (g, w) in enumerate(zip(got, want)):
        tol = 1e-5 if i == 0 else later
        for k in keys:
            assert abs(g[k] - w[k]) <= tol * max(abs(w[k]), 1.0), (k, g, w)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sharded_steps_equal_one_process_and_reference(runs, case):
    ranks, arch, ga = case
    res = _result(runs, case)
    for r in res[1:]:                        # every rank logs the mean
        assert r["metrics"] == res[0]["metrics"]
    got = res[0]
    keys = ["loss", "grad_norm", "lr_scale"] + (["ce", "aux"] if ga == 1
                                                else [])
    assert sorted(got["metrics"][0]) == sorted(keys)
    for ref in (False, True):
        want, state = _one_process(arch, ga, ref)
        _close_metrics(got["metrics"], want, keys,
                       later=MOE_LATER if ref and arch == MOE else 1e-5)
        _close_states(got["state"], state,
                      MOE_LATER if ref and arch == MOE else 1e-5)
    if arch == MOE and ga == 1:
        assert all(m["aux"] > 0 for m in got["metrics"])


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_each_ranks_shards_have_the_plans_shapes(runs, case):
    """Every rank's parameter and moment shards have the shard shape of
    the leaf's spec in the plan of a (ranks, 1) mesh; split leaves are
    split over the data axis, the step count is whole."""
    ranks, arch, ga = case
    cfg = tget(arch)
    mesh = MeshSpec((ranks, 1), ("data", "model"))
    rules = addressing.default_rules(mesh, overrides=cfg.rules_overrides)
    specs = tsteps.param_partition(cfg, mesh, rules, max_seq=S)
    whole = _initial(arch)[1]["params"]
    want = pytree.tree_map(
        lambda spec, t: addressing.shard_shape(spec, t.shape, mesh),
        specs, whole, is_leaf=lambda x: isinstance(x, tuple))
    n_split = 0
    for r in _result(runs, case):
        shapes = r["shapes"]
        assert shapes["params"] == shapes["opt"]["m"] == \
            shapes["opt"]["v"] == want
        assert shapes["opt"]["step"] == ()
        n_split = sum(a != tuple(t.shape) for a, t in zip(
            pytree.tree_leaves(want, is_leaf=lambda x: isinstance(
                x, tuple)), pytree.tree_leaves(whole)))
    assert n_split > 0


def _split(spec) -> bool:
    return any("data" in addressing.spec_axes(spec, d)
               for d in range(len(spec)))


@pytest.mark.parametrize("case", CASES[:1] + CASES[2:], ids=_case_id)
def test_a_step_issues_its_collectives(runs, case):
    """One all_gather and one reduce_scatter a split parameter (each
    counting the whole leaf's f32 bytes here), one all_reduce a
    replicated one, and two more: the norm's sums and the metrics. An
    MoE layer's dispatch gathers its counts in each forward pass of each
    microbatch (the layer's own and backward's recompute) and sums its
    load-balance terms then and once in backward; with grad_accum 2 the
    ranks first exchange the batch's two arrays."""
    ranks, arch, ga = case
    cfg = tget(arch)
    mesh = MeshSpec((ranks, 1), ("data", "model"))
    specs = tsteps.param_partition(cfg, mesh, addressing.default_rules(
        mesh, overrides=cfg.rules_overrides), max_seq=S)
    whole = _initial(arch)[1]["params"]
    split = pytree.tree_leaves(pytree.tree_map(
        lambda spec, t: 4 * t.numel() if _split(spec) else 0, specs, whole,
        is_leaf=lambda x: isinstance(x, tuple)))
    counts = _result(runs, case)[0]["counts"]
    n = sum(b > 0 for b in split)
    assert counts["all_gather"] == counts["reduce_scatter"] == n > 0
    assert counts["all_reduce"] == len(split) - n + 2
    assert counts["all_gather_bytes"] == counts["reduce_scatter_bytes"] \
        == sum(split)
    moe = sum(k == "attn_moe" for k in tsteps.layer_kinds(cfg))
    passes = 2 if cfg.remat == "nothing" else 1
    assert counts.get("dispatch_all_gather", 0) == ga * moe * passes
    assert counts.get("dispatch_all_reduce", 0) == ga * moe * (passes + 1)
    assert counts.get("batch_all_gather", 0) == (2 if arch == MOE and ga > 1
                                          else 0)


@pytest.mark.parametrize("arch", OTHER, ids=lambda a: a.split("-")[0])
def test_other_kinds_train_on_a_data_only_mesh(runs, arch):
    """A (2, 1) step of whisper or recurrentgemma equals the port's
    one-process step: the plan names "model" at size 1, and the step's
    splits over it are whole."""
    res = [r[len(r) - len(OTHER) + OTHER.index(arch)] for r in runs[2]]
    assert res[0]["metrics"] == res[1]["metrics"]
    want, state = _one_process(arch, 1, False)
    _close_metrics(res[0]["metrics"], want, ["loss", "lr_scale", "ce", "aux"])
    _close_metrics(res[0]["metrics"], want, ["grad_norm"], later=OTHER_LATER)
    _close_states(res[0]["state"], state, moments=OTHER_LATER)
    _, _, grads = tsteps.make_train_step(
        tget(arch), schedule_kwargs=SCHED, policy="fused").accumulate(
            _initial(arch)[1]["params"], _arch_batches(arch)[0])
    got = {pytree.keystr(p): t for p, t in
           pytree.tree_flatten_with_path(res[0]["whole_grads"])[0]}
    for path, g in pytree.tree_flatten_with_path(grads)[0]:
        d = got[pytree.keystr(path)] - g
        assert float(d.norm()) <= 1e-5 * float(g.norm()), pytree.keystr(path)
    assert {r["coords"]["data"] for r in res} == {0, 1}


def test_checkpoint_at_two_ranks_resumes_at_one_and_four(runs):
    """Steps 3-4 of a run preempted at step 2 on 2 ranks, resumed on 4
    and on 1, log the uninterrupted 2-rank run's losses; the checkpoint
    holds whole leaves (the unsharded state's shapes), written once."""
    cut, whole = runs[2][0][:2]
    assert whole["final_step"] == 4 and not whole["preempted"]
    assert cut["final_step"] == 2 and cut["preempted"]
    assert sorted(whole["losses"]) == [1, 2, 3, 4]
    assert {k: whole["losses"][k] for k in (1, 2)} == cut["losses"]
    for r in runs[2]:
        assert r[1]["losses"] == whole["losses"]
    resumed = [runs[4][0][-1], runs["resumed_1"]]
    for rep in resumed:
        assert rep["final_step"] == 4 and sorted(rep["losses"]) == [3, 4]
        for k in (3, 4):
            assert abs(rep["losses"][k] - whole["losses"][k]) <= \
                2e-3 * whole["losses"][k], (k, rep["losses"])
    manifest = json.loads((runs["cut"] / "step-000000002" /
                           "manifest.json").read_text())
    plain = tsteps.init_train_state(tget(DENSE), 0, device="cpu",
                                    max_seq=16)
    from repro_torch.checkpoint.manager import _items
    assert {k: tuple(v["shape"]) for k, v in
            manifest["leaves"].items()} == {
                k: tuple(np.shape(v)) for k, v in _items(plain)}
    # the 1-rank resume holds whole leaves too
    assert runs["resumed_1"]["shapes"] == [
        tuple(t.shape) for t in pytree.tree_leaves(plain["params"])]


def test_api_train_and_launcher_on_a_mesh(runs, tmp_path, capsys):
    """api.train(mesh=) at 2 ranks keeps the one-process report's keys
    and losses; the launcher under a torchrun environment at 2 ranks
    runs; `--data-axis 1` in one process (its own one-rank group) logs
    the plain run's losses bit for bit."""
    plain = tapi.train("qwen3-14b", num_steps=2, batch=4, seq=16,
                       device="cpu", checkpoint_dir=str(tmp_path / "api"))
    for r in runs[2]:
        got = r[2]
        assert got["keys"] == sorted(plain)
        assert got["final_step"] == 2
        for a, b in zip(got["losses"], [m["loss"] for m in
                                        plain["metrics"]]):
            assert abs(a - b) <= 2e-3 * b
    argv = CLI
    two = runs["cli"]
    alone = cli.main(argv + ["--checkpoint-dir", str(tmp_path / "plain")])
    one = cli.main(argv + ["--checkpoint-dir", str(tmp_path / "one"),
                           "--data-axis", "1"])
    assert not dist.is_initialized()          # the launcher's group ended
    want = [m["loss"] for m in alone["metrics"]]
    assert [m["loss"] for m in one["metrics"]] == want
    for r in two:
        assert r[0]["final_step"] == 3
        for a, b in zip(r[0]["losses"], want):
            assert abs(a - b) <= 2e-3 * b
    assert "final step 3" in capsys.readouterr().out


def test_a_model_axis_above_one_raises(runs):
    """A model axis above 1 raises where the plan splits a leaf the
    sharded step does not compute (xlstm's mlstm leaves under rules that
    split its heads and keep its inner width whole, which replace its
    own), naming the leaf and the ROADMAP entry; every arch trains on
    such meshes under its own rules, xlstm under the dry run's tponly
    rules too (`tests/test_torch_tp.py`)."""
    item = "Splits over 'model' the port does not compute"
    for r in runs[2]:
        assert item in r[3] and "mlstm" in r[3]
    cluster = Cluster(dataclasses.replace(
        tget("xlstm-125m-smoke"), rules_overrides=(("ffn", None),)),
        MeshSpec((1, 2), ("data", "model")), device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        cluster.compile(TrainProgram(num_steps=1))
    with pytest.raises(RuntimeError, match="no process group"):
        Cluster(DENSE, MeshSpec((1, 1), ("data", "model")),
                device="cpu").compile(TrainProgram(num_steps=1))


def _fsdp_result(runs, case, fsdp=True):
    return [r[runs["at"][(case, fsdp)]] for r in runs[case[0]]]


def _whole_tree(runs, case):
    """The whole-tree step's rank results beside an `FSDP` case (same
    world, arch, grad_accum and draw), or None."""
    ranks, arch, ga, dtype = case
    if dtype == "bf16":
        return _fsdp_result(runs, case, fsdp=False)
    return _result(runs, case[:3]) if case[:3] in CASES else None


def _rel_l2(a, b) -> float:
    """Relative L2 distance of `a` from `b` (0 for equal tensors)."""
    a, b = a.double(), b.double()
    return 0.0 if torch.equal(a, b) else float((a - b).norm() / b.norm())


def _equal_trees(got, want, what):
    pytree.tree_map_with_path(
        lambda path, a, b: None if torch.equal(a, b)
        else pytest.fail(f"{what}: {pytree.keystr(path)} differs"),
        got, want)


@pytest.mark.parametrize("case", FSDP, ids=_fsdp_id)
def test_fsdp_steps_equal_the_whole_tree_step(runs, case):
    """The per-layer gather's step against the whole-tree step from the
    same state in the same world: every rank's blocks of the state after
    three steps and the metrics bit-equal at grad_accum 1 (f32 and bf16),
    within 1e-5 (metrics relative, each state leaf relative L2) at
    grad_accum 2; the shard shapes equal. f32 cases also against the
    one-process step and the reference's, as the whole-tree step is."""
    ranks, arch, ga, dtype = case
    res = _fsdp_result(runs, case)
    for r in res[1:]:                        # every rank logs the mean
        assert r["metrics"] == res[0]["metrics"]
    keys = ["loss", "grad_norm", "lr_scale"] + (["ce", "aux"] if ga == 1
                                                else [])
    assert sorted(res[0]["metrics"][0]) == sorted(keys)
    whole = _whole_tree(runs, case)
    assert whole is not None or (ranks, ga) == (4, 2)
    for r, w in zip(res, whole or ()):
        assert r["shapes"] == w["shapes"] and r["coords"] == w["coords"]
        if ga == 1:
            assert r["metrics"] == w["metrics"]
            _equal_trees(r["local"], w["local"], _fsdp_id(case))
            continue
        _close_metrics(r["metrics"], w["metrics"], keys)
        pytree.tree_map_with_path(
            lambda path, a, b: None if _rel_l2(a, b) <= 1e-5
            else pytest.fail(f"{pytree.keystr(path)}: {_rel_l2(a, b)}"),
            r["local"], w["local"])
    if dtype == "f32":
        for ref in (False, True):
            want, state = _one_process(arch, ga, ref)
            later = MOE_LATER if ref and arch == MOE else 1e-5
            _close_metrics(res[0]["metrics"], want, keys, later=later)
            _close_states(res[0]["state"], state, later)


def _fsdp_leaves(arch, dtype, ranks):
    """(key path, spec, whole initial leaf) of each parameter of an
    `FSDP` case's state on a (ranks, 1) mesh."""
    cfg = tget(arch)
    mesh = MeshSpec((ranks, 1), ("data", "model"))
    specs = tsteps.param_partition(cfg, mesh, addressing.default_rules(
        mesh, overrides=cfg.rules_overrides), max_seq=S)
    params = (_initial(arch)[1] if dtype == "f32" else
              tsteps.init_train_state(cfg, 0, device="cpu",
                                      max_seq=S))["params"]
    by_key = {tsteps._path_key(path): spec for path, spec in
              pytree.tree_flatten_with_path(
                  specs, is_leaf=lambda x: isinstance(x, tuple))[0]}
    return [(tsteps._path_key(path), by_key[tsteps._path_key(path)], t)
            for path, t in pytree.tree_flatten_with_path(params)[0]]


@pytest.mark.parametrize("case", FSDP, ids=_fsdp_id)
def test_fsdp_step_issues_its_collectives(runs, case):
    """A step of the per-layer gather: each block leaf split over the
    data axis all-gathered once a pass of each microbatch (twice: the
    layer and its recompute under remat "nothing", in the leaf's dtype)
    and reduce-scattered once a microbatch (f32); the other split leaves
    once a step each, as the whole-tree step does; one all_reduce a
    replicated leaf, the norm's and the metrics'; the MoE dispatch's and
    the row exchange as before. Each `torch.autograd.grad` call (one a
    microbatch) returns the gradients of the other leaves whole and of
    the token, none of a split block leaf (the whole-tree step's return
    every leaf's)."""
    ranks, arch, ga, dtype = case
    cfg = tget(arch)
    leaves = _fsdp_leaves(arch, dtype, ranks)
    held = [k[0] == "blocks" and _split(sp) for k, sp, _ in leaves]
    other = [not h and _split(sp) for h, (_, sp, _) in zip(held, leaves)]
    nbytes = lambda mask, size=None: sum(
        t.numel() * (size or t.element_size())
        for m, (_, _, t) in zip(mask, leaves) if m)
    passes = 2 if cfg.remat == "nothing" else 1
    res = _fsdp_result(runs, case)
    counts = res[0]["counts"]
    assert sum(held) > 0
    assert counts["all_gather"] == ga * passes * sum(held) + sum(other)
    assert counts["reduce_scatter"] == ga * sum(held) + sum(other)
    assert counts["all_reduce"] == len(leaves) - sum(held) - sum(other) + 2
    assert counts["all_gather_bytes"] == ga * passes * nbytes(held) + \
        nbytes(other)
    assert counts["reduce_scatter_bytes"] == ga * nbytes(held, 4) + \
        nbytes(other, 4)
    moe = sum(k == "attn_moe" for k in tsteps.layer_kinds(cfg))
    assert counts.get("dispatch_all_gather", 0) == ga * moe * passes
    assert counts.get("dispatch_all_reduce", 0) == ga * moe * (passes + 1)
    assert counts.get("batch_all_gather", 0) == (2 if arch == MOE and ga > 1
                                          else 0)
    free = sum(t.numel() for h, (_, _, t) in zip(held, leaves) if not h)
    for r in res:
        assert r["grad_numel"] == [free + 1] * ga
    for w in _whole_tree(runs, case) or ():
        assert w["grad_numel"] == [sum(t.numel() for *_, t in leaves)] * ga


def _batch_free(spec) -> tuple:
    """`spec` with the batch axes taken out (what the per-layer gather
    makes of a leaf)."""
    out = []
    for d in range(len(spec)):
        axes = tuple(a for a in addressing.spec_axes(spec, d)
                     if a not in addressing.BATCH_AXES)
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    return tuple(out)


PROD_MESHES = {"pod": ((16, 16), ("data", "model")),
               "multipod": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("mesh", sorted(PROD_MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_layer_gather_shapes_are_the_references_specs(arch, mesh):
    """With no process group, on a production mesh: each leaf of a layer
    in the reference's scan (its remainder layers have no gather spec),
    as the per-layer gather makes it (the plan's spec less the batch
    axes), has the model axes and the local shape of its spec in
    `cells.layer_gather_specs` (the reference's gather specs); the
    gather undoes a split of some leaf."""
    from repro_torch.cluster import cells
    cfg = tget(arch)
    m = MeshSpec(*PROD_MESHES[mesh])
    rules = addressing.default_rules(m, overrides=cfg.rules_overrides)
    specs = tsteps.param_partition(cfg, m, rules)
    keys = tsteps.param_plan_keys(cfg)
    shapes = tsteps.param_specs(cfg)
    ref = dict(tsteps.tree_paths(cells.layer_gather_specs(cfg, m, rules)))
    checked = undone = 0
    for i, layer in enumerate(specs["blocks"]):
        flat = pytree.tree_flatten_with_path(
            layer, is_leaf=lambda x: isinstance(x, tuple))[0]
        for path, spec in flat:
            key, stacked = _at(keys["blocks"][i], path)
            if not stacked:
                continue
            shape = _at(shapes["blocks"][i], path).shape
            want = ref[key.removeprefix("blocks/")]
            got = _batch_free(spec)
            assert [addressing.spec_axes(got, d) for d in range(len(shape))] \
                == [addressing.spec_axes(want, d) for d in range(len(shape))]
            assert addressing.shard_shape(got, shape, m) == \
                addressing.shard_shape(want, shape, m), key
            checked += 1
            undone += got != spec
    assert checked > 0 and undone > 0


def _at(tree, path):
    for k in path:
        tree = tree[getattr(k, "key", getattr(k, "idx", k))]
    return tree
