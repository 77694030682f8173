"""repro_torch's tensor-parallel train step (the model axis) against its
one-process step and the reference's single-device step, in spawned gloo
ranks on the CPU (`tests/torch_ranks.py`: a `FileStore` under the
module's temporary directory, one thread a rank, every world joined
against its own deadline and killed past it).

* Sharded steps on (1, 2), (2, 2), (1, 4) ("data", "model") meshes and
  one (2, 1, 2) ("pod", "data", "model") mesh, from one f32 state on
  three global batches of 8 x 16, each rank its rows: qwen3-14b-smoke at
  grad_accum 1 and 2; qwen1.5-32b-smoke (the qkv biases split with their
  heads); mixtral-8x7b-smoke (the experts' d_ff split, the router whole),
  whose router gradient is equal on every model rank; qwen3 with 6 query
  and 2 KV heads at model 4 (heads the axis does not divide: whole on
  every rank, as qwen3-14b's 40 are on (16, 16)); mixtral with 8 query
  and 2 KV heads at model 4 (the query heads split, the KV heads whole,
  each rank reading the one its two query heads share, as mixtral-8x7b
  on (16, 16)). Against the port's one-process step and the reference's
  jitted step on the global batch: every step's losses and metrics;
  each leaf of the first batch's reduced gradients, gathered whole; the
  whole state after the steps. Each rank's blocks are the plan's
  `local_block` of the whole leaves.
* The per-layer gather (`make_sharded_train_step(fsdp_gather=True)`,
  `FSDP`) in the 4-rank world on (2, 2) and (2, 1, 2): bit-equal to the
  whole-tree step at grad_accum 1, within 1e-5 relative L2 a leaf at
  grad_accum 2, and against the one-process step and the reference's
  as above; each split block leaf gathered over the batch axes once a
  pass (its split over "model" kept) and reduce-scattered once a
  microbatch, and no `torch.autograd.grad` call returning its gradient.
* At one rank (a (1, 1) mesh in this process) the step is bit-equal to
  `make_train_step` in bf16, and a forward pass issues reduce_from_ranks
  twice a layer, once for the embedding and twice a loss chunk.
* `TrainProgram` on (2, 2): a run preempted after step 2 (SIGTERM to
  every rank) resumed at (1, 4) and at (4, 1) logs the uninterrupted
  run's losses for steps 3-4; the checkpoint holds whole leaves.
* `launch/train.py` under a torchrun environment: `--data-axis 1` over
  2 ranks (a (1, 2) mesh) and `--data-axis 2` over 4 (a (2, 2) mesh).
* The other block kinds (`KINDS`): whisper-small-smoke (enc_attn and
  attn_cross: the encoder's and the decoder's heads and gelu MLPs, the
  cross-attention's KV heads of the encoder output), xlstm-125m-smoke
  (under its own rules only the vocabulary splits: its mLSTM and sLSTM
  blocks run whole on every model rank), recurrentgemma-9b-smoke (the
  RG-LRU's channels, local_attn's heads, the geglu MLP) and
  llama-3.2-vision-90b-smoke (its cross blocks' heads, KV heads of the
  image embeddings and gated MLP; the gates opened,
  `torch_parity.open_gates`) on (1, 2), (2, 2), (1, 4) and (2, 1, 2),
  and whisper with 6 query and 6 KV heads at model 4 (a mixed plan: the
  heads whole, d_ff split), with the encoder's stub frames or the image
  embeddings in each batch, against the one-process step and the
  reference's as above. The leaf-by-leaf gradient test holds the two
  places a split may drop a share of a gradient: the encoder output,
  which every rank's split cross-attention reads (its gradient summed
  over the model ranks before the encoder's backward), and the RG-LRU's
  input u through its two gate products, split on their input channels
  (every channel's gradient gathered back to each rank).
* On a (1, 1) mesh the four archs' sharded steps are bit-equal to
  `make_train_step` in bf16.
* xlstm under the dry run's tponly rules (`default_rules(mesh,
  overrides=(("embed", None),))`), which split its mLSTM / sLSTM leaves
  over "model" (`XLSTM_TP`: the inner width, w_up's and w_in's columns,
  the cells' heads), on the four meshes, and with 2 heads of 32 at model
  4 (`XLSTM_TP_WHOLE`: the cells' heads whole, the inner width split),
  against the one-process step and the reference's as xlstm under its
  own rules, with two departures. Its first-step gradients and grad
  norm are held within twice their noise floor where that is above 1e-5
  (`_grad_floor`: the largest move of the one-process gradient under a
  1e-7 relative move of every parameter): a split sums the mLSTM's
  products in another order, and its f32 gradients are that sensitive.
  The input gate biases' (`b_i`) move by up to 4.4e-3 relative so (a
  head output row whose terms cancel), 8.9e-2 with 2 heads; the other
  leaves' by up to ~4e-5, and the split parts from the one-process step
  by up to 1.6e-5 there (tok_embed at model 4). And
  its later steps are held by their losses, not their grad norms: after
  AdamW's first update (lr x sign(g) on those near-zero gradients) the
  grad norms part by up to 2.5e-3, and the moments after three steps by
  up to 2.5e-4 as a whole tree (held within `XLSTM_NORM_LATER`). At (1, 1) the tponly step is bit-equal
  to `make_train_step` in bf16. Rules that split xlstm's heads and keep
  its inner width whole (q / k / v split on their heads), a split the
  step does not compute, raise NotImplementedError naming the leaf and
  the ROADMAP entry, on a MeshSpec, through `Cluster.compile` and in the
  2-rank world.

The initial weights are the port's seeded draw with the attention
weights rescaled to their true fan-in (`torch_parity.true_fan_in`):
without it the random scores are so large that the one-process step
and the reference's part by 2e-5 a leaf before any sharding.

Tolerances (f32): losses, grad norms and lr scales within 1e-5 relative
(mixtral's later steps against the reference 5e-5: `MOE_LATER`, as in
`tests/test_torch_dp.py`); every gradient leaf within 1e-5 relative L2;
every leaf of the state after three steps within 1e-5 relative L2
(mixtral's against the reference 5e-5), and each of params, m and v as
a whole. The other block kinds' states are held as
`tests/test_torch_dp.py` holds them on a data-only mesh (`KINDS_LATER`):
their gradients agree leaf by leaf within 1e-5, but AdamW's first
updates move each element by about lr x sign(g), and their many
zero-initialised biases and norm scales (xlstm's sLSTM bias b, the
RG-LRU's gate biases, the norms' offsets) have near-zero gradient
elements that take either sign in two sum orders; their later grad
norms and moments are held within 2e-4 and the parameters within 1e-5
as a whole tree. xlstm (`XLSTM`) is held to the reference at the first
step only (its loss and grad norm within 1e-5) and by its loss at every
step, and to the one-process step in full: its f32 gradients part from
the reference's by up to 1.0e-4 a leaf at this batch (the input gate's
bias; `tests/test_torch_grads.py` pins the cause, a head output row whose
terms cancel, and holds the two packages within 7e-5 at its own batch),
and AdamW's first update then moves its step-3 grad norm 1.1% from the
reference's in the one-process step as much as in the sharded one; its
later grad norms part from the one-process step's by up to 2.3e-4 and
are held within 1e-3 (`XLSTM_NORM_LATER`). Vision's two f32 gate
scalars (`GATES`) take their gradient as one sum over every element of
the block's output, whose terms cancel: the one-process step's is
3.8e-6 from the reference's and the sharded step's within 1e-5 of the
one-process step's, so against the reference they are held within the
sum of the two, 2e-5. One leaf is held in the whole tree only: qwen1.5's key biases
`bk`, zero at init, whose gradient cancels over the positions (up to
RoPE, a constant key shift leaves softmax as it is); AdamW moves each
of their elements by about lr x sign(g), so after three steps they part
by up to 5e-3 relative between any two sum orders, the one-process
step's and the reference's too, while their gradients and moments agree
within 1e-6. bf16 runs (the programs and the launcher): losses within
2e-3 relative across meshes.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import dataclasses
import json
from pathlib import Path

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
from repro_torch import weights
from repro_torch.configs import get as tget
from repro_torch.core import addressing, collectives
from repro_torch.core.addressing import MeshSpec
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.models import steps as tsteps

ROOT = Path(__file__).resolve().parents[1]
DENSE, BIAS, MOE = "qwen3-14b-smoke", "qwen1.5-32b-smoke", "mixtral-8x7b-smoke"
WHOLE_HEADS = (("n_heads", 6), ("n_kv_heads", 2))   # at model 4
KV_WHOLE = (("n_heads", 8), ("n_kv_heads", 2))      # at model 4
SCHED = {"warmup": 1, "total": 10}
B, S, N_STEPS = 8, 16, 3
MOE_LATER = 5e-5
# (mesh sizes, arch, grad_accum, config changes); a 3-axis mesh is over
# ("pod", "data", "model")
CASES = [((1, 2), DENSE, 1, ()), ((1, 2), DENSE, 2, ()),
         ((1, 2), BIAS, 1, ()), ((1, 2), MOE, 1, ()),
         ((2, 2), DENSE, 1, ()), ((2, 2), MOE, 2, ()),
         ((1, 4), DENSE, 1, ()), ((1, 4), DENSE, 1, WHOLE_HEADS),
         ((1, 4), MOE, 1, KV_WHOLE), ((2, 1, 2), DENSE, 1, ())]
# the per-layer gather's steps (fields as in CASES), in the 4-rank world
FSDP = [((2, 2), DENSE, 1, ()), ((2, 2), MOE, 2, ()),
        ((2, 1, 2), DENSE, 1, ()), ((2, 1, 2), MOE, 2, ())]
WHISPER, XLSTM, RGEMMA, VISION = (
    "whisper-small-smoke", "xlstm-125m-smoke", "recurrentgemma-9b-smoke",
    "llama-3.2-vision-90b-smoke")
KINDS = (WHISPER, XLSTM, RGEMMA, VISION)
MIXED = (("n_heads", 6), ("n_kv_heads", 6))          # at model 4
CASES += [(sizes, arch, 1, ()) for arch in KINDS
          for sizes in ((1, 2), (2, 2), (1, 4), (2, 1, 2))]
CASES += [((1, 4), WHISPER, 1, MIXED)]
# the dry run's tponly rules, which replace xlstm's own and split its
# mLSTM / sLSTM leaves over "model"; and with 2 heads of 32 at model 4
# (the cells' heads whole, their inner width split)
TPONLY = (("embed", None),)
XLSTM_TP = (("rules_overrides", TPONLY),)
XLSTM_TP_WHOLE = XLSTM_TP + (("n_heads", 2), ("n_kv_heads", 2),
                             ("head_dim", 32))
CASES += [(sizes, XLSTM, 1, XLSTM_TP)
          for sizes in ((1, 2), (2, 2), (1, 4), (2, 1, 2))]
CASES += [((1, 4), XLSTM, 1, XLSTM_TP_WHOLE)]
# rules that split xlstm's heads and keep its inner width whole: a split
# the step does not compute
HEADS_ONLY = (("ffn", None),)
# the other kinds' later grad norms and moments (see the docstring);
# xlstm's later grad norms against the one-process step
KINDS_LATER = 2e-4
XLSTM_NORM_LATER = 1e-3
# vision's tanh gates against the reference's (see the docstring)
GATES = {"gate_attn": 2e-5, "gate_ffn": 2e-5}
PROG = dict(num_steps=4, batch=8, seq=16, warmup=1, log_every=1,
            checkpoint_every=2)
CLI = ["--device", "cpu", "--arch", "qwen3-14b", "--smoke", "--steps", "3",
       "--batch", "4", "--seq", "16", "--no-resume"]


def _names(sizes):
    return ("pod", "data", "model") if len(sizes) == 3 else ("data", "model")


def _case_id(case):
    sizes, arch, ga, change = case
    tail = "".join("-tponly" if k == "rules_overrides" else f"-{k[2:]}{v}"
                   for k, v in change)
    return f"{'x'.join(map(str, sizes))}-{arch.split('-')[0]}-accum{ga}{tail}"


def _plain(change) -> tuple:
    """`change` less the rules (which one process does not read)."""
    return tuple((k, v) for k, v in change if k != "rules_overrides")


def _tponly(case) -> bool:
    return any(k == "rules_overrides" for k, _ in case[3])


def _cfgs(arch, ga, change):
    change = dict(change)
    return (dataclasses.replace(tget(arch), grad_accum=ga, **change),
            dataclasses.replace(jget(arch), grad_accum=ga, **change))


def _batches(arch=DENSE):
    """Three seeded global batches; an encoder-decoder's carry its stub
    frame embeddings, a vision model's its image embeddings."""
    rng = np.random.default_rng(40)
    out = [{k: torch.from_numpy(rng.integers(0, 256, (B, S)).astype(
        np.int32)) for k in ("tokens", "labels")} for _ in range(N_STEPS)]
    cfg = tget(arch)
    n, key = ((cfg.enc_seq, "enc_embeds") if cfg.family == "encdec" else
              (cfg.n_img_tokens, "img_embeds") if cfg.family == "vlm"
              else (0, None))
    if n:
        rng = np.random.default_rng(41)
        out = [b | {key: torch.from_numpy((0.5 * rng.standard_normal(
            (B, n, cfg.d_model))).astype(np.float32))} for b in out]
    return out


_INIT = {}


def _initial(arch, change):
    """The initial f32 train state of `arch` with `change` (the port's
    seeded draw, the attention weights rescaled to their true fan-in
    (`torch_parity.true_fan_in`), zero moments) for the reference and a
    fresh port copy of it (the port's step updates it in place)."""
    change = _plain(change)
    key = (arch, change)
    if key not in _INIT:
        cfg = _cfgs(arch, 1, change)[0]
        drawn = tsteps.init_params(cfg, 0, device="cpu", max_seq=S)
        params = torch_parity.open_gates(torch_parity.true_fan_in(
            torch_parity.reference_tree(cfg, drawn)))
        zeros = jax.tree.map(np.zeros_like, params)
        host = {"params": params, "opt": {"m": zeros, "v": zeros,
                                          "step": np.zeros((), np.int32)}}
        _INIT[key] = jax.tree.map(jnp.asarray, host), host
    js, host = _INIT[key]
    return js, weights.from_jax_train_state(host, device="cpu")


def _grad_keys(arch):
    """The router's key paths (the leaves whose gradient is checked on
    every rank)."""
    cfg = tget(arch)
    return [f"['blocks'][{i}]['moe']['router']"
            for i in range(cfg.n_layers)] if arch == MOE else []


def _step_jobs(tmp, world, cases=CASES, fsdp_gather=False):
    jobs = []
    for case in [c for c in cases if np.prod(c[0]) == world]:
        sizes, arch, ga, change = case
        state = tmp / f"{_case_id(case)}-state.pt"
        torch.save(_initial(arch, change)[1], state)
        batches = tmp / f"batches-{arch}.pt"
        if not batches.exists():
            torch.save(_batches(arch), batches)
        jobs.append(("sharded_steps", dict(
            arch=arch, grad_accum=ga, state=str(state),
            batches=str(batches), schedule_kwargs=SCHED,
            mesh=sizes, names=_names(sizes), replace=dict(change) or None,
            grads_of=_grad_keys(arch), fsdp_gather=fsdp_gather)))
    return jobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawned world of this module, started together: 2 gloo ranks
    (the (1, 2) steps, then xlstm's step built under the tponly rules and
    its error under rules splitting its heads alone), 4 gloo
    ranks (the 4-rank steps, then the (2, 2) programs and their resumes
    at (1, 4) and (4, 1)), and the launcher at 2 and at 4 ranks (no
    group before it)."""
    tmp = tmp_path_factory.mktemp("tp")
    cut = str(tmp / "cut")
    two = _step_jobs(tmp, 2) + [
        ("model_axis", dict(arch=XLSTM, overrides=TPONLY)),
        ("model_axis", dict(arch=XLSTM, overrides=HEADS_ONLY))]
    four = _step_jobs(tmp, 4) + [
        ("program", dict(arch=DENSE, checkpoint_dir=cut, preempt_after=2,
                         copies=(cut + "14", cut + "41"), mesh=(2, 2),
                         **PROG)),
        ("program", dict(arch=DENSE, checkpoint_dir=str(tmp / "whole"),
                         mesh=(2, 2), **PROG)),
        ("program", dict(arch=DENSE, checkpoint_dir=cut + "14", resume=True,
                         mesh=(1, 4), **PROG)),
        ("program", dict(arch=DENSE, checkpoint_dir=cut + "41", resume=True,
                         mesh=(4, 1), **PROG))] + _step_jobs(
                             tmp, 4, FSDP, fsdp_gather=True)
    cli = lambda world, data: torch_ranks.start_ranks(
        [("cli", dict(port=torch_ranks.free_port(), argv=CLI + [
            "--data-axis", str(data), "--checkpoint-dir",
            str(tmp / f"cli{world}")]))], world, tmp / f"cli{world}-ranks",
        group=False, timeout=240)
    worlds = {2: torch_ranks.start_ranks(two, 2, tmp / "two", timeout=240),
              4: torch_ranks.start_ranks(four, 4, tmp / "four",
                                         timeout=300),
              "cli2": cli(2, 1), "cli4": cli(4, 2)}
    out = {k: w.wait() for k, w in worlds.items()}
    out["cut"] = tmp / "cut"
    return out


def _result(runs, case):
    world = int(np.prod(case[0]))
    index = [c for c in CASES if np.prod(c[0]) == world].index(case)
    return [r[index] for r in runs[world]]


_ONE = {}


def _one_process(case, ref: bool):
    """(metrics of each step, final state, the first batch's gradients)
    of the port's one-process step (`ref` False) or the reference's
    jitted step (`FAST_COMPILE`; its gradients those of the loss on the
    whole first batch, grad_accum 1 only) on the whole batches."""
    _, arch, ga, change = case
    change = _plain(change)
    key = (arch, ga, change, ref)
    if key not in _ONE:
        tcfg, jcfg = _cfgs(arch, ga, change)
        js, ts = _initial(arch, change)
        kw = {"schedule_kwargs": SCHED, "policy": "fused"}
        rows, grads = [], None
        if ref:
            jbs = [{k: jnp.asarray(v.numpy()) for k, v in b.items()}
                   for b in _batches(arch)]
            if ga == 1:
                vg = jax.jit(jax.value_and_grad(
                    lambda p, b: jsteps.loss_fn(jcfg, p, b)[0]))
                _, g = vg.lower(js["params"], jbs[0]).compile(
                    compiler_options=torch_parity.FAST_COMPILE)(
                        js["params"], jbs[0])
                grads = weights.from_jax_params(
                    jax.tree.map(np.asarray, g), device="cpu")
            step = jax.jit(jsteps.make_train_step(jcfg, **kw)).lower(
                js, jbs[0]).compile(
                    compiler_options=torch_parity.FAST_COMPILE)
            for jb in jbs:
                js, m = step(js, jb)
                rows.append({k: float(v) for k, v in m.items()})
            state = weights.from_jax_train_state(
                jax.tree.map(lambda a: np.asarray(a, np.float32), js),
                device="cpu")
        else:
            step = tsteps.make_train_step(tcfg, **kw)
            grads = step.accumulate(ts["params"], _batches(arch)[0])[2]
            for b in _batches(arch):
                ts, m = step(ts, b)
                rows.append({k: float(v) for k, v in m.items()})
            state = ts
        _ONE[key] = rows, state, grads
    return _ONE[key]


def _close_states(got, want, tol, whole_only=False, moments=KINDS_LATER):
    """Every leaf of the state within `tol` relative L2, but the key
    biases' parameters (see the module's docstring), which count in the
    whole parameter tree's relative L2, within `tol` too. With
    `whole_only` (the other block kinds) params as a whole tree within
    `tol` and the moments within `moments`."""
    for part in ("params", "m", "v"):
        g = got["params"] if part == "params" else got["opt"][part]
        w = want["params"] if part == "params" else want["opt"][part]
        num = sum(pytree.tree_leaves(pytree.tree_map(
            lambda a, b: float(((a.float() - b.float()) ** 2).sum()), g, w)))
        den = sum(float((b.float() ** 2).sum())
                  for b in pytree.tree_leaves(w))
        lim = moments if whole_only and part != "params" else tol
        assert (num / den) ** 0.5 < lim, (part, (num / den) ** 0.5)
        if whole_only:
            continue
        if part == "params":
            g, w = ({k: v for k, v in pytree.tree_flatten_with_path(t)[0]
                     if "'bk'" not in pytree.keystr(k)} for t in (g, w))
        _close_leaves(g, w, tol)
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == N_STEPS


def _close_leaves(got, want, tol=1e-5, by_name=None):
    """Every leaf within `tol` relative L2 (a zero leaf equal to zero);
    `by_name` {leaf name: tol} for the leaves it names."""
    by_name = by_name or {}

    def one(path, a, b):
        a, b = a.double(), b.double()
        if b.norm() == 0:
            assert a.norm() == 0, pytree.keystr(path)
            return
        rel = float((a - b).norm() / b.norm())
        name = getattr(path[-1], "key", None)
        assert rel < by_name.get(name, tol), (pytree.keystr(path), rel)

    pytree.tree_map_with_path(one, got, want)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tp_steps_equal_one_process_and_reference(runs, case):
    sizes, arch, ga, _ = case
    res = _result(runs, case)
    for r in res[1:]:                        # every rank logs the mean
        assert r["metrics"] == res[0]["metrics"]
    got = res[0]
    keys = ["loss", "grad_norm", "lr_scale"] + (["ce", "aux"] if ga == 1
                                                else [])
    assert sorted(got["metrics"][0]) == sorted(keys)
    kinds = arch in KINDS
    norm_later = XLSTM_NORM_LATER if arch == XLSTM else KINDS_LATER
    for ref in (False, True):
        want, state, _ = _one_process(case, ref)
        later = MOE_LATER if ref and arch == MOE else 1e-5
        for i, (g, w) in enumerate(zip(got["metrics"], want)):
            for k in keys:
                if arch == XLSTM and i > 0 and k == "grad_norm" and (
                        ref or _tponly(case)):
                    continue                # see the module's docstring
                tol = 1e-5 if i == 0 else (
                    norm_later if kinds and k == "grad_norm" else later)
                if i == 0 and k == "grad_norm" and _tponly(case):
                    tol = max(tol, 2 * _grad_floor(case)[1])
                assert abs(g[k] - w[k]) <= tol * max(abs(w[k]), 1.0), \
                    (k, g, w)
        if not (ref and arch == XLSTM):
            _close_states(got["state"], state, later, whole_only=kinds,
                          moments=XLSTM_NORM_LATER if _tponly(case)
                          else KINDS_LATER)
    counts = got["counts"]
    assert counts["reduce_from_ranks"] > 0 and counts["copy_to_ranks"] > 0
    assert counts["max_over_ranks"] > 0


_FLOOR = {}


def _grad_floor(case) -> tuple[dict, float]:
    """The noise floor of a case's f32 first-step gradients: for each leaf
    (by key path) the largest relative L2 change of the one-process
    step's gradient of the first batch when every parameter moves by
    1e-7 relative (four seeded normal draws), and that of the gradient
    norm. xlstm's input gate biases' floors reach 1e-3 or more (a head
    output row whose terms cancel; see the module's docstring), the
    other leaves' some 1e-5."""
    _, arch, _, change = case
    change = _plain(change)
    if (arch, change) not in _FLOOR:
        step = tsteps.make_train_step(_cfgs(arch, 1, change)[0],
                                      policy="fused")
        params = _initial(arch, change)[1]["params"]
        batch = _batches(arch)[0]
        base = step.accumulate(params, batch)[2]
        norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                    for g in pytree.tree_leaves(base))))
        leaves, worst = {}, 0.0
        for seed in range(4):
            gen = torch.Generator().manual_seed(seed)
            moved = pytree.tree_map(lambda t: t * (1 + 1e-7 * torch.randn(
                t.shape, generator=gen)), params)
            got = step.accumulate(moved, batch)[2]
            for (path, a), b in zip(pytree.tree_flatten_with_path(got)[0],
                                    pytree.tree_leaves(base)):
                a, b = a.double(), b.double()
                key = pytree.keystr(path)
                leaves[key] = max(leaves.get(key, 0.0),
                                  float((a - b).norm() / b.norm()))
            n = float(torch.sqrt(sum((g.double() ** 2).sum()
                                     for g in pytree.tree_leaves(got))))
            worst = max(worst, abs(n - norm) / norm)
        _FLOOR[arch, change] = leaves, worst
    return _FLOOR[arch, change]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tp_gradients_equal_leaf_by_leaf(runs, case):
    """The first batch's gradients the step reduces (each rank's blocks,
    gathered whole) against the port's one-process gradients and (at
    grad_accum 1) the reference's, every leaf within 1e-5 relative L2;
    under the tponly rules each of xlstm's leaves within twice its noise
    floor where that is above 1e-5 (`_grad_floor`)."""
    got = _result(runs, case)[0]["whole_grads"]
    if _tponly(case):
        floor = _grad_floor(case)[0]

        def one(path, a, b):
            a, b = a.double(), b.double()
            rel = float((a - b).norm() / b.norm())
            lim = max(1e-5, 2 * floor[pytree.keystr(path)])
            assert rel < lim, (pytree.keystr(path), rel, lim)

        pytree.tree_map_with_path(one, got, _one_process(case, False)[2])
    else:
        _close_leaves(got, _one_process(case, False)[2])
    if case[2] == 1 and case[1] != XLSTM:   # see the module's docstring
        _close_leaves(got, _one_process(case, True)[2],
                      by_name=GATES if case[1] == VISION else None)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_each_ranks_blocks_are_the_plans_local_block(runs, case):
    """Every rank's parameter and moment blocks are `local_block` of the
    leaf's spec in the plan of the mesh, at the rank's coordinates, cut
    from the whole state; a leaf split over both axes (w_down) holds a
    block of each; the step count is whole."""
    sizes, arch, ga, change = case
    cfg = _cfgs(arch, ga, change)[0]
    mesh = MeshSpec(sizes, _names(sizes))
    rules = addressing.default_rules(mesh, overrides=cfg.rules_overrides)
    specs = tsteps.param_partition(cfg, mesh, rules, max_seq=S)
    res = _result(runs, case)
    whole = res[0]["state"]
    both = 0
    for r in res:
        for part in ("params", "m", "v"):
            w = whole["params"] if part == "params" else whole["opt"][part]
            local = (r["local"]["params"] if part == "params"
                     else r["local"]["opt"][part])

            def one(spec, a, b):
                block = addressing.local_block(spec, b.shape, mesh,
                                               r["coords"])
                assert tuple(a.shape) == addressing.shard_shape(
                    spec, b.shape, mesh)
                assert torch.equal(a, b[block])

            pytree.tree_map(one, specs, local, w,
                            is_leaf=lambda x: isinstance(x, tuple))
        assert r["local"]["opt"]["step"].shape == ()
        both = sum(len({a for d in range(len(sp))
                        for a in addressing.spec_axes(sp, d)}
                       & {"data", "model"}) == 2
                   for sp in pytree.tree_leaves(
                       specs, is_leaf=lambda x: isinstance(x, tuple)))
    if sizes[-2] > 1 and sizes[-1] > 1:
        # the tponly rules split no leaf over the batch axes
        assert (both > 0) != _tponly(case)


def test_router_gradient_is_equal_on_every_model_rank(runs):
    """mixtral on (1, 2) and (2, 2): the router (replicated over
    "model") gets its whole gradient on each model rank, bit for bit the
    same on the ranks of one data coordinate, and nonzero."""
    for case in [c for c in CASES if c[1] == MOE and not c[3]]:
        res = _result(runs, case)
        by_row = {}
        for r in res:
            row = tuple(v for k, v in r["coords"].items() if k != "model")
            by_row.setdefault(row, []).append(r["grads"])
        for grads in by_row.values():
            assert len(grads) == case[0][-1]
            for key in _grad_keys(MOE):
                assert grads[0][key].abs().max() > 0
                for g in grads[1:]:
                    assert torch.equal(g[key], grads[0][key]), key


def test_one_rank_step_is_bit_equal_and_counts_its_model_collectives(
        tmp_path):
    """On a (1, 1) mesh (a one-rank gloo group of this process) the
    sharded step goes through the model axis's code (every leaf it may
    split named by the plan, at size 1) and equals `make_train_step` bit
    for bit in bf16, losses and every leaf, dense and MoE; a forward pass
    of qwen3 issues reduce_from_ranks twice a layer, once for the
    embedding and twice a loss chunk (the sums of exp and the label's
    logit), and max_over_ranks once a chunk."""
    kw = {"schedule_kwargs": {"warmup": 1, "total": 4}, "policy": "fused"}
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_device_mesh(MeshSpec((1, 1), ("data", "model")), "cpu")
        for arch, ga in ((DENSE, 2), (MOE, 1)):
            cfg = dataclasses.replace(tget(arch), grad_accum=ga)
            plain = tsteps.make_train_step(cfg, **kw)
            a = tsteps.init_train_state(cfg, 0, device="cpu", max_seq=S)
            step = tsteps.make_sharded_train_step(cfg, mesh, max_seq=S, **kw)
            assert step.axis.heads == slice(0, cfg.n_heads)
            assert step.axis.vocab == slice(0, cfg.vocab)
            s = tsteps.init_train_state(cfg, 0, device="cpu", max_seq=S,
                                        shards=step.shards)
            for b in _batches()[:2]:
                a, ma = plain(a, b)
                s, ms = step(s, b)
                assert float(ms["loss"]) == float(ma["loss"])
            pytree.tree_map_with_path(
                lambda path, x, y: None if torch.equal(x, y)
                else pytest.fail(f"{arch}: {pytree.keystr(path)} differs"),
                s, a)
        cfg = tget(DENSE)
        step = tsteps.make_sharded_train_step(cfg, mesh, max_seq=S, **kw)
        s = tsteps.init_train_state(cfg, 0, device="cpu", max_seq=S,
                                    shards=step.shards)
        collectives.reset_counts()
        with torch.no_grad():
            tsteps.loss_fn(cfg, s["params"], _batches()[0], axis=step.axis)
        counts = collectives.counts()
        assert counts["reduce_from_ranks"] == 2 * cfg.n_layers + 1 + 2
        assert counts["max_over_ranks"] == 1
        assert counts["copy_to_ranks"] == 0     # a backward collective
    finally:
        dist.destroy_process_group()


def test_checkpoint_at_2x2_resumes_at_1x4_and_4x1(runs):
    """Steps 3-4 of a (2, 2) run preempted at step 2, resumed on (1, 4)
    and on (4, 1), log the uninterrupted (2, 2) run's losses (bf16,
    within 2e-3); the checkpoint holds whole leaves, written once; every
    rank of a run logs the same losses."""
    res = runs[4]
    first = len([c for c in CASES if np.prod(c[0]) == 4])
    cut, whole, at14, at41 = (res[0][first + i] for i in range(4))
    assert whole["final_step"] == 4 and not whole["preempted"]
    assert cut["final_step"] == 2 and cut["preempted"]
    assert sorted(whole["losses"]) == [1, 2, 3, 4]
    assert {k: whole["losses"][k] for k in (1, 2)} == cut["losses"]
    for r in res:
        for i in range(4):
            assert r[first + i]["losses"] == res[0][first + i]["losses"]
    for rep in (at14, at41):
        assert rep["final_step"] == 4 and sorted(rep["losses"]) == [3, 4]
        for k in (3, 4):
            assert abs(rep["losses"][k] - whole["losses"][k]) <= \
                2e-3 * whole["losses"][k], (k, rep["losses"])
    manifest = json.loads((runs["cut"] / "step-000000002" /
                           "manifest.json").read_text())
    plain = tsteps.init_train_state(tget(DENSE), 0, device="cpu", max_seq=S)
    from repro_torch.checkpoint.manager import _items
    assert {k: tuple(v["shape"]) for k, v in
            manifest["leaves"].items()} == {
                k: tuple(np.shape(v)) for k, v in _items(plain)}
    # a (1, 4) rank holds a quarter of the vocabulary's rows
    assert (64, 64) in at14["shapes"] and (256, 64) not in at14["shapes"]


def test_launcher_trains_on_1x2_and_2x2(runs, tmp_path):
    """`launch/train.py` under a torchrun environment: `--data-axis 1`
    over 2 ranks and `--data-axis 2` over 4 run 3 steps, every rank
    logging the single-process run's losses within 2e-3 (bf16)."""
    from repro_torch.launch import train as cli
    plain = cli.main(CLI + ["--checkpoint-dir", str(tmp_path / "plain")])
    want = [m["loss"] for m in plain["metrics"]]
    for world in ("cli2", "cli4"):
        for r in runs[world]:
            assert r[0]["final_step"] == 3
            for a, b in zip(r[0]["losses"], want):
                assert abs(a - b) <= 2e-3 * b


def _one_rank_step_bit_equal(tmp_path, arch, cfg):
    """`cfg` (of `arch`)'s sharded step on a (1, 1) mesh against
    `make_train_step`, bf16 ("fused"): losses and every leaf after two
    steps bit-equal. -> the step's `ModelAxis`."""
    kw = {"schedule_kwargs": {"warmup": 1, "total": 4}, "policy": "fused"}
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_device_mesh(MeshSpec((1, 1), ("data", "model")), "cpu")
        plain = tsteps.make_train_step(cfg, **kw)
        a = tsteps.init_train_state(cfg, 0, device="cpu", max_seq=S)
        step = tsteps.make_sharded_train_step(cfg, mesh, max_seq=S, **kw)
        s = tsteps.init_train_state(cfg, 0, device="cpu", max_seq=S,
                                    shards=step.shards)
        for b in _batches(arch)[:2]:
            b = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                 for k, v in b.items()}
            a, ma = plain(a, b)
            s, ms = step(s, b)
            assert float(ms["loss"]) == float(ma["loss"])
        pytree.tree_map_with_path(
            lambda path, x, y: None if torch.equal(x, y)
            else pytest.fail(f"{arch}: {pytree.keystr(path)} differs"),
            s, a)
        return step.axis
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", KINDS, ids=lambda a: a.split("-")[0])
def test_one_rank_kinds_step_is_bit_equal(tmp_path, arch):
    """On a (1, 1) mesh the other block kinds' sharded steps go through
    their split code at size 1 (the heads, d_ff, lru width and
    vocabulary the plan names) and equal `make_train_step` bit for bit in
    bf16 ("fused"), losses and every leaf after two steps."""
    cfg = tget(arch)
    axis = _one_rank_step_bit_equal(tmp_path, arch, cfg)
    assert axis.vocab == slice(0, cfg.vocab)
    if arch == XLSTM:       # its own rules keep its block leaves whole
        assert axis.heads is None and not axis.ffn
        assert axis.inner is None and axis.cell_heads is None
    else:
        assert axis.heads == slice(0, cfg.n_heads)
        assert axis.ffn
    assert (axis.lru is not None) == (arch == RGEMMA)


def test_one_rank_xlstm_tponly_step_is_bit_equal(tmp_path):
    """xlstm under the tponly rules on a (1, 1) mesh: its mLSTM / sLSTM
    blocks go through the split code at size 1 (the inner width, w_up's
    and w_in's columns gathered, the cells' heads) and the step equals
    `make_train_step` bit for bit in bf16."""
    cfg = dataclasses.replace(tget(XLSTM), rules_overrides=TPONLY)
    axis = _one_rank_step_bit_equal(tmp_path, XLSTM, cfg)
    di = cfg.n_heads * cfg.hd
    assert axis.inner == slice(0, di)
    assert axis.cell_heads == slice(0, cfg.n_heads)
    assert axis.heads is None and axis.lru is None


def test_xlstm_under_tponly_rules_raises_naming_the_item(runs):
    """The dry run's tponly rules replace xlstm's own and split its mLSTM
    / sLSTM leaves over "model" (w_up's 2 di columns straddling gate and
    main, w_in's 4 di the four gates, the q / k / v / gate rows on the
    inner width, the cells' heads where the model size divides them):
    the step computes that split, planned on a MeshSpec ((1, 2), (2, 4),
    (16, 16)) and built in the 2-rank world. Rules that split xlstm's
    heads and keep its inner width whole (q / k / v split on their heads)
    are a split it does not compute: it raises NotImplementedError naming
    the leaf and the ROADMAP entry, planned on a MeshSpec, compiled as a
    `TrainProgram` (before any process group) and built in the 2-rank
    world. Under xlstm's own rules the same meshes admit it."""
    from repro_torch.cluster import Cluster, TrainProgram
    item = "Splits over 'model' the port does not compute"
    assert item in (ROOT / "ROADMAP.md").read_text()
    cfg = tget(XLSTM)
    for sizes in ((1, 2), (2, 4), (16, 16)):
        mesh = MeshSpec(sizes, ("data", "model"))
        assert tsteps.check_mesh(cfg, mesh, addressing.default_rules(
            mesh, overrides=TPONLY)) == sizes
        assert tsteps.check_mesh(cfg, mesh) == sizes
    for sizes in ((1, 2), (2, 4)):
        mesh = MeshSpec(sizes, ("data", "model"))
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 3") \
                as e:
            tsteps.check_mesh(cfg, mesh, addressing.default_rules(
                mesh, overrides=HEADS_ONLY))
        assert item in str(e.value) and "mlstm" in str(e.value)
        assert "wq" in str(e.value) and "dim 1" in str(e.value)
    with pytest.raises(NotImplementedError, match=item):
        Cluster(dataclasses.replace(cfg, rules_overrides=HEADS_ONLY),
                MeshSpec((1, 2), ("data", "model")),
                device="cpu").compile(TrainProgram(num_steps=1))
    at = len([c for c in CASES if np.prod(c[0]) == 2])
    built, msg = runs[2][0][at], runs[2][0][at + 1]
    assert built is None
    assert msg is not None and "ROADMAP Queue 3" in msg and item in msg


def _fsdp_result(runs, case):
    """Each rank's results of an `FSDP` case (after the 4-rank world's
    step cases and its four programs)."""
    first = len([c for c in CASES if np.prod(c[0]) == 4]) + 4
    return [r[first + FSDP.index(case)] for r in runs[4]]


@pytest.mark.parametrize("case", FSDP, ids=_case_id)
def test_tp_fsdp_steps_equal_the_whole_tree_step(runs, case):
    """The per-layer gather's step on a mesh with a model axis against
    the whole-tree step from the same state in the same world (where it
    runs that case): every rank's blocks and the metrics bit-equal at
    grad_accum 1, each leaf within 1e-5 relative L2 at grad_accum 2;
    against the one-process step and the reference's as the whole-tree
    step is."""
    sizes, arch, ga, _ = case
    res = _fsdp_result(runs, case)
    for r in res[1:]:
        assert r["metrics"] == res[0]["metrics"]
    if case in CASES:
        for r, w in zip(res, _result(runs, case)):
            assert r["shapes"] == w["shapes"] and r["coords"] == w["coords"]
            if ga == 1:
                assert r["metrics"] == w["metrics"]
                pytree.tree_map_with_path(
                    lambda path, a, b: None if torch.equal(a, b)
                    else pytest.fail(f"{pytree.keystr(path)} differs"),
                    r["local"], w["local"])
            else:
                _close_leaves(r["local"]["params"], w["local"]["params"])
                _close_leaves(r["local"]["opt"]["m"], w["local"]["opt"]["m"])
                _close_leaves(r["local"]["opt"]["v"], w["local"]["opt"]["v"])
    keys = ["loss", "grad_norm", "lr_scale"] + (["ce", "aux"] if ga == 1
                                                else [])
    for ref in (False, True):
        want, state, _ = _one_process(case, ref)
        later = MOE_LATER if ref and arch == MOE else 1e-5
        for i, (g, w) in enumerate(zip(res[0]["metrics"], want)):
            for k in keys:
                tol = 1e-5 if i == 0 else later
                assert abs(g[k] - w[k]) <= tol * max(abs(w[k]), 1.0), \
                    (k, g, w)
        _close_states(res[0]["state"], state, later)


@pytest.mark.parametrize("case", FSDP, ids=_case_id)
def test_tp_fsdp_step_issues_its_collectives(runs, case):
    """On (2, 2) and (2, 1, 2): each block leaf split over the batch axes
    all-gathered over them once a pass of each microbatch (the layer and
    its recompute) and reduce-scattered once a microbatch, the other
    split leaves once a step, an all_reduce a leaf the batch axes do not
    split, the norm's and the metrics'; each `torch.autograd.grad` call
    returns the other leaves' gradients (whole over the batch axes, this
    rank's block over "model") and the token's, none of a split block
    leaf."""
    sizes, arch, ga, change = case
    cfg = _cfgs(arch, ga, change)[0]
    mesh = MeshSpec(sizes, _names(sizes))
    specs = {tsteps._path_key(p): sp for p, sp in
             pytree.tree_flatten_with_path(tsteps.param_partition(
                 cfg, mesh, addressing.default_rules(
                     mesh, overrides=cfg.rules_overrides), max_seq=S),
                 is_leaf=lambda x: isinstance(x, tuple))[0]}
    res = _fsdp_result(runs, case)
    batch_parts = int(np.prod(sizes[:-1]))
    leaves = []
    for path, shape in pytree.tree_flatten_with_path(
            res[0]["shapes"]["params"],
            is_leaf=lambda x: isinstance(x, tuple))[0]:
        key = tsteps._path_key(path)
        split = any(a in addressing.BATCH_AXES
                    for d in range(len(specs[key]))
                    for a in addressing.spec_axes(specs[key], d))
        n = int(np.prod(shape)) * (batch_parts if split else 1)
        leaves.append((key[0] == "blocks" and split, split, n))
    held = sum(h for h, _, _ in leaves)
    other = sum(s and not h for h, s, _ in leaves)
    passes = 2 if cfg.remat == "nothing" else 1
    counts = res[0]["counts"]
    assert held > 0
    assert counts["all_gather"] == ga * passes * held + other
    assert counts["reduce_scatter"] == ga * held + other
    assert counts["all_reduce"] == len(leaves) - held - other + 2
    free = sum(n for h, _, n in leaves if not h)
    for r in res:
        assert r["grad_numel"] == [free + 1] * ga
    if case in CASES:
        for w in _result(runs, case):
            assert w["grad_numel"] == [sum(n for *_, n in leaves)] * ga
