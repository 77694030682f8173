"""repro_torch's selective remat policies (cfg.remat "dots" and
"dots_no_batch", `core/remat.py`) against "nothing" and against what the
reference's checkpoint policies save, on the CPU.

* Gradients: qwen3-14b-smoke, mixtral-8x7b-smoke and xlstm-125m-smoke
  in f32 under the kernel policies "reference", "tuned" and "fused":
  every gradient leaf and the loss of `make_train_step(...).accumulate`
  under "dots" and "dots_no_batch" bit-equal to "nothing"'s. A kept
  product is read back in the recompute where "nothing" runs it again:
  the same value.
* What each layer's checkpoint keeps. The checkpoint packs each layer's
  input through the saved-tensor hooks (caught with
  `torch.autograd.graph.saved_tensors_hooks`: the same tensors under
  every policy, a (B, S, d) input a layer among them); a selective
  policy's kept products live in its checkpoint's storage, outside the
  hooks (caught by wrapping `core.remat`'s
  `create_selective_checkpoint_contexts`). Against the reference's
  `saved_residuals` of its `loss_fn` under the same policy and route
  (its residuals stacked over the scanned layers, by size a layer or a
  pattern's period of layers: xlstm's scan body is a period of four):
  the port keeps the reference's products, and the reference keeps at
  most one tensor more, the size of a layer input (the reference's scan
  keeps a layer input where no kept product rebuilds it; the port's
  checkpoint keeps every layer's input). Under "dots_no_batch" that is
  every product with no batch index (qwen3's seven weight products, the
  router "td,de->te" too; never an expert product "ecd,edf->ecf");
  under "fused" none of the fused kernels' (qwen3 keeps nothing, as
  under "nothing"). "dots" keeps those and, on the plain route, a
  non-empty set of batched products besides; qwen3's and mixtral's
  equal the reference's by size (the attention's scores and p @ v, the
  experts' three), xlstm's are
  its cells' batched products, which the reference stacks over its
  chunk and step scans where the port keeps one a chunk or a step.
* A (2, 2) gloo world: qwen3 under "dots_no_batch" with the per-layer
  gather (`fsdp_gather=True`) bit-equal to "nothing" (metrics and every
  rank's blocks after three steps), each rank's collective counts equal
  to "nothing"'s: the recompute gathers again and the gradients reduce
  as often.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import ad_checkpoint as jad_checkpoint
from torch.utils import _pytree as pytree
from torch.utils import checkpoint as tcheckpoint

import torch_ranks
from repro.cluster.policy import use_policy as juse
from repro.configs import get as jget
from repro.models import steps as jsteps
from repro_torch.cluster.policy import use_policy as tuse
from repro_torch.configs import get as tget
from repro_torch.core import remat
from repro_torch.models import steps as tsteps

ARCHS = ("qwen3-14b-smoke", "mixtral-8x7b-smoke", "xlstm-125m-smoke")
SELECTIVE = ("dots", "dots_no_batch")
B, S = 3, 16        # B differs from the smokes' layer count: see _reference


def _batch():
    rng = np.random.default_rng(3)
    return {k: torch.from_numpy(rng.integers(0, 256, (B, S)).astype(
        np.int32)) for k in ("tokens", "labels")}


_PARAMS = {}


def _params(arch):
    """The port's seeded draw of `arch`, in f32."""
    if arch not in _PARAMS:
        p = tsteps.init_params(tget(arch), 0, device="cpu", max_seq=S)
        _PARAMS[arch] = pytree.tree_map(lambda t: t.float(), p)
    return _PARAMS[arch]


@pytest.mark.parametrize("eq, nd, kind", [
    ("bsd,dhk->bshk", (3, 3), remat.UNBATCHED),
    ("td,de->te", (2, 2), remat.UNBATCHED),
    ("...d,dv->...v", (3, 2), remat.UNBATCHED),
    ("ecd,edf->ecf", (3, 3), remat.BATCHED),
    ("bqkgd,bskd->bkgqs", (5, 4), remat.BATCHED),
    ("bhd,ghde->bghe", (3, 4), remat.BATCHED),
    ("...d,...d->...", (3, 3), remat.BATCHED)])
def test_product_kind_reads_the_batch_index(eq, nd, kind):
    assert remat.product_kind(eq, *nd) == kind


@pytest.mark.parametrize("policy", SELECTIVE)
@pytest.mark.parametrize("route", ["reference", "tuned", "fused"])
@pytest.mark.parametrize("arch", ARCHS, ids=lambda a: a.split("-")[0])
def test_selective_policy_gradients_are_nothings(arch, route, policy):
    params, batch = _params(arch), _batch()
    got = {}
    for name in ("nothing", policy):
        cfg = dataclasses.replace(tget(arch), remat=name)
        got[name] = tsteps.make_train_step(cfg, policy=route).accumulate(
            params, batch)
    (l0, p0, g0), (l1, p1, g1) = got["nothing"], got[policy]
    assert torch.equal(l0, l1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    flat0, flat1 = (pytree.tree_flatten_with_path(g)[0] for g in (g0, g1))
    assert len(flat0) == len(flat1) > 0
    for (path, a), (_, b) in zip(flat0, flat1):
        assert torch.equal(a, b), pytree.keystr(path)


def _kept(arch, route, policy):
    """(shapes the saved-tensor hooks see in the forward and the loss,
    {layer: Counter of the sizes of the products its checkpoint keeps})
    of the port's forward under `policy`."""
    modes = []
    real = remat.create_selective_checkpoint_contexts

    def spy(*args, **kwargs):
        fwd, rec = real(*args, **kwargs)
        modes.append(fwd)
        return fwd, rec

    hooked = []
    cfg = dataclasses.replace(tget(arch), remat=policy)
    params = pytree.tree_map(lambda t: t.detach().requires_grad_(),
                             _params(arch))
    remat.create_selective_checkpoint_contexts = spy
    try:
        with tuse(route), torch.autograd.graph.saved_tensors_hooks(
                lambda t: hooked.append(tuple(t.shape)) or t, lambda t: t):
            tsteps.loss_fn(cfg, params, _batch())
    finally:
        remat.create_selective_checkpoint_contexts = real
    layers = {}
    for i, mode in enumerate(modes):
        layers[i] = collections.Counter(
            entry.val.numel() for per in mode.storage.values()
            for entry in per.values() if entry is not tcheckpoint._RECOMPUTE)
    return hooked, layers


_REF = {}


def _reference(arch, route, policy):
    """The sizes the reference's `loss_fn` keeps a scan step (a layer, or
    a pattern's period of layers) under `policy`: its residuals stacked
    over the scanned layers (the first dim the number of scan steps,
    which the batch of B rows does not share)."""
    key = (arch, route, policy)
    if key not in _REF:
        cfg = dataclasses.replace(jget(arch), remat=policy)
        steps = cfg.n_layers // len(cfg.pattern)
        params = jax.tree.map(lambda a: a.astype(jnp.float32),
                              jsteps.init_params(cfg, jax.random.PRNGKey(0)))
        batch = {k: jnp.asarray(v.numpy()) for k, v in _batch().items()}
        with juse(route):
            res = jad_checkpoint.saved_residuals(
                lambda p: jsteps.loss_fn(cfg, p, batch)[0], params)
        _REF[key] = collections.Counter(
            int(np.prod(aval.shape[1:])) for aval, why in res
            if "output of scan" in why and "prefetchable_scan" in why
            and aval.ndim > 1 and aval.shape[0] == steps)
    return _REF[key]


@pytest.mark.parametrize("policy", SELECTIVE)
@pytest.mark.parametrize("route", ["tuned", "fused"])
@pytest.mark.parametrize("arch", ARCHS, ids=lambda a: a.split("-")[0])
def test_checkpoint_keeps_what_the_references_policy_keeps(arch, route,
                                                           policy):
    cfg = tget(arch)
    period = len(cfg.pattern)
    layer_input = B * S * cfg.d_model
    hooked, layers = _kept(arch, route, policy)
    plain_hooked, plain = _kept(arch, route, "nothing")
    assert plain == {} and hooked == plain_hooked
    assert hooked.count((B, S, cfg.d_model)) >= cfg.n_layers
    assert sorted(layers) == list(range(cfg.n_layers))
    per_step = [sum((layers[i] for i in range(j, j + period)),
                    collections.Counter())
                for j in range(0, cfg.n_layers, period)]
    assert all(c == per_step[0] for c in per_step)
    got = per_step[0]
    unbatched = _reference(arch, route, "dots_no_batch")
    if policy == "dots_no_batch":
        want = unbatched
    else:
        _, no_batch = _kept(arch, route, "dots_no_batch")
        batched = [layers[i] - no_batch[i] for i in layers]
        assert all(layers[i] - batched[i] == no_batch[i] for i in layers)
        if route == "tuned":
            assert sum(sum(c.values()) for c in batched) > 0
        if arch.startswith("xlstm"):      # see the module's docstring
            got = sum((no_batch[i] for i in range(period)),
                      collections.Counter())
            want = unbatched
            assert sum(_reference(arch, route, "dots").values()) > \
                sum(unbatched.values())
        else:
            want = _reference(arch, route, "dots")
    assert not got - want, (got, want)
    extra = want - got
    assert not extra or extra == collections.Counter({layer_input: 1}), \
        (got, want)
    if route == "fused" and arch.startswith("qwen3"):
        assert got == collections.Counter()


def test_dots_no_batch_with_the_layer_gather_at_2x2(tmp_path):
    """qwen3 on a (2, 2) gloo world, the per-layer gather on: the step
    under "dots_no_batch" bit-equal to "nothing" on every rank, and each
    rank's collective counts of a step equal to "nothing"'s."""
    arch = "qwen3-14b-smoke"
    cfg = tget(arch)
    state = tsteps.init_train_state(cfg, 0, device="cpu", max_seq=S)
    torch.save(pytree.tree_map(
        lambda t: t.float() if t.is_floating_point() else t, state),
               tmp_path / "state.pt")
    rng = np.random.default_rng(7)
    torch.save([{k: torch.from_numpy(rng.integers(0, 256, (8, S)).astype(
        np.int32)) for k in ("tokens", "labels")} for _ in range(3)],
        tmp_path / "batches.pt")
    jobs = [("sharded_steps", dict(
        arch=arch, grad_accum=1, state=str(tmp_path / "state.pt"),
        batches=str(tmp_path / "batches.pt"),
        schedule_kwargs={"warmup": 1, "total": 10}, mesh=(2, 2),
        names=("data", "model"), replace={"remat": name}, fsdp_gather=True))
        for name in ("nothing", "dots_no_batch")]
    ranks = torch_ranks.run_ranks(jobs, 4, tmp_path / "ranks", timeout=240)
    for nothing, dots in ranks:
        assert dots["metrics"] == nothing["metrics"]
        assert dots["counts"] == nothing["counts"]
        assert dots["counts"]["all_gather"] > 0
        pytree.tree_map_with_path(
            lambda path, a, b: None if torch.equal(a, b)
            else pytest.fail(f"{pytree.keystr(path)} differs"),
            dots["local"], nothing["local"])
    assert len({r[0]["metrics"][0]["loss"] for r in ranks}) == 1
