"""repro_torch's addressing plan against the reference's, on the CPU.

* The address scrambler (`AddressMap.scramble` / `descramble` /
  `tile_of`) is bit-equal to the reference's on seeded random addresses
  and on the region's edges, for several (t, b, s).
* `Cluster(arch, mesh).plan()` equals the reference's `Cluster(arch,
  AbstractMesh(...)).plan()` on the production meshes themselves ((16, 16)
  ("data", "model") and (2, 16, 16) ("pod", "data", "model")), planned
  with no ranks, for every arch of the registry with fsdp on and off:
  the same keys, logical axes, spec, region and shape on every leaf (562
  leaves with fsdp on). Each leaf's shard shape equals the reference's
  `NamedSharding(mesh, spec).shard_shape(shape)`, every device's block
  (`local_block`) has that shape and the blocks tile the leaf, and the
  DTensor placements split exactly the spec's dims.
* `SHAPES`, `input_specs`, `cell_supported`, `batch_logical`,
  `shardings_for`, `layer_gather_specs`, `model_flops` and
  `abstract_train_state` equal the reference's; `api.plan` agrees with
  `Cluster.plan`; `make_device_mesh` needs an initialised group.

Tolerance: none (every value compared for equality). Data: seeded numpy
addresses.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import itertools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro import api as japi
from repro.cluster import cells as jcells
from repro.cluster.session import Cluster as JCluster
from repro.configs import registry as jreg
from repro.core import addressing as jaddr
from repro.models import steps as jsteps
from repro_torch import api as tapi
from repro_torch.cluster import cells as tcells
from repro_torch.cluster.session import Cluster as TCluster
from repro_torch.configs import registry as treg
from repro_torch.core import addressing as taddr
from repro_torch.launch import mesh as tmesh
from repro_torch.models import steps as tsteps

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = sorted(treg.ARCHS)


def _jmesh(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names)


def _tmesh(name):
    return tmesh.make_production_mesh(multi_pod=name == "multipod")


# ----------------------------------------------------------------------------
# The scrambler
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("tbs", [(6, 4, 4), (4, 2, 3), (2, 3, 1), (8, 5, 6)])
def test_scrambler_is_the_references_bit_for_bit(tbs):
    t, b, s = tbs
    jm = jaddr.AddressMap(tile_bits=t, bank_bits=b, seq_rows_bits=s)
    tm = taddr.AddressMap(tile_bits=t, bank_bits=b, seq_rows_bits=s)
    assert tm.seq_region_bytes == jm.seq_region_bytes
    n = tm.seq_region_bytes
    rng = np.random.default_rng(sum(tbs))
    edges = np.array([0, 1, 3, 4, n // 2, n - 4, n - 1, n, n + 1, 2 * n,
                      (1 << 40) + 7, (1 << 62) - 1], np.int64)
    addrs = np.concatenate([edges, rng.integers(0, 4 * n, 4096),
                            rng.integers(0, 1 << 62, 1024)])
    for fn in ("scramble", "descramble", "tile_of"):
        got, want = getattr(tm, fn)(addrs), getattr(jm, fn)(addrs)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tm.descramble(tm.scramble(addrs)), addrs)
    assert tm.scramble(7) == jm.scramble(7)          # scalars too


# ----------------------------------------------------------------------------
# The plan, leaf for leaf, on the production meshes
# ----------------------------------------------------------------------------

def _plans(arch, mesh, fsdp):
    jc, tc = JCluster(arch, _jmesh(mesh)), TCluster(arch, _tmesh(mesh),
                                                     device="cpu")
    if not fsdp:
        cfg = tc.arch
        jc.rules = jaddr.default_rules(jc.mesh, fsdp=False,
                                       overrides=cfg.rules_overrides)
        tc.rules = taddr.default_rules(tc.mesh, fsdp=False,
                                       overrides=cfg.rules_overrides)
    return jc, tc


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "no_fsdp"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_equals_the_references_leaf_for_leaf(arch, mesh, fsdp):
    jc, tc = _plans(arch, mesh, fsdp)
    want, got = jc.plan(), tc.plan()
    assert list(got) == sorted(want)
    sizes = dict(zip(*reversed(MESHES[mesh])))
    for key, w in want.items():
        g = got[key]
        assert g["logical"] == w["logical"], key
        assert g["spec"] == tuple(w["spec"]), (key, g["spec"], w["spec"])
        assert g["region"] == w["region"], key
        assert g["shape"] == tuple(w["shape"]), key
        block = NamedSharding(jc.mesh, P(*g["spec"])).shard_shape(g["shape"])
        assert taddr.shard_shape(g["spec"], g["shape"], tc.mesh) == block
        # the corner devices' blocks have that shape; the placements
        # split exactly the spec's dims
        for corner in itertools.product(*[(0, n - 1) for n in
                                          sizes.values()]):
            coords = dict(zip(sizes, corner))
            sl = taddr.local_block(g["spec"], g["shape"], tc.mesh, coords)
            assert tuple(s.stop - s.start for s in sl) == block
        pl = taddr.placements(g["spec"], tc.mesh)
        for ax, p in zip(sizes, pl):
            dims = [d for d in range(len(g["spec"]))
                    if ax in taddr.spec_axes(g["spec"], d)]
            assert (p.is_shard(dims[0]) if dims else p.is_replicate()), \
                (key, ax, p)


def test_spec_tree_and_plan_tree_are_the_plans_specs():
    """`spec_tree` / `plan_tree` over the parameters' shapes and logical
    axes give the plan's specs (and `Sharding`s of them) leaf for leaf."""
    tc = TCluster("whisper-small", _tmesh("multipod"), device="cpu")
    p_sds, p_log = tsteps.abstract_params(tc.arch)
    specs = dict(_tree_items(taddr.spec_tree(p_sds, p_log, tc.mesh,
                                             tc.rules)))
    shardings = dict(_tree_items(taddr.plan_tree(p_sds, p_log, tc.mesh,
                                                 tc.rules)))
    plan = tc.plan()
    assert specs == {k: v["spec"] for k, v in plan.items()}
    assert {k: (v.spec, v.shard_shape(plan[k]["shape"]))
            for k, v in shardings.items()} == {
        k: (v["spec"], taddr.shard_shape(v["spec"], v["shape"], tc.mesh))
        for k, v in plan.items()}


def test_the_production_plans_hold_562_leaves():
    total = sum(len(TCluster(a, _tmesh(m), device="cpu").plan())
                for a in ARCHS for m in MESHES)
    assert total == 562


def test_local_blocks_tile_every_leaf_of_the_test_mesh():
    """On the 8-rank test meshes every element of every qwen3-14b-smoke
    leaf lies in exactly as many devices' blocks as the spec leaves
    replicas (the product of the mesh axes it does not name)."""
    for multi in (False, True):
        mesh = tmesh.make_test_mesh(multi_pod=multi)
        sizes = taddr.mesh_axes(mesh)
        for key, leaf in TCluster("qwen3-14b-smoke", mesh,
                                  device="cpu").plan().items():
            named = {a for d in range(len(leaf["spec"]))
                     for a in taddr.spec_axes(leaf["spec"], d)}
            hits = np.zeros(leaf["shape"], np.int32)
            for corner in itertools.product(*map(range, mesh.sizes)):
                sl = taddr.local_block(leaf["spec"], leaf["shape"], mesh,
                                       dict(zip(sizes, corner)))
                hits[sl] += 1
            reps = int(np.prod([n for a, n in sizes.items()
                                if a not in named]))
            assert (hits == reps).all(), key


def test_api_plan_agrees_with_cluster_plan():
    for name in MESHES:
        got = tapi.plan("mixtral-8x7b", _tmesh(name), device="cpu")
        assert got == TCluster("mixtral-8x7b", _tmesh(name),
                               device="cpu").plan()
        want = japi.plan("mixtral-8x7b", _jmesh(name))
        assert {k: (v["spec"], v["region"]) for k, v in got.items()} == \
            {k: (tuple(v["spec"]), v["region"]) for k, v in want.items()}
    sizes, names = MESHES["pod"]
    assert tapi.plan("yi-34b", taddr.MeshSpec(sizes, names),
                     device="cpu") == tapi.plan("yi-34b", _tmesh("pod"),
                                                device="cpu")


# ----------------------------------------------------------------------------
# Workload shapes, input specs, the cells' helpers, the train state
# ----------------------------------------------------------------------------

def _tree_items(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_items(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def test_shapes_input_specs_and_cell_supported_match_reference():
    assert sorted(treg.SHAPES) == sorted(jreg.SHAPES)
    for name, shape in treg.SHAPES.items():
        assert vars(shape) == vars(jreg.SHAPES[name])
    for arch, name in itertools.product(ARCHS, sorted(treg.SHAPES)):
        tcfg, jcfg = treg.get(arch), jreg.get(arch)
        got = treg.input_specs(tcfg, treg.SHAPES[name])
        want = jreg.input_specs(jcfg, jreg.SHAPES[name])
        assert sorted(got) == sorted(want), (arch, name)
        for k in want:
            assert got[k].shape == tuple(want[k].shape), (arch, name, k)
            assert _dtype_name(got[k].dtype) == str(want[k].dtype)
        assert treg.cell_supported(tcfg, treg.SHAPES[name]) == \
            jreg.cell_supported(jcfg, jreg.SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_helpers_match_reference(arch):
    """batch_logical, shardings_for (of input_specs), layer_gather_specs
    and model_flops on the production pod mesh, and the train state's
    shapes, dtypes and logical axes."""
    tcfg, jcfg = treg.get(arch), jreg.get(arch)
    jm, tm = _jmesh("pod"), _tmesh("pod")
    jrules = jaddr.default_rules(jm, overrides=jcfg.rules_overrides)
    trules = taddr.default_rules(tm, overrides=tcfg.rules_overrides)
    for name in sorted(treg.SHAPES):
        ts, js = treg.SHAPES[name], jreg.SHAPES[name]
        assert tcells.batch_logical(tcfg, ts) == jcells.batch_logical(jcfg,
                                                                      js)
        got = tcells.shardings_for(treg.input_specs(tcfg, ts),
                                   tcells.batch_logical(tcfg, ts), tm,
                                   trules)
        want = jcells.shardings_for(jreg.input_specs(jcfg, js),
                                    jcells.batch_logical(jcfg, js), jm,
                                    jrules)
        assert {k: v.spec for k, v in got.items()} == \
            {k: tuple(v.spec) for k, v in want.items()}
        assert tcells.model_flops(tcfg, ts) == jcells.model_flops(jcfg, js)
    got = dict(_tree_items(tcells.layer_gather_specs(tcfg, tm, trules)))
    want = dict(_tree_items(jax.tree.map(
        tuple, jcells.layer_gather_specs(jcfg, jm, jrules),
        is_leaf=lambda x: isinstance(x, P))))
    assert got == want
    t_sds, t_log = tsteps.abstract_train_state(tcfg)
    j_sds, j_log = jsteps.abstract_train_state(jcfg)
    flat_j = jax.tree_util.tree_flatten_with_path(j_sds)[0]
    got = dict(_tree_items(t_sds))
    assert sorted(got) == sorted("/".join(str(k.key) for k in path)
                                 for path, _ in flat_j)
    for path, sds in flat_j:
        g = got["/".join(str(k.key) for k in path)]
        assert g.shape == tuple(sds.shape)
        assert _dtype_name(g.dtype) == str(sds.dtype)
    logical = dict(_tree_items(t_log))
    for path, log in jax.tree_util.tree_flatten_with_path(
            j_log, is_leaf=lambda x: isinstance(x, tuple))[0]:
        assert logical["/".join(str(k.key) for k in path)] == log


# ----------------------------------------------------------------------------
# Meshes
# ----------------------------------------------------------------------------

def test_meshes_and_device_mesh(tmp_path):
    """The production and test descriptions have the reference's shapes;
    `make_device_mesh` refuses without a group (and a group of another
    size) and, over a one-rank gloo group, makes a DeviceMesh the planner
    reads as it reads the description."""
    for multi in (False, True):
        for fn in ("make_production_mesh", "make_test_mesh"):
            got = getattr(tmesh, fn)(multi_pod=multi)
            sizes, names = ((2, 16, 16), ("pod", "data", "model")) \
                if multi else ((16, 16), ("data", "model"))
            if fn == "make_test_mesh":
                sizes = (2, 2, 2) if multi else (2, 4)
            assert (got.sizes, got.axis_names) == (sizes, names)
    one = taddr.MeshSpec((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_device_mesh(one, "cpu")
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="holds 2 ranks"):
            tmesh.make_device_mesh(taddr.MeshSpec((2, 1), ("data", "model")),
                                   "cpu")
        dm = tmesh.make_device_mesh(one, "cpu")
        assert taddr.mesh_axes(dm) == {"data": 1, "model": 1}
        assert TCluster("qwen3-14b-smoke", dm, device="cpu").plan() == \
            TCluster("qwen3-14b-smoke", one, device="cpu").plan()
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="out of the mesh's order"):
        taddr.placements((("data", "pod"),), tmesh.make_test_mesh(
            multi_pod=True))
    assert torch.Size(taddr.shard_shape(("data",), (8, 3), one)) == (8, 3)
