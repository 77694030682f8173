"""repro_torch's interconnect models and machine hierarchy against the
reference's (`repro.core.interconnect`, `repro.core.mesh`).

* `TopologyModel` (MemPool's Top_1 / Top_4 / Top_H): `split`,
  `accepted_load` and `avg_latency` equal the reference's exactly (`==`)
  for the three specs on a grid of injected load x p_local x tiles, and
  the reference's own claims (paper Fig. 4/5) hold for the port.
* `CollectiveModel` on a `Topology` built with the reference's v5e levels:
  every collective's seconds and wire bytes equal the reference's to
  1e-12 relative, and so does `ring_allgather_time`. On `h100_topology`
  the algebra holds (all_reduce = reduce_scatter + all_gather, an axis of
  one costs nothing) and the levels are the H100 data sheet's.

Tolerance: none for the topology model; 1e-12 relative for the collective
model (the same formulas, one float order). Data: fixed grids.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import itertools

import pytest

from repro.core import interconnect as jic
from repro.core import mesh as jhw
from repro_torch.core import interconnect as tic
from repro_torch.core import mesh as thw

SPECS = ("TOP_1", "TOP_4", "TOP_H")
LOADS = (0.0, 0.01, 0.05, 0.1, 0.2, 0.3, 0.37, 0.39, 0.4, 0.5, 0.9, 1.0,
         2.0)
P_LOCAL = (0.0, 0.02, 0.25, 0.5, 0.75, 0.95, 1.0)
TILES = (1, 2, 3, 4, 16, 64)


@pytest.mark.parametrize("n_tiles", TILES)
@pytest.mark.parametrize("spec", SPECS)
def test_topology_model_equals_reference(spec, n_tiles):
    js, ts = getattr(jic, spec), getattr(tic, spec)
    assert tuple(vars(js).values()) == tuple(vars(ts).values())
    jm, tm = jic.TopologyModel(js, n_tiles), tic.TopologyModel(ts, n_tiles)
    for load, p in itertools.product(LOADS, P_LOCAL):
        assert tm.split(p) == jm.split(p)
        assert tm.accepted_load(load, p) == jm.accepted_load(load, p)
        assert tm.avg_latency(load, p) == jm.avg_latency(load, p)
    assert tm.accepted_load(0.5) == jm.accepted_load(0.5)      # defaults
    assert tm.avg_latency(0.5) == jm.avg_latency(0.5)


def test_topology_claims_of_the_paper_hold():
    """The reference's Fig. 4 / Fig. 5 claims on the port's model:
    saturation order, the latency blow-up, hybrid addressing's gain."""
    t1, t4, th = (tic.TopologyModel(s) for s in (tic.TOP_1, tic.TOP_4,
                                                 tic.TOP_H))
    a1, a4, ah = (t.accepted_load(0.5) for t in (t1, t4, th))
    assert a1 < a4 <= ah
    assert a1 == pytest.approx(0.105, abs=0.02)
    assert ah == pytest.approx(0.41, abs=0.05)
    assert th.avg_latency(0.05) < 6.0
    assert th.avg_latency(0.39) > th.avg_latency(0.10) * 2
    acc = [th.accepted_load(2.0, p_local=p) for p in (0.0, 0.25, 0.5, 0.75)]
    assert all(b > a for a, b in zip(acc, acc[1:]))
    lat = [th.avg_latency(0.3, p_local=p) for p in (0.0, 0.25, 0.5, 0.75)]
    assert all(b < a for a, b in zip(lat, lat[1:]))
    gain = th.accepted_load(0.5, 0.25) / th.accepted_load(0.5, 0.0) - 1
    assert 0.15 < gain < 0.40, gain


def _v5e_levels():
    """The reference's v5e levels, as the port's `Level`s."""
    ref = jhw.v5e_topology((1,), ("data",)).levels
    return tuple(thw.Level(lv.name, lv.fanout, lv.latency_s, lv.bw_bytes)
                 for lv in ref)


MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data",
                                                          "model")),
          ((1, 4), ("data", "model")), ((4, 2, 8), ("pod", "data", "model"))]


def _close(a, b):
    return a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b))


@pytest.mark.parametrize("shape,names", MESHES,
                         ids=lambda x: "x".join(map(str, x))
                         if isinstance(x[0], int) else "-".join(x))
def test_collective_model_on_v5e_levels_equals_reference(shape, names):
    jm = jic.CollectiveModel(jhw.v5e_topology(shape, names))
    topo = thw.Topology(levels=_v5e_levels(), mesh_shape=shape,
                        axis_names=names)
    tm = tic.CollectiveModel(topo)
    assert topo.n_chips == jm.topo.n_chips
    for axis in names:
        assert topo.axis_size(axis) == jm.topo.axis_size(axis)
        for nbytes in (0.0, 1.0, 4096.0, 1e6, 3.3e9):
            for kind in ("all_gather", "reduce_scatter", "all_reduce",
                         "all_to_all"):
                got = getattr(tm, kind)(nbytes, axis)
                want = getattr(jm, kind)(nbytes, axis)
                assert _close(got.seconds, want.seconds), (kind, axis)
                assert _close(got.bytes_on_wire, want.bytes_on_wire)
            assert _close(topo.ring_allgather_time(axis, nbytes),
                          jm.topo.ring_allgather_time(axis, nbytes))
    for lv in _v5e_levels():
        assert topo.level(lv.name) == lv
    with pytest.raises(KeyError):
        topo.level("nvlink")


@pytest.mark.parametrize("axis", ["data", "model", "pod"])
def test_collective_algebra_on_h100(axis):
    topo = thw.h100_topology((2, 8, 4), ("pod", "data", "model"))
    cm = tic.CollectiveModel(topo)
    n = topo.axis_size(axis)
    shard = 1e6
    ag = cm.all_gather(shard, axis)
    assert ag.bytes_on_wire == shard * (n - 1)
    rs = cm.reduce_scatter(shard * n, axis)
    assert rs.bytes_on_wire == pytest.approx(shard * (n - 1))
    ar = cm.all_reduce(shard * n, axis)
    assert ar.seconds == pytest.approx(rs.seconds + ag.seconds)
    assert ar.bytes_on_wire == pytest.approx(rs.bytes_on_wire
                                             + ag.bytes_on_wire)
    assert ag.seconds > 0
    lvl = topo.axis_level(axis)
    assert lvl.name == ("network" if axis == "pod" else "nvlink")
    # the network is the slow level: the same bytes cost more across it
    assert (cm.all_gather(shard, "pod").seconds / (topo.axis_size("pod") - 1)
            > cm.all_gather(shard, "data").seconds
            / (topo.axis_size("data") - 1))
    one = tic.CollectiveModel(thw.h100_topology((1, 4), ("data", "model")))
    for kind in ("all_gather", "reduce_scatter", "all_reduce", "all_to_all"):
        c = getattr(one, kind)(1e6, "data")
        assert c.seconds == 0.0 and c.bytes_on_wire == 0.0
    assert one.topo.ring_allgather_time("data", 1e6) == 0.0


def test_h100_levels_are_the_data_sheet():
    topo = thw.h100_topology((2, 8), ("node", "data"))
    hbm, nvl, net = topo.levels
    assert (hbm.name, hbm.bw_bytes) == ("hbm", 3.35e12)
    assert (nvl.name, nvl.bw_bytes, nvl.fanout) == ("nvlink", 450e9, 8)
    assert thw.NVLINK_LINKS * thw.NVLINK_BW_PER_LINK == 450e9
    assert (net.name, net.bw_bytes, net.fanout) == ("network", 50e9, 2)
    assert topo.n_chips == 16
    # a switched fabric: half the axis's cards cross the cut
    assert topo.bisection_bw("data") == 4 * 2 * 450e9
    assert topo.bisection_bw("node") == 1 * 8 * 50e9
    assert tic.CollectiveModel().topo.axis_size("data") == thw.NODE_GPUS
    cm = tic.CollectiveModel(topo)
    assert cm.collective_term_seconds({"ag": 450e9, "rs": 450e9}) == 2.0
