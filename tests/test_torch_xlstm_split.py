"""xlstm's mLSTM / sLSTM blocks split over "model" (the dry run's tponly
rules): the collectives a block issues do not grow with the sequence.
The sLSTM gathers its gates' inputs once, before its scan, and no
collective runs inside the scan's per-step loop; the mLSTM gathers w_up's
output once and sums its five head products once, whatever the number
of chunks. Counted on a (1, 1) mesh of a one-rank gloo group, where
every split the plan names is made at size 1 and each collective is
still counted.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import dataclasses

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get as tget
from repro_torch.core import addressing, collectives
from repro_torch.core.addressing import MeshSpec
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.models import blocks, steps

ARCH = "xlstm-125m-smoke"
TPONLY = (("embed", None),)


@pytest.mark.parametrize("kind", ["slstm", "mlstm"])
def test_block_collectives_do_not_grow_with_the_sequence(tmp_path, kind):
    cfg = dataclasses.replace(tget(ARCH), rules_overrides=TPONLY,
                              attn_chunk=8)
    params = steps.init_params(cfg, 0, device="cpu", max_seq=32)
    layer = steps.layer_kinds(cfg).index(kind)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_device_mesh(MeshSpec((1, 1), ("data", "model")), "cpu")
        axis = steps.model_axis(cfg, mesh, addressing.default_rules(
            mesh, overrides=TPONLY), max_seq=32)
        assert axis.inner is not None and axis.cell_heads is not None
        got = {}
        for S in (8, 32):
            x = torch.randn((2, S, cfg.d_model), generator=torch.Generator(
                ).manual_seed(S))
            ctx = {"positions": torch.arange(S).expand(2, S), "rope": False,
                   "max_seq": S, "model_axis": axis}
            collectives.reset_counts()
            with torch.no_grad():
                y, _ = blocks.BLOCKS[kind]["apply"](
                    cfg, params["blocks"][layer], x, ctx)
            assert y.shape == x.shape and torch.isfinite(y).all()
            got[S] = {k: v for k, v in collectives.counts().items()
                      if v and not k.endswith("_bytes")}
    finally:
        dist.destroy_process_group()
    assert got[8] == got[32]
    assert got[8]["inner_all_gather"] == 1
    assert got[8]["reduce_from_ranks"] == 1
    assert got[8].get("gates_reduce_scatter", 0) == (
        5 if kind == "mlstm" else 0)
