"""Spawned gloo ranks for the port's multi-process tests (not a test
module; imports torch and repro_torch only, so a rank starts without
jax).

`start_ranks(jobs, world, root, timeout)` starts `world` processes (the
"spawn" start method), each one rank of a gloo group over a `FileStore`
under `root`, which run the listed jobs in order; its `wait()` returns
each rank's results. Several such worlds may run at once. Every rank
caps torch at one thread. The group's collectives time out after
`COLLECTIVE_TIMEOUT_S`, so a rank whose peer died raises instead of
waiting; `wait` joins all ranks against the deadline set at the start,
kills those still alive when it passes and fails, and a rank's exception
comes back as the failure's text. A job is a (name, kwargs) pair naming
a function of `JOBS`; with `group=False` the jobs run with no group
initialised (a launcher that starts its own). `run_ranks` starts and
waits; `in_process` runs jobs as the one rank of a group in this
process.
"""

from __future__ import annotations

import datetime
import os
import shutil
import signal
import socket
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

COLLECTIVE_TIMEOUT_S = 60
JOBS = {}


def job(fn):
    JOBS[fn.__name__] = fn
    return fn


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (torchrun-style env:// rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, root: str, jobs: list, group: bool):
    torch.set_num_threads(1)
    out = Path(root) / f"rank{rank}.pt"
    try:
        if group:
            dist.init_process_group(
                "gloo", store=dist.FileStore(str(Path(root) / "store"),
                                             world),
                rank=rank, world_size=world,
                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            results = [JOBS[name](rank=rank, world=world, **kw)
                       for name, kw in jobs]
        finally:
            if group:
                dist.destroy_process_group()
        torch.save(results, out)
    except BaseException:
        (Path(root) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)


class Ranks:
    """A started world of ranks (`start_ranks`)."""

    def __init__(self, jobs: list, world: int, root, timeout: float,
                 group: bool):
        self.world, self.root, self.timeout = world, Path(root), timeout
        self.root.mkdir(parents=True, exist_ok=True)
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_entry,
                                  args=(r, world, str(self.root), jobs,
                                        group), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout

    def wait(self) -> list:
        """[rank 0's results, rank 1's, ...], each a list with one entry a
        job. Raises AssertionError when a rank fails or the deadline
        passes (every rank still running is killed first)."""
        for p in self.procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = {r: (self.root / f"rank{r}.err").read_text()
                  for r in range(self.world)
                  if (self.root / f"rank{r}.err").exists()}
        codes = [p.exitcode for p in self.procs]
        if hung or errors or any(codes):
            raise AssertionError(f"ranks hung past {self.timeout} s: {hung};"
                                 f" exit codes {codes}; errors: {errors}")
        return [torch.load(self.root / f"rank{r}.pt", weights_only=False)
                for r in range(self.world)]


def start_ranks(jobs: list, world: int, root, *, timeout: float = 120.0,
                group: bool = True) -> Ranks:
    return Ranks(jobs, world, root, timeout, group)


def run_ranks(jobs: list, world: int, root, *, timeout: float = 120.0,
              group: bool = True) -> list:
    return start_ranks(jobs, world, root, timeout=timeout,
                       group=group).wait()


def in_process(jobs: list, root) -> list:
    """The jobs' results as the one rank of a gloo group of this
    process (a `FileStore` under `root`), the group ended after."""
    Path(root).mkdir(parents=True, exist_ok=True)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(Path(root) / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(
            seconds=COLLECTIVE_TIMEOUT_S))
    try:
        return [JOBS[name](rank=0, world=1, **kw) for name, kw in jobs]
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------------
# Jobs
# ----------------------------------------------------------------------------

def _mesh(world: int, model: int = 1, sizes=None, names=None):
    """A DeviceMesh over the group: `sizes` / `names` when given, else
    (world // model, model) over ("data", "model")."""
    from repro_torch.core.addressing import MeshSpec
    from repro_torch.launch.mesh import make_device_mesh
    if sizes is None:
        sizes, names = (world // model, model), ("data", "model")
    return make_device_mesh(MeshSpec(tuple(sizes), tuple(names)), "cpu")


@job
def sharded_steps(rank, world, *, arch, grad_accum, state, batches,
                  schedule_kwargs, policy="fused", max_seq=16, mesh=None,
                  names=("data", "model"), replace=None, grads_of=()):
    """The sharded step on `mesh` (sizes over `names`; None: (world, 1))
    from the whole state in the file `state` (the port's layout) on the
    batches in the file `batches`, this rank taking its rows (the plan's
    batch block); `replace` is `dataclasses.replace` keywords for the
    arch's config. -> every step's metrics, the collective counts of one
    step, each leaf's shard shape, this rank's mesh coordinates and
    final blocks, the step's reduced gradients of the first batch (this
    rank's blocks of the leaves named in `grads_of`, key paths, and on
    rank 0 the whole tree) and (rank 0) the whole state at the end."""
    import dataclasses

    from torch.utils import _pytree as pytree

    from repro_torch.configs import get
    from repro_torch.core import addressing, collectives
    from repro_torch.models import steps

    cfg = dataclasses.replace(get(arch), grad_accum=grad_accum,
                              **(replace or {}))
    mesh = _mesh(world, sizes=mesh, names=names)
    rules = addressing.default_rules(mesh, overrides=cfg.rules_overrides)
    shards = steps.state_shards(cfg, mesh, rules, device="cpu",
                                max_seq=max_seq)
    whole = torch.load(state, weights_only=False)
    local = pytree.tree_map(lambda sh, leaf: sh.take(leaf), shards, whole,
                            is_leaf=lambda x: isinstance(
                                x, addressing.LeafShard))
    step = steps.make_sharded_train_step(
        cfg, mesh, schedule_kwargs=schedule_kwargs, policy=policy,
        max_seq=max_seq)
    coords = dict(zip(addressing.mesh_axes(mesh), mesh.get_coordinate()))
    metrics, counts, grads = [], None, {}

    def rows_of(batch):
        B, S = batch["tokens"].shape
        spec = rules.spec_for(("batch", "seq"), (B, S), mesh)
        rows = addressing.local_block(spec, (B, S), mesh, coords)[0]
        return {k: v[rows] for k, v in batch.items()}

    all_batches = torch.load(batches, weights_only=False)
    _, _, g = step.accumulate(local["params"], rows_of(all_batches[0]))
    grads = {pytree.keystr(path): t for path, t in
             pytree.tree_flatten_with_path(g)[0]
             if pytree.keystr(path) in grads_of}
    whole_grads = step.gather(g)
    for batch in all_batches:
        collectives.reset_counts()
        local, m = step(local, rows_of(batch))
        counts = counts or collectives.counts()
        metrics.append({k: float(v) for k, v in m.items()})
    shapes = pytree.tree_map(lambda t: tuple(t.shape), local)
    gathered = pytree.tree_map(
        lambda sh, leaf: sh.gather(leaf), shards, local,
        is_leaf=lambda x: isinstance(x, addressing.LeafShard))
    return {"metrics": metrics, "counts": counts, "shapes": shapes,
            "coords": coords, "local": local,
            "grads": grads, "state": gathered if rank == 0 else None,
            "whole_grads": whole_grads if rank == 0 else None}


@job
def program(rank, world, *, arch, checkpoint_dir, preempt_after=None,
            copies=(), wait_for=None, mesh=None, **spec):
    """`Cluster(arch, MeshSpec(mesh or (world, 1), ("data", "model")))
    .compile(TrainProgram(...)).run()` on the CPU; with `preempt_after`
    k, a SIGTERM to this rank after its k-th step (every rank at the same
    step). `wait_for`: a file to wait for first (another world's
    `copies`, up to the collectives' timeout); `copies`: directories rank
    0 copies the checkpoint directory into after the run, each then
    marked by a ``<dir>.done`` file. -> the report's final step,
    preemption flag, logged losses and the trained parameters' shapes."""
    from repro_torch.cluster import Cluster, TrainProgram
    from repro_torch.core.addressing import MeshSpec

    if wait_for is not None:
        deadline = time.monotonic() + COLLECTIVE_TIMEOUT_S
        while not os.path.exists(wait_for):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{wait_for} never came")
            time.sleep(0.05)

    cluster = Cluster(arch, MeshSpec(tuple(mesh or (world, 1)),
                                     ("data", "model")), device="cpu")
    prog = cluster.compile(TrainProgram(checkpoint_dir=checkpoint_dir,
                                        **spec))
    if preempt_after is not None:
        step, calls = prog.step, []

        def preempted(state, batch):
            out = step(state, batch)
            calls.append(1)
            if len(calls) == preempt_after:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        prog.step = preempted
    report = prog.run()
    if rank == 0:
        for target in copies:
            shutil.copytree(checkpoint_dir, target)
            Path(f"{target}.done").touch()
    return {"final_step": report["final_step"],
            "preempted": report["preempted"],
            "losses": {m["step"]: m["loss"] for m in report["metrics"]},
            "shapes": [tuple(t.shape) for t in
                       _leaves(report["params"])]}


def _leaves(tree):
    from torch.utils import _pytree as pytree
    return pytree.tree_leaves(tree)


@job
def api_train(rank, world, *, checkpoint_dir, **kw):
    """`api.train(..., mesh=MeshSpec((world, 1)))` -> its report's keys
    and logged losses."""
    from repro_torch import api
    from repro_torch.core.addressing import MeshSpec

    rep = api.train("qwen3-14b", mesh=MeshSpec((world, 1),
                                               ("data", "model")),
                    device="cpu", checkpoint_dir=checkpoint_dir, **kw)
    return {"keys": sorted(rep), "final_step": rep["final_step"],
            "losses": [m["loss"] for m in rep["metrics"]]}


@job
def cli(rank, world, *, port, argv):
    """`launch/train.py` as torchrun runs it: RANK / WORLD_SIZE /
    LOCAL_RANK and a 127.0.0.1 rendezvous in the environment, no group
    before it. -> the logged losses."""
    from repro_torch.launch import train

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(port)})
    rep = train.main(argv)
    return {"final_step": rep["final_step"],
            "losses": [m["loss"] for m in rep["metrics"]]}


@job
def model_axis(rank, world, *, arch="xlstm-125m-smoke"):
    """The sharded step of `arch` on a (1, world) mesh: the message of
    its NotImplementedError (None when it builds)."""
    from repro_torch.configs import get
    from repro_torch.models import steps

    try:
        steps.make_sharded_train_step(get(arch), _mesh(world, model=world))
    except NotImplementedError as e:
        return str(e)
    return None




@job
def compressed_psum(rank, world, *, grads, method):
    """`optim.compress.compressed_psum` of this rank's gradient tree
    (`grads[rank]`, numpy leaves) over the group -> the reduced leaves
    and then the error feedback's (dict keys sorted), as numpy arrays."""
    from torch.utils import _pytree as pytree

    from repro_torch.optim import compress

    g = pytree.tree_map(torch.from_numpy, grads[rank])
    red, err = compress.compressed_psum(g, dist.group.WORLD, method)
    return [t.numpy() for t in _sorted_leaves(red) + _sorted_leaves(err)]


def _sorted_leaves(tree) -> list:
    """A tree's leaves with dict keys in sorted order (jax's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _sorted_leaves(t)]
    return [tree]
