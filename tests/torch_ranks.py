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

import contextlib
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
                  names=("data", "model"), replace=None, grads_of=(),
                  fsdp_gather=False):
    """The sharded step on `mesh` (sizes over `names`; None: (world, 1))
    from the whole state in the file `state` (the port's layout) on the
    batches in the file `batches`, this rank taking its rows (the plan's
    batch block); `replace` is `dataclasses.replace` keywords for the
    arch's config; `fsdp_gather` the step's per-layer gather. -> every
    step's metrics, the collective counts of one step, each leaf's shard
    shape, this rank's mesh coordinates and final blocks, the step's
    reduced gradients of the first batch (this rank's blocks of the
    leaves named in `grads_of`, key paths, and on rank 0 the whole tree),
    the elements of the gradients each `torch.autograd.grad` call of that
    batch's `accumulate` returned (not those backward makes inside
    one), and (rank 0) the whole state at the
    end."""
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
        max_seq=max_seq, fsdp_gather=fsdp_gather)
    coords = dict(zip(addressing.mesh_axes(mesh), mesh.get_coordinate()))
    metrics, counts, grads, grad_numel = [], None, {}, []

    def rows_of(batch):
        B, S = batch["tokens"].shape
        spec = rules.spec_for(("batch", "seq"), (B, S), mesh)
        rows = addressing.local_block(spec, (B, S), mesh, coords)[0]
        return {k: v[rows] for k, v in batch.items()}

    all_batches = torch.load(batches, weights_only=False)
    autograd_grad, depth = torch.autograd.grad, []

    def counted_grad(*args, **kw):
        depth.append(1)           # the calls backward makes inside one
        try:
            out = autograd_grad(*args, **kw)
        finally:
            depth.pop()
        if not depth:
            grad_numel.append(sum(t.numel() for t in out))
        return out

    torch.autograd.grad = counted_grad
    try:
        _, _, g = step.accumulate(local["params"], rows_of(all_batches[0]))
    finally:
        torch.autograd.grad = autograd_grad
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
            "coords": coords, "local": local, "grad_numel": grad_numel,
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
def model_axis(rank, world, *, arch="xlstm-125m-smoke", overrides=None):
    """The sharded step of `arch` on a (1, world) mesh (under
    `default_rules(mesh, overrides=overrides)` when given, else the
    arch's own rules): the message of its NotImplementedError (None when
    it builds)."""
    from repro_torch.configs import get
    from repro_torch.core import addressing
    from repro_torch.models import steps

    mesh = _mesh(world, model=world)
    rules = (None if overrides is None else
             addressing.default_rules(mesh, overrides=overrides))
    try:
        steps.make_sharded_train_step(get(arch), mesh, rules=rules)
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


# ----------------------------------------------------------------------------
# Serving on a mesh (tests/test_torch_serve_mesh.py)
# ----------------------------------------------------------------------------

SERVE_B, PROMPT, DECODE_STEPS, CHUNK, MAX_PROMPT, PAGE = 4, 6, 8, 4, 8, 4


def serve_inputs(cfg, max_seq: int) -> dict:
    """The seeded inputs of a serving case (global batch of SERVE_B
    slots): prefill tokens (B, PROMPT); per-slot start positions that put
    the slots in different blocks of the cache's rows; teacher-forced
    decode tokens (B, DECODE_STEPS); a session's prompts (lengths 2 ..
    MAX_PROMPT) and budgets."""
    import numpy as np
    rng = np.random.default_rng(7)
    B = SERVE_B
    span = max_seq - DECODE_STEPS
    starts = (np.arange(B) * span) // B + rng.integers(0, max(span // B, 1),
                                                       B)
    lens = rng.integers(2, MAX_PROMPT + 1, B)
    prompts = np.zeros((B, MAX_PROMPT), np.int64)
    for b in range(B):
        prompts[b, :lens[b]] = rng.integers(0, cfg.vocab, lens[b])
    return {"prefill": torch.from_numpy(
                rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)),
            "starts": torch.from_numpy(np.minimum(starts, span).astype(
                np.int64)),
            "decode": torch.from_numpy(
                rng.integers(0, cfg.vocab, (B, DECODE_STEPS)).astype(
                    np.int32)),
            "prompt_buf": torch.from_numpy(prompts),
            "prompt_len": torch.from_numpy(lens.astype(np.int64)),
            "budget": torch.from_numpy(rng.integers(3, 7, B).astype(
                np.int64))}


def serve_cross(cfg):
    """A vision or encoder-decoder model's cross context for the prefill
    (f32, seeded), else None."""
    n = cfg.n_img_tokens if cfg.family == "vlm" else (
        cfg.enc_seq if cfg.family == "encdec" else 0)
    if not n:
        return None
    g = torch.Generator().manual_seed(11)
    return torch.randn((SERVE_B, n, cfg.d_model), generator=g) * 0.5


def f32(cache: dict) -> dict:
    """A cache's leaves in f32 (the tests' parameters are f32; the
    reference cannot run its bf16 cache with f32 parameters either)."""
    return {k: v.float() for k, v in cache.items()}


def serve_state(cache, inputs, rows=slice(None), *, pages_per_slot=None):
    """A session state (`engine.init_session_state`) over `cache` for the
    slots `rows` of the inputs, every slot admitted with its prompt and
    budget; with `pages_per_slot`, slot b's table maps the pages 1 + b *
    pages_per_slot onwards (page 0 is the trash page)."""
    from repro_torch.runtime import engine
    buf = inputs["prompt_buf"][rows]
    n = buf.shape[0]
    state = engine.init_session_state(f32(cache), n, buf.shape[1],
                                      pages_per_slot, device="cpu")
    state["prompt_buf"].copy_(buf)
    state["prompt_len"].copy_(inputs["prompt_len"][rows])
    state["budget"].copy_(inputs["budget"][rows])
    state["active"].fill_(True)
    if pages_per_slot is not None:
        slots = torch.arange(inputs["prompt_buf"].shape[0])[rows]
        state["pages"].copy_(1 + slots[:, None] * pages_per_slot
                             + torch.arange(pages_per_slot))
    return state


def run_session(fn, params, state, rounds: int = 2):
    """`rounds` chunks of a session cell -> (tokens, emit flags) of every
    chunk, concatenated along the steps."""
    toks, emits = [], []
    for _ in range(rounds):
        state, t, e, _, _ = fn(params, state)
        toks.append(t.clone())
        emits.append(e.clone())
    return torch.cat(toks, 1), torch.cat(emits, 1)


def chunk_start(cfg, max_seq: int) -> int:
    """Where a case's decode chunk starts: CHUNK rows before the middle
    of the cache's rows, so that its 2 * CHUNK steps write and attend
    across the boundary of two ranks' row blocks at model 2 or 4."""
    from repro_torch.models import steps
    return steps.decode_cache_len(cfg, max_seq) // 2 - CHUNK


def run_chunk(fn, params, cache, start_tok, rounds: int = 2, start: int = 0):
    """`rounds` calls of a K-step decode chunk from position `start`
    (SERVE_B rows of `start_tok`, no EOS; the rows before `start` left as
    the cache holds them) -> the tokens of every call."""
    b = start_tok.shape[0]
    tok = start_tok.to(torch.int64)
    fin = torch.zeros(b, dtype=torch.bool)
    emitted = torch.zeros(b, dtype=torch.int64)
    pos = torch.full((), start, dtype=torch.int64)
    rem = torch.full((), rounds * CHUNK, dtype=torch.int64)
    out = []
    for _ in range(rounds):
        cache, tok, fin, emitted, pos, n, _, toks = fn(
            params, cache, tok, fin, emitted, pos, rem)
        rem = rem - n
        out.append(toks)
    return torch.cat(out, 1)


@contextlib.contextmanager
def reading_logits():
    """Within the block, every greedy pick of the port's serving steps
    (`steps._greedy`) also records its f32 logits, whole over the
    vocabulary (a rank's block gathered over the model ranks here, outside
    the step's counted collectives), in call order: the list yielded."""
    from repro_torch.models import steps
    seen, greedy = [], steps._greedy

    def reading(lg, axis):
        whole = lg
        if axis is not None and axis.vocab is not None:
            front = lg.movedim(-1, 0).contiguous()
            out = front.new_empty((axis.size * front.shape[0],
                                   *front.shape[1:]))
            gather = getattr(dist, "all_gather_single", None) or \
                dist.all_gather_into_tensor      # the name before torch 2.13
            gather(out, front, group=axis.group)
            whole = out.movedim(0, -1)
        seen.append(whole.clone())
        return greedy(lg, axis)

    steps._greedy = reading
    try:
        yield seen
    finally:
        steps._greedy = greedy


def serve_reference(cfg, params, max_seq: int, inputs, *, paged: bool,
                    cross=None, cells: bool = True):
    """The one-process results of a serving case on the whole batch (the
    port's plain steps and cells): prefill tokens and logits, every
    decode step's tokens and logits, the cache after them; with `cells`,
    the chunk's tokens, the session's and (`paged`) the paged session's
    tokens and emit flags and pool."""
    from repro_torch.models import steps
    from repro_torch.runtime import engine
    B = SERVE_B
    clen = steps.decode_cache_len(cfg, max_seq)
    out = {}
    batch = {"tokens": inputs["prefill"]}
    if cross is not None:
        batch["enc_embeds" if cfg.family == "encdec" else "img_embeds"] = \
            cross
    step = steps.make_decode_step(cfg, max_seq)
    cache = f32(steps.init_cache(cfg, B, clen, device="cpu"))
    out["decode"] = []
    with reading_logits() as seen:
        out["prefill"] = steps.make_prefill_step(cfg)(params, batch)
        for t in range(DECODE_STEPS):
            cache, tok = step(params, cache, {
                "tokens": inputs["decode"][:, t:t + 1],
                "pos": inputs["starts"] + t})
            out["decode"].append(tok)
    out["prefill_logits"], out["decode_logits"] = seen[0], seen[1:]
    out["cache"] = cache
    if not cells:
        return out
    plain = steps.make_decode_step(cfg, max_seq)
    out["chunk"] = run_chunk(engine.decode_chunk_fn(plain, CHUNK), params,
                             f32(steps.init_cache(cfg, B, clen,
                                                  device="cpu")),
                             inputs["decode"][:, :1],
                             start=chunk_start(cfg, max_seq))
    sess = engine.session_chunk_fn(plain, CHUNK, cuda_graph=False)
    out["session"] = run_session(sess, params, serve_state(
        steps.init_cache(cfg, B, clen, device="cpu"), inputs))
    if paged:
        pps = -((max_seq + 1) // -PAGE)
        pool = steps.init_paged_cache(cfg, B, clen, n_pages=B * pps + 1,
                                      page_size=PAGE, device="cpu")
        state = serve_state(pool, inputs, pages_per_slot=pps)
        out["paged"] = run_session(sess, params, state)
        out["pool"] = state["cache"]
    return out


@job
def serve_case(rank, world, *, arch, params, max_seq, mesh=None,
               names=("data", "model"), replace=None, paged=True,
               cells=True):
    """A serving case on `mesh`, this rank's share of it, from the whole
    parameters in the file `params` and `serve_inputs`: the sharded
    prefill's tokens and logits, 8 teacher-forced sharded decode steps'
    tokens and logits and the cache blocks after them; with `cells`, the
    decode-chunk, session and (`paged`) paged session cells of
    `cells.build_cell`, their tokens and the pool's blocks. Also this
    rank's coordinates and batch rows, and one decode step's collective
    counts."""
    import dataclasses

    from repro_torch.cluster import cells as cells_lib
    from repro_torch.configs import get
    from repro_torch.configs.registry import ShapeConfig
    from repro_torch.core import addressing, collectives
    from repro_torch.models import steps

    cfg = dataclasses.replace(get(arch), **(replace or {}))
    mesh = _mesh(world, sizes=mesh, names=names)
    rules = addressing.default_rules(mesh, overrides=cfg.rules_overrides)
    coords = addressing.coordinates(mesh)
    B = SERVE_B
    spec = rules.spec_for(("batch",), (B,), mesh)
    rows = addressing.local_block(spec, (B,), mesh, coords)[0]
    inputs = serve_inputs(cfg, max_seq)
    whole = torch.load(params, weights_only=False)
    out = {"coords": coords, "rows": (rows.start, rows.stop)}

    pre = steps.make_sharded_prefill_step(cfg, mesh, max_seq=max_seq,
                                          batch=B)
    local = addressing.take_tree(pre.shards, whole)
    batch = {"tokens": inputs["prefill"][rows]}
    cross = serve_cross(cfg)
    if cross is not None:
        batch["enc_embeds" if cfg.family == "encdec" else "img_embeds"] = \
            cross[rows]

    clen = steps.decode_cache_len(cfg, max_seq)
    step = steps.make_sharded_decode_step(cfg, mesh, max_seq, batch=B)
    shards = steps.cache_shards(cfg, mesh, rules, B, clen)
    cache = f32(steps.init_cache(cfg, B, clen, device="cpu", shards=shards))
    out["decode"] = []
    with reading_logits() as seen:
        out["prefill"] = pre(local, batch)
        for t in range(DECODE_STEPS):
            collectives.reset_counts()
            cache, tok = step(local, cache, {
                "tokens": inputs["decode"][rows, t:t + 1],
                "pos": inputs["starts"][rows] + t})
            out["counts"] = collectives.counts()
            out["decode"].append(tok)
    out["prefill_logits"], out["decode_logits"] = seen[0], seen[1:]
    out["cache"] = cache
    out["split"] = step.split
    if not cells:
        return out
    shape = ShapeConfig("t", max_seq, B, "decode")
    fn = cells_lib.build_cell(cfg, shape, mesh, rules, decode_chunk=CHUNK)[0]
    out["chunk"] = run_chunk(fn, local, f32(steps.init_cache(
        cfg, B, clen, device="cpu", shards=fn.cache_shards)),
        inputs["decode"][rows, :1], start=chunk_start(cfg, max_seq))
    fn = cells_lib.build_cell(cfg, shape, mesh, rules, decode_chunk=CHUNK,
                              session=True)[0]
    out["session"] = run_session(fn, local, serve_state(
        steps.init_cache(cfg, B, clen, device="cpu",
                         shards=fn.cache_shards), inputs, rows))
    if paged:
        fn, args = cells_lib.build_cell(cfg, shape, mesh, rules,
                                        decode_chunk=CHUNK, session=True,
                                        paged=True, page_size=PAGE)[:2]
        pps = args[1]["pages"].shape[1]
        pool = steps.init_paged_cache(
            cfg, B, clen, n_pages=B * pps + 1, page_size=PAGE,
            device="cpu", shards=fn.cache_shards)
        state = serve_state(pool, inputs, rows, pages_per_slot=pps)
        out["paged"] = run_session(fn, local, state)
        out["pool"] = state["cache"]
        out["pool_shards"] = {k: (s.dim, s.model_dim)
                              for k, s in fn.cache_shards.items()}
    out["cache_shards"] = {k: (s.dim, s.model_dim)
                           for k, s in shards.items()}
    return out


@job
def serve_ref_cells(rank, world, *, arch, params, inputs, seq=64, batch=8):
    """qwen3's prefill, session and paged session cells of `build_cell` on
    the reference's (2, 4) test mesh (`inputs`: the prefill tokens and
    the session's prompts and budgets of every slot) -> this rank's rows,
    its prefill tokens and each session's tokens and emit flags."""
    from repro_torch.cluster import cells as cells_lib
    from repro_torch.configs import get
    from repro_torch.configs.registry import ShapeConfig
    from repro_torch.core import addressing
    from repro_torch.models import steps

    cfg = get(arch)
    mesh = _mesh(world, sizes=(2, 4), names=("data", "model"))
    rules = addressing.default_rules(mesh, overrides=cfg.rules_overrides)
    coords = addressing.coordinates(mesh)
    spec = rules.spec_for(("batch",), (batch,), mesh)
    rows = addressing.local_block(spec, (batch,), mesh, coords)[0]
    whole = torch.load(params, weights_only=False)
    fn = cells_lib.build_cell(cfg, ShapeConfig("t", seq, batch, "prefill"),
                              mesh, rules)[0]
    local = addressing.take_tree(fn.shards, whole)
    out = {"rows": (rows.start, rows.stop), "prefill": fn(local, {
        "tokens": inputs["prefill"][rows]})}
    shape = ShapeConfig("t", seq, batch, "decode")
    clen = steps.decode_cache_len(cfg, seq)
    for paged in (False, True):
        fn, args = cells_lib.build_cell(cfg, shape, mesh, rules,
                                        decode_chunk=CHUNK, session=True,
                                        paged=paged, page_size=PAGE)[:2]
        pps = args[1]["pages"].shape[1] if paged else None
        cache = (steps.init_paged_cache(
            cfg, batch, clen, n_pages=batch * pps + 1, page_size=PAGE,
            device="cpu", shards=fn.cache_shards) if paged else
            steps.init_cache(cfg, batch, clen, device="cpu",
                             shards=fn.cache_shards))
        state = serve_state(cache, inputs, rows, pages_per_slot=pps)
        out["paged" if paged else "session"] = run_session(fn, local, state)
    return out


@job
def decode_cell(rank, world, *, arch, params, seq, batch, tokens, start,
                replace=None):
    """`build_cell`'s decode cell of `arch` on the reference's (2, 4) test
    mesh from the whole parameters in the file `params`: teacher-forced
    steps of `tokens` (batch x steps) from position `start` (one position
    for every slot, as the reference's cell takes it), this rank its rows
    and its blocks of a zero f32 cache -> its rows and the tokens of
    every step. `replace` is `dataclasses.replace` keywords for the
    arch's config."""
    import dataclasses

    from repro_torch.cluster import cells as cells_lib
    from repro_torch.configs import get
    from repro_torch.configs.registry import ShapeConfig
    from repro_torch.core import addressing
    from repro_torch.models import steps

    cfg = dataclasses.replace(get(arch), **(replace or {}))
    mesh = _mesh(world, sizes=(2, 4), names=("data", "model"))
    rules = addressing.default_rules(mesh, overrides=cfg.rules_overrides)
    coords = addressing.coordinates(mesh)
    spec = rules.spec_for(("batch",), (batch,), mesh)
    rows = addressing.local_block(spec, (batch,), mesh, coords)[0]
    fn = cells_lib.build_cell(cfg, ShapeConfig("t", seq, batch, "decode"),
                              mesh, rules)[0]
    local = addressing.take_tree(fn.shards,
                                 torch.load(params, weights_only=False))
    cache = f32(steps.init_cache(cfg, batch, steps.decode_cache_len(
        cfg, seq), device="cpu", shards=fn.cache_shards))
    out = []
    for t in range(tokens.shape[1]):
        cache, tok = fn(local, cache, {"tokens": tokens[rows, t:t + 1],
                                       "pos": start + t})
        out.append(tok)
    return {"rows": (rows.start, rows.stop), "decode": torch.cat(out, 1)}


@job
def prefill_cell(rank, world, *, arch, params, tokens, replace=None):
    """`build_cell`'s prefill cell of `arch` (`replace` as `decode_cell`
    takes it) on the reference's (2, 4) test mesh from the whole
    parameters in the file `params` on the prompts `tokens` (batch x
    seq), this rank its rows -> its rows and their greedy tokens."""
    import dataclasses

    from repro_torch.cluster import cells as cells_lib
    from repro_torch.configs import get
    from repro_torch.configs.registry import ShapeConfig
    from repro_torch.core import addressing

    cfg = dataclasses.replace(get(arch), **(replace or {}))
    mesh = _mesh(world, sizes=(2, 4), names=("data", "model"))
    rules = addressing.default_rules(mesh, overrides=cfg.rules_overrides)
    batch, seq = tokens.shape
    spec = rules.spec_for(("batch",), (batch,), mesh)
    rows = addressing.local_block(spec, (batch,), mesh,
                                  addressing.coordinates(mesh))[0]
    fn = cells_lib.build_cell(cfg, ShapeConfig("t", seq, batch, "prefill"),
                              mesh, rules)[0]
    local = addressing.take_tree(fn.shards,
                                 torch.load(params, weights_only=False))
    return {"rows": (rows.start, rows.stop),
            "prefill": fn(local, {"tokens": tokens[rows]})}


@job
def train_cell(rank, world, *, arch, state, batches, seq, batch,
               fsdp_gather=True, replace=None):
    """`build_cell`'s train cell (with `fsdp_gather` unless it is False)
    on the reference's (2, 4) test mesh from the whole state in the file
    `state` (the port's layout) on the global batches in the file
    `batches`, this rank taking its rows -> each step's metrics and (rank
    0) the whole state after them. `replace` as `decode_cell` takes
    it."""
    import dataclasses

    from torch.utils import _pytree as pytree

    from repro_torch.cluster import cells as cells_lib
    from repro_torch.configs import get
    from repro_torch.configs.registry import ShapeConfig
    from repro_torch.core import addressing

    cfg = dataclasses.replace(get(arch), **(replace or {}))
    mesh = _mesh(world, sizes=(2, 4), names=("data", "model"))
    rules = addressing.default_rules(mesh, overrides=cfg.rules_overrides)
    coords = addressing.coordinates(mesh)
    fn = cells_lib.build_cell(cfg, ShapeConfig("t", seq, batch, "train"),
                              mesh, rules, fsdp_gather=fsdp_gather)[0]
    local = addressing.take_tree(fn.shards,
                                 torch.load(state, weights_only=False))
    spec = rules.spec_for(("batch", "seq"), (batch, seq), mesh)
    rows = addressing.local_block(spec, (batch, seq), mesh, coords)[0]
    metrics = []
    for b in torch.load(batches, weights_only=False):
        local, m = fn(local, {k: v[rows] for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    whole = pytree.tree_map(
        lambda sh, leaf: sh.gather(leaf), fn.shards, local,
        is_leaf=lambda x: isinstance(x, addressing.LeafShard))
    return {"metrics": metrics, "state": whole if rank == 0 else None}


@job
def dryrun_cells(rank, world, *, arch, seq, batch, mesh=(2, 2)):
    """`build_cell`'s train and decode cells of `arch` on `mesh` over
    ("data", "model"), run for real on this rank's seeded blocks (CPU:
    the plain route) under `core.op_cost.tracked` -> for each cell the
    collectives' counts and bytes (`collectives.counts`) and the products'
    flops (FlopCounterMode's formulas), which a dry run's meta trace of
    the same rank must give too."""
    from torch.utils import _pytree as pytree

    from repro_torch.cluster import cells as cells_lib
    from repro_torch.configs import get
    from repro_torch.configs.registry import ShapeConfig, TensorSpec
    from repro_torch.core import addressing, collectives, op_cost

    cfg = get(arch)
    dmesh = _mesh(world, sizes=mesh, names=("data", "model"))
    rules = addressing.default_rules(dmesh, overrides=cfg.rules_overrides)
    gen = torch.Generator().manual_seed(rank)

    def real(s):
        if s.dtype.is_floating_point:
            return (torch.randn(s.shape, generator=gen) * 0.02).to(s.dtype)
        if s.dtype == torch.bool:
            return torch.zeros(s.shape, dtype=torch.bool)
        return torch.randint(0, cfg.vocab, s.shape, generator=gen,
                             dtype=s.dtype) if s.shape else \
            torch.zeros((), dtype=s.dtype)

    out = {}
    for kind in ("train", "decode"):
        fn, args = cells_lib.build_cell(
            cfg, ShapeConfig("t", seq, batch, kind), dmesh, rules)[:2]
        args = pytree.tree_map(real, args,
                               is_leaf=lambda x: isinstance(x, TensorSpec))
        collectives.reset_counts()
        with op_cost.tracked() as tr:
            fn(*args)
        out[kind] = {"collectives": collectives.counts(),
                     "products": tr.ops.products}
    return out
