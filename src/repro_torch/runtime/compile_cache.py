"""Program cache and CUDA-graph capture (the port of
`repro.runtime.compile_cache`).

The reference memoizes compiled executables keyed on the step, the
shapes and the mesh. The port's compiled form of a step is a CUDA graph
captured from its eager PyTorch run: `CompileCache` memoizes built things
(`Cluster.compile` keeps its programs in one), `Captured` records one
graph, and `Graphed` runs a function as a cache of captured graphs keyed
as the reference keys its jit cache (input shapes and dtypes).

The reference's `compile_step` (an AOT `jax.jit(...).lower().compile()`)
has no counterpart: a captured graph reads and writes the addresses it was
captured on, so it lives with the program that owns those buffers and
cannot be built ahead of them.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Callable

import torch

_NOTHING = object()


def _fingerprint(*parts: Any) -> str:
    s = json.dumps([str(p) for p in parts], sort_keys=True)
    return hashlib.sha1(s.encode()).hexdigest()[:16]


class CompileCache:
    """`get(key_parts, build)`: the thing built for this key, built on the
    first request. `hits` and `misses` count the requests."""

    def __init__(self):
        self._cache: dict[str, Any] = {}
        self.hits = 0
        self.misses = 0

    def get(self, key_parts: tuple, build: Callable[[], Any]):
        key = _fingerprint(*key_parts)
        if key in self._cache:
            self.hits += 1
            return self._cache[key]
        self.misses += 1
        exe = build()
        self._cache[key] = exe
        return exe

    def clear(self) -> None:
        """Drop every entry (the counters stay)."""
        self._cache.clear()

    def __len__(self) -> int:
        return len(self._cache)


class Captured:
    """`fn()` captured as a CUDA graph.

    Construction runs `fn` once eagerly on a side stream (the warm-up that
    capture needs; its result is `first`, a real call with all its
    effects), then captures a second call in ``thread_local`` mode without
    running it. `replay()` runs the captured call on the current stream and
    returns its outputs, the graph's own tensors, which the next replay
    overwrites.

    A kernel wrapper counts a launch when Python calls it, so the warm-up
    and the capture each count once and a replay counts nothing; a device
    trace (`kernels.launches.traced_launches`) sees the replays' launches.
    A capture that fails raises: nothing falls back to eager."""

    def __init__(self, fn: Callable[[], Any]):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.first = fn()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side,
                              capture_error_mode="thread_local"):
            self.out = fn()

    def replay(self):
        self.graph.replay()
        return self.out


def tensor_leaves(tree):
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensor_leaves(v)


def _map(fn, tree, *rest):
    """`fn` over the leaves (anything but a dict, list or tuple) of `tree`
    and the trees of the same structure in `rest`."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _signature(tree) -> Any:
    """A copied argument's key: each tensor's shape and dtype, each other
    leaf's type."""
    return _map(lambda x: (tuple(x.shape), str(x.dtype))
                if isinstance(x, torch.Tensor) else type(x).__name__, tree)


class Graphed:
    """`fn(*args)` run on the card as captured CUDA graphs: the port's
    `jax.jit`.

    Arguments at the positions in `copied` (a batch: token ids, frames, a
    position) are copied into the graph's own input tensors before each
    replay. Every other tensor argument (parameters, caches, state) is used
    in place, by address: what `fn` writes there lands in the caller's
    tensors. The graphs sit in `graphs`, a `CompileCache` keyed by the
    copied arguments' shapes and dtypes and by the identity of the in-place
    tensors. The first call with a key runs `fn` eagerly (the warm-up) and
    captures it, and returns the eager result; later calls replay. Outputs
    that are not in-place arguments come back as fresh copies, so that a
    later replay does not overwrite what the caller holds.

    A graph writes to the addresses it was captured on, so the graphs keep
    their in-place tensors alive, and a call whose in-place tensors are
    other ones (a new parameter tree, another cache) first drops every
    graph of the old ones. CPU arguments, a call made while a capture is
    under way and ``cuda_graph=False`` run `fn` eagerly (`eager` is `fn`
    itself)."""

    def __init__(self, fn: Callable, *, copied: tuple[int, ...] = (),
                 cuda_graph: bool = True):
        self.eager = fn
        self.copied = frozenset(copied)
        self.cuda_graph = cuda_graph
        self.graphs = CompileCache()
        self._held: tuple[int, ...] | None = None

    @torch.inference_mode()
    def __call__(self, *args):
        first = next(tensor_leaves(args), None)
        if (not self.cuda_graph or first is None or not first.is_cuda
                or torch.cuda.is_current_stream_capturing()):
            return self.eager(*args)
        fixed = [t for i, a in enumerate(args) if i not in self.copied
                 for t in tensor_leaves(a)]
        held = tuple(map(id, fixed))
        if held != self._held:
            self.graphs.clear()
            self._held = held
        inputs = [a for i, a in enumerate(args) if i in self.copied]
        entry = self.graphs.get(
            (held, _signature(inputs)),
            lambda: _GraphEntry(self.eager, args, self.copied, first.device))
        out = entry.take_first()
        if out is _NOTHING:
            entry.load(inputs)
            held_ids = set(held)
            out = _map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                       and id(x) not in held_ids else x,
                       entry.captured.replay())
        return out


class _GraphEntry:
    """One captured graph of a `Graphed` function: the arguments it was
    captured on (the copied ones replaced by the graph's own inputs) and
    the capture."""

    def __init__(self, fn, args, copied, device):
        def static(x):
            if isinstance(x, torch.Tensor):
                return x.to(device, copy=True)
            if x is None:
                return None
            return torch.as_tensor(x, device=device)

        self.args = [_map(static, a) if i in copied else a
                     for i, a in enumerate(args)]
        self.inputs = [a for i, a in enumerate(self.args) if i in copied]
        self.captured = Captured(lambda: fn(*self.args))
        self._first = self.captured.first
        self.captured.first = None

    def take_first(self):
        """The warm-up's result, once; `_NOTHING` afterwards."""
        out, self._first = self._first, _NOTHING
        return out

    def load(self, inputs) -> None:
        """Copy this call's batch into the graph's inputs."""
        def put(dst, src):
            if isinstance(dst, torch.Tensor):
                if isinstance(src, torch.Tensor):
                    dst.copy_(src)
                elif isinstance(src, (bool, int, float)):
                    dst.fill_(src)
                else:
                    dst.copy_(torch.as_tensor(src))

        _map(put, self.inputs, inputs)
