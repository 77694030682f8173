"""Checkpointing (the port of `repro.checkpoint.manager`, same on-disk
formats, so either package reads what the other wrote).

* `save` / `restore`: a step directory ``step-<9 digits>`` holding
  ``leaves.npz`` (one member a leaf, keyed by its tree path) and a
  ``manifest.json`` with each leaf's shape and true dtype; written to a
  tmp directory and renamed (atomic), ``LATEST`` updated after, the oldest
  beyond `keep` removed. Serialization runs on a thread unless
  ``async_save=False``; a failed write surfaces on the next `save` or on
  `wait()`, never silently.
* `save_session` / `restore_session`: one serving-session snapshot as a
  single ``session-<9 digits>.ckpt`` file — a JSON manifest line (the
  session's `meta` and each leaf's key, dtype, stored view and shape)
  followed by the leaves' raw bytes in manifest order, written to a tmp
  file and renamed.

Tree paths join dict keys (sorted, as `jax.tree_util` orders them) and
list indices with "/"; leaves are tensors, numpy arrays and numbers, and
any other object (a captured CUDA graph in a session state) is skipped.
Dtypes numpy lacks are stored as unsigned views of the same width with
the true dtype in the manifest: bf16 as uint16, read back through
torch's 16-bit view, so the bits round-trip without `ml_dtypes`.
`restore_session` writes into the tensors of `like` in place: a captured
session step keeps the addresses it replays on. `restore(...,
shardings=)` puts each restored leaf on the device it names (one device
for all, or a tree of them): the elastic restore onto the survivors'
devices, the port's counterpart of the reference's per-leaf
`device_put`. A tree of `core.addressing.LeafShard`s instead restores
each rank's block of every leaf (the sharded step's state), and
`save(..., shardings=)` gathers such a state's leaves whole (a
collective every rank joins) before the one manager with ``writer=True``
writes them: a checkpoint holds whole leaves whatever the world size
that wrote it, as the reference's global arrays do.
"""

from __future__ import annotations

import json
import numbers
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.addressing import LeafShard

_SEP = "/"

# torch dtypes numpy cannot hold: (manifest name, stored view (the
# reference's), the same-width integer type torch views them through)
_VIEW_DTYPES = {
    torch.bfloat16: ("bfloat16", np.uint16, torch.int16),
    torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8, torch.uint8),
    torch.float8_e5m2: ("float8_e5m2", np.uint8, torch.uint8),
}
_BY_NAME = {name: (dt, tview)
            for dt, (name, _view, tview) in _VIEW_DTYPES.items()}
_NP_OF = {torch.int16: np.int16, torch.uint8: np.uint8}


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, numbers.Number))


def _items(tree, prefix=()):
    """(path, leaf) pairs in tree order; non-array objects skipped."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    elif _is_leaf(tree):
        yield _SEP.join(prefix), tree


def _encode(leaf) -> tuple[np.ndarray, str]:
    """A host copy of the leaf's bits, and its true dtype's name. A copy
    also for a leaf already on the host: an async save writes it while the
    caller goes on updating its state in place."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype in _VIEW_DTYPES:
            name, view, tview = _VIEW_DTYPES[t.dtype]
            return t.view(tview).numpy().view(view), name
        return t.numpy(), str(t.numpy().dtype)
    arr = np.array(leaf, order="C", copy=True)
    return arr, str(arr.dtype)


def _decode(arr: np.ndarray, dtype_name: str, like):
    """The stored array as a leaf of `like`'s kind (a tensor on its
    device, else a numpy array)."""
    if dtype_name in _BY_NAME:
        dt, tview = _BY_NAME[dtype_name]
        t = torch.from_numpy(np.array(arr).view(_NP_OF[tview])).view(dt)
    elif isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.array(arr))
    else:
        return np.array(arr)
    return t.to(like.device) if isinstance(like, torch.Tensor) else t


def _rebuild(like, leaves: dict, prefix=()):
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(like))
    if not _is_leaf(like):
        return like
    key = _SEP.join(prefix)
    if key not in leaves:
        raise KeyError(f"checkpoint missing leaf {key}")
    return leaves[key]


def _placements(like, shardings) -> dict:
    """{leaf key: torch.device or LeafShard} from `shardings`."""
    if shardings is None:
        return {}
    if isinstance(shardings, (str, torch.device)):
        dev = torch.device(shardings)
        return {key: dev for key, _ in _items(like)}
    out = {}

    def walk(tree, sh, prefix):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], sh[k], prefix + (str(k),))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, sh[i], prefix + (str(i),))
        elif _is_leaf(tree) and sh is not None:
            out[_SEP.join(prefix)] = (sh if isinstance(sh, LeafShard)
                                      else torch.device(sh))

    walk(like, shardings, ())
    return out


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 3,
                 async_save: bool = True, writer: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self.writer = writer
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # ------------------------------------------------------------- save
    def save(self, step: int, state, *, block: bool = False,
             shardings=None):
        """The host copy is taken now (every leaf copied, a host leaf
        too, so the caller may update its state in place as soon as this
        returns); serialization runs on a thread unless `block` or
        ``async_save=False``. A failed write of the previous save raises
        here (and on `wait()`). With `shardings` (a tree of `LeafShard`s
        like `state`) every split leaf is gathered whole first; a manager
        with ``writer=False`` joins the gathers and writes nothing."""
        self.wait()
        where = _placements(state, shardings)
        snapshot = {}
        for k, v in _items(state):
            sh = where.get(k)
            if isinstance(sh, LeafShard):
                v = sh.gather(v)
            if self.writer:
                snapshot[k] = _encode(v)
        if not self.writer:
            return

        def _write():
            try:
                self._write_step(step, snapshot)
            except Exception as e:   # surfaced on wait() / next save()
                self._error = e

        if self.async_save and not block:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def _write_step(self, step: int, encoded: dict):
        tmp = self.dir / f".tmp-{step}"
        final = self.dir / f"step-{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "leaves.npz", **{k: v for k, (v, _) in encoded.items()})
        manifest = {
            "step": step,
            "time": time.time(),
            "leaves": {k: {"shape": list(v.shape), "dtype": dt}
                       for k, (v, dt) in encoded.items()},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                       # atomic publish
        (self.dir / "LATEST.tmp").write_text(str(step))
        (self.dir / "LATEST.tmp").rename(self.dir / "LATEST")
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step-{s:09d}", ignore_errors=True)

    def wait(self):
        """Block until the in-flight write lands; raise its exception
        (once) if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # --------------------------------------------------- serving session
    def save_session(self, step: int, state, meta: dict):
        """One bit-exact serving-session snapshot: the state's tensors
        (the captured step graph skipped) and the host-side bookkeeping
        `meta`, as one `.ckpt` file written in one go and renamed; the
        oldest beyond `keep` removed."""
        self.wait()
        encoded = {k: _encode(v) for k, v in _items(state)}
        manifest = {"step": step, "meta": meta,
                    "leaves": [{"key": k, "dtype": dt, "view": str(v.dtype),
                                "shape": list(v.shape)}
                               for k, (v, dt) in encoded.items()]}
        tmp = self.dir / f".tmp-session-{step}.ckpt"
        with open(tmp, "wb") as f:
            f.write(json.dumps(manifest).encode() + b"\n")
            for v, _ in encoded.values():
                f.write(memoryview(v).cast("B"))
        tmp.rename(self.dir / f"session-{step:09d}.ckpt")
        for old in self.session_steps()[: -self.keep]:
            (self.dir / f"session-{old:09d}.ckpt").unlink(missing_ok=True)

    def session_steps(self) -> list[int]:
        return sorted(int(p.stem.split("-")[1])
                      for p in self.dir.glob("session-*.ckpt"))

    def latest_session_step(self) -> int | None:
        steps = self.session_steps()
        return steps[-1] if steps else None

    def restore_session(self, step: int, like) -> tuple[object, dict]:
        """Inverse of `save_session`: (`like`'s tree with the snapshot's
        values, the session meta). Every tensor of `like` is written in
        place, so it keeps its storage; a leaf of another dtype or shape
        raises."""
        raw = bytearray((self.dir / f"session-{step:09d}.ckpt").read_bytes())
        nl = raw.index(b"\n")                   # manifest json has no \n
        manifest = json.loads(raw[:nl])
        stored, off = {}, nl + 1
        for spec in manifest["leaves"]:
            arr = np.frombuffer(
                raw, dtype=np.dtype(spec["view"]), offset=off,
                count=int(np.prod(spec["shape"], dtype=np.int64)),
            ).reshape(spec["shape"])
            stored[spec["key"]] = (arr, spec["dtype"])
            off += arr.nbytes
        leaves = {}
        for key, leaf in _items(like):
            if key not in stored:
                raise KeyError(f"session snapshot missing leaf {key}")
            value = _decode(*stored[key], like=leaf)
            if isinstance(leaf, torch.Tensor):
                if value.dtype != leaf.dtype or value.shape != leaf.shape:
                    raise ValueError(
                        f"session snapshot leaf {key}: {value.dtype} "
                        f"{tuple(value.shape)}, the state holds "
                        f"{leaf.dtype} {tuple(leaf.shape)}")
                with torch.inference_mode():
                    leaf.copy_(value)
                value = leaf
            leaves[key] = value
        return _rebuild(like, leaves), manifest["meta"]

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("-")[1])
                      for p in self.dir.glob("step-*") if p.is_dir())

    def latest_step(self) -> int | None:
        marker = self.dir / "LATEST"
        if marker.exists():
            s = int(marker.read_text())
            if (self.dir / f"step-{s:09d}" / "manifest.json").exists():
                return s
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like, shardings=None):
        """`like`'s tree with the step's values: tensors (on each `like`
        leaf's device) where `like` holds tensors, else numpy arrays.

        `shardings` says where each leaf goes instead: one device (a
        `torch.device` or its name) for every leaf, or a tree of `like`'s
        structure with a device (or None: `like`'s own) at each leaf. A
        leaf given a device comes back as a tensor on it, also where
        `like` holds a numpy array. A `LeafShard` there restores this
        rank's shard of the leaf, on the shard's device."""
        d = self.dir / f"step-{step:09d}"
        data = np.load(d / "leaves.npz")
        manifest = json.loads((d / "manifest.json").read_text())
        where = _placements(like, shardings)
        leaves = {}
        for key, leaf in _items(like):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            dev = where.get(key)
            dtype = manifest["leaves"][key]["dtype"]
            if isinstance(dev, LeafShard):         # cut on the host side
                value = dev.take(_decode(data[key], dtype,
                                         torch.empty(0)))
            else:
                value = _decode(data[key], dtype, leaf)
                if dev is not None:
                    value = torch.as_tensor(value).to(dev)
            leaves[key] = value
        return _rebuild(like, leaves)
