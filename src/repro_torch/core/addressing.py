"""Hybrid addressing scheme — MemPool §3.2 — as a sharding planner (the
port of `repro.core.addressing`).

Two layers live here, as in the reference:

1. MemPool's address scrambler (paper Fig. 3), `AddressMap`: a bijective
   bit permutation that carves per-tile sequential regions out of a
   word-interleaved memory map, in numpy, bit for bit the reference's.

2. The region-policy sharding planner. Every tensor of a step gets a
   `Region` (SEQUENTIAL: private data, owner-local; INTERLEAVED: shared
   weights spread over the machine; REPLICATED: small read-only
   constants), and `AxisRules.spec_for` lowers logical-axis annotations
   to a spec on a mesh with the reference's divisibility and axis-conflict
   fallback.

A spec is a tuple with one entry per leading dim — None, a mesh axis
name, or a tuple of names — with trailing Nones dropped, the values of the
reference's `PartitionSpec`. A mesh is anything with axis names and sizes:
a `MeshSpec` (a plain description, so a 256- or 512-rank mesh is planned
with no ranks) or a live `torch.distributed.DeviceMesh`. Where the
reference leaves placement to GSPMD, the port turns a spec into DTensor
placements (`placements`), into a rank's coordinates and process groups
on a live mesh (`coordinates`, `batch_group`), and into a rank's own
block of a leaf (`LeafShard`: a dim split over the batch axes, a dim
split over "model", or both), which the sharded train step and the
checkpoints read.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Mapping, Sequence

import numpy as np
import torch

# ----------------------------------------------------------------------------
# 1. Paper-faithful address scrambler (Fig. 3)
# ----------------------------------------------------------------------------

BYTE_BITS = 2  # 32-bit words


@dataclasses.dataclass(frozen=True)
class AddressMap:
    """MemPool L1 address layout: [row | tile(t) | bank(b) | byte(2)].

    `seq_rows_bits` (s) rows of every tile's banks form its sequential
    region; the first 2**(t+s+b+2) bytes of the address space are
    sequential.
    """
    tile_bits: int = 6     # t: 64 tiles
    bank_bits: int = 4     # b: 16 banks/tile
    seq_rows_bits: int = 4  # s: 2**s rows per bank are sequential

    @property
    def seq_region_bytes(self) -> int:
        return 1 << (self.tile_bits + self.seq_rows_bits + self.bank_bits
                     + BYTE_BITS)

    def scramble(self, addr):
        """Logical (hybrid-map) address -> physical address (Fig. 3): the
        (tile, row_s) fields of a sequential-region address swap places,
        so each tile's 2^(s+b+2) contiguous logical bytes land in that
        tile, bank-interleaved. Outside the region: identity."""
        addr = np.asarray(addr, dtype=np.int64)
        t, b, s = self.tile_bits, self.bank_bits, self.seq_rows_bits
        lo = b + BYTE_BITS            # first bit above [bank|byte]
        in_seq = addr < self.seq_region_bytes

        keep_low = addr & ((1 << lo) - 1)
        row_f = (addr >> lo) & ((1 << s) - 1)        # logical row-in-tile
        tile_f = (addr >> (lo + s)) & ((1 << t) - 1)  # logical tile chunk
        high = addr >> (lo + t + s)
        phys = (high << (lo + t + s)) | (row_f << (lo + t)) | \
            (tile_f << lo) | keep_low
        return np.where(in_seq, phys, addr)

    def descramble(self, addr):
        """Inverse permutation (physical -> logical)."""
        addr = np.asarray(addr, dtype=np.int64)
        t, b, s = self.tile_bits, self.bank_bits, self.seq_rows_bits
        lo = b + BYTE_BITS
        in_seq = addr < self.seq_region_bytes

        keep_low = addr & ((1 << lo) - 1)
        tile_f = (addr >> lo) & ((1 << t) - 1)
        row_f = (addr >> (lo + t)) & ((1 << s) - 1)
        high = addr >> (lo + t + s)
        logical = (high << (lo + t + s)) | (tile_f << (lo + s)) | \
            (row_f << lo) | keep_low
        return np.where(in_seq, logical, addr)

    def tile_of(self, addr) -> np.ndarray:
        """Physical tile servicing a physical (post-scramble) address: the
        hardwired interconnect routing field."""
        addr = np.asarray(addr, dtype=np.int64)
        lo = self.bank_bits + BYTE_BITS
        return (addr >> lo) & ((1 << self.tile_bits) - 1)


# ----------------------------------------------------------------------------
# 2. Meshes: a plain description or a live DeviceMesh
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh by its axes alone: ``MeshSpec((16, 16), ("data", "model"))``.
    Enough to plan; `launch.mesh.make_device_mesh` makes a live
    DeviceMesh of it over an initialised process group."""
    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"MeshSpec: {len(self.sizes)} sizes for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a `MeshSpec` or a `DeviceMesh`, in mesh
    order."""
    if isinstance(mesh, MeshSpec):
        return mesh.shape
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"a mesh needs axis names; got {type(mesh).__name__}")
    return dict(zip(names, tuple(mesh.shape)))


def describe(mesh) -> MeshSpec:
    """The plain description of any mesh."""
    axes = mesh_axes(mesh)
    return MeshSpec(tuple(axes.values()), tuple(axes))


# ----------------------------------------------------------------------------
# 3. Region-policy sharding planner
# ----------------------------------------------------------------------------

class Region(enum.Enum):
    SEQUENTIAL = "sequential"    # private -> owner-local, collective-free
    INTERLEAVED = "interleaved"  # shared  -> spread machine-wide (FSDP x TP)
    REPLICATED = "replicated"    # RO consts -> every chip has a copy


@dataclasses.dataclass
class AxisRules:
    """Logical-axis -> mesh-axes mapping, parameterized by region policy.

    `rules` maps a logical axis name to a mesh axis (or a tuple of axes,
    or None). Built by `default_rules`."""
    rules: Mapping[str, Any]

    def spec_for(self, logical_axes: Sequence[str | None],
                 shape: Sequence[int], mesh) -> tuple:
        """The spec of a leaf of `shape` with `logical_axes` on `mesh`:
        each dim takes its rule's mesh axes in order, dropping an axis
        that an earlier dim used, that the mesh lacks, or that would not
        divide the dim (the planner's "multiplexer" fallback)."""
        sizes = mesh_axes(mesh)
        used: set[str] = set()
        parts = []
        for dim, name in zip(shape, logical_axes):
            axes = _normalize(self.rules.get(name) if name else None)
            kept = []
            size = 1
            for ax in axes:
                if ax in used or ax not in sizes:
                    continue
                nxt = size * sizes[ax]
                if dim % nxt != 0:
                    continue
                kept.append(ax)
                used.add(ax)
                size = nxt
            parts.append(tuple(kept) if len(kept) > 1
                         else (kept[0] if kept else None))
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)


def _normalize(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


def default_rules(mesh, *, fsdp: bool = True, seq_shard: bool = False,
                  zero1: bool = True, expert_axis: str | None = None,
                  overrides=()) -> AxisRules:
    """The framework's hybrid memory map, as logical-axis rules.

    INTERLEAVED logical axes (weights):
      embed   -> the batch axes when fsdp (weights spread over the DP
                 "banks")
      ffn/heads/vocab/qkv -> model axis (TP)
    SEQUENTIAL logical axes (private data):
      batch -> (pod, data): each chip owns its slice outright
      seq   -> data only when seq_shard (sequence parallelism for prefill)
      kv_heads, kv_seq -> model (a KV cache sharded with its producer)
    `zero1`: optimizer moments take their parameters' logical axes, so
    under fsdp they are spread over `data` like the weights (ZeRO-1 with
    no code path of its own)."""
    has_pod = "pod" in mesh_axes(mesh)
    batch_axes = ("pod", "data") if has_pod else ("data",)
    rules = {
        # --- SEQUENTIAL region ---
        "batch": batch_axes,
        "seq": ("data",) if seq_shard else None,
        "kv_seq": "model",
        "state": None,
        # --- INTERLEAVED region ---
        "embed": batch_axes if fsdp else None,   # FSDP shard dim
        "vocab": "model",
        "ffn": "model",
        "heads": "model",
        "kv_heads": "model",
        "qkv": "model",
        "expert": expert_axis,                   # None -> TP-within-expert
        "conv": None,
        "layers": None,                          # stacked-layer dim whole
        # --- REPLICATED ---
        "norm": None,
        None: None,
    }
    rules.update(dict(overrides))
    return AxisRules(rules=rules)


def map_trees(fn, abstract, logical):
    """`fn(abstract leaf, logical axes)` over two trees of one structure
    (dicts and lists; a logical tuple is a leaf)."""
    if isinstance(abstract, dict):
        return {k: map_trees(fn, abstract[k], logical[k]) for k in abstract}
    if isinstance(abstract, list):
        return [map_trees(fn, a, g) for a, g in zip(abstract, logical)]
    return fn(abstract, logical)


def plan_tree(abstract_tree: Any, logical_tree: Any, mesh,
              rules: AxisRules) -> Any:
    """A tree of `Sharding`s (mesh + spec) for a tree of shape records
    (anything with ``.shape``) and its logical-axes tree."""
    return map_trees(lambda a, g: Sharding(mesh, rules.spec_for(g, a.shape,
                                                            mesh)),
                 abstract_tree, logical_tree)


def spec_tree(abstract_tree: Any, logical_tree: Any, mesh,
              rules: AxisRules) -> Any:
    """Same as `plan_tree` but the raw specs."""
    return map_trees(lambda a, g: rules.spec_for(g, a.shape, mesh),
                 abstract_tree, logical_tree)


# ----------------------------------------------------------------------------
# 4. From a spec to placements and shards (what GSPMD does in the reference)
# ----------------------------------------------------------------------------

def spec_axes(spec: tuple, dim: int) -> tuple[str, ...]:
    """The mesh axes that split `dim` under `spec` (major first)."""
    return _normalize(spec[dim]) if dim < len(spec) else ()


def shard_shape(spec: tuple, shape: Sequence[int], mesh) -> tuple:
    """One device's block of a leaf of `shape` (the reference's
    `NamedSharding(mesh, spec).shard_shape(shape)`)."""
    sizes = mesh_axes(mesh)
    return tuple(d // math.prod(sizes[a] for a in spec_axes(spec, i))
                 for i, d in enumerate(shape))


def placements(spec: tuple, mesh) -> list:
    """The DTensor placements of `spec`: for each mesh axis, ``Shard(d)``
    when the spec splits dim d over it, else ``Replicate()``. An entry
    that names several axes must name them in mesh order (a DTensor
    shards a dim over mesh dims major to minor)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    out = [Replicate() for _ in names]
    for d in range(len(spec)):
        axes = spec_axes(spec, d)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {spec}: dim {d} names {axes} out of the "
                             f"mesh's order {tuple(names)}")
        for ax in axes:
            out[names.index(ax)] = Shard(d)
    return out


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (the reference's `NamedSharding`)."""
    mesh: Any
    spec: tuple

    def shard_shape(self, shape: Sequence[int]) -> tuple:
        return shard_shape(self.spec, shape, self.mesh)


def local_block(spec: tuple, shape: Sequence[int], mesh,
                coords: Mapping[str, int]) -> tuple[slice, ...]:
    """The slice of a leaf of `shape` that the device at mesh coordinates
    `coords` ({axis: index}) holds under `spec`: each split dim cut into
    the product of its axes' sizes, the index counted major (the entry's
    first axis) to minor, as the reference's `NamedSharding` lays blocks
    out."""
    sizes = mesh_axes(mesh)
    out = []
    for d, n in enumerate(shape):
        index, parts = 0, 1
        for a in spec_axes(spec, d):
            index = index * sizes[a] + coords[a]
            parts *= sizes[a]
        step = n // parts
        out.append(slice(index * step, (index + 1) * step))
    return tuple(out)


def coordinates(mesh) -> dict[str, int]:
    """This rank's coordinate on each axis of a live DeviceMesh."""
    return dict(zip(mesh_axes(mesh), mesh.get_coordinate()))


def block_index(axes: Sequence[str], mesh,
                coords: Mapping[str, int]) -> tuple[int, int]:
    """(index, parts) of the block that the rank at `coords` holds of a
    dim split over `axes` (major first), as `local_block` counts it."""
    sizes = mesh_axes(mesh)
    index, parts = 0, 1
    for a in axes:
        index = index * sizes[a] + coords[a]
        parts *= sizes[a]
    return index, parts


BATCH_AXES = ("pod", "data")
_BATCH_GROUPS: dict = {}


def batch_group(mesh):
    """The process group of this rank's replicas over the batch axes
    ("pod" and "data") of a live DeviceMesh: the ranks that share its
    other coordinates, in the order `block_index` counts the batch axes
    (pod major). One axis's own group when the mesh has one batch axis;
    else a group of every such set of ranks, made once a mesh (every
    rank makes them all, in one order)."""
    sizes = mesh_axes(mesh)
    axes = [a for a in BATCH_AXES if a in sizes]
    if not axes:
        raise ValueError(f"mesh axes {tuple(sizes)} have no batch axis "
                         f"({BATCH_AXES})")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = id(mesh)
    if key not in _BATCH_GROUPS:
        import torch.distributed as dist
        names = list(sizes)
        rest = [names.index(a) for a in names if a not in axes]
        ranks = mesh.mesh.permute([names.index(a) for a in axes] + rest)
        ranks = ranks.reshape(math.prod(sizes[a] for a in axes), -1)
        mine = None
        for col in ranks.t().tolist():
            if col != sorted(col):
                raise NotImplementedError(
                    f"mesh {sizes}: the batch axes' ranks {col} are not in "
                    f"rank order (the batch axes must lead the mesh)")
            group = dist.new_group(col)
            if dist.get_rank() in col:
                mine = group
        _BATCH_GROUPS[key] = (mesh, mine)
    return _BATCH_GROUPS[key][1]


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """One rank's block of a leaf, on `device`: `dim` cut into `parts`
    equal chunks over the batch axes, of which the rank holds chunk
    `index` (dim None: whole over them), spread over the process group
    `group`; and `model_dim` cut likewise into `model_parts` over the
    "model" axis (`model_index`, `model_group`; None: whole over it). A
    leaf with neither is replicated.

    `take` is how an initial state or a restore lands on the rank: its
    block, cut on the host side of the copy to `device`, its own storage
    (never a view of a whole leaf). `gather_batch` is the collective that
    makes the rank's model block whole over the batch axes (what the
    train step computes with), `gather` the leaf whole over both (what a
    checkpoint holds); a split runs its gather also when its group has
    one rank (then it is a copy). The train step's per-layer gather
    (`fsdp_gather`) gathers a layer's blocks with
    `collectives.gather_for_layer` instead, which at one rank is the
    block itself."""
    dim: int | None
    index: int = 0
    parts: int = 1
    device: Any = None
    group: Any = None
    model_dim: int | None = None
    model_index: int = 0
    model_parts: int = 1
    model_group: Any = None

    @property
    def sharded(self) -> bool:
        """Split over the batch axes."""
        return self.dim is not None

    @property
    def model_sharded(self) -> bool:
        return self.model_dim is not None

    def local_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The shape of this rank's block of a leaf of `shape`."""
        out = list(shape)
        for dim, parts in ((self.dim, self.parts),
                           (self.model_dim, self.model_parts)):
            if dim is not None:
                out[dim] //= parts
        return tuple(out)

    def take(self, whole):
        t = torch.as_tensor(whole)
        part = t
        for dim, index, parts in ((self.dim, self.index, self.parts),
                                  (self.model_dim, self.model_index,
                                   self.model_parts)):
            if dim is not None and parts > 1:
                n = part.shape[dim] // parts
                part = part.narrow(dim, index * n, n)
        if part is t:
            return t if self.device is None else t.to(self.device)
        out = part if self.device is None else part.to(self.device)
        if out.untyped_storage().data_ptr() == \
                t.untyped_storage().data_ptr():
            out = out.clone()
        return out

    def gather_batch(self, local):
        if not self.sharded:
            return local
        from repro_torch.core import collectives
        return collectives.all_gather_dim(local, self.dim, self.group)

    def gather(self, local):
        whole = self.gather_batch(local)
        if not self.model_sharded:
            return whole
        from repro_torch.core import collectives
        return collectives.all_gather_dim(whole, self.model_dim,
                                          self.model_group)


def take_tree(shards, tree):
    """Each leaf of `tree` cut to this rank's block (`LeafShard.take`),
    `shards` a tree like it of `LeafShard`s (a whole cache or parameter
    tree landing on a rank, as the tests and checkpoints place it)."""
    if isinstance(shards, LeafShard):
        return shards.take(tree)
    if isinstance(shards, dict):
        return {k: take_tree(shards[k], tree[k]) for k in tree}
    return [take_tree(s, t) for s, t in zip(shards, tree)]
