"""One-call entry points (the port of `repro.api`): thin shims over the
`Cluster` and its programs, kept so that calls written for the reference
keep their return shapes.

Entry points run on the card; ``device="cpu"`` runs the plain versions on
the CPU.
"""

from __future__ import annotations

import os
import tempfile
import warnings

from repro_torch.cluster import Cluster, ServeSessionProgram, TrainProgram

_UNSET = object()


def plan(arch: str, mesh, *, device=None) -> dict:
    """The hybrid addressing plan for an architecture on a mesh (a
    `core.addressing.MeshSpec` such as `launch.mesh.make_production_mesh()`,
    or a live DeviceMesh): {tree path: {logical, spec, region, shape}} for
    every parameter.

    Shim over `Cluster(arch, mesh).plan()`; planning allocates nothing.
    `device` is the cluster's (the card unless ``device="cpu"``)."""
    return Cluster(arch, mesh, device=device).plan()


def train(arch: str, *, num_steps: int | None = None, steps_=_UNSET,
          batch: int = 4, seq: int = 128, smoke: bool = True,
          checkpoint_dir: str = os.path.join(tempfile.gettempdir(),
                                             "repro_torch-api-train"),
          mesh=None, seed: int = 0, device=None) -> dict:
    """One-call training on the synthetic stream. Returns the loop report.

    Shim over `Cluster(...).compile(TrainProgram(...)).run()`. `steps_` is
    a deprecated alias for `num_steps` (kept for one release). `mesh` (a
    live DeviceMesh, or a `MeshSpec` made into one over the initialised
    process group) trains data-parallel over its batch axes and
    tensor-parallel over its "model" axis, this process one rank of it."""
    if steps_ is not _UNSET:
        warnings.warn("api.train(steps_=...) is deprecated; use num_steps=",
                      DeprecationWarning, stacklevel=2)
        if num_steps is None:
            num_steps = steps_
    if num_steps is None:
        num_steps = 100
    cluster = Cluster(arch + ("-smoke" if smoke else ""), mesh,
                      device=device)
    program = cluster.compile(TrainProgram(
        num_steps=num_steps, batch=batch, seq=seq, seed=seed,
        checkpoint_dir=checkpoint_dir))
    return program.run()


def serve(arch: str, params=None, *, batch: int = 4, max_seq: int = 64,
          max_new: int = 16, smoke: bool = True, seed: int = 0,
          chunk: int = 1, device=None) -> dict:
    """One-call batched greedy decoding. Returns tokens + latency stats.

    Shim over the request-level serving API: compiles a
    `ServeSessionProgram` (one slot per batch row), submits one request
    per slot and drains — the legacy return shape (tokens array +
    ServeLoop-style stats, the session's under ``"session"``). `chunk` is
    the decode-steps-per-host-sync knob (1 = one sync per token, the
    legacy default)."""
    cluster = Cluster(arch + ("-smoke" if smoke else ""), device=device)
    program = cluster.compile(ServeSessionProgram(
        slots=batch, max_seq=max_seq, max_new=max_new, seed=seed,
        chunk=chunk))
    return program.run(params=params)
