"""One-call entry points (the port of `repro.api`): thin shims over the
`Cluster` and its programs, kept so that calls written for the reference
keep their return shapes.

Entry points run on the card; ``device="cpu"`` runs the plain versions on
the CPU.
"""

from __future__ import annotations

from repro_torch.cluster import Cluster, ServeSessionProgram


def plan(arch: str, mesh=None):
    """The reference's hybrid addressing plan has no port yet."""
    raise NotImplementedError("plan: the addressing plan is ROADMAP Queue 1 "
                              "K (item 14, the XLA-only modules)")


def train(arch: str, **kwargs):
    """Training has no port yet."""
    raise NotImplementedError("train: training is ROADMAP Queue 1 H "
                              "(item 11)")


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
