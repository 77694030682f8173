"""TuneDB — a persistent, shareable database of timed kernel tunes; the
port's copy of `repro.kernels.tunedb` (same schema, same env names).

MemPool's efficiency story only holds because its kernel mappings are
*measured* per workload, not modeled. The in-memory analogue is
`configs.registry.KERNEL_TUNES`; this module gives those records a disk
life so the measurement is paid once per (backend, kernel, shape, dtype,
policy-mode) key and every later process warm-starts instead of
re-racing.

Backend keys: the port writes "cuda" (the Hopper kernels' plan knobs) and
"torch_cpu" (the plain versions on the CPU), never the reference's "cpu",
"gpu" or "tpu" (`jax.default_backend()`), so a DB file both packages
share never hands Pallas blocks to a Hopper kernel, or the other way
round. Records of other backends survive a load-save round trip verbatim.

File format (schema-versioned JSON; anything unreadable, corrupt, or from
another schema version is *ignored* — the caller falls back to cold
autotune, never crashes):

    {"version": 1,
     "records": [{"backend": "cuda", "mode": "fused", "kernel": "matmul",
                  "shape_key": "b2_k4096_m4096_n4096",
                  "blocks": [["tile_n", 256]],
                  "default_blocks": [...], "modeled_seconds": ...,
                  "default_modeled_seconds": ..., "saved_bytes": 0.0,
                  "measured_us": 241.7, "default_us": 363.2,
                  "source": "timed"}, ...]}

Environment knobs (all optional):

  REPRO_TUNE_DB      path of the default active DB; unset -> no disk
                     persistence (tests stay hermetic by default)
  REPRO_TUNE_MODE    "timed" (default: race top-N candidates on device),
                     "modeled" (legacy score-only pick), or
                     "frozen" (CI determinism: never race, never write —
                     misses take the modeled pick)

`Cluster` owns a TuneDB handle (constructed from `tune_db=` or the env),
warm-starts KERNEL_TUNES from it on construction (its device's backend
key, its policy's mode), and installs it as the active DB so
`pipeline.autotune` writes new races through.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from pathlib import Path
from typing import Iterator

from repro_torch.configs import registry

SCHEMA_VERSION = 1

TUNE_MODES = ("timed", "modeled", "frozen")

_DB_ENV = "REPRO_TUNE_DB"
_MODE_ENV = "REPRO_TUNE_MODE"


def tune_mode(override: str | None = None) -> str:
    """Resolve the active tuning mode: explicit override > the active
    KernelPolicy's `tuning` field > REPRO_TUNE_MODE > "timed"."""
    if override is not None:
        if override not in TUNE_MODES:
            raise ValueError(f"unknown tune mode {override!r}; "
                             f"expected one of {TUNE_MODES}")
        return override
    from repro_torch.cluster.policy import current_policy
    pol_tuning = getattr(current_policy(), "tuning", "auto")
    if pol_tuning and pol_tuning != "auto":
        return pol_tuning
    mode = os.environ.get(_MODE_ENV, "").strip() or "timed"
    if mode not in TUNE_MODES:
        raise ValueError(f"{_MODE_ENV}={mode!r}: expected one of "
                         f"{TUNE_MODES}")
    return mode


def _record_to_json(rec: registry.KernelTuneRecord, backend: str,
                    mode: str) -> dict:
    return {
        "backend": backend,
        "mode": mode,
        "kernel": rec.kernel,
        "shape_key": rec.shape_key,
        "blocks": [list(kv) for kv in rec.blocks],
        "modeled_seconds": rec.modeled_seconds,
        "default_blocks": [list(kv) for kv in rec.default_blocks],
        "default_modeled_seconds": rec.default_modeled_seconds,
        "saved_bytes": rec.saved_bytes,
        "measured_us": rec.measured_us,
        "default_us": rec.default_us,
        "source": rec.source,
        "route": rec.route,
    }


def _record_from_json(d: dict) -> registry.KernelTuneRecord:
    return registry.KernelTuneRecord(
        kernel=d["kernel"],
        shape_key=d["shape_key"],
        blocks=tuple((str(k), int(v)) for k, v in d["blocks"]),
        modeled_seconds=float(d["modeled_seconds"]),
        default_blocks=tuple((str(k), int(v))
                             for k, v in d.get("default_blocks", ())),
        default_modeled_seconds=float(d.get("default_modeled_seconds", 0.0)),
        saved_bytes=float(d.get("saved_bytes", 0.0)),
        measured_us=float(d.get("measured_us", 0.0)),
        default_us=float(d.get("default_us", 0.0)),
        source=str(d.get("source", "modeled")),
        route=str(d.get("route", "fused")),
    )


class TuneDB:
    """JSON disk cache of timed tune records, keyed by
    (backend, mode, kernel, shape_key) — shape_key already carries dtype.

    `frozen=True` makes the DB read-only: `record()` and `save()` are
    no-ops (counted in `write_skips`), which is the CI-determinism mode.
    A missing, corrupt, or stale-schema file loads as empty (counted in
    `load_errors`) so callers always fall back to cold autotune.
    """

    def __init__(self, path: str | os.PathLike, *, frozen: bool = False):
        self.path = Path(path)
        self.frozen = frozen
        # key -> raw json record dict (kept verbatim so unknown backends'
        # records survive a load/save round-trip untouched)
        self._records: dict[tuple[str, str, str, str], dict] = {}
        self.loads = 0          # records loaded from disk
        self.stores = 0         # records written through
        self.write_skips = 0    # frozen writes refused
        self.load_errors = 0    # corrupt/stale files ignored
        self._load()

    @staticmethod
    def _key(d: dict) -> tuple[str, str, str, str]:
        return (d["backend"], d["mode"], d["kernel"], d["shape_key"])

    def _load(self) -> None:
        if not self.path.exists():
            return
        try:
            raw = json.loads(self.path.read_text())
            if raw.get("version") != SCHEMA_VERSION:
                raise ValueError(f"schema version {raw.get('version')!r}")
            for d in raw["records"]:
                _record_from_json(d)               # validates the shape
                self._records[self._key(d)] = d
            self.loads = len(self._records)
        except Exception:
            # corrupt / stale / truncated DB: start cold, never crash
            self._records = {}
            self.loads = 0
            self.load_errors += 1

    # -- queries --------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._records)

    def get(self, backend: str, mode: str, kernel: str,
            shape_key: str) -> registry.KernelTuneRecord | None:
        d = self._records.get((backend, mode, kernel, shape_key))
        return _record_from_json(d) if d is not None else None

    def records(self, backend: str | None = None,
                mode: str | None = None) -> Iterator[registry.KernelTuneRecord]:
        for (b, m, _, _), d in sorted(self._records.items()):
            if backend is not None and b != backend:
                continue
            if mode is not None and m != mode:
                continue
            yield _record_from_json(d)

    # -- mutation -------------------------------------------------------------
    def record(self, rec: registry.KernelTuneRecord, *, backend: str,
               mode: str, save: bool = True) -> None:
        """Store one tune record and (unless frozen) write the file."""
        if self.frozen:
            self.write_skips += 1
            return
        d = _record_to_json(rec, backend, mode)
        self._records[self._key(d)] = d
        self.stores += 1
        if save:
            self.save()

    def save(self) -> None:
        """Atomic write (tmp + rename) so a killed process never leaves a
        truncated DB for the next run to trip over."""
        if self.frozen:
            self.write_skips += 1
            return
        payload = {"version": SCHEMA_VERSION,
                   "records": [self._records[k]
                               for k in sorted(self._records)]}
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.path.parent,
                                   prefix=self.path.name + ".")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1)
            os.replace(tmp, self.path)
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise

    # -- warm-start -----------------------------------------------------------
    def warm_start(self, *, backend: str, mode: str) -> int:
        """Register every matching record into KERNEL_TUNES (source "db")
        so later `tuned_call`s hit instead of racing. Returns the count.

        In-memory records win: a record already in KERNEL_TUNES for the
        same (kernel, shape_key) — e.g. a fresher race from this process —
        is not overwritten by the disk copy.
        """
        n = 0
        for rec in self.records(backend=backend, mode=mode):
            if registry.get_kernel_tune(rec.kernel, rec.shape_key) is None:
                registry.register_kernel_tune(
                    rec if rec.source == "db" else
                    _dataclass_replace(rec, source="db"))
                n += 1
        return n

    def describe(self) -> dict:
        """JSON-able snapshot for Program.report() / bench records."""
        return {"path": str(self.path), "frozen": self.frozen,
                "entries": len(self._records), "loads": self.loads,
                "stores": self.stores, "write_skips": self.write_skips,
                "load_errors": self.load_errors}


def _dataclass_replace(rec, **kw):
    import dataclasses
    return dataclasses.replace(rec, **kw)


# ----------------------------------------------------------------------------
# The active DB (what pipeline.autotune writes through)
# ----------------------------------------------------------------------------

_UNSET = object()
_ACTIVE: "TuneDB | None | object" = _UNSET


def _env_db() -> TuneDB | None:
    path = os.environ.get(_DB_ENV, "").strip()
    if not path:
        return None
    return TuneDB(path, frozen=tune_mode() == "frozen")


def active_db() -> TuneDB | None:
    """The DB autotune write-through targets: the one installed with
    `set_active_db` (usually by Cluster), else the REPRO_TUNE_DB env one,
    else None (no persistence)."""
    global _ACTIVE
    if _ACTIVE is _UNSET:
        _ACTIVE = _env_db()
    return _ACTIVE  # type: ignore[return-value]


def set_active_db(db: TuneDB | None) -> None:
    global _ACTIVE
    _ACTIVE = db


def reset_active_db() -> None:
    """Forget the cached active DB; next `active_db()` re-reads the env."""
    global _ACTIVE
    _ACTIVE = _UNSET


@contextlib.contextmanager
def use_db(db: TuneDB | None) -> Iterator[TuneDB | None]:
    """Scope `db` as the active write-through target (tests)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = db
    try:
        yield db
    finally:
        _ACTIVE = prev


def resolve_db(spec: "TuneDB | str | os.PathLike | None",
               *, frozen: bool | None = None) -> TuneDB | None:
    """Coerce a Cluster's `tune_db=` argument: a TuneDB passes through, a
    path opens one, None falls back to the env default (which may be
    None too). `frozen` overrides the opened DB's mode."""
    if spec is None:
        db = active_db()
    elif isinstance(spec, TuneDB):
        db = spec
    else:
        db = TuneDB(spec, frozen=tune_mode() == "frozen")
    if db is not None and frozen is not None:
        db.frozen = frozen
    return db
