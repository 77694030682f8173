"""repro_torch's prefill attention schedules against the reference's.

`attention(schedule=...)` for "banded", "folded", "masked" and "auto" on
the same q/k/v (made with numpy), GQA (4 heads on 2 kv heads), at chunk
8: lengths of 2 to 7 chunks (odd counts, where "folded" falls back to
"masked" on both sides), windows shorter than S (banded's band, folded's
fallback) and none, in f32 (within 1e-5: sum order only) and bf16 (within
2e-2: one rounding of p and of the output). The schedule rules ("auto"
takes direct, banded or masked; "folded" takes masked without an even
chunk count or with a window shorter than S) are held to the reference's
by name.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.models import attention as tattn

CHUNK = 8


def _operands(seed, s, dtype, b=2, h=4, kv=2, hd=16):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shp).astype(np.float32)
            for shp in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


CASES = [  # (schedule, S, window)
    ("banded", 24, 8), ("banded", 40, 16), ("banded", 56, 12),
    ("banded", 32, 4),
    ("folded", 32, None), ("folded", 48, None), ("folded", 24, None),
    ("folded", 40, None), ("folded", 32, 16),
    ("masked", 24, 8), ("masked", 40, None),
    ("auto", 24, 16), ("auto", 40, 8), ("auto", 32, None), ("auto", 16, 8),
    ("auto", 20, None)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule,s,window", CASES,
                         ids=[f"{c[0]}-S{c[1]}-w{c[2]}" for c in CASES])
def test_schedule_matches_reference(schedule, s, window, dtype):
    (qj, kj, vj), (qt, kt, vt) = _operands(s, s, dtype)
    kw = dict(n_kv=2, causal=True, window=window, chunk=CHUNK,
              schedule=schedule)
    want = jattn.attention(qj, kj, vj, **kw)
    got = tattn.attention(qt, kt, vt, **kw)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert got.shape == qt.shape and got.dtype == qt.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("s,window", [(24, 8), (40, 16), (48, None)])
def test_chunked_schedules_agree_with_direct(s, window):
    """Banded, folded (or its masked fallback) and masked compute direct
    attention's function (f32, 1e-5)."""
    _, (q, k, v) = _operands(7, s, "float32")
    want = tattn.direct_attention(q, k, v, n_kv=2, window=window)
    for schedule in ("masked", "folded") + (("banded",) if window else ()):
        got = tattn.attention(q, k, v, n_kv=2, window=window, chunk=CHUNK,
                              schedule=schedule)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_folded_equals_masked_bit_for_bit():
    """Folded walks each q chunk's blocks in masked's order and skips
    only blocks above the diagonal, which add exactly nothing."""
    _, (q, k, v) = _operands(8, 48, "float32")
    kw = dict(n_kv=2, chunk=CHUNK)
    assert torch.equal(tattn.attention(q, k, v, schedule="folded", **kw),
                       tattn.attention(q, k, v, schedule="masked", **kw))


def test_unknown_schedule_raises():
    _, (q, k, v) = _operands(9, 24, "float32")
    with pytest.raises(ValueError, match="schedule"):
        tattn.attention(q, k, v, n_kv=2, chunk=CHUNK, schedule="ring")
