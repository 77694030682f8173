"""repro_torch's Table 1 kernel suite against the reference Pallas kernels.

The same seeded numpy inputs go through `repro.kernels.ops` under the
"interpret" policy (the Pallas kernels, interpreted on the CPU) and
through `repro_torch.kernels.ops` under the default policy, whose
wrappers run their plain PyTorch versions on CPU tensors — the arithmetic
the CUDA kernels implement (`test_torch_cuda.py` holds the kernels to
those plain versions on a GPU).

Tolerances: f32 1e-5 elementwise (sum order only); matmul 1e-4 * sqrt(K)
absolute (a K-long f32 sum in another order; the CUDA kernel's 3xTF32
route, emulated by `ref.matmul_tf32x3`, is held to the same and to twice
the f32 product's error against f64); dotp 1e-5 relative to
sum|x*y| (the same, over every element); bf16 2e-2 (sum order can flip
one output rounding).
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster.policy import use_policy as juse
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.cluster.policy import use_policy
from repro_torch.kernels import launches, ops, ref

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str = "float32"):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    return (jnp.asarray(a).astype(JDT[dtype]),
            torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dtype]))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _normal(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ----------------------------------------------------------------------------
# each kernel: the port's plain version vs the Pallas kernel
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (128, 96, 40),
                                   (24, 200, 72),
                                   # M > 16, no edge a multiple of a tile
                                   (40, 80, 40), (130, 200, 200)])
def test_matmul_matches_pallas(dtype, m, k, n):
    aj, at = _pair(_normal(m, m, k), dtype)
    bj, bt = _pair(_normal(k, k, n), dtype)
    with juse("interpret"):
        want = jops.matmul(aj, bj)
    got = ops.matmul(at, bt)
    assert got.dtype == TDT[dtype] and got.shape == (m, n)
    tol = (dict(rtol=0.0, atol=1e-4 * k ** 0.5) if dtype == "float32"
           else TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(want), **tol)


MATMUL_SHAPES = [(64, 64, 64), (128, 96, 40), (24, 200, 72), (40, 80, 40),
                 (130, 200, 200)]


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
def test_matmul_tf32x3_emulation_matches_pallas(m, k, n):
    """The arithmetic of the f32 kernel's tensor-core route (three TF32
    products of split operands, `ref.matmul_tf32x3`) against the Pallas
    kernel, to the suite's f32 matmul tolerance 1e-4 * sqrt(K)."""
    aj, at = _pair(_normal(m, m, k))
    bj, bt = _pair(_normal(k, k, n))
    with juse("interpret"):
        want = jops.matmul(aj, bj)
    got = ref.matmul_tf32x3(at, bt)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0.0,
                               atol=1e-4 * k ** 0.5)


def _err64(got, a, b):
    want = a.double() @ b.double()
    return (got.double() - want).abs().max().item()


def test_matmul_tf32x3_is_as_accurate_as_f32_at_k4096():
    """Against an f64 product, the 3xTF32 emulation's error is at most
    twice the f32 product's at K = 4096 (unit normal operands)."""
    a = torch.from_numpy(_normal(21, 64, 4096))
    b = torch.from_numpy(_normal(22, 4096, 48))
    f32 = _err64(ref.matmul(a, b), a, b)
    assert 0 < _err64(ref.matmul_tf32x3(a, b), a, b) <= 2 * f32


def test_one_tf32_product_fails_the_f32_tolerances_at_k4096():
    """One TF32 product (hi_a.hi_b alone) misses both checks the f32
    route is held to, so they can fail: 1e-4 * sqrt(K) against the plain
    version, and twice the f32 product's error against f64."""
    k = 4096
    a = torch.from_numpy(_normal(23, 64, k))
    b = torch.from_numpy(_normal(24, k, 48))
    one = ref.matmul_tf32x3(a, b, passes=1)
    assert (one - ref.matmul(a, b)).abs().max().item() > 1e-4 * k ** 0.5
    assert _err64(one, a, b) > 2 * _err64(ref.matmul(a, b), a, b)


def test_tf32_rounds_to_nearest_with_ties_away():
    """`ref.tf32_rna` keeps 10 mantissa bits like cvt.rna.tf32.f32: below
    half an ulp (2^-10 at 1) down, at half away from zero, above up; the
    split's parts sum back to x within 2^-22 |x|."""
    u = 2.0 ** -10
    x = torch.tensor([1 + 0.49 * u, 1 + 0.5 * u, -(1 + 0.5 * u),
                      1 + 1.5 * u, 1 + 0.51 * u, 3.0, -0.0])
    want = [1.0, 1 + u, -(1 + u), 1 + 2 * u, 1 + u, 3.0, -0.0]
    assert ref.tf32_rna(x).tolist() == want
    v = torch.from_numpy(_normal(25, 4096))
    hi = ref.tf32_rna(v)
    lo = ref.tf32_rna(v - hi)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((v.double() - hi.double() - lo.double()).abs()
            <= 2.0 ** -22 * v.double().abs()).all()


def _nonfinite_operands(seed: int, m: int, k: int, n: int):
    """Unit normal (m, k) and (k, n) f32 operands with +-inf, NaN, FLT_MAX
    and 3.4e38 entries: inf against a b value TF32 holds exactly (1.0, so
    its lo part is 0) and against 0.0 (NaN in f32), inf against inf of
    either sign, NaN, and the two largest values against b rows of 0.25
    (a finite 1e38-size output) and 2.0 (inf in f32)."""
    a, b = _normal(seed, m, k), _normal(seed + 1, k, n)
    big = np.resize(np.float32([0.25, 2.0, -0.5, -3.0]), n)
    a[0, 3], b[3, 0], b[3, 1] = np.inf, 1.0, 0.0
    a[1, 5] = -np.inf
    a[2, 7] = np.nan
    b[9, 2], a[3, 9] = np.inf, -np.inf
    a[4, 11], b[11] = np.finfo(np.float32).max, big
    a[5, 13], b[13] = 3.4e38, big
    return a, b


def test_tf32_split_keeps_inf_nan_and_the_largest_values():
    """`ref.tf32_split` as the kernel splits: a finite x keeps finite
    parts that sum back to it within 2^-22 |x|, also where TF32 rounding
    would pass FLT_MAX; inf and NaN become (+-1, x)."""
    fmax = float(np.finfo(np.float32).max)
    x = torch.tensor([fmax, -fmax, 3.4e38, 1.0, -2.5e-3])
    hi, lo = ref.tf32_split(x)
    assert torch.isfinite(hi).all() and torch.isfinite(lo).all()
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((x.double() - hi.double() - lo.double()).abs()
            <= 2.0 ** -22 * x.double().abs()).all()
    assert not torch.isfinite(ref.tf32_rna(torch.tensor([fmax]))).any()
    y = torch.tensor([float("inf"), -float("inf"), float("nan")])
    hi, lo = ref.tf32_split(y)
    assert hi.tolist() == [1.0, -1.0, 1.0]
    assert torch.equal(lo[:2], y[:2]) and lo[2].isnan()


def test_matmul_tf32x3_emulation_keeps_inf_and_nan_like_f32():
    """With +-inf, NaN and near-FLT_MAX entries the 3xTF32 arithmetic
    gives the f32 product's NaNs and infs (with their signs), and its
    finite outputs within 1e-4 * sqrt(K), or 1e-5 relative for the
    1e38-size ones, of the plain version and of the Pallas kernel."""
    m, k, n = 40, 80, 40
    a, b = _nonfinite_operands(26, m, k, n)
    aj, at = _pair(a)
    bj, bt = _pair(b)
    with juse("interpret"):
        pallas = torch.from_numpy(np.array(_np(jops.matmul(aj, bj))))
    plain = ref.matmul(at, bt)
    assert plain.isnan().any() and (plain == float("inf")).any()
    assert (plain == -float("inf")).any()
    assert (plain[torch.isfinite(plain)].abs() > 1e37).any()
    got = ref.matmul_tf32x3(at, bt)
    for want in (plain, pallas):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-4 * k ** 0.5, equal_nan=True)


def test_inf_times_tiny_subnormal_is_the_references_nan():
    """inf times an f32 subnormal below 2^-137 (2^-140): XLA's CPU flushes
    the subnormal to 0, so the JAX package's f32 products give NaN
    (`jnp.dot` at every precision, `ops.matmul` on its plain route and
    through the Pallas kernel); the card's 3xTF32 route rounds it to 0 in
    TF32 and gives NaN as well (`ref.matmul_tf32x3` here, the card test
    `test_cuda_matmul_f32_inf_times_tiny_subnormal_is_nan`). The port's
    CPU plain product is torch's f32 product, which keeps subnormals:
    inf. Recorded behaviour: the card's route matches the reference."""
    a = np.full((4, 8), np.inf, np.float32)
    b = np.full((8, 4), 2.0 ** -140, np.float32)
    assert b[0, 0] != 0
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    for precision in (None, "highest"):
        assert np.isnan(_np(jnp.dot(aj, bj, precision=precision))).all()
    assert np.isnan(_np(jops.matmul(aj, bj))).all()
    with juse("interpret"):
        assert np.isnan(_np(jops.matmul(aj, bj))).all()
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    assert ref.matmul_tf32x3(at, bt).isnan().all()
    assert (ref.matmul(at, bt) == float("inf")).all()
    with use_policy("tuned"):
        assert (ops.matmul(at, bt) == float("inf")).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("alpha_kind", ["float", "tensor"])
def test_axpy_matches_pallas(dtype, alpha_kind):
    xj, xt = _pair(_normal(1, 96, 128), dtype)
    yj, yt = _pair(_normal(2, 96, 128), dtype)
    with juse("interpret"):
        want = jops.axpy(1.7, xj, yj)
    alpha = 1.7 if alpha_kind == "float" else torch.tensor(1.7)
    got = ops.axpy(alpha, xt, yt)
    assert got.dtype == TDT[dtype] and got.shape == (96, 128)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("shape", [(64, 128), (200, 48)])
def test_dotp_matches_pallas(shape):
    xj, xt = _pair(_normal(3, *shape))
    yj, yt = _pair(_normal(4, *shape))
    with juse("interpret"):
        want = float(jops.dotp(xj, yj))
    got = ops.dotp(xt, yt)
    assert got.shape == () and got.dtype == torch.float32
    scale = float(np.sum(np.abs(_np(xt) * _np(yt))))
    assert abs(float(got) - want) <= 1e-5 * scale


@pytest.mark.parametrize("h,w,block_rows", [(64, 48, 16), (96, 128, 32),
                                            (40, 24, 8)])
def test_conv2d_matches_pallas_across_row_blocks(h, w, block_rows):
    """The Pallas kernel takes its halo rows from the neighbour row
    blocks; with blocks smaller than H the result must still be the
    zero-padded correlation at every block boundary."""
    xj, xt = _pair(_normal(5, h, w))
    wj, wt = _pair(_normal(6, 3, 3))
    with juse("interpret"):
        want = jops.conv2d_3x3(xj, wj, block_rows=block_rows)
    got = ops.conv2d_3x3(xt, wt, block_rows=block_rows)
    assert got.shape == (h, w)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    np.testing.assert_allclose(_np(got), _np(jref.conv2d_3x3(xj, wj)),
                               **TOL["float32"])


@pytest.mark.parametrize("n", [64, 200])
def test_dct8x8_matches_pallas_and_keeps_energy(n):
    xj, xt = _pair(_normal(7, n, 8, 8))
    with juse("interpret"):
        want = jops.dct8x8(xj)
    got = ops.dct8x8(xt)
    assert got.shape == (n, 8, 8)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    # an orthonormal transform keeps each block's energy
    np.testing.assert_allclose((got ** 2).sum((1, 2)).numpy(),
                               (xt ** 2).sum((1, 2)).numpy(), rtol=1e-5)


def test_dct_matrix_equals_the_reference():
    np.testing.assert_array_equal(ref.dct_matrix(8), jref.dct_matrix(8))
    c = ref.dct_matrix(8).astype(np.float64)
    np.testing.assert_allclose(c @ c.T, np.eye(8), atol=1e-6)


# ----------------------------------------------------------------------------
# the descriptor table and the block arguments
# ----------------------------------------------------------------------------


def _operands(name):
    """Small operands for each ported kernel, as (jax, torch) tuples."""
    r = lambda seed, *shape: _pair(_normal(seed, *shape))   # noqa: E731
    table = {
        "axpy": [(2.0, 2.0), r(1, 16, 8), r(2, 16, 8)],
        "dotp": [r(3, 16, 8), r(4, 16, 8)],
        "matmul": [r(5, 16, 24), r(6, 24, 8)],
        "conv2d": [r(7, 12, 20), r(8, 3, 3)],
        "dct8x8": [r(9, 5, 8, 8)],
        "rmsnorm_matmul": [r(10, 4, 16), r(11, 16), r(12, 16, 8)],
        "matmul_residual_add": [r(13, 4, 16), r(14, 16, 8), r(15, 4, 8)],
        "flash_attention_proj": [r(16, 1, 4, 6, 16), r(17, 1, 2, 6, 16),
                                 r(18, 1, 2, 6, 16), r(19, 4, 16, 32)],
    }
    ops_ = table[name]
    return tuple(o[0] for o in ops_), tuple(o[1] for o in ops_)


@pytest.mark.parametrize("name", ["axpy", "dotp", "matmul", "conv2d",
                                  "dct8x8", "rmsnorm_matmul",
                                  "matmul_residual_add",
                                  "flash_attention_proj"])
def test_kernel_shapes_equal_the_reference(name):
    jargs, targs = _operands(name)
    assert ops.kernel_shapes(name, *targs) == jops.kernel_shapes(name, *jargs)
    assert ops.OPS[name].fused == jops.OPS[name].fused
    assert (ops.OPS[name].streamed_operand
            == jops.OPS[name].streamed_operand)
    made = ops.OPS[name].operands(ops.kernel_shapes(name, *targs),
                                  torch.float32, device="cpu")
    assert ops.kernel_shapes(name, *made) == ops.kernel_shapes(name, *targs)


@pytest.mark.parametrize("name,kwargs", [
    ("matmul", dict(bm=6)), ("matmul", dict(bk=20)),
    ("axpy", dict(block_rows=6)), ("dotp", dict(block_rows=12)),
    ("conv2d", dict(block_rows=7)), ("dct8x8", dict(block_n=2))])
def test_non_divisor_block_raises_in_both(name, kwargs):
    jargs, targs = _operands(name)
    with juse("interpret"), pytest.raises(ValueError):
        jops.wrapper_for(name)(*jargs, **kwargs)
    with pytest.raises(ValueError):
        ops.wrapper_for(name)(*targs, **kwargs)


def test_divisor_and_oversized_blocks_pass():
    jargs, targs = _operands("matmul")
    got = ops.matmul(*targs, bm=8, bn=8, bk=4096)    # bk capped at K
    with juse("interpret"):
        want = jops.matmul(*jargs, bm=8, bn=8, bk=4096)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-3)


@pytest.mark.parametrize("mode,key", [("reference", "ref_calls"),
                                      ("interpret", "plain_calls"),
                                      ("tuned", "kernel_calls")])
def test_policy_routes_and_counts(mode, key):
    """Each mode takes its route, bumps its counter, and agrees with the
    reference package under the same mode; on CPU tensors nothing
    launches."""
    names = ("axpy", "dotp", "matmul", "conv2d", "dct8x8")
    launches.reset_counts()
    with use_policy(mode) as pol:
        got = {n: ops.wrapper_for(n)(*_operands(n)[1]) for n in names}
    assert pol.stats == {key: len(names)}
    jmode = "interpret" if mode == "tuned" else mode
    with juse(jmode):
        want = {n: jops.wrapper_for(n)(*_operands(n)[0]) for n in names}
    for n in names:
        np.testing.assert_allclose(_np(got[n]), _np(want[n]), rtol=1e-5,
                                   atol=1e-4)
    assert all(c == {"launches": 0, "plain_cuda_calls": 0}
               for c in launches.counts().values())
