"""The pure-Python half of the port's kernel call path, on the CPU: how
axpy passes alpha to its launcher, the lean operand check every wrapper
makes, and the ctypes declarations of every C entry point against the
sources in `csrc/` (a declaration that disagrees with its C function
passes garbage or cuts a pointer; nothing here needs nvcc or a card).
"""

import ctypes
import math
import re
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import axpy, build, dotp

CSRC = Path(build.__file__).resolve().parent / "csrc"
NUMBERS = [1.7, 2, -0.0, 0.0, float("inf"), -float("inf"), float("nan"),
           1e-40, -3e-45, 3.4e38, np.float32(0.1), np.float64(1 / 3)]


def _f32_bits(v: float) -> bytes:
    return struct.pack("<f", v)


@pytest.mark.parametrize("alpha", NUMBERS, ids=repr)
def test_number_alpha_goes_by_value(alpha):
    """A number is passed by value (no tensor, no pointer), and the f32 the
    launcher receives (ctypes rounds it) has the bits of the 1-element f32
    tensor the same number makes: the two forms reach the kernel alike."""
    x = torch.zeros(4)
    ptr, value = axpy.alpha_arg(alpha, x)
    assert ptr is None and type(value) is float
    if math.isnan(float(alpha)):
        assert math.isnan(value)
    else:
        assert value == float(alpha)
        assert math.copysign(1.0, value) == math.copysign(1.0, float(alpha))
    passed = ctypes.c_float(value).value
    as_tensor = torch.tensor(float(alpha), dtype=torch.float32)
    assert _f32_bits(passed) == as_tensor.numpy().tobytes()


def test_number_alpha_declared_by_value():
    """The launchers declare alpha's value as a C float after its pointer."""
    for fn in ("axpy_f32", "axpy_bf16"):
        argtypes, restype = build.SIGNATURES["axpy"][fn]
        assert argtypes[:2] == [ctypes.c_void_p, ctypes.c_float]
        assert restype is ctypes.c_int


@pytest.mark.parametrize("shape", [(), (1,), (1, 1)])
def test_tensor_alpha_goes_by_pointer(shape):
    x = torch.zeros(4)
    alpha = torch.full(shape, 1.5, dtype=torch.float32)
    assert axpy.alpha_arg(alpha, x) == (alpha.data_ptr(), 0.0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16,
                                   torch.float16, torch.int32])
def test_alpha_tensor_of_the_wrong_dtype_raises(dtype):
    with pytest.raises(TypeError):
        axpy.alpha_arg(torch.ones((), dtype=dtype), torch.zeros(4))


@pytest.mark.parametrize("shape", [(2,), (0,), (1, 3)])
def test_alpha_tensor_of_the_wrong_size_raises(shape):
    with pytest.raises(ValueError):
        axpy.alpha_arg(torch.ones(shape), torch.zeros(4))


def _cases():
    """{case: (operands, the error check_operands raises or None)}"""
    base = torch.zeros(64, 8)
    flat = base.view(-1)
    return {
        "fine": ((base, torch.ones(64, 8)), None),
        "bf16": ((base.bfloat16(), base.bfloat16()), None),
        "three": ((base, base, torch.ones(8)), None),
        "dtype_not_taken": ((base.half(), base.half()),
                            (TypeError, "k: the CUDA kernel takes "
                             "torch.float32 or torch.bfloat16, got "
                             "torch.float16")),
        "dtypes_differ": ((base, base.bfloat16()),
                          (TypeError, "k: operands of torch.bfloat16 and "
                           "torch.float32")),
        "not_contiguous": ((base.t(), base.t()),
                           (ValueError, "k: operands must be contiguous")),
        "misaligned": ((flat[1:], flat[1:]),
                       (ValueError, "k: operands must be 32-byte aligned")),
        "second_misaligned": ((flat[:-1], flat[1:]),
                              (ValueError,
                               "k: operands must be 32-byte aligned")),
        "third_not_contiguous": ((base, base, base.t()),
                                 (ValueError,
                                  "k: operands must be contiguous")),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_check_operands_returns_pointers_or_raises(case):
    """Operands that pass come back as their device's index and data
    pointers (one pass); the others raise the error that says what is
    wrong."""
    tensors, error = _cases()[case]
    dtypes = (torch.float32, torch.bfloat16)
    if error is None:
        got = build.check_operands("k", *tensors, dtypes=dtypes)
        assert got == (-1, [t.data_ptr() for t in tensors])
    else:
        with pytest.raises(error[0]) as e:
            build.check_operands("k", *tensors, dtypes=dtypes)
        assert str(e.value) == error[1]


def test_cpu_calls_resolve_no_launcher():
    """CPU tensors go to the plain versions: no library is built or
    loaded for them, so the kept launchers stay as they were."""
    before = (axpy._launchers, dotp._launchers)
    x, y = torch.ones(8, 4), torch.full((8, 4), 2.0)
    assert torch.equal(axpy.axpy(3.0, x, y), torch.full((8, 4), 5.0))
    assert torch.equal(axpy.axpy(torch.tensor(3.0), x, y),
                       torch.full((8, 4), 5.0))
    assert dotp.dotp(x, y).item() == 64.0
    assert (axpy._launchers, dotp._launchers) == before


C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
           "size_t": ctypes.c_size_t}


def _c_declaration(fn: str) -> tuple[list, object]:
    """(argtypes, restype) of `extern "C" <ret> fn(...)` in csrc."""
    for src in sorted(CSRC.glob("*.cu*")):
        m = re.search(r'extern\s+"C"\s+([\w\s\*]+?)\s*\b' + fn +
                      r"\s*\(([^)]*)\)", src.read_text())
        if m:
            def kind(decl):
                if "*" in decl:
                    return ctypes.c_void_p
                return C_TYPES[decl.replace("const", "").split()[0]]
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            ret = m.group(1).strip()
            return ([kind(p) for p in params],
                    ctypes.c_char_p if "char" in ret else kind(ret))
    raise AssertionError(f"no extern \"C\" {fn} in {CSRC}")


@pytest.mark.parametrize("lib,fn", [(lib, fn)
                                    for lib, fns in build.SIGNATURES.items()
                                    for fn in fns])
def test_ctypes_declarations_match_the_c_functions(lib, fn):
    argtypes, restype = build.SIGNATURES[lib][fn]
    assert _c_declaration(fn) == (argtypes, restype)
