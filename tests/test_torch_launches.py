"""The profiler names that `launches.ENTRY_KERNELS` counts each wrapper's
launches by, against the `__global__` kernels the CUDA sources define.

A trace counts a launch for wrapper A when a device kernel's name holds
one of A's patterns. So every pattern must name a kernel that A's source
can launch, and none may hold for a kernel or a pattern of another
wrapper: `hgemm::tile_kernel<false,0>` would count as
`gemm::tile_kernel<false,0>`'s. The sources are read as text (comments
and strings stripped, namespaces followed by their braces); nothing is
compiled, so this runs without nvcc.
"""

import re
from pathlib import Path

import pytest

from repro_torch.kernels import build, launches

CSRC = Path(build.__file__).resolve().parent / "csrc"
WRAPPERS = sorted(launches.ENTRY_KERNELS)

# common.cuh's `launch_matmul<NORM, EPI>` instantiates these kernels
LAUNCH_MATMUL = ("gemm::tile_kernel<{n},{e}>", "skinny::partial_kernel<{n},{e}>",
                 "skinny::finish_kernel<{e}>")


def _strip(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    return re.sub(r'"(?:\\.|[^"\\])*"', '""', text)


def kernels_of(path: Path) -> list[tuple[str, bool]]:
    """(qualified name, is a template) of every `__global__` function in
    one source; anonymous namespaces add nothing to the name."""
    text = _strip(path.read_text())
    out, scopes = [], []
    for m in re.finditer(r"namespace\s*(\w*)\s*\{|\{|\}|__global__", text):
        tok = m.group(0)
        if tok.startswith("namespace"):
            scopes.append(m.group(1))
        elif tok == "{":
            scopes.append(None)
        elif tok == "}":
            scopes.pop()
        else:
            rest = re.sub(r"__launch_bounds__\s*\([^)]*\)", " ",
                          text[m.end():m.end() + 400])
            name = re.search(r"void\s+(\w+)\s*\(", rest).group(1)
            templ = re.search(r"template\s*<[^;{}]*>\s*$",
                              text[max(0, m.start() - 200):m.start()])
            ns = [s for s in scopes if s]
            out.append(("::".join(ns + [name]), templ is not None))
    return out


def includes_of(path: Path) -> set[Path]:
    """`path` and every header of csrc it includes, transitively."""
    seen, todo = set(), [path]
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        todo += [CSRC / h for h in re.findall(r'#include "([^"]+)"',
                                              p.read_text())
                 if (CSRC / h).exists()]
    return seen


def epi_codes() -> dict:
    enum = re.search(r"enum\s*:\s*int\s*\{([^}]*)\}",
                     _strip((CSRC / "common.cuh").read_text())).group(1)
    return {k: v for k, v in re.findall(r"(\w+)\s*=\s*(\d+)", enum)}


def owned(wrapper: str) -> tuple[set, set]:
    """(the base names of every kernel the wrapper's source can reach, the
    instantiated names of its `launch_matmul` calls)."""
    src = CSRC / f"{wrapper}.cu"
    bases = {name for p in includes_of(src) for name, _ in kernels_of(p)}
    codes = epi_codes()
    insts = set()
    for norm, epi in re.findall(r"launch_matmul<\s*(true|false)\s*,\s*(\w+)\s*>",
                                _strip(src.read_text())):
        insts |= {f.format(n=norm, e=codes[epi]) for f in LAUNCH_MATMUL}
    return bases, insts


def _split(pattern: str) -> tuple[str, str | None]:
    """'gemm::tile_kernel<true,0>' -> ('gemm::tile_kernel', 'true,0');
    'rmsnorm_kernel<' -> ('rmsnorm_kernel', ''); no '<' -> (name, None)."""
    if "<" not in pattern:
        return pattern, None
    base, args = pattern.split("<", 1)
    return base, args.rstrip(">")


def test_every_wrapper_has_a_source_and_a_pattern():
    assert set(WRAPPERS) == set(launches.WRAPPERS) == set(build.SOURCES)
    for name in WRAPPERS:
        assert (CSRC / f"{name}.cu").exists(), name
        assert launches.ENTRY_KERNELS[name], name


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_each_pattern_names_a_kernel_of_its_wrapper(wrapper):
    bases, insts = owned(wrapper)
    for pattern in launches.ENTRY_KERNELS[wrapper]:
        base, args = _split(pattern)
        assert any(base in b for b in bases), (pattern, sorted(bases))
        if args:                        # an instantiation it launches
            assert pattern in insts, (pattern, sorted(insts))


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_no_pattern_holds_for_another_wrappers_kernel(wrapper):
    for other in WRAPPERS:
        if other == wrapper:
            continue
        bases, insts = owned(other)
        for pattern in launches.ENTRY_KERNELS[wrapper]:
            base, args = _split(pattern)
            for b in bases:
                if base not in b:
                    continue
                # only the same shared template may hold the base, and then
                # the other wrapper must not launch this instantiation
                assert b == base and args, (pattern, other, b)
                assert pattern not in insts, (pattern, other)
            for theirs in launches.ENTRY_KERNELS[other]:
                assert pattern not in theirs, (pattern, other, theirs)


def test_the_shared_wgmma_mainloop_is_counted_for_no_wrapper():
    """rmsnorm_matmul and flash_attention_proj both launch
    `hopper::tma_wgmma_kernel`; each is counted by the kernel that opens
    its call, so no pattern may hold for the mainloop."""
    kernels = dict(kernels_of(CSRC / "wgmma_gemm.cuh"))
    assert kernels == {"hopper::tma_wgmma_kernel": True}
    for wrapper in ("rmsnorm_matmul", "flash_attention_proj"):
        assert CSRC / "wgmma_gemm.cuh" in includes_of(CSRC / f"{wrapper}.cu")
    for patterns in launches.ENTRY_KERNELS.values():
        for p in patterns:
            assert _split(p)[0] not in "hopper::tma_wgmma_kernel", p


def test_the_parser_reads_namespaces_and_templates():
    common = dict(kernels_of(CSRC / "common.cuh"))
    assert common == {"gemm::tile_kernel": True,
                      "skinny::partial_kernel": True,
                      "skinny::finish_kernel": True}
    assert dict(kernels_of(CSRC / "flash_attention_proj.cu")) == {
        "fa_proj_heads_kernel": False}
    assert owned("matmul_bias_act")[1] >= {"gemm::tile_kernel<false,3>",
                                           "skinny::finish_kernel<4>"}
