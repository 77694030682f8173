"""The profiler names that `launches.ENTRY_KERNELS` counts each wrapper's
launches by, against the `__global__` kernels the CUDA sources define
and the template instantiations their `launch_matmul<NORM, EPI>` and
`hopper::launch<EPI, OWNER>` calls make.

A trace counts a launch for wrapper A when a device kernel's name holds
one of A's patterns. So every pattern must name a kernel that A's source
can launch, and none may hold for a kernel or a pattern of another
wrapper: `hgemm::tile_kernel<false,0>` would count as
`gemm::tile_kernel<false,0>`'s. The sources are read as text (comments
and strings stripped, namespaces followed by their braces); nothing is
compiled, so this runs without nvcc.
"""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import re
from pathlib import Path

import pytest

from repro_torch.kernels import build, launches

CSRC = Path(build.__file__).resolve().parent / "csrc"
WRAPPERS = sorted(launches.ENTRY_KERNELS)

# decode_gemm.cuh's `launch_matmul<NORM, EPI>` instantiates these kernels:
# the decode kernel (M <= 16, K and N % 8 == 0), common.cuh's split-K pair
# (other M <= 16) and its wmma tile
LAUNCH_MATMUL = ("decode::tma_gemv_kernel<{n},{e}>",
                 "gemm::tile_kernel<{n},{e}>",
                 "skinny::partial_kernel<{n},{e}>",
                 "skinny::finish_kernel<{e}>")
# wgmma_gemm.cuh's `hopper::launch<EPI, OWNER>`, one per N tile
MAINLOOP = "hopper::tma_wgmma_kernel<{bn},{e},{o}>"


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


def enum_codes(header: str) -> dict:
    """{name: value} of every `enum : int { ... }` in a csrc header."""
    text = _strip((CSRC / header).read_text())
    return {k: v for body in re.findall(r"enum\s*:\s*int\s*\{([^}]*)\}", text)
            for k, v in re.findall(r"(\w+)\s*=\s*(\d+)", body)}


def epi_codes() -> dict:
    return enum_codes("common.cuh")


def tile_n() -> tuple:
    """`hopper::TILE_N`, the mainloop's N tiles."""
    body = re.search(r"TILE_N\[\]\s*=\s*\{([^}]*)\}",
                     _strip((CSRC / "wgmma_gemm.cuh").read_text())).group(1)
    return tuple(int(v) for v in re.findall(r"\d+", body))


def mainloop_calls(wrapper: str) -> list[tuple[str, str]]:
    """(EPI code, OWNER code) of every `hopper::launch<EPI, OWNER>` call in
    the wrapper's source."""
    codes = epi_codes() | enum_codes("wgmma_gemm.cuh")
    calls = re.findall(r"hopper::launch<\s*(\w+)\s*,\s*(?:hopper::)?(\w+)\s*>",
                       _strip((CSRC / f"{wrapper}.cu").read_text()))
    return [(codes[epi], codes[owner]) for epi, owner in calls]


def owned(wrapper: str) -> tuple[set, set]:
    """(the base names of every kernel the wrapper's source can reach, the
    instantiated names of its `launch_matmul` and `hopper::launch`
    calls)."""
    src = CSRC / f"{wrapper}.cu"
    bases = {name for p in includes_of(src) for name, _ in kernels_of(p)}
    codes = epi_codes()
    insts = set()
    for norm, epi in re.findall(r"launch_matmul<\s*(true|false)\s*,\s*(\w+)\s*>",
                                _strip(src.read_text())):
        insts |= {f.format(n=norm, e=codes[epi]) for f in LAUNCH_MATMUL}
    for epi, owner in mainloop_calls(wrapper):
        insts |= {MAINLOOP.format(bn=bn, e=epi, o=owner) for bn in tile_n()}
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


MAINLOOP_WRAPPERS = ("rmsnorm_matmul", "flash_attention_proj", "matmul",
                     "matmul_residual_add", "matmul_bias_act")


def test_each_mainloop_instantiation_is_launched_by_one_wrapper():
    """Five wrappers launch `hopper::tma_wgmma_kernel`, each under an OWNER
    of its own. Every instantiation a pattern names is launched by exactly
    one wrapper's source: the wrapper whose pattern it is."""
    kernels = dict(kernels_of(CSRC / "wgmma_gemm.cuh"))
    assert kernels == {"hopper::tma_wgmma_kernel": True}
    insts = {w: owned(w)[1] for w in WRAPPERS}
    named = 0
    for wrapper, patterns in launches.ENTRY_KERNELS.items():
        for p in patterns:
            if _split(p)[0] != "hopper::tma_wgmma_kernel":
                continue
            named += 1
            assert [w for w in WRAPPERS if p in insts[w]] == [wrapper], p
    # matmul, matmul_residual_add, and matmul_bias_act's three activations
    assert named == len(launches.TILE_N) * 5


def test_each_mainloop_caller_has_an_owner_of_its_own():
    """The OWNER codes of csrc/wgmma_gemm.cuh are the ones launches.py
    names, each wrapper's calls use its own, and launches.TILE_N is the
    header's TILE_N."""
    owners = {k: int(v) for k, v in enum_codes("wgmma_gemm.cuh").items()
              if k.startswith("OWNER_")}
    assert {f"OWNER_{w.upper()}": c
            for w, c in launches.MAINLOOP_OWNER.items()} == owners
    assert tuple(launches.TILE_N) == tile_n()
    for wrapper in WRAPPERS:
        calls = mainloop_calls(wrapper)
        if wrapper not in MAINLOOP_WRAPPERS:
            assert calls == [], wrapper
            continue
        assert CSRC / "wgmma_gemm.cuh" in includes_of(CSRC / f"{wrapper}.cu")
        assert calls and {int(o) for _, o in calls} == {
            launches.MAINLOOP_OWNER[wrapper]}, (wrapper, calls)


def test_rmsnorm_matmul_and_fa_proj_are_counted_by_their_opening_kernel():
    """Their mainloop follows a kernel of their own in the same call; a
    pattern for both would count each call twice."""
    for wrapper in ("rmsnorm_matmul", "flash_attention_proj"):
        bases, insts = owned(wrapper)
        mainloop = {i for i in insts if i.startswith("hopper::")}
        assert len(mainloop) == len(launches.TILE_N), wrapper
        for p in launches.ENTRY_KERNELS[wrapper]:
            assert _split(p)[0] != "hopper::tma_wgmma_kernel", p


def test_the_parser_reads_namespaces_and_templates():
    common = dict(kernels_of(CSRC / "common.cuh"))
    assert common == {"gemm::tile_kernel": True,
                      "skinny::partial_kernel": True,
                      "skinny::finish_kernel": True}
    assert dict(kernels_of(CSRC / "decode_gemm.cuh")) == {
        "decode::tma_gemv_kernel": True}
    assert dict(kernels_of(CSRC / "flash_attention_proj.cu")) == {
        "fa_proj_heads_kernel": False}
    assert owned("matmul_bias_act")[1] >= {"gemm::tile_kernel<false,3>",
                                           "skinny::finish_kernel<4>",
                                           "decode::tma_gemv_kernel<false,4>"}
    assert owned("rmsnorm_matmul")[1] >= {"decode::tma_gemv_kernel<true,0>"}
    assert owned("matmul_residual_add")[1] >= {
        "hopper::tma_wgmma_kernel<160,1,3>", "gemm::tile_kernel<false,1>"}


def test_matmul_bias_act_launches_the_mainloop_under_owner_4():
    """Every `hopper::launch<>` of matmul_bias_act.cu names OWNER 4, one
    call an activation (bias, bias + gelu, bias + silu), and launches.py
    counts it so."""
    codes = enum_codes("wgmma_gemm.cuh")
    assert codes["OWNER_MATMUL_BIAS_ACT"] == "4"
    assert launches.MAINLOOP_OWNER["matmul_bias_act"] == 4
    epi = epi_codes()
    assert sorted(mainloop_calls("matmul_bias_act")) == [
        (epi["EPI_BIAS"], "4"), (epi["EPI_BIAS_GELU"], "4"),
        (epi["EPI_BIAS_SILU"], "4")]


@pytest.mark.parametrize("epi", (2, 3, 4))
@pytest.mark.parametrize("bn", launches.TILE_N)
def test_owner_4_instantiations_count_as_matmul_bias_act_only(bn, epi):
    """A trace's `tma_wgmma_kernel<BN,EPI,4>` (as `traced_launches` matches
    it, by substring) counts for matmul_bias_act and for no other
    wrapper."""
    name = f"hopper::tma_wgmma_kernel<{bn},{epi},4>"
    matched = [w for w, patterns in launches.ENTRY_KERNELS.items()
               if any(p in name for p in patterns)]
    assert matched == ["matmul_bias_act"], (name, matched)
    assert name in owned("matmul_bias_act")[1]


@pytest.mark.parametrize("wrapper,kernel", [
    ("flash_attention", "flash_attention_kernel"),
    ("flash_attention_proj", "fa_proj_heads_kernel")])
def test_the_attention_kernels_run_the_hopper_core(wrapper, kernel):
    """Both attention kernels keep their names (and so their patterns) and
    run attention.cuh's core, which reaches the mainloop's TMA and wgmma
    pieces and defines no kernel of its own."""
    src = CSRC / f"{wrapper}.cu"
    assert {CSRC / "attention.cuh", CSRC / "wgmma_gemm.cuh"} <= includes_of(
        src)
    assert kernels_of(CSRC / "attention.cuh") == []
    (name, templ), = kernels_of(src)
    assert name == kernel
    assert "attn::attend<" in _strip(src.read_text())
    shown = f"{kernel}<128>" if templ else kernel    # as a trace names it
    traced = [w for w, patterns in launches.ENTRY_KERNELS.items()
              if any(p in shown for p in patterns)]
    assert traced == [wrapper]


DECODE_WRAPPERS = ("rmsnorm_matmul", "matmul_residual_add", "matmul",
                   "matmul_bias_act")


@pytest.mark.parametrize("wrapper", DECODE_WRAPPERS)
def test_each_decode_instantiation_counts_for_its_wrapper_only(wrapper):
    """The four GEMM wrappers run their M <= 16 products on
    `decode::tma_gemv_kernel<NORM,EPI>` (decode_gemm.cuh), each with flags
    of its own: every instantiation the wrapper's source makes is named by
    exactly one pattern of its own, and a trace's name of it (as
    `traced_launches` matches it, by substring) counts for this wrapper
    and no other."""
    assert CSRC / "decode_gemm.cuh" in includes_of(CSRC / f"{wrapper}.cu")
    insts = sorted(i for i in owned(wrapper)[1]
                   if i.startswith("decode::tma_gemv_kernel<"))
    assert insts, wrapper
    for inst in insts:
        mine = [p for p in launches.ENTRY_KERNELS[wrapper] if p in inst]
        assert mine == [inst], (inst, mine)
        shown = inst.replace(",", ", ") + "(CUtensorMap_st, decode::Args)"
        key = shown.replace(" ", "")
        matched = [w for w, patterns in launches.ENTRY_KERNELS.items()
                   if any(p in key for p in patterns)]
        assert matched == [wrapper], (inst, matched)
    want = {"rmsnorm_matmul": 1, "matmul_residual_add": 1, "matmul": 1,
            "matmul_bias_act": 3}[wrapper]
    assert len(insts) == want, insts


@pytest.mark.parametrize("name", sorted(launches.ENTRY_KERNELS))
def test_launch_counts_credit_each_entry_kernel_to_its_wrapper(name):
    """`launch_counts` (the raw-record count of a long trace) credits a
    run of each of a wrapper's entry kernels to that wrapper alone, as
    `traced_launches` does; kernels of no wrapper count nowhere."""
    kernels = {f"void {k.rstrip('<')}<128, 1>(float const*)" if k.endswith("<")
               else f"void {k}(float const*)": 2
               for k in launches.ENTRY_KERNELS[name]}
    kernels["void at::native::vectorized_elementwise_kernel<4>()"] = 5
    got = launches.launch_counts(kernels)
    assert got[name] == 2 * len(launches.ENTRY_KERNELS[name])
    assert all(v == 0 for k, v in got.items() if k != name)
