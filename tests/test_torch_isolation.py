"""repro_torch stands alone: no jax, no repro, no CUDA tooling at import.

* an AST scan of every module of `src/repro_torch/`, of `chip_smoke.py`,
  `examples/serve_chaos_torch.py` and `examples/train_lm_torch.py` finds
  no import of `jax`,
  `repro` or `ml_dtypes` (or their submodules; the GPU machine has no
  `ml_dtypes`);
* importing `repro_torch` in a fresh interpreter leaves `jax` out of
  `sys.modules`;
* importing it works with no `nvcc` on the PATH and `triton` blocked.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "serve_chaos_torch.py",
    ROOT / "examples" / "train_lm_torch.py"]
BANNED = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imports(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    assert path.exists(), path
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _run(code: str, env_extra=None) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_leaves_jax_out():
    r = _run("import sys, repro_torch, repro_torch.kernels.ops, "
             "repro_torch.runtime, repro_torch.weights, "
             "repro_torch.kernels.flash_attention, "
             "repro_torch.kernels.rmsnorm\n"
             "import repro_torch.cluster.session\n"
             "import repro_torch.runtime.faults, repro_torch.runtime.journal\n"
             "import repro_torch.checkpoint.manager\n"
             "import repro_torch.data, repro_torch.optim\n"
             "import repro_torch.runtime.train_loop\n"
             "import repro_torch.launch.train\n"
             "assert 'jax' not in sys.modules, 'jax imported'\n"
             "assert 'ml_dtypes' not in sys.modules, 'ml_dtypes imported'\n"
             "assert not any(m == 'repro' or m.startswith('repro.') "
             "for m in sys.modules), 'repro imported'\n")
    assert r.returncode == 0, r.stderr


def test_import_needs_no_nvcc_or_triton():
    r = _run("import sys\n"
             "sys.modules['triton'] = None   # any import of it now fails\n"
             "import repro_torch, repro_torch.kernels.fused as f\n"
             "import repro_torch.kernels.build as b\n"
             "assert f.rmsnorm_matmul.launches == 0\n"
             "assert f.matmul_bias_act.launches == 0\n"
             "assert b._LIBS == {}\n",
             env_extra={"PATH": "/nonexistent", "CUDA_HOME": "/nonexistent"})
    assert r.returncode == 0, r.stderr
