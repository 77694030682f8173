"""chip_smoke.py's `[host]` lines for several checkouts in one call (GPU).

Host times spread between machines, so two versions are compared only
within one call. Each tree given (a checkout of the repository: its own
`src/` and `chip_smoke.py`) builds axpy and dotp into its own build
directory and runs `chip_smoke.host_phase()` in a process of its own,
in the order given (e.g. parent, change, change, parent):

    python3 tools/host_lines.py results/parent . . results/parent
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

CODE = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
import chip_smoke
from repro_torch.kernels import build
build.build(("axpy", "dotp"))
chip_smoke.host_phase()
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="checkouts, run in this order")
    args = ap.parse_args()
    for tree in args.trees:
        root = Path(tree).resolve()
        print(f"[tree] {tree}", flush=True)
        proc = subprocess.run(
            [sys.executable, "-c", CODE.format(src=str(root / "src"),
                                               root=str(root))],
            cwd=root, capture_output=True, text=True, timeout=600)
        print("\n".join(line for line in proc.stdout.splitlines()
                        if line.startswith("[host]")), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
