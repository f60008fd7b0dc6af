"""The port stands alone: no file of ``src/repro_torch`` or
``chip_smoke.py`` imports JAX or the JAX package, importing the port
leaves both out of the process, and ``chip_smoke.py`` refuses to run (no
result, non-zero exit) without a CUDA device or without the repository."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_file_imports_no_jax(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def test_importing_port_leaves_jax_out():
    code = ("import json, sys\n"
            "import repro_torch, repro_torch.core, repro_torch.serving\n"
            "import repro_torch.kernels.moscore\n"
            "import repro_torch.models, repro_torch.configs\n"
            "import repro_torch.common\n"
            "import repro_torch.kernels.flash_attention\n"
            "import repro_torch.kernels.decode_attention\n"
            "print(json.dumps(sorted(m for m in sys.modules\n"
            "    if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path):
    """Here there is no card: the script exits non-zero with no result.
    Alone in a directory it cannot find the port and fails the same way
    (on the card too)."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    runs = [[sys.executable, str(alone)]]
    if not torch.cuda.is_available():
        runs.append([sys.executable, str(REPO / "chip_smoke.py")])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cmd in runs:
        out = subprocess.run(cmd, env=env, cwd=tmp_path,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
