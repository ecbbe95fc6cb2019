"""The card-only entry points refuse to run without a GPU.

``chip_smoke.py`` and ``bench.py`` measure nothing on the CPU: they exit
non-zero and print no result line. ``chip_smoke.py`` copied alone into an
empty directory fails too (it cannot reach the package)."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args", [
    ["chip_smoke.py"],
    ["chip_smoke.py", "--four-cards"],
    ["bench.py"],
    ["bench.py", "--grid", "128x128"],
], ids=["chip_smoke", "chip_smoke-four-cards", "bench", "bench-128"])
def test_exits_nonzero_without_gpu(args):
    proc = _run(args, REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "MLUPS" not in proc.stdout
    assert "needs an NVIDIA GPU" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_cli_has_no_backend_option():
    from tpulbm.cli import build_parser

    with pytest.raises(SystemExit):
        build_parser().parse_args(["p", "o", "--backend", "jnp"])
