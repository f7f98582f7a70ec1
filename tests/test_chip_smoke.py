"""chip_smoke.py's own contract where there is no GPU: it refuses to run
and prints no result."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("env_dir", [None, "/elsewhere/cache"])
def test_compile_cache_dir(env_dir):
    env = {} if env_dir is None else {"JAX_COMPILATION_CACHE_DIR": env_dir}
    expect = env_dir or str(ROOT / ".jax_cache")
    assert chip_smoke.compile_cache_dir(env) == expect


def test_refuses_a_cpu_backend(capsys):
    # the four-card mode skips the child test run, so this reaches the
    # device check directly; the suite runs on the CPU backend
    rc = chip_smoke.main(["--four-cards"])
    out = capsys.readouterr()
    assert rc != 0
    assert '"ok"' not in out.out
    assert "needs a GPU" in out.err


def test_fails_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
