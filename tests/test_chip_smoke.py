"""CPU rehearsal of ``chip_smoke.py``: every phase at a tiny size on the
virtual CPU devices (the script itself refuses to run without a GPU)."""

import json
import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def cpu():
    return jax.devices("cpu")[0]


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    for line in r.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_phase_demo(cpu):
    chip_smoke.phase_demo(cpu, cpu, steps=240)


def test_phase_manyworld(cpu):
    chip_smoke.phase_manyworld(cpu, cpu, worlds=8, compare_worlds=4, steps=10)


def test_run_phases_reports_failures(capsys):
    def boom():
        raise AssertionError("no")

    assert chip_smoke.run_phases([("ok", lambda: None), ("bad", boom)]) == [
        "bad"]
    assert "[bad] FAILED" in capsys.readouterr().out
