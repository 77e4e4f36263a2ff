"""CPU rehearsal of ``chip_smoke.py``'s stress, render and four-card
phases at tiny sizes on the virtual CPU devices."""

import os
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def cpu():
    return jax.devices("cpu")[0]


def test_phase_stress(cpu, tmp_path):
    chip_smoke.phase_stress(cpu, cpu, bodies=300, steps=4,
                            trace_dir=str(tmp_path / "trace"))


def test_phase_render(cpu):
    chip_smoke.phase_render(cpu, cpu, app_size=(160, 96),
                            frame_size=(256, 160), settle=240, app_frames=1)


def test_phase_four_cards():
    chip_smoke.phase_four_cards(jax.devices()[:4], worlds=8, steps=4,
                                bodies=64)
