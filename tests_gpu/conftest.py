"""GPU tier: tests that need a GPU, run there with no platform forcing.

    python -m pytest tests_gpu -m gpu

``chip_smoke.py`` runs them too.  Each test asks for the ``gpu`` fixture,
which skips it when JAX's first device is not a GPU.
"""

import pytest


@pytest.fixture
def gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX's first device is '{dev.platform}')")
    return dev
