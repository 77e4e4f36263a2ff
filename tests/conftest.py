"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated on the XLA host platform with 8 virtual
devices; the tests that need a GPU live in ``tests_gpu/``.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
