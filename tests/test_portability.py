"""The package runs on any JAX backend: its kernels import only the Pallas
routes a GPU compiles, and the compile cache goes where the environment
says."""

import ast
import os
import subprocess
import sys

import pytest

import banggameengine_tpu

PKG = os.path.dirname(os.path.abspath(banggameengine_tpu.__file__))
# Pallas itself and its Triton route; any other Pallas module is a route
# the GPU build does not compile
ALLOWED_PALLAS = {"jax.experimental.pallas", "jax.experimental.pallas.triton"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            for a in node.names:
                yield f"{node.module}.{a.name}"


def test_kernels_import_only_gpu_pallas_routes():
    found, bad = set(), []
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                for m in _imports(path):
                    if m.startswith("jax.experimental.pallas"):
                        found.add(m)
                        if m not in ALLOWED_PALLAS:
                            bad.append((path, m))
    assert not bad, bad
    assert "jax.experimental.pallas.triton" in found


_PROBE = ("import banggameengine_tpu as b, jax; "
          "print(jax.config.jax_compilation_cache_dir); "
          "print(b.default_cache_dir())")


@pytest.mark.parametrize("env,expect", [
    ({"JAX_COMPILATION_CACHE_DIR": "/tmp/bang_cache_probe"},
     "/tmp/bang_cache_probe"),
    ({}, "default"),
    ({"JAX_PLATFORMS": "cpu"}, "None"),
], ids=["env_dir", "checkout_default", "forced_cpu_off"])
def test_compile_cache_placement(env, expect):
    base = {k: v for k, v in os.environ.items()
            if k not in ("JAX_COMPILATION_CACHE_DIR", "JAX_PLATFORMS",
                         "BANG_NO_COMP_CACHE")}
    # without JAX_PLATFORMS this host still has only the CPU backend
    r = subprocess.run([sys.executable, "-c", _PROBE], env={**base, **env},
                       capture_output=True, text=True, timeout=120,
                       cwd=os.path.dirname(PKG))
    assert r.returncode == 0, r.stderr
    got, default = r.stdout.split()[:2]
    assert default == os.path.join(os.path.dirname(PKG), ".jax_cache")
    assert got == (default if expect == "default" else expect)
