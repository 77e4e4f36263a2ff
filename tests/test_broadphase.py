"""Broadphase tests: the grid and blocked-AABB neighbor lists, parity vs
the dense path and brute force, and large-world scale behavior."""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from banggameengine_tpu import math3d
from banggameengine_tpu.engine import make_step_fn
from banggameengine_tpu.physics.broadphase import build_neighbor_lists
from banggameengine_tpu.scene.synthetic import build_falling_boxes
from banggameengine_tpu.state import SHAPE_BOX, InputFrame


def _boxes_env(positions):
    n = len(positions)
    pos = jnp.asarray(positions, jnp.float32)
    quat = math3d.quat_identity((n,))
    st = jnp.full(n, SHAPE_BOX, jnp.int8)
    size = jnp.tile(jnp.asarray([0.5, 0.5, 0.5], jnp.float32), (n, 1))
    active = jnp.ones(n, bool)
    return pos, quat, st, size, active


class TestNeighborLists:
    def test_adjacent_bodies_found(self):
        pos, quat, st, size, active = _boxes_env(
            [[0, 0, 0], [0.9, 0, 0], [10, 0, 0]]
        )
        nl = build_neighbor_lists(pos, quat, st, size, active, cell_size=2.0)
        n0 = set(np.asarray(nl.idx[0])[np.asarray(nl.valid[0])].tolist())
        assert n0 == {1}
        n1 = set(np.asarray(nl.idx[1])[np.asarray(nl.valid[1])].tolist())
        assert n1 == {0}  # symmetric
        n2 = np.asarray(nl.valid[2]).sum()
        assert n2 == 0  # isolated
        assert int(nl.cell_overflow) == 0

    def test_cross_cell_neighbors(self):
        # bodies straddling a cell boundary must still pair up
        pos, quat, st, size, active = _boxes_env(
            [[1.95, 0, 0], [2.05, 0, 0]]
        )
        nl = build_neighbor_lists(pos, quat, st, size, active, cell_size=2.0)
        assert bool(nl.valid[0, 0]) and int(nl.idx[0, 0]) == 1

    def test_inactive_excluded(self):
        pos, quat, st, size, _ = _boxes_env([[0, 0, 0], [0.5, 0, 0]])
        active = jnp.asarray([True, False])
        nl = build_neighbor_lists(pos, quat, st, size, active, cell_size=2.0)
        assert np.asarray(nl.valid).sum() == 0

    def test_dense_cluster_overflow_reported(self):
        # 40 bodies in one cell with capacity 8 -> overflow counted
        rng = np.random.default_rng(0)
        pts = rng.uniform(0, 0.5, (40, 3))
        pos, quat, st, size, active = _boxes_env(pts)
        nl = build_neighbor_lists(
            pos, quat, st, size, active, cell_size=4.0, cell_capacity=8
        )
        assert int(nl.cell_overflow) > 0

    def test_no_false_pairs_from_hash_collisions(self):
        # tiny table forces hash collisions; cell-match filter must reject
        pos, quat, st, size, active = _boxes_env(
            [[0, 0, 0], [50, 0, 0], [100, 0, 0], [150, 0, 0]]
        )
        nl = build_neighbor_lists(
            pos, quat, st, size, active, cell_size=2.0, table_size=2
        )
        assert np.asarray(nl.valid).sum() == 0


class TestGridStepParity:
    def test_grid_matches_dense_small_world(self):
        state, static = build_falling_boxes(12, seed=3, spread=4.0)
        dense = make_step_fn(static, donate=False)
        grid = make_step_fn(static, donate=False, broadphase="grid",
                            grid_cell_size=2.5)
        inp = InputFrame.zero()
        s_d = s_g = state
        # short horizon: identical contact sets, only accumulation-order
        # float drift (longer rollouts diverge chaotically by design —
        # SURVEY.md §7 tolerance-based parity)
        for _ in range(90):
            s_d, _ = dense(s_d, inp)
            s_g, _ = grid(s_g, inp)
        np.testing.assert_allclose(
            np.asarray(s_d.pos), np.asarray(s_g.pos), atol=0.15
        )
        # long horizon: identical resting statistics
        for _ in range(300):
            s_d, _ = dense(s_d, inp)
            s_g, _ = grid(s_g, inp)
        yd = np.asarray(s_d.pos[:12, 1])
        yg = np.asarray(s_g.pos[:12, 1])
        np.testing.assert_allclose(yd, 0.5, atol=0.1)
        np.testing.assert_allclose(yg, 0.5, atol=0.3)

    def test_grid_200_boxes_settle(self):
        state, static = build_falling_boxes(200, seed=1)
        grid = make_step_fn(static, donate=False, broadphase="grid",
                            grid_cell_size=2.5, grid_table_size=8192)
        inp = InputFrame.zero()
        for _ in range(300):
            state, _ = grid(state, inp)
        pos = np.asarray(state.pos[:200])
        assert np.isfinite(pos).all()
        # nothing fell through the ground plane
        assert (pos[:, 1] > 0.2).all()
        # the ones that have landed are resting at box half-height
        landed = np.abs(np.asarray(state.lin_vel[:200, 1])) < 0.05
        assert landed.sum() > 15  # spawn heights reach y~102; most still fall
        np.testing.assert_allclose(pos[landed, 1].min(), 0.5, atol=0.1)


def _aabb_case(name):
    """-> (mn, mx, dyn, layer, mask) inputs of neighbor_lists_aabb."""
    rng = np.random.default_rng(7)
    if name == "saturated_pile":
        # 4x4x6 boxes at 0.98 spacing: every interior box overlaps more
        # partners than the 8-slot cap
        g = np.stack(np.meshgrid(np.arange(4), np.arange(6), np.arange(4),
                                 indexing="ij"), -1).reshape(-1, 3) * 0.98
        pos = g.astype(np.float32)
    elif name == "n_below_k":
        pos = np.asarray([[0, 0, 0], [0.5, 0, 0], [0.9, 0.3, 0]], np.float32)
    else:
        pos = rng.uniform(-6, 6, (300, 3)).astype(np.float32)
    n = len(pos)
    half = rng.uniform(0.3, 0.9, (n, 3)).astype(np.float32)
    dyn = np.ones(n, np.int32)
    layer = np.ones(n, np.int32)
    mask = np.full(n, -1, np.int32)
    if name == "mixed_flags":
        dyn = rng.choice([-1, 0, 1], n).astype(np.int32)   # not solid/static
        layer = rng.choice([1, 2, 4], n).astype(np.int32)
        mask = rng.choice([-1, 1, 3, 6], n).astype(np.int32)
    return pos - half, pos + half, dyn, layer, mask


def _aabb_impl(name):
    import functools

    from banggameengine_tpu.physics.broadphase import neighbor_lists_aabb
    from banggameengine_tpu.physics.broadphase_triton import (
        neighbor_lists_aabb_triton, neighbor_lists_sorted,
    )

    return {
        "plain_block64": functools.partial(neighbor_lists_aabb,
                                           block_rows=64),
        "plain": neighbor_lists_aabb,
        # the Pallas kernel, interpreted on the CPU
        "triton_interpret": functools.partial(neighbor_lists_aabb_triton,
                                              interpret=True),
        # the stress route's dispatch: the plain version off CUDA
        "sorted_route": neighbor_lists_sorted,
    }[name]


@pytest.mark.parametrize("case", ["random", "saturated_pile", "mixed_flags",
                                  "n_below_k"])
@pytest.mark.parametrize("impl", ["plain_block64", "plain",
                                  "triton_interpret", "sorted_route"])
def test_aabb_neighbor_lists_match_brute_force(case, impl):
    """The blocked all-pairs broadphase keeps exactly the first k partners
    (ascending) of the NumPy brute force, and counts the rest."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from chip_smoke import brute_force_neighbors

    args = _aabb_case(case)
    nl = _aabb_impl(impl)(*(jnp.asarray(a) for a in args), max_neighbors=8)
    idx, counts = brute_force_neighbors(*args, k=8)
    np.testing.assert_array_equal(np.asarray(nl.idx), idx)
    np.testing.assert_array_equal(np.asarray(nl.valid), idx >= 0)
    assert int(nl.nbr_overflow) == int(np.maximum(counts - 8, 0).sum())
    if case == "saturated_pile":
        assert int(nl.nbr_overflow) > 0


def test_morton_key_orders_space():
    """Morton-sorted neighbours in x/z land close together in the order."""
    from banggameengine_tpu.physics.broadphase import morton_key_xz

    g = np.stack(np.meshgrid(np.arange(16), np.arange(16), indexing="ij"),
                 -1).reshape(-1, 2).astype(np.float32)
    pos = jnp.asarray(np.stack([g[:, 0], np.zeros(256), g[:, 1]], 1))
    key = np.asarray(morton_key_xz(pos, cell=1.0))
    assert len(np.unique(key)) == 256 and (key >= 0).all()
    rank = np.argsort(np.argsort(key))
    # each aligned 2x2 quad of cells occupies 4 consecutive ranks
    quad = rank.reshape(8, 2, 8, 2).transpose(0, 2, 1, 3).reshape(64, 4)
    assert (np.ptp(quad, axis=1) == 3).all()


def test_sorted_route_lowers_the_kernel_only_for_cuda():
    """The stress route picks the Pallas kernel when lowered for a CUDA GPU
    and the plain version for the CPU, from the lowering platform."""
    import functools

    from banggameengine_tpu.physics.broadphase_triton import (
        neighbor_lists_sorted,
    )

    args = tuple(jnp.asarray(a) for a in _aabb_case("random"))
    traced = jax.jit(functools.partial(neighbor_lists_sorted,
                                       max_neighbors=8)).trace(*args)
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    cpu = traced.lower(lowering_platforms=("cpu",)).as_text()
    assert "triton" in cuda.lower() and "triton" not in cpu.lower()
