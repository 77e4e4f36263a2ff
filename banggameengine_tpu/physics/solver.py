"""Velocity-level contact solver: fixed-iteration mass-splitting Jacobi.

Replaces Bullet's sequential-impulse solver (``btSequentialImpulseConstraint
Solver``, created at ``PhysicsSystem.cpp:124-128``) with a deterministic,
order-independent scheme made of dense array operations.

Design (after the round-1 perf pass):

- narrowphase produces *candidate* contact slots (dense ``[N,N,K]`` or
  neighbor-list ``[N,K_nb,K]``), of which only a few per body are real;
- :func:`compact_contacts` compresses them to a fixed per-body budget
  ``[N, C]`` with explicit partner ids (one stable argsort, outside the
  iteration loop), so the 10x-iterated solver touches ~20x less data;
- each unordered pair appears mirrored in both bodies' rows with identical
  lambdas by symmetry, so per-body impulse accumulation is a **row
  reduction** — no scatters anywhere in the hot loop;
- *mass splitting*: per-body velocity deltas are divided by the body's
  active contact count, making simultaneous-impulse Jacobi convergent (the
  standard parallel-solver trick) at the cost of more iterations than
  Gauss-Seidel;
- warm-start-free, fixed iteration count => bitwise deterministic and
  identical under ``vmap``.

Partner id ``-1`` marks a static-world contact (the implicit ground plane,
``PhysicsSystem.cpp:149-166``): the partner side contributes no velocity and
infinite mass.  Friction uses a 2-tangent pyramid clamped by mu * lambda_n;
restitution uses pre-solve approach speed with Bullet's velocity threshold;
Baumgarte stabilization replaces split-impulse position correction.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from banggameengine_tpu import math3d

Array = jax.Array

BAUMGARTE = 0.2            # Bullet global ERP default
PENETRATION_SLOP = 0.005   # ~ Bullet linear slop
RESTITUTION_THRESHOLD = 1.0  # Bullet restitution velocity threshold
WARM_START_FACTOR = 0.85   # btContactSolverInfo m_warmstartingFactor


def _orthonormal_tangents(n: Array) -> tuple[Array, Array]:
    """Two tangents orthogonal to unit normal n, branchless."""
    helper = jnp.where(
        (jnp.abs(n[..., 0]) < 0.7)[..., None],
        jnp.asarray([1.0, 0.0, 0.0], n.dtype),
        jnp.asarray([0.0, 1.0, 0.0], n.dtype),
    )
    t1 = jnp.cross(n, helper)
    t1 = t1 / jnp.maximum(jnp.linalg.norm(t1, axis=-1, keepdims=True), 1e-9)
    t2 = jnp.cross(n, t1)
    return t1, t2


def inv_inertia_world(quat: Array, inv_inertia_body: Array) -> Array:
    """I^-1_world = R diag(I^-1_body) R^T. [..., 3, 3]."""
    r = math3d.quat_to_mat3(quat)
    return jnp.einsum("...ij,...j,...kj->...ik", r, inv_inertia_body, r)


def compaction_matrix(valid: Array, budget: int) -> tuple[Array, Array, Array]:
    """Stable compaction as a one-hot matrix (sort-free, a matmul).

    valid bool[..., M] -> (sel f32[..., M, budget] with sel[m, c] = 1 iff
    valid slot m lands in output slot c, new_valid bool[..., budget],
    counts i32[...]).  ``out = einsum('...mc,...m->...c', sel, x)`` then
    gathers/compacts any per-slot array; exact because columns are one-hot.
    """
    counts_incl = jnp.cumsum(valid.astype(jnp.int32), axis=-1)
    target = counts_incl - 1                         # destination slot
    in_budget = valid & (target < budget)
    sel = (
        jax.nn.one_hot(jnp.where(in_budget, target, budget), budget,
                       dtype=jnp.float32)
    )                                                # [..., M, budget]
    counts = counts_incl[..., -1]
    new_valid = jnp.arange(budget) < jnp.minimum(counts, budget)[..., None]
    return sel, new_valid, counts


def compact_contacts(
    b_idx: Array,    # i32[N, M] partner per slot (-1 = static world)
    point: Array,    # f32[N, M, 3]
    normal: Array,   # f32[N, M, 3]
    depth: Array,    # f32[N, M]
    valid: Array,    # bool[N, M]
    budget: int,
    feat: Array | None = None,  # i32[N, M] contact feature ids
):
    """Compress candidate slots to ``[N, budget]`` per-body contact lists.

    Sort-free: destinations come from a running count (stable order) and the
    move is a one-hot contraction (a matmul) instead of an argsort-based
    compaction.  Overflow (more real contacts than
    budget) is returned for diagnostics.  When ``feat`` is given (persistent
    contact-cache features), a compacted ``c_feat`` (-1 in empty slots) is
    appended to the return.
    """
    sel, new_valid, counts = compaction_matrix(valid, budget)

    # per-operand precision: the 0/1 selection matrix is EXACT at DEFAULT
    # precision; the f32 payload stays HIGHEST.  Bit-identical to
    # (HIGHEST, HIGHEST) for selection contractions.
    _SEL_PREC = (jax.lax.Precision.DEFAULT, jax.lax.Precision.HIGHEST)

    def move(a):
        return jnp.einsum("...mc,...m->...c", sel, a.astype(jnp.float32),
                          precision=_SEL_PREC)

    def move3(a):
        return jnp.einsum("...mc,...mk->...ck", sel, a,
                          precision=_SEL_PREC)

    c_b = jnp.where(new_valid, move(b_idx.astype(jnp.float32)).astype(jnp.int32), -1)
    out = (
        c_b,
        move3(point),
        move3(normal),
        move(depth),
        new_valid,
    )
    overflow = jnp.sum(jnp.maximum(counts - budget, 0))
    if feat is not None:
        c_f = jnp.where(new_valid, move(feat).astype(jnp.int32), -1)
        return out + (overflow, c_f)
    return out + (overflow,)


@partial(jax.jit, static_argnames=("iterations", "return_lambdas", "sor",
                                   "momentum"))
def solve_contacts_unified(
    v: Array,            # f32[N,3] linear velocity (pre-solve)
    w: Array,            # f32[N,3] angular velocity
    pos: Array,          # f32[N,3] body centers
    inv_m: Array,        # f32[N]
    inv_i_world: Array,  # f32[N,3,3]
    c_b: Array,          # i32[N,C] partner ids (-1 = static world)
    c_point: Array,      # f32[N,C,3]
    c_normal: Array,     # f32[N,C,3] from partner toward row body
    c_depth: Array,      # f32[N,C]
    c_valid: Array,      # bool[N,C]
    c_mu: Array,         # f32[N,C] combined friction
    c_e: Array,          # f32[N,C] combined restitution
    dt: Array,
    iterations: int = 10,
    warm: tuple[Array, Array, Array] | None = None,
    return_lambdas: bool = False,
    sor: float = 1.0,
    momentum: float = 0.0,
) -> tuple[Array, ...]:
    """Solve the compacted contact set; returns post-solve (v, w).

    ``warm`` = cached (lambda_n, lambda_t1, lambda_t2) f32[N,C] from the
    previous step's feature-matched contacts (Bullet-style warm starting:
    the cached impulses are applied to the velocities up-front and the
    accumulators start from them, so the iterative solve only refines the
    *change* — stacks settle instead of re-fighting gravity from zero each
    step).  ``return_lambdas=True`` appends the accumulated
    (ln, lt1, lt2) to the return for the caller to cache."""
    is_static = c_b < 0
    safe_b = jnp.maximum(c_b, 0)
    n = v.shape[0]

    ra = c_point - pos[:, None]                    # [N,C,3]
    rb = c_point - pos[safe_b]
    t1, t2 = _orthonormal_tangents(c_normal)

    # Partner-velocity reads happen EVERY solver iteration.  For small
    # body counts we build a one-hot selection tensor ONCE and turn the
    # per-iteration gather into a contraction (exact: each row has at most
    # a single 1; static/world slots are all-zero rows, replacing the
    # where(is_static, 0, ...)).
    use_onehot = n <= 128
    if use_onehot:
        sel_partner = jax.nn.one_hot(
            jnp.where(is_static, n, safe_b), n + 1, dtype=v.dtype
        )[..., :n]                                 # [N,C,N]

    im_b = jnp.where(is_static, 0.0, inv_m[safe_b])
    ib = jnp.where(is_static[..., None, None], 0.0, inv_i_world[safe_b])

    ia = inv_i_world[:, None]                      # [N,1,3,3] broadcasts

    def k_along(direction):
        rxd_a = jnp.cross(ra, direction)
        ang_a = jnp.cross(jnp.einsum("...ij,...j->...i", ia, rxd_a), ra)
        rxd_b = jnp.cross(rb, direction)
        ang_b = jnp.cross(jnp.einsum("...ij,...j->...i", ib, rxd_b), rb)
        k = (
            inv_m[:, None] + im_b
            + jnp.sum(direction * ang_a, -1)
            + jnp.sum(direction * ang_b, -1)
        )
        return jnp.maximum(k, 1e-9)

    kn = k_along(c_normal)
    kt1 = k_along(t1)
    kt2 = k_along(t2)

    def rel_vel(v_, w_):
        va = v_[:, None] + jnp.cross(w_[:, None], ra)
        if use_onehot:
            # 0/1 partner selector is exact at DEFAULT precision; HIGHEST
            # for the f32 velocity payload (bit-identical to the
            # all-HIGHEST form)
            prec = (jax.lax.Precision.DEFAULT, jax.lax.Precision.HIGHEST)
            vb_lin = jnp.einsum("ncm,mk->nck", sel_partner, v_,
                                precision=prec)
            wb = jnp.einsum("ncm,mk->nck", sel_partner, w_, precision=prec)
            vb = vb_lin + jnp.cross(wb, rb)
        else:
            vb = jnp.where(is_static[..., None], 0.0, v_[safe_b]) + jnp.cross(
                jnp.where(is_static[..., None], 0.0, w_[safe_b]), rb
            )
        return va - vb

    vn0 = jnp.sum(rel_vel(v, w) * c_normal, -1)
    bounce = c_e * jnp.maximum(-vn0 - RESTITUTION_THRESHOLD, 0.0)
    baum = (BAUMGARTE / dt) * jnp.maximum(c_depth - PENETRATION_SLOP, 0.0)
    target = jnp.maximum(bounce, baum)

    cnt = jnp.sum(c_valid, axis=-1).astype(jnp.float32)
    split = jnp.maximum(cnt, 1.0)

    zeros = jnp.zeros_like(c_depth)

    if warm is not None:
        # apply the cached impulses BEFORE iterating (restitution target
        # above already captured the true pre-solve approach speed); the
        # 0.85 factor is Bullet's warm-starting damping — full-strength
        # reuse can freeze unstable equilibria (a cube balancing on its
        # edge forever) because the solve then needs zero correction
        ln0 = jnp.where(
            c_valid, jnp.maximum(warm[0], 0.0) * WARM_START_FACTOR, 0.0)
        lt10 = jnp.where(c_valid, warm[1] * WARM_START_FACTOR, 0.0)
        lt20 = jnp.where(c_valid, warm[2] * WARM_START_FACTOR, 0.0)
        imp0 = (
            ln0[..., None] * c_normal
            + lt10[..., None] * t1
            + lt20[..., None] * t2
        )
        lin0 = jnp.sum(imp0, axis=1)
        ang0 = jnp.sum(jnp.cross(ra, imp0), axis=1)
        v = v + lin0 * (inv_m / split)[:, None]
        w = w + jnp.einsum("nij,nj->ni", inv_i_world, ang0) / split[:, None]
    else:
        ln0 = lt10 = lt20 = zeros

    def body(_, carry):
        v_, w_, ln, lt1, lt2, pln, plt1, plt2 = carry
        vr = rel_vel(v_, w_)
        vn = jnp.sum(vr * c_normal, -1)
        dln = sor * (-(vn - target)) / kn
        ln_new = jnp.maximum(ln + dln, 0.0)
        if momentum:
            # heavy-ball extrapolation over the lambda iterates (Chebyshev-
            # style acceleration of mass-splitting Jacobi, cf. Tonge et al.
            # "Mass Splitting for Jitter-Free Parallel Rigid Body
            # Simulation"): projects back onto the cone after extrapolating
            ln_new = jnp.maximum(ln_new + momentum * (ln_new - pln), 0.0)
        dln = jnp.where(c_valid, ln_new - ln, 0.0)
        pln = ln
        ln = jnp.where(c_valid, ln_new, ln)

        vt1 = jnp.sum(vr * t1, -1)
        vt2 = jnp.sum(vr * t2, -1)
        max_f = c_mu * ln
        lt1_new = lt1 - sor * vt1 / kt1
        lt2_new = lt2 - sor * vt2 / kt2
        if momentum:
            lt1_new = lt1_new + momentum * (lt1_new - plt1)
            lt2_new = lt2_new + momentum * (lt2_new - plt2)
        lt1_new = jnp.clip(lt1_new, -max_f, max_f)
        lt2_new = jnp.clip(lt2_new, -max_f, max_f)
        dlt1 = jnp.where(c_valid, lt1_new - lt1, 0.0)
        dlt2 = jnp.where(c_valid, lt2_new - lt2, 0.0)
        plt1, plt2 = lt1, lt2
        lt1 = jnp.where(c_valid, lt1_new, lt1)
        lt2 = jnp.where(c_valid, lt2_new, lt2)

        imp = (
            dln[..., None] * c_normal
            + dlt1[..., None] * t1
            + dlt2[..., None] * t2
        )                                           # [N,C,3]
        lin = jnp.sum(imp, axis=1)
        ang = jnp.sum(jnp.cross(ra, imp), axis=1)
        v_ = v_ + lin * (inv_m / split)[:, None]
        w_ = w_ + jnp.einsum("nij,nj->ni", inv_i_world, ang) / split[:, None]
        return v_, w_, ln, lt1, lt2, pln, plt1, plt2

    carry = (v, w, ln0, lt10, lt20, ln0, lt10, lt20)
    carry = jax.lax.fori_loop(0, iterations, body, carry)
    if return_lambdas:
        return carry[0], carry[1], (carry[2], carry[3], carry[4])
    return carry[0], carry[1]
