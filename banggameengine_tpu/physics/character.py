"""Kinematic character controller.

Reproduces the *observable* behaviors of the reference's
``btKinematicCharacterController`` usage (``PhysicsSystem.cpp:709-846``), not
Bullet's internals (SURVEY.md §7 "Hard parts"):

- camera-yaw-relative WASD walk at ``walkSpeed``, sprint x1.8
  (``PhysicsSystem.cpp:35``, ``:790-846``);
- jump sets vertical speed to ``jumpImpulse`` only when on ground
  (``setJumpSpeed`` + ``canJump``, ``:834-844``);
- gravity from config, fall speed clamped to 3*|g| (``setFallSpeed``,
  ``:763``);
- capsule from config, NOT scaled by the entity transform (``:735``);
- step height: penetration recovery may lift the capsule up to
  ``stepHeight`` per tick;
- slope limit: ground contacts steeper than ``maxSlope`` don't count as
  support (``setMaxSlope``, ``:760``).

The controller is a ghost object: it pushes **itself** out of world geometry
but applies no impulses to dynamic bodies (Bullet ghost semantics).
Implemented as a fixed-iteration depenetration loop against all colliders +
the implicit ground plane, fully vectorized over character slots via vmap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from banggameengine_tpu import math3d
from banggameengine_tpu.physics import narrowphase as nf
from banggameengine_tpu.physics.config import SPRINT_MULTIPLIER
from banggameengine_tpu.state import SHAPE_BOX, SHAPE_CAPSULE

Array = jax.Array

DEPENETRATION_ITERS = 4
CONTACT_TOLERANCE = 0.05   # ground-support probe distance


def walk_velocity(move_forward, move_right, cam_yaw, walk_speed, sprint):
    """Horizontal walk velocity from input axes, camera-relative
    (``HandleCharacterInput``, PhysicsSystem.cpp:790-846)."""
    fwd = math3d.yaw_pitch_forward(cam_yaw, jnp.float32(0.0))
    fwd = fwd.at[1].set(0.0)
    fwd = fwd / jnp.maximum(jnp.linalg.norm(fwd), 1e-9)
    right = jnp.cross(fwd, jnp.asarray([0.0, 1.0, 0.0], jnp.float32))
    right = -right  # match reference: right = up x fwd
    wish = fwd * move_forward + right * move_right
    norm = jnp.linalg.norm(wish)
    wish = jnp.where(norm > 1e-6, wish / jnp.maximum(norm, 1e-9), 0.0)
    speed = walk_speed * jnp.where(sprint, SPRINT_MULTIPLIER, 1.0)
    return wish * speed


def _capsule_world_contacts(
    c_pos, radius, half_height,
    pos, quat, shape_type, size, obstacle_mask,
):
    """Contacts of an upright capsule at ``c_pos`` against all entity shapes
    plus the ground plane.  Returns (normals [M,3] pushing the capsule out,
    depths [M], valid [M]) with M = 3*N + 2."""
    n = pos.shape[0]
    ts = jnp.asarray([0.0, 0.5, 1.0], jnp.float32)
    lo = c_pos - jnp.asarray([0.0, 1.0, 0.0]) * half_height
    hi = c_pos + jnp.asarray([0.0, 1.0, 0.0]) * half_height
    samples = lo[None, :] + (hi - lo)[None, :] * ts[:, None]      # [3,3]

    # vs boxes: sphere-box per (sample, entity)
    d_box, n_box, _ = nf._sphere_box_contact(
        samples[:, None, :], radius,
        pos[None, :], quat[None, :], size[None, :],
    )  # [3,N]
    is_box = (shape_type == SHAPE_BOX)[None, :]
    valid_box = is_box & obstacle_mask[None, :]

    # vs capsules: segment-segment against each entity capsule
    seg_a, seg_b = _entity_capsule_segments(pos, quat, size)
    c1, c2 = _closest_seg(lo, hi, seg_a, seg_b)                    # [N,3] each
    delta = c1 - c2
    dist = jnp.linalg.norm(delta, axis=-1)
    n_cap = jnp.where(
        dist[:, None] > 1e-9,
        delta / jnp.maximum(dist, 1e-9)[:, None],
        jnp.asarray([0.0, 1.0, 0.0]),
    )
    d_cap = radius + size[:, 0] - dist                              # [N]
    is_cap = shape_type == SHAPE_CAPSULE
    valid_cap = is_cap & obstacle_mask

    # ground plane: both end spheres
    d_gnd = jnp.stack([radius - lo[1], radius - hi[1]])
    n_gnd = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), (2, 3))

    normals = jnp.concatenate([n_box.reshape(3 * n, 3), n_cap, n_gnd], axis=0)
    depths = jnp.concatenate([d_box.reshape(3 * n), d_cap, d_gnd], axis=0)
    valid = jnp.concatenate(
        [jnp.broadcast_to(valid_box, (3, n)).reshape(3 * n), valid_cap,
         jnp.ones(2, bool)],
        axis=0,
    )
    return normals, depths, valid


def _entity_capsule_segments(pos, quat, size):
    up = jnp.zeros_like(pos).at[:, 1].set(size[:, 1])
    axis = math3d.quat_rotate(quat, up)
    return pos - axis, pos + axis


def _closest_seg(p1, q1, p2, q2):
    from banggameengine_tpu.physics.shapes import closest_segment_segment

    return closest_segment_segment(
        jnp.broadcast_to(p1, p2.shape), jnp.broadcast_to(q1, q2.shape), p2, q2
    )


def _qrot_comps(qx, qy, qz, qw, vx, vy, vz):
    """Componentwise image of :func:`math3d.quat_rotate` (2-cross form):
    v' = v + 2*cross(u, cross(u, v) + w*v)."""
    c1x = qy * vz - qz * vy + qw * vx
    c1y = qz * vx - qx * vz + qw * vy
    c1z = qx * vy - qy * vx + qw * vz
    ox = vx + 2.0 * (qy * c1z - qz * c1y)
    oy = vy + 2.0 * (qz * c1x - qx * c1z)
    oz = vz + 2.0 * (qx * c1y - qy * c1x)
    return ox, oy, oz


def _box_local_comps(lb0, lb1, lb2, hb0, hb1, hb2):
    """Componentwise image of :func:`shapes.closest_point_on_box`
    (same first-axis-wins argmin tie-break) -> (n0, n1, n2, sdist)."""
    cl0 = jnp.clip(lb0, -hb0, hb0)
    cl1 = jnp.clip(lb1, -hb1, hb1)
    cl2 = jnp.clip(lb2, -hb2, hb2)
    d0, d1, d2 = lb0 - cl0, lb1 - cl1, lb2 - cl2
    dist = jnp.sqrt(d0 * d0 + d1 * d1 + d2 * d2)
    outside = dist > 1e-9
    inv = 1.0 / jnp.maximum(dist, 1e-9)
    f0 = hb0 - jnp.abs(lb0)
    f1 = hb1 - jnp.abs(lb1)
    f2 = hb2 - jnp.abs(lb2)
    min_clear = jnp.minimum(jnp.minimum(f0, f1), f2)
    ax0 = (f0 <= f1) & (f0 <= f2)
    ax1 = ~ax0 & (f1 <= f2)
    ax2 = ~ax0 & ~ax1

    def sgn(x):
        s = jnp.sign(x)
        return jnp.where(s == 0.0, 1.0, s)

    ni0 = jnp.where(ax0, sgn(lb0), 0.0)
    ni1 = jnp.where(ax1, sgn(lb1), 0.0)
    ni2 = jnp.where(ax2, sgn(lb2), 0.0)
    n0 = jnp.where(outside, d0 * inv, ni0)
    n1 = jnp.where(outside, d1 * inv, ni1)
    n2 = jnp.where(outside, d2 * inv, ni2)
    sdist = jnp.where(outside, dist, -min_clear)
    return n0, n1, n2, sdist


def step_characters_t(
    cx, cy, cz,            # f32[C] capsule centers
    vel_y, on_ground,      # f32[C], bool[C]
    radius, half_height, walk_speed, jump_speed,   # f32[C]
    inp_forward, inp_right, inp_jump, inp_sprint, cam_yaw,  # [C]
    bpx, bpy, bpz,         # f32[K,C] candidate positions
    bqx, bqy, bqz, bqw,    # f32[K,C] candidate quats
    b_is_box, b_is_cap,    # bool[K,C] candidate masks (shape & obstacle)
    hb0, hb1, hb2,         # f32[K,C] candidate half sizes
    gravity, dt, step_height, max_slope_cos,
):
    """Planar (component-form) image of :func:`step_character` for C
    characters at once, characters on the minor axis.

    The vmapped per-character form builds ``[C,3,K,3]``-minor
    intermediates; this planar form works on ``[K,C]``/[C] planes like
    the transposed contact pipeline (contact_t.py).  Same formulas, same argmin/argmax
    tie-breaks; returns (cx, cy, cz, vel_y, grounded).
    """
    # -- walk velocity (walk_velocity in comps; pitch=0 so |fwd|=1) --
    fx = jnp.cos(cam_yaw)
    fz = jnp.sin(cam_yaw)
    fn = jnp.maximum(jnp.sqrt(fx * fx + fz * fz), 1e-9)
    fx, fz = fx / fn, fz / fn
    # right = -(fwd x up) = (fz, 0, -fx)
    wx = fx * inp_forward + fz * inp_right
    wz = fz * inp_forward - fx * inp_right
    wn = jnp.sqrt(wx * wx + wz * wz)
    inv_wn = 1.0 / jnp.maximum(wn, 1e-9)
    wx = jnp.where(wn > 1e-6, wx * inv_wn, 0.0)
    wz = jnp.where(wn > 1e-6, wz * inv_wn, 0.0)
    speed = walk_speed * jnp.where(inp_sprint, SPRINT_MULTIPLIER, 1.0)

    # -- vertical dynamics --
    do_jump = inp_jump & on_ground
    vel_y = jnp.where(do_jump, jump_speed, vel_y)
    vel_y = vel_y + gravity * dt
    fall_cap = 3.0 * jnp.abs(gravity)
    vel_y = jnp.clip(vel_y, -fall_cap, jnp.inf)

    px = cx + wx * speed * dt
    py = cy + vel_y * dt
    pz = cz + wz * speed * dt

    # loop-invariant candidate frames
    cqx, cqy, cqz = -bqx, -bqy, -bqz           # conj for world->local
    # entity capsule core segments: axis = R @ (0, hb1, 0)
    axx, axy, axz = _qrot_comps(bqx, bqy, bqz, bqw,
                                jnp.zeros_like(hb1), hb1,
                                jnp.zeros_like(hb1))
    sax, say, saz = bpx - axx, bpy - axy, bpz - axz
    sbx, sby, sbz = bpx + axx, bpy + axy, bpz + axz

    def contacts(px_, py_, pz_):
        """All candidate contacts of the C capsules at (px_,py_,pz_):
        lists of (nx, ny, nz, depth, valid) planes, M = 3K + K + 2."""
        loy = py_ - half_height
        hiy = py_ + half_height
        out_n = []
        out_d = []
        out_v = []
        # vs boxes: sphere-box per (sample, candidate)
        for t_ in (0.0, 0.5, 1.0):
            sy = loy + (hiy - loy) * t_
            dx0 = px_[None] - bpx
            dy0 = sy[None] - bpy
            dz0 = pz_[None] - bpz
            l0, l1, l2 = _qrot_comps(cqx, cqy, cqz, bqw, dx0, dy0, dz0)
            n0, n1, n2, sd = _box_local_comps(l0, l1, l2, hb0, hb1, hb2)
            nwx, nwy, nwz = _qrot_comps(bqx, bqy, bqz, bqw, n0, n1, n2)
            out_n.append((nwx, nwy, nwz))
            out_d.append(radius[None] - sd)
            out_v.append(b_is_box)
        # vs capsules: segment-segment (shapes.closest_segment_segment in
        # comps; d1 = char axis (0, hiy-loy, 0), r = p1 - p2)
        d1y = hiy - loy                                       # [C]
        d2x, d2y, d2z = sbx - sax, sby - say, sbz - saz       # [K,C]
        rx = px_[None] - sax
        ry = loy[None] - say
        rz = pz_[None] - saz
        a_ = (d1y * d1y)[None]
        e_ = d2x * d2x + d2y * d2y + d2z * d2z
        f_ = d2x * rx + d2y * ry + d2z * rz
        c_ = d1y[None] * ry
        b_ = d1y[None] * d2y
        den = a_ * e_ - b_ * b_
        s_ = jnp.where(
            den > 1e-12,
            jnp.clip((b_ * f_ - c_ * e_) / jnp.maximum(den, 1e-12),
                     0.0, 1.0), 0.0)
        t2 = (b_ * s_ + f_) / jnp.maximum(e_, 1e-12)
        t2 = jnp.clip(t2, 0.0, 1.0)
        s_ = jnp.clip((b_ * t2 - c_) / jnp.maximum(a_, 1e-12), 0.0, 1.0)
        c2x = sax + d2x * t2
        c2y = say + d2y * t2
        c2z = saz + d2z * t2
        dx_ = px_[None] - c2x
        dy_ = (loy[None] + d1y[None] * s_) - c2y
        dz_ = pz_[None] - c2z
        dist = jnp.sqrt(dx_ * dx_ + dy_ * dy_ + dz_ * dz_)
        ok_d = dist > 1e-9
        inv = 1.0 / jnp.maximum(dist, 1e-9)
        out_n.append((jnp.where(ok_d, dx_ * inv, 0.0),
                      jnp.where(ok_d, dy_ * inv, 1.0),
                      jnp.where(ok_d, dz_ * inv, 0.0)))
        out_d.append(radius[None] + hb0 - dist)
        out_v.append(b_is_cap)
        # ground plane: both end spheres
        one = jnp.ones_like(loy)
        zero = jnp.zeros_like(loy)
        for ey in (loy, hiy):
            out_n.append((zero[None], one[None], zero[None]))
            out_d.append((radius - ey)[None])
            out_v.append(jnp.ones_like(ey, bool)[None])
        nx = jnp.concatenate([n[0] for n in out_n], axis=0)
        ny = jnp.concatenate([n[1] for n in out_n], axis=0)
        nz = jnp.concatenate([n[2] for n in out_n], axis=0)
        dd = jnp.concatenate(out_d, axis=0)
        vv = jnp.concatenate(out_v, axis=0)
        return nx, ny, nz, dd, vv                              # [M, C]

    def depen_body(_, p):
        px_, py_, pz_ = p
        nx, ny, nz, dd, vv = contacts(px_, py_, pz_)
        pen = jnp.where(vv, dd, -jnp.inf)
        idx = jnp.argmax(pen, axis=0)                          # [C]
        ohot = jnp.arange(pen.shape[0])[:, None] == idx[None, :]
        d = jnp.maximum(jnp.max(pen, axis=0), 0.0)
        wnx = jnp.sum(jnp.where(ohot, nx, 0.0), axis=0)
        wny = jnp.sum(jnp.where(ohot, ny, 0.0), axis=0)
        wnz = jnp.sum(jnp.where(ohot, nz, 0.0), axis=0)
        push_x = wnx * d
        push_y = jnp.clip(wny * d, -step_height, step_height + radius)
        push_z = wnz * d
        hit = d > 0.0
        return (jnp.where(hit, px_ + push_x, px_),
                jnp.where(hit, py_ + push_y, py_),
                jnp.where(hit, pz_ + push_z, pz_))

    px, py, pz = jax.lax.fori_loop(
        0, DEPENETRATION_ITERS, depen_body, (px, py, pz))

    # -- ground support probe --
    nx, ny, nz, dd, vv = contacts(px, py, pz)
    support = vv & (dd > -CONTACT_TOLERANCE) & (ny > max_slope_cos)
    grounded = jnp.any(support, axis=0)
    vel_y = jnp.where(grounded & (vel_y < 0.0), 0.0, vel_y)
    return px, py, pz, vel_y, grounded


def step_character(
    c_pos: Array,          # f32[3] capsule center (world)
    vel_y: Array,          # f32[] vertical velocity
    on_ground: Array,      # bool[]
    radius: Array, half_height: Array,
    walk_speed: Array, jump_speed: Array,
    inp_forward, inp_right, inp_jump, inp_sprint, cam_yaw,
    pos, quat, shape_type, size, obstacle_mask,
    gravity, dt, step_height, max_slope_cos,
):
    """Advance one character by one fixed step.

    Returns (new_center, new_vel_y, new_on_ground).
    """
    # -- input-driven horizontal walk --
    walk = walk_velocity(inp_forward, inp_right, cam_yaw, walk_speed, inp_sprint)

    # -- vertical dynamics --
    do_jump = inp_jump & on_ground
    vel_y = jnp.where(do_jump, jump_speed, vel_y)
    vel_y = vel_y + gravity * dt
    fall_cap = 3.0 * jnp.abs(gravity)  # setFallSpeed(|g|*3), :763
    vel_y = jnp.clip(vel_y, -fall_cap, jnp.inf)

    # -- proposed motion --
    disp = walk * dt + jnp.asarray([0.0, 1.0, 0.0]) * (vel_y * dt)
    new_pos = c_pos + disp

    # -- depenetration loop --
    def depen_body(_, p):
        normals, depths, valid = _capsule_world_contacts(
            p, radius, half_height, pos, quat, shape_type, size, obstacle_mask
        )
        pen = jnp.where(valid, depths, -jnp.inf)
        worst = jnp.argmax(pen)
        d = jnp.maximum(pen[worst], 0.0)
        push = normals[worst] * d
        # step-height rule: never push below more than stepHeight upward
        # in one go (prevents teleporting up tall walls)
        push_y = jnp.clip(push[1], -step_height, step_height + radius)
        push = push.at[1].set(push_y)
        return jnp.where(d > 0.0, p + push, p)

    new_pos = jax.lax.fori_loop(0, DEPENETRATION_ITERS, depen_body, new_pos)

    # -- ground support probe --
    normals, depths, valid = _capsule_world_contacts(
        new_pos, radius, half_height, pos, quat, shape_type, size, obstacle_mask
    )
    support = valid & (depths > -CONTACT_TOLERANCE) & (normals[:, 1] > max_slope_cos)
    grounded = jnp.any(support)
    vel_y = jnp.where(grounded & (vel_y < 0.0), 0.0, vel_y)

    return new_pos, vel_y, grounded
