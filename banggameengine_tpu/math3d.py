"""3D math library: quaternions, 4x4 transforms, camera matrices.

Array-native replacement for the bx math routines the reference leans on
(``bx::mtxSRT`` at ``src/ecs/Transform.cpp:20``, ``bx::mtxLookAt`` /
``bx::mtxProj`` at ``src/camera/Camera.cpp:63-72`` and
``src/render/Renderer.cpp:740-744``, ``bx::mtxInverse``/``mtxTranspose`` for the
normal matrix at ``src/render/Renderer.cpp:633-636``).

Conventions (self-consistent; parity is defined against this library's NumPy
golden, not bit-exactly against bx/Bullet — see SURVEY.md §7 "Hard parts"):

- Matrices are ``float32[..., 4, 4]``, **column-vector** convention:
  ``p_world = M @ [p; 1]``.  Composition: ``world = parent_world @ local``.
- ``local = T @ R @ S`` (scale first, then rotate, then translate), matching
  the observable semantics of ``bx::mtxSRT(scale, euler, pos)``.
- Euler angles are radians, applied in X, then Y, then Z order:
  ``R = Rz(az) @ Ry(ay) @ Rx(ax)`` (the reference stores ``rotationEuler`` as
  XYZ radians, ``src/ecs/Transform.h:14``; Bullet reads back with
  ``getEulerZYX`` which is the same composition order,
  ``src/physics/PhysicsSystem.cpp:906``).
- Quaternions are ``[x, y, z, w]`` (Bullet layout), unit-normalized.
- Projection produces depth in [0, 1] after perspective divide (D3D-style,
  matching the reference's default D3D11 backend; the bgfx
  ``homogeneousDepth`` handling at ``Renderer.cpp:740-744`` collapses to this).

Every function broadcasts over leading batch dimensions so the same code path
serves one entity or ``[W, N]`` many-world batches under ``vmap``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


# ---------------------------------------------------------------------------
# Quaternions ([x, y, z, w])
# ---------------------------------------------------------------------------

def quat_identity(shape=()) -> Array:
    """Identity quaternion, optionally batched to ``shape + (4,)``."""
    q = jnp.zeros(tuple(shape) + (4,), jnp.float32)
    return q.at[..., 3].set(1.0)


def quat_normalize(q: Array, eps: float = 1e-12) -> Array:
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q / jnp.maximum(n, eps)


def quat_mul(a: Array, b: Array) -> Array:
    """Hamilton product a*b (rotation b applied first, then a)."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx_, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bx_ + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx_,
            aw * bz + ax * by - ay * bx_ + az * bw,
            aw * bw - ax * bx_ - ay * by - az * bz,
        ],
        axis=-1,
    )


def quat_conj(q: Array) -> Array:
    return q * jnp.asarray([-1.0, -1.0, -1.0, 1.0], q.dtype)


def quat_rotate(q: Array, v: Array) -> Array:
    """Rotate vector(s) v by unit quaternion(s) q.

    Uses the 2-cross-product form: v' = v + 2*cross(q.xyz, cross(q.xyz, v) + w*v).
    """
    u = q[..., :3]
    w = q[..., 3:4]
    c1 = jnp.cross(u, v) + w * v
    return v + 2.0 * jnp.cross(u, c1)


def quat_from_axis_angle(axis: Array, angle: Array) -> Array:
    axis = axis / jnp.maximum(jnp.linalg.norm(axis, axis=-1, keepdims=True), 1e-12)
    half = jnp.asarray(angle)[..., None] * 0.5
    return jnp.concatenate([axis * jnp.sin(half), jnp.cos(half)], axis=-1)


def quat_from_euler_xyz(euler: Array) -> Array:
    """Euler XYZ radians -> quaternion with R = Rz @ Ry @ Rx (column-vector).

    Matches the composition used by :func:`mat_from_euler` so that
    ``quat_to_mat3(quat_from_euler_xyz(e)) == euler_rotation_matrix(e)``.
    """
    hx, hy, hz = euler[..., 0] * 0.5, euler[..., 1] * 0.5, euler[..., 2] * 0.5
    cx, sx = jnp.cos(hx), jnp.sin(hx)
    cy, sy = jnp.cos(hy), jnp.sin(hy)
    cz, sz = jnp.cos(hz), jnp.sin(hz)
    # q = qz * qy * qx  (apply X first)
    return jnp.stack(
        [
            sx * cy * cz - cx * sy * sz,
            cx * sy * cz + sx * cy * sz,
            cx * cy * sz - sx * sy * cz,
            cx * cy * cz + sx * sy * sz,
        ],
        axis=-1,
    )


def quat_to_mat3(q: Array) -> Array:
    """Unit quaternion -> 3x3 rotation matrix (column-vector convention)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_from_mat3(m: Array) -> Array:
    """3x3 rotation matrix -> unit quaternion [x,y,z,w].

    Branch-free (jnp.where-selected) Shepperd's method, safe under jit/vmap.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    # Candidate 0: trace-dominant
    s0 = jnp.sqrt(jnp.maximum(tr + 1.0, 1e-12)) * 2.0
    q0 = jnp.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0], -1)
    # Candidate 1: m00 dominant
    s1 = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 1e-12)) * 2.0
    q1 = jnp.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], -1)
    # Candidate 2: m11 dominant
    s2 = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, 1e-12)) * 2.0
    q2 = jnp.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2], -1)
    # Candidate 3: m22 dominant
    s3 = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, 1e-12)) * 2.0
    q3 = jnp.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3], -1)

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = jnp.where(cond0, q0, jnp.where(cond1, q1, jnp.where(cond2, q2, q3)))
    return quat_normalize(q)


def euler_zyx_from_quat(q: Array) -> Array:
    """Extract Euler XYZ angles assuming R = Rz @ Ry @ Rx.

    Mirrors Bullet's ``btMatrix3x3::getEulerZYX`` used for dynamic-body
    write-back (``src/physics/PhysicsSystem.cpp:906``). Returns [ax, ay, az].
    """
    m = quat_to_mat3(q)
    # R = Rz Ry Rx => m[2,0] = -sin(ay); m[2,1]=cos(ay) sin(ax); m[0,0]=cos(ay)cos(az)
    sy = -m[..., 2, 0]
    sy = jnp.clip(sy, -1.0, 1.0)
    ay = jnp.arcsin(sy)
    cy = jnp.cos(ay)
    near_gimbal = jnp.abs(cy) < 1e-6
    ax = jnp.where(
        near_gimbal,
        jnp.arctan2(-m[..., 1, 2], m[..., 1, 1]),
        jnp.arctan2(m[..., 2, 1], m[..., 2, 2]),
    )
    az = jnp.where(
        near_gimbal,
        jnp.zeros_like(ay),
        jnp.arctan2(m[..., 1, 0], m[..., 0, 0]),
    )
    return jnp.stack([ax, ay, az], axis=-1)


def quat_nlerp(a: Array, b: Array, t) -> Array:
    """Normalized linear interpolation with hemisphere correction.

    For the small per-substep rotations of motion-state interpolation this
    matches slerp to float precision while staying branch-free."""
    sign = jnp.where(jnp.sum(a * b, axis=-1, keepdims=True) < 0.0, -1.0, 1.0)
    return quat_normalize(a + (b * sign - a) * t)


def quat_integrate(q: Array, omega: Array, dt) -> Array:
    """Integrate unit quaternion by world angular velocity over dt.

    q' = normalize(q + 0.5 * dt * [omega, 0] * q)  — first-order, the same
    scheme Bullet uses inside its integrator.
    """
    ow = jnp.concatenate([omega, jnp.zeros_like(omega[..., :1])], axis=-1)
    dq = 0.5 * quat_mul(ow, q)
    return quat_normalize(q + dq * jnp.asarray(dt, q.dtype)[..., None])


# ---------------------------------------------------------------------------
# 4x4 matrices
# ---------------------------------------------------------------------------

def mat_identity(shape=()) -> Array:
    return jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), tuple(shape) + (4, 4))


def mat_from_srt(scale: Array, quat: Array, pos: Array) -> Array:
    """Compose local = T @ R @ S from scale[...,3], quat[...,4], pos[...,3].

    Batched equivalent of ``bx::mtxSRT`` (``src/ecs/Transform.cpp:20``).
    """
    r = quat_to_mat3(quat)
    rs = r * scale[..., None, :]  # R @ diag(s): scale columns
    top = jnp.concatenate([rs, pos[..., :, None]], axis=-1)  # [...,3,4]
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def mat_from_euler_srt(scale: Array, euler: Array, pos: Array) -> Array:
    return mat_from_srt(scale, quat_from_euler_xyz(euler), pos)


def mat_mul(a: Array, b: Array) -> Array:
    return jnp.matmul(a, b, preferred_element_type=jnp.float32)


def mat_transform_point(m: Array, p: Array) -> Array:
    """Apply 4x4 to 3-vector point(s): rows of p are transformed."""
    return jnp.einsum("...ij,...j->...i", m[..., :3, :3], p) + m[..., :3, 3]


def mat_transform_dir(m: Array, v: Array) -> Array:
    return jnp.einsum("...ij,...j->...i", m[..., :3, :3], v)


def mat_affine_inverse(m: Array) -> Array:
    """Inverse of an affine TRS matrix (general 3x3 inverse + translation)."""
    a = m[..., :3, :3]
    inv_a = jnp.linalg.inv(a)
    t = m[..., :3, 3]
    inv_t = -jnp.einsum("...ij,...j->...i", inv_a, t)
    top = jnp.concatenate([inv_a, inv_t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def normal_matrix(world: Array) -> Array:
    """(world^-1)^T upper-left 3x3, the reference's normal transform
    (``src/render/Renderer.cpp:633-636``)."""
    a = world[..., :3, :3]
    return jnp.swapaxes(jnp.linalg.inv(a), -1, -2)


# ---------------------------------------------------------------------------
# Camera matrices
# ---------------------------------------------------------------------------

def mtx_look_at(eye: Array, at: Array, up=None) -> Array:
    """Right-handed view matrix, equivalent in effect to ``bx::mtxLookAt``
    (``src/camera/Camera.cpp:63-72``): transforms world -> view space where the
    camera looks down +Z (bgfx/D3D convention: left-handed view with +Z
    forward)."""
    if up is None:
        up = jnp.asarray([0.0, 1.0, 0.0], jnp.float32)
    f = at - eye
    f = f / jnp.maximum(jnp.linalg.norm(f, axis=-1, keepdims=True), 1e-12)
    r = jnp.cross(up, f)
    r = r / jnp.maximum(jnp.linalg.norm(r, axis=-1, keepdims=True), 1e-12)
    u = jnp.cross(f, r)
    rot = jnp.stack([r, u, f], axis=-2)  # rows: right, up, forward
    t = -jnp.einsum("...ij,...j->...i", rot, eye)
    top = jnp.concatenate([rot, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def mtx_proj(fovy_deg, aspect, near, far) -> Array:
    """Perspective projection, depth in [0,1] (D3D-style), +Z forward.

    Equivalent of ``bx::mtxProj(fovY=60, aspect, 0.1, 1000, homogeneousDepth)``
    as configured at ``src/camera/Camera.h:33-35`` / ``Renderer.cpp:740-744``.
    """
    fovy = jnp.deg2rad(jnp.asarray(fovy_deg, jnp.float32))
    h = 1.0 / jnp.tan(fovy * 0.5)
    w = h / jnp.asarray(aspect, jnp.float32)
    near = jnp.asarray(near, jnp.float32)
    far = jnp.asarray(far, jnp.float32)
    a = far / (far - near)
    b = -near * a
    m = jnp.zeros((4, 4), jnp.float32)
    m = m.at[0, 0].set(w)
    m = m.at[1, 1].set(h)
    m = m.at[2, 2].set(a)
    m = m.at[2, 3].set(b)
    m = m.at[3, 2].set(1.0)
    return m


def mtx_ortho(left, right, bottom, top, near, far) -> Array:
    m = jnp.zeros((4, 4), jnp.float32)
    m = m.at[0, 0].set(2.0 / (right - left))
    m = m.at[1, 1].set(2.0 / (top - bottom))
    m = m.at[2, 2].set(1.0 / (far - near))
    m = m.at[0, 3].set(-(right + left) / (right - left))
    m = m.at[1, 3].set(-(top + bottom) / (top - bottom))
    m = m.at[2, 3].set(-near / (far - near))
    m = m.at[3, 3].set(1.0)
    return m


def yaw_pitch_forward(yaw: Array, pitch: Array) -> Array:
    """Forward vector from yaw/pitch, matching the reference camera
    (``src/camera/Camera.cpp:63-72``): yaw=pi/2 faces +Z."""
    cp = jnp.cos(pitch)
    return jnp.stack(
        [jnp.cos(yaw) * cp, jnp.sin(pitch), jnp.sin(yaw) * cp], axis=-1
    )
