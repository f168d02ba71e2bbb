"""Quaternion + vector math in the reference engine's conventions.

Port of ``vrt.core.quat``: Z-up, X-forward, Y-right; quaternions stored
``(x, y, z, w)``.  Every function takes numpy arrays (host-side scene
assembly) or torch tensors (device-side use) and dispatches on the input
type, as ``vrt`` dispatches between numpy and jax.numpy.  The formulas and
their operation order are ``vrt``'s, so both packages round alike.
"""

from __future__ import annotations

import numpy as np
import torch

from vrt_torch.core import kinks

UP = np.array([0.0, 0.0, 1.0], np.float32)
FORWARD = np.array([1.0, 0.0, 0.0], np.float32)
RIGHT = np.array([0.0, 1.0, 0.0], np.float32)

IDENTITY = np.array([0.0, 0.0, 0.0, 1.0], np.float32)


def _is_torch(*arrays) -> bool:
    return any(isinstance(a, torch.Tensor) for a in arrays)


def _like(v, ref):
    """``v`` as a float32 tensor on ``ref``'s device (numpy constants)."""
    return torch.as_tensor(v, dtype=torch.float32, device=ref.device)


def cross(a, b):
    """Broadcasting cross product on the last axis."""
    if not _is_torch(a, b):
        return np.cross(a, b)
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _norm(v):
    if _is_torch(v):
        return torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return np.linalg.norm(v, axis=-1, keepdims=True)


def normalize(v, eps=0.0):
    """Normalize the last axis; eps=0 matches HLSL normalize (inf/nan on
    zero)."""
    n = _norm(v)
    if eps:
        n = kinks.maximum(n, eps) if _is_torch(n) else np.maximum(n, eps)
    return v / n


def dot(a, b):
    return (a * b).sum(-1)


def from_axis_angle(axis, angle):
    """Quaternion from (unit) axis and angle in radians
    (``VQuat::FromAxisAngle``)."""
    if _is_torch(axis, angle):
        ref = axis if isinstance(axis, torch.Tensor) else angle
        axis = _like(axis, ref)
        angle = _like(angle, ref)
        half = angle * 0.5
        xyz = axis * torch.sin(half)[..., None]
        w = torch.cos(half)[..., None]
        return torch.cat([xyz, w.expand(xyz.shape[:-1] + (1,))], dim=-1)
    axis = np.asarray(axis, dtype=np.float32)
    angle = np.asarray(angle, dtype=np.float32)
    half = angle * 0.5
    s = np.sin(half)[..., None]
    w = np.cos(half)[..., None]
    return np.concatenate([axis * s, w], axis=-1)


def multiply(q1, q2):
    """Hamilton product q1*q2 (apply q2 first, then q1)."""
    stack = ((lambda xs: torch.stack(xs, dim=-1)) if _is_torch(q1, q2)
             else (lambda xs: np.stack(xs, axis=-1)))
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])


def conjugate(q):
    if _is_torch(q):
        return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype,
                                device=q.device)
    return q * np.asarray([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype)


def inverse(q):
    return conjugate(q) / (q * q).sum(-1, keepdims=True)


def rotate(q, v):
    """Rotate vector(s) v by unit quaternion(s) q. Batched on leading dims."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * cross(qv, v)
    return v + qw * t + cross(qv, t)


def from_euler_degrees(roll, yaw, pitch):
    """``VQuat::FromEulerAnglesDegrees``:
    FromAxisAngle(RIGHT, pitch) * FromAxisAngle(UP, yaw)
    * FromAxisAngle(FORWARD, roll)."""
    if _is_torch(roll, yaw, pitch):
        ref = next(a for a in (roll, yaw, pitch)
                   if isinstance(a, torch.Tensor))
        r, y, p = (torch.deg2rad(_like(a, ref)) for a in (roll, yaw, pitch))
        right, up, fwd = (_like(c, ref) for c in (RIGHT, UP, FORWARD))
    else:
        r, y, p = (np.deg2rad(np.float32(a)) for a in (roll, yaw, pitch))
        right, up, fwd = RIGHT, UP, FORWARD
    qp = from_axis_angle(right, p)
    qy = from_axis_angle(up, y)
    qr = from_axis_angle(fwd, r)
    return multiply(multiply(qp, qy), qr)


def from_two_vectors(v1, v2):
    """Rotation taking unit v1 to unit v2 (Eigen FromTwoVectors semantics)."""
    if _is_torch(v1, v2):
        ref = v1 if isinstance(v1, torch.Tensor) else v2
        v1 = _like(v1, ref)
        v2 = _like(v2, ref)
        c = cross(v1, v2)
        w = (1.0 + (v1 * v2).sum(-1))[..., None]
        q = torch.cat([c, w], dim=-1)
        ortho = cross(v1, _like(RIGHT, ref))
        small = _norm(ortho) < 1e-6
        ortho = torch.where(small, cross(v1, _like(UP, ref)), ortho)
        flip = torch.cat([normalize(ortho, 1e-12), torch.zeros_like(w)],
                         dim=-1)
        return normalize(torch.where(w < 1e-6, flip, q), 1e-12)
    v1 = np.asarray(v1, dtype=np.float32)
    v2 = np.asarray(v2, dtype=np.float32)
    c = np.cross(v1, v2)
    w = (1.0 + (v1 * v2).sum(-1))[..., None]
    q = np.concatenate([c, w], axis=-1)
    ortho = np.cross(v1, RIGHT)
    small = _norm(ortho) < 1e-6
    ortho = np.where(small, np.cross(v1, UP), ortho)
    flip = np.concatenate([normalize(ortho, 1e-12),
                           np.zeros_like(w, dtype=np.float32)], axis=-1)
    return normalize(np.where(w < 1e-6, flip, q), 1e-12)


def forward_vector(q):
    """Rotation's forward vector (``VQuat::GetForwardVector``)."""
    return rotate(q, _like(FORWARD, q) if _is_torch(q) else FORWARD)


def up_vector(q):
    return rotate(q, _like(UP, q) if _is_torch(q) else UP)


def right_vector(q):
    return rotate(q, _like(RIGHT, q) if _is_torch(q) else RIGHT)
