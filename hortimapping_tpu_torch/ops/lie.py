"""SE(3) / Sim(3) machinery, batched over leading axes.

Counterpart of `hortimapping_tpu/ops/lie.py`. Tangents are ordered
(translation, rotation[, log scale]) with a LEFT perturbation, so the pose
update is ``T <- exp(delta) @ T``. `exp_sim3` is the exact exponential;
`exp_sim3_ref`, the LM's update, keeps the reference's quirk: inside the
theta > eps branch the c*I term of the translation Jacobian is zeroed for
every s <= 1e-8, not only at s = 0.
"""

from __future__ import annotations

import torch

_EPS = 1e-8
_V_SERIES_TERMS = 20


def skew(v: torch.Tensor) -> torch.Tensor:
    """Hat operator: (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _eye3(x: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device)


def _v_matrix_series(X: torch.Tensor) -> torch.Tensor:
    """V = sum_n X^n / (n+1)!, branch-free and stable in f32."""
    eye = _eye3(X).expand(X.shape)
    V = eye
    term = eye
    for n in range(1, _V_SERIES_TERMS):
        term = (term @ X) / (n + 1.0)
        V = V + term
    return V


def _assemble(A: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(A.shape[:-2] + (4, 4), dtype=A.dtype, device=A.device)
    T[..., :3, :3] = A
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def exp_se3(x: torch.Tensor) -> torch.Tensor:
    """se(3) -> SE(3): x = (v[3], w[3]) -> 4x4."""
    v, w = x[..., :3], x[..., 3:6]
    theta = torch.linalg.norm(w, dim=-1)
    small = theta < _EPS
    theta_safe = torch.where(small, torch.ones_like(theta), theta)
    t2 = theta_safe * theta_safe
    A = torch.where(small, torch.ones_like(theta), torch.sin(theta) / theta_safe)
    half_sin = torch.sin(theta / 2.0)
    B = torch.where(small, torch.full_like(theta, 0.5), 2.0 * half_sin * half_sin / t2)
    W = skew(w)
    R = _eye3(x) + A[..., None, None] * W + B[..., None, None] * (W @ W)
    t = (_v_matrix_series(W) @ v[..., None])[..., 0]
    return _assemble(R, t)


def exp_sim3(x: torch.Tensor) -> torch.Tensor:
    """sim(3) -> Sim(3), the exact exponential: x = (v[3], w[3], s) -> 4x4
    with the rotation block scaled by e^s; the translation through the
    series V matrix of W + s I (branch-free where Strasdat's closed form
    cancels in f32 near theta -> 0 and s -> 0)."""
    v, w, s = x[..., :3], x[..., 3:6], x[..., 6]
    theta = torch.linalg.norm(w, dim=-1)
    small = theta < _EPS
    theta_safe = torch.where(small, torch.ones_like(theta), theta)
    t2 = theta_safe * theta_safe
    A = torch.where(small, torch.ones_like(theta), torch.sin(theta) / theta_safe)
    half_sin = torch.sin(theta / 2.0)
    B = torch.where(small, torch.full_like(theta, 0.5), 2.0 * half_sin * half_sin / t2)
    W = skew(w)
    eye = _eye3(x)
    R = eye + A[..., None, None] * W + B[..., None, None] * (W @ W)
    t = (_v_matrix_series(W + s[..., None, None] * eye) @ v[..., None])[..., 0]
    return _assemble(torch.exp(s)[..., None, None] * R, t)


def exp_sim3_ref(x: torch.Tensor) -> torch.Tensor:
    """Reference-compatible sim(3) "exponential", quirk included (see the
    module docstring); the (e^s - 1)/s division keeps the reference's
    operation order so f32 rounding matches."""
    v, w, s = x[..., :3], x[..., 3:6], x[..., 6]
    theta = torch.linalg.norm(w, dim=-1)
    small = theta <= _EPS
    one = torch.ones_like(theta)
    zero = torch.zeros_like(theta)
    theta_safe = torch.where(small, one, theta)
    t2 = theta_safe * theta_safe
    e_s = torch.exp(s)
    sin_t = torch.sin(theta)
    cos_t = torch.cos(theta)

    W = skew(w)
    W2 = W @ W
    eye = _eye3(x)
    A = torch.where(small, zero, sin_t / theta_safe)
    B = torch.where(small, zero, (1.0 - cos_t) / t2)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2

    s_safe = torch.where(s == 0.0, torch.ones_like(s), s)
    c_div = (e_s - 1.0) / s_safe
    c_small = torch.where(s == 0.0, torch.ones_like(s), c_div)
    c_big = torch.where(s <= _EPS, torch.zeros_like(s), c_div)
    denom = s * s + t2
    a = e_s * sin_t
    b = e_s * cos_t
    k1 = (a * s + (1.0 - b) * theta) / denom
    k2 = c_big - ((b - 1.0) * s + a * theta) / denom
    j_big = (
        c_big[..., None, None] * eye
        + (k1 / theta_safe)[..., None, None] * W
        + (k2 / t2)[..., None, None] * W2
    )
    j_small = c_small[..., None, None] * eye
    j = torch.where(small[..., None, None], j_small, j_big)
    t = (j @ v[..., None])[..., 0]
    return _assemble(e_s[..., None, None] * R, t)


def points_to_pose_jacobian_se3(points: torch.Tensor) -> torch.Tensor:
    """[I | -x^]: (..., 3) -> (..., 3, 6)."""
    eye = _eye3(points).expand(points.shape[:-1] + (3, 3))
    return torch.cat([eye, -skew(points)], dim=-1)


def points_to_pose_jacobian_sim3(points: torch.Tensor) -> torch.Tensor:
    """[I | -x^ | x]: (..., 3) -> (..., 3, 7)."""
    eye = _eye3(points).expand(points.shape[:-1] + (3, 3))
    return torch.cat([eye, -skew(points), points[..., None]], dim=-1)


def sim3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a Sim(3) matrix [[sR, t], [0, 1]]:
    (sR)^-1 = (sR)^T / s^2, s^2 the squared norm of the first row of sR."""
    A = T[..., :3, :3]
    t = T[..., :3, 3]
    s2 = torch.sum(A[..., 0, :] * A[..., 0, :], dim=-1)[..., None, None]
    A_inv = A.transpose(-1, -2) / s2
    t_inv = -torch.einsum("...ij,...j->...i", A_inv, t)
    return _assemble(A_inv, t_inv)


def rotation_matrix_to_angle(R: torch.Tensor) -> torch.Tensor:
    """acos((tr - 1)/2), argument clipped to [-1, 1]."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))


def axis_angle_to_rotation_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula; the identity below an angle of 1e-8."""
    angle = torch.linalg.norm(axis_angle, dim=-1)
    small = angle < _EPS
    axis = axis_angle / torch.where(small, torch.ones_like(angle), angle)[..., None]
    S = skew(axis)
    eye = _eye3(axis_angle)
    R = (eye + torch.sin(angle)[..., None, None] * S
         + (1.0 - torch.cos(angle))[..., None, None] * (S @ S))
    return torch.where(small[..., None, None], eye, R)
