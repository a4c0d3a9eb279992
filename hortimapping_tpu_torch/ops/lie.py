"""SE(3) / Sim(3) machinery, batched over leading axes.

Counterpart of `hortimapping_tpu/ops/lie.py`. Tangents are ordered
(translation, rotation[, log scale]) with a LEFT perturbation, so the pose
update is ``T <- exp(delta) @ T``. `exp_sim3_ref` keeps the reference's
quirk: inside the theta > eps branch the c*I term of the translation
Jacobian is zeroed for every s <= 1e-8, not only at s = 0.
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


def rotation_matrix_to_angle(R: torch.Tensor) -> torch.Tensor:
    """acos((tr - 1)/2), argument clipped to [-1, 1]."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
