"""The samples that the fused render term never reads: a sample outside its
frame's radius, every sample of an invalid ray and every sample of a frozen
lane. Moving them changes no output of the term's plain version
(`fused_render_plain`), so the CUDA kernel may run its decoder on the other
samples alone (`csrc/fused_render.cu`, stages 1-3).

Each case moves every out-of-radius sample to twice the frame's radius
along its direction and gives the samples of invalid rays and of the frozen
lane arbitrary points, then holds res, jd and jm to the unmoved run, exactly
(`torch.equal`). The cases take the render settings of the benchmark's
three configurations and a linear occupancy.
"""

import numpy as np
import pytest
import torch

from hortimapping_tpu_torch.models.decoder import DecoderSpec
from hortimapping_tpu_torch.models.workspace import params_from_jax
from hortimapping_tpu_torch.ops import mlp_kernels, render_kernel
from torch_port_common import random_decoder_np

torch.set_num_threads(1)

SPEC = DecoderSpec(code_length=8, dims=(128,) * 4, latent_in=(2,), clamping_distance=0.1)

CASES = {
    # sweetpepper_cka / sweetpepper_bup20: Sim(3), logistic at 1 cm, occlusion, 30 samples
    "pepper_logistic_occlusion": dict(M=30, pose_dim=7, log_occ_on=True, occ_cutoff=0.01,
                                      occlusion_on=True),
    # strawberry_lab: logistic at 5 mm, no occlusion, 15 samples
    "berry_logistic_no_occlusion": dict(M=15, pose_dim=7, log_occ_on=True, occ_cutoff=0.005,
                                        occlusion_on=False),
    "se3_linear_occlusion": dict(M=22, pose_dim=6, log_occ_on=False, occ_cutoff=0.01,
                                 occlusion_on=True),
}


def _inputs(M, seed, B=3, F=2, R=24):
    """Rays from a camera 0.3 m before the object through a 0.12-m radius,
    some hitting it: their near and far samples fall outside it. The last 3
    rays of each frame are padding (invalid), lane 1 is frozen."""
    rng = np.random.default_rng(seed)
    ang = np.concatenate([rng.normal(size=(B, F, R, 2)) * 0.15, np.ones((B, F, R, 1))], -1)
    depths = np.broadcast_to(np.linspace(0.16, 0.44, M), (B, F, M))
    pts = ang[..., None, :] * depths[:, :, None, :, None] - np.array([0.01, -0.02, 0.3])
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)
    ray_valid = torch.ones(B, F, R, dtype=torch.bool)
    ray_valid[:, :, R - 3:] = False
    active = torch.ones(B, dtype=torch.bool)
    active[1] = False
    return dict(latent=t(rng.normal(size=(B, SPEC.code_length)) * 0.05), pts=t(pts),
                depth_obs=t(0.3 + rng.normal(size=(B, F, R)) * 0.03),
                is_fg=torch.arange(R) < R // 2, ray_valid=ray_valid, depths=t(depths),
                bbx_radius=t(np.full((B, F), 0.12)), lane_active=active)


def _decoder(x, pts):
    """A random decoder whose zero set crosses the rays: the head's bias
    puts the median sdf of the in-radius samples at 0."""
    params = random_decoder_np(SPEC, 3)
    pk = mlp_kernels.pack_params(params_from_jax(params, "cpu"), SPEC)
    rows = torch.cat([x["latent"][:, None, None, None].expand(*pts.shape[:-1], -1), pts], -1)
    sdf, _ = mlp_kernels.chain_plain(pk, rows.reshape(-1, SPEC.in_dim))
    inside = ((pts * pts).sum(-1) < 0.12 ** 2).reshape(-1)
    params[f"lin{SPEC.num_linear - 1}"]["b"] -= np.arctanh(float(sdf[inside].median()))
    return mlp_kernels.pack_params(params_from_jax(params, "cpu"), SPEC)


@pytest.mark.parametrize("case", list(CASES))
def test_dead_samples_move_nothing(case):
    c = CASES[case]
    x = _inputs(c["M"], seed=5)
    pts = x["pts"]
    pk = _decoder(x, pts)
    kw = dict(pose_dim=c["pose_dim"], scale_on=c["pose_dim"] == 7, log_occ_on=c["log_occ_on"],
              occ_cutoff=c["occ_cutoff"], occlusion_on=c["occlusion_on"], occlusion_th=0.03,
              min_grad_th=1e-6)
    bbx = x["bbx_radius"][..., None, None]
    norm2 = (pts * pts).sum(-1)
    outside = ~(norm2 < bbx * bbx)               # the plain version's own test, negated
    dead = ~(x["ray_valid"] & x["lane_active"][:, None, None])[..., None].expand_as(norm2)
    moved = torch.where(outside[..., None], pts * (2 * bbx[..., None] / norm2.sqrt()[..., None]),
                        pts)
    rng = np.random.default_rng(11)
    arbitrary = torch.as_tensor(rng.normal(size=tuple(pts.shape)) * 0.1, dtype=torch.float32)
    moved = torch.where(dead[..., None], arbitrary, moved)
    assert int((outside & ~dead).sum()) > 0 and int((~outside & ~dead).sum()) > 0
    assert not torch.equal(moved, pts)

    args = lambda p: (pk, x["latent"], p, x["depth_obs"], x["is_fg"], x["ray_valid"],
                      x["depths"], x["bbx_radius"], x["lane_active"])
    stats = {}
    want = render_kernel.fused_render_plain(*args(pts), stats=stats, **kw)
    got = render_kernel.fused_render_plain(*args(moved), **kw)
    jd, jm, res = want
    assert stats["band_samples"] > 0 and bool((res[..., 2] > 0.5).any())
    assert float(jd.abs().max()) > 0 and float(jm.abs().max()) > 0
    for name, g, w in zip(("jd", "jm", "res"), got, want):
        assert torch.equal(g, w), name
