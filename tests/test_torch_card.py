"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

These need an NVIDIA GPU (sm_90a, nvcc) and skip without one. The file
imports neither JAX nor the JAX package, so it runs where only the port's
dependencies are installed:

    python -m pytest tests/test_torch_card.py -m cuda

Inputs are made from a seed with numpy, weights through `params_from_jax`.
Tolerances, as a fraction of each output's largest magnitude:
* f32: kernel and plain version differ only in summation order, ~1e-7;
* bf16 decoder chain: both round every matmul operand to bf16, but the
  tensor cores sum in another order, so an activation now and then rounds
  one bf16 ulp the other way; the median error stays near f32 level and the
  worst is a few bf16 ulps;
* bf16 render term: such a flip can move a sample across the band edge, so
  it is held to the repo's fused-kernel gate (median and p90 residual delta,
  share of rays off by more than 1e-3), never to the per-ray maximum.
"""

import numpy as np
import pytest
import torch

from hortimapping_tpu_torch.models.decoder import DecoderSpec
from hortimapping_tpu_torch.models.workspace import config_decoder, params_from_jax
from hortimapping_tpu_torch.ops import mlp_kernels, render_kernel
from torch_port_common import ASSETS, random_decoder_np

torch.set_num_threads(1)

SPECS = {
    "latent_in": dict(code_length=8, dims=(128,) * 4, latent_in=(2,)),
    "no_skip": dict(code_length=8, dims=(128,) * 3, latent_in=()),
    "synthetic_pepper_32": None,  # the asset decoder: 32-d code, 8 x 512, latent_in 4
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda")


def _decoder(name, seed, dev):
    if SPECS[name] is None:
        return config_decoder(f"{ASSETS}/{name}", device=dev)
    spec = DecoderSpec(clamping_distance=0.1, **SPECS[name])
    return params_from_jax(random_decoder_np(spec, seed), dev), spec


def _rel(got, want):
    """|got - want| as a fraction of want's largest magnitude."""
    got, want = got.double().cpu(), want.double().cpu()
    return (got - want).abs() / want.abs().max().clamp_min(1e-6)


def _held_to_plain(got, want, dtype):
    """The decoder chain's tolerances (module docstring), as fractions of
    want's largest magnitude."""
    err = _rel(got, want)
    if dtype == "f32":
        assert float(err.max()) <= 1e-5
    else:
        assert float(err.median()) <= 1e-3 and float(err.max()) <= 5e-2


def _wave(name, pk):
    """Clusters a wave of forward-only kernel `name` holds."""
    wave = mlp_kernels.wave_and_smem(name, pk)[0]
    assert wave > 0
    return wave


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(SPECS))
def test_mlp_kernel_matches_plain(cuda, name, dtype):
    params, spec = _decoder(name, 9, cuda)
    rng = np.random.default_rng(0)
    x = torch.as_tensor((rng.normal(size=(1037, spec.in_dim)) * 0.1).astype(np.float32)).to(cuda)
    pk = mlp_kernels.pack_params(params, spec, torch.float32 if dtype == "f32" else torch.bfloat16)
    before = mlp_kernels.launches
    got = mlp_kernels.mlp_sdf_and_input_grad(pk, x)
    want = mlp_kernels.mlp_sdf_and_input_grad_plain(pk, x)
    torch.cuda.synchronize()
    assert mlp_kernels.launches == before + 1
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        _held_to_plain(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(SPECS))
def test_fwd_kernel_matches_plain(cuda, name, dtype):
    """B3 (forward alone) on rows that fill no whole chunk; its sdf equals
    B1's bit for bit, since both run the forward of one chain."""
    params, spec = _decoder(name, 9, cuda)
    rng = np.random.default_rng(2)
    x = torch.as_tensor((rng.normal(size=(1037, spec.in_dim)) * 0.1).astype(np.float32)).to(cuda)
    pk = mlp_kernels.pack_params(params, spec, torch.float32 if dtype == "f32" else torch.bfloat16)
    before = mlp_kernels.launches_fwd
    got = mlp_kernels.mlp_sdf(pk, x)
    want = mlp_kernels.mlp_sdf_plain(pk, x)
    torch.cuda.synchronize()
    assert mlp_kernels.launches_fwd == before + 1
    assert bool(torch.isfinite(got).all())
    _held_to_plain(got, want, dtype)
    b1 = mlp_kernels.mlp_sdf_and_input_grad(pk, x)[0]
    np.testing.assert_array_equal(got.cpu().numpy(), b1.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(SPECS))
def test_shared_latent_kernel_matches_plain(cuda, name, dtype):
    """B4: 3 codes x 999 points in one launch, each equal to B3 on the
    materialised [code | xyz] rows."""
    params, spec = _decoder(name, 5, cuda)
    rng = np.random.default_rng(3)
    lat = torch.as_tensor((rng.normal(size=(3, spec.code_length)) * 0.1).astype(np.float32)).to(cuda)
    pts = torch.as_tensor((rng.normal(size=(999, 3)) * 0.05).astype(np.float32)).to(cuda)
    pk = mlp_kernels.pack_params(params, spec, torch.float32 if dtype == "f32" else torch.bfloat16)
    before = mlp_kernels.launches_shared_latent
    got = mlp_kernels.mlp_sdf_shared_latent(pk, lat, pts)
    want = mlp_kernels.mlp_sdf_shared_latent_plain(pk, lat, pts)
    torch.cuda.synchronize()
    assert mlp_kernels.launches_shared_latent == before + 1
    assert got.shape == (3, 999) and bool(torch.isfinite(got).all())
    _held_to_plain(got, want, dtype)
    rows = torch.cat([lat[:, None, :].expand(3, 999, spec.code_length),
                      pts.expand(3, 999, 3)], dim=-1)
    np.testing.assert_array_equal(got.cpu().numpy(), mlp_kernels.mlp_sdf(pk, rows).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fwd_kernel_more_than_a_wave(cuda, dtype):
    """B3 over more chunk pairs than one wave of clusters takes, an odd
    number of 64-row chunks (the last pair half empty) and a ragged last
    chunk: two launches agree bit for bit and hold to the plain version."""
    params, spec = _decoder("synthetic_pepper_32", 6, cuda)
    pk = mlp_kernels.pack_params(params, spec, torch.float32 if dtype == "f32" else torch.bfloat16)
    chunks = 4 * _wave("mlp_fwd", pk) + 3
    n = (chunks - 1) * 64 + 37
    rng = np.random.default_rng(6)
    x = torch.as_tensor((rng.normal(size=(n, spec.in_dim)) * 0.1).astype(np.float32)).to(cuda)
    got = mlp_kernels.mlp_sdf(pk, x)
    again = mlp_kernels.mlp_sdf(pk, x)
    want = mlp_kernels.mlp_sdf_plain(pk, x)
    torch.cuda.synchronize()
    assert got.shape == (n,) and bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    _held_to_plain(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_shared_latent_kernel_more_than_a_wave(cuda, dtype):
    """B4 with 15 chunks a code (933 points: a ragged last chunk that no
    other code shares) and an odd number of codes, more chunk pairs than
    one wave of clusters takes: two launches agree bit for bit and hold to
    the plain version."""
    params, spec = _decoder("synthetic_pepper_32", 7, cuda)
    pk = mlp_kernels.pack_params(params, spec, torch.float32 if dtype == "f32" else torch.bfloat16)
    B, N = 2 * -(-2 * _wave("mlp_shared_latent", pk) // 15) + 1, 14 * 64 + 37
    rng = np.random.default_rng(7)
    lat = torch.as_tensor((rng.normal(size=(B, spec.code_length)) * 0.1).astype(np.float32)).to(cuda)
    pts = torch.as_tensor((rng.normal(size=(N, 3)) * 0.05).astype(np.float32)).to(cuda)
    got = mlp_kernels.mlp_sdf_shared_latent(pk, lat, pts)
    again = mlp_kernels.mlp_sdf_shared_latent(pk, lat, pts)
    want = mlp_kernels.mlp_sdf_shared_latent_plain(pk, lat, pts)
    torch.cuda.synchronize()
    assert got.shape == (B, N) and bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    _held_to_plain(got, want, dtype)


def _jtj_rel(got, want, ok, pose_dim):
    """(relH, relH_blk) of the fused-kernel gate: the worst relative
    Frobenius delta of each active lane's J^T J / n over its ok rays, for
    the depth and the mask Jacobian, whole and over the diagonal blocks of
    the translation, rotation, scale and latent columns."""
    J = want[0].shape[-1]
    blocks = [(0, 3), (3, 6)] + ([(6, 7)] if pose_dim == 7 else []) + [(pose_dim, J)]
    rel = lambda d, w: float(d.norm() / w.norm().clamp_min(1e-30))
    relH = relH_blk = 0.0
    for b in torch.nonzero(ok.reshape(ok.shape[0], -1).any(1)).reshape(-1).tolist():
        n = int(ok[b].sum())
        for k in (0, 1):
            Jg, Jw = got[k][b][ok[b]].double(), want[k][b][ok[b]].double()
            Hg, Hw = Jg.T @ Jg / n, Jw.T @ Jw / n
            relH = max(relH, rel(Hg - Hw, Hw))
            for s, e in blocks:
                relH_blk = max(relH_blk, rel(Hg[s:e, s:e] - Hw[s:e, s:e], Hw[s:e, s:e]))
    return relH, relH_blk


def _bf16_render_gate(got, want, active, pose_dim):
    """The fused-kernel gate of the bf16 render term (chip_smoke RENDER_TOL
    bf16): median and p90 residual delta, share of rays off by more than
    1e-3, relH and relH_blk."""
    ok = (want[2][..., 2] > 0.5) & active[:, None, None]
    assert int(ok.sum()) > 0
    for k in (0, 1):
        d = (got[2][..., k] - want[2][..., k]).abs()[ok].double()
        assert float(d.median()) <= 2e-3 and float(torch.quantile(d, 0.9)) <= 4e-3
        assert float((d > 1e-3).double().mean()) <= 0.2
    relH, relH_blk = _jtj_rel(got, want, ok, pose_dim)
    assert relH <= 0.35 and relH_blk <= 0.35, (relH, relH_blk)


def _render_inputs(spec, dev, B, F, R, M, seed):
    rng = np.random.default_rng(seed)
    ang = np.concatenate([rng.normal(size=(B, F, R, 2)) * 0.1, np.ones((B, F, R, 1))], -1)
    depths = np.broadcast_to(np.linspace(0.2, 0.42, M), (B, F, M))
    T_oc = np.linalg.inv(np.array([[1, 0, 0, 0.01], [0, 1, 0, -0.02], [0, 0, 1, 0.3], [0, 0, 0, 1]]))
    pts = (ang[..., None, :] * depths[:, :, None, :, None]) @ T_oc[:3, :3].T + T_oc[:3, 3]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32).to(dev)
    ray_valid = torch.ones(B, F, R, dtype=torch.bool, device=dev)
    ray_valid[:, :, R - 3:] = False  # padded rays
    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[-1] = False  # a frozen lane
    return (t(rng.normal(size=(B, spec.code_length)) * 0.05), t(pts),
            t(0.3 + rng.normal(size=(B, F, R)) * 0.03), torch.arange(R, device=dev) < R // 2,
            ray_valid, t(depths), t(np.full((B, F), 0.12)), active)


RENDER_CASES = {
    "sim3_log_M22": dict(M=22, scale_on=True, log_occ_on=True),
    "se3_linear_M10": dict(M=10, scale_on=False, log_occ_on=False),
    "sim3_linear_M30": dict(M=30, scale_on=True, log_occ_on=False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RENDER_CASES))
@pytest.mark.parametrize("name", ["latent_in", "synthetic_pepper_32"])
def test_render_kernel_matches_plain_f32(cuda, name, case):
    c = RENDER_CASES[case]
    params, spec = _decoder(name, 1, cuda)
    args = _render_inputs(spec, cuda, B=3, F=2, R=37, M=c["M"], seed=7)
    kw = dict(pose_dim=7 if c["scale_on"] else 6, scale_on=c["scale_on"],
              log_occ_on=c["log_occ_on"], occ_cutoff=0.15, occlusion_on=True,
              occlusion_th=0.03, min_grad_th=1e-6)
    pk = mlp_kernels.pack_params(params, spec)
    before = render_kernel.launches
    got = render_kernel.fused_render(pk, *args, **kw)
    want = render_kernel.fused_render_plain(pk, *args, **kw)
    torch.cuda.synchronize()
    assert render_kernel.launches == before + 1
    res_g, res_w = got[2], want[2]
    assert torch.equal(res_g[..., 2:], res_w[..., 2:])  # ray_ok, in-radius count
    assert bool(res_w[:-1, ..., 2].any())  # the band is not empty
    assert float(torch.cat([t[-1].reshape(-1) for t in got]).abs().max()) == 0.0  # frozen lane
    for g, w in zip(got, want):
        assert float(_rel(g, w).max()) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("M", [10, 22])  # the bench's coarse and fine samples per ray
def test_render_kernel_bf16_within_gate(cuda, M):
    params, spec = _decoder("synthetic_pepper_32", 0, cuda)
    args = _render_inputs(spec, cuda, B=3, F=3, R=64, M=M, seed=8)
    kw = dict(pose_dim=7, scale_on=True, log_occ_on=True, occ_cutoff=0.15, occlusion_on=True,
              occlusion_th=0.03, min_grad_th=1e-6)
    pk = mlp_kernels.pack_params(params, spec, torch.bfloat16)
    got = render_kernel.fused_render(pk, *args, **kw)
    want = render_kernel.fused_render_plain(pk, *args, **kw)
    torch.cuda.synchronize()
    ok = (want[2][..., 2] > 0.5) & args[-1][:, None, None]
    assert int(ok.sum()) > 0
    for k in (0, 1):
        d = (got[2][..., k] - want[2][..., k]).abs()[ok].double()
        assert float(d.median()) <= 2e-3 and float(torch.quantile(d, 0.9)) <= 4e-3
        assert float((d > 1e-3).double().mean()) <= 0.2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlp_kernel_lane_mask(cuda, dtype):
    """B1 with frozen lanes and rows a lane (1000) that fill no whole
    64-row chunk: frozen lanes are zero, the others as the plain version
    (f32 to the chip_smoke tolerance: 1e-5 sdf, 1e-4 of the gradient's
    largest magnitude); two launches agree bit for bit."""
    params, spec = _decoder("synthetic_pepper_32", 4, cuda)
    rng = np.random.default_rng(5)
    B, N = 5, 1000
    x = torch.as_tensor((rng.normal(size=(B, N, spec.in_dim)) * 0.1).astype(np.float32)).to(cuda)
    active = torch.tensor([True, False, True, True, False], device=cuda)
    pk = mlp_kernels.pack_params(params, spec, torch.float32 if dtype == "f32" else torch.bfloat16)
    s_k, g_k = mlp_kernels.mlp_sdf_and_input_grad(pk, x, active)
    s_2, g_2 = mlp_kernels.mlp_sdf_and_input_grad(pk, x, active)
    s_p, g_p = mlp_kernels.mlp_sdf_and_input_grad_plain(pk, x, active)
    torch.cuda.synchronize()
    assert torch.equal(s_k, s_2) and torch.equal(g_k, g_2)
    assert not s_k[~active].any() and not g_k[~active].any()
    if dtype == "f32":
        assert float((s_k - s_p).abs().max()) <= 1e-5
        assert float((g_k - g_p).abs().max()) <= 1e-4 * float(g_p.abs().max())
    else:
        for g, w in ((s_k, s_p), (g_k, g_p)):
            _held_to_plain(g[active], w[active], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_render_band_crosses_chunks_tiles_and_clusters(cuda, dtype):
    """B2 where the band rows of the launch cross 64-row chunks, tiles and
    clusters of tiles (R = 41 at M = 30: 4 rays a tile, a ragged 11th tile
    of one ray and a padding tile to whole clusters), with a frozen lane: bf16 under the
    fused-kernel gate, f32 to 2e-5 of each output's largest magnitude; the
    band is non-empty in several tiles, and two launches agree bit for
    bit. The bf16 gate includes relH and relH_blk, which read the band
    backward's jd and jm."""
    params, spec = _decoder("synthetic_pepper_32", 2, cuda)
    args = _render_inputs(spec, cuda, B=3, F=2, R=41, M=30, seed=11)
    kw = dict(pose_dim=7, scale_on=True, log_occ_on=True, occ_cutoff=0.15, occlusion_on=True,
              occlusion_th=0.03, min_grad_th=1e-6)
    pk = mlp_kernels.pack_params(params, spec, torch.float32 if dtype == "f32" else torch.bfloat16)
    rl = render_kernel.render_forward(pk, *args, **kw)
    offsets = render_kernel.band_offsets(rl.counts)
    total = int(offsets[-1])
    tr, tiles_x = render_kernel.tiling(41, 30)
    assert rl.tr == tr and tiles_x > -(-41 // tr)  # a padding tile
    assert total > 2 * 64 and int((rl.counts > 0).sum()) > 4
    assert not rl.counts.reshape(3, 2, tiles_x)[-1].any()  # the frozen lane lists nothing
    got = render_kernel.fused_render(pk, *args, **kw)
    again = render_kernel.fused_render(pk, *args, **kw)
    want = render_kernel.fused_render_plain(pk, *args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert float(torch.cat([t[-1].reshape(-1) for t in got]).abs().max()) == 0.0
    if dtype == "f32":
        for g, w in zip(got, want):
            assert float(_rel(g, w).max()) <= 2e-5
        return
    _bf16_render_gate(got, want, args[-1], kw["pose_dim"])


@pytest.mark.cuda
def test_render_empty_band(cuda):
    """B2 when no sample of the launch is in the band (every ray invalid):
    the band launch reads a total of 0 on the card and does nothing, and
    every output equals the plain version's zeros."""
    params, spec = _decoder("latent_in", 3, cuda)
    args = list(_render_inputs(spec, cuda, B=2, F=2, R=20, M=10, seed=13))
    args[4] = torch.zeros_like(args[4])  # ray_valid
    kw = dict(pose_dim=6, scale_on=False, log_occ_on=True, occ_cutoff=0.15, occlusion_on=True,
              occlusion_th=0.03, min_grad_th=1e-6)
    pk = mlp_kernels.pack_params(params, spec)
    before = render_kernel.launches_band
    got = render_kernel.fused_render(pk, *args, **kw)
    want = render_kernel.fused_render_plain(pk, *args, **kw)
    torch.cuda.synchronize()
    assert render_kernel.launches_band == before + 1
    for g, w in zip(got, want):
        assert not w.any() and torch.equal(g, w)


def _in_radius_rows(args):
    """The plain count of the samples the forward's chain takes: in radius,
    on a valid ray, of an active lane."""
    pts, ray_valid, bbx, active = args[1], args[4], args[6], args[7]
    inside = (pts * pts).sum(-1) < (bbx * bbx)[..., None, None]
    return int((inside & ray_valid[..., None] & active[:, None, None, None]).sum())


def _traced_fused_render(pk, args, kw):
    """fused_render with tracing forced on: its outputs and the render
    term's device counters of that one call."""
    from hortimapping_tpu_torch.utils import trace

    trace.force(True)
    try:
        got = render_kernel.fused_render(pk, *args, **kw)
        return got, trace.counters()
    finally:
        trace.force(None)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [10, 15, 22, 30])  # bench coarse, berry, bench fine, greenhouse
def test_render_chain_skips_dead_samples(cuda, M):
    """B2's forward runs the decoder on the in-radius samples of valid rays
    of active lanes alone (R = 41: padding tiles at M = 22 and 30, padded
    rays, a frozen lane): `render.fwd_rows` is their plain count and under
    the active lanes' samples (`render.rows`), the outputs hold to the plain
    version under the fused-kernel gate, and two launches agree bit for
    bit."""
    params, spec = _decoder("synthetic_pepper_32", 1, cuda)
    args = _render_inputs(spec, cuda, B=3, F=3, R=41, M=M, seed=20 + M)
    kw = dict(pose_dim=7, scale_on=True, log_occ_on=True, occ_cutoff=0.15, occlusion_on=True,
              occlusion_th=0.03, min_grad_th=1e-6)
    pk = mlp_kernels.pack_params(params, spec, torch.bfloat16)
    got, counters = _traced_fused_render(pk, args, kw)
    again = render_kernel.fused_render(pk, *args, **kw)
    want = render_kernel.fused_render_plain(pk, *args, **kw)
    torch.cuda.synchronize()
    rows = _in_radius_rows(args)
    assert counters["render.fwd_rows"] == rows
    assert counters["render.rows"] == int(args[7].sum()) * 3 * 41 * M > rows > 0
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert float(torch.cat([t[-1].reshape(-1) for t in got]).abs().max()) == 0.0
    assert torch.equal(got[2][..., 3], want[2][..., 3])  # in-radius counts
    _bf16_render_gate(got, want, args[7], kw["pose_dim"])


@pytest.mark.cuda
@pytest.mark.parametrize("reach", ["none", "all"])
def test_render_chain_none_or_all_in_radius(cuda, reach):
    """B2 where no sample lies in radius (no chain row, no band: every
    output the plain version's zeros) and where every sample does (the
    chain takes every sample of the valid rays of active lanes, under the
    fused-kernel gate)."""
    params, spec = _decoder("synthetic_pepper_32", 2, cuda)
    args = list(_render_inputs(spec, cuda, B=3, F=2, R=37, M=30, seed=31))
    args[6] = torch.full_like(args[6], 1e-3 if reach == "none" else 10.0)  # bbx_radius
    kw = dict(pose_dim=7, scale_on=True, log_occ_on=True, occ_cutoff=0.15, occlusion_on=True,
              occlusion_th=0.03, min_grad_th=1e-6)
    pk = mlp_kernels.pack_params(params, spec, torch.bfloat16)
    rl = render_kernel.render_forward(pk, *args, **kw)
    got, counters = _traced_fused_render(pk, args, kw)
    want = render_kernel.fused_render_plain(pk, *args, **kw)
    torch.cuda.synchronize()
    valid = int((args[4] & args[7][:, None, None]).sum()) * 30
    assert counters["render.fwd_rows"] == int(rl.fwd_offsets[-1]) == (0 if reach == "none" else valid)
    if reach == "none":
        assert counters["render.band_rows"] == 0
        for g, w in zip(got, want):
            assert not w.any() and torch.equal(g, w)
        return
    assert torch.equal(got[2][..., 3], want[2][..., 3])
    _bf16_render_gate(got, want, args[7], kw["pose_dim"])


@pytest.mark.cuda
def test_render_frame_card_matches_cpu(cuda):
    """The generator's float64 ray march on the card against the CPU, at
    1280x720 with the 32 fruits of chip_smoke's row (mid-row camera, 0.8 m
    from the fruits). A full CPU march of that frame takes minutes, so the
    CPU marches a seeded sample of 20000 of its pixels (the march is per
    pixel: a pixel's value does not depend on which others are marched).
    The instance id must agree on >= 99.9 % of them, depth within 1e-5 m
    where both hit the same instance (float64 sums in another order move a
    boundary pixel now and then)."""
    from hortimapping_tpu_torch.tools import make_demo_data as gen

    W, H, n = 1280, 720, 32
    cat, base_radius = gen.category(f"{ASSETS}/synthetic_pepper_32")
    proj = cat.projection()
    T_wos, codes = gen.draw_fruits(np.random.default_rng(7), n, cat.spec.code_length)
    fruits = [(np.linalg.inv(T), base_radius * np.exp(proj @ c)) for T, c in zip(T_wos, codes)]
    x_end = 0.12 * (n - 1) / 2
    T_wc = gen.row_poses(50, -x_end, x_end, 0.8)[25]
    K = gen.intrinsics(W, H)
    depth, inst, _ = gen.render_frame(T_wc, K, W, H, fruits, gen.WALL_Z, cuda)
    assert len(np.unique(inst)) > 6   # the wall and several fruits in view
    idx = np.random.default_rng(0).choice(W * H, 20000, replace=False)
    pix = torch.as_tensor(np.stack([idx % W, idx // W], axis=-1).astype(np.float64))
    d_cpu, i_cpu = gen.march_pixels(T_wc, K, pix, fruits, gen.WALL_Z)
    i_cpu, d_cpu = i_cpu.numpy(), d_cpu.numpy().astype(np.float32)
    i_card, d_card = inst.reshape(-1)[idx], depth.reshape(-1)[idx]
    assert (i_card == i_cpu).mean() >= 0.999
    same = (i_card == i_cpu) & (i_cpu > 0)
    assert np.abs(d_card[same] - d_cpu[same]).max() <= 1e-5


@pytest.mark.cuda
def test_served_batch_equals_packed_solve(cuda):
    """A served batch of 8 on the card (the bench config: retrieval warm
    start, coarse-to-fine LM; meshing on) equals `joint_opt_packed` of the
    same 8 requests at width 8: B1 and B2 are bit-equal across launches, so
    latent and pose agree within 1e-5, iteration counts and flags exactly;
    every result carries its mesh, and all four kernels launched on the
    server's worker thread."""
    from hortimapping_tpu_torch.config import JointOptConfig
    from hortimapping_tpu_torch.models.workspace import load_latent_vectors
    from hortimapping_tpu_torch.ops.mesher import MeshExtractor
    from hortimapping_tpu_torch.optim import lm
    from hortimapping_tpu_torch.optim.state import stack_observations
    from hortimapping_tpu_torch.serve import CompletionRequest, CompletionServer
    from hortimapping_tpu_torch.tools.synthetic import SyntheticCategory, make_scene

    params, spec = _decoder("synthetic_pepper_32", 0, cuda)
    table = load_latent_vectors(f"{ASSETS}/synthetic_pepper_32", device=cuda)
    cfg = JointOptConfig(scale_on=True, n_fg_pix=200, n_bg_pix=200, n_frame=10,
                         n_sample_on_ray=30, recon_n_pts=2000, max_iter=50, coarse_to_fine=True,
                         fine_max_iter=2, coarse_frame_stride=4, coarse_ray_frac=0.3,
                         coarse_sample_frac=0.35, coarse_pts_frac=0.3, coarse_max_iter=8,
                         fine_ray_frac=0.6, fine_sample_frac=0.75, fine_pts_frac=0.6,
                         init_mode="retrieval", retrieval_score_pts=128, retrieval_n_scales=1,
                         retrieval_scale_min=1.0, retrieval_scale_max=1.0,
                         retrieval_score_bf16=True)
    cat = SyntheticCategory(spec=spec, base_radius=0.06)
    rng = np.random.default_rng(43)
    reqs = []
    for b in range(8):
        code = (rng.normal(size=spec.code_length) * 0.3).astype(np.float32)
        T_wo = np.eye(4, dtype=np.float32)
        T_wo[:3, 3] = rng.normal(size=3) * 0.1
        obs, _ = make_scene(cat, code, T_wo, n_frames=cfg.n_frame, n_fg=cfg.n_fg_pix,
                            n_bg=cfg.n_bg_pix, n_points=cfg.recon_n_pts, seed=b)
        reqs.append(CompletionRequest(f"fruit_{b}", obs, table.mean(0).cpu().numpy(),
                                      np.linalg.inv(T_wo).astype(np.float32)))
    mesher = MeshExtractor(params, spec, voxels_dim=40, cube_radius=0.08, device=cuda)
    res, _ = lm.joint_opt_packed(
        params, spec, cfg, stack_observations([r.obs for r in reqs], cuda),
        torch.as_tensor(np.stack([r.latent0 for r in reqs])).to(cuda),
        torch.as_tensor(np.stack([r.T_ow0 for r in reqs])).to(cuda), 0.08,
        latent_table=table, device=cuda)
    srv = CompletionServer(params, spec, cfg, 0.08, max_batch=8, max_wait_s=1.0,
                           latent_table=table, mesher=mesher, device=cuda)
    srv.warmup(reqs[0])
    counts = (mlp_kernels.launches, render_kernel.launches, mlp_kernels.launches_fwd,
              mlp_kernels.launches_shared_latent)
    with srv:
        got = [f.result(timeout=600) for f in [srv.submit(r) for r in reqs]]
    after = (mlp_kernels.launches, render_kernel.launches, mlp_kernels.launches_fwd,
             mlp_kernels.launches_shared_latent)
    assert all(a > c for a, c in zip(after, counts)), (counts, after)
    for i, g in enumerate(got):
        assert g.batch_size == 8 and g.mesh is not None and g.mesh.faces.shape[0] > 100
        assert g.iter_count == int(res.iter_count[i]) and g.failed == bool(res.failed[i])
        np.testing.assert_allclose(g.latent, res.latent[i].cpu().numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(g.T_ow, res.T_ow[i].cpu().numpy(), atol=1e-5, rtol=0)


def _sphere_sdf_experiment(root, n_scenes=4, n=2048, width=64, code_length=8, seed=0):
    """SdfSamples of spheres (radius 5-8 cm, points around the surface) and
    an experiment of 3 x `width` layers taking all scenes in one step."""
    import json
    import os

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "data", "SdfSamples"))
    for s in range(n_scenes):
        r = 0.05 + 0.03 * rng.random()
        pts = rng.normal(size=(n, 3))
        pts *= r * (1.0 + rng.normal(size=(n, 1)) * 0.3) / np.linalg.norm(pts, axis=-1,
                                                                           keepdims=True)
        sdf = np.linalg.norm(pts, axis=-1) - r
        samples = np.concatenate([pts, sdf[:, None]], axis=-1).astype(np.float32)
        np.savez(os.path.join(root, "data", "SdfSamples", f"sphere_{s:02d}.npz"),
                 pos=samples[sdf >= 0], neg=samples[sdf < 0])
    with open(os.path.join(root, "specs.json"), "w") as f:
        json.dump({"DataSource": os.path.join(root, "data"), "CodeLength": code_length,
                   "NetworkSpecs": {"dims": [width] * 3, "latent_in": [1]},
                   "ClampingDistance": 0.1, "ScenesPerBatch": n_scenes,
                   "SamplesPerScene": 1024,
                   "LearningRateSchedule": [{"Initial": 2e-3}, {"Initial": 5e-3}]}, f)
    return str(root)


@pytest.mark.cuda
def test_train_steps_card_match_cpu(cuda, tmp_path, monkeypatch):
    """Two DeepSDF training steps (3 x 64, C = 8, 4 scenes of 1024 samples)
    on the card against the same steps on the CPU: the same init and the
    CPU generator's draws replayed on the card. f32 on both (TF32 pinned
    off): the losses agree to 1e-6 (the predictions differ by f32 rounding,
    ~2e-7; TF32's 10-bit mantissa would move them ~1e-3), the parameters to
    2e-5, a hundredth of the step's lr (Adam's first steps are ~lr * g /
    |g|; a gradient near zero moves its weight by up to lr * dg / eps)."""
    from hortimapping_tpu_torch.train import deepsdf

    exp_cpu = _sphere_sdf_experiment(tmp_path / "cpu")
    exp_card = _sphere_sdf_experiment(tmp_path / "card")
    spec = DecoderSpec(code_length=8, dims=(64,) * 3, latent_in=(1,))
    init = random_decoder_np(spec, 5)
    monkeypatch.setattr(deepsdf, "init_decoder_params",
                        lambda spec_, g, dev: params_from_jax(init, dev))
    draws, orig = [], deepsdf._draw_step

    def record(*a):
        draws.append(orig(*a))
        return draws[-1]

    monkeypatch.setattr(deepsdf, "_draw_step", record)
    quiet = dict(log=lambda *a: None, save=False, num_epochs=2)
    res_cpu = deepsdf.train_deepsdf(exp_cpu, device="cpu", **quiet)
    replay = iter(draws)
    monkeypatch.setattr(deepsdf, "_draw_step",
                        lambda *a: tuple(t.to(cuda) for t in next(replay)))
    res_card = deepsdf.train_deepsdf(exp_card, device=cuda, **quiet)
    assert next(replay, None) is None and len(draws) == 2
    assert not torch.backends.cuda.matmul.allow_tf32
    assert np.abs(res_card.losses - res_cpu.losses).max() <= 1e-6
    for name in res_cpu.params:
        for k in ("w", "b"):
            d = (res_card.params[name][k].cpu() - res_cpu.params[name][k]).abs().max()
            assert float(d) <= 2e-5, (name, k, float(d))
    assert np.abs(res_card.latent_codes - res_cpu.latent_codes).max() <= 5e-5


@pytest.mark.cuda
def test_one_lane_kernels_match_plain(cuda):
    """The interactive replay's shapes: B1 on one lane of 2000 rows, B2 on
    one lane (B = 1, bf16 under the fused-kernel gate, f32 tight) and B4 on
    one code over the 40^3 grid (bf16 and f32)."""
    from hortimapping_tpu_torch.ops.mesher import create_voxel_grid

    params, spec = _decoder("synthetic_pepper_32", 4, cuda)
    rng = np.random.default_rng(12)
    pk32 = mlp_kernels.pack_params(params, spec)
    pk16 = mlp_kernels.pack_params(params, spec, torch.bfloat16)
    code = torch.as_tensor((rng.normal(size=(1, spec.code_length)) * 0.1).astype(np.float32))
    xyz = torch.as_tensor((rng.normal(size=(1, 2000, 3)) * 0.05).astype(np.float32))
    x = torch.cat([code[:, None].expand(1, 2000, spec.code_length), xyz], -1).to(cuda)
    active = torch.ones(1, dtype=torch.bool, device=cuda)
    got = mlp_kernels.mlp_sdf_and_input_grad(pk32, x, active)
    want = mlp_kernels.mlp_sdf_and_input_grad_plain(pk32, x, active)
    for g, w in zip(got, want):
        _held_to_plain(g, w, "f32")

    args = _render_inputs(spec, cuda, B=1, F=10, R=400, M=30, seed=13)
    args = args[:-1] + (torch.ones(1, dtype=torch.bool, device=cuda),)
    kw = dict(pose_dim=7, scale_on=True, log_occ_on=True, occ_cutoff=0.15, occlusion_on=True,
              occlusion_th=0.03, min_grad_th=1e-6)
    g16 = render_kernel.fused_render(pk16, *args, **kw)
    w16 = render_kernel.fused_render_plain(pk16, *args, **kw)
    ok = w16[2][..., 2] > 0.5
    assert int(ok.sum()) > 0
    for k in (0, 1):
        d = (g16[2][..., k] - w16[2][..., k]).abs()[ok].double()
        assert float(d.median()) <= 2e-3 and float(torch.quantile(d, 0.9)) <= 4e-3
        assert float((d > 1e-3).double().mean()) <= 0.2
    # f32 tight on a slice of 2 frames x 64 rays (as chip_smoke's check)
    lat, pts, depth, is_fg, rv, depths, bbx, act = args
    small = (lat, pts[:, :2, :64].contiguous(), depth[:, :2, :64], is_fg[:64], rv[:, :2, :64],
             depths[:, :2], bbx[:, :2], act)
    g32 = render_kernel.fused_render(pk32, *small, **kw)
    w32 = render_kernel.fused_render_plain(pk32, *small, **kw)
    for g, w in zip(g32, w32):
        assert float(_rel(g, w).max()) <= 2e-5

    grid = torch.as_tensor(create_voxel_grid(40), dtype=torch.float32).to(cuda) * 0.08
    for pk, dtype in ((pk32, "f32"), (pk16, "bf16")):
        got = mlp_kernels.mlp_sdf_shared_latent(pk, code.to(cuda), grid)
        want = mlp_kernels.mlp_sdf_shared_latent_plain(pk, code.to(cuda), grid)
        assert got.shape == (1, 40 ** 3)
        _held_to_plain(got, want, dtype)


@pytest.mark.cuda
def test_kernels_launched_from_threads_match_alone(cuda):
    """B1, B2 (its three launches), B3 and B4 launched at once from 4 host
    threads, each on a stream of its own, 3 times each (the fruit mesh's
    shards launch so): every output equals the same launch made alone, bit
    for bit, and every launch counter reads exactly 3."""
    import sys
    import threading

    params, spec = _decoder("synthetic_pepper_32", 0, cuda)
    pk32 = mlp_kernels.pack_params(params, spec, torch.float32)
    pk16 = mlp_kernels.pack_params(params, spec, torch.bfloat16)
    rng = np.random.default_rng(12)
    t = lambda a: torch.as_tensor(a.astype(np.float32)).to(cuda)
    x = t(rng.normal(size=(4000, spec.in_dim)) * 0.1)
    lat, pts = t(rng.normal(size=(6, spec.code_length)) * 0.1), t(rng.normal(size=(5000, 3)) * 0.05)
    args = _render_inputs(spec, cuda, B=3, F=2, R=37, M=22, seed=7)
    kw = dict(pose_dim=7, scale_on=True, log_occ_on=True, occ_cutoff=0.15, occlusion_on=True,
              occlusion_th=0.03, min_grad_th=1e-6)
    calls = {
        "B1": lambda: mlp_kernels.mlp_sdf_and_input_grad(pk32, x),
        "B2": lambda: render_kernel.fused_render(pk16, *args, **kw),
        "B3": lambda: (mlp_kernels.mlp_sdf(pk16, x),),
        "B4": lambda: (mlp_kernels.mlp_sdf_shared_latent(pk16, lat, pts),),
    }
    alone = {k: fn() for k, fn in calls.items()}
    torch.cuda.synchronize()
    reps = 3
    mlp_kernels.launches = mlp_kernels.launches_fwd = mlp_kernels.launches_shared_latent = 0
    render_kernel.launches = render_kernel.launches_band = render_kernel.launches_sum = 0
    start = threading.Barrier(len(calls))
    out, errors = {}, []

    def run(name):
        try:
            stream = torch.cuda.Stream(device=cuda)
            with torch.cuda.stream(stream):
                start.wait(timeout=60)
                res = [calls[name]() for _ in range(reps)]
                stream.synchronize()
            out[name] = res
        except BaseException as e:   # reported below, in the test's thread
            errors.append((name, e))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(k,)) for k in calls]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    assert not errors, errors
    for name, want in alone.items():
        for got in out[name]:
            assert all(torch.equal(g, w) for g, w in zip(got, want)), name
    assert (mlp_kernels.launches, render_kernel.launches, render_kernel.launches_band,
            render_kernel.launches_sum, mlp_kernels.launches_fwd,
            mlp_kernels.launches_shared_latent) == (reps,) * 6


# ---------------------------------------------------------------- LM loop: solve kernel, graphs

def _lm_case(case, cuda, n=32, seed=3):
    """(params, spec, cfg, obs, latent0, T_ow0) of a served batch of `n`
    synthetic peppers under one of the benchmark's configurations (`bup20`:
    `configs/wild_pepper_tpu.yaml`; `cka`: `configs/cka_pepper_tpu.yaml`;
    `cka_se3`: the same in SE(3), D = 38; `small_8`: the wild config with the
    8-code decoder widened to 128, D = 15), from the table-mean code and a
    pose init 1 cm off."""
    import dataclasses
    import os

    from hortimapping_tpu_torch.config import JointOptConfig, load_config
    from hortimapping_tpu_torch.models.workspace import load_latent_vectors
    from hortimapping_tpu_torch.optim.state import stack_observations
    from hortimapping_tpu_torch.tools.synthetic import SyntheticCategory, make_scene
    from torch_port_common import load_npz_params, widen_decoder_np

    yaml = "cka_pepper_tpu.yaml" if case.startswith("cka") else "wild_pepper_tpu.yaml"
    cfg = JointOptConfig.from_dict(load_config(os.path.join(ASSETS, "..", "configs", yaml)))
    if case == "cka_se3":
        cfg = dataclasses.replace(cfg, scale_on=False)
    if case == "small_8":
        params_np, fields, table, base_radius = load_npz_params("synthetic_small_8")
        params_np, fields = widen_decoder_np(params_np, fields, 128)
        spec = DecoderSpec(**fields)
        params = params_from_jax(params_np, cuda)
        mean = table.mean(0)
    else:
        params, spec = _decoder("synthetic_pepper_32", 0, cuda)
        mean = load_latent_vectors(f"{ASSETS}/synthetic_pepper_32", device="cpu").mean(0).numpy()
        base_radius = 0.06
    cat = SyntheticCategory(spec=spec, base_radius=base_radius)
    rng = np.random.default_rng(seed)
    obs_list, T_list = [], []
    for b in range(n):
        code = (rng.normal(size=spec.code_length) * 0.3).astype(np.float32)
        T_wo = np.eye(4, dtype=np.float32)
        T_wo[:3, 3] = rng.normal(size=3) * 0.1
        o, _ = make_scene(cat, code, T_wo, n_frames=cfg.n_frame, n_fg=cfg.n_fg_pix,
                          n_bg=cfg.n_bg_pix, n_points=cfg.recon_n_pts, seed=seed * 100 + b)
        obs_list.append(o)
        T0 = np.linalg.inv(T_wo).astype(np.float32)
        T0[:3, 3] += rng.normal(size=3).astype(np.float32) * 0.01
        T_list.append(T0)
    lat0 = torch.as_tensor(np.tile(mean[None], (n, 1)).astype(np.float32)).to(cuda)
    return (params, spec, cfg, stack_observations(obs_list, cuda), lat0,
            torch.as_tensor(np.stack(T_list)).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("case,D", [("bup20", 39), ("cka", 39), ("cka_se3", 38), ("small_8", 15)])
def test_solve_kernel_matches_solve_ex(cuda, case, D):
    """The solve kernel on the damped normal equations of real batches (B =
    32, three successive iterates), one launch a solve: within 1e-5 of the
    float64 solution, as a fraction of each lane's largest entry, and within
    1e-5 of `torch.linalg.solve_ex` beyond solve_ex's own distance to that
    solution (on bup20's H, condition ~2e4, solve_ex itself is up to ~3e-5
    from it; the kernel equilibrates first). A lane whose H is singular
    (nothing observed: the pose block zero) comes out non-finite in both,
    the others finite."""
    from hortimapping_tpu_torch.ops import linalg
    from hortimapping_tpu_torch.optim import lm
    from hortimapping_tpu_torch.optim.state import init_state

    params, spec, cfg, obs, lat0, T0 = _lm_case(case, cuda)
    packs = lm.make_packs(params, spec, cfg)
    s = init_state(lat0, T0)
    def rel(a, ref):
        return (a.double() - ref).abs().max(-1).values / ref.abs().max(-1).values

    for _ in range(3):
        H, b, _ = lm.normal_equations(params, spec, cfg, obs, s.latent, s.T_ow, s.i, 0.08, None,
                                      packs)
        assert H.shape[-1] == D
        before = linalg.launches
        got = linalg.solve(H, b)
        want = torch.linalg.solve_ex(H, b[..., None])[0][..., 0]
        exact = torch.linalg.solve(H.double(), b.double()[..., None])[..., 0]
        torch.cuda.synchronize()
        assert linalg.launches == before + 1
        assert bool(torch.isfinite(want).all())
        err, err_ex, gap = rel(got, exact), rel(want, exact), rel(got, want.double())
        print(f"solve kernel, {case} (D = {D}): largest lane error {float(err.max()):.3g}, "
              f"solve_ex's {float(err_ex.max()):.3g}, gap {float(gap.max()):.3g}")
        assert float(err.max()) <= 1e-5
        assert bool((gap <= 1e-5 + err_ex).all())
        s = lm._freeze_if_done(s, lm.lm_iteration(params, spec, cfg, obs, s, 0.08, False, packs))
    H_sing = H.clone()
    H_sing[0, :cfg.pose_dim] = 0.0
    H_sing[0, :, :cfg.pose_dim] = 0.0
    got = linalg.solve(H_sing, b)
    want = torch.linalg.solve_ex(H_sing, b[..., None])[0][..., 0]
    fin_got, fin_want = torch.isfinite(got).all(-1), torch.isfinite(want).all(-1)
    assert torch.equal(fin_got, fin_want) and not bool(fin_got[0]) and bool(fin_got[1:].all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bup20", "cka"])
def test_lm_iteration_captures_inside_a_cuda_graph(cuda, case, monkeypatch):
    """One whole `lm_iteration` at B = 32 (render and SDF terms included)
    captured by `torch.cuda.graph` in its strictest mode: nothing in it
    waits for the device. Its replay equals the eager iteration bit for
    bit."""
    from hortimapping_tpu_torch.optim import lm
    from hortimapping_tpu_torch.optim.state import init_state

    params, spec, cfg, obs, lat0, T0 = _lm_case(case, cuda)
    packs = lm.make_packs(params, spec, cfg)
    s = init_state(lat0, T0)
    monkeypatch.setattr(lm, "CUDA_GRAPHS", False)
    want = lm.lm_iteration(params, spec, cfg, obs, s, 0.08, False, packs)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = lm.lm_iteration(params, spec, cfg, obs, s, 0.08, False, packs)
    g.replay()
    torch.cuda.synchronize()
    for name, a, w in zip(s._fields, got, want):
        assert torch.equal(a, w), name


def _launch_counts():
    from hortimapping_tpu_torch.ops import linalg

    return (mlp_kernels.launches, render_kernel.launches, render_kernel.launches_band,
            render_kernel.launches_sum, linalg.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bup20", "cka"])
def test_graphs_replay_the_eager_solve_bit_for_bit(cuda, case, monkeypatch):
    """A whole solve at B = 32 (bup20: coarse-to-fine, 8 + 2 iterations;
    cka: 50 iterations) with the iteration's graphs on, twice (the first
    captures every key at its second call, the second replays throughout),
    equals the eager solve lane by lane bit for bit; the kernels' launch
    counts and the band rows B2 read are the same, and the traced
    iterations say which replayed."""
    from hortimapping_tpu_torch.optim import lm
    from hortimapping_tpu_torch.utils import trace

    params, spec, cfg, obs, lat0, T0 = _lm_case(case, cuda)
    packs = lm.make_packs(params, spec, cfg)
    solver = lm.coarse_to_fine_joint_opt if cfg.coarse_to_fine else lm.shape_pose_joint_opt_batched

    def run(graphs):
        monkeypatch.setattr(lm, "CUDA_GRAPHS", graphs)
        before, caps = _launch_counts(), lm.graph_captures
        trace.force(True)
        try:
            res = solver(params, spec, cfg, obs, lat0, T0, 0.08, False, cuda, packs)
            counters = trace.counters()
            flags = [sp.attrs["graph"] for sp in trace.spans() if sp.name == "lm.iteration"]
        finally:
            trace.force(False)
        launched = tuple(a - b for a, b in zip(_launch_counts(), before))
        return res, launched, counters["render.band_rows"], flags, lm.graph_captures - caps

    lm._graphed.clear()
    want, launched, rows, flags, caps = run(False)
    assert not any(flags) and caps == 0 and launched[-1] == len(flags)
    for rep in range(2):
        got, launched_g, rows_g, flags_g, caps_g = run(True)
        for name, a, w in zip(want._fields, got, want):
            assert torch.equal(a, w), (rep, name)
        assert launched_g == launched and rows_g == rows, (rep, launched_g, launched)
        assert len(flags_g) == len(flags)
        if rep == 0:
            assert caps_g == (2 if cfg.coarse_to_fine else 1)
            assert flags_g[0] == 0 and sum(flags_g) == len(flags_g) - caps_g
        else:
            assert caps_g == 0 and all(flags_g)
    trace.force(None)
    lm._graphed.clear()
