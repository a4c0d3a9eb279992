"""The host side of the Hopper kernels, on the CPU: the weight streams the
kernels' rings receive, the plain versions of the forward-only kernels B3
and B4 on the same rows, the frozen-lane skip of the SDF term, the tiling
and packing of the render term's band rows, and the kernel sources the
build knows.

The kernels themselves need the card (tests/test_torch_card.py); what is
checked here is everything they are handed. Inputs are made from a seed
with numpy; weights are packed from the same arrays for both packages.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hortimapping_tpu.models import decoder as jdec
from hortimapping_tpu.ops import recon as jrecon
from hortimapping_tpu_torch.models import decoder as tdec
from hortimapping_tpu_torch.models.workspace import config_decoder, params_from_jax
from hortimapping_tpu_torch.ops import cuda_build, mlp_kernels, render_kernel
from hortimapping_tpu_torch.ops import recon as trecon
from torch_port_common import ASSETS, random_decoder_np

torch.set_num_threads(1)

SPECS = {
    "latent_in": dict(code_length=8, dims=(128,) * 4, latent_in=(2,), clamping_distance=0.1),
    "no_skip": dict(code_length=8, dims=(128,) * 3, latent_in=(), clamping_distance=0.1),
    "synthetic_pepper_32": None,  # the asset decoder: 32-d code, 8 x 512, latent_in 4
}


def _decoder(name):
    if SPECS[name] is None:
        return config_decoder(f"{ASSETS}/{name}", device="cpu")
    spec = tdec.DecoderSpec(**SPECS[name])
    return params_from_jax(random_decoder_np(jdec.DecoderSpec(**SPECS[name]), 3), "cpu"), spec


# ---------------------------------------------------------------- weight streams

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(SPECS))
def test_weight_streams_unpack_exactly(name, dtype):
    """Both streams read back bit for bit to the packed matrices, with zero
    padding where the kernels pad layer 0; the stages come in the order a
    chunk consumes them (forward: layer 0, 1, ..; backward: last to first)."""
    params, spec = _decoder(name)
    pk = mlp_kernels.pack_params(params, spec, dtype)
    fwd, bwd = mlp_kernels.unpack_streams(pk)
    k = pk.in_dim
    assert len(fwd) == len(bwd) == pk.n_mid + 1
    assert fwd[0].dtype == bwd[0].dtype == dtype
    assert torch.equal(fwd[0][:k], pk.w0) and not fwd[0][k:].any()
    assert torch.equal(bwd[-1][:, :k], pk.w0.t()) and not bwd[-1][:, k:].any()
    for j in range(pk.n_mid):
        assert torch.equal(fwd[1 + j], pk.wm[j])
        assert torch.equal(bwd[pk.n_mid - 1 - j], pk.wmt[j])
    # a bf16 stage is K-major core matrices: its first 16 bytes are rows
    # 0..7 of column 0 of W, the next 16 bytes column 1
    if dtype == torch.bfloat16:
        W = fwd[1] if pk.n_mid else fwd[0]
        flat = pk.fwd_stream[fwd[0].numel():] if pk.n_mid else pk.fwd_stream
        assert torch.equal(flat[:8], W[:8, 0]) and torch.equal(flat[8:16], W[:8, 1])


# ---------------------------------------------------------------- B3 and B4

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(SPECS))
def test_shared_latent_plain_equals_forward_plain_on_materialised_rows(name, dtype):
    """B4's plain version is B3's on each code's materialised [code | xyz]
    rows, bit for bit (the card holds the two kernels to the same). One code
    a call: the CPU's matmuls may sum in another order at another row count."""
    params, spec = _decoder(name)
    pk = mlp_kernels.pack_params(params, spec, dtype)
    rng = np.random.default_rng(8)
    lat = torch.as_tensor((rng.normal(size=(3, spec.code_length)) * 0.1).astype(np.float32))
    pts = torch.as_tensor((rng.normal(size=(301, 3)) * 0.05).astype(np.float32))
    got = mlp_kernels.mlp_sdf_shared_latent_plain(pk, lat, pts)
    rows = torch.cat([lat[:, None, :].expand(3, 301, spec.code_length),
                      pts.expand(3, 301, 3)], dim=-1)
    assert got.shape == (3, 301)
    for b in range(3):
        assert torch.equal(got[b], mlp_kernels.mlp_sdf_plain(pk, rows[b]))


def test_shared_latent_chunk_limit():
    """B4's chunk indices are ints: the wrapper refuses more than MAX_CHUNKS
    64-point chunks before it reaches the card."""
    params, spec = _decoder("no_skip")
    pk = mlp_kernels.pack_params(params, spec)
    lat = torch.zeros(2, spec.code_length)
    pts = torch.zeros(64 * (mlp_kernels.MAX_CHUNKS // 2) + 1, 3, device="meta")
    with pytest.raises(ValueError, match="chunks"):
        mlp_kernels._shared_latent_cuda(pk, lat.to("meta"), pts)


# ---------------------------------------------------------------- SDF term, frozen lanes

@pytest.mark.parametrize("packed", [True, False], ids=["kernel_path", "autograd_path"])
def test_sdf_residuals_lane_active_match_jax(packed):
    """Active lanes equal JAX's `sdf_residuals`; frozen lanes are zero (the
    kernel skips them), whichever path computes the term."""
    fields = SPECS["latent_in"]
    jspec, tspec = jdec.DecoderSpec(**fields), tdec.DecoderSpec(**fields)
    params_np = random_decoder_np(jspec, 10)
    rng = np.random.default_rng(12)
    B, N = 4, 70
    lat = (rng.normal(size=(B, 8)) * 0.1).astype(np.float32)
    pts = (rng.normal(size=(B, N, 3)) * 0.05).astype(np.float32)
    valid = np.arange(N)[None, :] < np.array([[60], [70], [50], [65]])
    active = np.array([True, False, True, False])
    jp = jax.tree_util.tree_map(jnp.asarray, params_np)
    tp = params_from_jax(params_np, "cpu")
    pk = mlp_kernels.pack_params(tp, tspec) if packed else None
    got = trecon.sdf_residuals(tp, tspec, torch.as_tensor(lat), torch.as_tensor(pts),
                               torch.as_tensor(valid), True, pk, torch.as_tensor(active))
    for b in range(B):
        if not active[b]:
            assert not got.res[b].any() and not got.jac[b].any()
            continue
        want = jrecon.sdf_residuals(jp, jspec, jnp.asarray(lat[b]), jnp.asarray(pts[b]),
                                    jnp.asarray(valid[b]), True)
        for g, w in ((got.res[b], want.res), (got.jac[b], want.jac)):
            w = np.asarray(w, np.float64)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())


def test_lane_mask_must_match_the_lanes():
    params, spec = _decoder("no_skip")
    pk = mlp_kernels.pack_params(params, spec)
    x = torch.zeros(3, 5, spec.in_dim)
    with pytest.raises(ValueError):
        mlp_kernels.mlp_sdf_and_input_grad(pk, x, torch.ones(2, dtype=torch.bool))
    sdf, grad = mlp_kernels.mlp_sdf_and_input_grad(pk, x, torch.tensor([True, False, True]))
    assert sdf.shape == (3, 5) and grad.shape == (3, 5, spec.in_dim) and not grad[1].any()


# ---------------------------------------------------------------- band packing

def test_tiling_pads_to_whole_clusters():
    # M = 30: 4 rays a tile; 10 rays make 3 tiles (the last holds 2), padded
    # with an empty tile to a whole cluster
    tr, tiles_x = render_kernel.tiling(10, 30)
    assert tr == 4 and tiles_x % mlp_kernels.CLUSTER == 0 and tiles_x >= 3
    assert render_kernel.tiling(400, 30) == (4, 100)
    assert render_kernel.tiling(240, 22)[0] == 5
    with pytest.raises(ValueError):
        render_kernel.tiling(10, 129)


def test_band_offsets_pack_in_tile_order():
    """A hand-made launch: 2 frames x 10 rays x M = 30 (4 rays a tile, a
    ragged third tile and a padding tile each). The band rows of each tile,
    counted per slot, packed by the exclusive scan, must come out in sample
    order of the whole launch: (frame, ray, sample), tile after tile."""
    F, R, M = 2, 10, 30
    tr, tiles_x = render_kernel.tiling(R, M)
    rng = np.random.default_rng(0)
    band = rng.random((F, R, M)) < 0.1
    band[0, 0:4] = False            # an empty real tile
    band[1, 8:10, :3] = True        # the ragged tile has band rows
    counts, slots = [], []
    for f in range(F):
        for t in range(tiles_x):
            rows = [(f, r, m) for r in range(t * tr, min((t + 1) * tr, R))
                    for m in range(M) if band[f, r, m]]
            counts.append(len(rows))
            slots.append(rows)
    offsets = render_kernel.band_offsets(torch.tensor(counts, dtype=torch.int32))
    assert offsets.dtype == torch.int32 and int(offsets[0]) == 0
    assert int(offsets[-1]) == int(band.sum())
    packed = [None] * int(offsets[-1])
    for t, rows in enumerate(slots):
        assert int(offsets[t + 1]) - int(offsets[t]) == len(rows)
        for i, row in enumerate(rows):
            packed[int(offsets[t]) + i] = row
    assert packed == [tuple(ix) for ix in np.argwhere(band)]
    # the band kernel finds each packed row's tile as the last t with
    # offsets[t] <= q, which skips the empty tiles
    off = offsets.numpy()
    for q in range(int(off[-1])):
        t = int(np.searchsorted(off[:-1], q, side="right")) - 1
        assert off[t] <= q < off[t + 1]


# ---------------------------------------------------------------- kernel sources

def test_every_kernel_source_is_built_and_every_header_included():
    """Each csrc/*.cu is a library the build makes, and each csrc/*.cuh is
    included by one of them: no dead kernel source is left behind."""
    names = sorted(os.listdir(cuda_build.CSRC))
    cus = [n[:-3] for n in names if n.endswith(".cu")]
    assert sorted(cus) == sorted(cuda_build.KERNELS)
    included = set()
    for n in cus:
        with open(os.path.join(cuda_build.CSRC, n + ".cu")) as f:
            included |= set(re.findall(r'^#include "([^"]+)"', f.read(), re.M))
    assert {n for n in names if n.endswith(".cuh")} <= included
    assert included <= set(names)
