"""The fused render-residual term: the CUDA kernel and its plain version.

Counterpart of `hortimapping_tpu/ops/pallas_render.py::fused_render`, with
the batch written out: one call covers [B fruits, F frames, R rays, M
samples] (the JAX package vmaps a single-frame kernel over frames and
fruits). The kernel is `csrc/fused_render.cu`: the forward
(`render_forward`: each tile's in-radius samples listed, packed by a scan,
the decoder run on them alone, then the render math per ray), the
input-gradient backward over the band rows of the whole launch packed in
tile order (`band_offsets`, `render_band`), and the per-ray sums
(`render_sum`). A CUDA tensor goes to them and nowhere else, a CPU tensor
takes `fused_render_plain`, the dense math of `ops/render.py` returning the
same outputs.

Outputs: jd, jm [B, F, R, pose_dim + C] per-ray Jacobian sums (pose block
first) and res [B, F, R, 4] = (res_d, res_m, ray_ok, in-radius count). The
frame-level `min_valid_sample` gate is the caller's epilogue.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from hortimapping_tpu_torch.ops import cuda_build
from hortimapping_tpu_torch.ops import mlp_kernels
from hortimapping_tpu_torch.ops.mlp_kernels import STREAM_NAMES, PackedDecoder, chain_plain
from hortimapping_tpu_torch.ops.sdf import logistic_sigma
from hortimapping_tpu_torch.utils import trace

TILE_ROWS = 128             # samples per block: TR = TILE_ROWS // M rays (fused_render.cu kTileRows)
MAX_SMEM = 232448           # dynamic shared memory a block may use on the H100
REC_FLOATS = 8              # floats a band record (fused_render.cu kRec)

# launches since the counts were last set to 0: the forward (one per call,
# its stages together: the count of the TPU kernel's port), band backward,
# per-ray sums (`utils/trace.count`)
launches = 0
launches_band = 0
launches_sum = 0


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _frame_scalars(depths: torch.Tensor, bbx_radius: torch.Tensor):
    """delta_d, d_term_bg, bbx per frame, in the JAX package's op order."""
    M = depths.shape[-1]
    d_min, d_max = depths[..., 0], depths[..., -1]
    delta_d = (d_max - d_min) / (M - 1)
    return delta_d, d_max + delta_d, bbx_radius.to(depths.dtype)


def fused_render_plain(
    pk: PackedDecoder,
    latent: torch.Tensor,        # [B, C]
    pts: torch.Tensor,           # [B, F, R, M, 3] object-frame sample points
    depth_obs: torch.Tensor,     # [B, F, R]
    is_fg: torch.Tensor,         # [R] bool
    ray_valid: torch.Tensor,     # [B, F, R] bool (padding & frame validity)
    depths: torch.Tensor,        # [B, F, M]
    bbx_radius: torch.Tensor,    # [B, F]
    lane_active: Optional[torch.Tensor] = None,  # [B] bool; False zeroes the lane
    *,
    pose_dim: int,
    scale_on: bool,
    log_occ_on: bool,
    occ_cutoff: float,
    occlusion_on: bool,
    occlusion_th: float,
    min_grad_th: float,
    stats: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `fused_render` (dense [R, M] math). A
    `stats` dict receives the samples the function needs: `active_samples`
    (all samples of active lanes) and `band_samples` (those whose
    Jacobians count)."""
    B, F, R, M, _ = pts.shape
    C = latent.shape[-1]
    f32 = torch.float32
    x = torch.cat([latent[:, None, None, None, :].expand(B, F, R, M, C), pts], dim=-1)
    sdf, g = chain_plain(pk, x.reshape(-1, C + 3))
    sdf = sdf.reshape(B, F, R, M)
    g = g.reshape(B, F, R, M, C + 3)

    delta_d, d_term_bg, bbx = _frame_scalars(depths, bbx_radius)
    valid = ((pts * pts).sum(-1) < (bbx * bbx)[..., None, None]) & ray_valid[..., None]
    if log_occ_on:
        sigma = logistic_sigma(occ_cutoff)
        occ_all = torch.sigmoid(-sdf / sigma)
    else:
        occ_all = 0.5 - torch.clamp(sdf, -occ_cutoff, occ_cutoff) / (2.0 * occ_cutoff)
    occ = torch.where(valid, occ_all, torch.zeros_like(occ_all))
    one_minus = 1.0 - occ
    acc = torch.cumprod(one_minus, dim=-1)
    acc_aug = torch.cat([torch.ones_like(acc[..., :1]), acc[..., :-1]], dim=-1)
    term_prob = occ * acc_aug
    term_end = acc[..., -1]
    occ_ray = term_prob.sum(-1)
    d_u = (depths[:, :, None, :] * term_prob).sum(-1) + d_term_bg[..., None] * term_end

    denom = torch.where(one_minus <= 0.0, torch.ones_like(one_minus), one_minus)
    suffix = torch.flip(torch.cumsum(torch.flip(acc, [-1]), dim=-1), [-1])
    de_do = suffix * delta_d[..., None, None] / denom
    dm_do = term_end[..., None] / denom
    if log_occ_on:
        do_ds = -occ * (1.0 - occ) / sigma
    else:
        do_ds = torch.full_like(occ, -1.0 / (2.0 * occ_cutoff))
    mask = valid & (sdf > -occ_cutoff) & (sdf < occ_cutoff) & (de_do > min_grad_th)
    if occlusion_on:
        occluded = (~is_fg) & (depth_obs < d_u - occlusion_th) & (depth_obs > 0.0)
        mask = mask & ~occluded[..., None]
    ray_ok = mask.any(-1)
    if stats is not None:
        act = (torch.ones(B, dtype=torch.bool, device=pts.device) if lane_active is None
               else lane_active.reshape(B))
        stats["active_samples"] = int(act.sum()) * F * R * M
        stats["band_samples"] = int((mask & act.reshape(B, 1, 1, 1)).sum())
    target = torch.where(is_fg, depth_obs, d_term_bg[..., None])
    zero = torch.zeros_like(d_u)
    res_d = torch.where(ray_ok, target - d_u, zero)
    res_m = torch.where(ray_ok, occ_ray - is_fg.to(f32), zero)
    count = valid.sum(-1).to(f32)

    g_xyz = g[..., C:]
    cols = [g_xyz, torch.linalg.cross(pts, g_xyz, dim=-1)]
    if pose_dim == 7:
        cols.append((g_xyz * pts).sum(-1, keepdim=True))
    cols.append(g[..., :C])
    J = torch.cat(cols, dim=-1)                                   # [B, F, R, M, pose+C]
    zw = torch.zeros_like(de_do)
    w_d = torch.where(mask, de_do * do_ds, zw)
    w_m = torch.where(mask, dm_do * do_ds, zw)
    okf = ray_ok.to(f32)[..., None]
    jd = (J * w_d[..., None]).sum(-2) * okf
    jm = (J * w_m[..., None]).sum(-2) * okf
    res = torch.stack([res_d, res_m, ray_ok.to(f32), count], dim=-1)
    if lane_active is not None:
        act = lane_active.reshape(B, 1, 1, 1)
        jd = torch.where(act, jd, torch.zeros_like(jd))
        jm = torch.where(act, jm, torch.zeros_like(jm))
        res = torch.where(act, res, torch.zeros_like(res))
    return jd, jm, res


_argtypes_set = False
_lock = threading.Lock()


def _lib() -> ctypes.CDLL:
    global _argtypes_set
    lib = cuda_build.load("fused_render")
    with _lock:   # declared once, before any thread calls an entry
        if not _argtypes_set:
            p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            streams = [p, p, p, p, p, fl]          # fwd, bwd, wl, b0, bm, bl
            lib.horti_render_select.restype = i
            lib.horti_render_select.argtypes = [
                p, p, p, p,                        # pts, rinfo, fscal, active
                i, i, i, i, i, i,                  # B, F, R, M, tr, tiles_x
                p, p, p,                           # idx, fcounts, stream
            ]
            lib.horti_render_forward.restype = i
            lib.horti_render_forward.argtypes = [
                p, p, p, p, p, p,                  # pts, rinfo, depths, fscal, active, latent
                i, i, i, i, i, i, i,               # B, F, R, M, C, tr, tiles_x
                i, i, i,                           # pose_dim, log_occ_on, occlusion_on
                fl, fl, fl, fl,                    # occ_cutoff, sigma, occlusion_th, min_grad_th
                i, i, i, i, *streams,              # D, n_mid, li, bf16, weight streams
                p, p, p, p,                        # idx, foffsets, packed, sdf
                p, p, p, p,                        # res, recs, counts, stream
            ]
            lib.horti_render_band.restype = i
            lib.horti_render_band.argtypes = [
                p, p, i, i, p,                     # recs, offsets, n_tiles, cap, latent
                i, i, i,                           # C, pose_dim, rays_per_fruit
                i, i, i, i, *streams,              # D, n_mid, li, bf16, weight streams
                p, p, p,                           # cd, cm, stream
            ]
            lib.horti_render_sum.restype = i
            lib.horti_render_sum.argtypes = [
                p, p, p, p, p,                     # recs, offsets, cd, cm, res
                i, i, i, i, i, i, i,               # B, F, R, tr, tiles_x, cap, J
                p, p, p,                           # jd, jm, stream
            ]
            lib.horti_render_smem.restype = ctypes.c_long
            lib.horti_render_smem.argtypes = [i] * 5
            _argtypes_set = True
    return lib


def tiling(R: int, M: int) -> Tuple[int, int]:
    """(tr, tiles_x): whole rays filling TILE_ROWS samples a tile, and the
    tiles of a frame padded to whole clusters (the last real tile may be
    ragged, the padding tiles are empty)."""
    if M > TILE_ROWS:
        raise ValueError(f"M={M} samples per ray exceed a tile of {TILE_ROWS}")
    tr = max(1, TILE_ROWS // M)
    return tr, _round_up(-(-R // tr), mlp_kernels.CLUSTER)


def ray_tile(pk: PackedDecoder, C: int, pose_dim: int, M: int) -> int:
    """Rays per tile (`tiling`); raises where a block of the forward's chain
    or of the band kernel would not fit in shared memory."""
    tr, _ = tiling(1, M)
    lib = _lib()
    for kind in (0, 1):
        smem = lib.horti_render_smem(kind, pk.D, pk.n_mid, pk.in_dim, int(pk.bf16))
        if smem > MAX_SMEM:
            raise ValueError(f"the decoder needs {smem} bytes of shared memory a block")
    return tr


class RenderLaunches(NamedTuple):
    """What the launches of one call share: the tiling, and what the
    forward fills."""

    B: int
    F: int
    R: int
    M: int
    C: int
    J: int
    tr: int
    tiles_x: int
    res: torch.Tensor      # [B, F, R, 4]
    recs: torch.Tensor     # [n_tiles, tr * M, 8] band records
    counts: torch.Tensor   # [n_tiles] int32 band rows a tile
    fwd_offsets: torch.Tensor  # [n_tiles + 1] int32 scan of each tile's in-radius samples


def render_forward(pk, latent, pts, depth_obs, is_fg, ray_valid, depths, bbx_radius,
                   lane_active, *, pose_dim, scale_on, log_occ_on, occ_cutoff,
                   occlusion_on, occlusion_th, min_grad_th) -> RenderLaunches:
    """The forward and the render math of every tile: the residuals and each
    tile's band records. Each tile lists its in-radius samples of valid rays
    of active lanes (`horti_render_select`), a scan of the counts packs
    them, and the decoder runs on those rows alone before the render math
    (`horti_render_forward`). The host never reads the packed total."""
    B, F, R, M, _ = pts.shape
    C = latent.shape[-1]
    dev = pts.device
    f32, i32 = torch.float32, torch.int32
    for name, t in (("pts", pts), ("latent", latent), ("depths", depths)):
        if t.dtype != f32 or t.device != dev:
            raise ValueError(f"{name} must be float32 on {dev}")
    for name in STREAM_NAMES:
        if getattr(pk, name).device != dev:
            raise ValueError(f"packed weight {name} must be on {dev}")
    if pk.in_dim != C + 3 or M < 2:
        raise ValueError(f"latent width {C} / samples {M} do not fit the decoder")
    delta_d, d_term_bg, bbx = _frame_scalars(depths, bbx_radius)
    rinfo = torch.stack(
        [depth_obs.to(f32), is_fg.to(f32).expand(B, F, R), ray_valid.to(f32)], dim=-1
    ).contiguous()
    fscal = torch.stack([delta_d, d_term_bg, bbx], dim=-1).contiguous()
    active = (torch.ones(B, dtype=f32, device=dev) if lane_active is None
              else lane_active.to(f32).reshape(B).contiguous())
    pts = pts.contiguous()
    latent = latent.contiguous()
    depths = depths.contiguous()
    ray_tile(pk, C, pose_dim, M)
    tr, tiles_x = tiling(R, M)
    n_tiles, cap = tiles_x * F * B, tr * M
    if n_tiles * cap >= 2 ** 31:
        raise ValueError("at most 2^31 samples a launch")
    idx = torch.empty(n_tiles, cap, dtype=i32, device=dev)
    fcounts = torch.empty(n_tiles + 1, dtype=i32, device=dev)   # 0, then each tile's
    lib = _lib()
    rc = mlp_kernels.launch(
        lib.horti_render_select, pts, pts.data_ptr(), rinfo.data_ptr(), fscal.data_ptr(),
        active.data_ptr(), B, F, R, M, tr, tiles_x, idx.data_ptr(), fcounts.data_ptr(),
    )
    cuda_build.check(rc, "horti_render_select")
    fwd_offsets = torch.cumsum(fcounts, 0, dtype=i32)
    packed = torch.empty(n_tiles * cap, dtype=i32, device=dev)
    sdf = torch.empty(B, F, R, M, dtype=f32, device=dev)
    res = torch.empty(B, F, R, 4, dtype=f32, device=dev)
    recs = torch.empty(n_tiles, cap, REC_FLOATS, dtype=f32, device=dev)
    counts = torch.empty(n_tiles, dtype=i32, device=dev)
    rc = mlp_kernels.launch(
        lib.horti_render_forward, pts,
        pts.data_ptr(), rinfo.data_ptr(), depths.data_ptr(), fscal.data_ptr(),
        active.data_ptr(), latent.data_ptr(),
        B, F, R, M, C, tr, tiles_x, pose_dim, int(log_occ_on), int(occlusion_on),
        occ_cutoff, logistic_sigma(occ_cutoff), occlusion_th, min_grad_th,
        pk.D, pk.n_mid, pk.li, int(pk.bf16), *pk.stream_ptrs(), pk.bl,
        idx.data_ptr(), fwd_offsets.data_ptr(), packed.data_ptr(), sdf.data_ptr(),
        res.data_ptr(), recs.data_ptr(), counts.data_ptr(),
    )
    cuda_build.check(rc, "horti_render_forward")
    trace.count(globals(), "launches")
    return RenderLaunches(B, F, R, M, C, pose_dim + C, tr, tiles_x, res, recs, counts,
                          fwd_offsets)


def band_offsets(counts: torch.Tensor) -> torch.Tensor:
    """[n_tiles + 1] int32: where each tile's band rows start in the packed
    order (tile order), and the total at the end."""
    out = torch.zeros(counts.shape[0] + 1, dtype=torch.int32, device=counts.device)
    out[1:] = torch.cumsum(counts, 0)
    return out


def render_band(pk, latent, rl: RenderLaunches, offsets: torch.Tensor,
                pose_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The [J] depth and mask contributions of the packed band rows, in
    full 64-row chunks. Their number, offsets[-1], is read on the card (the
    host never waits for it), so cd and cm [n_tiles x cap, J] hold the worst
    case; rows past offsets[-1] are left unwritten."""
    dev = rl.res.device
    rows = rl.counts.shape[0] * rl.tr * rl.M
    cd = torch.empty(rows, rl.J, dtype=torch.float32, device=dev)
    cm = torch.empty(rows, rl.J, dtype=torch.float32, device=dev)
    rc = mlp_kernels.launch(
        _lib().horti_render_band, rl.res,
        rl.recs.data_ptr(), offsets.data_ptr(), rl.counts.shape[0], rl.tr * rl.M,
        latent.contiguous().data_ptr(), rl.C, pose_dim, rl.F * rl.R,
        pk.D, pk.n_mid, pk.li, int(pk.bf16), *pk.stream_ptrs(), pk.bl,
        cd.data_ptr(), cm.data_ptr(),
    )
    cuda_build.check(rc, "horti_render_band")
    trace.count(globals(), "launches_band")
    return cd, cm


def render_sum(rl: RenderLaunches, offsets: torch.Tensor, cd: torch.Tensor,
               cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """jd, jm [B, F, R, J], each ray's contributions summed in sample
    order, times ray_ok."""
    dev = rl.res.device
    jd = torch.empty(rl.B, rl.F, rl.R, rl.J, dtype=torch.float32, device=dev)
    jm = torch.empty_like(jd)
    rc = mlp_kernels.launch(
        _lib().horti_render_sum, rl.res,
        rl.recs.data_ptr(), offsets.data_ptr(), cd.data_ptr(), cm.data_ptr(), rl.res.data_ptr(),
        rl.B, rl.F, rl.R, rl.tr, rl.tiles_x, rl.tr * rl.M, rl.J, jd.data_ptr(), jm.data_ptr(),
    )
    cuda_build.check(rc, "horti_render_sum")
    trace.count(globals(), "launches_sum")
    return jd, jm


def _fused_render_cuda(pk, latent, pts, depth_obs, is_fg, ray_valid, depths, bbx_radius,
                       lane_active, **render_kw):
    rl = render_forward(pk, latent, pts, depth_obs, is_fg, ray_valid, depths, bbx_radius,
                        lane_active, **render_kw)
    if trace.enabled():   # on the card, only while tracing
        lanes = (torch.full((), rl.B, dtype=torch.int64, device=pts.device) if lane_active is None
                 else (lane_active.reshape(-1).to(torch.float32) > 0.5).sum())
        trace.add("render.fwd_rows", rl.fwd_offsets[-1])
        trace.add("render.rows", lanes * (rl.F * rl.R * rl.M))
    offsets = band_offsets(rl.counts)
    trace.add("render.band_rows", offsets[-1])
    cd, cm = render_band(pk, latent, rl, offsets, render_kw["pose_dim"])
    jd, jm = render_sum(rl, offsets, cd, cm)
    return jd, jm, rl.res


def fused_render(pk: PackedDecoder, latent, pts, depth_obs, is_fg, ray_valid, depths,
                 bbx_radius, lane_active=None, **render_kw):
    """The fused render term for the whole batch (arguments as
    `fused_render_plain`). CUDA tensors launch the kernel; CPU tensors take
    the plain version."""
    fn = _fused_render_cuda if pts.is_cuda else fused_render_plain
    return fn(pk, latent, pts, depth_obs, is_fg, ray_valid, depths, bbx_radius,
              lane_active, **render_kw)
