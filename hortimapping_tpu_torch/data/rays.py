"""Ray/pixel sampling: per-frame render observations of one submap from
instance-id and depth images (counterpart of `hortimapping_tpu/data/rays.py`).

Host numpy by design, with the JAX package's draws in its order: without an
explicit `rng`, `get_render_data` draws from numpy's global generator (the
pipelines seed it with `utils.misc.set_random_seed(42)`), first the
background subsample of a frame, then its foreground subsample.
  * a frame is a valid match only if >= `min_pix_count_match` pixels carry
    the submap id AND a positive depth;
  * the mask bbox is padded by `n_bg_pad` pixels, clipped to the image, and
    frames with a bbox side > `max_bbx_size` are rejected;
  * a dense linspace grid over the bbox is split into fg (mask & valid
    depth) and bg (~mask, depth irrelevant) pixels;
  * each set is randomly subsampled to `n_fg_pix` / `n_bg_pix`;
  * ray directions are invK @ [u, v, 1].
`render_data_to_observations` packs one fruit's samples into fixed-shape
numpy buffers; `optim/state.stack_observations` batches them onto the
device in one upload per field.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from hortimapping_tpu_torch.optim.state import FruitObservations


def get_rays(sampled_pixels: np.ndarray, invK: np.ndarray) -> np.ndarray:
    """Pixel coords (N, 2) in [u, v] order + invK -> cam-frame ray dirs (N, 3)."""
    n = sampled_pixels.shape[0]
    u_hom = np.concatenate([sampled_pixels, np.ones((n, 1))], axis=-1)
    return (u_hom @ invK.T).astype(np.float32)


def get_render_data(
    submap_id: int,
    id_imgs: Dict[str, np.ndarray],
    depth_imgs: Dict[str, np.ndarray],
    cam_poses: Dict[str, np.ndarray],
    img_size: Sequence[int],
    invK: np.ndarray,
    n_fg_pix: int,
    n_bg_pix: int,
    n_bg_pad: int,
    min_pix_count_match: int = 400,
    max_bbx_size: int = 300,
    down_rate: int = 1,
    rng: Optional[np.random.Generator] = None,
) -> Dict:
    """Per-frame fg/bg ray samples for one submap (host numpy).

    id_imgs maps frame id -> instance-id image; a pixel belongs to the fruit
    when `id_img == submap_id`. Returns a dict of per-frame lists of numpy
    arrays and the matched-frame `count`.
    """
    render_data: Dict = {
        "frame_id": [], "T_wc": [], "rays_fg": [], "rays_bg": [],
        "depth_fg": [], "depth_bg": [], "pix_fg": [], "pix_bg": [], "count": 0,
    }
    choice = (rng.choice if rng is not None else np.random.choice)

    for img_id, submap_id_img in id_imgs.items():
        depth_img = depth_imgs[img_id]
        mask_bool = submap_id_img == submap_id
        valid_mask_bool = mask_bool & (depth_img > 0.0)
        if np.count_nonzero(valid_mask_bool) < min_pix_count_match:
            continue
        mask_v, mask_u = np.where(valid_mask_bool)
        min_v = max(mask_v.min() - n_bg_pad, 0)
        max_v = min(mask_v.max() + n_bg_pad, img_size[0] - 1)
        min_u = max(mask_u.min() - n_bg_pad, 0)
        max_u = min(mask_u.max() + n_bg_pad, img_size[1] - 1)
        bbx_h, bbx_w = max_v - min_v + 1, max_u - min_u + 1
        if bbx_h > max_bbx_size or bbx_w > max_bbx_size:
            continue  # wrong data association (utils.py:65-66)
        hh = np.linspace(min_v, max_v, int(bbx_h / down_rate)).astype(np.int32)
        ww = np.linspace(min_u, max_u, int(bbx_w / down_rate)).astype(np.int32)
        vv = np.repeat(hh, ww.shape[0])
        uu = np.tile(ww, hh.shape[0])

        valid_bg = ~mask_bool[vv, uu]
        pix_bg = np.stack([uu[valid_bg], vv[valid_bg]], axis=-1)
        depth_bg = depth_img[vv[valid_bg], uu[valid_bg]]
        if pix_bg.shape[0] > n_bg_pix:
            ind = choice(pix_bg.shape[0], n_bg_pix, replace=False)
            pix_bg, depth_bg = pix_bg[ind], depth_bg[ind]

        valid_fg = valid_mask_bool[vv, uu]
        pix_fg = np.stack([uu[valid_fg], vv[valid_fg]], axis=-1)
        depth_fg = depth_img[vv[valid_fg], uu[valid_fg]]
        if pix_fg.shape[0] > n_fg_pix:
            ind = choice(pix_fg.shape[0], n_fg_pix, replace=False)
            pix_fg, depth_fg = pix_fg[ind], depth_fg[ind]

        render_data["frame_id"].append(img_id)
        render_data["rays_fg"].append(get_rays(pix_fg, invK))
        render_data["rays_bg"].append(get_rays(pix_bg, invK))
        render_data["depth_fg"].append(depth_fg.astype(np.float32))
        render_data["depth_bg"].append(depth_bg.astype(np.float32))
        render_data["T_wc"].append(np.asarray(cam_poses[img_id], np.float32))
        render_data["pix_fg"].append(pix_fg)
        render_data["pix_bg"].append(pix_bg)
        render_data["count"] += 1
    return render_data


def render_data_to_observations(
    render_data: Dict,
    points_w: np.ndarray,
    n_frame: int,
    n_fg_pix: int,
    n_bg_pix: int,
    n_points: int,
    frame_indices: Optional[Sequence[int]] = None,
) -> FruitObservations:
    """Pack variable-length per-frame samples into fixed [F, R] buffers.

    <= `n_frame` frames are selected with a linspace over the matched frames
    (pass `frame_indices` to override); rows [0, n_fg) are fg, [n_fg, R) bg,
    padding is masked invalid, and unfilled frame slots are invalid.
    `points_w` are the measured surface points (world frame), padded to
    `n_points`.
    """
    F, R = n_frame, n_fg_pix + n_bg_pix
    count = render_data["count"]
    if frame_indices is None:
        # linspace frame selection, reference optimizer.py:77-78
        frame_indices = np.linspace(0, count - 1, min(n_frame, count)).astype(np.int32).tolist()

    T_wc = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    rays = np.zeros((F, R, 3), np.float32)
    ray_valid = np.zeros((F, R), bool)
    depth_obs = np.zeros((F, R), np.float32)
    frame_valid = np.zeros(F, bool)

    for slot, idx in enumerate(frame_indices[:F]):
        rf, rb = render_data["rays_fg"][idx], render_data["rays_bg"][idx]
        df, db = render_data["depth_fg"][idx], render_data["depth_bg"][idx]
        nf, nb = min(rf.shape[0], n_fg_pix), min(rb.shape[0], n_bg_pix)
        T_wc[slot] = render_data["T_wc"][idx]
        rays[slot, :nf] = rf[:nf]
        depth_obs[slot, :nf] = df[:nf]
        ray_valid[slot, :nf] = True
        rays[slot, n_fg_pix : n_fg_pix + nb] = rb[:nb]
        depth_obs[slot, n_fg_pix : n_fg_pix + nb] = db[:nb]
        ray_valid[slot, n_fg_pix : n_fg_pix + nb] = True
        frame_valid[slot] = True

    pts = np.zeros((n_points, 3), np.float32)
    np_actual = min(points_w.shape[0], n_points)
    pts[:np_actual] = points_w[:np_actual]
    point_valid = np.arange(n_points) < np_actual

    # host numpy: `stack_observations` uploads the batch once a field
    return FruitObservations(
        T_wc=T_wc,
        rays=rays,
        ray_valid=ray_valid,
        depth_obs=depth_obs,
        frame_valid=frame_valid,
        points_w=pts,
        point_valid=point_valid,
    )
