"""The port's data layer against the JAX package's on the CPU: image files
against OpenCV, containers, mesh sampling, PLY, DBSCAN, submap cleaning,
pose init and ray sampling on the same seeded numpy inputs. Where the JAX
function is numpy the port must be bit-identical: no tolerance below is
looser than equality unless it says why."""

import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from hortimapping_tpu import native as jnative
from hortimapping_tpu.data import kitti as jkitti
from hortimapping_tpu.data import mesh as jmesh
from hortimapping_tpu.data import ply as jply
from hortimapping_tpu.data import preprocess as jpre
from hortimapping_tpu.data import rays as jrays
from hortimapping_tpu.utils import misc as jmisc
from hortimapping_tpu.vis import color_table as jcolor_table
from hortimapping_tpu_torch import native as tnative
from hortimapping_tpu_torch.data import imageio
from hortimapping_tpu_torch.data import kitti as tkitti
from hortimapping_tpu_torch.data import mesh as tmesh
from hortimapping_tpu_torch.data import ply as tply
from hortimapping_tpu_torch.data import preprocess as tpre
from hortimapping_tpu_torch.data import rays as trays
from hortimapping_tpu_torch.utils import misc as tmisc
from hortimapping_tpu_torch.utils import trace
from hortimapping_tpu_torch.vis import StubVisualizer, color_table, make_visualizer



@pytest.fixture
def cv2():
    """OpenCV, the reference of the image files (on the JAX side only)."""
    return pytest.importorskip("cv2")


# ---------------------------------------------------------------- images

def _images():
    rng = np.random.default_rng(0)
    ramp = np.add.outer(np.arange(40), 3 * np.arange(52)).astype(np.uint8)
    return {
        "gray8": rng.integers(0, 256, (37, 53)).astype(np.uint8),
        "gray8_smooth": ramp,
        "gray16": rng.integers(0, 65536, (41, 29)).astype(np.uint16),
        "bgr8": rng.integers(0, 256, (23, 31, 3)).astype(np.uint8),
    }


@pytest.mark.parametrize("kind", ["gray8", "gray8_smooth", "gray16", "bgr8"])
def test_png_matches_opencv(kind, tmp_path, cv2):
    img = _images()[kind]
    for level in (1, 9):
        path = str(tmp_path / f"cv_{level}.png")
        cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        got = imageio.imread(path)
        assert got.dtype == img.dtype and got.shape == img.shape
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_UNCHANGED))
    path = str(tmp_path / "port.png")
    imageio.imwrite(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert back.dtype == img.dtype
    np.testing.assert_array_equal(back, img)


def _filter_row(ftype, cur, prev, bpp):
    """PNG filter of one row (the encoder side, written out per byte)."""
    out = bytearray(len(cur))
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (cur[i] - pred) & 0xFF
    return bytes([ftype]) + bytes(out)


@pytest.mark.parametrize("kind", ["gray8", "gray16", "bgr8"])
def test_png_all_five_filters(kind, tmp_path, cv2):
    """Rows filtered none, sub, up, average and Paeth in turn decode as
    OpenCV decodes them."""
    img = _images()[kind]
    H, W = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    ctype = 2 if img.ndim == 3 else 0
    px = img[..., ::-1] if img.ndim == 3 else img
    raw = np.ascontiguousarray(px, ">u2" if depth == 16 else np.uint8).view(np.uint8).reshape(H, -1)
    bpp = raw.shape[1] // W
    prev = bytes(raw.shape[1])
    body = b""
    for y in range(H):
        body += _filter_row(y % 5, raw[y].tobytes(), prev, bpp)
        prev = raw[y].tobytes()

    def chunk(kind_, data):
        return struct.pack(">I", len(data)) + kind_ + data + struct.pack(
            ">I", zlib.crc32(kind_ + data) & 0xFFFFFFFF)

    path = str(tmp_path / "filters.png")
    with open(path, "wb") as f:
        f.write(imageio.PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(imageio.imread(path), img)


@pytest.mark.parametrize("compression", ["none", "lzw", "lzw_no_predictor"])
def test_float_tiff_matches_opencv(compression, tmp_path, cv2):
    rng = np.random.default_rng(1)
    depth = np.where(rng.random((67, 45)) > 0.3, rng.random((67, 45)) * 2.0, 0.0)
    depth = depth.astype(np.float32)
    params = {"none": [], "lzw": [cv2.IMWRITE_TIFF_COMPRESSION, 5],
              "lzw_no_predictor": [cv2.IMWRITE_TIFF_COMPRESSION, 5, cv2.IMWRITE_TIFF_PREDICTOR, 1]}
    path = str(tmp_path / "cv.tiff")
    cv2.imwrite(path, depth, params[compression])
    got = imageio.imread(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, depth)
    path = str(tmp_path / "port.tiff")
    imageio.imwrite(path, depth)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, depth)
    np.testing.assert_array_equal(imageio.imread(path), depth)


def test_unsupported_images_raise(tmp_path, cv2):
    from PIL import Image

    gray = _images()["gray8"]
    p = str(tmp_path / "palette.png")
    Image.fromarray(np.stack([gray] * 3, -1)).convert("P").save(p)
    with pytest.raises(ValueError, match="palette"):
        imageio.imread(p)
    p = str(tmp_path / "rgba.png")
    cv2.imwrite(p, np.dstack([_images()["bgr8"], _images()["bgr8"][..., :1]]))
    with pytest.raises(ValueError, match="RGBA"):
        imageio.imread(p)
    # the same gray image with its IHDR's interlace byte set
    p = str(tmp_path / "adam7.png")
    cv2.imwrite(p, gray)
    data = bytearray(open(p, "rb").read())
    data[28] = 1
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    open(p, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        imageio.imread(p)
    p = str(tmp_path / "deflate.tiff")
    cv2.imwrite(p, gray.astype(np.float32), [cv2.IMWRITE_TIFF_COMPRESSION, 8])
    with pytest.raises(ValueError, match="compression 8"):
        imageio.imread(p)
    p = str(tmp_path / "u16.tiff")
    cv2.imwrite(p, _images()["gray16"])
    with pytest.raises(ValueError, match="16 bits"):
        imageio.imread(p)
    with pytest.raises(ValueError, match="extension"):
        imageio.imread(str(tmp_path / "frame.jpg"))
    with pytest.raises(ValueError, match="unsupported PNG array"):
        imageio.encode_png(np.zeros((4, 4), np.float32))


# ---------------------------------------------------------------- containers

def _cloud(colors: bool, n=3000, seed=2):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 0.03 + [0.1, -0.2, 0.5]).astype(np.float32)
    return pts, (rng.random((n, 3)) if colors else None)


def _same_cloud(a, b):
    np.testing.assert_array_equal(a.points, b.points)
    assert (a.colors is None) == (b.colors is None)
    if a.colors is not None:
        np.testing.assert_array_equal(a.colors, b.colors)


@pytest.mark.parametrize("colors", [False, True])
def test_point_cloud_ops_match_jax(colors):
    pts, col = _cloud(colors)
    j, t = jmesh.PointCloud(pts, col), tmesh.PointCloud(pts, col)
    idx = np.arange(0, len(pts), 3)
    _same_cloud(t.select(idx), j.select(idx))
    for a, b in zip(t.aabb(), j.aabb()):
        np.testing.assert_array_equal(a, b)
    lo, hi = [0.09, -0.22, 0.48], [0.13, -0.18, 0.52]
    _same_cloud(t.crop(lo, hi), j.crop(lo, hi))
    T = np.eye(4)
    T[:3, :3] = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]) * 1.1
    T[:3, 3] = [0.3, 0.1, -0.2]
    _same_cloud(t.transform(T), j.transform(T))
    for voxel in (0.005, 0.02):
        _same_cloud(t.voxel_down_sample(voxel), j.voxel_down_sample(voxel))
    _same_cloud(t + t.select(idx), j + j.select(idx))
    assert len(t) == len(j)


def _ellipsoid_mesh(colors: bool):
    from hortimapping_tpu_torch.tools.make_demo_data import partial_fruit_mesh

    T_wo = np.eye(4)
    T_wo[:3, 3] = [0.05, 0.0, 0.45]
    m = partial_fruit_mesh(T_wo, np.array([0.05, 0.06, 0.045]), np.array([0.0, 0.0, -1.0]),
                           grid_n=24)
    c = np.random.default_rng(5).random(m.vertices.shape) if colors else None
    return m.vertices, m.faces, c


@pytest.mark.parametrize("colors", [False, True])
def test_sample_points_uniformly_bit_equal(colors):
    v, f, c = _ellipsoid_mesh(colors)
    jm, tm = jmesh.TriangleMesh(v, f, c), tmesh.TriangleMesh(v, f, c)
    for n, seed in ((5000, 0), (777, 3)):
        _same_cloud(tm.sample_points_uniformly(n, seed=seed),
                    jm.sample_points_uniformly(n, seed=seed))
    np.testing.assert_array_equal(tm.vertex_normals(), jm.vertex_normals())
    empty = tmesh.TriangleMesh(v, np.zeros((0, 3), np.int32))
    assert len(empty.sample_points_uniformly(10)) == 0


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("what", ["mesh", "cloud"])
def test_ply_reads_equal_across_packages(what, binary, tmp_path):
    v, f, c = _ellipsoid_mesh(True)
    for writer, reader in ((jply, tply), (tply, jply)):
        path = str(tmp_path / f"{writer.__name__}.ply")
        if what == "mesh":
            writer.write_mesh(path, writer.TriangleMesh(v, f, c), binary=binary)
            a, b = reader.read_mesh(path), writer.read_mesh(path)
            np.testing.assert_array_equal(a.faces, b.faces)
            np.testing.assert_array_equal(a.vertices, b.vertices)
            np.testing.assert_array_equal(a.vertex_colors, b.vertex_colors)
        else:
            writer.write_point_cloud(path, writer.PointCloud(v, c), binary=binary)
            _same_cloud(reader.read_point_cloud(path), writer.read_point_cloud(path))
        with open(path, "rb") as fh:
            written = fh.read()
        other = str(tmp_path / "other.ply")
        mod = tply if writer is jply else jply
        if what == "mesh":
            mod.write_mesh(other, mod.TriangleMesh(v, f, c), binary=binary)
        else:
            mod.write_point_cloud(other, mod.PointCloud(v, c), binary=binary)
        with open(other, "rb") as fh:
            assert fh.read() == written   # the two writers write the same bytes


# ---------------------------------------------------------------- cleaning and pose init

def _fruit_cloud(seed=3):
    """A dense blob with a far cluster and sparse noise."""
    rng = np.random.default_rng(seed)
    main = rng.normal(size=(1500, 3)) * 0.01
    far = rng.normal(size=(60, 3)) * 0.004 + 0.2
    noise = rng.uniform(-0.3, 0.3, size=(40, 3))
    return np.concatenate([main, far, noise]).astype(np.float32)


def test_dbscan_matches_jax():
    pts = _fruit_cloud()
    for eps, min_pts in ((0.01, 30), (0.005, 5), (0.02, 100)):
        got = tnative.dbscan(pts, eps, min_pts)
        np.testing.assert_array_equal(got, jnative.dbscan(pts, eps, min_pts))
        assert got.max() >= 0 and (got == -1).any()


@pytest.mark.parametrize("filter_isolated", [False, True])
def test_clean_matches_jax(filter_isolated):
    pts = _fruit_cloud()
    _same_cloud(tpre.clean_pcd(tmesh.PointCloud(pts)), jpre.clean_pcd(jmesh.PointCloud(pts)))
    v, f, c = _ellipsoid_mesh(True)
    # a second, small island of triangles far from the fruit
    island_v = v[:60] + 0.3
    keep = np.all(f < 60, axis=1)
    v2 = np.concatenate([v, island_v])
    f2 = np.concatenate([f, f[keep] + v.shape[0]])
    c2 = np.concatenate([c, c[:60]])
    kw = dict(sample_point_count=2000, cluster_dist_thre=0.02, filter_isolated_mesh=filter_isolated,
              filter_cluster_min_tri=int(keep.sum()) + 1)
    got = tpre.clean_mesh(tmesh.TriangleMesh(v2, f2, c2), **kw)
    _same_cloud(got, jpre.clean_mesh(jmesh.TriangleMesh(v2, f2, c2), **kw))
    assert np.all(np.linalg.norm(got.points - [0.05, 0.0, 0.45], axis=1) < 0.1)


def _sphere(r, center, n=500, seed=4):
    pts = np.random.default_rng(seed).normal(size=(n, 3))
    return (pts / np.linalg.norm(pts, axis=1, keepdims=True) * r + center).astype(np.float32)


@pytest.mark.parametrize("case", ["valid", "too_small", "too_large", "bg_yaw", "rot_off",
                                  "y_largest"])
def test_get_pose_init_and_build_T_wo_match_jax(case):
    center = np.array([0.1, 0.0, 0.5])
    r = {"too_small": 0.005, "too_large": 0.2}.get(case, 0.04)
    pts = _sphere(r, center)
    if case == "y_largest":
        pts = (pts - center) * [0.8, 1.2, 0.7] + center
    bg = None
    if case in ("bg_yaw", "rot_off"):
        bg = (np.random.default_rng(6).normal(size=(300, 3)) * 0.01
              + center + [0.03, 0.02, 0.07]).astype(np.float32)
    kw = dict(rot_on=case != "rot_off")
    got = tpre.get_pose_init(tmesh.PointCloud(pts),
                             tmesh.PointCloud(bg) if bg is not None else None, **kw)
    want = jpre.get_pose_init(jmesh.PointCloud(pts),
                              jmesh.PointCloud(bg) if bg is not None else None, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert got[3] == (case not in ("too_small", "too_large"))
    if case == "bg_yaw":
        assert abs(got[1]) > 1e-3
    for rot_on in (True, False):
        for scale_on in (True, False):
            np.testing.assert_array_equal(
                tpre.build_T_wo(got[0], got[1], 1.2, rot_on=rot_on, scale_on=scale_on),
                jpre.build_T_wo(want[0], want[1], 1.2, rot_on=rot_on, scale_on=scale_on))
    v1, v2 = pts[0] - center, pts[1] - center
    assert tpre.get_deg_between_vectors(v1, v2) == jpre.get_deg_between_vectors(v1, v2)


# ---------------------------------------------------------------- ray sampling

def _frames(n_frames=6, H=90, W=120, submap_id=5):
    """Instance-id and depth images with the fruit in a box that moves and
    grows; frame 1 has too few fruit pixels, frame 3 a box too wide for
    `max_bbx_size`, frame 4 no valid depth on the fruit."""
    rng = np.random.default_rng(7)
    ids, depths, poses = {}, {}, {}
    for k in range(n_frames):
        img = rng.integers(0, 3, (H, W)).astype(np.uint8)      # background ids
        side = {1: 6, 3: 70}.get(k, 24 + 2 * k)
        v0, u0 = 10 + 3 * k, 15 + 4 * k
        img[v0:v0 + min(side, 40), u0:u0 + side] = submap_id
        depth = np.where(rng.random((H, W)) > 0.1, rng.random((H, W)) + 0.5, 0.0)
        if k == 4:
            depth[img == submap_id] = 0.0
        T = np.eye(4)
        T[:3, 3] = rng.normal(size=3) * 0.1
        ids[f"{k:05d}"], depths[f"{k:05d}"], poses[f"{k:05d}"] = img, depth, T
    K = np.array([[100.0, 0.0, W / 2], [0.0, 100.0, H / 2], [0.0, 0.0, 1.0]])
    return ids, depths, poses, (H, W), np.linalg.inv(K)


def _same_render_data(got, want):
    assert got["count"] == want["count"] and got["frame_id"] == want["frame_id"]
    for key in ("T_wc", "rays_fg", "rays_bg", "depth_fg", "depth_bg", "pix_fg", "pix_bg"):
        assert len(got[key]) == len(want[key])
        for a, b in zip(got[key], want[key]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("draws", ["global_seed", "explicit_rng"])
def test_get_render_data_bit_equal(draws):
    ids, depths, poses, size, invK = _frames()
    kw = dict(n_fg_pix=150, n_bg_pix=120, n_bg_pad=6, min_pix_count_match=100, max_bbx_size=60)
    out = []
    for mod, misc in ((trays, tmisc), (jrays, jmisc)):
        misc.set_random_seed(42)
        rng = np.random.default_rng(11) if draws == "explicit_rng" else None
        out.append(mod.get_render_data(5, ids, depths, poses, size, invK, rng=rng, **kw))
        out.append(np.random.random(4))   # the global state after the draws
    _same_render_data(out[0], out[2])
    np.testing.assert_array_equal(out[1], out[3])
    got = out[0]
    assert got["frame_id"] == ["00000", "00002", "00005"]   # 1, 3, 4 rejected
    assert any(len(p) == 150 for p in got["pix_fg"]) and any(len(p) == 120 for p in got["pix_bg"])
    np.testing.assert_array_equal(trays.get_rays(got["pix_fg"][0], invK),
                                  jrays.get_rays(got["pix_fg"][0], invK))


@pytest.mark.parametrize("n_frame", [2, 5])
def test_render_data_to_observations_matches_jax(n_frame):
    """With 3 matched frames, n_frame 5 leaves two invalid frame slots."""
    ids, depths, poses, size, invK = _frames()
    rd = trays.get_render_data(5, ids, depths, poses, size, invK, n_fg_pix=150, n_bg_pix=120,
                               n_bg_pad=6, min_pix_count_match=100, max_bbx_size=60,
                               rng=np.random.default_rng(0))
    pts = _sphere(0.04, [0.0, 0.0, 0.5], n=90)
    got = trays.render_data_to_observations(rd, pts, n_frame, 150, 120, 128)
    want = jrays.render_data_to_observations(rd, pts, n_frame, 150, 120, 128)
    assert type(got).__module__ == "hortimapping_tpu_torch.optim.state"
    for name in got._fields:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.frame_valid.sum() == min(n_frame, 3)
    if n_frame == 5:
        assert not got.ray_valid[3:].any()


# ---------------------------------------------------------------- misc and vis

def test_seed_timer_trace_and_vis(tmp_path, monkeypatch):
    tmisc.set_random_seed(42)
    a = (np.random.random(3), np.random.choice(100, 5, replace=False))
    t1 = torch.rand(2)
    jmisc.set_random_seed(42)
    b = (np.random.random(3), np.random.choice(100, 5, replace=False))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    tmisc.set_random_seed(42)
    assert torch.equal(torch.rand(2), t1)

    # the Chrome trace holds the program's spans, on the trace's clock
    monkeypatch.setenv("HORTI_PROFILE_DIR", str(tmp_path))
    with tmisc.trace_if_enabled("probe"):
        with trace.span("probe.span", fruits=2):
            with torch.profiler.record_function("probe.range"):
                torch.ones(4).sum()
    assert os.path.isfile(tmp_path / "probe.json")
    with open(tmp_path / "probe.json") as f:
        events = json.load(f)["traceEvents"]
    (sp,) = [e for e in events if e.get("cat") == "program_span" and e["name"] == "probe.span"]
    (rng,) = [e for e in events if e.get("name") == "probe.range"]
    assert sp["args"]["fruits"] == 2
    assert sp["ts"] - 100 <= rng["ts"] and rng["ts"] + rng["dur"] <= sp["ts"] + sp["dur"] + 100

    assert color_table == jcolor_table
    vis = make_visualizer(True)
    assert isinstance(vis, StubVisualizer) and not vis.interactive and not vis.stop()


# ---------------------------------------------------------------- KITTI

def test_kitti_readers_match_jax(tmp_path):
    """Calibration lines (12 values as 3 x 4, other counts flat, lines
    without a colon or with words skipped) and a velodyne scan, equal to the
    JAX package's readers."""
    rng = np.random.default_rng(11)
    P0 = rng.normal(size=12)
    calib = tmp_path / "calib.txt"
    calib.write_text(
        "P0: " + " ".join(f"{v:.12e}" for v in P0) + "\n"
        "R0_rect: 1 0 0 0 1 0 0 0 1\n"
        "calib_time: 09-Jan-2012 13:57:47\n"
        "no colon on this line\n"
        "Tr_velo_to_cam: " + " ".join(str(v) for v in range(12)) + "\n")
    got, want = tkitti.read_calib_file(str(calib)), jkitti.read_calib_file(str(calib))
    assert sorted(got) == sorted(want) == ["P0", "R0_rect", "Tr_velo_to_cam"]
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), k
    assert got["P0"].shape == (3, 4) and got["R0_rect"].shape == (9,)

    scan = rng.normal(size=(1000, 4)).astype(np.float32)
    scan.tofile(tmp_path / "000000.bin")
    cloud = tkitti.read_velodyne_bin(str(tmp_path / "000000.bin"))
    assert isinstance(cloud, tmesh.PointCloud) and cloud.colors is None
    assert np.array_equal(cloud.points, scan[:, :3])
    assert np.array_equal(cloud.points, jkitti.read_velodyne_bin(str(tmp_path / "000000.bin")).points)
