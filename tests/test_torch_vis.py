"""The port's visualizer against the JAX package's, on the CPU.

* `VisualizerCore` + `FakeRenderer`: every scenario of `tests/test_vis_core.py`
  runs through both packages' cores on the same inputs; the renderer call
  logs, the anchors, the flags and the shown geometry must be equal.
* `text_3d`: points and colours bit for bit to JAX's (PIL's default font)
  for every integer 0-9999, with and without `direction`, and for every
  printable ASCII character and random ASCII strings; the committed glyph
  table equals one regenerated with PIL.
* `_O3dRenderer` / `OptVisualizer` / `set_view` / `make_visualizer`: both
  packages driven against one fake `open3d` module (neither machine has
  Open3D): the same call log, key codes, handlers and help text.
* The interactive wild replay: JAX's fixture (`tests/test_vis_core.py`'s
  `test_wild_pipeline_interactive_replay`) widened to 2 fruits, N pressed on
  the second. The same renderer op sequence; each replayed iteration's mesh
  within half a voxel (mean symmetric nearest-neighbour distance); names,
  validity, reasons and iteration counts equal; latents and T_wo at
  `tests/test_torch_wild.py`'s bounds: within 2e-4 of JAX's run or, where
  a one-ulp change of JAX's start latent moves JAX's own result further,
  within 4x that movement. On this fixture the solved fruit,
  `00002_Sweetpepper.ply`, is such a lane: the reference schedule (mean
  init, 6 unconverged iterations of fixed lambda) moves it 3.6e-2 under
  JAX's one-ulp probe, and the port lies 3.7e-2 from JAX's run.
"""

import os
import random
import shutil
import string
import subprocess
import sys
import types

import numpy as np
import pytest
from PIL import Image, ImageDraw, ImageFont
from scipy.spatial import cKDTree

import hortimapping_tpu.vis.core as jcore
import hortimapping_tpu.vis.opt_visualizer as jvis
from hortimapping_tpu.data import mesh as jmesh
from hortimapping_tpu_torch.data import mesh as tmesh
from hortimapping_tpu_torch.vis import _font
from hortimapping_tpu_torch.vis import core as tcore
from hortimapping_tpu_torch.vis import opt_visualizer as tvis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET_DIR = os.path.join(ROOT, "assets", "synthetic_small_8")
PKGS = {"jax": (jcore, jvis, jmesh), "torch": (tcore, tvis, tmesh)}


# ---------------------------------------------------------------- the core

def _scan(m):
    return m.PointCloud(np.array([[0, 0, 0], [0.1, 0.1, 0.1]], np.float32))


def _mesh(m):
    v = np.array([[0, 0, 0], [0.05, 0, 0], [0, 0.05, 0]], np.float32)
    return m.TriangleMesh(v, np.array([[0, 1, 2]], np.int32))


def _pose():
    T = np.eye(4)
    T[:3, 3] = [1.0, 2.0, 3.0]
    return T


class _FakeBox:
    min_bound = np.zeros(3)
    max_bound = np.full(3, 0.1)


class _O3dLikePcd:
    points = np.array([[0, 0, 0], [0.1, 0.1, 0.1]], np.float64)

    def get_axis_aligned_bounding_box(self):
        return _FakeBox()


class _BarePoints:
    points = np.array([[0, 0, 0], [0.1, 0.1, 0.1]], np.float64)


def _scenario_add_scan(core, r, m):
    core.add_scan(_scan(m))


def _scenario_update_mesh_pose(core, r, m):
    core.add_scan(_scan(m))
    core.update_mesh_pose(_mesh(m), _pose(), iteration=7)
    core.update_mesh_pose(_mesh(m), _pose(), iteration=8)


def _scenario_toggles(core, r, m):
    core.add_scan(_scan(m))
    core.add_gt_scan(_scan(m))
    core.update_mesh_pose(_mesh(m), np.eye(4), 1)
    for toggle in ("on_toggle_mesh", "on_toggle_mesh", "on_toggle_frame", "on_toggle_frame",
                   "on_toggle_gt", "on_toggle_gt", "on_toggle_cano"):
        getattr(core, toggle)()
    core.update_mesh_pose(_mesh(m), np.eye(4), 2)
    core.on_toggle_mesh()
    core.on_toggle_mesh()
    core.on_toggle_cano()
    core.update_mesh_pose(_mesh(m), _pose(), 3)


def _scenario_viewpoint(core, r, m):
    core.on_toggle_view()
    core.on_toggle_view()
    core.on_toggle_view()


def _scenario_stop_and_skip(core, r, m):
    r.events.append(core.on_start_stop)
    core.record = [core.stop()]
    r.events.append(core.on_skip)
    core.record.append(core.stop())
    core.record.append(core.skip_flag)
    core.update_view()
    core.clean_vis()
    core.destroy_window()


def _scenario_foreign_scans(core, r, m):
    core.add_scan(_O3dLikePcd())
    core.add_scan(_BarePoints())


SCENARIOS = {f.__name__[len("_scenario_"):]: f for f in (
    _scenario_add_scan, _scenario_update_mesh_pose, _scenario_toggles, _scenario_viewpoint,
    _scenario_stop_and_skip, _scenario_foreign_scans)}


def _geometry(g):
    """A shown geometry as plain arrays."""
    out = {}
    for k in ("points", "colors", "vertices", "faces", "vertex_colors"):
        v = getattr(g, k, None)
        if v is not None:
            out[k] = np.asarray(v)
    return out


def _run_scenario(pkg, name):
    core_mod, _, mesh_mod = PKGS[pkg]
    r = core_mod.FakeRenderer()
    core = core_mod.VisualizerCore(r, frame_axis_len=0.1, pause_time_s=0.0)
    SCENARIOS[name](core, r, mesh_mod)
    flags = {k: getattr(core, k) for k in (
        "skip_flag", "block_vis", "play_crun", "reset_bounding_box", "render_mesh",
        "render_frame", "render_gt", "vis_cano", "global_view", "iteration")}
    return dict(ops=r.ops, view_resets=r.view_resets, destroyed=r.destroyed, flags=flags,
                cano_tran=core.cano_tran, txt_tran=core.txt_tran,
                record=getattr(core, "record", None),
                shown={k: _geometry(v) for k, v in r.shown.items()})


def _assert_same(a, b, path="state"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_core_scenario_matches_jax(name):
    want = _run_scenario("jax", name)
    got = _run_scenario("torch", name)
    _assert_same(got, want)
    assert got["ops"], name


# ---------------------------------------------------------------- text_3d

def _held_bit_for_bit(text, **kw):
    want = jvis.text_3d(text, [0.25, -0.1, 0.05], **kw)
    got = tvis.text_3d(text, [0.25, -0.1, 0.05], **kw)
    assert got.points.dtype == want.points.dtype
    np.testing.assert_array_equal(got.points, want.points, err_msg=repr(text))
    if want.colors is None:
        assert got.colors is None
    else:
        np.testing.assert_array_equal(got.colors, want.colors, err_msg=repr(text))


@pytest.mark.parametrize("direction", [None, (0.3, -0.5, 0.8)], ids=["plain", "direction"])
def test_text_3d_integers_bit_for_bit(direction):
    for n in range(10000):
        _held_bit_for_bit(str(n), direction=direction)


def test_text_3d_ascii_bit_for_bit():
    chars = string.printable[:95]
    for c in chars:
        _held_bit_for_bit(c)
    rng = random.Random(0)
    for _ in range(2000):
        text = "".join(rng.choice(chars) for _ in range(rng.randint(2, 9)))
        _held_bit_for_bit(text, direction=(0.0, 1.0, 0.2), degree=45.0, density=3)
    _held_bit_for_bit("")
    _held_bit_for_bit("   ")
    with pytest.raises(ValueError, match="é"):
        tvis.text_3d("12é", [0, 0, 0])
    with pytest.raises(NotImplementedError):
        tvis.text_3d("12", [0, 0, 0], font="DejaVuSans.ttf")


def test_glyph_table_regenerates_from_pil():
    """The generating snippet of `vis/_font.py`'s docstring, run with PIL:
    the same table."""
    font = ImageFont.load_default()
    draw = ImageDraw.Draw(Image.new("L", (1, 1)))
    table = {}
    for c in string.printable[:95]:
        box = draw.textbbox((0, 0), c, font=font)
        w, h = box[2] - box[0], box[3] - box[1]
        img = Image.new("L", (max(w, 1), max(h, 1)), 0)
        ImageDraw.Draw(img).text((-box[0], -box[1]), c, fill=255, font=font)
        cover = np.asarray(img).tobytes().hex() if w > 0 and h > 0 else ""
        table[c] = (int(font.getlength(c)), tuple(int(v) for v in box), cover)
    assert table == _font.GLYPHS


# ---------------------------------------------------------------- Open3D window

def _fake_open3d(log):
    """A module standing in for open3d: every call the visualizer makes is
    appended to `log`, geometry as plain lists."""
    o3d = types.ModuleType("open3d")
    o3d.callbacks = {}

    class Vec:
        def __init__(self, a):
            self.a = np.array(a)

    class PointCloud:
        def __init__(self):
            self.points = self.colors = None

    class TriangleMesh:
        def __init__(self, v, f):
            self.vertices, self.triangles, self.vertex_colors = v, f, None

        def compute_vertex_normals(self):
            log.append(("compute_vertex_normals",))

    def describe(g):
        if isinstance(g, TriangleMesh):
            return ("mesh", g.vertices.a.tolist(), g.triangles.a.tolist(),
                    None if g.vertex_colors is None else g.vertex_colors.a.tolist())
        return ("cloud", g.points.a.tolist(), None if g.colors is None else g.colors.a.tolist())

    class ViewControl:
        def convert_to_pinhole_camera_parameters(self):
            log.append(("save_viewpoint",))
            return "camera"

        def convert_from_pinhole_camera_parameters(self, p):
            log.append(("restore_viewpoint", p))

        def __getattr__(self, name):   # set_zoom, set_front, set_lookat, set_up
            return lambda *a: log.append((name,) + a)

    class RenderOption:
        def __setattr__(self, k, v):
            log.append(("render_option", k, v))

    class Window:
        def register_key_callback(self, key, fn):
            log.append(("register_key", key))
            o3d.callbacks.setdefault(key, []).append(fn)

        def create_window(self, window_name):
            log.append(("create_window", window_name))

        def get_render_option(self):
            return RenderOption()

        def get_view_control(self):
            return ViewControl()

        def add_geometry(self, g, reset):
            log.append(("add_geometry", describe(g), reset))

        def remove_geometry(self, g, reset):
            log.append(("remove_geometry", describe(g), reset))

        def __getattr__(self, name):   # poll_events, update_renderer, ...
            return lambda *a: log.append((name,) + a)

    o3d.geometry = types.SimpleNamespace(PointCloud=PointCloud, TriangleMesh=TriangleMesh)
    o3d.utility = types.SimpleNamespace(Vector3dVector=Vec, Vector3iVector=Vec)
    o3d.visualization = types.SimpleNamespace(VisualizerWithKeyCallback=Window)
    return o3d


def _drive_window(pkg, monkeypatch, capsys):
    """OptVisualizer of `pkg` over the fake open3d: made, fed a scan and two
    updates, every key pressed once (Q last). Returns (log, key codes,
    printed help, the core's state)."""
    core_mod, vis_mod, mesh_mod = PKGS[pkg]
    log = []
    o3d = _fake_open3d(log)
    monkeypatch.setitem(sys.modules, "open3d", o3d)
    capsys.readouterr()
    vis = vis_mod.make_visualizer(True, pause_time_s=0.0)
    assert type(vis).__name__ == "OptVisualizer" and vis.interactive
    help_text = capsys.readouterr().out
    vis.add_scan(_scan(mesh_mod))
    vis.add_gt_scan(_scan(mesh_mod))
    vis.update_mesh_pose(_mesh(mesh_mod).paint_uniform_color([0.2, 0.4, 0.6]), _pose(), 3)
    vis.update_mesh_pose(_mesh(mesh_mod), np.eye(4), 4)
    vis_mod.set_view(vis.renderer, zoom=0.5)    # the window's own view control
    vis_mod.set_view(vis)                       # no `.vis` on the visualizer: a no-op
    keys = sorted(o3d.callbacks)
    for key in keys:
        if key in (ord("Q"), 256):
            continue
        for fn in o3d.callbacks[key]:
            fn(None)
            log.append(("state", key, vis.play_crun, vis.skip_flag, vis.block_vis,
                        vis.render_mesh, vis.render_frame, vis.render_gt, vis.vis_cano,
                        vis.global_view))
    vis.clean_vis()
    for key in (256, ord("Q")):
        with pytest.raises(SystemExit) as exc:
            o3d.callbacks[key][0](None)
        assert exc.value.code == 0
    return log, keys, help_text


def test_open3d_window_matches_jax(monkeypatch, capsys):
    want = _drive_window("jax", monkeypatch, capsys)
    got = _drive_window("torch", monkeypatch, capsys)
    assert got[1] == want[1] == sorted([ord(c) for c in "QVFMCNG "] + [256])
    assert got[2] == want[2] and "[ESC / Q] to exit" in got[2]
    assert got[0] == want[0]
    assert ("destroy_window",) in got[0] and ("create_window", "OptVisualizer") in got[0]


def test_make_visualizer_without_open3d(monkeypatch):
    monkeypatch.setitem(sys.modules, "open3d", None)   # import open3d raises ImportError
    for pkg in PKGS:
        _, vis_mod, _ = PKGS[pkg]
        for on in (True, False):
            vis = vis_mod.make_visualizer(on)
            assert type(vis).__name__ == "StubVisualizer" and not vis.interactive
            assert vis.stop() is False
            vis_mod.set_view(vis)
        with pytest.raises(ImportError, match="open3d"):
            vis_mod.OptVisualizer()


def test_make_visualizer_vis_off_with_open3d(monkeypatch):
    monkeypatch.setitem(sys.modules, "open3d", _fake_open3d([]))
    assert type(tvis.make_visualizer(False)).__name__ == "StubVisualizer"
    assert type(tvis.make_visualizer(True)).__name__ == "OptVisualizer"


def test_importing_vis_loads_neither_pil_nor_open3d():
    code = ("import sys\n"
            "import hortimapping_tpu_torch.vis, hortimapping_tpu_torch.pipeline.wild\n"
            "from hortimapping_tpu_torch.vis import text_3d\n"
            "text_3d('0123456789', [0, 0, 0])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('PIL', 'open3d', 'jax',\n"
            "                                                       'hortimapping_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ---------------------------------------------------------------- interactive replay

VIS_CFG = {
    "run_name": "vis_replay", "deepsdf_dir": ASSET_DIR, "baseline_name": "none",
    "begin_submap": 1, "begin_frame": 0, "end_frame": 2000, "every_frame": 1, "device": "tpu",
    "opt": {
        "scale_on": True,
        "lm": {"lm_on": True, "lm_eye": False, "lm_lambda_0": 0.3, "s_damp": 1e-3},
        "pose_init": {"rot_on": True, "scale_on": True},
        "recon": {"n_pts": 200, "cluster_dist_m": 0.01, "robust_th_m": 0.01},
        "render": {
            "n_fg_pix": 48, "n_bg_pix": 32, "n_bg_pad": 8, "n_frame": 3,
            "n_sample_on_ray": 14, "log_sdf_occ": True,
            "occ_cutoff_m": 0.01, "occlusion_on": True, "robust_th_m": 0.05,
        },
        "weight": {"w_recon": 1, "w_depth": 5e-2, "w_mask": 5e-4, "w_codereg": 5e-4},
        "converge": {"max_iter": 6, "epsilon_g": 1e-4, "epsilon_c": 1e-2,
                     "epsilon_t": 1e-3, "epsilon_r": 1.0, "epsilon_s": 1e-3},
        "robust_iter": 4,
        "outlier": {"scale_max": 2.0, "scale_min": 0.3, "rot_max_deg": 89},
    },
    "vis": {"log_on": False, "vis_on": True, "wandb_log_on": False,
            "object_radius_max_m": 0.08, "mc_res_mm": 8.0},
}
SKIP = 1   # the fruit (in phase 1's order) on which N is pressed


def _auto_core(core_mod):
    """A core over a renderer that answers every block: N on fruit SKIP,
    SPACE otherwise; it keeps each replayed mesh's vertices."""

    class AutoRenderer(core_mod.FakeRenderer):
        def __init__(self):
            super().__init__()
            self.core = None
            self.meshes = []

        def add(self, name, geometry, reset_bbox=False):
            super().add(name, geometry, reset_bbox)
            if name == "mesh":
                self.meshes.append(np.asarray(geometry.vertices, np.float64))

        def poll(self):
            super().poll()
            if self.core is not None and self.core.block_vis:
                fruit = sum(op == ("clear",) for op in self.ops) - 1
                skip = fruit == SKIP and not self.core.skip_flag
                (self.core.on_skip if skip else self.core.on_start_stop)()

    r = AutoRenderer()
    core = core_mod.VisualizerCore(r, pause_time_s=0.0)
    r.core = core
    return core, r


@pytest.fixture(scope="module")
def replay_scene(tmp_path_factory):
    if not os.path.isdir(ASSET_DIR):
        pytest.skip("synthetic assets not built")
    from hortimapping_tpu.tools import make_demo_data

    root = str(tmp_path_factory.mktemp("vis_replay") / "scene")
    old = sys.argv
    sys.argv = ["make_demo_data", "--out", root, "--deepsdf_dir", ASSET_DIR, "--n_fruits", "2",
                "--n_frames", "4", "--width", "144", "--height", "108", "--seed", "3"]
    try:
        make_demo_data.main()
    finally:
        sys.argv = old
    return root


def _replay(pkg, scene, tmp, monkeypatch, start_ulp=False):
    import hortimapping_tpu.pipeline.wild as jwild
    import hortimapping_tpu_torch.pipeline.wild as twild

    wild = jwild if pkg == "jax" else twild
    d = os.path.join(tmp, f"{pkg}{'_up' if start_ulp else ''}")
    shutil.copytree(scene, d, ignore=shutil.ignore_patterns("submaps_*"))
    core, r = _auto_core(PKGS[pkg][0])
    cfg = dict(VIS_CFG, data_dir=d, cam_info_path=os.path.join(d, "cam_info.yaml"))
    with monkeypatch.context() as m:
        m.setattr(wild, "make_visualizer", lambda *a, **k: core)
        if start_ulp:   # JAX's traced solve from its start latent moved one ulp up
            import jax.numpy as jnp

            import hortimapping_tpu.optim.lm as jlm

            traced = jlm.shape_pose_joint_opt_traced
            m.setattr(jlm, "shape_pose_joint_opt_traced",
                      lambda p, s, c, o, lat, *a, **k: traced(p, s, c, o,
                                                             jnp.nextafter(lat, jnp.inf), *a, **k))
        if pkg == "jax":
            results = wild.run_wild_completion(cfg, log=lambda *a: None)
        else:
            results = wild.run_wild_completion(cfg, log=lambda *a: None, device="cpu")
    return sorted(results, key=lambda res: res.name), r


def test_interactive_replay_matches_jax(replay_scene, tmp_path, monkeypatch):
    want, r_j = _replay("jax", replay_scene, str(tmp_path), monkeypatch)
    up, _ = _replay("jax", replay_scene, str(tmp_path), monkeypatch, start_ulp=True)
    got, r_t = _replay("torch", replay_scene, str(tmp_path), monkeypatch)

    assert r_t.ops == r_j.ops
    assert [(g.name, g.valid, g.reason, g.iter_count) for g in got] == [
        (w.name, w.valid, w.reason, w.iter_count) for w in want]
    skipped = [g for g in got if g.reason == "optimization failed"]
    solved = [g for g in got if g.iter_count > 0]
    assert len(skipped) == 1 and skipped[0].iter_count == 0 and len(solved) == 1
    # one mesh update per replayed iteration, then one per valid fruit in phase 3
    n_updates = sum(g.iter_count for g in solved) + sum(g.valid for g in got)
    assert len(r_t.meshes) == len(r_j.meshes) == n_updates

    voxel = 2 * 0.08 / (int(2 * 0.08 * 1e3 / 8.0) - 1)
    for a, b in zip(r_t.meshes, r_j.meshes):
        sym = 0.5 * (cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean())
        assert sym <= 0.5 * voxel, (sym, voxel)

    # test_torch_wild.py's bound: 2e-4, or 4x JAX's own movement under a
    # one-ulp change of its start latent where that is larger
    moved = []
    for g, w, u in zip(got, want, up):
        spread = max(np.abs(np.asarray(w.latent) - np.asarray(u.latent)).max(),
                     np.abs(w.T_wo - u.T_wo).max())
        tol = max(2e-4, 4 * float(spread))
        if tol > 2e-4:
            moved.append(g.name)
        np.testing.assert_allclose(g.latent, np.asarray(w.latent), atol=tol, rtol=0,
                                   err_msg=g.name)
        np.testing.assert_allclose(g.T_wo, w.T_wo, atol=tol, rtol=0, err_msg=g.name)
    assert moved == ["00002_Sweetpepper.ply"], moved   # the lane the docstring names
