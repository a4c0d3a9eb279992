"""Optional interactive optimization visualizer (counterpart of
`hortimapping_tpu/vis/opt_visualizer.py`).

An Open3D `VisualizerWithKeyCallback` window shows the input scan, the GT
scan, the evolving completed mesh, the pose frame and an iteration counter,
with the SPACE/N/V/M/F/G/C/Q/ESC key bindings of the reference's
`opt_visualizer.py`. Visualization is host-side and optional (`vis_on:
false` is the performance path): without Open3D the same interface is
served by `StubVisualizer`, a no-op, so every driver calls vis methods
unconditionally. Open3D is imported only where a window is made; the
iteration counter's text is rasterised from the font table of
`vis/_font.py` (PIL's default font, without PIL).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from hortimapping_tpu_torch.vis import _font
from hortimapping_tpu_torch.vis.core import VisualizerCore

__all__ = ["color_table", "text_3d", "StubVisualizer", "OptVisualizer", "make_visualizer"]

# 10 instance colors (reference `color_table`, opt_visualizer.py:21-31)
color_table = [
    [230.0 / 255.0, 0.0, 0.0],          # red
    [60.0 / 255.0, 180.0 / 255.0, 75.0 / 255.0],   # green
    [0.0, 0.0, 255.0 / 255.0],          # blue
    [255.0 / 255.0, 0, 255.0 / 255.0],  # magenta
    [255.0 / 255.0, 165.0 / 255.0, 0.0],# orange
    [128.0 / 255.0, 0, 128.0 / 255.0],  # purple
    [0.0, 255.0 / 255.0, 255.0 / 255.0],# cyan
    [210.0 / 255.0, 245.0 / 255.0, 60.0 / 255.0],  # lime
    [250.0 / 255.0, 190.0 / 255.0, 190.0 / 255.0], # pink
    [0.0, 128.0 / 255.0, 128.0 / 255.0],# teal
]


def text_3d(text: str, pos, direction=None, degree: float = 90.0,
            font: Optional[str] = None, font_size: int = 20,
            density: int = 2):
    """Render a text sprite as a colored point cloud in 3-D space (the
    reference's `text_3d`) — the iteration counter overlay. The glyphs are
    PIL's default font (`vis/_font.py`; `font_size` does not apply to it, as
    in the JAX package), pixels above 128 kept; points and colours equal
    the JAX package's bit for bit. Returns a host `PointCloud`; the Open3D
    visualizer converts it like any scan. Raises NotImplementedError for a
    `font` path (no TrueType rasteriser here) and ValueError for a
    character outside printable ASCII."""
    from hortimapping_tpu_torch.data.mesh import PointCloud

    if font is not None:
        raise NotImplementedError("text_3d: only the built-in font (font=None) is available")
    _, arr = _font.render(text)
    ys, xs = np.nonzero(arr > 128)
    if xs.size == 0:
        return PointCloud(np.zeros((0, 3), np.float32))
    scale = 1e-3 / density
    pts = np.stack([xs * scale, -ys * scale, np.zeros_like(xs, float)], axis=-1)
    # orient: rotate about x by `degree`, then align z with `direction`
    rad = np.deg2rad(degree)
    Rx = np.array([[1, 0, 0], [0, np.cos(rad), -np.sin(rad)], [0, np.sin(rad), np.cos(rad)]])
    pts = pts @ Rx.T
    if direction is not None:
        d = np.asarray(direction, float)
        d = d / np.linalg.norm(d)
        z = np.array([0.0, 0.0, 1.0])
        v = np.cross(z, d)
        c = float(z @ d)
        if np.linalg.norm(v) > 1e-9:
            vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
            R = np.eye(3) + vx + vx @ vx / (1.0 + c)
            pts = pts @ R.T
    pts = pts + np.asarray(pos, float)
    return PointCloud(pts.astype(np.float32),
                      np.tile([[1.0, 1.0, 1.0]], (pts.shape[0], 1)))


def _have_open3d() -> bool:
    try:
        import open3d  # noqa: F401

        return True
    except ImportError:
        return False


class StubVisualizer:
    """No-op visualizer with the full driver-facing interface
    (reference `StubVisualizer`, `opt_visualizer.py:77-83`)."""

    interactive = False  # pipelines skip the per-iteration replay path

    def __init__(self, frame_axis_len: float = 0.1, pause_time_s: float = 1e-2):
        self.frame_axis_len = frame_axis_len
        self.pause_time_s = pause_time_s
        self.skip_flag = False

    def update(self, scan, pose, mesh=None) -> None:
        pass

    def update_mesh(self, mesh) -> None:
        pass

    def update_mesh_pose(self, cano_mesh, transform, iteration: int) -> None:
        pass

    def add_scan(self, scan) -> None:
        pass

    def add_gt_scan(self, gt_scan) -> None:
        pass

    def update_view(self) -> None:
        pass

    def pause_view(self) -> None:
        pass

    def clean_vis(self) -> None:
        pass

    def stop(self) -> bool:
        """Blocks until keypress in the real visualizer; returns the skip
        flag (`opt_visualizer.py:211-220`)."""
        return self.skip_flag

    def destroy_window(self) -> None:
        pass


class _O3dRenderer:
    """Open3D window as a `vis.core.Renderer`: converts framework-native
    geometries to o3d objects, tracks them by handle, and binds the GLFW key
    callbacks to the core's handlers."""

    def __init__(self, core_getter, window_name: str):
        import open3d as o3d

        self._o3d = o3d
        self._core_getter = core_getter  # late-bound: core is built after
        self._shown = {}
        self.vis = o3d.visualization.VisualizerWithKeyCallback()
        self._register_key_callbacks()
        self.vis.create_window(window_name=window_name)
        self.vis.get_render_option().light_on = True
        self.vis.get_render_option().mesh_show_back_face = True
        self.view_control = self.vis.get_view_control()

    # -- conversions --------------------------------------------------------

    def _to_o3d(self, g):
        o3d = self._o3d
        if isinstance(g, (o3d.geometry.PointCloud, o3d.geometry.TriangleMesh)):
            return g
        if hasattr(g, "faces"):
            m = o3d.geometry.TriangleMesh(
                o3d.utility.Vector3dVector(np.asarray(g.vertices, np.float64)),
                o3d.utility.Vector3iVector(np.asarray(g.faces, np.int32)),
            )
            if getattr(g, "vertex_colors", None) is not None:
                m.vertex_colors = o3d.utility.Vector3dVector(
                    np.asarray(g.vertex_colors))
            m.compute_vertex_normals()
            return m
        pcd = o3d.geometry.PointCloud()
        pcd.points = o3d.utility.Vector3dVector(np.asarray(g.points, np.float64))
        if getattr(g, "colors", None) is not None:
            pcd.colors = o3d.utility.Vector3dVector(np.asarray(g.colors, np.float64))
        return pcd

    # -- Renderer interface -------------------------------------------------

    def add(self, name, geometry, reset_bbox=False):
        self.remove(name)
        obj = self._to_o3d(geometry)
        self._shown[name] = obj
        self.vis.add_geometry(obj, reset_bbox)

    def remove(self, name):
        obj = self._shown.pop(name, None)
        if obj is not None:
            self.vis.remove_geometry(obj, False)

    def poll(self):
        self.vis.poll_events()
        self.vis.update_renderer()

    def reset_view(self):
        self.vis.update_renderer()
        self.vis.reset_view_point(True)

    def save_viewpoint(self):
        return self.view_control.convert_to_pinhole_camera_parameters()

    def restore_viewpoint(self, viewpoint):
        self.view_control.convert_from_pinhole_camera_parameters(viewpoint)

    def clear(self):
        self.vis.clear_geometries()
        self._shown.clear()

    def destroy(self):
        self.vis.destroy_window()

    # -- key bindings (opt_visualizer.py:243-251) ---------------------------

    def _register(self, keys: List, callback: Callable) -> None:
        for key in keys:
            self.vis.register_key_callback(
                key if isinstance(key, int) else ord(key),
                lambda _vis, cb=callback: cb())

    def _register_key_callbacks(self) -> None:
        core = self._core_getter
        # 256 = GLFW_KEY_ESCAPE (the reference binds it as ord("A" + 0x100),
        # opt_visualizer.py:244 - ord("\x1b") = 27 would never fire)
        self._register(["Q", 256], lambda: core().on_quit_exit())
        self._register([" "], lambda: core().on_start_stop())
        self._register(["V"], lambda: core().on_toggle_view())
        self._register(["F"], lambda: core().on_toggle_frame())
        self._register(["M"], lambda: core().on_toggle_mesh())
        self._register(["C"], lambda: core().on_toggle_cano())
        self._register(["N"], lambda: core().on_skip())
        self._register(["G"], lambda: core().on_toggle_gt())


class OptVisualizer(VisualizerCore):
    """Open3D-backed interactive visualizer: `vis.core.VisualizerCore`
    bookkeeping drawn through an Open3D window. Import-guarded: constructing
    it without open3d raises with a clear message; use `make_visualizer` to
    fall back to the stub automatically.

    Key map (parity with the reference's printed help, `opt_visualizer.py:235`):
    [SPACE] pause/start, [N] skip this fruit, [V] switch back to the default
    viewpoint, [M] toggle the completed mesh, [F] toggle the pose coordinate
    frame, [G] toggle the ground-truth scan, [C] toggle the mesh in the
    canonical frame, [ESC/Q] exit.
    """

    def __init__(self, frame_axis_len: float = 0.1, pause_time_s: float = 1e-2):
        if not _have_open3d():
            raise ImportError(
                "open3d is required for OptVisualizer; set vis_on: false or "
                "install open3d (StubVisualizer keeps the pipeline fully "
                "functional without it)"
            )
        renderer = _O3dRenderer(lambda: self, self.__class__.__name__)
        super().__init__(renderer, frame_axis_len, pause_time_s)
        print(100 * "*")
        print(
            f"{self.__class__.__name__} initialized. Press [SPACE] to "
            "pause/start, [N] to skip, [V] to switch back to the default "
            "viewpoint, [M] to toggle the completed mesh, [F] to toggle the "
            "pose coordinate frame, [G] to toggle the ground truth mesh if "
            "available, [C] to toggle the mesh visualization in the "
            "canonical frame, [ESC / Q] to exit."
        )

    def on_quit_exit(self) -> None:
        import sys

        self.renderer.destroy()
        sys.exit(0)


def set_view(vis, zoom: float = 0.6, front=(0.0, 0.0, -1.0),
             lookat=(0.0, 0.0, 0.5), up=(0.0, -1.0, 0.0)) -> None:
    """Set the Open3D view-control camera (reference `set_view`,
    `wild_completion/utils.py:482-497`). No-op on a StubVisualizer."""
    ctl = getattr(getattr(vis, "vis", None), "get_view_control", None)
    if ctl is None:
        return
    vc = ctl()
    vc.set_zoom(zoom)
    vc.set_front(list(front))
    vc.set_lookat(list(lookat))
    vc.set_up(list(up))


def make_visualizer(vis_on: bool, frame_axis_len: float = 0.1,
                    pause_time_s: float = 1e-2) -> StubVisualizer:
    """`vis_on and open3d available` -> OptVisualizer, else StubVisualizer."""
    if vis_on and _have_open3d():
        return OptVisualizer(frame_axis_len, pause_time_s)
    return StubVisualizer(frame_axis_len, pause_time_s)
