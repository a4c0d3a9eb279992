"""Visualizer core: geometry/state bookkeeping behind a renderer interface
(counterpart of `hortimapping_tpu/vis/core.py`).

The per-iteration bookkeeping (which meshes, frames and counters are shown,
the display toggles, the pause/skip/viewpoint flags) lives here against a
minimal `Renderer` interface. The Open3D window is one Renderer
(`opt_visualizer._O3dRenderer`, behind `OptVisualizer`); `FakeRenderer`
records every call, so each state transition is testable headless,
including the traced-trajectory replay of the interactive wild pipeline
(`pipeline/wild.py`). Renderer calls, their order, the anchors, toggles and
flags are the JAX package's.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Tuple

import numpy as np


def _scan_bounds(scan) -> Tuple[np.ndarray, np.ndarray]:
    """AABB (lo, hi) of a scan of any accepted type: the framework's
    point-cloud/mesh types (`.aabb()`), open3d geometries
    (`get_axis_aligned_bounding_box()` — the reference passes o3d clouds,
    opt_visualizer.py:171), or anything with `.points`."""
    if hasattr(scan, "aabb"):
        return scan.aabb()
    if hasattr(scan, "get_axis_aligned_bounding_box"):
        box = scan.get_axis_aligned_bounding_box()
        return np.asarray(box.min_bound), np.asarray(box.max_bound)
    pts = np.asarray(scan.points, np.float64)
    return pts.min(axis=0), pts.max(axis=0)


class Renderer:
    """Minimal window interface the visualizer core draws through.

    Geometries are identified by string handles; `add` with an existing
    handle replaces it. Implementations: the Open3D window
    (`opt_visualizer._O3dRenderer`) and `FakeRenderer` (tests).
    """

    def add(self, name: str, geometry, reset_bbox: bool = False) -> None:
        raise NotImplementedError

    def remove(self, name: str) -> None:
        raise NotImplementedError

    def poll(self) -> None:
        """Process window/input events once (may fire key callbacks)."""
        raise NotImplementedError

    def reset_view(self) -> None:
        pass

    def save_viewpoint(self):
        return None

    def restore_viewpoint(self, viewpoint) -> None:
        pass

    def clear(self) -> None:
        raise NotImplementedError

    def destroy(self) -> None:
        pass


class FakeRenderer(Renderer):
    """Records every renderer call; key events are injected by queueing
    callables that poll() executes — the same dispatch shape as GLFW key
    callbacks firing inside Open3D's poll_events()."""

    def __init__(self):
        self.shown: Dict[str, object] = {}
        self.ops: List[Tuple] = []
        self.events: "deque[Callable[[], None]]" = deque()
        self.view_resets = 0
        self.destroyed = False

    def add(self, name, geometry, reset_bbox=False):
        self.shown[name] = geometry
        self.ops.append(("add", name, reset_bbox))

    def remove(self, name):
        self.shown.pop(name, None)
        self.ops.append(("remove", name))

    def poll(self):
        self.ops.append(("poll",))
        while self.events:
            self.events.popleft()()

    def reset_view(self):
        self.view_resets += 1

    def save_viewpoint(self):
        return ("viewpoint", self.view_resets)

    def restore_viewpoint(self, viewpoint):
        self.ops.append(("restore_viewpoint", viewpoint))

    def clear(self):
        self.shown.clear()
        self.ops.append(("clear",))

    def destroy(self):
        self.destroyed = True


def _coordinate_frame(size: float):
    """RGB axis-triad mesh (framework-native stand-in for
    o3d.TriangleMesh.create_coordinate_frame)."""
    from hortimapping_tpu_torch.data.mesh import TriangleMesh

    w = size * 0.02
    verts, faces, colors = [], [], []
    for ax, col in [(0, [1.0, 0, 0]), (1, [0, 1.0, 0]), (2, [0, 0, 1.0])]:
        base = len(verts)
        for corner in range(4):
            v = np.zeros(3)
            v[ax] = size if corner >= 2 else 0.0
            v[(ax + 1) % 3] = w if corner % 2 else -w
            verts.append(v)
            colors.append(col)
        faces += [[base, base + 1, base + 2], [base + 1, base + 3, base + 2]]
    return TriangleMesh(np.asarray(verts, np.float32),
                        np.asarray(faces, np.int32),
                        np.asarray(colors, np.float64))


def _translate(mesh, offset: np.ndarray):
    T = np.eye(4)
    T[:3, 3] = np.asarray(offset, np.float64)
    return mesh.transform(T)


class VisualizerCore:
    """All OptVisualizer bookkeeping, renderer-agnostic.

    State parity with the reference (`opt_visualizer.py:112-135,155-220,
    330-365`): display toggles (mesh/frame/gt/canonical copy), the
    pause/continuous/skip flags, the canonical-mesh and iteration-counter
    anchors derived from the scan bbox, viewpoint save/restore, and the
    per-iteration mesh+frame+counter update.
    """

    interactive = True  # pipeline/wild.py replays per-iteration meshes

    def __init__(self, renderer: Renderer, frame_axis_len: float = 0.1,
                 pause_time_s: float = 1e-2):
        self.renderer = renderer
        self.frame_axis_len = frame_axis_len
        self.pause_time_s = pause_time_s
        self.skip_flag = False
        self.block_vis = True
        self.play_crun = False
        self.reset_bounding_box = True
        # display toggles (reference opt_visualizer.py:112-121)
        self.render_mesh = True
        self.render_frame = True
        self.render_gt = True
        self.vis_cano = False
        self.global_view = False
        self.cano_tran = np.zeros(3)
        self.txt_tran = np.zeros(3)
        self.iteration = 0
        self.scan = None
        self.gt_scan = None
        self.mesh = None
        self.cano_mesh = None
        self.frame = None
        self._viewpoint = None

    # -- geometry updates ---------------------------------------------------

    def add_scan(self, scan) -> None:
        self.scan = scan
        self.renderer.add("scan", scan, self.reset_bounding_box)
        lo, hi = _scan_bounds(scan)
        # canonical-mesh anchor beside the scan + counter anchor
        # (reference opt_visualizer.py:171-182)
        self.cano_tran = (np.asarray(lo) + np.asarray(hi)) / 2.0
        self.cano_tran[0] += 2 * self.frame_axis_len
        self.txt_tran = np.copy(self.cano_tran)
        self.txt_tran[0] -= 3.5 * self.frame_axis_len
        self._set_txt(0)
        self.renderer.poll()

    def add_gt_scan(self, gt_scan) -> None:
        self.gt_scan = gt_scan
        self.renderer.add("gt", gt_scan, self.reset_bounding_box)
        self.renderer.poll()

    def update_mesh(self, mesh) -> None:
        self.mesh = mesh
        self.renderer.add("mesh", mesh)
        self.renderer.poll()

    def _set_txt(self, iteration: int) -> None:
        """Iteration-counter overlay (reference opt_visualizer.py:349-351)."""
        self.iteration = iteration
        from hortimapping_tpu_torch.vis.opt_visualizer import text_3d

        self.renderer.remove("txt")
        self.renderer.add("txt", text_3d(str(iteration), self.txt_tran))

    def update_mesh_pose(self, cano_mesh, transform, iteration: int) -> None:
        """Show the completed mesh posed by `transform`, the pose frame, the
        optional canonical-frame copy and the iteration counter (reference
        `update_mesh_pose`/`_update_mesh_cano`, `opt_visualizer.py:155-165,
        330-355`)."""
        T = np.asarray(transform, np.float64)
        self.renderer.remove("mesh")
        self.renderer.remove("cano")
        if self.render_mesh:
            self.mesh = cano_mesh.transform(T)
            self.renderer.add("mesh", self.mesh, self.reset_bounding_box)
            if self.vis_cano:
                self.cano_mesh = _translate(cano_mesh, self.cano_tran)
                self.renderer.add("cano", self.cano_mesh)
        self.renderer.remove("frame")
        if self.render_frame:
            self.frame = _coordinate_frame(self.frame_axis_len).transform(T)
            self.renderer.add("frame", self.frame)
        self._set_txt(iteration)
        if self.reset_bounding_box:
            self.renderer.reset_view()
            self.reset_bounding_box = False
        self.renderer.poll()
        self.pause_view()

    # -- window control -----------------------------------------------------

    def update_view(self) -> None:
        self.renderer.poll()

    def pause_view(self) -> None:
        import time

        if self.pause_time_s > 0:
            time.sleep(self.pause_time_s)

    def clean_vis(self) -> None:
        self.skip_flag = False
        self.renderer.clear()
        self.scan = self.gt_scan = self.mesh = self.cano_mesh = self.frame = None
        self.reset_bounding_box = True

    def stop(self) -> bool:
        """Block until SPACE (continue) or N (skip); returns the skip flag,
        which persists until `clean_vis` (`opt_visualizer.py:211-220,
        134-135`)."""
        self.block_vis = True
        while self.block_vis:
            self.renderer.poll()
        return self.skip_flag

    def destroy_window(self) -> None:
        self.renderer.destroy()

    # -- key handlers (bound by the renderer; opt_visualizer.py:243-251) ----

    def on_start_stop(self) -> None:
        self.play_crun = not self.play_crun
        self.block_vis = False

    def on_skip(self) -> None:
        self.skip_flag = True
        self.block_vis = False

    def on_toggle_view(self) -> None:
        """Save/restore the camera viewpoint (reference `_toggle_view`,
        opt_visualizer.py:358-365)."""
        self.global_view = not self.global_view
        self.renderer.reset_view()
        current = self.renderer.save_viewpoint()
        if self._viewpoint is not None and not self.global_view:
            self.renderer.restore_viewpoint(self._viewpoint)
        self._viewpoint = current

    def on_toggle_frame(self) -> None:
        self.render_frame = not self.render_frame
        if self.render_frame and self.frame is not None:
            self.renderer.add("frame", self.frame)
        else:
            self.renderer.remove("frame")

    def on_toggle_mesh(self) -> None:
        self.render_mesh = not self.render_mesh
        if self.render_mesh:
            if self.mesh is not None:
                self.renderer.add("mesh", self.mesh)
            if self.vis_cano and self.cano_mesh is not None:
                self.renderer.add("cano", self.cano_mesh)
        else:
            self.renderer.remove("mesh")
            self.renderer.remove("cano")

    def on_toggle_cano(self) -> None:
        self.vis_cano = not self.vis_cano
        if self.vis_cano and self.render_mesh and self.cano_mesh is not None:
            self.renderer.add("cano", self.cano_mesh)
        elif not self.vis_cano:
            self.renderer.remove("cano")

    def on_toggle_gt(self) -> None:
        self.render_gt = not self.render_gt
        if self.render_gt and self.gt_scan is not None:
            self.renderer.add("gt", self.gt_scan)
        else:
            self.renderer.remove("gt")

    def on_quit(self) -> None:
        self.renderer.destroy()
