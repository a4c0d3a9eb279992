"""Visualisation hooks of the pipelines (counterpart of
`hortimapping_tpu/vis/opt_visualizer.py`): the instance colour table and the
no-op visualiser. The interactive Open3D visualiser is not ported
(`ROADMAP.md`), so `make_visualizer` returns the stub, as the JAX package
does wherever Open3D is missing.
"""

from __future__ import annotations

__all__ = ["color_table", "StubVisualizer", "make_visualizer"]

# 10 instance colours, RGB in [0, 1]
color_table = [
    [230.0 / 255.0, 0.0, 0.0],                          # red
    [60.0 / 255.0, 180.0 / 255.0, 75.0 / 255.0],        # green
    [0.0, 0.0, 255.0 / 255.0],                          # blue
    [255.0 / 255.0, 0, 255.0 / 255.0],                  # magenta
    [255.0 / 255.0, 165.0 / 255.0, 0.0],                # orange
    [128.0 / 255.0, 0, 128.0 / 255.0],                  # purple
    [0.0, 255.0 / 255.0, 255.0 / 255.0],                # cyan
    [210.0 / 255.0, 245.0 / 255.0, 60.0 / 255.0],       # lime
    [250.0 / 255.0, 190.0 / 255.0, 190.0 / 255.0],      # pink
    [0.0, 128.0 / 255.0, 128.0 / 255.0],                # teal
]


class StubVisualizer:
    """No-op visualiser with the interface the pipelines call."""

    interactive = False  # pipelines take the batched solve

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
        """The skip flag (the interactive visualiser blocks for a key)."""
        return self.skip_flag

    def destroy_window(self) -> None:
        pass


def make_visualizer(vis_on: bool, frame_axis_len: float = 0.1,
                    pause_time_s: float = 1e-2) -> StubVisualizer:
    """The stub, whatever `vis_on` says: the interactive visualiser is not
    ported."""
    return StubVisualizer(frame_axis_len, pause_time_s)
