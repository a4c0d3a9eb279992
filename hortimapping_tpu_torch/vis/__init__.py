from hortimapping_tpu_torch.vis.opt_visualizer import (
    OptVisualizer,
    StubVisualizer,
    color_table,
    make_visualizer,
    set_view,
    text_3d,
)

__all__ = ["OptVisualizer", "StubVisualizer", "color_table", "make_visualizer",
           "set_view", "text_3d"]
