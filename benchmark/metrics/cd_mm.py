"""Mean Chamfer-L1 (mm) of every mesh completed in the window against its
fruit's analytic GT surface, by the benchmark's own sampler and Chamfer
(`lib/chamfer.py`), after the window."""

from lib.chamfer import mean_cd_mm
from lib.check import settings


def read(ctx):
    done = [d for d in ctx.window.done if not d.failed]
    if not done:
        return None
    return mean_cd_mm([d.mesh for d in done], [ctx.pool[d.scene].gt for d in done], ctx.dev,
                      settings(ctx.workload)["cd_samples"])
