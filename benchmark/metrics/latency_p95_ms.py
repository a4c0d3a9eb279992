"""95th percentile (nearest rank) of every request of the window, each
timed from when it was due to when its result, mesh included, resolved; a
request that failed or never resolved counts as missing every limit."""

import math


def read(ctx):
    lat = sorted((d.t_done - d.t_due) * 1e3 if not d.failed else math.inf
                 for d in ctx.window.done)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1]
