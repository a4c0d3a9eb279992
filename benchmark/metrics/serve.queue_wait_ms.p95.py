"""95th percentile (nearest rank) of the queue wait of the window's
requests: each one's `serve.queue` span, from the `submit()` that stamped
it to the server's worker taking it into a batch (program span)."""

import math

from lib.program_trace import collected


def read(ctx):
    got = collected(ctx)
    if got is None:
        return None
    keys = {d.key for d in ctx.window.done}
    waits = sorted((s.t1 - s.t0) / 1e6 for s in got[0]
                   if s.name == "serve.queue" and s.attrs.get("fruit") in keys)
    if not waits:
        if keys:
            raise RuntimeError(f"no 'serve.queue' span for the {len(keys)} requests of the window")
        return None
    return waits[math.ceil(0.95 * len(waits)) - 1]
