"""Mean over the window's batches of the server's time outside the solve:
each `serve.batch` span less its `serve.solve` (packing, the grid decode's
enqueue, the read-back copy, host meshing, resolving the results), in ms
(program span)."""

from lib.program_trace import children, in_window


def read(ctx):
    batches = in_window(ctx, "serve.batch")
    if not batches:
        return None
    solves = children(ctx, "serve.solve")
    if any(b.sid not in solves for b in batches):
        raise RuntimeError("a 'serve.batch' span without its 'serve.solve'")
    host = [(b.t1 - b.t0) - (solves[b.sid].t1 - solves[b.sid].t0) for b in batches]
    return sum(host) / len(host) / 1e6
