"""Closed loop of back-to-back batches of `batch` in-memory fruits through
the greenhouse evaluation's path: each batch stacked and uploaded, solved
by `warmstart_solve` (retrieval, LM, rescue) and meshed by
`complete_mesh_batch`, the next started when the last one's meshes are on
the host. The window ends at the end of the batch that crosses `--seconds`.

The pool splits into fixed batches of `batch` fruits, run in turn, so that
every seed gives the same work; the seed picks the batch to start with,
the order of the lanes in each batch and every fruit's pose offset.

Parameters: batch, pool, pool_seed, pose_offset_sigma_m.
"""

from __future__ import annotations

import time

import numpy as np

from lib.harness import Done, Window
from lib.scenes import Request, make_requests


def batch_requests(pool, B: int, k: int, seed: int, offset_sigma_m: float):
    """The k-th batch of the window: the pool's fixed batch (start + k) mod
    the number of batches, its lanes in a seeded order, each fruit's pose
    init offset by N(0, offset_sigma_m^2) per axis."""
    n_batches = len(pool) // B
    rng = np.random.default_rng([seed, 0xBA7C4, k])
    first = int(np.random.default_rng([seed, 0xBA7C4]).integers(n_batches))
    lo = ((first + k) % n_batches) * B
    out = []
    for j, s in enumerate(lo + rng.permutation(B)):
        T = pool[s].T_wo.copy()
        T[:3, 3] += rng.normal(size=3) * offset_sigma_m
        out.append(Request(f"b{k}_{j:02d}", int(s), np.linalg.inv(T).astype(np.float32)))
    return out


def prepare(ctx):
    p = ctx.params
    warm = make_requests(ctx.pool, p["batch"], p["pose_offset_sigma_m"], ctx.seed, stream=2)
    ctx.program.solve_batch(ctx.pool, warm)


def window(ctx) -> Window:
    p = ctx.params
    B = p["batch"]
    out = []
    t0 = time.perf_counter()
    k = 0
    while True:
        reqs = batch_requests(ctx.pool, B, k, ctx.seed, p["pose_offset_sigma_m"])
        ctx.rec.begin_batch([r.key for r in reqs], B)
        res, meshes = ctx.program.solve_batch(ctx.pool, reqs)
        now = time.perf_counter()
        lat, T, bad = (res.latent.cpu().numpy(), res.T_ow.cpu().numpy(),
                       res.failed.cpu().numpy())
        for i, r in enumerate(reqs):
            out.append(Done(r.key, r.scene, r.T_ow0, t0, now, latent=lat[i], T_ow=T[i],
                            mesh=(meshes[i].vertices, meshes[i].faces), failed=bool(bad[i])))
        k += 1
        if now - t0 >= ctx.seconds:
            break
    failed = sum(o.failed for o in out)
    return Window(t0=t0, t_end=now, done=out, attempted=len(out), failed=failed, notes={"batches": k})


def close(ctx):
    pass
