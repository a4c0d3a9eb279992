"""What a run keeps of the program's work: the benchmark's own wrappers
around the program's entry points, installed for the run and taken off at
its end.

Every run keeps, for each batch the window drives, the lanes' fruits; for
a few batches drawn from the seed it also keeps the start codes and poses
retrieval chose (one scale or a grid of them), for each LM iteration of the
main solve its input and output iterate (references to the program's
tensors, nothing copied), for a few lanes drawn from the seed the render and
SDF residuals of that iteration, and the SDF grids meshed: what the check
holds against the reference. Both solvers are wrapped: the fixed-lambda
iteration (`lm.lm_iteration`) and the trust region's (`lm.lm_iteration_tr`),
whose iterations also keep the point each lane's step was taken from (the
trial it accepted, or the accepted point it rolled back to), the iteration
index that point's normal equations were assembled at, each lane's lambda
and whether it converged. A traced run also records spans (host time,
closed by a synchronize) and the work each kernel family was asked for, for
the per-layer readers: the render and SDF terms' from each LM iteration's
own per-lane flags and observations, the retrieval's from the codes and
points scored, the grid's from the fruits meshed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Iteration:
    shape: tuple                    # (frames, rays, samples a ray, points) of the view
    lat_in: torch.Tensor
    T_in: torch.Tensor
    i_in: torch.Tensor
    done_in: torch.Tensor
    failed_in: torch.Tensor
    lat_out: Optional[torch.Tensor] = None
    T_out: Optional[torch.Tensor] = None
    watched: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    # the trust region's: the point each lane's step was taken from, the
    # iteration index its normal equations were assembled at, the lane's
    # lambda, and whether it left converged
    lin_lat: Optional[torch.Tensor] = None
    lin_T: Optional[torch.Tensor] = None
    lin_i: Optional[torch.Tensor] = None
    lam: Optional[torch.Tensor] = None
    converged: Optional[torch.Tensor] = None


@dataclasses.dataclass
class Batch:
    keys: List[str]                 # the fruits of the real lanes, in lane order
    width: int
    watch: List[int]                # lanes whose residuals are kept
    kept: bool = True               # the batch keeps what the check reads
    n_iters: int = 0                # LM iterations of its main solve
    start_latent: Optional[torch.Tensor] = None
    start_T: Optional[torch.Tensor] = None   # the start pose, its retrieved scale composed
    tr_asm: Optional[torch.Tensor] = None    # [B] assembly index of each lane's accepted point
    grids: Optional[torch.Tensor] = None   # the watched lanes' SDF grids, as meshed
    iters: List[Iteration] = dataclasses.field(default_factory=list)
    rescue: Optional[dict] = None


class Recorder:
    def __init__(self, seed: int, watch_lanes: int, traced: bool, cuda: bool, seconds: float,
                 kept_batches: int):
        self.on = False
        self.traced = traced
        self.cuda = cuda
        self.batches: List[Batch] = []
        self.cur: Optional[Batch] = None
        self._iter: Optional[Iteration] = None
        self._rescue = 0
        self._depth = defaultdict(int)
        self.spans: List[tuple] = []            # (name, t0, t1, batch index)
        self.work: Dict[str, list] = defaultdict(list)
        self._rng = np.random.default_rng([seed, 0x7A7C4])
        self._watch = watch_lanes
        # the times (s into the window) after which the next batch to begin
        # is kept; the window's first batch is always kept
        self._keep_at = sorted(self._rng.uniform(0.0, seconds, max(kept_batches - 1, 0)).tolist())
        self._t0 = 0.0

    def start(self) -> None:
        """The window opens."""
        self._t0 = time.perf_counter()
        self.on = True

    # ---------------- batches
    def begin_batch(self, keys: List[str], width: int) -> None:
        """A new batch of the window. The window's first batch, and the
        first to begin after each of a few times drawn from the seed over
        the window, keep their iterates, start codes and grids for the
        check; the rest keep only their fruits, and the wrappers pass their
        calls straight through. So a run keeps the same few batches however
        many the window holds."""
        if not self.on:
            return
        k = min(self._watch, len(keys))
        watch = sorted(self._rng.choice(len(keys), size=k, replace=False).tolist())
        now = time.perf_counter() - self._t0
        kept = not self.batches
        while self._keep_at and self._keep_at[0] <= now:
            self._keep_at.pop(0)
            kept = True
        self.cur = Batch(list(keys), int(width), watch, kept=kept)
        self.batches.append(self.cur)

    def keeping(self) -> bool:
        return self.on and self.cur is not None and self.cur.kept and not self._rescue

    # ---------------- spans
    @contextlib.contextmanager
    def span(self, name: str):
        """Host time of the outermost call of `name`, closed by a
        synchronize; only in a traced run."""
        if not (self.on and self.traced) or self._depth[name]:
            yield
            return
        self._depth[name] += 1
        t0 = time.perf_counter()
        try:
            yield
            if self.cuda:
                torch.cuda.synchronize()
        finally:
            self._depth[name] -= 1
            self.spans.append((name, t0, time.perf_counter(), len(self.batches) - 1))


def _wrap(owner, attr: str, make):
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    return owner, attr, orig


def install(rec: Recorder):
    """Wrap the program's entry points for `rec`; returns the undo list."""
    from hortimapping_tpu_torch import serve
    from hortimapping_tpu_torch.ops import mesher
    from hortimapping_tpu_torch.optim import lm, warmstart

    undo = []

    def spanned(name):
        def make(orig):
            def f(*a, **k):
                with rec.span(name):
                    return orig(*a, **k)
            return f
        return make

    # the serving packer names the batch's fruits, lane by lane
    def assemble(orig):
        def f(reqs, target):
            rec.begin_batch([r.fruit_id for r in reqs], target)
            return orig(reqs, target)
        return f

    undo.append(_wrap(serve, "_assemble_batch_np", assemble))

    def retrieval(orig):
        def f(*a, **k):
            out = orig(*a, **k)
            if rec.keeping() and rec.cur.start_latent is None:
                rec.cur.start_latent, rec.cur.start_T = out[0], out[1]
            return out
        return f

    undo.append(_wrap(warmstart, "retrieval_init_batched", retrieval))

    def counted(cfg, obs, state):
        """Counts an LM iteration of either solver; its input iterate."""
        if rec.on and rec.cur is not None and not rec._rescue:
            rec.cur.n_iters += 1
        if rec.on and rec.traced:
            # the work this iteration needs: the lanes that run it (neither
            # done nor failed on entry), their valid rays of valid frames
            # and their valid surface points
            act = ~(state.done | state.failed)
            rays = (obs.ray_valid & obs.frame_valid[..., None]).sum((1, 2))
            rec.work["render"].append(((rays * act).sum(), cfg.n_sample_on_ray))
            rec.work["sdf"].append((obs.point_valid.sum(-1) * act).sum())

    def kept_iteration(cfg, obs, state) -> Iteration:
        return Iteration((obs.rays.shape[1], obs.rays.shape[2], cfg.n_sample_on_ray,
                          obs.points_w.shape[1]), state.latent, state.T_ow, state.i,
                         state.done, state.failed)

    def iteration(orig):
        def f(params, spec, cfg, obs, state, *a, **k):
            counted(cfg, obs, state)
            if not rec.keeping():
                return orig(params, spec, cfg, obs, state, *a, **k)
            it = kept_iteration(cfg, obs, state)
            rec._iter = it
            try:
                new = orig(params, spec, cfg, obs, state, *a, **k)
            finally:
                rec._iter = None
            it.lat_out, it.T_out = new.latent, new.T_ow
            rec.cur.iters.append(it)
            return new
        return f

    undo.append(_wrap(lm, "lm_iteration", iteration))

    def iteration_tr(orig):
        def f(params, spec, cfg, obs, ts, *a, **k):
            s = ts.base
            counted(cfg, obs, s)
            if not rec.keeping():
                return orig(params, spec, cfg, obs, ts, *a, **k)
            it = kept_iteration(cfg, obs, s)
            rec._iter = it
            try:
                new = orig(params, spec, cfg, obs, ts, *a, **k)
            finally:
                rec._iter = None
            # a lane whose accepted point is its trial assembled it at this
            # iteration; one that rolled back keeps the index its accepted
            # point was assembled at (a solve's first iteration accepts every
            # lane, so an index left from an earlier solve is never taken)
            took = ((new.acc_latent == s.latent).all(-1)
                    & (new.acc_T_ow == s.T_ow).flatten(1).all(-1))
            prev = rec.cur.tr_asm
            if prev is None or prev.shape != s.i.shape:
                prev = s.i
            it.lin_i = rec.cur.tr_asm = torch.where(took, s.i, prev)
            it.lat_out, it.T_out = new.base.latent, new.base.T_ow
            it.lin_lat, it.lin_T = new.acc_latent, new.acc_T_ow
            it.lam, it.converged = new.lam, new.base.converged
            rec.cur.iters.append(it)
            return new
        return f

    undo.append(_wrap(lm, "lm_iteration_tr", iteration_tr))

    def watched(kind):
        def make(orig):
            def f(*a, **k):
                out = orig(*a, **k)
                it = rec._iter
                if it is not None and rec.cur.watch:
                    idx = torch.as_tensor(rec.cur.watch, device=out[0].device)
                    if kind == "sdf":
                        it.watched["sdf"] = out.res.index_select(0, idx)
                    else:
                        it.watched["res_d"] = out.res_d.index_select(0, idx)
                        it.watched["ray_ok"] = out.ray_ok.index_select(0, idx)
                return out
            return f
        return make

    undo.append(_wrap(lm, "sdf_residuals", watched("sdf")))
    undo.append(_wrap(lm, "render_residuals", watched("render")))

    def rescue(orig):
        def f(*a, **k):
            rec._rescue += 1
            try:
                with rec.span("rescue"):
                    res, info = orig(*a, **k)
            finally:
                rec._rescue -= 1
            if rec.on and rec.cur is not None:
                rec.cur.rescue = info
            return res, info
        return f

    undo.append(_wrap(warmstart, "selective_rescue", rescue))

    def grids(orig):
        def f(self, g):
            if rec.keeping() and rec.cur.grids is None and rec.cur.watch:
                rec.cur.grids = g.index_select(0, torch.as_tensor(rec.cur.watch, device=g.device))
            return orig(self, g)
        return f

    undo.append(_wrap(mesher.MeshExtractor, "meshes_from_grids", grids))

    if rec.traced:
        undo.append(_wrap(lm, "joint_opt_packed", spanned("solve")))
        undo.append(_wrap(warmstart, "warmstart_solve", spanned("solve")))
        undo.append(_wrap(warmstart, "_retrieve", spanned("retrieval")))
        undo.append(_wrap(mesher.MeshExtractor, "meshes_from_grids", spanned("mesh_host")))

        def decode(orig):
            def f(self, latents):
                with rec.span("mesh_decode"):
                    out = orig(self, latents)
                if rec.on and rec.cur is not None:
                    rec.work["grid"].append((len(rec.cur.keys), self.voxel_points.shape[0]))
                return out
            return f

        undo.append(_wrap(mesher.MeshExtractor, "decode_grids", decode))

        def score(orig):
            def f(params, spec, codes, points, valid, *a, **k):
                if rec.on:
                    rec.work["retrieval"].append((codes.shape[0], valid.sum()))
                return orig(params, spec, codes, points, valid, *a, **k)
            return f

        undo.append(_wrap(warmstart, "_score_codes", score))
    return undo


def uninstall(undo) -> None:
    for owner, attr, orig in reversed(undo):
        setattr(owner, attr, orig)
