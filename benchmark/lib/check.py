"""What decides `correct`: the program's answers of the window, or a sample
of them drawn from the seed, held against the plain reference once the
window has closed. Nine numbers, each beside its limit from the cell's
file (eight under the mean start, which reports no `retrieval_gap`):

  retrieval_gap   the widest gap between the reference's score of the
                  (code, scale) a fruit's solve started from and the
                  reference's best score over the whole table at every
                  scale of the configured grid (retrieval's choice); only
                  under `init_mode: retrieval`;
  step_code_p75   the 75th percentile, over sampled (batch, iteration,
                  lane), of the gap in code units between the code an LM
                  step of the program reached and the code the reference's
                  step from the same iterate reaches (the render and SDF
                  terms, the normal equations and the solve together);
  answer_code_med the median, over sampled fruits, of the same gap between
                  the code each returned and the reference's last step from
                  the lane's last iterate (the answer as it is handed out);
  step_pose_rel   the pose half of the same steps, and of the answers'
                  last steps, pooled: the summed gap between the pose the
                  program reached and the reference's, over the summed
                  length of the reference's steps (a 3 x 4 Sim(3) block,
                  translation in cube radii). A pose never updated reads 1;
  lane_code_rel   the widest, over every lane index of the batches kept,
                  of the code gap of that lane's first LM step over the
                  length of the reference's step (one step a lane index,
                  from a batch drawn from the seed). A lane that is left
                  unmoved reads 1, whichever lane of the batch it is;
  render_res_med  the median gap of the depth residual over every ray the
                  reference renders in the sampled iterations of the lanes
                  kept (the render term alone);
  sdf_res_max     the widest gap of the SDF residual over the valid surface
                  points of the same iterations (the SDF term alone);
  grid_p99_voxel  the 99th percentile of the gap between the SDF grid the
                  program meshed and the reference's grid of the returned
                  code, over the grid points within two voxels of the
                  surface of the lanes kept, in voxels (the grid decode,
                  tied to the returned answer);
  mesh_p99_voxel  the 99th percentile, over the vertices of sampled meshes,
                  of their distance to the zero level set of the returned
                  code under the returned pose, in voxels (iso-surfacing,
                  tied to the returned answer).

The solver modes the check follows, as the configuration states them:
  * the start: `init_mode: retrieval` scores the start against the table
    over `linspace(retrieval_scale_min, retrieval_scale_max, n_scales)`,
    each scale composed onto the pose the fruit was given as
    diag(s, s, s, 1) @ T_init (one scale: the pose itself); any other start
    (the table mean) is not scored, and a retrieval start that was never
    recorded reads inf;
  * the fixed-lambda LM: each step from the program's input iterate,
    damped by `lm_lambda_0`;
  * the trust region (`trust_region`): each step from the point the
    program took it from (the trial it accepted, or the accepted point it
    rolled back to), assembled at that point's own iteration index and
    damped by the lane's own lambda; a quarter of the steps drawn are
    roll-backs where there are any. The watched residuals stay at the
    iteration's input iterate, where the program computed them. An answer
    is held against the step that produced it: the last trial of a lane
    that converged, else the step whose output the lane last accepted.

The pool of fruits is the same for every seed (see the traffic drivers);
the seed draws which answers, steps, lanes and batches are compared.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch

from lib import reference as R

F32 = {"render": "f32", "sdf": "f32", "algebra": "f32"}

# How much of a run the check reads (the tests shrink these through a
# cell's "check" overrides; a cell's file holds only its limits).
SETTINGS = {
    "kept_batches": 6,        # batches that keep their iterates (lib/record.py)
    "watch_lanes": 2,         # lanes a kept batch keeps residuals of
    "retrieval_fruits": 16,   # start codes scored against the whole table
    "steps": 16,              # LM steps drawn for step_code_p75 and step_pose_rel
    "residual_steps": 8,      # watched steps whose residuals are compared
    "final_steps": 8,         # answers held against their last step
    "meshes": 8,              # meshes whose vertices are compared
    "grid_batches": 4,        # kept batches whose grids are compared
    "lanes_per_pass": 8,      # the reference's lanes a call
    "cd_samples": 100000,     # surface samples a mesh for cd_mm
}


def settings(workload: dict) -> dict:
    return {**SETTINGS, **workload.get("check", {})}


def _pose_gap(A: torch.Tensor, B: torch.Tensor, cube_radius: float) -> torch.Tensor:
    """[n] norm of the difference of two [n, 4, 4] poses' 3 x 4 blocks, the
    translation column in cube radii."""
    d = (A.double() - B.double())[:, :3, :].clone()
    d[:, :, 3] /= cube_radius
    return torch.linalg.norm(d.reshape(d.shape[0], -1), dim=-1)


def _obs_batch(pool, scenes: List[int], dev) -> List[torch.Tensor]:
    out = []
    for f in range(7):
        a = np.stack([pool[s].obs[f] for s in scenes])
        out.append(torch.as_tensor(a if a.dtype == np.bool_ else a.astype(np.float32)).to(dev))
    return out


def _sample(rng, items: list, n: int) -> list:
    if len(items) <= n:
        return list(items)
    return [items[i] for i in sorted(rng.choice(len(items), size=n, replace=False).tolist())]


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.full_like(x, float("inf")))


def _retrieval_gap(ctx, answers, loc, rng, chk) -> float:
    """The widest, over sampled fruits, of the reference's score of the
    (code, scale) retrieval started the fruit from less the reference's
    best over the table at every scale of the grid; inf where a start was
    not recorded, is no code of the table, or (over a grid of scales) is
    no scale of the grid composed onto the pose the fruit was given."""
    solver, rec, dev = ctx.config["solver"], ctx.rec, ctx.dev
    cand = [d for d in answers if rec.batches[loc[d.key][0]].start_latent is not None]
    pick = _sample(rng, cand, chk["retrieval_fruits"])
    if not pick:
        return float("inf")
    gap = 0.0
    n_pts = solver["retrieval_score_pts"]
    S = solver["retrieval_n_scales"]
    obs = _obs_batch(ctx.pool, [d.scene for d in pick], dev)
    T0 = torch.as_tensor(np.stack([d.T_ow0 for d in pick])).to(dev)
    pts = obs[5][:, :n_pts] @ T0[:, :3, :3].transpose(1, 2) + T0[:, None, :3, 3]
    if S == 1:
        scores = R.score_codes(ctx.reference, ctx.table, pts, obs[6][:, :n_pts])[:, None]
    else:
        G, P = pts.shape[:2]
        grid = R.scale_grid(solver["retrieval_scale_min"], solver["retrieval_scale_max"], S).to(dev)
        valid = obs[6][:, None, :n_pts].expand(G, S, P).reshape(G * S, P)
        scores = R.score_codes(ctx.reference, ctx.table,
                               (grid[None, :, None, None] * pts[:, None]).reshape(G * S, P, 3),
                               valid).reshape(G, S, -1)
        # each grid scale composed onto the given pose: [G, S, 4, 4]
        sig = torch.cat([grid[:, None].expand(S, 3), torch.ones(S, 1, device=dev)], 1)
        T_grid = sig[None, :, :, None] * T0[:, None]
    for j, d in enumerate(pick):
        bi, lane = loc[d.key]
        b = rec.batches[bi]
        hit = torch.nonzero((ctx.table == b.start_latent[lane][None]).all(1)).reshape(-1)
        if hit.numel() == 0:
            return float("inf")
        k = 0
        if S > 1:
            err = (T_grid[j] - b.start_T[lane][None].to(T_grid.dtype)).abs().flatten(1).max(1).values
            k = int(err.argmin())
            if not float(err[k]) <= 1e-5 * (1.0 + float(T0[j].abs().max())):
                return float("inf")
        gap = max(gap, float(scores[j, k, hit[0]] - scores[j].min()))
    return gap


def run(ctx, win) -> Tuple[Dict[str, Tuple[float, float]], bool]:
    chk = settings(ctx.workload)
    lim = chk["limits"]
    dev = ctx.dev
    dec = ctx.reference
    solver = ctx.config["solver"]
    rec = ctx.rec
    rng = np.random.default_rng([ctx.seed, 0xC4EC4])
    loc = {}
    for bi, b in enumerate(rec.batches):
        for lane, key in enumerate(b.keys):
            loc[key] = (bi, lane)
    answers = [d for d in win.done if not d.failed and d.key in loc]
    by_key = {d.key: d for d in answers}
    nums: Dict[str, float] = {}

    with torch.no_grad():
        # ---- retrieval: the start (code, scale) against the reference's scores
        if solver["init_mode"] == "retrieval":
            nums["retrieval_gap"] = _retrieval_gap(ctx, answers, loc, rng, chk)

        # ---- LM steps at the program's own iterates (under the trust region,
        # from the point each step was taken from)
        tr = bool(solver["trust_region"])
        acts = [[(~(it.done_in | it.failed_in)).cpu().numpy() for it in b.iters]
                for b in rec.batches]
        if tr:
            host = [[{"i": it.i_in.cpu().numpy(), "lin_i": it.lin_i.cpu().numpy(),
                      "conv": it.converged.cpu().numpy()} for it in b.iters] for b in rec.batches]
        steps, watched = [], []
        for bi, b in enumerate(rec.batches):
            for ii, it in enumerate(b.iters):
                act = acts[bi][ii]
                for lane in range(len(b.keys)):
                    if act[lane] and b.keys[lane] in by_key:
                        steps.append((bi, ii, lane))
                        if lane in b.watch:
                            watched.append((bi, ii, lane))

        def rolled(t) -> bool:
            h = host[t[0]][t[1]]
            return bool(h["lin_i"][t[2]] != h["i"][t[2]])

        if tr:
            # accepted and rolled-back steps both: a quarter of the draw from
            # the roll-backs where there are any
            pick = _sample(rng, [t for t in steps if rolled(t)], chk["steps"] // 4)
            drawn = set(pick)
            pick += _sample(rng, [t for t in steps if t not in drawn], chk["steps"] - len(pick))
            jobs = [(t, None) for t in sorted(pick)]
        else:
            jobs = [(t, None) for t in _sample(rng, steps, chk["steps"])]
        jobs += [(t, "watch") for t in _sample(rng, watched, chk["residual_steps"])]
        # each sampled fruit's last step, onto the answer it returned
        finals = []
        for d in answers:
            bi, lane = loc[d.key]
            b = rec.batches[bi]
            if not b.kept:
                continue
            if b.rescue and lane in [b.rescue["lanes"][a] for a in b.rescue.get("accepted", [])]:
                continue   # a rescued lane's answer comes from the rescue's own solve
            last = [ii for ii in range(len(b.iters)) if acts[bi][ii][lane]]
            if last and tr and not host[bi][last[-1]]["conv"][lane]:
                # a lane that stopped unconverged returns its last accepted
                # point: the output of the step from iteration lin_i - 1
                at = host[bi][last[-1]]["lin_i"][lane] - 1
                last = [ii for ii in last if host[bi][ii]["i"][lane] == at][-1:]
            if last:
                finals.append((bi, last[-1], lane))
        jobs += [(t, "final") for t in _sample(rng, finals, chk["final_steps"])]
        # every lane index of the kept batches: its first step, in a batch drawn
        # from the seed among those where that lane runs it
        by_lane = defaultdict(list)
        for bi, b in enumerate(rec.batches):
            if b.iters:
                for lane in range(len(b.keys)):
                    if acts[bi][0][lane] and b.keys[lane] in by_key:
                        by_lane[lane].append(bi)
        jobs += [((int(rng.choice(by_lane[lane])), 0, lane), "lane") for lane in sorted(by_lane)]
        loop_gaps, answer_gaps, lane_rel = [], [], []
        pose_gap = pose_len = 0.0
        raw = []
        res_gaps, sdf_max = [], 0.0
        n_watch = 0
        groups = defaultdict(list)
        for (bi, ii, lane), kind in jobs:
            groups[rec.batches[bi].iters[ii].shape].append((bi, ii, lane, kind))
        for shape, group in groups.items():
            for lo in range(0, len(group), chk["lanes_per_pass"]):
                part = group[lo:lo + chk["lanes_per_pass"]]
                keys = [rec.batches[bi].keys[lane] for bi, _, lane, _ in part]
                obs = _obs_batch(ctx.pool, [by_key[k].scene for k in keys], dev)
                view = [v for v in R.views(obs, solver) if R.view_shape(v) == shape]
                if not view:
                    raise RuntimeError(f"no view of the configured solve has the shape {shape}")
                its = [rec.batches[bi].iters[ii] for bi, ii, _, _ in part]
                idx = [lane for _, _, lane, _ in part]
                lat0 = torch.stack([it.lat_in[l] for it, l in zip(its, idx)])
                T0 = torch.stack([it.T_in[l] for it, l in zip(its, idx)])
                i0 = torch.stack([it.i_in[l] for it, l in zip(its, idx)])
                lam = None
                if tr:
                    at_input = (lat0, T0, i0)
                    lat0 = torch.stack([it.lin_lat[l] for it, l in zip(its, idx)])
                    T0 = torch.stack([it.lin_T[l] for it, l in zip(its, idx)])
                    i0 = torch.stack([it.lin_i[l] for it, l in zip(its, idx)])
                    lam = torch.stack([it.lam[l] for it, l in zip(its, idx)])
                lat_r, T_r, terms = R.lm_step(dec, view[0], lat0, T0, i0, ctx.program.cube_radius,
                                              F32, lam)
                if tr and any(kind == "watch" and rolled((bi, ii, lane))
                              for bi, ii, lane, kind in part):
                    # the residuals the program computed, at the input iterate
                    terms = R.normal_equations(dec, view[0], *at_input, ctx.program.cube_radius, F32)
                lat_p = [torch.as_tensor(by_key[k].latent).to(dev) if kind == "final"
                         else it.lat_out[lane] for (_, _, lane, kind), it, k in zip(part, its, keys)]
                T_p = [torch.as_tensor(by_key[k].T_ow).to(dev) if kind == "final"
                       else it.T_out[lane] for (_, _, lane, kind), it, k in zip(part, its, keys)]
                g_c = _finite(torch.linalg.norm((torch.stack(lat_p) - lat_r).double(), dim=-1))
                l_c = torch.linalg.norm((lat_r - lat0).double(), dim=-1)
                g_p = _finite(_pose_gap(torch.stack(T_p), T_r, ctx.program.cube_radius))
                l_p = _pose_gap(T_r, T0, ctx.program.cube_radius)
                for j, (bi, ii, lane, kind) in enumerate(part):
                    if kind == "lane":
                        lane_rel.append(float(g_c[j] / l_c[j]) if l_c[j] > 0
                                        else (0.0 if g_c[j] == 0 else float("inf")))
                    else:
                        (answer_gaps if kind == "final" else loop_gaps).append(float(g_c[j]))
                    pose_gap += float(g_p[j])
                    pose_len += float(l_p[j])
                    raw.append({"kind": kind or "step", "batch": bi, "iter": ii, "lane": lane,
                                "code_gap": float(g_c[j]), "code_step": float(l_c[j]),
                                "pose_gap": float(g_p[j]), "pose_step": float(l_p[j])})
                    if tr:
                        raw[-1].update(rolled_back=rolled((bi, ii, lane)),
                                       lam=float(its[j].lam[lane]))
                for j, (bi, ii, lane, kind) in enumerate(part):
                    if kind != "watch":
                        continue
                    w = rec.batches[bi].watch.index(lane)
                    got = its[j].watched
                    ok = terms.ray_ok[j]
                    res_gaps.append((got["res_d"][w] - terms.res_d[j]).abs()[ok])
                    pv = view[0].point_valid[j]
                    d = (got["sdf"][w] - terms.sdf_res[j]).abs()[pv]
                    sdf_max = max(sdf_max, float(d.max()) if d.numel() else 0.0)
                    n_watch += 1
        nums["step_code_p75"] = float(np.percentile(loop_gaps, 75)) if loop_gaps else float("inf")
        nums["answer_code_med"] = float(np.median(answer_gaps)) if answer_gaps else float("inf")
        nums["step_pose_rel"] = pose_gap / pose_len if pose_len > 0 else float("inf")
        nums["lane_code_rel"] = max(lane_rel) if lane_rel else float("inf")
        ctx.check_steps = raw
        res_gaps = torch.cat(res_gaps) if res_gaps else torch.zeros(0)
        nums["render_res_med"] = float(res_gaps.median()) if res_gaps.numel() else float("inf")
        nums["sdf_res_max"] = sdf_max if n_watch else float("inf")

        # ---- meshes: vertices against the returned code's zero level set
        pick = _sample(rng, [d for d in answers if rec.batches[loc[d.key][0]].kept], chk["meshes"])
        m = ctx.config["meshing"]
        voxel = 2.0 * m["cube_radius_m"] / (m["voxels"] - 1)
        dists = []
        for d in pick:
            verts, faces = d.mesh
            if faces.shape[0] == 0:
                dists = None
                break
            v = torch.as_tensor(np.asarray(verts, np.float32)).to(dev)
            dists.append(R.surface_distance(dec, torch.as_tensor(d.latent).to(dev),
                                            torch.as_tensor(d.T_ow).to(dev), v) / voxel)
        if dists:
            nums["mesh_p99_voxel"] = float(torch.quantile(torch.cat(dists).double(), 0.99))
        else:
            nums["mesh_p99_voxel"] = float("inf")

        # ---- the SDF grids the program meshed, against the reference's
        gpts = R.voxel_points(m["voxels"], m["cube_radius_m"], dev)
        gaps_g = []
        for b in _sample(rng, [b for b in rec.batches if b.grids is not None], chk["grid_batches"]):
            for w, lane in enumerate(b.watch):
                d = by_key.get(b.keys[lane])
                if d is None:
                    continue
                ref = R.grid_sdf(dec, torch.as_tensor(d.latent).to(dev), gpts)
                near = ref.abs() < 2.0 * voxel
                gaps_g.append((b.grids[w].reshape(-1).to(dev).float() - ref).abs()[near] / voxel)
        nums["grid_p99_voxel"] = (float(torch.quantile(torch.cat(gaps_g).double(), 0.99))
                                  if gaps_g else float("inf"))

    out = {k: (v, float(lim[k])) for k, v in nums.items()}
    ok = (win.failed == 0 and win.attempted > 0 and len(answers) == len(win.done)
          and all(np.isfinite(v) and v <= l for v, l in out.values()))
    return out, ok
