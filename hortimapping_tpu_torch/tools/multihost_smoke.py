"""Two-process smoke run of the fruit mesh across processes (counterpart of
`tools/multihost_smoke.py`).

  parent:  picks a free port on 127.0.0.1, starts NUM_PROCESSES workers (this
           module with `--worker i`) and exits 0 only if every worker
           reports ok and all hold the same gathered result.
  worker:  `init_multi_host("127.0.0.1:port", NUM_PROCESSES, i)` (gloo) with
           LOCAL_SHARDS shards of its own (the CPU, or the visible cards in
           turn), then one `shard_joint_opt` of 4 deterministic synthetic
           fruits, one lane a shard: every process passes the same batch,
           solves its own shards and receives every other lane.

    python -m hortimapping_tpu_torch.tools.multihost_smoke [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NUM_PROCESSES = 2
LOCAL_SHARDS = 2
MARKER = "MULTIHOST_SMOKE_OK "


def worker(port: int, process_id: int, device: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from hortimapping_tpu_torch.config import JointOptConfig
    from hortimapping_tpu_torch.device import resolve_device
    from hortimapping_tpu_torch.models.workspace import config_decoder
    from hortimapping_tpu_torch.optim.state import stack_observations
    from hortimapping_tpu_torch.parallel.sharding import init_multi_host, shard_joint_opt
    from hortimapping_tpu_torch.tools.synthetic import SyntheticCategory, make_scene

    dev = resolve_device(device)
    local = ([dev] * LOCAL_SHARDS if dev.type == "cpu" else
             [f"cuda:{k % torch.cuda.device_count()}" for k in range(LOCAL_SHARDS)])
    mesh = init_multi_host(f"127.0.0.1:{port}", NUM_PROCESSES, process_id, devices=local)
    try:
        n_global = NUM_PROCESSES * LOCAL_SHARDS
        assert (mesh.rank, mesh.world_size, mesh.size) == (process_id, NUM_PROCESSES, n_global)
        params, spec = config_decoder(os.path.join(ROOT, "assets", "synthetic_small_8"),
                                      device=dev)
        cfg = JointOptConfig(n_fg_pix=32, n_bg_pix=32, n_frame=2, n_sample_on_ray=16,
                             recon_n_pts=32, max_iter=2, lm_lambda_0=0.5)
        cat = SyntheticCategory(spec=spec)
        obs_list = []
        for b in range(n_global):   # one fruit a shard
            rng = np.random.default_rng(100 + b)
            code = (rng.normal(size=spec.code_length) * 0.4).astype(np.float32)
            obs, _ = make_scene(cat, code, np.eye(4, dtype=np.float32), n_frames=cfg.n_frame,
                                n_fg=cfg.n_fg_pix, n_bg=cfg.n_bg_pix, n_points=cfg.recon_n_pts,
                                seed=100 + b)
            obs_list.append(obs)
        obs = stack_observations(obs_list, dev)
        lat0 = torch.zeros(n_global, spec.code_length, device=dev)
        T0 = torch.eye(4, device=dev).expand(n_global, 4, 4).contiguous()
        res = shard_joint_opt(params, spec, cfg, obs, lat0, T0, 0.1, mesh, device=dev)
        # every process holds every lane
        assert res.latent.shape == (n_global, spec.code_length), res.latent.shape
        failed, iters = res.failed.cpu().numpy(), res.iter_count.cpu().numpy()
        assert not failed.any() and (iters >= 1).all(), (failed, iters)
        digest = hashlib.sha256(res.latent.cpu().numpy().tobytes()
                                + res.T_ow.cpu().numpy().tobytes()).hexdigest()[:16]
        print(MARKER + json.dumps({
            "process_id": process_id, "processes": mesh.world_size, "shards": mesh.size,
            "devices": [str(d) for d in mesh.devices], "failed": failed.tolist(),
            "iters": iters.tolist(), "result": digest,
        }), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--timeout", type=float, default=300.0, help="seconds for the workers")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.worker is not None:
        worker(args.port, args.worker, args.device)
        return 0

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hortimapping_tpu_torch.tools.multihost_smoke", "--worker",
         str(i), "--port", str(port), "--device", args.device],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(NUM_PROCESSES)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=args.timeout)[0])
    except subprocess.TimeoutExpired:
        outs += [""] * (NUM_PROCESSES - len(outs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        lines = [l for l in out.splitlines() if l.startswith(MARKER)]
        good = p.returncode == 0 and len(lines) == 1
        print(f"worker {i}: rc={p.returncode} {'ok' if good else 'FAIL'}")
        if good:
            print("  " + lines[0])
            reports.append(json.loads(lines[0][len(MARKER):]))
        else:
            print(out[-4000:])
    same = len(reports) == NUM_PROCESSES and len({r["result"] for r in reports}) == 1
    if len(reports) == NUM_PROCESSES and not same:
        print("the processes hold different results")
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
