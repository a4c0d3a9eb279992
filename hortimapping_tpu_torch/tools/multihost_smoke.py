"""Two-process smoke runs of the fruit mesh across processes (counterpart of
`tools/multihost_smoke.py`).

  parent:  picks a free port on 127.0.0.1, starts NUM_PROCESSES workers (this
           module with `--worker i`) and exits 0 only if every worker
           reports ok and all hold the same result.
  worker:  `init_multi_host("127.0.0.1:port", NUM_PROCESSES, i)` (gloo) with
           `--local_shards` shards of its own (the CPU, or the visible cards
           in turn), then
    solve  (default) one `shard_joint_opt` of 4 deterministic synthetic
           fruits, one lane a shard: every process passes the same batch,
           solves its own shards and receives every other lane;
    --train EXPERIMENT  `train_deepsdf(EXPERIMENT, mesh=...)` data-parallel
           over every process's shards (`--epochs`, `--snapshot_every`,
           `--resume`, `--save` as the trainer's), one epoch a chunk; with
           `--out DIR` each process writes its result to DIR/rank<i>.npz
           (losses, codes, params.<layer>.<w|b>). Its report adds ms a step
           (median over the epochs after the first), the gather's ms a step
           and the peak device memory. On the CPU each process runs one
           intra-op thread, so its sums keep one order whatever the host.

    python -m hortimapping_tpu_torch.tools.multihost_smoke [--device cpu|cuda]
    python -m hortimapping_tpu_torch.tools.multihost_smoke --train EXP [--device cpu|cuda]
        [--local_shards K] [--epochs N] [--snapshot_every N] [--resume] [--save] [--out DIR]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NUM_PROCESSES = 2
LOCAL_SHARDS = 2
MARKER = "MULTIHOST_SMOKE_OK "


def _local_devices(dev, local_shards: int) -> list:
    import torch

    return ([dev] * local_shards if dev.type == "cpu" else
            [f"cuda:{k % torch.cuda.device_count()}" for k in range(local_shards)])


def worker(port: int, process_id: int, device: str, local_shards: int = LOCAL_SHARDS) -> None:
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
    mesh = init_multi_host(f"127.0.0.1:{port}", NUM_PROCESSES, process_id,
                           devices=_local_devices(dev, local_shards))
    try:
        n_global = NUM_PROCESSES * local_shards
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


def train_worker(port: int, process_id: int, device: str, experiment: str, local_shards: int,
                 epochs: int, snapshot_every=None, resume: bool = False, save: bool = False,
                 out=None) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from hortimapping_tpu_torch.device import resolve_device
    from hortimapping_tpu_torch.parallel.sharding import init_multi_host
    from hortimapping_tpu_torch.train.deepsdf import train_deepsdf

    dev = resolve_device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    mesh = init_multi_host(f"127.0.0.1:{port}", NUM_PROCESSES, process_id,
                           devices=_local_devices(dev, local_shards))
    try:
        stamps = []

        def log(msg: str) -> None:
            if msg.startswith("epoch"):
                stamps.append(time.perf_counter())
            print(f"[rank {process_id}] {msg}", flush=True)

        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        res = train_deepsdf(experiment, num_epochs=epochs, epochs_per_call=1,
                            snapshot_every=snapshot_every, resume=resume, save=save, mesh=mesh,
                            log=log, device=dev)
        arrays = {"losses": res.losses, "codes": res.latent_codes}
        for name, p in res.params.items():
            for k in ("w", "b"):
                arrays[f"params.{name}.{k}"] = p[k].cpu().numpy()
        if out:
            os.makedirs(out, exist_ok=True)
            np.savez(os.path.join(out, f"rank{process_id}.npz"), **arrays)
        digest = hashlib.sha256(b"".join(np.ascontiguousarray(a).tobytes()
                                         for a in arrays.values())).hexdigest()[:16]
        steps = len(stamps) * res.timing["steps_per_epoch"]
        ms_epoch = np.diff(stamps) * 1e3
        print(MARKER + json.dumps({
            "process_id": process_id, "processes": mesh.world_size, "shards": mesh.size,
            "devices": [str(d) for d in mesh.devices], "losses": res.losses.tolist(),
            "result": digest, "checkpoint": res.checkpoint_path, "steps": steps,
            "ms_step": (float(np.median(ms_epoch)) / res.timing["steps_per_epoch"]
                        if len(ms_epoch) else None),
            "gather_ms_step": res.timing["gather_s"] * 1e3 / max(steps, 1),
            "peak_mb": (torch.cuda.max_memory_allocated(dev) / 2**20
                        if dev.type == "cuda" else None),
        }), flush=True)
    finally:
        dist.destroy_process_group()


def run_workers(worker_args, timeout: float, command=None) -> list:
    """Start NUM_PROCESSES workers on a free port of 127.0.0.1 (`command`,
    default this module, + `--worker i --port P` + `worker_args`) and wait
    for them, killing any still running at `timeout` seconds -> [(return
    code, output, report or None)] in rank order; the report is the JSON of
    the worker's one marker line."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    command = command or [sys.executable, "-m", "hortimapping_tpu_torch.tools.multihost_smoke"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen(
        list(command) + ["--worker", str(i), "--port", str(port)] + list(worker_args),
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(NUM_PROCESSES)]
    outs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(0.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        outs += [""] * (NUM_PROCESSES - len(outs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for p, out in zip(procs, outs):
        lines = [l for l in out.splitlines() if l.startswith(MARKER)]
        report = json.loads(lines[0][len(MARKER):]) if len(lines) == 1 else None
        results.append((p.returncode, out, report))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--timeout", type=float, default=300.0, help="seconds for the workers")
    ap.add_argument("--local_shards", type=int, default=LOCAL_SHARDS,
                    help="shards of each process")
    ap.add_argument("--train", metavar="EXPERIMENT", default=None,
                    help="train this DeepSDF experiment over the mesh instead of the solve")
    ap.add_argument("--epochs", type=int, default=None, help="override specs.json NumEpochs")
    ap.add_argument("--snapshot_every", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--save", action="store_true", help="write the checkpoint at the end")
    ap.add_argument("--out", default=None, help="directory for each process's result")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.worker is not None:
        if args.train:
            train_worker(args.port, args.worker, args.device, args.train, args.local_shards,
                         args.epochs, args.snapshot_every, args.resume, args.save, args.out)
        else:
            worker(args.port, args.worker, args.device, args.local_shards)
        return 0

    worker_args = ["--device", args.device, "--local_shards", str(args.local_shards)]
    if args.train:
        worker_args += ["--train", args.train]
        for flag in ("epochs", "snapshot_every", "out"):
            if getattr(args, flag) is not None:
                worker_args += [f"--{flag}", str(getattr(args, flag))]
        worker_args += [f"--{flag}" for flag in ("resume", "save") if getattr(args, flag)]
    results = run_workers(worker_args, args.timeout)
    for i, (rc, out, report) in enumerate(results):
        good = rc == 0 and report is not None
        print(f"worker {i}: rc={rc} {'ok' if good else 'FAIL'}")
        if good:
            print("  " + MARKER + json.dumps(report))
        else:
            print(out[-4000:])
    reports = [r for rc, _, r in results if rc == 0 and r is not None]
    same = len(reports) == NUM_PROCESSES and len({r["result"] for r in reports}) == 1
    if len(reports) == NUM_PROCESSES and not same:
        print("the processes hold different results")
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
