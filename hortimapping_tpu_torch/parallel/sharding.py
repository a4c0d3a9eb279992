"""Fruit-parallel execution over a mesh of devices (counterpart of
`hortimapping_tpu/parallel/sharding.py`).

Fruits never talk to each other: the decoder is replicated, each fruit's LM
solve touches only its own observation buffers, and the only cross-fruit
step of a pipeline is the final gather. So the fruit batch is split into
contiguous shards, one a mesh entry, and each shard runs the whole
single-start solve (`optim/lm.joint_opt`) on its own lanes, leaving its own
LM loop when its lanes are done; nothing is exchanged until the results are
gathered.

  * `FruitMesh` / `fruit_mesh(n)`: the shards' devices, every card by
    default. A device may appear more than once (each entry is one shard),
    so one card runs several shards side by side and the CPU tests run
    `["cpu"] * 8`.
  * `shard_joint_opt(...)`: each local shard gets a host thread, entered
    under its device and a CUDA stream of its own; the decoder and its
    kernel packs are replicated once a device and kept (keyed by the
    params' identity, the device and the config), so a served batch does
    not pack the weights again. Results are gathered onto the caller's
    device; an exception in a shard is raised to the caller.
  * Host turns: the shards' threads take turns on the host (one lock a
    `run_shards` call). A shard thread holds the turn while it runs Python
    and enqueues work, and hands it over only where it waits for its device
    (`host_read`, the LM loop's one read-back an iteration). Threads that
    all issue many small ops at once thrash on the interpreter lock (each
    op releases and re-takes it; `chip_smoke.py` phase 17 measures it, see
    `PERF.md`); with turns one shard's enqueue overlaps the others' device
    work.
  * `init_multi_host(...)`: a process group over gloo and the mesh of this
    process's devices. Every process passes the same full batch, solves its
    own shards and receives every other process's lanes (`all_gather_object`
    of host tensors): the only traffic between processes.
  * Across processes, process r's local shard i is global shard
    r * len(mesh.devices) + i. `gather_rows` gathers one host row a shard
    in that order (the data-parallel trainer's gradient exchange), and
    `raise_on_any_rank` is a barrier that carries failures, so an error in
    one process raises in every process instead of leaving the others
    waiting in a collective.

Padding: the batch is padded to a multiple of the mesh size with invalid
lanes (`frame_valid=False` everywhere) that fail at their first iteration
and are dropped before returning.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Optional, Sequence, Tuple

import torch

from hortimapping_tpu_torch.optim.state import FruitObservations, OptResult

REPLICA_CACHE = 16    # (params, device, config) replicas kept, least recently used dropped


@dataclasses.dataclass(frozen=True)
class FruitMesh:
    """The devices of this process's shards (one entry a shard; a device may
    repeat), this process's rank and the number of processes. Every
    process of a multi-process mesh holds the same number of shards."""

    devices: Tuple[torch.device, ...]
    rank: int = 0
    world_size: int = 1

    @property
    def size(self) -> int:
        """The number of shards over all processes."""
        return len(self.devices) * self.world_size


def fruit_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> FruitMesh:
    """The mesh of `devices` (any torch device names, repeats allowed), or
    of the first `n_devices` cards (default: every card). Raises when there
    is no card and no `devices`."""
    if devices is None:
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("no CUDA device for a fruit mesh; pass devices= (e.g. ['cpu'] * 8) "
                               "to shard over the CPU")
        devices = [f"cuda:{i}" for i in range(n_cards)][:n_devices]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a fruit mesh needs at least one device")
    return FruitMesh(devices)


def init_multi_host(coordinator_address: Optional[str] = None,
                    num_processes: Optional[int] = None,
                    process_id: Optional[int] = None,
                    devices: Optional[Sequence] = None) -> FruitMesh:
    """Join a process group (gloo over TCP at `coordinator_address`
    "host:port", default `MASTER_ADDR:MASTER_PORT`; `num_processes` default
    `WORLD_SIZE`, `process_id` default `RANK`) and return the mesh of this
    process's shards (`fruit_mesh(devices=devices)`) with its rank and the
    world size.

    gloo, not NCCL: the processes exchange only the final per-lane results
    (host tensors), and NCCL refuses two ranks on one card."""
    import torch.distributed as dist

    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    world = int(os.environ["WORLD_SIZE"] if num_processes is None else num_processes)
    rank = int(os.environ["RANK"] if process_id is None else process_id)
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)
    return dataclasses.replace(fruit_mesh(devices=devices), rank=rank, world_size=world)


def pad_to_multiple(
    obs: FruitObservations,
    latent0: torch.Tensor,
    T_ow0: torch.Tensor,
    multiple: int,
) -> Tuple[FruitObservations, torch.Tensor, torch.Tensor, int]:
    """Pad the fruit batch (leading axis) to a multiple of `multiple`.

    Padded lanes carry `frame_valid=False` / `point_valid=False` /
    `ray_valid=False`, so the solver marks them failed on their first
    iteration; their other buffers repeat the last real lane, so their math
    stays well-conditioned, their code is zero and their pose the identity.
    Returns (obs, latent0, T_ow0, original batch size).
    """
    B = latent0.shape[0]
    rem = (-B) % multiple
    if rem == 0:
        return obs, latent0, T_ow0, B

    def pad(x: torch.Tensor, invalidate: bool) -> torch.Tensor:
        if invalidate or x.dtype == torch.bool:
            block = torch.zeros((rem,) + x.shape[1:], dtype=x.dtype, device=x.device)
        else:
            block = x[-1:].expand((rem,) + x.shape[1:])
        return torch.cat([x, block])

    obs_p = FruitObservations(
        T_wc=pad(obs.T_wc, False),
        rays=pad(obs.rays, False),
        ray_valid=pad(obs.ray_valid, True),
        depth_obs=pad(obs.depth_obs, False),
        frame_valid=pad(obs.frame_valid, True),
        points_w=pad(obs.points_w, False),
        point_valid=pad(obs.point_valid, True),
    )
    eye = torch.eye(4, dtype=T_ow0.dtype, device=T_ow0.device).expand(rem, 4, 4)
    return (
        obs_p,
        torch.cat([latent0, torch.zeros((rem,) + latent0.shape[1:], dtype=latent0.dtype,
                                        device=latent0.device)]),
        torch.cat([T_ow0, eye]),
        B,
    )


_shard = threading.local()   # `turn`: the host turn of the shard thread running here


def on_shard_thread() -> bool:
    """Whether this thread is a shard thread of the fruit mesh, which takes
    host turns."""
    return getattr(_shard, "turn", None) is not None


def host_read(t: torch.Tensor):
    """The value of the one-element t on the host: on a shard thread the
    host turn goes to the other shards while this one waits for its device
    to produce t."""
    turn = getattr(_shard, "turn", None)
    if turn is None:
        return t.item()
    turn.release()
    try:
        return t.item()
    finally:
        turn.acquire()


_replicas: "OrderedDict[tuple, tuple]" = OrderedDict()
_replicas_lock = threading.Lock()


def _replicate(params, spec, cfg, device: torch.device, score: bool):
    """(params, packs) on `device`: the decoder copied there and its kernel
    packs (`optim/lm.make_packs`, with the scoring decoder where `score`),
    made once for each (params object, device, config, score) and kept, the
    counterpart of the JAX package's cached sharded program. The entry holds
    the params object, so its identity cannot be reused while cached; a
    params object is taken to keep its values (as the JAX package's arrays
    do), so pass a new one after changing weights in place."""
    from hortimapping_tpu_torch.optim import lm

    key = (id(params), str(device), cfg, spec, score)
    with _replicas_lock:
        hit = _replicas.get(key)
        if hit is not None:
            _replicas.move_to_end(key)
            return hit[1:]
        params_d = {k: {kk: v.to(device) for kk, v in p.items()} for k, p in params.items()}
        packs = lm.make_packs(params_d, spec, cfg, score=score)
        _replicas[key] = (params, params_d, packs)
        while len(_replicas) > REPLICA_CACHE:
            _replicas.popitem(last=False)
        return params_d, packs


_streams: dict = {}


def _stream(device: torch.device, i: int) -> "torch.cuda.Stream":
    """The CUDA stream of shard i on `device`, the same on every call, so
    the caching allocator reuses the blocks a shard freed on its last call
    (they are kept per stream)."""
    with _replicas_lock:
        key = (str(device), i)
        if key not in _streams:
            _streams[key] = torch.cuda.Stream(device=device)
        return _streams[key]


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


def run_shards(fn, devices: Sequence[torch.device], caller: torch.device) -> list:
    """[fn(i) for each shard i], each call in a host thread of its own,
    entered under its device and a CUDA stream of its own (`_stream`) that first waits
    for the caller's work (the caller's stream, and its device's current
    stream as the calling thread sees it); the threads take host turns
    (module docstring). Once every shard has returned,
    the caller's stream waits for each shard's stream, and so does the
    calling thread's current stream of each returned tensor's device, which
    is marked as using the tensor, so its memory is not reused before the
    caller has read it. The first shard's exception is raised once all have
    ended."""
    caller_stream = torch.cuda.current_stream(caller) if caller.type == "cuda" else None
    ready = [[torch.cuda.current_stream(d)] + ([caller_stream] if caller_stream else [])
             if d.type == "cuda" else [] for d in devices]
    streams = [_stream(d, i) if d.type == "cuda" else None for i, d in enumerate(devices)]
    turn = threading.Lock()

    def shard(i: int):
        with contextlib.ExitStack() as ctx:
            ctx.enter_context(turn)
            _shard.turn = turn
            ctx.callback(setattr, _shard, "turn", None)
            if streams[i] is not None:
                ctx.enter_context(torch.cuda.device(devices[i]))
                ctx.enter_context(torch.cuda.stream(streams[i]))
                for s in ready[i]:
                    streams[i].wait_stream(s)
            return fn(i)

    with ThreadPoolExecutor(max_workers=len(devices), thread_name_prefix="fruit-shard") as pool:
        futs = [pool.submit(shard, i) for i in range(len(devices))]
        wait(futs)
        outs = [f.result() for f in futs]
    for stream, out in zip(streams, outs):
        if stream is None:
            continue
        if caller_stream is not None:
            caller_stream.wait_stream(stream)
        for t in _tensors(out):
            if t.is_cuda:
                mine = torch.cuda.current_stream(t.device)
                mine.wait_stream(stream)
                t.record_stream(mine)
    return outs


def _solve_local(params, spec, cfg, obs, latent0, T_ow0, cube_radius, pose_known, table,
                 devices, caller: torch.device):
    """Solve the lanes of `obs` split evenly over `devices` (`run_shards`)
    and gather the results onto `caller`."""
    from hortimapping_tpu_torch.optim import lm

    per = latent0.shape[0] // len(devices)
    with_retrieval = cfg.init_mode == "retrieval" and table is not None
    replicas = [_replicate(params, spec, cfg, d, with_retrieval) for d in devices]

    def shard(i: int) -> OptResult:
        dev, (params_d, packs) = devices[i], replicas[i]

        def lanes(t):
            return t[i * per:(i + 1) * per].to(dev, non_blocking=True)

        return lm.joint_opt(params_d, spec, cfg, FruitObservations(*(lanes(a) for a in obs)),
                            lanes(latent0), lanes(T_ow0), cube_radius, pose_known,
                            None if table is None else table.to(dev), dev, packs)

    results = run_shards(shard, devices, caller)
    return OptResult(*(torch.cat([r[k].to(caller) for r in results])
                       for k in range(len(OptResult._fields))))


def check_shard_counts(counts: Sequence[int]) -> None:
    """Refuse a multi-process mesh whose processes (`counts`, in rank order)
    hold different numbers of shards."""
    if len(set(counts)) != 1:
        raise ValueError(f"processes hold {list(counts)} shards: a fruit mesh needs the same "
                         "number in each")


def raise_on_any_rank(mesh: FruitMesh, error: Optional[BaseException], what: str) -> None:
    """A barrier over the processes of `mesh` that carries failures: each
    process passes its own exception (None when it is fine), and if any
    passed one, every process raises a RuntimeError saying `what` failed,
    on which ranks and why (chained to the local exception where there is
    one)."""
    import torch.distributed as dist

    said = [None] * mesh.world_size
    dist.all_gather_object(said, None if error is None else f"{type(error).__name__}: {error}")
    failed = [f"rank {r}: {m}" for r, m in enumerate(said) if m is not None]
    if failed:
        raise RuntimeError(f"{what} failed on " + "; ".join(failed)) from error


def gather_rows(local: torch.Tensor, mesh: FruitMesh) -> torch.Tensor:
    """[k, n] host rows of this process's k shards -> [world_size * k, n]
    of every process's, in global shard order (rank by rank), on every
    process. Each row arrives as it was sent: nothing is summed in transit."""
    import torch.distributed as dist

    parts = [torch.empty_like(local) for _ in range(mesh.world_size)]
    dist.all_gather(parts, local.contiguous())
    return torch.cat(parts)


def _gather_processes(res: OptResult, mesh: FruitMesh, device: torch.device) -> OptResult:
    """Every process's lanes, in rank order, on every process."""
    import torch.distributed as dist

    parts = [None] * mesh.world_size
    dist.all_gather_object(parts, (len(mesh.devices), OptResult(*(t.cpu() for t in res))))
    check_shard_counts([p[0] for p in parts])
    return OptResult(*(torch.cat([p[1][k] for p in parts]).to(device)
                       for k in range(len(OptResult._fields))))


def shard_joint_opt(
    params,
    spec,
    cfg,
    obs: FruitObservations,
    latent0: torch.Tensor,
    T_ow0: torch.Tensor,
    cube_radius: float,
    mesh: FruitMesh,
    pose_known: bool = False,
    latent_table: Optional[torch.Tensor] = None,
    device: str | torch.device = "cuda",
) -> OptResult:
    """The batched single-start solve sharded over `mesh`: the batch padded
    to a multiple of the mesh size, each shard's contiguous lanes through
    `optim/lm.joint_opt` on its device (with `cfg.init_mode == "retrieval"`
    and a `latent_table`, the retrieval warm start runs inside the shard on
    its own lanes against the replicated table), no exchange between shards,
    the results gathered onto `device` (CUDA unless the caller asks for the
    CPU) and cut to the batch. On a mesh that spans processes every process
    passes the same batch and receives every lane."""
    from hortimapping_tpu_torch.optim import lm

    dev, obs, latent0, T_ow0 = lm._prepare(device, cfg, obs, latent0, T_ow0)
    obs, latent0, T_ow0, B = pad_to_multiple(obs, latent0, T_ow0, mesh.size)
    if latent_table is not None:
        latent_table = torch.as_tensor(latent_table)
    per_process = latent0.shape[0] // mesh.world_size
    lo, hi = mesh.rank * per_process, (mesh.rank + 1) * per_process
    res = _solve_local(params, spec, cfg, FruitObservations(*(a[lo:hi] for a in obs)),
                       latent0[lo:hi], T_ow0[lo:hi], float(cube_radius), bool(pose_known),
                       latent_table, mesh.devices, dev)
    if mesh.world_size > 1:
        res = _gather_processes(res, mesh, dev)
    return OptResult(*(a[:B] for a in res))
