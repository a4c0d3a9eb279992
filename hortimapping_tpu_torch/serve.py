"""Continuous fruit-completion serving (counterpart of
`hortimapping_tpu/serve.py`).

A mapping robot produces submaps continuously, and the solver is batched, so
the serving shape is a queue and a batch packer in front of the one-call
packed solve (`optim/lm.joint_opt_packed`):

  * requests (one fruit each) arrive on a thread-safe queue and are grouped
    by observation shape (a batch stacks fruits of one shape);
  * a worker thread packs up to `max_batch` lanes a step, pads a partial
    batch to the next power of two with invalid lanes (they fail at their
    first iteration and are frozen from then on) and runs the batched solve
    on the server's device: the retrieval warm start, the configured solver
    and pose polish, the result packed into one device buffer;
  * results resolve `concurrent.futures.Future`s, so producers prepare the
    next submap while the device works on the current one;
  * optional meshing decodes the batch's grids into the same buffer
    (`ops/mesher.MeshExtractor.pack_solve_with_grids`), so solve and meshing
    results cross to the host in one copy, and iso-surfaces them on the
    host.

With a fruit mesh (`use_mesh`, on by default where more than one card is
visible) each batch is sharded over the mesh
(`parallel/sharding.shard_joint_opt`): batch widths are multiples of the
mesh size and `max_batch` rounds up to one.

Unlike the JAX package's worker, this one completes each batch before it
packs the next: the LM loop reads its convergence flags back once an
iteration, so a one-deep pipeline would overlap nothing on the card (batch
k's copy would queue behind batch k+1's grid decode on the one stream) and
would hold batch k's results until batch k+1 is solved.

While tracing is on (`utils/trace.py`) the worker records each request's
queue wait (`serve.queue`), each batch (`serve.batch`) and its solve
(`serve.solve`).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hortimapping_tpu_torch.config import JointOptConfig
from hortimapping_tpu_torch.device import resolve_device
from hortimapping_tpu_torch.models.decoder import DecoderSpec, Params
from hortimapping_tpu_torch.optim import lm
from hortimapping_tpu_torch.optim.state import FruitObservations, upload
from hortimapping_tpu_torch.parallel.sharding import FruitMesh, fruit_mesh, shard_joint_opt
from hortimapping_tpu_torch.utils import trace


@dataclasses.dataclass
class CompletionRequest:
    """One fruit to complete. `obs` holds one fruit's observation fields,
    no leading axis, as host arrays (numpy, e.g. `tools/synthetic.make_scene`
    or `data/rays.render_data_to_observations`)."""

    fruit_id: str
    obs: FruitObservations
    latent0: np.ndarray              # [C]
    T_ow0: np.ndarray                # [4, 4]
    pose_known: bool = False
    # latency contract, seconds from submit(): a request still queued when
    # its deadline passes resolves DeadlineExceeded instead of taking a
    # solve lane (checked when its batch is packed; a request already in
    # flight completes). None: no deadline.
    deadline_s: Optional[float] = None


class ServerOverloaded(RuntimeError):
    """Raised by submit() when `max_queue` requests are in flight (admission
    control): the caller sheds load instead of deepening the queue."""


class DeadlineExceeded(RuntimeError):
    """Set on a request's Future when its `deadline_s` passed while it was
    still queued: a pose solved against stale frames is worse than none on
    a moving robot, so the client hears at once and may re-submit."""


@dataclasses.dataclass
class CompletionResult:
    fruit_id: str
    latent: np.ndarray
    T_ow: np.ndarray
    iter_count: int
    failed: bool
    converged: bool
    mesh: Optional[object] = None    # data.mesh.TriangleMesh when meshing is on
    latency_s: float = 0.0           # submit -> result
    batch_size: int = 0              # real lanes in the batch that served it


def _assemble_batch_np(reqs: List[CompletionRequest], target: int):
    """Stack and pad a batch in host numpy, to `target` lanes. Padding as
    `parallel/sharding.pad_to_multiple`: bool masks pad False (the lanes
    fail at once), numeric buffers repeat the last real lane (well
    conditioned arithmetic), codes pad zero and poses identity."""
    n = len(reqs)
    rem = target - n
    f32 = np.float32

    def stack(get, pad_invalid: bool):
        a = np.stack([np.asarray(get(r)) for r in reqs])
        if rem > 0:
            if pad_invalid and a.dtype == np.bool_:
                pad = np.zeros((rem,) + a.shape[1:], a.dtype)
            else:
                pad = np.broadcast_to(a[-1:], (rem,) + a.shape[1:])
            a = np.concatenate([a, pad], axis=0)
        return a

    obs = FruitObservations(
        T_wc=stack(lambda r: r.obs.T_wc, False),
        rays=stack(lambda r: r.obs.rays, False),
        ray_valid=stack(lambda r: r.obs.ray_valid, True),
        depth_obs=stack(lambda r: r.obs.depth_obs, False),
        frame_valid=stack(lambda r: r.obs.frame_valid, True),
        points_w=stack(lambda r: r.obs.points_w, False),
        point_valid=stack(lambda r: r.obs.point_valid, True),
    )
    lat0 = np.stack([np.asarray(r.latent0, f32) for r in reqs])
    T0 = np.stack([np.asarray(r.T_ow0, f32) for r in reqs])
    if rem > 0:
        lat0 = np.concatenate([lat0, np.zeros((rem,) + lat0.shape[1:], f32)])
        eye = np.broadcast_to(np.eye(4, dtype=f32), (rem, 4, 4))
        T0 = np.concatenate([T0, eye])
    return obs, lat0, T0


def _shape_key(req: CompletionRequest) -> Tuple:
    """The bucket of a request: the shape and dtype of each observation
    field, and `pose_known`."""
    return (
        tuple((tuple(a.shape), str(a.dtype).replace("torch.", "")) for a in req.obs),
        bool(req.pose_known),
    )


class CompletionServer:
    """Queue and batch packer in front of the batched packed solve, on
    `device` (CUDA unless the caller asks for the CPU; `params` and
    `latent_table` live there, and results are gathered there). `use_mesh`:
    None shards each batch over every card when more than one is visible,
    True over `mesh` (default `fruit_mesh()`), False never.

    Usage::

        with CompletionServer(params, spec, cfg, cube_radius) as srv:
            futs = [srv.submit(r) for r in requests]
            results = [f.result() for f in futs]
    """

    def __init__(
        self,
        params: Params,
        spec: DecoderSpec,
        cfg: JointOptConfig,
        cube_radius: float,
        max_batch: int = 16,
        max_wait_s: float = 0.02,
        mesher=None,
        use_mesh: Optional[bool] = None,
        max_queue: Optional[int] = None,
        latent_table=None,
        device: str | torch.device = "cuda",
        mesh: Optional[FruitMesh] = None,
    ):
        self.params = params
        self.spec = spec
        self.cfg = cfg
        # a config that asks for retrieval without a table would serve the
        # mean init under the retrieval config's name
        if cfg.init_mode == "retrieval" and latent_table is None:
            raise ValueError(
                "cfg.init_mode='retrieval' requires latent_table "
                "(models/workspace.load_latent_vectors)")
        # the packed solve applies the single-start retrieval init only:
        # serving a multi_start config would give other results than the
        # pipelines' warmstart_solve under the same name
        if cfg.multi_start > 1:
            raise ValueError(
                "CompletionServer does not support opt.tpu.multi_start > 1; "
                "use the batch pipelines (optim/warmstart.warmstart_solve) "
                "or set multi_start: 1 in the serving config")
        cfg.check_ported()
        self.device = resolve_device(device)
        self.latent_table = (None if latent_table is None
                             else torch.as_tensor(latent_table).to(self.device))
        if use_mesh is None:
            use_mesh = self.device.type == "cuda" and torch.cuda.device_count() > 1
        self.mesh = (mesh or fruit_mesh()) if use_mesh else None
        if self.mesh is not None and self.mesh.world_size > 1:
            raise ValueError("a server shards its batches over this process's devices; "
                             "a mesh that spans processes needs every process to pass the batch")
        self._packs = (None if self.mesh is not None else
                       lm.make_packs(params, spec, cfg, score=self.latent_table is not None))
        self.cube_radius = float(cube_radius)
        self.max_batch = int(max_batch)
        if self.mesh is not None:
            self.max_batch = -(-self.max_batch // self.mesh.size) * self.mesh.size
        self.max_wait_s = float(max_wait_s)
        self.mesher = mesher
        # admission control: a bound on requests in flight (queued and being
        # solved). None: unbounded. With a bound, submit() raises
        # ServerOverloaded instead of deepening the queue: the worst wait is
        # about (max_queue / max_batch + 1) batch times.
        self.max_queue = max_queue
        self._inflight = 0
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # serializes submit() against stop()'s final drain: without it a
        # producer could pass the stop check and enqueue after the drain,
        # leaving its Future unresolved
        self._submit_lock = threading.Lock()
        self._completed = 0
        self._expired = 0
        # bounded: a continuous server must not grow host memory with age
        self._latencies = deque(maxlen=4096)
        self._started_at: Optional[float] = None
        # per-shape-bucket FIFOs, owned by the worker thread (stop() drains
        # them only after the join)
        self._pending: Dict[Tuple, "deque"] = {}
        self._seq = 0   # batches taken by the worker (the `batch` of its spans)

    # ---------------- lifecycle ----------------

    def start(self) -> "CompletionServer":
        if self._stop.is_set():
            # a stopped server's worker would exit at once and strand every
            # submitted Future
            raise RuntimeError(
                "CompletionServer cannot be restarted after stop(); create a new server")
        if self._thread is not None:
            return self
        self._started_at = time.perf_counter()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        # fail what raced the shutdown instead of hanging its waiter; under
        # _submit_lock no put can land after this drain
        with self._submit_lock:
            leftovers = []
            while True:
                try:
                    leftovers.append(self._q.get_nowait())
                except queue.Empty:
                    break
            for dq in self._pending.values():
                leftovers.extend(dq)
            self._pending.clear()
            for _req, fut, _t in leftovers:
                if not fut.done():
                    fut.set_exception(RuntimeError("CompletionServer stopped"))

    def __enter__(self) -> "CompletionServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---------------- API ----------------

    def submit(self, req: CompletionRequest) -> "Future[CompletionResult]":
        """Queue one request; host only (no device call)."""
        with self._submit_lock:
            if self._stop.is_set() or self._thread is None:
                raise RuntimeError("CompletionServer is not running (call start())")
            if self.max_queue is not None:
                with self._lock:
                    if self._inflight >= self.max_queue:
                        raise ServerOverloaded(
                            f"{self._inflight} requests in flight (max_queue={self.max_queue})")
                    self._inflight += 1
            fut: "Future[CompletionResult]" = Future()
            if self.max_queue is not None:
                # runs on set_result, set_exception and a client's cancel
                fut.add_done_callback(self._dec_inflight)
            self._q.put((req, fut, time.perf_counter()))
        return fut

    def _dec_inflight(self, _fut) -> None:
        with self._lock:
            self._inflight -= 1

    def _expire(self, item) -> bool:
        """True (and the Future resolved DeadlineExceeded) when the request's
        deadline passed while it waited in the queue. Worker thread only."""
        req, fut, t_sub = item
        if req.deadline_s is None:
            return False
        waited = time.perf_counter() - t_sub
        if waited <= req.deadline_s:
            return False
        if not fut.done():
            fut.set_exception(DeadlineExceeded(
                f"fruit {req.fruit_id!r} queued {waited * 1e3:.0f} ms > "
                f"deadline {req.deadline_s * 1e3:.0f} ms"))
            # a Future already resolved (cancelled between submit and pack)
            # is dropped, but not counted as expired
            with self._lock:
                self._expired += 1
        return True

    def _batch_width(self, n: int) -> int:
        """Solve width of an n-request batch: the next power of two, capped
        at max_batch, rounded up to a multiple of the mesh size. The worker
        and warmup() share it, so every width the worker uses is warm."""
        target = 1
        while target < n:
            target *= 2
        target = min(target, self.max_batch)
        if self.mesh is not None:
            target = -(-target // self.mesh.size) * self.mesh.size
        return target

    def warmup(self, sample) -> None:
        """Build the kernels (on the card, one nvcc per source, in parallel)
        and run one solve at every batch width the packer can use, so the
        first served batch pays neither a build nor a first launch.

        `sample` is one CompletionRequest or a sequence of them: one
        representative per shape bucket the stream will carry."""
        if self.device.type == "cuda":
            from hortimapping_tpu_torch.ops import cuda_build

            cuda_build.build_all()
        samples = [sample] if isinstance(sample, CompletionRequest) else list(sample)
        seen = set()
        for s in samples:
            key = _shape_key(s)
            if key in seen:
                continue
            seen.add(key)
            self._warmup_one(s)

    def _warmup_one(self, sample: CompletionRequest) -> None:
        widths = set()
        w = 1
        while w < self.max_batch:
            widths.add(self._batch_width(w))
            w *= 2
        widths.add(self._batch_width(self.max_batch))
        for w in sorted(widths):
            res, packed = self._solve(*_assemble_batch_np([sample], w), sample.pose_known)
            if self.mesher is not None:
                packed = self.mesher.pack_solve_with_grids(res)
            packed.cpu()

    def _solve(self, obs, lat0, T0, pose_known: bool):
        """One host batch (`_assemble_batch_np`) through the packed solve,
        sharded over the mesh where there is one: (result, packed result)."""
        dev = self.device
        obs = FruitObservations(*(upload(a, dev) for a in obs))
        lat0, T0 = upload(lat0, dev), upload(T0, dev)
        if self.mesh is None:
            return lm.joint_opt_packed(self.params, self.spec, self.cfg, obs, lat0, T0,
                                       self.cube_radius, pose_known,
                                       latent_table=self.latent_table, device=dev,
                                       packs=self._packs)
        res = shard_joint_opt(self.params, self.spec, self.cfg, obs, lat0, T0, self.cube_radius,
                              self.mesh, pose_known, latent_table=self.latent_table, device=dev)
        return res, lm.pack_result(res)

    def stats(self) -> Dict:
        """Counts and rates since `start()`, for an operator's glance.
        Latency runs from `submit()` (`time.perf_counter`) to the result,
        mesh included, over the last 4096 completions; `fruits_per_sec` is
        the completions over the wall time since `start()`, idle time
        included. Queue wait alone, and each batch's host and solve time,
        are the spans `serve.queue`, `serve.batch` and `serve.solve`
        (`utils/trace.py`) under a profiler session."""
        with self._lock:
            lat = sorted(self._latencies)
            n = self._completed
            wall = (time.perf_counter() - self._started_at) if self._started_at else 0.0
        return {
            "completed": n,
            "fruits_per_sec": n / wall if wall > 0 else 0.0,
            "latency_p50_s": lat[len(lat) // 2] if lat else 0.0,
            "latency_p95_s": lat[int(len(lat) * 0.95)] if lat else 0.0,
            "queued": self._q.qsize() + self._pending_count(),
            "devices": 1 if self.mesh is None else self.mesh.size,
            "inflight": self._inflight,
            "deadline_expired": self._expired,
        }

    def _pending_count(self) -> int:
        try:  # best effort: the worker thread changes _pending meanwhile
            return sum(len(d) for d in list(self._pending.values()))
        except RuntimeError:  # pragma: no cover - dict resized mid-iteration
            return 0

    # ---------------- worker ----------------

    def _safe_key(self, item) -> Optional[Tuple]:
        """Shape key, or None after failing the request's Future (a malformed
        observation must not kill the worker or hang a waiter)."""
        try:
            return _shape_key(item[0])
        except Exception as e:
            if not item[1].done():
                item[1].set_exception(e)
            return None

    def _pump(self, timeout: float) -> bool:
        """Move arrivals from the queue into the per-bucket FIFOs. Blocks up
        to `timeout` for the first item, then drains whatever is ready."""
        try:
            item = self._q.get(timeout=timeout) if timeout > 0 else self._q.get_nowait()
        except queue.Empty:
            return False
        got = False
        while True:
            k = self._safe_key(item)
            if k is not None:
                self._pending.setdefault(k, deque()).append(item)
                got = True
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return got

    def _drain(self) -> List[Tuple[CompletionRequest, Future, float]]:
        """Pick the bucket whose head request is oldest (FIFO across shape
        buckets: a steady majority stream cannot starve a minority bucket),
        then wait up to max_wait_s for more of its requests to fill the
        batch."""
        if not self._pending and not self._pump(0.05):
            return []
        key = min(self._pending, key=lambda k: self._pending[k][0][2])
        dq = self._pending[key]
        deadline = time.perf_counter() + self.max_wait_s
        while len(dq) < self.max_batch:
            timeout = deadline - time.perf_counter()
            if timeout <= 0 or not self._pump(timeout):
                break
        batch = [dq.popleft() for _ in range(min(self.max_batch, len(dq)))]
        if not dq:
            del self._pending[key]
        self._seq += 1
        if trace.enabled():
            # each request's wait, from the t_sub that submit() stamped
            now = time.perf_counter_ns()
            for req, _, t_sub in batch:
                trace.record("serve.queue", round(t_sub * 1e9), now, group=self._seq,
                             fruit=req.fruit_id, batch=self._seq)
        return batch

    def _serve(self, batch) -> None:
        """Assemble, solve and (with meshing on) decode one batch, copy its
        results to the host in one copy and resolve its Futures; on an
        exception, resolve each of them with it."""
        reqs = [b[0] for b in batch]
        futs = [b[1] for b in batch]
        try:
            n = len(reqs)
            # the next power of two, not max_batch: a one-fruit batch must
            # not pay for a full-width solve
            obs, lat0, T0 = _assemble_batch_np(reqs, self._batch_width(n))
            with trace.span("serve.solve", batch=self._seq):
                res, packed_dev = self._solve(obs, lat0, T0, reqs[0].pose_known)
            C = res.latent.shape[1]
            grids = None
            if self.mesher is not None:
                combo = self.mesher.pack_solve_with_grids(res).cpu().numpy()
                packed, grids = self.mesher.unpack_solve_with_grids(combo)
            else:
                packed = packed_dev.cpu().numpy()
            latents = packed[:, :C]
            T_ows = packed[:, C:C + 16].reshape(-1, 4, 4)
            iters = packed[:, C + 16].astype(np.int32)
            failed = packed[:, C + 17] > 0.5
            conv = packed[:, C + 18] > 0.5
            meshes = [None] * n
            if grids is not None:
                T_wo = np.linalg.inv(T_ows[:n])
                meshes = [m.transform(T) for m, T in
                          zip(self.mesher.meshes_from_grids(torch.from_numpy(grids[:n])), T_wo)]
            now = time.perf_counter()
            for i, fut in enumerate(futs):
                if fut.done():  # e.g. cancelled by the client meanwhile
                    continue
                fut.set_result(CompletionResult(
                    fruit_id=reqs[i].fruit_id,
                    latent=latents[i],
                    T_ow=T_ows[i],
                    iter_count=int(iters[i]),
                    failed=bool(failed[i]),
                    converged=bool(conv[i]),
                    mesh=meshes[i],
                    latency_s=now - batch[i][2],
                    batch_size=n,
                ))
            with self._lock:
                self._completed += n
                self._latencies.extend(now - b[2] for b in batch)
        except Exception as e:  # deliver the failure to every waiter
            for fut in futs:
                if not fut.done():
                    fut.set_exception(e)

    def _worker(self) -> None:
        # each batch is completed before the next is packed (module docstring)
        while not self._stop.is_set() or not self._q.empty() or self._pending:
            batch = self._drain()
            # pack-time deadline check: an expired request takes no lane
            batch = [b for b in batch if not self._expire(b)]
            # honour a client's Future.cancel() before paying for the lane
            batch = [b for b in batch if b[1].set_running_or_notify_cancel()]
            if batch:
                with trace.span("serve.batch", group=self._seq, batch=self._seq,
                                lanes=len(batch), width=self._batch_width(len(batch))):
                    self._serve(batch)
