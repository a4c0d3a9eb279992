"""One run of one cell: find its files by name, set up, warm up, measure
for `--seconds`, check the answers against the reference, read the
metrics, print the result. Nothing here names a cell, a configuration or a
metric: the cell's file names its configuration and its traffic driver,
and each metric is a reader of its own under `metrics/`."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "hortimapping_tpu")
POOL_WORKERS = 4          # processes that draw the scene pool


@dataclasses.dataclass
class Done:
    key: str
    scene: int
    T_ow0: np.ndarray
    t_due: float
    t_done: float
    latent: Optional[np.ndarray] = None
    T_ow: Optional[np.ndarray] = None
    mesh: Optional[tuple] = None          # (world vertices, faces)
    failed: bool = False
    batch_size: int = 0


@dataclasses.dataclass
class Window:
    t0: float
    t_end: float
    done: List[Done]
    attempted: int
    failed: int
    notes: Dict[str, float]


def done_from_result(req, res, t_due: float, t_done: float) -> Done:
    """A served `CompletionResult` of benchmark request `req`."""
    mesh = None if res.mesh is None else (res.mesh.vertices, res.mesh.faces)
    return Done(req.key, req.scene, req.T_ow0, t_due, t_done, latent=res.latent, T_ow=res.T_ow,
                mesh=mesh, failed=bool(res.failed or mesh is None), batch_size=int(res.batch_size))


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.isfile(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Cell:
    """A cell's entries of BENCHMARK.json and its files: the workload
    (`workloads/<cell>.json`), its configuration (`configs/<config>.json`),
    its traffic driver (`traffic/<driver>.py`) and its metrics' readers
    (`metrics/<metric>.py`)."""

    def __init__(self, root: str, name: str, overrides: Optional[dict] = None,
                 bench_dir: str = BENCH):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)
        entry = [w for w in self.bench["workloads"] if w["name"] == name]
        if not entry:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        self.entry = entry[0]
        over = overrides or {}
        self.bench_dir = bench_dir
        with open(os.path.join(bench_dir, "workloads", name + ".json")) as f:
            self.workload = merge(json.load(f), over.get("workload", {}))
        with open(os.path.join(bench_dir, "configs", self.workload["config"] + ".json")) as f:
            self.config = merge(json.load(f), over.get("config", {}))
        self.driver = load_module(os.path.join(bench_dir, "traffic", self.workload["driver"] + ".py"),
                                  "bench_driver_" + self.workload["driver"])

    def metrics(self, traced: bool) -> List[dict]:
        """The metrics this cell reports in a run: its end-to-end ones, or
        with a trace its per-layer ones."""
        group = self.bench["per_layer" if traced else "end_to_end"]
        return [m for m in group if "workloads" not in m or self.entry["name"] in m["workloads"]]


class Ctx:
    """What the driver, the check and the readers share in one run."""

    def __init__(self, cell: Cell, seed: int, seconds: float, traced: bool, dev):
        self.cell = cell
        self.root = cell.root
        self.workload = cell.workload
        self.config = cell.config
        self.params = cell.workload["params"]
        self.seed = seed
        self.seconds = seconds
        self.traced = traced
        self.dev = dev


_SETUP: Dict[tuple, object] = {}


def _once(key: tuple, make):
    """The program and the scene pool, made once a process: a process that
    runs a cell on many seeds (`control.py`, the tests) sets each up once.
    A benchmark run makes each once all the same."""
    if key not in _SETUP:
        _SETUP[key] = make()
    return _SETUP[key]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(root: str, name: str, seed: int, seconds: float, traced: bool, *,
             require_cuda: bool = True, overrides: Optional[dict] = None, t_start=None,
             before=None):
    """Run one cell once. Returns (result dict, check lines, notes).
    `before(ctx)`, where given, runs once the program is set up and before
    the benchmark's wrappers go on (the control and the tests' faults put
    their code in the program's place there); it returns an undo callable."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(root, name, overrides)
    if require_cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
            raise SystemExit(f"{name}: needs {cell.entry['chips']} CUDA device(s), found "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    cuda = dev.type == "cuda"

    from lib import check, reference, scenes, trace
    from lib.program import Program
    from lib.record import Recorder, install, uninstall

    reference.pin_f32()
    ctx = Ctx(cell, seed, seconds, traced, dev)
    ctx.program = _once(("program", root, json.dumps(cell.config, sort_keys=True),
                         ctx.params["pool_seed"], str(dev)),
                        lambda: Program(root, cell.config, ctx.params["pool_seed"], dev))
    ctx.table = ctx.program.table
    sc = dict(cell.config["scene"], n_frames=cell.config["solver"]["n_frame"],
              n_fg=cell.config["solver"]["n_fg_pix"], n_bg=cell.config["solver"]["n_bg_pix"],
              n_points=cell.config["solver"]["recon_n_pts"])
    # the pool, the table's drawn codes and (in the drivers) the batches and
    # the arrival gaps are the same set for every seed, so that every seed
    # gives the same work; the seed draws their order and the pose offsets
    ctx.pool = _once(("pool", json.dumps(sc, sort_keys=True), cell.config["decoder"]["code_length"],
                      ctx.params["pool"], ctx.params["pool_seed"]),
                     lambda: scenes.build_pool(sc, cell.config["decoder"]["code_length"],
                                               ctx.params["pool"], ctx.params["pool_seed"],
                                               workers=cell.workload.get("pool_workers",
                                                                         POOL_WORKERS)))
    chk = check.settings(cell.workload)
    ctx.rec = Recorder(seed, chk["watch_lanes"], traced, cuda, seconds, chk["kept_batches"])
    ctx.reference = None
    undo_before = None
    if before is not None:
        ctx.reference = reference.load_decoder(root, cell.config["decoder"], dev)
        undo_before = before(ctx)
    undo = install(ctx.rec)
    try:
        cell.driver.prepare(ctx)
        if cuda:
            torch.cuda.synchronize()
        ctx.setup_s = time.perf_counter() - t_start
        ctx.rec.start()
        with trace.traced(traced, cuda) as summ:
            win = cell.driver.window(ctx)
        ctx.rec.on = False
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        cell.driver.close(ctx)
    finally:
        uninstall(undo)
        if undo_before is not None:
            undo_before()
    trace.reduce(summ, ctx.rec.spans)
    ctx.window, ctx.summary = win, summ
    ctx.server = None
    if ctx.reference is None:
        ctx.reference = reference.load_decoder(root, cell.config["decoder"], dev)
    t_check = time.perf_counter()
    numbers, ok = check.run(ctx, win)
    check_s = time.perf_counter() - t_check
    metrics = {}
    for m in cell.metrics(traced):
        reader = load_module(os.path.join(cell.bench_dir, "metrics", m["name"] + ".py"),
                             "bench_metric_" + m["name"].replace(".", "_"))
        v = reader.read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    if traced:
        device["busy_s"] = summ.busy_s
        device["window_s"] = summ.window_s
    result = {"correct": bool(ok), "attempted": win.attempted, "failed": win.failed,
              "metrics": metrics, "device": device}
    if traced:
        result["breakdown"] = trace.breakdown(summ)
    result["check"] = {k: {"value": v, "limit": l} for k, (v, l) in numbers.items()}
    lines = [f"check {k}: {v!r} (limit {l!r})" for k, (v, l) in numbers.items()]
    notes = dict(win.notes, window_s=win.t_end - win.t0, fruits=len(win.done),
                 batches=len(ctx.rec.batches), kept=sum(b.kept for b in ctx.rec.batches),
                 check_s=check_s)
    return result, lines, notes
