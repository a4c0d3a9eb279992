"""DeepSDF decoder training on the card (counterpart of
`hortimapping_tpu/train/deepsdf.py`).

The same experiment-directory convention, so a trained run drops straight
into the completion pipelines:

  <experiment>/specs.json                 arch + training hyperparameters
  <data_source>/SdfSamples/<name>.npz     per-scene samples, keys "pos"/"neg",
                                          each [N, 4] (xyz, sdf)
  -> <experiment>/native/<ckpt>.npz       folded weights + latent-code table
                                          (models/workspace.py)

The sample banks live on the device: one padded [S, N_cap, 4] tensor per
sign with its counts. A step draws ScenesPerBatch scenes and, for each,
SamplesPerScene / 2 positive and as many negative samples uniformly over
the scene's valid prefix (`_draw_step`, on the device generator), then
minimises the clamped L1 plus the ramped code regulariser

    L = |clamp(f(z_s, x)) - clamp(sdf)|_1 + lambda * min(1, (e + 1) / 100) |z|^2

with a straight-through clamp on the prediction: the value is the clamped
loss, the gradient treats the clamp as identity, so a prediction saturated
on the wrong side keeps its restoring pull. The network and the dense
latent table are two Adam groups under the two step-decay schedules of
`LearningRateSchedule` (initial * factor^floor(epoch / interval), set each
epoch); `CodeBound` projects the codes after each update. The decoder runs
as the plain `decoder_apply` under autograd (cuBLAS products on the card);
no kernel of the port is on this path.

Data-parallel over a fruit mesh (`mesh=`): the scene batch is split over
the shards (ScenesPerBatch / shards each, rounded up), each shard draws its
own scenes on its own generator (shard 0 on the run's, shard i on one
seeded from (seed, i)) and computes its loss and gradients in its own host
thread on its own replica; the losses and gradients are averaged in shard
order on the first shard's device, which holds the one master copy of the
parameters, the codes and both Adam groups (shard 0 works on it), and the
one update is copied to the other shards' replicas.

Over a mesh that spans processes (`parallel.init_multi_host`; every process
calls with the same arguments): process r's local shard i is global shard
g = r * k + i (k shards a process) and draws as global shard g of a
one-process mesh would. Each process keeps its own master copy on its first
device; the start is checked equal across processes (a digest of the
arguments, the data's names, the parameters, codes and Adam state). Each
step, each process packs each local shard's loss and gradients into one
flat f32 row, the rows of every process are gathered over gloo
(`parallel.sharding.gather_rows`: an all_gather, never an all-reduce,
whose order would depend on the split into processes) and every process
averages them in global shard order and takes the same Adam step. So the
run does not depend on how the shards are split into processes, and a
snapshot (every global shard's generator, written by rank 0 alone) resumes
on any layout of the same global shard count. A failure in any shard, or in
rank 0's writes, raises in every process (`raise_on_any_rank`).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hortimapping_tpu_torch.device import resolve_device
from hortimapping_tpu_torch.models.decoder import (
    DecoderSpec,
    Params,
    decoder_apply,
    init_decoder_params,
)
from hortimapping_tpu_torch.models.workspace import NATIVE_SUBDIR, load_specs, save_native_checkpoint
from hortimapping_tpu_torch.parallel.sharding import (
    check_shard_counts,
    gather_rows,
    raise_on_any_rank,
    run_shards,
)

TRAIN_STATE_FILE = "train_state.npz"
# marks the port's snapshots: the JAX trainer's file of the same name holds
# its flattened carry ("leaf_*"), which this package refuses
STATE_FORMAT = "hortimapping_tpu_torch.train_state/1"
_STALE = "specs.json or the dataset changed since the snapshot; delete it to restart from scratch"


def _train_state_path(experiment_directory: str) -> str:
    return os.path.join(experiment_directory, NATIVE_SUBDIR, TRAIN_STATE_FILE)


def _split_names(split: Optional[object]) -> Optional[List[str]]:
    """Flatten a DeepSDF split description (nested dict dataset->class->[ids]
    or a plain list) into instance names."""
    if split is None:
        return None
    if isinstance(split, (list, tuple)):
        return list(split)
    names: List[str] = []
    for classes in split.values():
        for ids in classes.values():
            names.extend(ids)
    return names


def load_sdf_samples(
    data_source: str,
    split: Optional[object] = None,
    n_cap: int = 16384,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """Load SdfSamples/*.npz into padded banks.

    Returns (pos [S, n_cap, 4], pos_n [S], neg [S, n_cap, 4], neg_n [S],
    names). A scene with more than n_cap samples of a sign is subsampled
    once on the host (`rng`, default `default_rng(0)`, drawn as the JAX
    package draws); training resamples on the device every step.
    """
    rng = rng or np.random.default_rng(0)
    root = os.path.join(data_source, "SdfSamples")
    names = _split_names(split)
    if names is None:
        names = sorted(
            os.path.splitext(f)[0] for f in os.listdir(root) if f.endswith(".npz")
        )
    S = len(names)
    if S == 0:
        raise FileNotFoundError(f"no SdfSamples .npz under {root}")
    pos = np.zeros((S, n_cap, 4), np.float32)
    neg = np.zeros((S, n_cap, 4), np.float32)
    pos_n = np.zeros(S, np.int32)
    neg_n = np.zeros(S, np.int32)
    for s, name in enumerate(names):
        with np.load(os.path.join(root, name + ".npz")) as z:
            for key, bank, count in (("pos", pos, pos_n), ("neg", neg, neg_n)):
                a = np.asarray(z[key], np.float32).reshape(-1, 4)
                if a.shape[0] > n_cap:
                    a = a[rng.choice(a.shape[0], n_cap, replace=False)]
                bank[s, : a.shape[0]] = a
                count[s] = a.shape[0]
    return pos, pos_n, neg, neg_n, names


@dataclasses.dataclass
class TrainResult:
    params: Params
    latent_codes: np.ndarray         # [S, C]
    losses: np.ndarray               # per-epoch mean loss
    names: List[str]
    checkpoint_path: Optional[str] = None
    # wall_s (whole loop), steady_wall_s / steady_epochs (without the first
    # chunk: first launches, allocator and library warm-up), steps_per_epoch
    timing: Optional[Dict] = None


def _lr_schedule(entry: Dict, default_initial: float) -> Tuple[float, float, float]:
    """(initial, factor, interval) of a DeepSDF 'Step' LearningRateSchedule."""
    if not entry:
        return default_initial, 0.5, 500.0
    return (
        float(entry.get("Initial", default_initial)),
        float(entry.get("Factor", 0.5)),
        float(entry.get("Interval", 500)),
    )


def _draw_step(generator: torch.Generator, n_scenes: int, scenes: int, half: int,
               pos_n: torch.Tensor, neg_n: torch.Tensor):
    """One step's draws on the device, with the JAX trainer's distributions:
    `scenes` scene ids uniform over [0, n_scenes), then for each sign
    randint(0, 2^30) % max(count, 1) sample indices [scenes, half].
    -> (scene_ids, pos_idx, neg_idx)."""
    dev = pos_n.device
    scene_ids = torch.randint(0, n_scenes, (scenes,), generator=generator, device=dev)

    def draw(counts):
        raw = torch.randint(0, 1 << 30, (scenes, half), generator=generator, device=dev)
        return raw % counts[scene_ids].clamp_min(1)[:, None]

    return scene_ids, draw(pos_n), draw(neg_n)


def _shard_generator(seed: int, shard: int, device: torch.device) -> torch.Generator:
    """The draw generator of shard `shard` > 0 of a data-parallel run, seeded
    from (seed, shard) without touching numpy's global generator."""
    state = np.random.SeedSequence([seed, shard]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _generator_states(generators: Sequence[torch.Generator], mesh) -> List[np.ndarray]:
    """Every global shard's generator state, in global shard order: this
    process's, or on a mesh that spans processes every process's
    (a collective: every process calls it)."""
    mine = [g.get_state().numpy() for g in generators]
    if mesh is None or mesh.world_size == 1:
        return mine
    import torch.distributed as dist

    parts = [None] * mesh.world_size
    dist.all_gather_object(parts, mine)
    return [s for p in parts for s in p]


def _save_train_state(experiment_directory: str, params: Params, codes: torch.Tensor,
                      opt: torch.optim.Adam, generator_states: Sequence[np.ndarray], epoch: int,
                      losses: Sequence[float]) -> str:
    """Persist the whole training state (params, codes, both Adam groups'
    moments and step counts, every global shard's generator state), the
    epoch and the loss history, atomically: a temp file renamed over the
    last snapshot."""
    arrays = {"format": np.asarray(STATE_FORMAT)}
    for name, p in params.items():
        for k in ("w", "b"):
            arrays[f"params.{name}.{k}"] = p[k].detach().cpu().numpy()
    arrays["codes"] = codes.detach().cpu().numpy()
    for i, st in opt.state_dict()["state"].items():
        for k, v in st.items():
            arrays[f"adam.{i}.{k}"] = v.detach().cpu().numpy()
    arrays["generator"] = generator_states[0]
    for i, st in enumerate(generator_states[1:], 1):
        arrays[f"generator.{i}"] = st
    arrays["shards"] = np.asarray(len(generator_states), np.int64)
    arrays["epoch"] = np.asarray(int(epoch), np.int64)
    arrays["losses"] = np.asarray(losses, np.float64)
    path = _train_state_path(experiment_directory)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path[: -len(".npz")] + ".tmp.npz"   # np.savez appends .npz to other names
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return path


def _load_train_state(experiment_directory: str, params: Params, codes: torch.Tensor,
                      opt: torch.optim.Adam, generators: Sequence[torch.Generator],
                      first: int = 0, total: Optional[int] = None):
    """Restore a snapshot of `_save_train_state` into the given state in
    place -> (epoch, losses); `generators` are global shards first,
    first + 1, ... of `total` (default: all of them). Refuses another
    package's snapshot, one whose shapes do not match this experiment and
    one of another global number of shards."""
    path = _train_state_path(experiment_directory)
    with np.load(path) as z:
        if "format" not in z.files or str(z["format"]) != STATE_FORMAT:
            raise ValueError(
                f"{path} is not a training state of this package (the JAX package's "
                "trainer writes its own under the same name); delete it to restart from "
                "scratch")
        want = {f"params.{name}.{k}": p[k] for name, p in params.items() for k in ("w", "b")}
        want["codes"] = codes
        shards = int(z["shards"]) if "shards" in z.files else 1
        total = len(generators) if total is None else total
        if shards != total:
            raise ValueError(f"{path} was written by a run on {shards} shards, not "
                             f"{total}: the draws would differ")
        saved = {k for k in z.files if k.startswith("params.")} | {"codes"}
        if saved != set(want):
            raise ValueError(f"{path} holds other layers than the experiment's: {_STALE}")
        for k, t in want.items():
            if tuple(z[k].shape) != tuple(t.shape):
                raise ValueError(f"{path} {k} shape {z[k].shape} != expected "
                                 f"{tuple(t.shape)}: {_STALE}")
        with torch.no_grad():
            for k, t in want.items():
                t.copy_(torch.as_tensor(z[k]))
        sd = opt.state_dict()
        n_params = sum(len(g["params"]) for g in sd["param_groups"])
        sd["state"] = {}
        for i in range(n_params):
            keys = [k for k in z.files if k.startswith(f"adam.{i}.")]
            if keys:
                sd["state"][i] = {k.split(".", 2)[2]: torch.as_tensor(z[k]) for k in keys}
        opt.load_state_dict(sd)
        for i, g in enumerate(generators, first):
            g.set_state(torch.as_tensor(z["generator" if i == 0 else f"generator.{i}"]))
        epoch = int(z["epoch"])
        losses = [float(x) for x in z["losses"]]
    return epoch, losses


def _state_digest(facts, tensors: Sequence[torch.Tensor]) -> str:
    """A digest of `facts` (repr) and the tensors' values, to check that the
    processes of a run start from the same state."""
    h = hashlib.sha256(repr(facts).encode())
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def train_deepsdf(
    experiment_directory: str,
    data_source: Optional[str] = None,
    split: Optional[object] = None,
    num_epochs: Optional[int] = None,
    seed: int = 0,
    save: bool = True,
    checkpoint: str = "latest",
    mesh=None,
    epochs_per_call: int = 25,
    snapshot_every: Optional[int] = None,
    resume: bool = False,
    log=print,
    device: str | torch.device = "cuda",
) -> TrainResult:
    """Train a DeepSDF decoder + latent table from an experiment directory.

    Reads the architecture and hyperparameters from `<experiment>/specs.json`
    (the upstream training fields with their upstream defaults), trains on
    `<data_source>/SdfSamples` on `device`, and writes the native checkpoint
    + latent table that `models.workspace.config_decoder` and
    `load_latent_vectors` load (in either package).

    The per-epoch mean loss is read back to the host once every
    `epochs_per_call` epochs. `snapshot_every=N` writes, every N epochs, the
    inference checkpoint `<experiment>/native/<checkpoint>.npz` and the whole
    training state `<experiment>/native/train_state.npz`; chunks end on
    snapshot boundaries, so `resume=True` replays the same chunking and
    continues bit for bit on the CPU. On the card it is held to rounding
    only: PyTorch does not promise a CUDA backward's summation order.

    `mesh` (`parallel/sharding.FruitMesh`): data-parallel over its shards
    (module docstring), the master state on its first device in place of
    `device`. On a mesh that spans processes every process calls with the
    same arguments and returns the same result (`timing` aside, which also
    gets `gather_s`, the seconds spent in the exchange between processes);
    rank 0 alone writes the checkpoint and the training state, and every
    process reads the state on resume, so the experiment directory is one
    that every process sees.
    """
    world = mesh.world_size if mesh is not None else 1
    rank = mesh.rank if mesh is not None else 0
    dev = resolve_device(mesh.devices[0] if mesh is not None else device)
    specs = load_specs(experiment_directory)
    spec = DecoderSpec.from_specs_json(specs)
    data_source = data_source or specs.get("DataSource")
    if data_source is None:
        raise ValueError("data_source not given and specs.json has no DataSource")
    if split is None and specs.get("TrainSplit") and os.path.isfile(str(specs["TrainSplit"])):
        with open(specs["TrainSplit"]) as f:
            split = json.load(f)

    scenes_per_batch = int(specs.get("ScenesPerBatch", 64))
    samples_per_scene = int(specs.get("SamplesPerScene", 8192))
    num_epochs = int(num_epochs or specs.get("NumEpochs", 500))
    clamp = float(specs.get("ClampingDistance", 0.1))
    code_reg = bool(specs.get("CodeRegularization", True))
    code_reg_lambda = float(specs.get("CodeRegularizationLambda", 1e-4))
    code_init_std = float(specs.get("CodeInitStdDev", 0.01))
    code_bound = specs.get("CodeBound")
    sched = specs.get("LearningRateSchedule", [])
    net_lr0, net_f, net_iv = _lr_schedule(sched[0] if len(sched) > 0 else {}, 5e-4)
    cod_lr0, cod_f, cod_iv = _lr_schedule(sched[1] if len(sched) > 1 else {}, 1e-3)

    pos, pos_n, neg, neg_n, names = load_sdf_samples(data_source, split)
    S = len(names)
    scenes_per_batch = min(scenes_per_batch, S)
    steps_per_epoch = max(1, S // scenes_per_batch)
    half = samples_per_scene // 2
    shards = [resolve_device(d) for d in mesh.devices] if mesh is not None else [dev]
    n_global = mesh.size if mesh is not None else 1
    first = rank * len(shards)   # this process's first global shard
    # each shard's share of the global scene batch, rounded up: flooring
    # would shrink the effective ScenesPerBatch against specs.json
    scenes_local = max(1, -(-scenes_per_batch // n_global))
    if mesh is not None and scenes_local * n_global != scenes_per_batch:
        log(f"[train] ScenesPerBatch={scenes_per_batch} is not divisible by {n_global} "
            f"devices; rounding the global scene batch up to {scenes_local * n_global}")

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_decoder_params(spec, gen, dev)
    codes = torch.as_tensor(
        (np.random.default_rng(seed).normal(size=(S, spec.code_length)) * code_init_std)
        .astype(np.float32)).to(dev).requires_grad_(True)
    net = [p[k].requires_grad_(True) for p in params.values() for k in ("w", "b")]
    # optax's adam(1.0) scaled by the lr is Adam with the lr set per epoch;
    # the code table is one dense parameter: rows not drawn in a step still
    # move with their moments, as optax moves them
    opt = torch.optim.Adam([{"params": net, "lr": net_lr0}, {"params": [codes], "lr": cod_lr0}])
    # global shard 0 draws on the run's generator, global shard g > 0 on
    # (seed, g)'s, whatever process holds it
    gens = [gen if g == 0 else _shard_generator(seed, g, d) for g, d in enumerate(shards, first)]
    # the sample banks once a device; the parameters and codes: shard 0's
    # are the master, every other shard differentiates a replica of its own
    # (shards of one device share no autograd leaf across threads)
    banks = {d: tuple(torch.as_tensor(a).to(d) for a in (pos, neg, pos_n, neg_n))
             for d in dict.fromkeys(shards)}
    replicas = [(params, codes)] + [
        ({k: {kk: v.detach().to(d).requires_grad_(True) for kk, v in p.items()}
          for k, p in params.items()}, codes.detach().to(d).requires_grad_(True))
        for d in shards[1:]]

    def shard_loss(p: Params, cz: torch.Tensor, d: torch.device, draw,
                   reg_ramp: float) -> torch.Tensor:
        scene_ids, pos_idx, neg_idx = draw
        pos_d, neg_d = banks[d][:2]
        rows = scene_ids[:, None]
        samples = torch.cat([pos_d[rows, pos_idx], neg_d[rows, neg_idx]], dim=1)
        xyz, sdf_gt = samples[..., :3], samples[..., 3].clamp(-clamp, clamp)
        z = cz[scene_ids]
        inp = torch.cat([z[:, None, :].expand(-1, xyz.shape[1], -1), xyz], dim=-1)
        pred = decoder_apply(p, spec, inp)[..., 0]
        # straight-through clamp (module docstring): a hard clamp has zero
        # gradient outside the band, and Adam's normalised steps push the
        # mean prediction past it within a few steps at full width, after
        # which every gradient is 0 and the run is dead
        pred = pred + (pred.clamp(-clamp, clamp) - pred).detach()
        loss = torch.mean(torch.abs(pred - sdf_gt))
        if code_reg:
            loss = loss + code_reg_lambda * reg_ramp * torch.mean(torch.sum(z * z, dim=-1))
        return loss

    def leaves(p: Params, cz: torch.Tensor) -> List[torch.Tensor]:
        return [p_[k] for p_ in p.values() for k in ("w", "b")] + [cz]

    @torch.no_grad()
    def sync_replicas() -> None:
        for p, cz in replicas[1:]:
            for r, m in zip(leaves(p, cz), leaves(params, codes)):
                r.copy_(m)

    def update(grads: Optional[List[torch.Tensor]] = None) -> None:
        """The Adam step from the gradients in .grad (or `grads`), the
        CodeBound projection, and the new values copied to the replicas."""
        if grads is not None:
            for leaf, g in zip(leaves(params, codes), grads):
                leaf.grad = g
        opt.step()
        if code_bound is not None:
            with torch.no_grad():
                norm = torch.linalg.norm(codes, dim=-1, keepdim=True)
                codes.mul_(torch.clamp(float(code_bound) / norm.clamp_min(1e-12), max=1.0))
        sync_replicas()

    def mean_in_order(ts: List[torch.Tensor]) -> torch.Tensor:
        acc = ts[0].to(dev, copy=True)
        for t in ts[1:]:
            acc.add_(t.to(dev))
        return acc.div_(len(ts))

    def step(reg_ramp: float) -> torch.Tensor:
        if mesh is None:
            draw = _draw_step(gen, S, scenes_per_batch, half, *banks[dev][2:])
            loss = shard_loss(params, codes, dev, draw, reg_ramp)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            update()
            return loss.detach()
        # every shard's draws on the calling thread, in shard order
        draws = [_draw_step(g, S, scenes_local, half, *banks[d][2:])
                 for g, d in zip(gens, shards)]

        def shard(i: int):
            p, cz = replicas[i]
            loss = shard_loss(p, cz, shards[i], draws[i], reg_ramp)
            return (loss.detach(),) + tuple(torch.autograd.grad(loss, leaves(p, cz)))

        if world == 1:
            outs = run_shards(shard, shards, dev)
            opt.zero_grad(set_to_none=True)
            update([mean_in_order([o[j] for o in outs]) for j in range(1, len(outs[0]))])
            return mean_in_order([o[0] for o in outs])

        def packed(i: int) -> torch.Tensor:
            """Shard i's loss and gradients as one flat f32 row."""
            try:
                return torch.cat([t.reshape(-1) for t in shard(i)])
            except Exception as exc:
                raise RuntimeError(f"shard {first + i}: {type(exc).__name__}: {exc}") from exc

        error, local = None, None
        try:
            local = torch.stack([r.cpu() for r in run_shards(packed, shards, dev)])
        except Exception as exc:   # raised below in every process, not only here
            error = exc
        t0 = time.perf_counter()
        raise_on_any_rank(mesh, error, "training step")
        rows = gather_rows(local, mesh)
        gather_s[0] += time.perf_counter() - t0
        mean = mean_in_order(list(rows.to(dev)))
        sizes = [t.numel() for t in leaves(params, codes)]
        opt.zero_grad(set_to_none=True)
        update([g.view_as(t) for g, t in zip(mean[1:].split(sizes), leaves(params, codes))])
        return mean[0]

    def run_chunk(e0: int, n: int) -> List[float]:
        means = []
        for e in range(e0, e0 + n):
            opt.param_groups[0]["lr"] = net_lr0 * net_f ** math.floor(e / net_iv)
            opt.param_groups[1]["lr"] = cod_lr0 * cod_f ** math.floor(e / cod_iv)
            reg_ramp = min(1.0, (e + 1.0) / 100.0)
            means.append(torch.stack([step(reg_ramp) for _ in range(steps_per_epoch)]).mean())
        return torch.stack(means).tolist()   # the chunk's one host round trip

    losses: list = []
    e = 0
    if resume and os.path.isfile(_train_state_path(experiment_directory)):
        e, losses = _load_train_state(experiment_directory, params, codes, opt, gens, first,
                                      n_global)
        sync_replicas()
        log(f"resumed at epoch {e}/{num_epochs} from "
            f"{_train_state_path(experiment_directory)}")
    gather_s = [0.0]
    if world > 1:
        import torch.distributed as dist

        # every process starts from the same state, or none trains
        facts = (names, specs, num_epochs, seed, save, checkpoint, epochs_per_call,
                 snapshot_every, e, losses)
        opt_state = [v for st in opt.state_dict()["state"].values() for v in st.values()]
        said = [None] * world
        dist.all_gather_object(said, (len(shards), _state_digest(
            facts, leaves(params, codes) + opt_state)))
        check_shard_counts([k for k, _ in said])
        if len({d for _, d in said}) != 1:
            raise ValueError("the processes of the mesh start from different states (arguments, "
                             "data, parameters or snapshot): every process must call "
                             "train_deepsdf with the same arguments on the same files")

    def rank0_writes(write) -> None:
        """write() on rank 0 alone; every other process waits for it and
        raises if it failed."""
        if world == 1:
            write()
            return
        error = None
        if rank == 0:
            try:
                write()
            except Exception as exc:   # raised below in every process
                error = exc
        raise_on_any_rank(mesh, error, "rank 0's write")

    epochs_per_call = max(1, min(int(epochs_per_call), num_epochs))
    t0 = time.time()
    t_first = None  # end of the first chunk: first launches + one chunk of work
    e_start = e     # resume offset: only num_epochs - e_start epochs run
    first_chunk_n = 0

    def snapshot():
        states = _generator_states(gens, mesh)

        def write():
            save_native_checkpoint(experiment_directory, checkpoint, params, spec,
                                   latent_codes=codes)
            _save_train_state(experiment_directory, params, codes, opt, states, e, losses)

        rank0_writes(write)

    while e < num_epochs:
        n = min(epochs_per_call, num_epochs - e)
        if snapshot_every:
            # chunk ends land on snapshot boundaries, so a resumed run
            # replays the same chunking
            n = min(n, snapshot_every - e % snapshot_every)
        losses.extend(run_chunk(e, n))
        if t_first is None:
            t_first = time.time()
            first_chunk_n = n
        e += n
        log(f"epoch {e:4d}/{num_epochs}  loss {losses[-1]:.5f}  "
            f"({time.time() - t0:.1f}s)")
        if snapshot_every and e % snapshot_every == 0 and e < num_epochs:
            snapshot()
    timing = {
        "wall_s": time.time() - t0,
        "steady_wall_s": (time.time() - t_first) if t_first else 0.0,
        "steady_epochs": max(0, (num_epochs - e_start) - first_chunk_n),
        "steps_per_epoch": steps_per_epoch,
    }
    if world > 1:
        timing["gather_s"] = gather_s[0]

    path = None
    if save:
        # keep the training state current, so a later resume with a larger
        # num_epochs extends this run
        states = _generator_states(gens, mesh) if snapshot_every else None

        def write():
            save_native_checkpoint(experiment_directory, checkpoint, params, spec,
                                   latent_codes=codes)
            if snapshot_every:
                _save_train_state(experiment_directory, params, codes, opt, states, e, losses)

        rank0_writes(write)
        path = os.path.join(experiment_directory, NATIVE_SUBDIR, checkpoint + ".npz")
        log(f"saved {path}")
    out = {k: {kk: v.detach() for kk, v in p.items()} for k, p in params.items()}
    return TrainResult(out, codes.detach().cpu().numpy(), np.asarray(losses), names, path,
                       timing)


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser(
        description="Train a DeepSDF decoder from a DeepSDF experiment directory.")
    ap.add_argument("--experiment", "-e", required=True,
                    help="experiment directory containing specs.json")
    ap.add_argument("--data_source", "-d", default=None,
                    help="dataset root containing SdfSamples/ (default: specs.json DataSource)")
    ap.add_argument("--epochs", default=None, type=int, help="override specs.json NumEpochs")
    ap.add_argument("--seed", default=0, type=int)
    ap.add_argument("--checkpoint", default="latest")
    ap.add_argument("--snapshot_every", default=None, type=int,
                    help="persist the rolling checkpoint + whole training state every N epochs")
    ap.add_argument("--resume", action="store_true",
                    help="continue from <experiment>/native/train_state.npz")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return train_deepsdf(
        args.experiment, data_source=args.data_source, num_epochs=args.epochs, seed=args.seed,
        checkpoint=args.checkpoint, snapshot_every=args.snapshot_every, resume=args.resume,
        device=args.device,
    )


if __name__ == "__main__":
    main()
