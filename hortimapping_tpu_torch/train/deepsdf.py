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
"""

from __future__ import annotations

import argparse
import dataclasses
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


def _save_train_state(experiment_directory: str, params: Params, codes: torch.Tensor,
                      opt: torch.optim.Adam, generator: torch.Generator, epoch: int,
                      losses: Sequence[float]) -> str:
    """Persist the whole training state (params, codes, both Adam groups'
    moments and step counts, the generator state), the epoch and the loss
    history, atomically: a temp file renamed over the last snapshot."""
    arrays = {"format": np.asarray(STATE_FORMAT)}
    for name, p in params.items():
        for k in ("w", "b"):
            arrays[f"params.{name}.{k}"] = p[k].detach().cpu().numpy()
    arrays["codes"] = codes.detach().cpu().numpy()
    for i, st in opt.state_dict()["state"].items():
        for k, v in st.items():
            arrays[f"adam.{i}.{k}"] = v.detach().cpu().numpy()
    arrays["generator"] = generator.get_state().numpy()
    arrays["epoch"] = np.asarray(int(epoch), np.int64)
    arrays["losses"] = np.asarray(losses, np.float64)
    path = _train_state_path(experiment_directory)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path[: -len(".npz")] + ".tmp.npz"   # np.savez appends .npz to other names
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return path


def _load_train_state(experiment_directory: str, params: Params, codes: torch.Tensor,
                      opt: torch.optim.Adam, generator: torch.Generator):
    """Restore a snapshot of `_save_train_state` into the given state in
    place -> (epoch, losses). Refuses another package's snapshot and one
    whose shapes do not match this experiment."""
    path = _train_state_path(experiment_directory)
    with np.load(path) as z:
        if "format" not in z.files or str(z["format"]) != STATE_FORMAT:
            raise ValueError(
                f"{path} is not a training state of this package (the JAX package's "
                "trainer writes its own under the same name); delete it to restart from "
                "scratch")
        want = {f"params.{name}.{k}": p[k] for name, p in params.items() for k in ("w", "b")}
        want["codes"] = codes
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
        generator.set_state(torch.as_tensor(z["generator"]))
        epoch = int(z["epoch"])
        losses = [float(x) for x in z["losses"]]
    return epoch, losses


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
    `mesh` (data-parallel training) is not ported.
    """
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel training (mesh=) is not ported to the PyTorch package: "
            "ROADMAP.md Queue A, 'Multi-GPU'")
    dev = resolve_device(device)
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
    pos_d, neg_d = torch.as_tensor(pos).to(dev), torch.as_tensor(neg).to(dev)
    pos_nd, neg_nd = torch.as_tensor(pos_n).to(dev), torch.as_tensor(neg_n).to(dev)

    def step(reg_ramp: float) -> torch.Tensor:
        scene_ids, pos_idx, neg_idx = _draw_step(gen, S, scenes_per_batch, half, pos_nd, neg_nd)
        rows = scene_ids[:, None]
        samples = torch.cat([pos_d[rows, pos_idx], neg_d[rows, neg_idx]], dim=1)
        xyz, sdf_gt = samples[..., :3], samples[..., 3].clamp(-clamp, clamp)
        z = codes[scene_ids]
        inp = torch.cat([z[:, None, :].expand(-1, xyz.shape[1], -1), xyz], dim=-1)
        pred = decoder_apply(params, spec, inp)[..., 0]
        # straight-through clamp (module docstring): a hard clamp has zero
        # gradient outside the band, and Adam's normalised steps push the
        # mean prediction past it within a few steps at full width, after
        # which every gradient is 0 and the run is dead
        pred = pred + (pred.clamp(-clamp, clamp) - pred).detach()
        loss = torch.mean(torch.abs(pred - sdf_gt))
        if code_reg:
            loss = loss + code_reg_lambda * reg_ramp * torch.mean(torch.sum(z * z, dim=-1))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if code_bound is not None:
            with torch.no_grad():
                norm = torch.linalg.norm(codes, dim=-1, keepdim=True)
                codes.mul_(torch.clamp(float(code_bound) / norm.clamp_min(1e-12), max=1.0))
        return loss.detach()

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
        e, losses = _load_train_state(experiment_directory, params, codes, opt, gen)
        log(f"resumed at epoch {e}/{num_epochs} from "
            f"{_train_state_path(experiment_directory)}")
    epochs_per_call = max(1, min(int(epochs_per_call), num_epochs))
    t0 = time.time()
    t_first = None  # end of the first chunk: first launches + one chunk of work
    e_start = e     # resume offset: only num_epochs - e_start epochs run
    first_chunk_n = 0

    def snapshot():
        save_native_checkpoint(experiment_directory, checkpoint, params, spec,
                               latent_codes=codes)
        _save_train_state(experiment_directory, params, codes, opt, gen, e, losses)

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

    path = None
    if save:
        path = save_native_checkpoint(experiment_directory, checkpoint, params, spec,
                                      latent_codes=codes)
        if snapshot_every:
            # keep the training state current, so a later resume with a
            # larger num_epochs extends this run
            _save_train_state(experiment_directory, params, codes, opt, gen, e, losses)
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
