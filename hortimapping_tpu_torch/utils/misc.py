"""Seeding, timing and tracing helpers (counterpart of
`hortimapping_tpu/utils/misc.py`), and the optional W&B set-up and run
summary.

`set_random_seed` seeds Python's and numpy's global generators exactly as
the JAX package does, because the pipelines' ray sampling draws from numpy's
global state (`data/rays.get_render_data`), and seeds torch's as well.
"""

from __future__ import annotations

import getpass
import os
import random
import time
from typing import Dict, List

import numpy as np
import torch

from hortimapping_tpu_torch.utils import trace


def set_random_seed(seed: int) -> None:
    """Seed `random`, numpy's global generator and torch's; every entry
    point calls this with 42, as the JAX package does."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ.setdefault("PYTHONHASHSEED", str(seed))
    torch.manual_seed(seed)


def get_time() -> float:
    """Wall time with the card's queued work drained first."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.time()


class trace_if_enabled:
    """Context manager: trace the block with `torch.profiler` when the
    environment variable `HORTI_PROFILE_DIR` is set, writing a Chrome trace
    `<dir>/<label>.json` that also holds the program's spans and counters
    on the trace's clock (`utils/trace.add_to_chrome_trace`), so host spans
    and kernels share one timeline; does nothing otherwise."""

    def __init__(self, label: str = "horti"):
        self.dir = os.environ.get("HORTI_PROFILE_DIR")
        self.label = label
        self._prof = None

    def __enter__(self):
        if self.dir:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(self.dir, f"{self.label}.json")
            self._prof.export_chrome_trace(path)
            self._prof = None
            trace.add_to_chrome_trace(path)
        return False


def setup_wandb() -> None:
    """Cache the W&B API key in `<user>_wandb.key` (asked for on the first
    run) and put it in `WANDB_API_KEY`, as the reference does; with no
    `wandb` package (imported only here) a notice, and runs go on without
    remote logging."""
    try:
        import wandb  # noqa: F401
    except ImportError:
        print("wandb not installed; remote logging disabled")
        return
    key_path = getpass.getuser() + "_wandb.key"
    if not os.path.exists(key_path):
        key = input("wandb api key (from https://wandb.ai/authorize): ")
        with open(key_path, "w") as f:
            f.write(key)
    else:
        print("wandb api key loaded from", key_path)
    with open(key_path) as f:
        os.environ["WANDB_API_KEY"] = f.read().rstrip()


def wandb_log_summary(project: str, run_name: str, summary: Dict, enabled: bool) -> None:
    """One summary dict per run to Weights & Biases; a no-op when disabled
    or when the `wandb` package is missing (it is imported only here)."""
    if not enabled:
        return
    try:
        import wandb
    except ImportError:
        return
    run = wandb.init(project=project, name=run_name)
    run.summary.update(summary)
    run.finish()


def mean_or_nan(xs: List[float]) -> float:
    return float(np.mean(xs)) if xs else float("nan")
