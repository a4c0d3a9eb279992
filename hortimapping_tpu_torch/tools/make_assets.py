"""Build the synthetic decoder categories (counterpart of
`hortimapping_tpu/tools/make_assets.py`).

Each category is a decoder trained on the analytic ellipsoid family
(`tools/synthetic.train_synthetic_decoder`), written as a DeepSDF experiment
directory (`specs.json` + `native/latest.npz`) that `workspace.config_decoder`
loads like any checkpoint. The `.npz` also holds the ellipsoid projection
and base radius (the ground-truth generator) and a table of 256 sample codes
~ N(0, 0.5^2), whose mean is the init code.

Run:  python -m hortimapping_tpu_torch.tools.make_assets --out DIR
      [--only NAME] [--device cpu]
`--out` is required: the repository's `assets/` holds the shipped decoders,
which this tool never overwrites unless pointed there.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np

from hortimapping_tpu_torch.device import resolve_device
from hortimapping_tpu_torch.models.decoder import DecoderSpec
from hortimapping_tpu_torch.models.workspace import save_native_checkpoint
from hortimapping_tpu_torch.tools.synthetic import SyntheticCategory, train_synthetic_decoder

CATEGORIES = {
    "synthetic_small_8": dict(
        spec=DecoderSpec(code_length=8, dims=(64,) * 4, latent_in=(2,), clamping_distance=0.1),
        base_radius=0.05,
        steps=8000,
        batch=4096,
        lr=1e-3,
    ),
    "synthetic_pepper_32": dict(
        spec=DecoderSpec(code_length=32, dims=(512,) * 8, latent_in=(4,), clamping_distance=0.1),
        base_radius=0.06,
        steps=12000,
        batch=8192,
        lr=3e-4,
    ),
    # the strawberry twin: ClampingDistance 0.05, smaller fruit
    "synthetic_berry_32": dict(
        spec=DecoderSpec(code_length=32, dims=(512,) * 8, latent_in=(4,), clamping_distance=0.05),
        base_radius=0.03,
        steps=12000,
        batch=8192,
        lr=3e-4,
    ),
}


def make_category(name: str, out_root: str, seed: int = 0, device="cuda",
                  steps: Optional[int] = None) -> str:
    """Train category `name` and write it to `<out_root>/<name>`; `steps`
    overrides the category's step count (a shortened build)."""
    dev = resolve_device(device)
    cfg = CATEGORIES[name]
    spec: DecoderSpec = cfg["spec"]
    cat = SyntheticCategory(spec=spec, base_radius=cfg["base_radius"])
    t0 = time.time()
    params, proj = train_synthetic_decoder(
        cat, seed, steps=cfg["steps"] if steps is None else steps, batch=cfg["batch"],
        lr=cfg["lr"], device=dev)
    print(f"[{name}] trained in {time.time() - t0:.1f}s")

    out_dir = os.path.join(out_root, name)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "specs.json"), "w") as f:
        json.dump(
            {
                "Description": f"Synthetic ellipsoid category {name} (analytic GT)",
                "NetworkArch": "deep_sdf_decoder",
                "CodeLength": spec.code_length,
                "ClampingDistance": spec.clamping_distance,
                "NetworkSpecs": {
                    "dims": list(spec.dims),
                    "latent_in": list(spec.latent_in),
                    "weight_norm": True,
                },
                "synthetic": {"base_radius": cat.base_radius, "proj_scale": cat.proj_scale},
            },
            f,
            indent=2,
        )
    rng = np.random.default_rng(seed)
    codes = (rng.normal(size=(256, spec.code_length)) * 0.5).astype(np.float32)
    path = save_native_checkpoint(out_dir, "latest", params, spec, codes)
    with np.load(path) as z:
        arrays = dict(z)
    arrays["synthetic.projection"] = proj.astype(np.float32)
    arrays["synthetic.base_radius"] = np.float64(cat.base_radius)
    np.savez(path, **arrays)
    print(f"[{name}] saved to {out_dir}")
    return out_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="root directory of the categories (one subdirectory each)")
    ap.add_argument("--only", default=None, help="category name to (re)build")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    for name in CATEGORIES:
        if args.only and name != args.only:
            continue
        make_category(name, args.out, device=dev)


if __name__ == "__main__":
    main()
