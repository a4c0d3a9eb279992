"""The port stands alone: no file of `hortimapping_tpu_torch/` imports JAX,
the JAX package, optax, Orbax, OpenCV, PIL or click, nor wandb at module
level (it is optional: the W&B summary imports it where it logs), importing
it loads none of them, and its entry points refuse to run on a missing card
unless asked for the CPU."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "hortimapping_tpu_torch")

# `hortimapping_tpu` as a whole word: the port's own name starts with it
JAX_PKG = re.compile(r"\bhortimapping_tpu\b(?!_torch)")
JAX_IMPORT = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
# the card's machine has none of these
HOST_ONLY_IMPORT = re.compile(r"^\s*(import|from)\s+(cv2|PIL|click|optax|orbax)\b", re.M)
# optional everywhere: never imported when a module is
MODULE_LEVEL_WANDB = re.compile(r"^(import|from)\s+wandb\b", re.M)


def _sources():
    for dirpath, _, files in os.walk(PKG):
        if "_build" in dirpath:
            continue
        for fn in files:
            if fn.endswith((".py", ".cu", ".cuh", ".cpp")):
                yield os.path.join(dirpath, fn)


def test_sources_do_not_import_jax_or_the_jax_package():
    files = list(_sources())
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            text = f.read()
        assert not JAX_IMPORT.search(text), path
        assert not HOST_ONLY_IMPORT.search(text), path
        assert not MODULE_LEVEL_WANDB.search(text), path
        for line in text.splitlines():
            if "import" in line:
                assert not JAX_PKG.search(line), f"{path}: {line}"


def test_name_pattern_tells_the_packages_apart():
    assert HOST_ONLY_IMPORT.search("import optax") and HOST_ONLY_IMPORT.search(
        "    import orbax.checkpoint as ocp")
    assert JAX_PKG.search("from hortimapping_tpu.ops import lie")
    assert JAX_PKG.search("import hortimapping_tpu")
    assert not JAX_PKG.search("from hortimapping_tpu_torch.ops import lie")


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import hortimapping_tpu_torch.optim.warmstart, hortimapping_tpu_torch.optim.lm\n"
        "import hortimapping_tpu_torch.ops.mesher, hortimapping_tpu_torch.ops.render_kernel\n"
        "import hortimapping_tpu_torch.metrics.chamfer, hortimapping_tpu_torch.tools.synthetic\n"
        "import hortimapping_tpu_torch.pipeline.wild, hortimapping_tpu_torch.tools.make_demo_data\n"
        "import hortimapping_tpu_torch.data.imageio, hortimapping_tpu_torch.utils.misc\n"
        "import hortimapping_tpu_torch.pipeline.challenge, hortimapping_tpu_torch.pipeline.lab\n"
        "import hortimapping_tpu_torch.data.rgbd, hortimapping_tpu_torch.data.challenge\n"
        "import hortimapping_tpu_torch.metrics.precision_recall\n"
        "import hortimapping_tpu_torch.pipeline.greenhouse, hortimapping_tpu_torch.serve\n"
        "import hortimapping_tpu_torch.train.deepsdf, hortimapping_tpu_torch.tools.make_assets\n"
        "import hortimapping_tpu_torch.data.kitti, hortimapping_tpu_torch.parallel\n"
        "import hortimapping_tpu_torch.tools.multihost_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'hortimapping_tpu', 'cv2', 'PIL', 'click', 'wandb', 'optax', 'orbax')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from hortimapping_tpu_torch import resolve_device
    from hortimapping_tpu_torch.models.workspace import config_decoder, load_latent_vectors
    from hortimapping_tpu_torch.ops.mesher import MeshExtractor
    from hortimapping_tpu_torch.optim.lm import (
        coarse_to_fine_joint_opt,
        shape_pose_joint_opt_batched,
        solve_in_chunks,
        staged_joint_opt,
    )
    from hortimapping_tpu_torch.optim.warmstart import (
        maybe_retrieval_init,
        retrieval_joint_opt,
        warmstart_solve,
    )

    assets = os.path.join(ROOT, "assets", "synthetic_small_8")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        config_decoder(assets)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_latent_vectors(assets)
    params, spec = config_decoder(assets, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        MeshExtractor(params, spec, voxels_dim=8)
    for fn in (retrieval_joint_opt, coarse_to_fine_joint_opt, shape_pose_joint_opt_batched,
               solve_in_chunks, staged_joint_opt):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(params, spec, None, None, None, None, 0.08)
    with pytest.raises(RuntimeError, match="CUDA"):
        warmstart_solve(params, spec, None, None, None, None, None, 0.08)
    with pytest.raises(RuntimeError, match="CUDA"):
        maybe_retrieval_init(params, spec, None, None, None, None, None)
    from hortimapping_tpu_torch.pipeline import wild
    from hortimapping_tpu_torch.tools import make_demo_data

    with pytest.raises(RuntimeError, match="CUDA"):
        wild.run_wild_completion({})
    with pytest.raises(RuntimeError, match="CUDA"):
        wild.main(["-c", os.path.join(ROOT, "configs", "wild_pepper_tpu.yaml")])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_demo_data.render_frame(np.eye(4), np.eye(3), 4, 4, [], 0.55)

    from hortimapping_tpu_torch.metrics.chamfer import ChamferDistance
    from hortimapping_tpu_torch.metrics.precision_recall import PrecisionRecall
    from hortimapping_tpu_torch.optim.lm import shape_opt_deepsdf, shape_opt_deepsdf_batched
    from hortimapping_tpu_torch.pipeline import challenge, lab

    for fn in (shape_opt_deepsdf, shape_opt_deepsdf_batched):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(params, spec, None, None, None, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        ChamferDistance()
    with pytest.raises(RuntimeError, match="CUDA"):
        PrecisionRecall(0.001, 0.01, 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        challenge.run_challenge({})
    with pytest.raises(RuntimeError, match="CUDA"):
        challenge.main(["-c", os.path.join(ROOT, "configs",
                                           "shape_completion_challenge_pepper_tpu.yaml")])
    for multi in (True, False):
        with pytest.raises(RuntimeError, match="CUDA"):
            lab.run_lab_eval({}, multi)
    with pytest.raises(RuntimeError, match="CUDA"):
        lab.main(["-c", os.path.join(ROOT, "configs", "lab_pepper_tpu.yaml"), "--multi_frame"])
    from hortimapping_tpu_torch.config import JointOptConfig
    from hortimapping_tpu_torch.optim.lm import (
        joint_opt_packed,
        shape_pose_joint_opt,
        shape_pose_joint_opt_traced,
    )
    from hortimapping_tpu_torch.pipeline import greenhouse
    from hortimapping_tpu_torch.serve import CompletionServer

    for fn in (shape_pose_joint_opt, shape_pose_joint_opt_traced, joint_opt_packed):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(params, spec, JointOptConfig(), [], np.zeros(8), np.eye(4), 0.08)
    with pytest.raises(RuntimeError, match="CUDA"):
        CompletionServer(params, spec, JointOptConfig(), 0.08)
    from hortimapping_tpu_torch.models.workspace import load_distributed_checkpoint
    from hortimapping_tpu_torch.parallel import fruit_mesh, shard_joint_opt
    from hortimapping_tpu_torch.tools import multihost_smoke

    with pytest.raises(RuntimeError, match="CUDA"):
        fruit_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        shard_joint_opt(params, spec, JointOptConfig(), [], np.zeros(8), np.eye(4), 0.08,
                        fruit_mesh(devices=["cpu"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        CompletionServer(params, spec, JointOptConfig(), 0.08, use_mesh=True, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        wild.run_wild_completion({}, mesh=fruit_mesh(devices=["cpu"] * 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_distributed_checkpoint(str(tmp_path / "dcp"))
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost_smoke.worker(0, 0, "cuda")
    for multi in (True, False):
        with pytest.raises(RuntimeError, match="CUDA"):
            greenhouse.run_greenhouse_eval({}, multi)
    with pytest.raises(RuntimeError, match="CUDA"):
        greenhouse.main(["-c", os.path.join(ROOT, "configs", "cka_pepper_tpu.yaml"), "--multi"])
    for gen in (make_demo_data.make_challenge_dataset, make_demo_data.make_lab_dataset,
                make_demo_data.make_greenhouse_dataset):
        with pytest.raises(RuntimeError, match="CUDA"):
            gen(str(tmp_path / gen.__name__), assets, n_fruits=1, n_frames=1)
        assert not os.path.exists(tmp_path / gen.__name__)   # refused before writing
    assert resolve_device("cpu") == torch.device("cpu")


def test_training_entry_points_raise_without_a_card(tmp_path):
    """The trainer, the asset tool and the `.pth` load refuse a missing
    card before they read or write anything, unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from hortimapping_tpu_torch.models.decoder import DecoderSpec, init_decoder_params
    from hortimapping_tpu_torch.models.workspace import config_decoder, convert_torch_checkpoint
    from hortimapping_tpu_torch.tools import make_assets, synthetic
    from hortimapping_tpu_torch.train import deepsdf

    exp = tmp_path / "exp"
    (exp / "ModelParameters").mkdir(parents=True)
    (exp / "specs.json").write_text('{"CodeLength": 4, "NetworkSpecs": {"dims": [8, 8]}}')
    torch.save({"lin0.weight": torch.zeros(8, 7)}, exp / "ModelParameters" / "latest.pth")
    with pytest.raises(RuntimeError, match="CUDA"):
        config_decoder(str(exp))
    assert not (exp / "native").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        convert_torch_checkpoint(str(exp / "ModelParameters" / "latest.pth"), DecoderSpec())
    with pytest.raises(RuntimeError, match="CUDA"):
        deepsdf.train_deepsdf(str(exp))
    with pytest.raises(RuntimeError, match="CUDA"):
        deepsdf.main(["-e", str(exp)])
    assert not (exp / "native").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_assets.make_category("synthetic_small_8", str(tmp_path / "assets"))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_assets.main(["--out", str(tmp_path / "assets")])
    assert not (tmp_path / "assets").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic.train_synthetic_decoder(synthetic.SyntheticCategory(DecoderSpec()), steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_decoder_params(DecoderSpec(), torch.Generator())
