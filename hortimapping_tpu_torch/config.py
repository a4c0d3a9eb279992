"""Config system: the same YAML schema as `hortimapping_tpu.config`, loaded
into the same frozen dataclass, field for field.

Two methods change meaning in the port: `fused_resolved` and
`pallas_resolved` no longer ask which backend runs (the JAX package turned
its kernels on only on a TPU) but whether the decoder architecture is one the
hand-written kernels support. Which of kernel or plain version then runs is
decided by the device of the tensors alone (`ops/mlp_kernels.py`,
`ops/render_kernel.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import yaml


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f)


class ForceKeyErrorDict(dict):
    """A dict that raises on a missing key and reads and writes keys as
    attributes (the reference's `ForceKeyErrorDict`)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value


def _wrap(obj):
    if isinstance(obj, dict):
        return ForceKeyErrorDict({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def get_configs(path: str) -> ForceKeyErrorDict:
    """A JSON (`.json`) or YAML config as nested `ForceKeyErrorDict`s (the
    reference's `get_configs`)."""
    import json

    with open(path) as f:
        data = json.load(f) if path.endswith(".json") else yaml.safe_load(f)
    return _wrap(data)


@dataclasses.dataclass(frozen=True)
class JointOptConfig:
    """Static configuration of the joint shape+pose LM optimization (the
    `opt:` block of the YAML schema, e.g. `configs/wild_pepper.yaml`)."""

    # Sim(3) vs SE(3)
    scale_on: bool = True
    # Levenberg-Marquardt
    lm_on: bool = True
    lm_eye: bool = False
    lm_lambda_0: float = 0.1
    s_damp: float = 1e-3
    yaw_damp: float = 0.0
    rot_damp: float = 0.0
    # pose initial guess
    pose_init_rot_on: bool = True
    pose_init_scale_on: bool = True
    # reconstruction (3D SDF) term
    recon_n_pts: int = 2000
    recon_cluster_dist_m: float = 0.01
    recon_robust_th_m: float = 0.01
    # render term
    n_fg_pix: int = 200
    n_bg_pix: int = 200
    n_bg_pad: int = 20
    n_frame: int = 10
    n_sample_on_ray: int = 30
    log_sdf_occ: bool = True
    occ_cutoff_m: float = 0.01
    occlusion_on: bool = True
    render_robust_th_m: float = 0.05
    # term weights
    w_recon: float = 1.0
    w_depth: float = 5e-2
    w_mask: float = 5e-4
    w_codereg: float = 5e-4
    # convergence
    max_iter: int = 50
    epsilon_g: float = 1e-4
    epsilon_c: float = 1e-2
    epsilon_t: float = 1e-3
    epsilon_r: float = 1.0
    epsilon_s: float = 1e-3
    robust_iter: int = 5
    # adaptive trust-region damping (optim/lm.py lm_iteration_tr)
    trust_region: bool = False
    tr_lambda_min: float = 1e-6
    tr_lambda_max: float = 1e5
    tr_cost_rtol: float = 5e-3
    # two-resolution solve (optim/lm.py coarse_to_fine_joint_opt)
    coarse_to_fine: bool = False
    coarse_frame_stride: int = 2
    coarse_ray_frac: float = 0.5
    coarse_sample_frac: float = 0.5
    coarse_pts_frac: float = 0.5
    coarse_max_iter: int = 0  # 0 = inherit max_iter
    fine_max_iter: int = 0    # 0 = inherit max_iter
    coarse_s_damp: float = 0.0
    fine_frame_stride: int = 1
    fine_ray_frac: float = 1.0
    fine_sample_frac: float = 1.0
    fine_pts_frac: float = 1.0
    # rays per tile of the JAX fused kernel's coarse phase; parsed for schema
    # parity and ignored: the CUDA kernel sizes its own ray tiles
    # (render_kernel.ray_tile)
    coarse_fused_tr: int = 0
    # latent warm start (optim/warmstart.py)
    init_mode: str = "mean"
    retrieval_top_k: int = 8
    retrieval_score_pts: int = 256
    retrieval_n_scales: int = 5
    retrieval_scale_min: float = 0.85
    retrieval_scale_max: float = 1.2
    retrieval_score_bf16: bool = False
    retrieval_prior_w: float = 0.0
    multi_start: int = 1
    rescue_starts: int = 0
    rescue_cost_z: float = 3.0
    pose_polish_iters: int = 0
    # outlier gates (applied by drivers after optimization)
    outlier_scale_min: float = 0.5
    outlier_scale_max: float = 1.25
    outlier_rot_max_deg: float = 60.0
    # performance knobs of the JAX package (`opt.tpu`). jac_cap, fwd_cap
    # and fwd_bf16 select the JAX package's compacted render route, which
    # the port does not have: parsed for schema parity, and refused by
    # `check_ported` unless at their defaults (-1, -1, off)
    jac_cap: int = -1
    fwd_cap: int = -1
    fwd_bf16: bool = False
    use_pallas: Optional[bool] = None
    fused_render: Optional[bool] = None
    fused_bf16: bool = True
    fused_tr: int = 16  # parsed for schema parity and ignored, as coarse_fused_tr

    def pallas_resolved(self, spec) -> bool:
        """Decoder evaluations of the dense render path go through the
        fwd+input-grad kernel: forced by `use_pallas`, else whenever the
        architecture is kernel-supported."""
        if self.use_pallas is not None:
            return self.use_pallas
        from hortimapping_tpu_torch.ops import mlp_kernels

        return mlp_kernels.supported(spec)

    def fused_resolved(self, spec) -> bool:
        """The render term goes through the fused render kernel: forced by
        `fused_render`, else whenever the architecture is kernel-supported."""
        if self.fused_render is not None:
            return self.fused_render
        from hortimapping_tpu_torch.ops import mlp_kernels

        return mlp_kernels.supported(spec)

    @property
    def pose_dim(self) -> int:
        return 7 if self.scale_on else 6

    @property
    def n_rays(self) -> int:
        return self.n_fg_pix + self.n_bg_pix

    def check_ported(self) -> None:
        """Raise for an `init_mode` other than mean or retrieval (the JAX
        package treats every other mode as mean) and for any setting of the
        compacted render route (`jac_cap`, `fwd_cap`, `fwd_bf16`), also
        where the JAX package would ignore it on its fused route."""
        if self.init_mode not in ("mean", "retrieval"):
            raise NotImplementedError(
                f"not ported to the PyTorch package: init_mode={self.init_mode!r}"
            )
        for name, default in (("jac_cap", -1), ("fwd_cap", -1), ("fwd_bf16", False)):
            value = getattr(self, name)
            if value != default:
                raise NotImplementedError(
                    f"not ported to the PyTorch package: opt.tpu.{name}={value!r} "
                    f"(the compacted render route; leave it at {default!r})"
                )

    @classmethod
    def from_dict(cls, cfg: Dict[str, Any]) -> "JointOptConfig":
        """Build from a YAML dict (the full config or its `opt:` subtree)."""
        opt = cfg["opt"] if "opt" in cfg else cfg
        lm = opt.get("lm", {})
        pi = opt.get("pose_init", {})
        rec = opt.get("recon", {})
        ren = opt.get("render", {})
        w = opt.get("weight", {})
        cv = opt.get("converge", {})
        out = opt.get("outlier", {})
        tpu = opt.get("tpu", {})  # extension block, absent in reference YAMLs
        d = cls()
        return cls(
            scale_on=bool(opt.get("scale_on", d.scale_on)),
            lm_on=bool(lm.get("lm_on", d.lm_on)),
            lm_eye=bool(lm.get("lm_eye", d.lm_eye)),
            lm_lambda_0=float(lm.get("lm_lambda_0", d.lm_lambda_0)),
            # opt.tpu.s_damp wins over opt.lm.s_damp when both are present
            s_damp=float(tpu.get("s_damp", lm.get("s_damp", d.s_damp))),
            yaw_damp=float(tpu.get("yaw_damp", d.yaw_damp)),
            rot_damp=float(tpu.get("rot_damp", d.rot_damp)),
            pose_init_rot_on=bool(pi.get("rot_on", d.pose_init_rot_on)),
            pose_init_scale_on=bool(pi.get("scale_on", d.pose_init_scale_on)),
            recon_n_pts=int(rec.get("n_pts", d.recon_n_pts)),
            recon_cluster_dist_m=float(rec.get("cluster_dist_m", d.recon_cluster_dist_m)),
            recon_robust_th_m=float(rec.get("robust_th_m", d.recon_robust_th_m)),
            n_fg_pix=int(ren.get("n_fg_pix", d.n_fg_pix)),
            n_bg_pix=int(ren.get("n_bg_pix", d.n_bg_pix)),
            n_bg_pad=int(ren.get("n_bg_pad", d.n_bg_pad)),
            n_frame=int(ren.get("n_frame", d.n_frame)),
            n_sample_on_ray=int(ren.get("n_sample_on_ray", d.n_sample_on_ray)),
            log_sdf_occ=bool(ren.get("log_sdf_occ", d.log_sdf_occ)),
            occ_cutoff_m=float(ren.get("occ_cutoff_m", d.occ_cutoff_m)),
            occlusion_on=bool(ren.get("occlusion_on", d.occlusion_on)),
            render_robust_th_m=float(ren.get("robust_th_m", d.render_robust_th_m)),
            w_recon=float(w.get("w_recon", d.w_recon)),
            w_depth=float(w.get("w_depth", d.w_depth)),
            w_mask=float(w.get("w_mask", d.w_mask)),
            w_codereg=float(w.get("w_codereg", d.w_codereg)),
            max_iter=int(cv.get("max_iter", d.max_iter)),
            epsilon_g=float(cv.get("epsilon_g", d.epsilon_g)),
            epsilon_c=float(cv.get("epsilon_c", d.epsilon_c)),
            epsilon_t=float(cv.get("epsilon_t", d.epsilon_t)),
            epsilon_r=float(cv.get("epsilon_r", d.epsilon_r)),
            epsilon_s=float(cv.get("epsilon_s", d.epsilon_s)),
            robust_iter=int(opt.get("robust_iter", d.robust_iter)),
            trust_region=bool(tpu.get("trust_region", d.trust_region)),
            tr_lambda_min=float(tpu.get("tr_lambda_min", d.tr_lambda_min)),
            tr_lambda_max=float(tpu.get("tr_lambda_max", d.tr_lambda_max)),
            tr_cost_rtol=float(tpu.get("tr_cost_rtol", d.tr_cost_rtol)),
            coarse_to_fine=bool(tpu.get("coarse_to_fine", d.coarse_to_fine)),
            coarse_frame_stride=int(tpu.get("coarse_frame_stride", d.coarse_frame_stride)),
            coarse_ray_frac=float(tpu.get("coarse_ray_frac", d.coarse_ray_frac)),
            coarse_sample_frac=float(tpu.get("coarse_sample_frac", d.coarse_sample_frac)),
            coarse_pts_frac=float(tpu.get("coarse_pts_frac", d.coarse_pts_frac)),
            coarse_max_iter=int(tpu.get("coarse_max_iter", d.coarse_max_iter)),
            coarse_s_damp=float(tpu.get("coarse_s_damp", d.coarse_s_damp)),
            fine_max_iter=int(tpu.get("fine_max_iter", d.fine_max_iter)),
            fine_frame_stride=int(tpu.get("fine_frame_stride", d.fine_frame_stride)),
            fine_ray_frac=float(tpu.get("fine_ray_frac", d.fine_ray_frac)),
            fine_sample_frac=float(tpu.get("fine_sample_frac", d.fine_sample_frac)),
            fine_pts_frac=float(tpu.get("fine_pts_frac", d.fine_pts_frac)),
            coarse_fused_tr=int(tpu.get("coarse_fused_tr", d.coarse_fused_tr)),
            init_mode=str(tpu.get("init_mode", d.init_mode)),
            retrieval_top_k=int(tpu.get("retrieval_top_k", d.retrieval_top_k)),
            retrieval_score_pts=int(tpu.get("retrieval_score_pts", d.retrieval_score_pts)),
            retrieval_n_scales=int(tpu.get("retrieval_n_scales", d.retrieval_n_scales)),
            retrieval_scale_min=float(tpu.get("retrieval_scale_min", d.retrieval_scale_min)),
            retrieval_scale_max=float(tpu.get("retrieval_scale_max", d.retrieval_scale_max)),
            retrieval_score_bf16=bool(tpu.get("retrieval_score_bf16", d.retrieval_score_bf16)),
            retrieval_prior_w=float(tpu.get("retrieval_prior_w", d.retrieval_prior_w)),
            multi_start=int(tpu.get("multi_start", d.multi_start)),
            rescue_starts=int(tpu.get("rescue_starts", d.rescue_starts)),
            rescue_cost_z=float(tpu.get("rescue_cost_z", d.rescue_cost_z)),
            pose_polish_iters=int(tpu.get("pose_polish_iters", d.pose_polish_iters)),
            outlier_scale_min=float(out.get("scale_min", d.outlier_scale_min)),
            outlier_scale_max=float(out.get("scale_max", d.outlier_scale_max)),
            outlier_rot_max_deg=float(out.get("rot_max_deg", d.outlier_rot_max_deg)),
            jac_cap=int(tpu.get("jac_cap", d.jac_cap)),
            fwd_cap=int(tpu.get("fwd_cap", d.fwd_cap)),
            fwd_bf16=bool(tpu.get("fwd_bf16", d.fwd_bf16)),
            use_pallas=tpu.get("use_pallas", d.use_pallas),
            fused_render=tpu.get("fused_render", d.fused_render),
            fused_bf16=bool(tpu.get("fused_bf16", d.fused_bf16)),
            fused_tr=int(tpu.get("fused_tr", d.fused_tr)),
        )
