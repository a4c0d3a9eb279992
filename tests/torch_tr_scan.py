"""Trust-region agreement of the port with the JAX package over many scenes.

The solves of `test_torch_solver.py` at its CPU size, from the first SEEDS
seeds x 4 fruits (lambda_0 0.1, robust_iter 1, 8 iterations): per lane,
whether `iter_count`, `failed` and `converged` agree, and the gap of the
final LM objective (port minus JAX) as a share of the starting objective.
`test_trust_region_final_objective_matches_jax` takes its tolerances from
this scan.

    JAX_PLATFORMS=cpu python tests/torch_tr_scan.py [SEEDS]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_solver as ts  # noqa: E402
from hortimapping_tpu.models.decoder import DecoderSpec as JSpec  # noqa: E402
from hortimapping_tpu.optim import lm as jlm  # noqa: E402
from hortimapping_tpu.optim import warmstart as jws  # noqa: E402
from hortimapping_tpu_torch.models.decoder import DecoderSpec as TSpec  # noqa: E402
from hortimapping_tpu_torch.models.workspace import params_from_jax  # noqa: E402
from hortimapping_tpu_torch.optim import lm as tlm  # noqa: E402
from hortimapping_tpu_torch.optim import warmstart as tws  # noqa: E402
from torch_port_common import load_npz_params, widen_decoder_np  # noqa: E402


def main(n_seeds: int) -> None:
    params_np, fields, table, base_radius = load_npz_params("synthetic_small_8")
    params_np, fields = widen_decoder_np(params_np, fields, 128)
    small = dict(jp=jax.tree_util.tree_map(jnp.asarray, params_np), jspec=JSpec(**fields),
                 tp=params_from_jax(params_np, "cpu"), tspec=TSpec(**fields), table=table,
                 base_radius=base_radius)
    jc, tc = ts._cfgs(trust_region=True, lm_lambda_0=0.1, robust_iter=1, max_iter=8)
    gaps, same = [], 0
    for seed in range(n_seeds):
        jobs, tobs, T0, lat0 = ts._batch(small, seed, 4)
        want = jlm.shape_pose_joint_opt_batched(small["jp"], small["jspec"], jc, jobs,
                                                jnp.asarray(lat0), jnp.asarray(T0), ts.CUBE_RADIUS)
        got = tlm.shape_pose_joint_opt_batched(small["tp"], small["tspec"], tc, tobs,
                                               *ts._t(lat0, T0), ts.CUBE_RADIUS, device="cpu")
        same += int(np.sum((got.iter_count.numpy() == np.asarray(want.iter_count))
                           & (got.failed.numpy() == np.asarray(want.failed))
                           & (got.converged.numpy() == np.asarray(want.converged))))
        f0 = tws.objective_value_batched(small["tp"], small["tspec"], tc, tobs, *ts._t(lat0, T0),
                                         ts.CUBE_RADIUS, device="cpu").numpy()
        f_t = tws.objective_value_batched(small["tp"], small["tspec"], tc, tobs, got.latent,
                                          got.T_ow, ts.CUBE_RADIUS, device="cpu").numpy()
        f_j = np.asarray(jws.objective_value_batched(small["jp"], small["jspec"], jc, jobs,
                                                     want.latent, want.T_ow, ts.CUBE_RADIUS))
        gaps.extend(((f_t - f_j) / f0).tolist())
    g = np.asarray(gaps)
    print(f"{len(g)} lanes of {n_seeds} seeds: iter_count, failed and converged equal on {same}; "
          f"final objective gap / starting objective: worst |gap| {np.abs(g).max():.4f}, mean "
          f"{g.mean():+.5f}, port lower on {(g < -1e-5).sum()} lanes, higher on {(g > 1e-5).sum()}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 40)
