"""Shared inputs of the `test_torch_*.py` files: decoders made from a seed
with numpy and handed to both packages, so the JAX package and the PyTorch
port see identical weights."""

from __future__ import annotations

import os

import numpy as np

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "assets")


def random_decoder_np(spec, seed: int, scale: float = 1.0):
    """He-style random weights for `spec` (any DecoderSpec with
    `layer_dims`), as the JAX package's nested numpy dict."""
    rng = np.random.default_rng(seed)
    params = {}
    for l, (fan_in, fan_out) in enumerate(spec.layer_dims()):
        w = rng.normal(size=(fan_in, fan_out)) * np.sqrt(2.0 / fan_in) * scale
        b = rng.normal(size=fan_out) * 0.01
        params[f"lin{l}"] = {"w": w.astype(np.float32), "b": b.astype(np.float32)}
    return params


def load_npz_params(name: str):
    """(nested numpy params, spec fields, latent table, synthetic base radius)
    of an asset decoder."""
    with np.load(os.path.join(ASSETS, name, "native", "latest.npz")) as z:
        params = {}
        l = 0
        while f"lin{l}.w" in z:
            params[f"lin{l}"] = {"w": np.array(z[f"lin{l}.w"]), "b": np.array(z[f"lin{l}.b"])}
            l += 1
        fields = dict(
            code_length=int(z["spec.code_length"]),
            dims=tuple(int(d) for d in z["spec.dims"]),
            latent_in=tuple(int(i) for i in z["spec.latent_in"]),
            clamping_distance=float(z["spec.clamping_distance"]),
        )
        table = np.array(z["latent_codes"])
        base_radius = float(z["synthetic.base_radius"])
    return params, fields, table, base_radius


def widen_decoder_np(params, fields, width: int):
    """The same function with every hidden layer zero-padded to `width`
    units (padded units are relu(0) = 0 and feed zero weights), so a trained
    64-wide decoder becomes one the 128-multiple kernels take. Returns
    (params, fields) of the widened decoder."""
    C3 = fields["code_length"] + 3
    dims = fields["dims"]
    li = fields["latent_in"]
    n_lin = len(dims) + 1

    def out_map(l, padded):
        """Output units of layer l: real count, and the padded count."""
        full = (list(dims) + [1])[l]
        w = (list([width] * len(dims)) + [1])[l] if padded else full
        return w - C3 if (l + 1) in li else w

    new = {}
    for l in range(n_lin):
        w, b = params[f"lin{l}"]["w"], params[f"lin{l}"]["b"]
        n_out, n_out_p = out_map(l, False), out_map(l, True)
        if l == 0:
            rows = list(range(C3))
            n_in_p = C3
        else:
            h_real, h_pad = out_map(l - 1, False), out_map(l - 1, True)
            rows = list(range(h_real))
            n_in_p = h_pad
            if l in li:
                rows += [h_pad + i for i in range(C3)]
                n_in_p = h_pad + C3
        W = np.zeros((n_in_p, n_out_p), np.float32)
        W[np.asarray(rows)[:, None], np.arange(n_out)[None, :]] = w
        B = np.zeros(n_out_p, np.float32)
        B[:n_out] = b
        new[f"lin{l}"] = {"w": W, "b": B}
    return new, dict(fields, dims=(width,) * len(dims))
