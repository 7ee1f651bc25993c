"""Weights and caches carried across from the JAX reference's layout.

This is the one module of the port that knows the reference's pytree key
names (``group0/e0/mixer/wq|embed,qheads`` ...).  Arrays cross as numpy:

  * ``params_from_jax(np_params, cfg)`` takes the reference's params
    pytree with numpy leaves (each layer leaf with its leading layers
    axis) and returns the port's parameter dict;
  * ``params_to_numpy(params, cfg)`` is its inverse: the port's parameters
    (or a gradient tree of the same layout) in the reference's pytree, as
    float32 numpy arrays, so tests can compare trained parameters and
    gradients leaf by leaf;
  * ``cache_to_numpy(cache)`` returns the port's cache in the reference's
    layout, ``{"group0": {"e0": {"attn": {"k", "v"}}}}`` of shape
    [n_layers, B, L, KV, hd], so tests can compare caches leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.layers import pname
from repro_torch.models.transformer import check_supported

# port layer key -> (reference sub-dict, reference key)
_LAYER_KEYS = {
    "norm1": ("norm1", pname("scale", "embed")),
    "wq": ("mixer", pname("wq", "embed", "qheads")),
    "wk": ("mixer", pname("wk", "embed", "kv_heads")),
    "wv": ("mixer", pname("wv", "embed", "kv_heads")),
    "wo": ("mixer", pname("wo", "qheads", "embed")),
    "norm2": ("norm2", pname("scale", "embed")),
    "w_gate": ("ffn", pname("w_gate", "embed", "mlp")),
    "w_up": ("ffn", pname("w_up", "embed", "mlp")),
    "w_down": ("ffn", pname("w_down", "mlp", "embed")),
}


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    # a copy through float32: numpy has no bfloat16, bf16 -> f32 -> bf16 is
    # exact, and the port never shares memory with the caller's arrays
    return torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                        dtype=dtype)


def params_from_jax(np_params: dict, cfg, device=DEFAULT_DEVICE) -> dict:
    """The port's parameters from the reference's (numpy leaves), on
    ``device`` (the card unless the caller asks for the CPU)."""
    check_supported(cfg)
    device = resolve_device(device)
    dt = cfg.pdtype
    layer = np_params["group0"]["e0"]
    params = {
        "embed": _tensor(np_params[pname("embed", "vocab", "embed")], dt,
                         device),
        "final_norm": _tensor(np_params["final_norm"][pname("scale", "embed")],
                              dt, device),
        "layers": {
            name: _tensor(layer[sub][key], dt, device)
            for name, (sub, key) in _LAYER_KEYS.items()
            if key in layer[sub]
        },
    }
    if not cfg.tie_embeddings:
        params["head"] = _tensor(np_params[pname("head", "embed", "vocab")],
                                 dt, device)
    return params


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def params_to_numpy(params: dict, cfg) -> dict:
    """The port's parameters in the reference's pytree (float32 numpy)."""
    check_supported(cfg)
    layer: dict = {}
    for name, t in params["layers"].items():
        sub, key = _LAYER_KEYS[name]
        layer.setdefault(sub, {})[key] = _numpy(t)
    out = {
        pname("embed", "vocab", "embed"): _numpy(params["embed"]),
        "final_norm": {pname("scale", "embed"): _numpy(params["final_norm"])},
        "group0": {"e0": layer},
    }
    if not cfg.tie_embeddings:
        out[pname("head", "embed", "vocab")] = _numpy(params["head"])
    return out


def cache_to_numpy(cache: dict) -> dict:
    """The cache in the reference's layout, as float32 numpy arrays."""
    return {"group0": {"e0": {"attn": {
        name: _numpy(cache[name]) for name in ("k", "v")
    }}}}
