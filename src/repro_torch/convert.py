"""Weights and caches carried across from the JAX reference's layout.

This is the one module of the port that knows the reference's pytree key
names (``group0/e0/mixer/wq|embed,qheads`` ...).  Arrays cross as numpy,
or as tensors where a checkpoint carries them:

  * ``params_from_jax(np_params, cfg)`` takes the reference's params
    pytree with numpy leaves (each layer leaf with its leading layers
    axis) and returns the port's parameter dict;
  * ``params_to_numpy(params, cfg)`` is its inverse: the port's parameters
    (or a gradient tree of the same layout) in the reference's pytree, as
    float32 numpy arrays, so tests can compare trained parameters and
    gradients leaf by leaf;
  * ``params_to_tree(params)`` / ``params_from_tree(tree, device)`` carry
    the port's parameters to the reference's pytree and back with every
    leaf's dtype kept (bfloat16 or float32 alike): the layout that
    ``repro-ckpt-v1`` checkpoints hold (``serve.handoff``);
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


_EMBED = pname("embed", "vocab", "embed")
_SCALE = pname("scale", "embed")
_HEAD = pname("head", "embed", "vocab")


def _from_layout(tree: dict, leaf, head: bool) -> dict:
    """The port's parameter dict from a tree in the reference's layout,
    each leaf through ``leaf``."""
    layer = tree["group0"]["e0"]
    params = {
        "embed": leaf(tree[_EMBED]),
        "final_norm": leaf(tree["final_norm"][_SCALE]),
        "layers": {
            name: leaf(layer[sub][key])
            for name, (sub, key) in _LAYER_KEYS.items()
            if key in layer[sub]
        },
    }
    if head:
        params["head"] = leaf(tree[_HEAD])
    return params


def _to_layout(params: dict, leaf, head: bool) -> dict:
    """The port's parameters in the reference's pytree, each leaf through
    ``leaf``."""
    layer: dict = {}
    for name, t in params["layers"].items():
        sub, key = _LAYER_KEYS[name]
        layer.setdefault(sub, {})[key] = leaf(t)
    out = {
        _EMBED: leaf(params["embed"]),
        "final_norm": {_SCALE: leaf(params["final_norm"])},
        "group0": {"e0": layer},
    }
    if head:
        out[_HEAD] = leaf(params["head"])
    return out


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    # a copy through float32: numpy has no bfloat16, bf16 -> f32 -> bf16 is
    # exact, and the port never shares memory with the caller's arrays
    return torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                        dtype=dtype)


def params_from_jax(np_params: dict, cfg, device=DEFAULT_DEVICE) -> dict:
    """The port's parameters from the reference's (numpy leaves), on
    ``device`` (the card unless the caller asks for the CPU), cast to
    ``cfg.pdtype``."""
    check_supported(cfg)
    device = resolve_device(device)
    return _from_layout(np_params,
                        lambda a: _tensor(a, cfg.pdtype, device),
                        head=not cfg.tie_embeddings)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def params_to_numpy(params: dict, cfg) -> dict:
    """The port's parameters in the reference's pytree (float32 numpy)."""
    check_supported(cfg)
    return _to_layout(params, _numpy, head=not cfg.tie_embeddings)


def params_to_tree(params: dict) -> dict:
    """The port's parameters in the reference's pytree, each leaf the
    port's own tensor (detached; its device and dtype kept), as a
    checkpoint stores them."""
    return _to_layout(params, torch.Tensor.detach, head="head" in params)


def params_from_tree(tree: dict, device=DEFAULT_DEVICE) -> dict:
    """Inverse of ``params_to_tree``: a tree of tensors in the reference's
    layout (as ``load_checkpoint`` returns it) as the port's parameters on
    ``device``, each leaf in its own dtype (never cast to a config's)."""
    device = resolve_device(device)
    return _from_layout(tree, lambda t: t.to(device), head=_HEAD in tree)


def cache_to_numpy(cache: dict) -> dict:
    """The cache in the reference's layout, as float32 numpy arrays."""
    return {"group0": {"e0": {"attn": {
        name: _numpy(cache[name]) for name in ("k", "v")
    }}}}
