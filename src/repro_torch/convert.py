"""Weights and caches carried across from the JAX reference's layout.

This is the one module of the port that knows the reference's pytree key
names (``group0/e0/mixer/wq|embed,qheads`` ...).  Arrays cross as numpy,
or as tensors where a checkpoint carries them:

  * ``params_from_jax(np_params, cfg)`` takes the reference's params
    pytree with numpy leaves (each layer leaf with its leading layers
    axis) and returns the port's parameter dict: flat ``layers`` where
    ``transformer.is_flat(cfg)``, the ``group{gi}/e{j}`` nesting otherwise,
    and Whisper's ``encoder`` / ``enc_final_norm`` and DeepSeek's ``mtp``
    subtree where the config has them;
  * ``params_to_numpy(params, cfg)`` is its inverse: the port's parameters
    (or a gradient tree of the same layout) in the reference's pytree, as
    float32 numpy arrays, so tests can compare trained parameters and
    gradients leaf by leaf;
  * ``params_to_tree(params)`` / ``params_from_tree(tree, cfg, device)``
    carry the port's parameters to the reference's pytree and back with
    every leaf's dtype kept (bfloat16 or float32 alike): the layout that
    ``repro-ckpt-v1`` checkpoints hold (``serve.handoff``);
  * ``cache_to_numpy(cache, cfg)`` returns the port's cache in the
    reference's layout (``transformer.cache_tree``), ``{"group0": {"e0":
    {"attn": {"k", "v"}}}}`` of shape [n_layers, B, L, KV, hd] for a flat
    attention stack, ``ssm`` states beside or instead of ``attn`` for the
    recurrent mixers, so tests can compare caches leaf by leaf;
  * ``tabular_params_from_jax(np_params, device)`` /
    ``tabular_params_to_numpy(params)`` carry the tabular models'
    parameters (``models.tabular``) across leaf for leaf, dtypes kept:
    their layout is the reference's own (dense [d_in, d_out], conv HWIO).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.layers import pname
from repro_torch.models.transformer import cache_tree, check_supported, is_flat
from repro_torch.tree import tree_map

_ATTN_KEYS = {
    "wq": pname("wq", "embed", "qheads"),
    "wk": pname("wk", "embed", "kv_heads"),
    "wv": pname("wv", "embed", "kv_heads"),
    "wo": pname("wo", "qheads", "embed"),
}
# every mixer's leaves (only attention's and MLA's ``wo`` is shared), in
# the reference's ``mixer`` dict: attention, MLA, Mamba-1, then RWKV6
_MIXER_KEYS = {
    name: ("mixer", key) for name, key in {
        **_ATTN_KEYS,
        "w_dq": pname("w_dq", "embed", "dc"),
        "q_norm_scale": pname("q_norm_scale", "dc"),
        "w_uq": pname("w_uq", "dc", "qheads"),
        "w_dkv": pname("w_dkv", "embed", "dc"),
        "kv_norm_scale": pname("kv_norm_scale", "dc"),
        "w_uk": pname("w_uk", "dc", "qheads"),
        "w_uv": pname("w_uv", "dc", "qheads"),
        "w_kr": pname("w_kr", "embed", "rope"),
        "w_in": pname("w_in", "embed", "inner"),
        "conv_w": pname("conv_w", "conv", "inner"),
        "conv_b": pname("conv_b", "inner"),
        "w_bcdt": pname("w_bcdt", "inner", "state"),
        "w_dt": pname("w_dt", "dc", "inner"),
        "dt_bias": pname("dt_bias", "inner"),
        "a_log": pname("a_log", "inner", "state"),
        "d_skip": pname("d_skip", "inner"),
        "w_out": pname("w_out", "inner", "embed"),
        "w_r": pname("w_r", "embed", "qheads"),
        "w_k": pname("w_k", "embed", "kv_heads"),
        "w_v": pname("w_v", "embed", "kv_heads"),
        "w_g": pname("w_g", "embed", "mlp"),
        "w_o": pname("w_o", "qheads", "embed"),
        "decay_w0": pname("decay_w0", "embed"),
        "decay_wa": pname("decay_wa", "embed", "dc"),
        "decay_wb": pname("decay_wb", "dc", "embed"),
        "bonus_u": pname("bonus_u", "qheads"),
        "token_mix": pname("token_mix", "embed"),
    }.items()
}
_DENSE_FFN_KEYS = {
    "w_gate": ("ffn", pname("w_gate", "embed", "mlp")),
    "w_up": ("ffn", pname("w_up", "embed", "mlp")),
    "w_down": ("ffn", pname("w_down", "mlp", "embed")),
}
# MoE layers: the router, the experts' stacked weights, shared experts
_MOE_FFN_KEYS = {
    "w_router": ("ffn", pname("w_router", "embed", "experts")),
    "w_gate": ("ffn", pname("w_gate", "experts", "embed", "expert_mlp")),
    "w_up": ("ffn", pname("w_up", "experts", "embed", "expert_mlp")),
    "w_down": ("ffn", pname("w_down", "experts", "expert_mlp", "embed")),
    "w_shared_gate": ("ffn", pname("w_shared_gate", "embed", "mlp")),
    "w_shared_up": ("ffn", pname("w_shared_up", "embed", "mlp")),
    "w_shared_down": ("ffn", pname("w_shared_down", "mlp", "embed")),
}
# Whisper's cross attention: GQA's leaves under ``cross_`` in the port
_CROSS_KEYS = {f"cross_{name}": ("cross", key)
               for name, key in _ATTN_KEYS.items()}
_ROUTER = "w_router"
# leaves the reference keeps in float32 whatever the parameter dtype
_FLOAT32 = {_ROUTER, "a_log", "d_skip", "decay_w0", "bonus_u", "token_mix"}


_EMBED = pname("embed", "vocab", "embed")
_SCALE = pname("scale", "embed")
_BIAS = pname("bias", "embed")
_HEAD = pname("head", "embed", "vocab")
_MTP_PROJ = pname("w", "embed", "embed")


def _norm_keys(name: str) -> dict:
    """A norm's port names -> (reference sub-dict, key): the scale, and
    the bias under ``layernorm`` (``name + "_bias"``)."""
    return {name: (name, _SCALE), f"{name}_bias": (name, _BIAS)}


def _keys(moe: bool) -> dict:
    """Port layer key -> (reference sub-dict, reference key), in
    ``transformer.init``'s order; the norms only where the norm has
    parameters (``ln_nonparam`` leaves the reference's norm dicts
    empty)."""
    return {**_norm_keys("norm1"), **_MIXER_KEYS, **_norm_keys("norm2"),
            **(_MOE_FFN_KEYS if moe else _DENSE_FFN_KEYS), **_CROSS_KEYS,
            **_norm_keys("norm_cross")}


def _layer_from(layer: dict, leaf) -> dict:
    """One pattern entry's port dict from its reference tree."""
    keys = _keys(_MOE_FFN_KEYS[_ROUTER][1] in layer["ffn"])
    return {name: leaf(layer[sub][key], name)
            for name, (sub, key) in keys.items()
            if key in layer.get(sub, {})}


def _layer_to(layer: dict, leaf) -> dict:
    """One pattern entry's reference tree from its port dict; without norm
    parameters the reference's empty norm dicts."""
    keys = _keys(_ROUTER in layer)
    out: dict = {"norm1": {}, "norm2": {}}
    if "cross_wq" in layer:
        out["norm_cross"] = {}
    for name, t in layer.items():
        sub, key = keys[name]
        out.setdefault(sub, {})[key] = leaf(t)
    return out


def _norm_from(tree: dict, name: str, leaf) -> dict:
    """A top-level norm's port leaves from the reference's ``tree[name]``."""
    return {port: leaf(tree[sub][key], port)
            for port, (sub, key) in _norm_keys(name).items()
            if key in tree[sub]}


def _norm_to(params: dict, name: str, leaf) -> dict:
    """The reference's dict of a top-level norm (empty without
    parameters)."""
    return {key: leaf(params[port])
            for port, (_, key) in _norm_keys(name).items() if port in params}


def _groups(tree: dict) -> list[str]:
    return [f"group{gi}" for gi in range(len(tree))
            if f"group{gi}" in tree]


def _from_layout(tree: dict, leaf, head: bool, flat: bool) -> dict:
    """The port's parameter dict from a tree in the reference's layout,
    each leaf through ``leaf(array, port name)``; ``flat``: the stack is
    one group of one spec (``transformer.is_flat``)."""
    params = {"embed": leaf(tree[_EMBED], "embed")}
    if flat:
        params["layers"] = _layer_from(tree["group0"]["e0"], leaf)
    else:
        for g in _groups(tree):
            params[g] = {e: _layer_from(layer, leaf)
                         for e, layer in tree[g].items()}
    params.update(_norm_from(tree, "final_norm", leaf))
    if head:
        params["head"] = leaf(tree[_HEAD], "head")
    if "mtp" in tree:
        mtp = tree["mtp"]
        params["mtp"] = {"proj": leaf(mtp["proj"][_MTP_PROJ], "proj"),
                         **_norm_from(mtp, "norm_h", leaf),
                         **_norm_from(mtp, "norm_e", leaf),
                         "block": _layer_from(mtp["block"], leaf)}
    if "encoder" in tree:
        params["encoder"] = {"e0": _layer_from(tree["encoder"]["e0"], leaf)}
        params.update(_norm_from(tree, "enc_final_norm", leaf))
    return params


def _to_layout(params: dict, leaf, head: bool, flat: bool) -> dict:
    """The port's parameters in the reference's pytree, each leaf through
    ``leaf``; ``flat`` as for ``_from_layout``."""
    out = {
        _EMBED: leaf(params["embed"]),
        "final_norm": _norm_to(params, "final_norm", leaf),
    }
    if flat:
        out["group0"] = {"e0": _layer_to(params["layers"], leaf)}
    else:
        for g in _groups(params):
            out[g] = {e: _layer_to(layer, leaf)
                      for e, layer in params[g].items()}
    if head:
        out[_HEAD] = leaf(params["head"])
    if "mtp" in params:
        mtp = params["mtp"]
        out["mtp"] = {"proj": {_MTP_PROJ: leaf(mtp["proj"])},
                      "norm_h": _norm_to(mtp, "norm_h", leaf),
                      "norm_e": _norm_to(mtp, "norm_e", leaf),
                      "block": _layer_to(mtp["block"], leaf)}
    if "encoder" in params:
        out["encoder"] = {"e0": _layer_to(params["encoder"]["e0"], leaf)}
        out["enc_final_norm"] = _norm_to(params, "enc_final_norm", leaf)
    return out


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    # a copy through float32: numpy has no bfloat16, bf16 -> f32 -> bf16 is
    # exact, and the port never shares memory with the caller's arrays
    return torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                        dtype=dtype)


def params_from_jax(np_params: dict, cfg, device=DEFAULT_DEVICE) -> dict:
    """The port's parameters from the reference's (numpy leaves), on
    ``device`` (the card unless the caller asks for the CPU), cast to
    ``cfg.pdtype`` (a MoE router and the recurrent mixers' float32 leaves
    stay float32, as the reference keeps them)."""
    check_supported(cfg)
    device = resolve_device(device)
    return _from_layout(
        np_params,
        lambda a, name: _tensor(a, torch.float32 if name in _FLOAT32
                                else cfg.pdtype, device),
        head=not cfg.tie_embeddings, flat=is_flat(cfg))


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def params_to_numpy(params: dict, cfg) -> dict:
    """The port's parameters in the reference's pytree (float32 numpy)."""
    check_supported(cfg)
    return _to_layout(params, _numpy, head=not cfg.tie_embeddings,
                      flat=is_flat(cfg))


def params_to_tree(params: dict) -> dict:
    """The port's parameters in the reference's pytree, each leaf the
    port's own tensor (detached; its device and dtype kept), as a
    checkpoint stores them.  A publisher holds no config, so the layout is
    the one the dict has: flat where it holds ``layers``."""
    return _to_layout(params, torch.Tensor.detach, head="head" in params,
                      flat="layers" in params)


def params_from_tree(tree: dict, cfg, device=DEFAULT_DEVICE) -> dict:
    """Inverse of ``params_to_tree``: a tree of tensors in the reference's
    layout (as ``load_checkpoint`` returns it) as ``cfg``'s parameters on
    ``device``, each leaf in its own dtype (never cast to a config's)."""
    device = resolve_device(device)
    return _from_layout(tree, lambda t, _: t.to(device), head=_HEAD in tree,
                        flat=is_flat(cfg))


def cache_to_numpy(cache: dict, cfg) -> dict:
    """``cfg``'s cache in the reference's layout, as float32 numpy
    arrays."""
    return tree_map(_numpy, cache_tree(cfg, cache))


def tabular_params_from_jax(np_params: dict, device=DEFAULT_DEVICE) -> dict:
    """A tabular model's parameters from the reference's tree (numpy
    leaves), leaf for leaf with each dtype kept, on ``device`` (the card
    unless the caller asks for the CPU)."""
    device = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device),
                    np_params)


def tabular_params_to_numpy(params: dict) -> dict:
    """Inverse of ``tabular_params_from_jax``: numpy leaves, dtypes kept."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
