"""Input specs for every (architecture x input shape), as meta tensors.

Counterpart of ``repro.configs.shapes``.  ``input_specs(cfg, shape_name)``
returns ``(cfg', specs, kind)`` where cfg' carries any shape-specific
overrides (the sliding-window variant dense archs use at long_500k) and
``specs`` holds tensors on ``torch.device("meta")`` — the counterpart of
``jax.ShapeDtypeStruct``: each has the input's shape and dtype and no
storage, so nothing is allocated at any size.  A decode spec's cache is
``transformer.init_cache`` on the meta device, in the port's layout (flat
``{"k", "v"}`` with a layers axis, or the ``group{gi}/e{j}`` nesting with
Whisper's ``cross`` caches; ``transformer.cache_tree`` gives the
reference's).
"""

from __future__ import annotations

import torch

from repro_torch.configs import INPUT_SHAPES

META = torch.device("meta")


class ShapeSkip(Exception):
    """Raised when an (arch, shape) pair is skipped (recorded in DESIGN.md)."""


def apply_shape_overrides(cfg, shape_name: str):
    if shape_name == "long_500k":
        if cfg.long_context_mode == "skip":
            raise ShapeSkip(
                f"{cfg.name}: long_500k skipped ({cfg.arch_type}; see DESIGN.md)"
            )
        if cfg.long_context_mode == "window":
            cfg = cfg.replace(sliding_window=cfg.long_context_window or 8192)
    # decode of an encoder-decoder: the decoder's self-KV spans seq_len, the
    # cross-KV is fixed at n_audio_ctx
    return cfg


def _spec(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_specs(cfg, shape_name: str) -> dict:
    shape = INPUT_SHAPES[shape_name]
    b, s = shape["global_batch"], shape["seq_len"]
    if cfg.arch_type == "vlm":
        sv = int(s * cfg.vision_prefix_frac)
        st = s - sv
        return {
            "tokens": _spec((b, st), torch.int32),
            "labels": _spec((b, st), torch.int32),
            "vision_embeds": _spec((b, sv, cfg.d_model), cfg.cdtype),
            "mrope_positions": _spec((b, s, 3), torch.int32),
        }
    if cfg.arch_type == "audio":
        return {
            "tokens": _spec((b, s), torch.int32),
            "labels": _spec((b, s), torch.int32),
            "frames": _spec((b, cfg.n_audio_ctx, cfg.d_model), cfg.cdtype),
        }
    return {
        "tokens": _spec((b, s), torch.int32),
        "labels": _spec((b, s), torch.int32),
    }


def prefill_specs(cfg, shape_name: str) -> dict:
    specs = train_specs(cfg, shape_name)
    specs.pop("labels", None)
    return specs


def decode_specs(cfg, shape_name: str) -> dict:
    from repro_torch.models import transformer

    shape = INPUT_SHAPES[shape_name]
    b, s = shape["global_batch"], shape["seq_len"]
    return {
        "tokens": _spec((b, 1), torch.int32),
        "cache": transformer.init_cache(cfg, b, s, META),
        "index": _spec((), torch.int32),
    }


def input_specs(cfg, shape_name: str):
    """-> (cfg_with_overrides, specs_dict, kind in {train, prefill, decode})."""
    cfg = apply_shape_overrides(cfg, shape_name)
    kind = INPUT_SHAPES[shape_name]["kind"]
    if kind == "train":
        return cfg, train_specs(cfg, shape_name), kind
    if kind == "prefill":
        return cfg, prefill_specs(cfg, shape_name), kind
    return cfg, decode_specs(cfg, shape_name), kind
