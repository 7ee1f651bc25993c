"""Architecture configs the port can run.

``get_config(arch_id)`` returns the full-size config and
``get_smoke_config(arch_id)`` the reduced same-family variant the CPU
tests use.  Every architecture of the reference's zoo is ported: the GQA
decoders, ``rwkv6-3b`` (attention-free), ``jamba-v0.1-52b`` (Mamba and
attention interleaved, MoE every other layer), ``deepseek-v3-671b`` (MLA,
3 dense layers then 58 MoE) and ``whisper-small`` (encoder-decoder).  An
unknown id raises.  ``INPUT_SHAPES`` names the reference's four input
shapes (``configs.shapes`` turns them into meta-tensor specs).
"""

from __future__ import annotations

import importlib

ARCHITECTURES = {
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "whisper-small": "repro_torch.configs.whisper_small",
}

INPUT_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def _module(arch_id: str):
    try:
        return importlib.import_module(ARCHITECTURES[arch_id])
    except KeyError:
        raise ValueError(
            f"unknown arch {arch_id!r} (repro_torch has: "
            f"{', '.join(ARCHITECTURES)})"
        ) from None


def get_config(arch_id: str):
    return _module(arch_id).config()


def get_smoke_config(arch_id: str):
    return _module(arch_id).smoke_config()


def list_archs() -> list[str]:
    return list(ARCHITECTURES)
