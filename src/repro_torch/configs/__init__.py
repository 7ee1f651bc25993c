"""Architecture configs the port can run.

``get_config(arch_id)`` returns the full-size config and
``get_smoke_config(arch_id)`` the reduced same-family variant the CPU
tests use.  The ported ids are the reference's decoder-only stacks of GQA
attention, Mamba-1 and RWKV6 mixers with dense or MoE FFNs: the GQA
decoders, ``rwkv6-3b`` (attention-free) and ``jamba-v0.1-52b`` (Mamba and
attention interleaved, MoE every other layer).  The reference's other
architectures (DeepSeek-V3's MLA, Whisper's encoder-decoder) are listed
in ROADMAP.md as still to port, and asking for one raises.
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
}


def _module(arch_id: str):
    try:
        return importlib.import_module(ARCHITECTURES[arch_id])
    except KeyError:
        raise ValueError(
            f"arch {arch_id!r} is not ported to repro_torch yet (ported: "
            f"{', '.join(ARCHITECTURES)}); see ROADMAP.md for the queue"
        ) from None


def get_config(arch_id: str):
    return _module(arch_id).config()


def get_smoke_config(arch_id: str):
    return _module(arch_id).smoke_config()


def list_archs() -> list[str]:
    return list(ARCHITECTURES)
