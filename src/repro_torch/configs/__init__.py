"""Architecture configs the port can run.

``get_config(arch_id)`` returns the full-size config and
``get_smoke_config(arch_id)`` the reduced same-family variant the CPU
tests use.  Only ``smollm-360m`` is ported; the reference's other
architectures are listed in ROADMAP.md as still to port.
"""

from __future__ import annotations

import importlib

ARCHITECTURES = {
    "smollm-360m": "repro_torch.configs.smollm_360m",
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
