"""Device resolution and the float32 matmul policy for the whole package.

Every entry point takes a ``device`` and defaults to ``"cuda"``.  A caller
that wants the CPU says so (``device="cpu"``, as the tests do); asking for
CUDA on a machine without it raises instead of quietly running on the CPU.

Importing this module pins TF32 off for matrix products and cuDNN:
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``.  TF32 keeps about three
decimal digits, and every float32 comparison against the JAX reference
(and between the decode kernel and the model's plain attention) assumes
full float32 products.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = DEFAULT_DEVICE
                   ) -> torch.device:
    """The ``torch.device`` to run on; raises if CUDA is asked for but absent."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to run "
            "on the CPU (the decode kernel then uses its plain version)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    return dev
