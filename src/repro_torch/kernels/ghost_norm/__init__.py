from repro_torch.kernels.ghost_norm.ops import ghost_norm, ghost_norm_blocked
from repro_torch.kernels.ghost_norm.ref import ghost_norm_ref

__all__ = ["ghost_norm", "ghost_norm_blocked", "ghost_norm_ref"]
