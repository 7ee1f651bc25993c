"""FedProx (Li et al., 2020) — FedAvg with a proximal term, as an arm.

Counterpart of ``repro.arms.fedprox``.  Each client takes
``max(2, fl_local_steps)`` local SGD steps on the regularised objective
``F_i(w) + (mu/2) ||w - w_global||^2``; the proximal term pulls local
iterates back toward the round's global model, which stabilises FedAvg
under heterogeneous (non-IID) silos.  The server size-weights the
resulting weights exactly like FedAvg: the whole arm is ``FLArm``'s cohort
step with the term added to each local gradient.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.arms.base import ArmConfig, Model, Participant
from repro_torch.arms.fl import FLArm
from repro_torch.arms.registry import register
from repro_torch.tree import tree_map


@register("fedprox")
class FedProxArm(FLArm):
    """Proximal-term FedAvg: heterogeneity-robust server-based FL."""

    def __init__(self, model: Model, participants: Sequence[Participant],
                 cfg: ArmConfig) -> None:
        super().__init__(model, participants, cfg)
        # FedProx is only distinct from FedSGD when clients take several
        # local steps; always use the weight-averaging (FedAvg) aggregation
        self.fedavg = True
        self.local_steps = max(2, cfg.fl_local_steps)
        self.mu = cfg.fedprox_mu

    def _local_steps(self) -> int:
        return self.local_steps

    def _local_step_grad(self, local, batch, mask, k, global_params):
        g = super()._local_step_grad(local, batch, mask, k, global_params)
        # grad of (mu/2)||w - w_global||^2 at the local iterate
        return tree_map(lambda gl, wl, wg: gl + self.mu * (wl - wg),
                        g, local, global_params)
