"""Optimizers over the port's parameter trees (no torch.optim state)."""

from repro_torch.optim.optimizers import (
    AdafactorState,
    AdamState,
    Optimizer,
    adafactor,
    adamw,
    get_optimizer,
    momentum,
    sgd,
)

__all__ = ["AdafactorState", "AdamState", "Optimizer", "adafactor", "adamw",
           "get_optimizer", "momentum", "sgd"]
