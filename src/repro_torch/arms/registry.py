"""Arm registry: every federation arm is written once and registered here.

The port's own copy of ``repro.arms.registry``.

``register`` is used as a class decorator on ``Arm`` subclasses; ``get``
returns the class so callers instantiate it with their (model, participants,
config).  The backend (``repro_torch.arms.runners.LocalRunner``) consumes
the registered class.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, TypeVar

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.arms.base import Arm

_REGISTRY: dict[str, type["Arm"]] = {}

A = TypeVar("A", bound="type[Arm]")


def register(name: str) -> Callable[[A], A]:
    """Class decorator: ``@register("decaph")`` above an ``Arm`` subclass."""

    def deco(cls: A) -> A:
        if name in _REGISTRY:
            raise ValueError(
                f"arm {name!r} already registered ({_REGISTRY[name].__qualname__})"
            )
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get(name: str) -> type["Arm"]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arm {name!r}; registered arms: {', '.join(names())}"
        ) from None


def names() -> tuple[str, ...]:
    """Registered arm names, sorted for stable CLI/CI enumeration."""
    return tuple(sorted(_REGISTRY))
