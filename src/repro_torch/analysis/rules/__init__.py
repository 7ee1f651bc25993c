"""Rule modules register themselves on import — registry-style, like
``repro_torch.arms`` and ``repro_torch.arms.backends``: adding a rule is one module
with one ``@register_rule`` class, plus its DESIGN.md §13 entry."""

from repro_torch.analysis.rules import (  # noqa: F401
    determinism,
    hashing,
    hostsync,
    locking,
    noise,
    prng,
)
