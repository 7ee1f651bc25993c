"""Synthetic multi-silo data pipeline (real datasets are access-gated).

The port's own copy of ``repro.data``: numpy only, the reference's arrays
bit for bit for the same arguments, in the port's ``Participant``.
"""

from repro_torch.data.synthetic import (
    make_gemini_like,
    make_pancreas_like,
    make_xray_like,
    make_lm_stream,
)
from repro_torch.data.partition import (
    dirichlet_partition,
    sized_partition,
    train_test_split_silos,
)

__all__ = [
    "make_gemini_like",
    "make_pancreas_like",
    "make_xray_like",
    "make_lm_stream",
    "dirichlet_partition",
    "sized_partition",
    "train_test_split_silos",
]
