"""``SimRunner`` of the port against the JAX reference's ``SimRunner``.

Every arm on the same node traces — ``heterogeneous_trace(4)`` as it is,
and with hospital 3 dropping out during round 1's upload and rejoining
before round 3 — on the GEMINI-like MLP of ``_torch_gemini`` (3 rounds,
sigma = 0): every ``SimTiming`` field is exactly equal (simulated wall
clock, bytes on the wire, dropouts, recoveries, lost rounds, events,
noise top-ups), and the parameters agree within 1e-5.  Every arm takes
the ``round_robin`` leader schedule here, because DeCaPH's ``uniform``
draw is the port's own numpy draw (ROADMAP.md, Queue 3) and the
facilitator decides who uploads to whom.  DeCaPH's cases are in
``test_torch_sim_decaph.py``.
"""

import pytest
import torch

from _torch_gemini import DROPOUT, case_id, check_sim_runner, make_setup

torch.set_num_threads(1)

# every arm but decaph, whose cases are test_torch_sim_decaph.py's
CASES = [("fedprox", {}), ("fl", {}), ("fl", {"fl_local_steps": 3}),
         ("gossip", {}), ("gossip-dp", {}), ("local", {}), ("primia", {}),
         ("scaffold", {})]


@pytest.fixture(scope="module")
def setup():
    return make_setup()


@pytest.mark.parametrize("dropout", [None, DROPOUT], ids=["clean", "dropout"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_sim_runner_matches_reference(setup, case, dropout):
    check_sim_runner(setup, case, dropout)
