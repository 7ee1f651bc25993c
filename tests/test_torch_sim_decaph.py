"""DeCaPH on the port's ``SimRunner`` against the reference's.

The cases of ``test_torch_sim_runner.py`` for the paper's own arm, with
and without SecAgg, on the clean trace and on the one where hospital 3
drops out during round 1's upload: every ``SimTiming`` field equal, the
parameters within 1e-5 at sigma = 0.  With the dropout, the lost noise
share is topped up (one top-up) and, with SecAgg, the dropped hospital's
pads are recovered from the survivors' Shamir shares (one recovery).
"""

import pytest
import torch

from _torch_gemini import DROPOUT, case_id, check_sim_runner, make_setup

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    return make_setup()


@pytest.mark.parametrize("dropout", [None, DROPOUT], ids=["clean", "dropout"])
@pytest.mark.parametrize("case", [("decaph", {}),
                                  ("decaph", {"use_secagg": True})],
                         ids=case_id)
def test_decaph_sim_runner_matches_reference(setup, case, dropout):
    ours = check_sim_runner(setup, case, dropout)
    if dropout is not None:
        assert ours.timing.noise_topups == 1
        assert ours.timing.recoveries == int(case[1].get("use_secagg", False))
