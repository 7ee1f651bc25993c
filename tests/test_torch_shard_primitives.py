"""The model primitives the dry run places, on real DTensors.

Four ``gloo`` ranks on the CPU (``repro_torch.launch.ranks.spawn``) run
``tests/_torch_primitive_ranks.py`` once for the module; each check holds
a DTensor call against the same call on plain tensors:

  * ``attention.gqa_decode`` writes its K and V rows into a cache split by
    its batch over "data", by its KV heads over "model" or by its sequence
    over "data", bit for bit, and gives the plain output (bit for bit
    where each rank holds whole rows and heads and ``wo`` is the identity;
    within 1e-5 where a product or the softmax is summed over ranks);
  * ``moe.moe_apply`` with the tokens split over ("pod", "data") into
    fewer groups than blocks gives the plain output within 1e-5;
  * ``layers.split_dim`` inside ``torch.func.vmap`` makes an uneven head
    split (15 heads of a dim split over 2 ranks) whole before the view.

And on plain tensors (a subprocess of its own): the one-card serving
path never loads ``torch.distributed.tensor``.
"""

import json
import os
import sys

import pytest

from repro_torch.launch.ranks import spawn

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    init = str(tmp_path_factory.mktemp("ranks") / "init")
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = spawn([sys.executable,
                   os.path.join(HERE, "_torch_primitive_ranks.py")],
                  4, init, timeout=300, env=env)
    for p in procs:
        assert p.returncode == 0, p.stderr[-3000:]
    line = [ln for ln in procs[0].stdout.splitlines()
            if ln.startswith("RESULT::")][0]
    return json.loads(line[len("RESULT::"):])


# the smoke SmolLM cache [4, 6, 2, 32]: this rank's block of it
LOCAL = {"batch": [2, 6, 2, 32], "heads": [4, 6, 1, 32],
         "sequence": [4, 3, 2, 32]}


@pytest.mark.parametrize("split", list(LOCAL))
def test_gqa_decode_writes_the_rows_of_a_split_cache(result, split):
    cell = result[f"decode_{split}"]
    assert cell["k_local_rows"] == LOCAL[split]
    assert cell["k"] == 0.0 and cell["v"] == 0.0
    assert result[f"decode_{split}_wo"]["k"] == 0.0


@pytest.mark.parametrize("split", ["batch", "heads"])
def test_gqa_decode_on_whole_rows_and_heads_is_bit_for_bit(result, split):
    assert result[f"decode_{split}"]["y"] == 0.0
    assert result["decode_batch_wo"]["y"] == 0.0


@pytest.mark.parametrize("cell", ["decode_heads_wo", "decode_sequence",
                                  "decode_sequence_wo"])
def test_gqa_decode_summed_over_ranks_is_within_1e5(result, cell):
    # wo's product over the heads' ranks, or the softmax over the
    # sequence's, sums in another order than one rank's
    assert result[cell]["y"] < 1e-5


def test_moe_apply_with_tokens_split_over_two_mesh_dims(result):
    cell = result["moe"]
    assert cell["x_placements"] == ["S(0)", "S(0)", "R"]
    assert cell["y"] < 1e-5 and cell["aux"] < 1e-5


def test_split_dim_under_vmap_makes_an_uneven_head_split_whole(result):
    cell = result["split"]
    assert cell["placements"] == ["R", "R"]
    assert cell["shape"] == [4, 3, 15] and cell["y"] == 0.0


ONE_CARD = r"""
import sys, torch
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as tf
cfg = get_smoke_config("smollm-360m")
params = tf.init(cfg, 0, "cpu")
tokens = torch.zeros((2, 8), dtype=torch.int32)
tf.forward(cfg, params, {"tokens": tokens})
cache = tf.init_cache(cfg, 2, 16, "cpu")
tf.decode_step(cfg, params, cache, tokens[:, :1], 3)
print("DTENSOR::" + str("torch.distributed.tensor" in sys.modules))
"""


def test_the_one_card_serving_path_does_not_load_dtensor():
    # the placement helpers return before any import on plain tensors: a
    # forward and a decode step on one device leave
    # torch.distributed.tensor unloaded (torch.func loads it by itself)
    import subprocess

    proc = subprocess.run([sys.executable, "-c", ONE_CARD],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=SRC))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "DTENSOR::False" in proc.stdout
