"""``repro_torch.launch.reanalyze``: re-scoring dry-run records from the op
logs beside them, without tracing again.

One subprocess (a ``fake`` group of 8 ranks) writes two records with
``launch.dryrun.run_one`` on a (4, 2) mesh; the tests copy them and
re-score the copies.
"""

import gzip
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import reanalyze
from repro_torch.launch.dryrun import op_log_path

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

SCRIPT = r"""
import sys
from repro_torch.launch.dryrun import run_one
from repro_torch.launch.mesh import init_fake_group, make_mesh

init_fake_group(8)
mesh = make_mesh((4, 2), ("data", "model"), "cpu")
for arch, shape in (("smollm-360m", "decode_32k"),
                    ("whisper-small", "decode_32k")):
    run_one(arch, shape, mesh=mesh, out_dir=sys.argv[1])
"""

KEYS = ("flops", "flops_per_rank", "flops_by_op_per_rank",
        "collective_bytes", "collective_bytes_per_rank",
        "collective_by_kind", "collective_counts_per_rank", "roofline",
        "model_flops", "useful_flops_ratio")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    proc = subprocess.run([sys.executable, "-c", SCRIPT, out],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=SRC))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return out


@pytest.fixture
def records(traced, tmp_path):
    d = tmp_path / "records"
    shutil.copytree(traced, d)
    return str(d)


def _path(d, arch="smollm-360m"):
    return os.path.join(d, f"{arch}__decode_32k__4x2.json")


@pytest.mark.parametrize("arch", ["smollm-360m", "whisper-small"])
def test_an_unchanged_record_gets_its_trace_numbers_back(records, arch):
    with open(_path(records, arch)) as f:
        traced = json.load(f)
    rec = reanalyze.reanalyze_file(_path(records, arch))
    assert traced["flops"] > 0 and traced["collective_bytes"] > 0
    for key in KEYS:
        assert rec[key] == traced[key], key
    with open(_path(records, arch)) as f:
        assert json.load(f) == traced


def test_an_ops_multiplicity_moves_flops_by_its_flops(records):
    path = _path(records)
    with open(path) as f:
        traced = json.load(f)
    log = reanalyze.read_op_log(op_log_path(path))
    i, line = next((i, ln) for i, ln in enumerate(log)
                   if ln["op"] == "aten.bmm.default")
    one = flop_registry[torch.ops.aten.bmm](
        *(reanalyze._meta(a) for a in line["args"]),
        out_val=reanalyze._meta(line["out"]))
    log[i] = dict(line, n=line["n"] + 3)
    with gzip.open(op_log_path(path), "wt") as f:
        f.write("".join(json.dumps(ln) + "\n" for ln in log))
    rec = reanalyze.reanalyze_file(path)
    assert one > 0
    assert rec["flops_per_rank"] == traced["flops_per_rank"] + 3 * one
    assert rec["flops"] == rec["flops_per_rank"] * rec["n_chips"]
    assert rec["flops_by_op_per_rank"]["aten.bmm"] == \
        traced["flops_by_op_per_rank"]["aten.bmm"] + 3 * one
    assert rec["collective_bytes"] == traced["collective_bytes"]


def test_the_cli_reanalyzes_every_record_with_an_op_log(records, capsys):
    reanalyze.main(["--dir", records])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "reanalyzed 2 artifacts"
    assert any(ln.startswith("smollm-360m") and "decode_32k" in ln
               and ln.endswith(("compute", "memory", "collective"))
               for ln in out)


def test_a_record_without_its_op_log_is_skipped(records, capsys):
    path = _path(records, "whisper-small")
    os.remove(op_log_path(path))
    with open(path) as f:
        before = f.read()
    assert reanalyze.reanalyze_file(path) is None
    with open(path) as f:
        assert f.read() == before
    reanalyze.main(["--dir", records])
    assert capsys.readouterr().out.splitlines()[-1] == \
        "reanalyzed 1 artifacts"
