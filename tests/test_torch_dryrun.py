"""The dry run (``repro_torch.launch.dryrun``) on ``fake`` process groups.

Each cell is a subprocess of its own (a ``fake`` group of the mesh's size,
joined once per process); the cells run at once.  The reference's cells
of ``tests/test_dryrun.py`` at their meshes and thresholds where the
port's DTensor path runs them (SmolLM-360M ``train_4k`` on (4, 2),
RWKV6-3B ``long_500k``, Qwen3-30B-A3B ``prefill_32k`` with collective
bytes), one cell on the 512-rank (2, 16, 16) production mesh, and at one
rank the dry run's FLOPs equal ``launch.roofline.analyze_program``'s for
the same program.  Nothing is allocated: every argument is a meta
DTensor, at full width.  OLMo-1B ``train_4k`` on (2, 2, 2) and
Whisper-small ``decode_32k`` do not run yet (ROADMAP.md, Queue 3).
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

SCRIPT = r"""
import json, math, sys
from repro_torch.launch.dryrun import run_one
from repro_torch.launch.mesh import init_fake_group, make_mesh

arch, shape, out = sys.argv[1], sys.argv[2], sys.argv[4]
dims = tuple(int(x) for x in sys.argv[3].split(","))
names = {1: ("data",), 2: ("data", "model"),
         3: ("pod", "data", "model")}[len(dims)]
if len(dims) == 1:
    dims, names = (1, 1), ("data", "model")
init_fake_group(math.prod(dims))
mesh = make_mesh(dims, names, "cpu")
rec = run_one(arch, shape, mesh=mesh, out_dir=out)
result = {k: rec[k] for k in ("flops", "flops_per_rank", "collective_bytes",
                              "useful_flops_ratio", "n_chips", "mesh",
                              "argument_bytes_per_rank",
                              "collective_counts_per_rank")}
result["bottleneck"] = rec["roofline"]["bottleneck"]
if sys.argv[3] == "1":
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch.roofline import analyze_program
    from repro_torch.launch.steps import build_program
    prog = build_program(get_config(arch), shape, "meta")
    result["analyze_flops"] = analyze_program(prog.fn, *prog.args)["flops"]
print("RESULT::" + json.dumps(result))
"""

CELLS = {
    "train_single_pod": ("smollm-360m", "train_4k", "4,2"),
    "decode_long_context_ssm": ("rwkv6-3b", "long_500k", "4,2"),
    "moe_prefill": ("qwen3-moe-30b-a3b", "prefill_32k", "4,2"),
    "production_multi_pod": ("smollm-360m", "prefill_32k", "2,16,16"),
    "one_rank": ("smollm-360m", "prefill_32k", "1"),
}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    env = dict(os.environ, PYTHONPATH=SRC)

    def one(cell):
        arch, shape, mesh = CELLS[cell]
        return subprocess.run(
            [sys.executable, "-c", SCRIPT, arch, shape, mesh, out],
            capture_output=True, text=True, timeout=400, env=env)

    with ThreadPoolExecutor(len(CELLS)) as pool:
        return dict(zip(CELLS, pool.map(one, CELLS)))


def _rec(records, cell) -> dict:
    proc = records[cell]
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT::")][0]
    return json.loads(line[len("RESULT::"):])


def test_dryrun_train_single_pod(records):
    rec = _rec(records, "train_single_pod")
    assert rec["flops"] > 1e14
    assert rec["collective_bytes"] > 0   # the DeCaPH secure-sum collectives
    assert 0.005 < rec["useful_flops_ratio"] < 5.0
    assert rec["n_chips"] == 8 and rec["mesh"] == "4x2"


def test_dryrun_decode_long_context_ssm(records):
    rec = _rec(records, "decode_long_context_ssm")
    assert rec["flops"] > 1e8


def test_dryrun_moe_prefill(records):
    rec = _rec(records, "moe_prefill")
    assert rec["collective_bytes"] > 0   # expert all-to-alls / gathers


def test_dryrun_on_the_512_rank_production_mesh(records):
    rec = _rec(records, "production_multi_pod")
    assert rec["n_chips"] == 512 and rec["mesh"] == "2x16x16"
    assert rec["flops"] > 1e14 and rec["collective_bytes"] > 0
    # each rank holds its shards of SmolLM-360M (~0.82 GB of bf16 params
    # and the batch): far less than the whole
    assert rec["argument_bytes_per_rank"] < 0.82e9 / 16


def test_one_rank_flops_are_analyze_programs(records):
    rec = _rec(records, "one_rank")
    assert rec["n_chips"] == 1 and rec["collective_bytes"] == 0
    assert rec["flops_per_rank"] == rec["analyze_flops"] > 1e14
