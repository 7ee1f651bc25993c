"""The dry run (``repro_torch.launch.dryrun``) on ``fake`` process groups.

Each cell is a subprocess of its own (a ``fake`` group of the mesh's size,
joined once per process); the cells run at once.  The reference's five
cells of ``tests/test_dryrun.py`` at their meshes and thresholds
(SmolLM-360M ``train_4k`` on (4, 2), OLMo-1B ``train_4k`` on the (2, 2,
2) pod mesh, RWKV6-3B ``long_500k``, Whisper-small ``decode_32k``,
Qwen3-30B-A3B ``prefill_32k`` with collective bytes); a GQA decode over a
sharded KV cache, by batch and heads (SmolLM-360M ``decode_32k``) and by
sequence (``long_500k``, windowed); the MoE prefill on the (2, 2, 2) and
the 512-rank (2, 16, 16) meshes, whose tokens split over ("pod", "data");
SmolLM-360M ``prefill_32k`` on the 512-rank mesh; SmolLM-360M
``train_4k`` on (16, 16), whose total FLOPs stay near (4, 2)'s; two
per-example programs under the per-example rules (a microbatch the
("pod", "data") ranks do not divide: SmolLM-360M at 2 layers and a
microbatch of 2 on (2, 8, 2), a Mamba + MoE layer of Jamba on (8, 2)),
each held against its ``--dp-mode none`` twin; and at one rank the dry
run's FLOPs equal ``launch.roofline.analyze_program``'s for the same
program.  Nothing is allocated: every argument is a meta DTensor, at full
width.
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
dp_mode = sys.argv[5] if len(sys.argv) > 5 else None
over = json.loads(sys.argv[6]) if len(sys.argv) > 6 else None
if over and "stack" in over:     # [[repeat, [[mixer, ffn], ...]], ...]
    from repro_torch.configs.base import LayerSpec
    over["stack"] = tuple((r, tuple(LayerSpec(*spec) for spec in pattern))
                          for r, pattern in over["stack"])
dims = tuple(int(x) for x in sys.argv[3].split(","))
names = {1: ("data",), 2: ("data", "model"),
         3: ("pod", "data", "model")}[len(dims)]
if len(dims) == 1:
    dims, names = (1, 1), ("data", "model")
init_fake_group(math.prod(dims))
mesh = make_mesh(dims, names, "cpu")
rec = run_one(arch, shape, mesh=mesh, out_dir=out, dp_mode=dp_mode,
              tag=dp_mode or "", cfg_overrides=over)
result = {k: rec[k] for k in ("flops", "flops_per_rank", "collective_bytes",
                              "useful_flops_ratio", "n_chips", "mesh",
                              "argument_bytes_per_rank",
                              "collective_bytes_per_rank",
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

DENSE_CUT = json.dumps({"n_layers": 2, "dp_microbatch": 2,
                        "stack": [[2, [["attn", "dense"]]]]})
MAMBA_MOE_CUT = json.dumps({"n_layers": 1,
                            "stack": [[1, [["mamba", "moe"]]]]})

CELLS = {
    "train_single_pod": ("smollm-360m", "train_4k", "4,2"),
    "train_multi_pod": ("olmo-1b", "train_4k", "2,2,2"),
    "train_production": ("smollm-360m", "train_4k", "16,16"),
    "train_production_no_dp": ("smollm-360m", "train_4k", "16,16", "none"),
    "decode_long_context_ssm": ("rwkv6-3b", "long_500k", "4,2"),
    "decode_whisper": ("whisper-small", "decode_32k", "4,2"),
    "decode_gqa_cache": ("smollm-360m", "decode_32k", "4,2"),
    "decode_windowed_long": ("smollm-360m", "long_500k", "4,2"),
    "moe_prefill": ("qwen3-moe-30b-a3b", "prefill_32k", "4,2"),
    "moe_prefill_pod_mesh": ("qwen3-moe-30b-a3b", "prefill_32k", "2,2,2"),
    "moe_prefill_multi_pod": ("qwen3-moe-30b-a3b", "prefill_32k",
                              "2,16,16"),
    "production_multi_pod": ("smollm-360m", "prefill_32k", "2,16,16"),
    # per-example rules: 2 examples a microbatch over ("pod", "data") of 4
    # x 8 ranks, and Jamba's one example over 8 "data" ranks; cut depths
    "rules_dense": ("smollm-360m", "train_4k", "2,8,2", "per_example",
                    DENSE_CUT),
    "rules_dense_no_dp": ("smollm-360m", "train_4k", "2,8,2", "none",
                          DENSE_CUT),
    "rules_mamba_moe": ("jamba-v0.1-52b", "train_4k", "8,2",
                        "per_example", MAMBA_MOE_CUT),
    "rules_mamba_moe_no_dp": ("jamba-v0.1-52b", "train_4k", "8,2", "none",
                              MAMBA_MOE_CUT),
    "one_rank": ("smollm-360m", "prefill_32k", "1"),
}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    env = dict(os.environ, PYTHONPATH=SRC)

    def one(cell):
        arch, shape, mesh, *mode = CELLS[cell]
        return subprocess.run(
            [sys.executable, "-c", SCRIPT, arch, shape, mesh, out, *mode],
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


def test_dryrun_train_multi_pod(records):
    rec = _rec(records, "train_multi_pod")
    assert rec["flops"] > 1e14
    assert rec["collective_bytes"] > 0
    assert rec["n_chips"] == 8 and rec["mesh"] == "2x2x2"


def test_dryrun_train_per_example_keeps_the_batch_split(records):
    # (16, 16) splits the 16 examples of a microbatch over its 16 data
    # ranks (the ordinary rules): the per-example program does the work of
    # the program without DP, not each data rank the whole microbatch
    # (16x).  Against (4, 2) at the same global batch the work grows only
    # where SmolLM-360M's 15 heads cannot split over "model" (attention
    # and its projections on all 16 model ranks there, on 2 of (4, 2))
    big = _rec(records, "train_production")
    no_dp = _rec(records, "train_production_no_dp")
    small = _rec(records, "train_single_pod")
    assert big["n_chips"] == 256 and big["mesh"] == "16x16"
    assert big["flops"] < 1.05 * no_dp["flops"]
    assert big["flops"] < 8.0 * small["flops"]


@pytest.mark.parametrize("pair", ["rules_dense", "rules_mamba_moe"])
def test_dryrun_per_example_rules_split_the_sequence(records, pair):
    # the per-example rules keep a microbatch's examples whole and split
    # each one's sequence over "data": its forward and backward run on its
    # rank's rows (attention's q rows, the projections, the conv's taps,
    # the MoE groups), so the program does the no-DP program's work, up
    # to the "pod" ranks that the examples cannot fill.  Attention (and
    # Mamba from its hint on) running on every "data" rank breaks the bar
    rec, twin = _rec(records, pair), _rec(records, f"{pair}_no_dp")
    pod = 2 if rec["mesh"] == "2x8x2" else 1
    assert rec["flops"] <= 1.25 * pod * twin["flops"]
    assert twin["flops"] > 1e14


def test_dryrun_decode_long_context_ssm(records):
    rec = _rec(records, "decode_long_context_ssm")
    assert rec["flops"] > 1e8


def test_dryrun_decode_whisper(records):
    rec = _rec(records, "decode_whisper")
    assert rec["flops"] > 1e8


@pytest.mark.parametrize("cell", ["decode_gqa_cache",
                                  "decode_windowed_long"])
def test_dryrun_decode_writes_a_sharded_kv_cache(records, cell):
    rec = _rec(records, cell)
    assert rec["flops"] > 1e8 and rec["collective_bytes"] > 0
    # SmolLM-360M's bf16 K and V caches: 32 layers of [B, L, 5, 64], the
    # batch split over 4 data ranks (decode_32k) or the 512k sequence
    # (long_500k); a rank holds its block, and the write moves new rows
    # only: a gather of the cache would bring each rank 3/4 of it
    cache = 2 * 32 * {"decode_gqa_cache": 128 * 32768,
                      "decode_windowed_long": 524288}[cell] * 5 * 64 * 2
    assert rec["argument_bytes_per_rank"] < cache / 2
    assert rec["collective_bytes_per_rank"] < cache / 4


def test_dryrun_moe_prefill(records):
    rec = _rec(records, "moe_prefill")
    assert rec["collective_bytes"] > 0   # expert all-to-alls / gathers


@pytest.mark.parametrize("cell", ["moe_prefill_pod_mesh",
                                  "moe_prefill_multi_pod"])
def test_dryrun_moe_prefill_with_tokens_split_over_pods(records, cell):
    # 16 MoE groups (the data extent) of tokens split over ("pod", "data")
    rec = _rec(records, cell)
    assert rec["collective_bytes"] > 0


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


def test_microbatches_traced_once_count_as_the_whole_loop():
    # the per-example loop's microbatches run the same ops on the same
    # shapes: one traced under ``repeated(n)`` counts what n do
    import torch

    from repro_torch.core import dp
    from repro_torch.launch.dryrun import RankCounts

    params = {"w": torch.empty(6, 3, device="meta")}
    batch = {"x": torch.empty(8, 6, device="meta"),
             "y": torch.empty(8, 3, device="meta")}

    def loss(p, ex):
        return torch.sum((ex["x"] @ p["w"] - ex["y"]) ** 2)

    full, once = RankCounts(), RankCounts()
    with full:
        dp.per_example_clipped_grad_sum(loss, params, batch, clip_norm=1.0,
                                        microbatch_size=2)
    with once:
        dp.per_example_clipped_grad_sum(loss, params, batch, clip_norm=1.0,
                                        microbatch_size=2,
                                        trace_repeat=once.repeated)
    assert sum(full.flops.values()) > 0
    assert once.flops == full.flops and once.ops == full.ops
    assert once.scale == 1


def test_value_reads_of_meta_tensors_outside_dtensor_still_raise():
    # only DTensor's own masking code has a meta tensor's read answered
    import torch

    from repro_torch.launch.dryrun import RankCounts

    counts = RankCounts()
    with pytest.raises(NotImplementedError), counts:
        torch.ones(3, device="meta").nonzero()
    assert not counts.answered


def test_microbatches_traced_once_refuse_tensors_with_values():
    # one microbatch of n would be a wrong gradient sum on real tensors
    import torch

    from repro_torch.core import dp
    from repro_torch.launch.dryrun import RankCounts

    params = {"w": torch.zeros(6, 3)}
    batch = {"x": torch.zeros(8, 6), "y": torch.zeros(8, 3)}
    with pytest.raises(ValueError, match="meta tensors only"):
        dp.per_example_clipped_grad_sum(
            lambda p, ex: torch.sum(ex["x"] @ p["w"]), params, batch,
            clip_norm=1.0, microbatch_size=2,
            trace_repeat=RankCounts().repeated)
