"""``python -m repro_torch.run`` against ``python -m repro.run``, on the CPU.

``run_one`` builds the same GEMINI-like hospitals and zero-initialised
logistic regression in both packages and runs DeCaPH with SecAgg on the
``ideal`` backend.  At sigma = 0 the runs must agree: ε equal (inf), loss
within 1e-5 and the same pooled accuracy.  On ``sim`` (nodes from
``heterogeneous_trace``) the printed lines are the reference's, the
``sim_wall`` part included, except DeCaPH's simulated wall clock: its
uniform leader draw is the port's own numpy draw (ROADMAP.md, Queue 3),
and the leader decides whose uploads cross which link.
"""

import json
import math

import pytest
import torch

import repro.arms as jarms
import repro.run as jrun
import repro_torch.arms as arms
import repro_torch.run as run
from repro.data.synthetic import make_gemini_like as jax_gemini
from repro.models.tabular import linear_model as jax_linear
from repro.models.tabular import pooled_accuracy as jax_accuracy
from repro_torch.data.synthetic import make_gemini_like
from repro_torch.models.tabular import linear_model, pooled_accuracy

torch.set_num_threads(1)

KW = dict(rounds=3, hospitals=4, features=8, examples=240, batch=32, seed=0)


def test_run_one_matches_the_reference_at_sigma0(capsys):
    ours = run.run_one("decaph", "ideal", sigma=0.0, device="cpu", **KW)
    ref = jrun.run_one("decaph", "ideal", sigma=0.0, **KW)
    out = capsys.readouterr().out.splitlines()
    assert ours.rounds_completed == ref.rounds_completed == 3
    assert ours.epsilon == ref.epsilon and math.isinf(ours.epsilon)
    assert abs(ours.mean_loss() - ref.mean_loss()) <= 1e-5
    assert [l.aggregate_batch for l in ours.logs] == \
        [l.aggregate_batch for l in ref.logs]
    # the printed lines agree field by field, and the accuracy exactly
    assert len(out) == 2 and out[0] == out[1], out
    data = dict(seed=0, n_total=KW["examples"], n_silos=KW["hospitals"],
                n_features=KW["features"])
    acc = pooled_accuracy(linear_model(KW["features"], device="cpu"),
                          ours.params,
                          arms.normalize_participants(make_gemini_like(**data)))
    jacc = jax_accuracy(jax_linear(KW["features"]), ref.params,
                        jarms.normalize_participants(jax_gemini(**data)))
    assert acc == jacc


@pytest.mark.parametrize("arm", ["fl", "primia", "gossip", "decaph"])
def test_run_one_on_sim_prints_the_references_line(arm, capsys):
    ours = run.run_one(arm, "sim", sigma=0.0, device="cpu", **KW)
    ref = jrun.run_one(arm, "sim", sigma=0.0, **KW)
    line, jline = capsys.readouterr().out.splitlines()
    assert ours.timing is not None and ours.rounds_completed == \
        ref.rounds_completed
    if arm == "decaph":
        # all but the simulated wall clock, which the leaders decide
        line, jline = (x.replace(x[x.index("sim_wall="):x.index("wire=")],
                                 "") for x in (line, jline))
    assert line == jline


def test_list_and_smoke_return_0(capsys):
    assert run.main(["--list"]) == 0
    listed = capsys.readouterr().out
    assert "decaph" in listed and "secagg=True" in listed
    # the arms as the reference lists them, and the four registered
    # backends, population's line as the reference's; shard names what it
    # needs (this process joins no group)
    assert listed.splitlines()[:9] == jrun_list()[:9]
    backend_lines = listed.split("backends:\n")[1].splitlines()
    assert [l.split()[0] for l in backend_lines] == ["ideal", "population",
                                                     "shard", "sim"]
    assert "sim_time=True group=host" in backend_lines[3]
    assert "group=spmd" in backend_lines[2]
    assert "unavailable here: needs a torch.distributed process group" in \
        backend_lines[2]
    assert backend_lines[1] in jrun_list()
    assert run.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "all registered arms passed" in out
    ran = {tuple(l.split()[:2]) for l in out.splitlines() if "rounds=" in l}
    # the fused-only population backend runs the fused round arms and
    # rules out the node arms, as the reference's smoke does
    fused = {a for a in arms.names()
             if getattr(arms.get(a), "fused_capable", False)}
    assert fused == {"decaph", "fl", "fedprox", "primia", "scaffold"}
    assert ran == {(a, b) for a in arms.names() for b in ("ideal", "sim")} | \
        {(a, "population") for a in fused}
    ruled = {l.split()[0] for l in out.splitlines() if "ruled out" in l}
    assert ruled == set(arms.names()) - fused


def jrun_list() -> list[str]:
    """The reference's ``--list`` lines."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jrun.main(["--list"]) == 0
    return buf.getvalue().splitlines()


def test_obs_writes_its_three_files(tmp_path, capsys):
    out = tmp_path / "obs"
    assert run.main(["--arm", "decaph", "--rounds", "2", "--device", "cpu",
                     "--hospitals", "3", "--examples", "200",
                     "--obs", str(out)]) == 0
    assert sorted(p.name for p in out.iterdir()) == \
        ["events.jsonl", "ledger.jsonl", "trace.json"]
    rows = [json.loads(l) for l in
            (out / "ledger.jsonl").read_text().splitlines()]
    rounds = [r for r in rows if r.get("type") != "ledger-meta"]
    assert len(rounds) == 2 * 3      # one entry per hospital and round
    assert "decaph" in capsys.readouterr().out


def test_cli_needs_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(["--arm", "decaph", "--rounds", "1"])
    with pytest.raises(SystemExit):
        run.main([])                 # --arm is required
