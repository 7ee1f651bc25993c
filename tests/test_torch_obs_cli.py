"""``python -m repro_torch.obs`` against ``python -m repro.obs``, on the CPU.

Each package's ``run`` CLI exports a DeCaPH run (``--obs DIR``); each obs
CLI then reads both exports: the summary, ``--validate``, ``--to-chrome``
and a tampered ledger give the same exit codes and the same text from
either CLI (the port's usage line names its own program).
"""

import contextlib
import io
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.obs as jobs
import repro.run as jrun
from repro.obs.cli import main as jmain
import repro_torch.obs as obs
import repro_torch.run as run
from repro_torch.obs.cli import main
from repro_torch.obs.convert import validate_chrome_trace

torch.set_num_threads(1)

ARGS = ["--arm", "decaph", "--rounds", "2", "--hospitals", "3",
        "--examples", "200", "--sigma", "0.8"]
REPO_ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs")
    with contextlib.redirect_stdout(io.StringIO()):
        assert run.main(ARGS + ["--device", "cpu",
                                "--obs", str(root / "port")]) == 0
        assert jrun.main(ARGS + ["--obs", str(root / "ref")]) == 0
    obs.disable()
    jobs.disable()
    return root


def _call(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = cli(argv)
        except SystemExit as e:         # argparse's usage errors
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def _both(argv):
    ours, ref = _call(main, argv), _call(jmain, argv)
    assert ours == ref
    return ours


@pytest.mark.parametrize("which", ["port", "ref"])
@pytest.mark.parametrize("mode", [[], ["--validate"]], ids=["summary",
                                                             "validate"])
def test_summary_and_validate_agree_on_each_export(exports, which, mode):
    d = exports / which
    rc, out, err = _both(mode + [str(d)])
    assert rc == 0 and err == ""
    if mode:
        assert out.count(": OK") == 3
        assert "chain of 6 entries (3 hospitals x 2 rounds)" in out
    else:
        assert "hospital 0" in out and "span    arms.run" in out
    # each artifact file on its own too
    for name in ("events.jsonl", "ledger.jsonl", "trace.json"):
        rc, out, err = _both(mode + [str(d / name)])
        assert rc == 0 and err == ""


def test_summary_epsilon_is_the_runs(exports):
    """The summary's per-hospital ε is the run's ε (the same run as the
    export's: ``run_one`` with the CLI's defaults and ``ARGS``)."""
    with contextlib.redirect_stdout(io.StringIO()):
        report = run.run_one("decaph", "ideal", rounds=2, hospitals=3,
                             features=32, examples=200, batch=64, seed=0,
                             sigma=0.8, device="cpu")
    rc, out, _ = _call(main, [str(exports / "port")])
    assert rc == 0
    entries = obs.read_entries(exports / "port" / "ledger.jsonl")
    assert obs.per_hospital_epsilon(entries) == \
        {h: report.epsilon for h in range(3)}
    for h in range(3):
        assert f"hospital {h:<4} eps={report.epsilon:10.4f}" in out


@pytest.mark.parametrize("which", ["port", "ref"])
def test_tampered_ledger_fails_both(exports, tmp_path, which):
    d = tmp_path / which
    shutil.copytree(exports / which, d)
    lines = (d / "ledger.jsonl").read_text().splitlines()
    row = json.loads(lines[2])
    row["eps"] = row["eps"] * 0.5      # under-report one hospital
    lines[2] = json.dumps(row, sort_keys=True, separators=(",", ":"))
    (d / "ledger.jsonl").write_text("\n".join(lines) + "\n")
    rc, out, err = _both(["--validate", str(d)])
    assert rc == 1 and "FAILED" in err
    rc, _, _ = _both(["--validate", str(exports / which), str(d)])
    assert rc == 1


@pytest.mark.parametrize("which", ["port", "ref"])
def test_to_chrome_writes_the_same_trace(exports, tmp_path, which):
    events = exports / which / "events.jsonl"
    ours, ref = tmp_path / "ours.json", tmp_path / "ref.json"
    assert _call(main, ["--to-chrome", str(events), "--out", str(ours)]) == \
        (0, f"wrote {ours}\n", "")
    assert _call(jmain, ["--to-chrome", str(events), "--out", str(ref)]) == \
        (0, f"wrote {ref}\n", "")
    assert ours.read_bytes() == ref.read_bytes()
    assert validate_chrome_trace(ours)["trace_events"] > 0


def test_usage_errors_exit_alike(tmp_path):
    for argv in ([], [str(tmp_path / "missing")], [str(tmp_path)]):
        rc, _, _ = _call(main, argv)
        assert rc == _call(jmain, argv)[0] and rc != 0


def test_python_dash_m_runs_the_cli(exports):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "--validate",
         str(exports / "ref")], capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO_ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120)
    assert proc.returncode == 0 and proc.stdout.count(": OK") == 3
    assert "jax" not in proc.stderr
