"""repro_torch.analysis: the port's contract rules, against the reference's.

The reference's ``tests/test_analysis.py`` cases, each with a firing
fixture and a near-miss, the fixtures of ``prng-key-discipline``,
``host-sync-hygiene`` and ``unaccounted-noise`` rewritten in PyTorch's
idioms (a draw without ``generator=``, ``.cpu()`` reachable from a
``fused_round``, ``torch.randn(...) * sigma`` outside ``core/dp.py``).
For the framework-free rules and the ``analysis-suppression`` meta-finding
the port's JSON report is the reference's byte for byte on the same
fixture tree, with ``repro`` renamed to ``repro_torch``.  The dogfood
checks: the port's tree is clean at an empty baseline, and the
reference's CI gate stays clean with the port's files in it.
"""

import json
import re
import subprocess
import textwrap
from pathlib import Path

import pytest

import repro.analysis as janalysis
import repro.analysis.report as jreport
from repro.analysis.cli import main as jcli_main
from repro_torch.analysis import all_rules, run_analysis
from repro_torch.analysis.baseline import (
    DEFAULT_BASELINE,
    load_baseline,
    split_new,
    write_baseline,
)
from repro_torch.analysis.cli import DEFAULT_PATHS, main as cli_main
from repro_torch.analysis.engine import module_name_for
from repro_torch.analysis.findings import Finding, parse_suppressions
from repro_torch.analysis.report import render_json

REPO_ROOT = Path(__file__).resolve().parents[1]
FRAMEWORK_FREE = ("canonical-hash-discipline", "locked-shared-state",
                  "nondeterminism")


# ---------------------------------------------------------------------------
# Harness
# ---------------------------------------------------------------------------

def _write_tree(root, files):
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def project(tmp_path, files, rules=None):
    """Materialise {relpath: source} and run the port's rules over it."""
    _write_tree(tmp_path, files)
    return run_analysis([tmp_path], tmp_path, rules=rules)


def rule_findings(result, rule_id):
    return [f for f in result.findings if f.rule == rule_id]


# ---------------------------------------------------------------------------
# Registry / self-documentation
# ---------------------------------------------------------------------------

def test_registry_has_the_contract_rules():
    rules = all_rules()
    ids = {r.id for r in rules}
    assert ids == {r.id for r in janalysis.all_rules()}
    assert {"prng-key-discipline", "host-sync-hygiene", "unaccounted-noise",
            "locked-shared-state", "canonical-hash-discipline",
            "nondeterminism"} <= ids
    ref = {r.id: r for r in janalysis.all_rules()}
    for r in rules:
        assert r.contract, f"{r.id} has no contract line"
        assert r.design == ref[r.id].design, f"{r.id} moved its DESIGN anchor"


def test_module_name_for():
    assert module_name_for("src/repro_torch/arms/fused.py") == \
        "repro_torch.arms.fused"
    assert module_name_for("src/repro_torch/obs/__init__.py") == \
        "repro_torch.obs"
    assert module_name_for("tests/test_torch_obs_cli.py") == \
        "tests.test_torch_obs_cli"


# ---------------------------------------------------------------------------
# prng-key-discipline
# ---------------------------------------------------------------------------

def test_prng_seed_reuse_fires(tmp_path):
    result = project(tmp_path, {"src/pkg/a.py": """
        import torch

        def f(seed, shape):
            g1 = torch.Generator().manual_seed(seed)
            g2 = torch.Generator().manual_seed(seed)
            return torch.randn(shape, generator=g1), \\
                torch.randn(shape, generator=g2)
    """})
    hits = rule_findings(result, "prng-key-discipline")
    assert len(hits) == 1 and "two generators, one stream" in hits[0].message


def test_prng_reseed_between_generators_is_clean(tmp_path):
    result = project(tmp_path, {"src/pkg/a.py": """
        import torch

        def f(seed, shape):
            g1 = torch.Generator().manual_seed(seed)
            seed = seed * 31 + 7
            g2 = torch.Generator().manual_seed(seed)
            return torch.randn(shape, generator=g1), \\
                torch.randn(shape, generator=g2)
    """})
    assert rule_findings(result, "prng-key-discipline") == []


def test_prng_loop_reuse_fires_and_per_iteration_seed_is_clean(tmp_path):
    result = project(tmp_path, {"src/pkg/bad.py": """
        import torch

        def f(seed, n):
            out = []
            gen = torch.Generator()
            for i in range(n):
                gen.manual_seed(seed)
                out.append(torch.randn((3,), generator=gen))
            return out
    """, "src/pkg/good.py": """
        import torch

        def f(seed, n):
            out = []
            gen = torch.Generator()
            for i in range(n):
                gen.manual_seed(seed * 1000 + i)
                out.append(torch.randn((3,), generator=gen))
            return out
    """})
    hits = rule_findings(result, "prng-key-discipline")
    assert len(hits) == 1 and hits[0].path == "src/pkg/bad.py"
    assert "inside a loop" in hits[0].message


def test_prng_comprehension_seed_is_fresh_per_iteration(tmp_path):
    result = project(tmp_path, {"src/pkg/a.py": """
        import torch

        def f(seeds):
            gens = [torch.Generator().manual_seed(s) for s in seeds]
            return [torch.randn((3,), generator=g) for g in gens]
    """})
    assert rule_findings(result, "prng-key-discipline") == []


def test_prng_untagged_stdlib_seed_fires_tagged_is_clean(tmp_path):
    result = project(tmp_path, {"src/pkg/a.py": """
        import random

        def bad(seed):
            return random.Random(seed)

        def good(seed):
            return random.Random(f"{seed}:rewire")
    """})
    hits = rule_findings(result, "prng-key-discipline")
    assert len(hits) == 1 and "tagged" in hits[0].message


def test_prng_stream_collision_across_modules(tmp_path):
    result = project(tmp_path, {
        "src/pkg/a.py": "_NOISE_STREAM = 17\n",
        "src/pkg/b.py": "B_SALT = 17\n",
        "src/pkg/c.py": "_NOISE_STREAM = 53\n",
        "tests/legacy.py": "OLD_STREAM = 17\n",  # tests/ exempt (vendored)
    })
    hits = rule_findings(result, "prng-key-discipline")
    assert {f.path for f in hits} == {"src/pkg/a.py", "src/pkg/b.py"}


@pytest.mark.parametrize("draw", [
    "torch.randn(shape)", "torch.rand(shape)", "torch.randint(0, 9, shape)",
    "torch.normal(0.0, 1.0, shape)", "torch.randperm(9)",
    "torch.bernoulli(torch.full(shape, 0.5))",
    "torch.multinomial(torch.ones(4), 2)", "torch.empty(shape).normal_()",
    "torch.empty(shape).uniform_()", "torch.empty(shape).bernoulli_(0.5)",
    "torch.empty(shape).exponential_()",
])
def test_prng_global_stream_draw_fires_and_generator_is_clean(tmp_path, draw):
    explicit = draw[:-1] + (", " if draw[-2] != "(" else "") \
        + "generator=gen)"
    result = project(tmp_path, {"src/pkg/bad.py": f"""
        import torch

        def f(shape):
            return {draw}
    """, "src/pkg/good.py": f"""
        import torch

        def f(shape, gen):
            return {explicit}
    """, "tests/test_fixture.py": f"""
        import torch

        def f(shape):
            return {draw}
    """})
    hits = rule_findings(result, "prng-key-discipline")
    assert len(hits) == 1 and hits[0].path == "src/pkg/bad.py"
    assert "without generator=" in hits[0].message


# ---------------------------------------------------------------------------
# host-sync-hygiene (computed hot-path scope)
# ---------------------------------------------------------------------------

HOT_PATH_SRC = {"src/pkg/arm.py": """
    import torch

    def helper(x):
        return x.cpu()

    def reporting(x):          # NOT reachable from fused_round
        return x.cpu()

    def fused_round(state, x):
        y = helper(x)
        return state, y
"""}


def test_hostsync_flags_sync_in_reachable_helper(tmp_path):
    result = project(tmp_path, HOT_PATH_SRC)
    hits = rule_findings(result, "host-sync-hygiene")
    assert len(hits) == 1
    assert "pkg.arm:helper" in hits[0].message and ".cpu()" in hits[0].message
    # the unreachable twin with the identical body is untouched: the scope
    # is the call graph, not a name list
    assert all("reporting" not in f.message for f in hits)


def test_hostsync_numpy_bookkeeping_is_host_data_not_a_sync(tmp_path):
    result = project(tmp_path, {"src/pkg/arm.py": """
        import dataclasses

        import numpy as np


        @dataclasses.dataclass
        class CohortBatch:
            counts: np.ndarray


        def stack(active) -> CohortBatch:
            return CohortBatch(np.asarray(active, np.int32))


        def fused_round(state, active):
            cb = stack(active)
            sizes = cb.counts.tolist()                         # host data
            ids = [int(c) for c in np.asarray(active).sum(0)]  # host data
            tail = state.tolist()                 # device sync: flagged
            return sizes, ids, tail
    """})
    hits = rule_findings(result, "host-sync-hygiene")
    assert len(hits) == 1 and ".tolist()" in hits[0].message
    assert hits[0].snippet == "tail = state.tolist()                 " \
        "# device sync: flagged"


def test_hostsync_item_in_fused_round_fires(tmp_path):
    result = project(tmp_path, {"src/pkg/arm.py": """
        def fused_round(state, x):
            return x.item()
    """})
    hits = rule_findings(result, "host-sync-hygiene")
    assert len(hits) == 1 and ".item()" in hits[0].message


@pytest.mark.parametrize("sync, what", [
    ("x.cpu().numpy()", ".cpu()"), ("x.numpy()", ".numpy()"),
    ("x.to('cpu')", '.to("cpu")'), ("x.to(device='cpu')", '.to("cpu")'),
    ("x.to(torch.device('cpu'))", '.to("cpu")'),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize"),
    ("float(x.sum())", "float(...)"), ("int(x[0])", "int(...)"),
    ("bool(x.any())", "bool(...)"),
])
def test_hostsync_each_torch_sync_fires_once(tmp_path, sync, what):
    result = project(tmp_path, {"src/pkg/arm.py": f"""
        import torch

        def fused_round(state, x):
            x = x.to(torch.float32)
            return state, {sync}
    """})
    hits = rule_findings(result, "host-sync-hygiene")
    assert len(hits) == 1 and what in hits[0].message


def test_hostsync_real_whitelist_holds():
    """The port's own sanctioned sync point stays out of scope."""
    from repro_torch.analysis.rules.hostsync import WHITELIST
    assert WHITELIST == {"repro_torch.arms.fused:build_contributions"}


# ---------------------------------------------------------------------------
# unaccounted-noise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draw", [
    "sigma * torch.randn(g.shape, generator=gen)",
    "torch.randn(g.shape, generator=gen) * sigma",
    "torch.normal(0.0, sigma, g.shape, generator=gen)",
    "torch.empty_like(g).normal_(0.0, sigma, generator=gen)",
    "g.clone().add_(torch.randn(g.shape, generator=gen), alpha=sigma)",
])
def test_noise_sigma_scaled_draw_outside_dp_fires(tmp_path, draw):
    result = project(tmp_path, {"src/pkg/mech.py": f"""
        import torch

        def add_noise(g, gen, sigma):
            return g + {draw}
    """})
    hits = rule_findings(result, "unaccounted-noise")
    assert len(hits) == 1 and "bypassing the accountant" in hits[0].message


def test_noise_core_dp_is_the_sanctioned_home(tmp_path):
    result = project(tmp_path, {"src/repro_torch/core/dp.py": """
        import torch

        def noise_share(g, gen, sigma):
            return g + sigma * torch.randn(g.shape, generator=gen)
    """})
    assert rule_findings(result, "unaccounted-noise") == []


def test_noise_model_initialisers_exempt_but_sigma_scaling_is_not(tmp_path):
    result = project(tmp_path, {"src/repro_torch/models/init.py": """
        import torch

        def init(gen, shape):
            return torch.randn(shape, generator=gen)     # initialiser: fine

        def sneak(gen, shape, noise_std):
            return noise_std * torch.randn(shape, generator=gen)  # flagged
    """, "src/repro_torch/arms/draw.py": """
        import torch

        def unscaled(gen, shape):
            return torch.randn(shape, generator=gen)     # outside dp: flagged
    """})
    hits = rule_findings(result, "unaccounted-noise")
    assert len(hits) == 2
    assert "noise_std" in hits[1].message
    assert hits[0].path == "src/repro_torch/arms/draw.py"
    assert "outside core/dp.py" in hits[0].message


def test_noise_tests_and_benchmarks_exempt(tmp_path):
    result = project(tmp_path, {"tests/test_x.py": """
        import torch

        def fixture(gen, sigma):
            return sigma * torch.randn((3,), generator=gen)
    """})
    assert rule_findings(result, "unaccounted-noise") == []


# ---------------------------------------------------------------------------
# locked-shared-state (computed serve-thread scope)
# ---------------------------------------------------------------------------

THREADED = {
    "src/app/state.py": """
        import threading

        CACHE = {}
        _LOCK = threading.Lock()

        def put(k, v):
            CACHE[k] = v

        def put_locked(k, v):
            with _LOCK:
                CACHE[k] = v

        def register_thing(k, v):
            CACHE[k] = v     # import-time registration convention
    """,
    "src/app/worker.py": """
        import threading

        from app import state

        def work():
            state.put(1, 2)

        def start():
            t = threading.Thread(target=work)
            t.start()
            return t
    """,
}


def test_locking_flags_unlocked_mutation_in_thread_closure(tmp_path):
    result = project(tmp_path, THREADED)
    hits = rule_findings(result, "locked-shared-state")
    assert len(hits) == 1
    assert "'CACHE'" in hits[0].message and "put()" in hits[0].message


def test_locking_quiet_without_any_thread(tmp_path):
    files = {k: v for k, v in THREADED.items() if k != "src/app/worker.py"}
    result = project(tmp_path, files)
    assert rule_findings(result, "locked-shared-state") == []


def test_locking_threading_local_is_clean(tmp_path):
    files = dict(THREADED)
    files["src/app/state.py"] = """
        import threading

        _TL = threading.local()

        def put(k, v):
            _TL.value = (k, v)
    """
    result = project(tmp_path, files)
    assert rule_findings(result, "locked-shared-state") == []


# ---------------------------------------------------------------------------
# canonical-hash-discipline
# ---------------------------------------------------------------------------

def test_hashing_hand_rolled_dumps_plus_digest_fires(tmp_path):
    result = project(tmp_path, {"src/pkg/addr.py": """
        import hashlib
        import json

        def addr(obj):
            raw = json.dumps(obj, sort_keys=True).encode()
            return hashlib.sha256(raw).hexdigest()
    """})
    hits = rule_findings(result, "canonical-hash-discipline")
    assert len(hits) == 1 and "repro_torch.canon" in hits[0].message


def test_hashing_split_across_functions_is_clean(tmp_path):
    result = project(tmp_path, {"src/pkg/split.py": """
        import hashlib
        import json

        def encode(obj):
            return json.dumps(obj).encode()

        def digest(raw):
            return hashlib.sha256(raw).hexdigest()
    """})
    assert rule_findings(result, "canonical-hash-discipline") == []


def test_hashing_tests_may_rederive(tmp_path):
    result = project(tmp_path, {"tests/test_tamper.py": """
        import hashlib
        import json

        def expected(obj):
            return hashlib.sha256(json.dumps(obj).encode()).hexdigest()
    """})
    assert rule_findings(result, "canonical-hash-discipline") == []


# ---------------------------------------------------------------------------
# nondeterminism
# ---------------------------------------------------------------------------

def test_nondeterminism_fires_in_population_modules(tmp_path):
    result = project(tmp_path, {"src/repro_torch/population/thing.py": """
        import time
        import uuid

        def trace_id(spec):
            return f"{uuid.uuid4()}-{time.time()}-{hash(spec)}"
    """})
    msgs = [f.message for f in rule_findings(result, "nondeterminism")]
    assert len(msgs) == 3
    assert any("uuid.uuid4" in m for m in msgs)
    assert any("time.time" in m for m in msgs)
    assert any("hash()" in m for m in msgs)


def test_nondeterminism_cli_modules_are_reporting_layers(tmp_path):
    result = project(tmp_path, {"src/repro_torch/population/cli.py": """
        import time

        def report():
            return time.time()
    """})
    assert rule_findings(result, "nondeterminism") == []


def test_nondeterminism_out_of_scope_module_untouched(tmp_path):
    result = project(tmp_path, {"src/repro_torch/serve/metrics.py": """
        import time

        def stamp():
            return time.time()
    """, "src/repro/population/t.py": """
        import time

        def stamp():
            return time.time()           # the reference's tree: not ours
    """})
    assert rule_findings(result, "nondeterminism") == []


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------

def test_reasoned_suppression_suppresses(tmp_path):
    result = project(tmp_path, {"src/repro_torch/population/t.py": """
        import time

        def f():
            return time.time()  # repro: allow[nondeterminism] wall metric only
    """})
    assert rule_findings(result, "nondeterminism") == []
    assert len(result.suppressed) == 1


def test_reasonless_suppression_does_not_suppress_and_is_itself_a_finding(tmp_path):
    result = project(tmp_path, {"src/repro_torch/population/t.py": """
        import time

        def f():
            return time.time()  # repro: allow[nondeterminism]
    """})
    assert len(rule_findings(result, "nondeterminism")) == 1
    meta = rule_findings(result, "analysis-suppression")
    assert len(meta) == 1 and "without a reason" in meta[0].message


def test_own_line_suppression_covers_next_line():
    sups = parse_suppressions(
        "# repro: allow[host-sync-hygiene] the round's one copy\n"
        "host = rows.cpu().numpy()\n"
    )
    assert 2 in sups and sups[2][0].rule == "host-sync-hygiene"


def test_wrong_rule_suppression_does_not_suppress(tmp_path):
    result = project(tmp_path, {"src/pkg/arm.py": """
        def fused_round(state, x):
            return x.cpu()  # repro: allow[prng-key-discipline] wrong rule
    """})
    assert len(rule_findings(result, "host-sync-hygiene")) == 1


# ---------------------------------------------------------------------------
# Fingerprints + baseline
# ---------------------------------------------------------------------------

BAD_SRC = """
    import time

    def f():
        return time.time()
"""


def test_fingerprint_survives_unrelated_edits(tmp_path):
    r1 = project(tmp_path / "v1", {"src/repro_torch/population/t.py": BAD_SRC})
    shifted = "# a new comment line\n# another\n" + textwrap.dedent(BAD_SRC)
    r2 = project(tmp_path / "v2", {"src/repro_torch/population/t.py": shifted})
    f1, = rule_findings(r1, "nondeterminism")
    f2, = rule_findings(r2, "nondeterminism")
    assert f1.line != f2.line
    assert f1.fingerprint() == f2.fingerprint()


def test_duplicate_sites_get_distinct_fingerprints_through_canon(tmp_path):
    from repro_torch.canon import content_hash

    result = project(tmp_path, {"src/repro_torch/population/t.py": """
        import time

        def f():
            return time.time()

        def g():
            return time.time()
    """})
    hits = rule_findings(result, "nondeterminism")
    assert len({f.fingerprint() for f in hits}) == 2
    for f in hits:
        assert f.fingerprint() == content_hash({
            "rule": f.rule, "path": f.path, "snippet": f.snippet,
            "occurrence": f.occurrence})


def test_baseline_round_trip_and_ratchet(tmp_path):
    result = project(tmp_path, {"src/repro_torch/population/t.py": BAD_SRC})
    findings = rule_findings(result, "nondeterminism")
    path = tmp_path / "baseline.json"
    write_baseline(path, findings)
    baseline = load_baseline(path)
    new, old = split_new(findings, baseline)
    assert new == [] and old == findings
    # a fresh violation is NOT covered by the old baseline
    r2 = project(tmp_path / "v2", {
        "src/repro_torch/population/t.py": BAD_SRC,
        "src/repro_torch/population/u.py": BAD_SRC,
    })
    new2, old2 = split_new(rule_findings(r2, "nondeterminism"), baseline)
    assert {f.path for f in old2} == {"src/repro_torch/population/t.py"}
    assert {f.path for f in new2} == {"src/repro_torch/population/u.py"}


def test_missing_baseline_is_empty_and_the_reference_file_is_refused(tmp_path):
    assert load_baseline(tmp_path / "nope.json") == set()
    assert DEFAULT_BASELINE == "analysis_baseline_torch.json"
    with pytest.raises(ValueError, match="reference's baseline"):
        write_baseline(tmp_path / "analysis_baseline.json", [])
    assert not (tmp_path / "analysis_baseline.json").exists()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_json_report_and_exit_codes(tmp_path, capsys):
    _write_tree(tmp_path, {"src/repro_torch/population/t.py": BAD_SRC})
    out = tmp_path / "report.json"
    rc = cli_main(["src", "--root", str(tmp_path), "--format", "json",
                   "--out", str(out)])
    capsys.readouterr()
    assert rc == 1
    payload = json.loads(out.read_text())
    assert payload["counts"]["findings"] == 1
    assert payload["findings"][0]["rule"] == "nondeterminism"
    assert payload["findings"][0]["new"] is True
    assert "hot_path_defs" in payload["scopes"]


def test_cli_fail_on_new_respects_baseline(tmp_path, capsys):
    _write_tree(tmp_path, {"src/repro_torch/population/t.py": BAD_SRC})
    rc = cli_main(["src", "--root", str(tmp_path), "--write-baseline"])
    assert rc == 0 and (tmp_path / DEFAULT_BASELINE).exists()
    rc = cli_main(["src", "--root", str(tmp_path), "--fail-on-new"])
    capsys.readouterr()
    assert rc == 0   # baselined debt is frozen, not failing
    _write_tree(tmp_path, {"src/repro_torch/population/u.py": BAD_SRC})
    rc = cli_main(["src", "--root", str(tmp_path), "--fail-on-new"])
    err = capsys.readouterr().err
    assert rc == 1 and "u.py" in err  # ...but new debt fails
    # the reference's baseline is never written from here
    rc = cli_main(["src", "--root", str(tmp_path), "--write-baseline",
                   "--baseline", str(tmp_path / "analysis_baseline.json")])
    capsys.readouterr()
    assert rc == 2 and not (tmp_path / "analysis_baseline.json").exists()


def test_cli_list_rules(capsys):
    rc = cli_main(["--list-rules"])
    out = capsys.readouterr().out
    assert rc == 0
    for rid in ("prng-key-discipline", "host-sync-hygiene",
                "canonical-hash-discipline"):
        assert rid in out
    assert "allow[<rule-id>]" in out


def test_cli_missing_path_is_usage_error(tmp_path, capsys):
    rc = cli_main(["no/such/dir", "--root", str(tmp_path)])
    assert rc == 2
    rc = cli_main(["tests/no_such_*.py", "--root", str(tmp_path)])
    capsys.readouterr()
    assert rc == 2


def _git(root, *argv):
    subprocess.run(["git", *argv], cwd=root, check=True,
                   capture_output=True, text=True)


def test_cli_changed_scopes_reporting_to_touched_files(tmp_path, capsys):
    _write_tree(tmp_path, {
        "src/repro_torch/population/old.py": BAD_SRC,
        "src/repro_torch/population/clean.py": "X = 1\n",
    })
    _git(tmp_path, "init", "-q")
    _git(tmp_path, "-c", "user.email=t@t", "-c", "user.name=t",
         "add", "-A")
    _git(tmp_path, "-c", "user.email=t@t", "-c", "user.name=t",
         "commit", "-qm", "seed")
    # old.py's violation predates the diff; new.py's is in it
    _write_tree(tmp_path, {"src/repro_torch/population/new.py": BAD_SRC})
    out = tmp_path / "report.json"
    rc = cli_main(["src", "--root", str(tmp_path), "--changed", "HEAD",
                   "--format", "json", "--out", str(out)])
    capsys.readouterr()
    assert rc == 1
    paths = {f["path"] for f in json.loads(out.read_text())["findings"]}
    assert paths == {"src/repro_torch/population/new.py"}


def test_cli_default_paths_are_the_ports(tmp_path, capsys):
    assert DEFAULT_PATHS == ("src/repro_torch", "tests/test_torch_*.py")
    _write_tree(tmp_path, {
        "src/repro_torch/population/t.py": BAD_SRC,
        "src/repro/population/t.py": BAD_SRC,
        "tests/test_torch_x.py": "import torch\n\n\ndef test_x():\n"
                                 "    g = torch.Generator()\n"
                                 "    for _ in range(2):\n"
                                 "        g.manual_seed(0)\n",
        "tests/test_x.py": "import time\n",
    })
    out = tmp_path / "report.json"
    rc = cli_main(["--root", str(tmp_path), "--format", "json",
                   "--out", str(out)])
    capsys.readouterr()
    payload = json.loads(out.read_text())
    assert rc == 1 and payload["files"] == 2
    assert {(f["path"], f["rule"]) for f in payload["findings"]} == {
        ("src/repro_torch/population/t.py", "nondeterminism"),
        ("tests/test_torch_x.py", "prng-key-discipline")}


# ---------------------------------------------------------------------------
# The framework-free rules: the reference's report, byte for byte
# ---------------------------------------------------------------------------

PARITY_TREE = {
    **THREADED,
    "src/repro/population/t.py": """
        import hashlib
        import json
        import time
        import uuid

        def trace_id(spec):
            return f"{uuid.uuid4()}-{time.time()}-{hash(spec)}"

        def addr(obj):
            raw = json.dumps(obj, sort_keys=True).encode()
            return hashlib.sha256(raw).hexdigest()

        def g():
            return time.time()  # repro: allow[nondeterminism] wall metric only

        def h():
            return time.time()  # repro: allow[nondeterminism]

        def k():
            return time.time()
    """,
    "src/repro/population/cli.py": BAD_SRC,
    "src/repro/obs/ledger.py": """
        import time

        # repro: allow[canonical-hash-discipline]
        STAMP = time.monotonic()
    """,
    "tests/test_tamper.py": """
        import hashlib
        import json

        def expected(obj):
            return hashlib.sha256(json.dumps(obj).encode()).hexdigest()
    """,
}

_RENAME = re.compile(r"\brepro(?=[./])")


def _renamed(obj):
    if isinstance(obj, str):
        return _RENAME.sub("repro_torch", obj)
    if isinstance(obj, list):
        return [_renamed(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _renamed(v) for k, v in obj.items()}
    return obj


def test_framework_free_report_is_the_references_byte_for_byte(tmp_path):
    jrules = [r for r in janalysis.all_rules() if r.id in FRAMEWORK_FREE]
    rules = [r for r in all_rules() if r.id in FRAMEWORK_FREE]
    _write_tree(tmp_path / "ref", PARITY_TREE)
    ref = janalysis.run_analysis([tmp_path / "ref"], tmp_path / "ref",
                                 rules=jrules)
    ours = project(tmp_path / "port",
                   {_RENAME.sub("repro_torch", k): _RENAME.sub("repro_torch", v)
                    for k, v in PARITY_TREE.items()}, rules=rules)
    assert len(ours.findings) == 10 and len(ours.suppressed) == 1
    assert {f.rule for f in ours.findings} == set(FRAMEWORK_FREE) | {
        "analysis-suppression"}
    fps = {f.fingerprint() for f in ours.findings[::2]}
    expected = _renamed(json.loads(jreport.render_json(
        ref, jrules, {f.fingerprint() for f in ref.findings[::2]})))
    # the renamed paths have their own fingerprints, by the same hash
    for f in expected["findings"] + expected["suppressed"]:
        f["fingerprint"] = Finding(**{k: f[k] for k in (
            "rule", "path", "line", "col", "message", "snippet",
            "occurrence")}).fingerprint()
    for key in expected["scopes"]:
        expected["scopes"][key].sort()
    assert render_json(ours, rules, fps) == json.dumps(
        expected, indent=2, sort_keys=True)


# ---------------------------------------------------------------------------
# Dogfood + repo gates
# ---------------------------------------------------------------------------

def test_dogfood_analysis_package_is_clean_under_its_own_rules():
    result = run_analysis([REPO_ROOT / "src" / "repro_torch" / "analysis"],
                          REPO_ROOT)
    assert result.findings == []
    assert result.skipped == []


def test_port_tree_is_clean_at_an_empty_baseline(capsys):
    """``python -m repro_torch.analysis``: the port's tree and tests, no
    baseline file, 0 findings."""
    assert load_baseline(REPO_ROOT / DEFAULT_BASELINE) == set()
    rc = cli_main(["--root", str(REPO_ROOT)])
    out = capsys.readouterr().out
    assert rc == 0 and "0 findings" in out
    result = run_analysis(
        [REPO_ROOT / "src" / "repro_torch",
         *sorted((REPO_ROOT / "tests").glob("test_torch_*.py"))], REPO_ROOT)
    assert [f.render() for f in result.findings] == []
    assert result.skipped == []
    assert "repro_torch.arms.fused:build_contributions" in \
        result.index.hot_path_scope()


def test_reference_gate_stays_clean_with_the_ports_files(capsys):
    """CI's ``python -m repro.analysis src tests benchmarks --fail-on-new``."""
    rc = jcli_main(["src", "tests", "benchmarks", "--root", str(REPO_ROOT),
                    "--fail-on-new"])
    capsys.readouterr()
    assert rc == 0
