"""The harness refuses to measure without a card: it exits non-zero and
prints no result, rather than falling back to the CPU."""

import subprocess
import sys

import pytest
import torch

from perfbench.harness import spec


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here: nothing to refuse")
    cell = spec.benchmark()["workloads"][0]["name"]
    res = subprocess.run(
        [sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload", cell,
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=spec.ROOT)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr
