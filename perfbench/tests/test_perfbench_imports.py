"""Nothing under perfbench/ imports JAX, Flax or the JAX package (top-level
names compared whole: the port, ``repro_torch``, is allowed), the plain
references import nothing of the port, and nothing reads the JAX
package's benchmarks or their results."""

import ast
import re
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH_DIR.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    BENCH_DIR)))
def test_no_jax_and_no_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob(
    "*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    assert imported_tops(path) <= {"__future__", "math", "numpy", "torch",
                                   "perfbench"}


def test_matching_is_by_whole_top_level_name(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.arms\nfrom repro_torchx import y\n")
    assert imported_tops(probe) == {"repro_torch", "repro_torchx"}
    assert not imported_tops(probe) & FORBIDDEN


def test_nothing_reads_the_jax_packages_benchmarks():
    # the JAX package's benchmark folder and its BENCH_<name>.json results
    words = re.compile("bench" + r"marks/|" + "BENCH" + r"_[a-z]")
    for path in BENCH_DIR.rglob("*"):
        if path.is_file() and path.suffix in (".py", ".json"):
            assert not words.search(path.read_text()), path
