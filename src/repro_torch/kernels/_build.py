"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/repro_torch/<name>-<hash>.so`` at the
root of the checkout, then loaded with ``ctypes``.  The hash covers the
source bytes and the compiler flags, so an edited source is rebuilt and an
unchanged one is reused.  ``nvcc``'s output (with ``-Xptxas -v``: each
kernel's registers, shared memory and spills) is kept beside the library
as ``<name>-<hash>.log``; ``resources`` reads it back and ``sass_counts``
counts instructions in the compiled code.  Nothing here runs at import:
building starts when a wrapper first gets a CUDA tensor (or
``chip_smoke.py`` asks), so the package imports on machines without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

BUILD_TIMEOUT_S = 600   # for all sources together

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}  # guarded by _lock


def _tool(name: str) -> str | None:
    """Path of a CUDA toolkit program, on ``PATH`` or in the default
    install; None where there is none."""
    found = shutil.which(name)
    if found:
        return found
    default = Path("/usr/local/cuda/bin") / name
    return str(default) if default.exists() else None


def nvcc() -> str:
    """Path of the CUDA compiler; raises where there is none."""
    found = _tool("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its source and flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> float:
    """Compile every named source whose library is missing, one ``nvcc``
    process per source, all started together.  Returns the seconds spent."""
    t0 = time.perf_counter()
    todo = {n: library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = []
    for name, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        try:
            log, _ = proc.communicate(
                timeout=max(1.0, BUILD_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for *_, p in procs:
                p.kill()
                p.wait()
            raise RuntimeError(f"nvcc did not finish {name}.cu within "
                               f"{BUILD_TIMEOUT_S} s") from None
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib


def _demangle(names: list[str]) -> list[str]:
    tool = _tool("cu++filt") or shutil.which("c++filt")
    if tool is None or not names:
        return names
    res = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=False)
    out = res.stdout.splitlines()
    return out if res.returncode == 0 and len(out) == len(names) else names


def resources(name: str) -> list[dict]:
    """Per kernel of ``csrc/<name>.cu``, what ``ptxas -v`` reported when it
    was built: registers per thread, static shared memory, stack frame and
    spill bytes.  Empty where the build left no log."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return []
    rows: dict[str, dict] = {}
    fn = None
    for line in log.read_text().splitlines():
        if m := re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$]+)'?", line):
            fn = m.group(1)
            rows.setdefault(fn, {"kernel": fn})
        elif fn and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes "
                                    r"spill stores, (\d+) bytes spill loads",
                                    line)):
            rows[fn].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            rows[fn]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rows[fn]["smem"] = int(smem.group(1)) if smem else 0
    kept = [r for r in rows.values() if "registers" in r]
    for r, pretty in zip(kept, _demangle([r["kernel"] for r in kept])):
        r["kernel"] = pretty
    return kept


def sass_counts(name: str, opcode: str) -> dict[str, int] | None:
    """Per kernel of the built ``csrc/<name>.cu``, how many of its SASS
    instructions start with ``opcode`` (for example ``HMMA``), from
    ``cuobjdump -sass``; None where there is no ``cuobjdump``."""
    tool = _tool("cuobjdump")
    if tool is None:
        return None
    res = subprocess.run([tool, "-sass", str(library_path(name))],
                         capture_output=True, text=True, check=True)
    counts: dict[str, int] = {}
    fn = None
    for line in res.stdout.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.search(rf"\*/\s+(@!?U?P\w+\s+)?{opcode}\b", line):
            counts[fn] += 1
    return dict(zip(_demangle(list(counts)), counts.values()))
