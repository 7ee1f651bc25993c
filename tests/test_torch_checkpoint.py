"""repro_torch.checkpoint against repro.checkpoint, on the CPU.

The port writes ``repro-ckpt-v1`` files with its own msgpack subset
(``repro_torch.checkpoint._msgpack``), because the machine with the card
has neither ``msgpack`` nor ``ml_dtypes``.  The contract is byte identity:
for the same tree, step and metadata, ``save_checkpoint`` of both packages
writes the same file (bfloat16 leaves included), and each package loads
the other's files with exact dtypes and values.  The codec is held to
``msgpack`` itself on every form of the subset, and the cases of
``tests/test_checkpoint.py`` (round trips, torn and foreign files, the
atomic write) run against the port.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro_torch.checkpoint import (
    CorruptCheckpointError,
    _msgpack,
    load_checkpoint,
    save_checkpoint,
)

SRC = Path(__file__).resolve().parents[1] / "src"

DTYPES = ["float32", "bfloat16", "int32", "int64", "bool", "uint8"]
SHAPES = [(), (0,), (3, 0, 2), (5,), (2, 3, 4)]


def _values(dtype: str, shape, rng) -> np.ndarray:
    """Seeded float32 / integer / bool values of ``shape`` (bfloat16 leaves
    start as float32 and are rounded by each package's own cast)."""
    if dtype in ("float32", "bfloat16"):
        return np.asarray(rng.standard_normal(shape) * 3, np.float32)
    if dtype == "bool":
        return np.asarray(rng.random(shape) < 0.5)
    info = np.iinfo(dtype)
    return np.asarray(rng.integers(info.min, info.max, shape, dtype=dtype,
                                   endpoint=True))


def _leaves(dtype: str, shape, rng):
    """(reference leaf, port leaf as a tensor, port leaf as numpy or None)."""
    a = _values(dtype, shape, rng)
    if dtype == "bfloat16":
        return (jnp.asarray(a, jnp.bfloat16),
                torch.from_numpy(a).to(torch.bfloat16), None)
    return a, torch.from_numpy(a.copy()), a


def _same_file(tmp_path, jtree, ttree, **kw) -> bytes:
    jsave(str(tmp_path / "ref.msgpack"), jtree, **kw)
    save_checkpoint(str(tmp_path / "port.msgpack"), ttree, **kw)
    ref = (tmp_path / "ref.msgpack").read_bytes()
    assert (tmp_path / "port.msgpack").read_bytes() == ref
    return ref


def _assert_exact(t: torch.Tensor, want, dtype: str):
    assert str(t.dtype).removeprefix("torch.") == dtype
    assert t.device.type == "cpu"
    if dtype == "bfloat16":
        want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
        assert torch.equal(t.float(), want)
    else:
        np.testing.assert_array_equal(t.numpy(), np.asarray(want))
        assert tuple(t.shape) == np.asarray(want).shape


# -- byte identity and cross loading ------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_leaves_of_every_dtype_and_shape_are_byte_identical(tmp_path, dtype):
    rng = np.random.default_rng(DTYPES.index(dtype))
    jtree, ttree, ntree = {}, {}, {}
    for i, shape in enumerate(SHAPES):
        j, t, n = _leaves(dtype, shape, rng)
        jtree[f"x{i}"], ttree[f"x{i}"] = j, t
        ntree[f"x{i}"] = t if n is None else n
    ref = _same_file(tmp_path, jtree, ttree, step=3)
    # numpy leaves write the same bytes as tensors
    save_checkpoint(str(tmp_path / "np.msgpack"), ntree, step=3)
    assert (tmp_path / "np.msgpack").read_bytes() == ref

    got, step, meta = load_checkpoint(str(tmp_path / "ref.msgpack"))
    assert step == 3 and meta == {}
    assert list(got) == sorted(jtree)
    for k, want in jtree.items():
        _assert_exact(got[k], want, dtype)
    # the reference reads the port's file as it reads its own
    theirs, _, _ = jload(str(tmp_path / "port.msgpack"))
    own, _, _ = jload(str(tmp_path / "ref.msgpack"))
    for k in jtree:
        assert theirs[k].dtype == own[k].dtype
        np.testing.assert_array_equal(np.asarray(theirs[k]),
                                      np.asarray(own[k]))


def _nested(rng, port: bool):
    """Dicts (keys out of order), lists and tuples, mixed leaves and Python
    scalars — the same tree for each package from the same draws."""
    bf = (rng.standard_normal((2, 3)) * 2).astype(np.float32)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    ids = rng.integers(-5, 5, (4,)).astype(np.int64)
    half = (torch.from_numpy(bf).to(torch.bfloat16) if port
            else jnp.asarray(bf, jnp.bfloat16))
    return {
        "zeta": {"w": w, "b": ids, "a": (half, [np.array(True), 7])},
        "alpha": [{"k": np.zeros((2, 0), np.uint8)}, (1.5, np.int32(-3))],
        "mid": (),
        "empty": {},
    }


@pytest.mark.parametrize("metadata", [
    None,
    {"arm": "decaph", "round": 7, "lr": 0.05, "ok": True, "none": None},
    {"z": {"nested": [1, -2, {"deep": "x" * 40}]}, "a": 2.0 ** 70,
     "published_unix": 1760000000.123456, "neg": -(2 ** 40)},
])
def test_nested_trees_and_metadata_are_byte_identical(tmp_path, metadata):
    _same_file(tmp_path, _nested(np.random.default_rng(1), port=False),
               _nested(np.random.default_rng(1), port=True), step=11,
               metadata=metadata)
    got, step, meta = load_checkpoint(str(tmp_path / "ref.msgpack"))
    assert step == 11 and meta == (metadata or {})
    assert list(got) == ["alpha", "empty", "mid", "zeta"]
    assert isinstance(got["alpha"], list) and isinstance(got["mid"], tuple)
    assert isinstance(got["zeta"]["a"], tuple)
    assert isinstance(got["zeta"]["a"][1], list)
    assert got["zeta"]["b"].dtype == torch.int64          # kept, not int32
    assert got["zeta"]["a"][1][1].dtype == torch.int64    # Python int
    assert got["alpha"][1][0].dtype == torch.float64      # Python float
    assert got["alpha"][1][1].dtype == torch.int32
    assert got["zeta"]["a"][0].dtype == torch.bfloat16


@pytest.mark.parametrize("step", [0, 127, 128, 65535, 65536, 2 ** 32])
def test_steps_are_byte_identical(tmp_path, step):
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    _same_file(tmp_path, tree, tree, step=step,
               metadata={"published_unix": 1.5e9 + step})
    for load in (load_checkpoint, jload):
        assert load(str(tmp_path / "port.msgpack"))[1] == step


# -- the codec against msgpack ---------------------------------------------------


_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-(2 ** 63), max_value=2 ** 64 - 1)
            | st.floats(allow_nan=False) | st.text(max_size=40)
            | st.binary(max_size=40))
_documents = st.recursive(
    _scalars,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.dictionaries(st.text(max_size=8) | st.integers(-99, 99),
                                     inner, max_size=20)),
    max_leaves=40)


def _plain(obj):
    if isinstance(obj, memoryview):
        return bytes(obj)
    if isinstance(obj, list):
        return [_plain(v) for v in obj]
    if isinstance(obj, dict):
        return {_plain(k): _plain(v) for k, v in obj.items()}
    return obj


@settings(max_examples=300, deadline=None)
@given(_documents)
def test_codec_matches_msgpack(doc):
    raw = msgpack.packb(doc, use_bin_type=True)
    assert _msgpack.packb(doc) == raw
    assert _plain(_msgpack.unpackb(raw)) == msgpack.unpackb(
        raw, raw=False, strict_map_key=False)


@settings(max_examples=100, deadline=None)
@given(st.floats(width=32, allow_nan=False))
def test_codec_reads_float32(x):
    raw = msgpack.packb(x, use_bin_type=True, use_single_float=True)
    assert raw[0] == 0xca
    assert _msgpack.unpackb(raw) == msgpack.unpackb(raw)


def _edges():
    """Every length and integer form at its boundaries."""
    ints = [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
            -(2 ** 31), -(2 ** 31) - 1, -(2 ** 63)]
    docs = [ints, [True, False, None, 0.0, -2.5, 1e300]]
    for n in (31, 32, 255, 256, 65535, 65536):
        docs += ["é" * (n // 2) + "x" * (n % 2), b"\x01" * n]
    for n in (15, 16, 65535, 65536):
        docs += [list(range(n)), {str(i): i for i in range(n)}]
    return docs


@pytest.mark.parametrize("doc", _edges(), ids=lambda d: type(d).__name__)
def test_codec_forms_at_their_boundaries(doc):
    raw = msgpack.packb(doc, use_bin_type=True)
    assert _msgpack.packb(doc) == raw
    assert _plain(_msgpack.unpackb(raw)) == msgpack.unpackb(
        raw, raw=False, strict_map_key=False)


@pytest.mark.parametrize("raw", [b"", b"\x92\x01", b"\xc4\x05ab",
                                 b"\xcd\x01", b"\x01\x02", b"\xc1",
                                 b"\xd4\x01\x02", b"\xa3\xff\xfe\xfd"])
def test_codec_refuses_truncated_trailing_and_foreign_bytes(raw):
    with pytest.raises(ValueError):
        _msgpack.unpackb(raw)


def test_codec_refuses_what_it_cannot_hold():
    with pytest.raises(TypeError):
        _msgpack.packb({"x": object()})
    with pytest.raises(OverflowError):
        _msgpack.packb(2 ** 64)


# -- the cases of tests/test_checkpoint.py, on the port -------------------------


def _assert_trees_equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_roundtrip_params_tree(tmp_path):
    tree = {
        "group0": {
            "b": torch.ones((4,), dtype=torch.float32),
            "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        },
        "head": torch.full((2, 2), -1.5, dtype=torch.bfloat16),
    }
    path = str(tmp_path / "ckpt.msgpack")
    save_checkpoint(path, tree, step=7, metadata={"arm": "decaph"})
    got, step, meta = load_checkpoint(path)
    assert step == 7
    assert meta["arm"] == "decaph"
    _assert_trees_equal(tree, got)


def test_roundtrip_kv_cache_shaped_tree(tmp_path):
    cache = {
        "group0": {
            "attn": (
                torch.zeros((2, 3, 16, 4, 8), dtype=torch.bfloat16),   # k
                torch.ones((2, 3, 16, 4, 8), dtype=torch.bfloat16),    # v
            ),
            "pos": torch.arange(3, dtype=torch.int32),
        },
        "group1": {
            "conv": torch.full((2, 3, 4, 32), 0.25),
            "ssm": [torch.zeros((2, 3, 8, 8))],
        },
    }
    path = str(tmp_path / "cache.msgpack")
    save_checkpoint(path, cache, step=0)
    got, _, _ = load_checkpoint(path)
    _assert_trees_equal(cache, got)
    assert isinstance(got["group0"]["attn"], tuple)
    assert isinstance(got["group1"]["ssm"], list)


def test_missing_file_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "nope.msgpack"))


def test_truncated_file_is_corrupt(tmp_path):
    path = str(tmp_path / "ckpt.msgpack")
    save_checkpoint(path, {"w": torch.ones((64, 64))}, step=3)
    raw = open(path, "rb").read()
    torn = str(tmp_path / "torn.msgpack")
    with open(torn, "wb") as f:
        f.write(raw[: len(raw) // 2])
    with pytest.raises(CorruptCheckpointError):
        load_checkpoint(torn)


def test_garbage_file_is_corrupt(tmp_path):
    path = str(tmp_path / "junk.msgpack")
    with open(path, "wb") as f:
        f.write(b"\xde\xad\xbe\xef not a checkpoint")
    with pytest.raises(CorruptCheckpointError):
        load_checkpoint(path)


def test_valid_msgpack_wrong_payload_is_corrupt(tmp_path):
    path = str(tmp_path / "notckpt.msgpack")
    with open(path, "wb") as f:
        f.write(msgpack.packb({"hello": "world"}, use_bin_type=True))
    with pytest.raises(CorruptCheckpointError):
        load_checkpoint(path)


def test_mismatched_array_bytes_are_corrupt(tmp_path):
    path = str(tmp_path / "ok.msgpack")
    save_checkpoint(path, {"w": torch.ones((4, 4))}, step=0)
    payload = msgpack.unpackb(open(path, "rb").read(), raw=False)
    payload["tree"]["__map__"]["w"]["shape"] = [5, 5]
    bad = str(tmp_path / "bad.msgpack")
    with open(bad, "wb") as f:
        f.write(msgpack.packb(payload, use_bin_type=True))
    with pytest.raises(CorruptCheckpointError):
        load_checkpoint(bad)


@pytest.mark.parametrize("fmt", ["repro-ckpt-v2", "", 1])
def test_wrong_format_stamp_is_corrupt(tmp_path, fmt):
    path = str(tmp_path / "ok.msgpack")
    save_checkpoint(path, {"w": torch.ones((2,))}, step=0)
    payload = msgpack.unpackb(open(path, "rb").read(), raw=False)
    payload["format"] = fmt
    bad = str(tmp_path / "other.msgpack")
    with open(bad, "wb") as f:
        f.write(msgpack.packb(payload, use_bin_type=True))
    with pytest.raises(CorruptCheckpointError, match="format"):
        load_checkpoint(bad)
    with pytest.raises(Exception, match="format"):
        jload(bad)   # the reference refuses it the same way


def test_pre_format_files_still_load(tmp_path):
    path = str(tmp_path / "ok.msgpack")
    save_checkpoint(path, {"w": torch.ones((2,))}, step=4)
    payload = msgpack.unpackb(open(path, "rb").read(), raw=False)
    del payload["format"]
    old = str(tmp_path / "old.msgpack")
    with open(old, "wb") as f:
        f.write(msgpack.packb(payload, use_bin_type=True))
    got, step, _ = load_checkpoint(old)
    assert step == 4 and torch.equal(got["w"], torch.ones(2))


def test_atomic_write_leaves_no_temp_droppings(tmp_path):
    path = str(tmp_path / "ckpt.msgpack")
    save_checkpoint(path, {"w": torch.zeros((2,))}, step=1)
    assert sorted(os.listdir(tmp_path)) == ["ckpt.msgpack"]


def test_failed_write_removes_its_temp_file(tmp_path):
    path = str(tmp_path / "ckpt.msgpack")
    with pytest.raises(TypeError):
        save_checkpoint(path, {"w": torch.zeros((2,))}, step=1,
                        metadata={"bad": object()})
    assert os.listdir(tmp_path) == []


def test_overwrite_is_atomic_replacement(tmp_path):
    path = str(tmp_path / "ckpt.msgpack")
    save_checkpoint(path, {"w": torch.zeros((2,))}, step=1)
    save_checkpoint(path, {"w": torch.ones((2,))}, step=2)
    got, step, _ = load_checkpoint(path)
    assert step == 2
    assert torch.equal(got["w"], torch.ones(2))


# -- imports ----------------------------------------------------------------------


def test_checkpoint_and_handoff_import_no_msgpack_ml_dtypes_or_jax():
    code = (
        "import sys\n"
        "import repro_torch.checkpoint, repro_torch.serve.handoff\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('msgpack', 'ml_dtypes', 'jax', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr
