"""The subset of msgpack that ``repro-ckpt-v1`` files use, in plain Python.

The port does not depend on the ``msgpack`` package.  ``pack(obj, write)``
emits the bytes ``msgpack.packb(obj, use_bin_type=True)`` gives, one piece
at a time through ``write``: a ``bin`` payload (``bytes`` or a
``memoryview``) goes to ``write`` as it is, never joined into a larger
``bytes``, so a file of gigabytes is written without a second copy in
memory.  An object of another type is first passed to ``default`` (as
msgpack's ``default`` hook), which returns something packable.
``unpackb(data)`` decodes one document; a ``bin`` comes back as a
read-only ``memoryview`` slice of ``data``, not a copy.

Forms: nil; bool; int in its smallest form (positive fixint, uint8–64,
negative fixint, int8–64); float as float64 (float32 and float64 read);
str as fixstr or str8/16/32; bin8/16/32; array and map as fix, 16 and 32.
Anything else raises ``TypeError`` when packing and ``ValueError`` when
unpacking, as does a truncated document or one with bytes after its end.
"""

from __future__ import annotations

import struct
from typing import Any, Callable

__all__ = ["pack", "packb", "unpackb"]


def _int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return bytes((x,))
    if -0x20 <= x < 0:
        return struct.pack(">b", x)
    if x > 0:
        for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if x < top:
                return bytes((code,)) + struct.pack(fmt, x)
    else:
        for code, fmt, low in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                               (0xd2, ">i", 1 << 31), (0xd3, ">q", 1 << 63)):
            if x >= -low:
                return bytes((code,)) + struct.pack(fmt, x)
    raise OverflowError(f"integer {x} does not fit msgpack's 64 bits")


def _head(n: int, fix: int | None, fix_max: int, codes: tuple) -> bytes:
    """The header of a str, bin, array or map of length ``n``: the fix form
    below ``fix_max`` (when the kind has one), else the 8-, 16- or 32-bit
    length form (``codes``, None where the kind has no such form)."""
    if fix is not None and n < fix_max:
        return bytes((fix | n,))
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"length {n} does not fit msgpack's 32 bits")


def pack(obj: Any, write: Callable[[Any], Any],
         default: Callable[[Any], Any] | None = None) -> None:
    """Write ``obj`` as msgpack through ``write``, piece by piece."""
    if obj is None:
        write(b"\xc0")
    elif isinstance(obj, bool):
        write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        write(_int(obj))
    elif isinstance(obj, float):
        write(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        write(_head(len(raw), 0xa0, 32, (0xd9, 0xda, 0xdb)))
        write(raw)
    elif isinstance(obj, (bytes, memoryview)):
        n = obj.nbytes if isinstance(obj, memoryview) else len(obj)
        write(_head(n, None, 0, (0xc4, 0xc5, 0xc6)))
        write(obj)
    elif isinstance(obj, (list, tuple)):
        write(_head(len(obj), 0x90, 16, (None, 0xdc, 0xdd)))
        for item in obj:
            pack(item, write, default)
    elif isinstance(obj, dict):
        write(_head(len(obj), 0x80, 16, (None, 0xde, 0xdf)))
        for k, v in obj.items():
            pack(k, write, default)
            pack(v, write, default)
    elif default is not None:
        pack(default(obj), write, default)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} as msgpack")


def packb(obj: Any, default: Callable[[Any], Any] | None = None) -> bytes:
    """``obj`` as one msgpack ``bytes`` (for small documents)."""
    pieces: list = []
    pack(obj, pieces.append, default)
    return b"".join(pieces)


# lead byte -> (struct format of the value or length that follows, kind)
_FIXED = {
    0xc0: (None, "nil"), 0xc2: (None, "false"), 0xc3: (None, "true"),
    0xca: (">f", "float"), 0xcb: (">d", "float"),
    0xcc: (">B", "int"), 0xcd: (">H", "int"), 0xce: (">I", "int"),
    0xcf: (">Q", "int"),
    0xd0: (">b", "int"), 0xd1: (">h", "int"), 0xd2: (">i", "int"),
    0xd3: (">q", "int"),
    0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
    0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
    0xdc: (">H", "array"), 0xdd: (">I", "array"),
    0xde: (">H", "map"), 0xdf: (">I", "map"),
}
_CONSTANTS = {"nil": None, "false": False, "true": True}


def _decode(buf: memoryview, i: int) -> tuple[Any, int]:
    """The object that starts at ``buf[i]``, and the index after it."""
    if i >= len(buf):
        raise ValueError("truncated msgpack document")
    lead = buf[i]
    i += 1
    if lead < 0x80:
        return lead, i
    if lead >= 0xe0:
        return lead - 0x100, i
    if 0xa0 <= lead < 0xc0:
        kind, n = "str", lead & 0x1f
    elif 0x90 <= lead < 0xa0:
        kind, n = "array", lead & 0x0f
    elif lead < 0x90:
        kind, n = "map", lead & 0x0f
    elif lead in _FIXED:
        fmt, kind = _FIXED[lead]
        if fmt is None:
            return _CONSTANTS[kind], i
        size = struct.calcsize(fmt)
        if i + size > len(buf):
            raise ValueError("truncated msgpack document")
        (n,) = struct.unpack_from(fmt, buf, i)
        i += size
        if kind in ("int", "float"):
            return n, i
    else:
        raise ValueError(f"unsupported msgpack type byte 0x{lead:02x}")
    if kind == "array":
        out = []
        for _ in range(n):
            item, i = _decode(buf, i)
            out.append(item)
        return out, i
    if kind == "map":
        out = {}
        for _ in range(n):
            k, i = _decode(buf, i)
            out[k], i = _decode(buf, i)
        return out, i
    if i + n > len(buf):
        raise ValueError("truncated msgpack document")
    piece = buf[i:i + n]
    return (str(piece, "utf-8") if kind == "str" else piece), i + n


def unpackb(data: bytes) -> Any:
    """Decode the one msgpack document that ``data`` holds."""
    buf = memoryview(data)
    obj, end = _decode(buf, 0)
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} bytes after the msgpack document")
    return obj
