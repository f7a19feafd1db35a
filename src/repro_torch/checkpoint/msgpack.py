"""The subset of msgpack that the checkpoint format uses, written and read
as a stream.

nil, bool, int, float (64-bit), str, bin, array and map, each with the
smallest header msgpack's own packer picks, so that ``pack`` gives the
bytes of ``msgpack.packb(obj, use_bin_type=True)``: positive ints as fixint
or uint 8/16/32/64, negative ones as negative fixint or int 8/16/32/64,
every Python float as float 64, str as fixstr/str 8/16/32, bytes as bin
8/16/32, lists and tuples as arrays, dicts as maps in their own order. A
``bin`` body may be written from (and read into) a buffer of its own, so a
large leaf never becomes one Python ``bytes`` object. The reader also takes
float 32, which msgpack writes for ``use_single_float``.
"""
from __future__ import annotations

import struct
from typing import Any, BinaryIO, Callable, Optional


def _header(small_tag: int, small_max: int, tags: tuple, n: int) -> bytes:
    """A length header: ``small_tag | n`` when ``n <= small_max`` (a
    fix- form; ``small_max < 0`` for bin, which has none), else the first of
    the (tag, struct format, max) forms that holds ``n``."""
    if n <= small_max:
        return bytes([small_tag | n])
    for tag, fmt, top in tags:
        if n <= top:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} is too large")


_U8, _U16, _U32 = 0xFF, 0xFFFF, 0xFFFFFFFF


def str_header(n: int) -> bytes:
    return _header(0xA0, 31, ((0xD9, ">B", _U8), (0xDA, ">H", _U16),
                              (0xDB, ">I", _U32)), n)


def bin_header(n: int) -> bytes:
    return _header(0, -1, ((0xC4, ">B", _U8), (0xC5, ">H", _U16),
                           (0xC6, ">I", _U32)), n)


def array_header(n: int) -> bytes:
    return _header(0x90, 15, ((0xDC, ">H", _U16), (0xDD, ">I", _U32)), n)


def map_header(n: int) -> bytes:
    return _header(0x80, 15, ((0xDE, ">H", _U16), (0xDF, ">I", _U32)), n)


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v > 0:
        for tag, fmt, top in ((0xCC, ">B", _U8), (0xCD, ">H", _U16),
                              (0xCE, ">I", _U32),
                              (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                return bytes([tag]) + struct.pack(fmt, v)
    else:
        for tag, fmt, lo in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                             (0xD2, ">i", -0x80000000),
                             (0xD3, ">q", -0x8000000000000000)):
            if v >= lo:
                return bytes([tag]) + struct.pack(fmt, v)
    raise OverflowError(f"msgpack: integer {v} does not fit 64 bits")


def pack(obj: Any, write: Callable[[bytes], Any]) -> None:
    """Write ``obj`` through ``write``."""
    if obj is None:
        write(b"\xc0")
    elif obj is True or obj is False:
        write(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        write(_int(obj))
    elif type(obj) is float:
        write(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        data = obj.encode("utf-8")
        write(str_header(len(data)))
        write(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = memoryview(obj).cast("B")
        write(bin_header(data.nbytes))
        write(data)
    elif isinstance(obj, (list, tuple)):
        write(array_header(len(obj)))
        for x in obj:
            pack(x, write)
    elif isinstance(obj, dict):
        write(map_header(len(obj)))
        for k, v in obj.items():
            pack(k, write)
            pack(v, write)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    out = []
    pack(obj, out.append)
    return b"".join(bytes(x) for x in out)


class Reader:
    """Reads msgpack objects from a binary file. ``read(bin_into=)`` reads a
    ``bin`` body by calling ``bin_into(n)`` for a writable buffer of ``n``
    bytes, which it fills and returns; ``skip=True`` skips bin bodies."""

    def __init__(self, f: BinaryIO):
        self.f = f

    def _take(self, n: int) -> bytes:
        data = self.f.read(n)
        if len(data) != n:
            raise ValueError("msgpack: unexpected end of data")
        return data

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def map_len(self) -> int:
        b = self._take(1)[0]
        if b & 0xF0 == 0x80:
            return b & 0x0F
        if b in (0xDE, 0xDF):
            return self._unpack(">H" if b == 0xDE else ">I")
        raise ValueError(f"msgpack: expected a map, got tag {b:#x}")

    def read(self, bin_into: Optional[Callable[[int], Any]] = None,
             skip: bool = False) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b & 0xE0 == 0xA0 or b in (0xD9, 0xDA, 0xDB):
            n = b & 0x1F if b & 0xE0 == 0xA0 else self._unpack(
                {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return self._take(n).decode("utf-8")
        if b & 0xF0 == 0x90 or b in (0xDC, 0xDD):
            n = b & 0x0F if b & 0xF0 == 0x90 else self._unpack(
                ">H" if b == 0xDC else ">I")
            return [self.read(bin_into, skip) for _ in range(n)]
        if b & 0xF0 == 0x80 or b in (0xDE, 0xDF):
            n = b & 0x0F if b & 0xF0 == 0x80 else self._unpack(
                ">H" if b == 0xDE else ">I")
            out = {}
            for _ in range(n):
                k = self.read(bin_into, skip)
                out[k] = self.read(bin_into, skip)
            return out
        if b in (0xC4, 0xC5, 0xC6):
            n = self._unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            if skip:
                self.f.seek(n, 1)
                return None
            if bin_into is None:
                return self._take(n)
            buf = bin_into(n)
            if self.f.readinto(memoryview(buf).cast("B")) != n:
                raise ValueError("msgpack: unexpected end of data")
            return buf
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        fmts = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fmts:
            return self._unpack(fmts[b])
        raise ValueError(f"msgpack: unsupported tag {b:#x}")
