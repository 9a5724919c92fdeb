"""Reader and writer, without dependencies, for the msgpack files that
``flax.serialization.to_bytes`` writes (the JAX package's ``*_net_*.pth``
checkpoints), so that the port loads and saves the same files on a machine
that has neither ``msgpack`` nor ``flax``.

Supported: maps, arrays, str, int, float, bin, and ext type 1 (flax's
ndarray: a packed ``(shape, dtype name, C-order bytes)``). Anything else
raises, including flax's ``__msgpack_chunked_array__`` form of arrays over
1 GiB. The writer sorts map keys and packs every value in its shortest
form, as flax does, so it reproduces flax's bytes.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_MAX_ARRAY_BYTES = 2 ** 30      # flax chunks larger arrays
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0
        self.bin_views = False

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self._array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self._str(b & 0x1f)
        fixed = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
                 0xca: ">f", 0xcb: ">d"}
        if b in fixed:
            return self.unpack(fixed[b])
        sized = {0xd9: ">B", 0xda: ">H", 0xdb: ">I",      # str
                 0xc4: ">B", 0xc5: ">H", 0xc6: ">I",      # bin
                 0xdc: ">H", 0xdd: ">I",                  # array
                 0xde: ">H", 0xdf: ">I",                  # map
                 0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}      # ext
        if b in sized:
            n = self.unpack(sized[b])
            if b in (0xd9, 0xda, 0xdb):
                return self._str(n)
            if b in (0xc4, 0xc5, 0xc6):
                view = self.take(n)
                return view if self.bin_views else bytes(view)
            if b in (0xdc, 0xdd):
                return self._array(n)
            if b in (0xde, 0xdf):
                return self._map(n)
            return self._ext(n)
        if 0xd4 <= b <= 0xd8:
            return self._ext(1 << (b - 0xd4))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _str(self, n):
        return bytes(self.take(n)).decode("utf-8")

    def _array(self, n):
        return [self.read() for _ in range(n)]

    def _map(self, n):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        if _CHUNKED in out:
            raise ValueError("chunked msgpack arrays (over 1 GiB) are not "
                             "supported")
        return out

    def _ext(self, n):
        code = self.unpack(">b")
        payload = self.take(n)
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        inner = _Reader(payload)
        inner.bin_views = True          # the array's bytes are copied once
        shape, dtype, raw = inner.read()
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def loads(data):
    """msgpack bytes -> nested dict of numpy arrays (and Python scalars)."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def _header(out, n, fix_base, fix_max, codes):
    if n <= fix_max:
        out.append(fix_base | n)
        return
    for code, fmt in codes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object too large ({n})")


def _pack(obj, out):
    if isinstance(obj, dict):
        _header(out, len(obj), 0x80, 15, ((0xde, ">H"), (0xdf, ">I")))
        for k in sorted(obj):
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str, got {type(k)}")
            _pack(k, out)
            _pack(obj[k], out)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 15, ((0xdc, ">H"), (0xdd, ">I")))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _header(out, len(raw), 0xa0, 31,
                ((0xd9, ">B"), (0xda, ">H"), (0xdb, ">I")))
        out += raw
    elif isinstance(obj, bytes):
        _header(out, len(obj), 0, -1,
                ((0xc4, ">B"), (0xc5, ">H"), (0xc6, ">I")))
        out += obj
    elif isinstance(obj, bool) or obj is None:
        raise TypeError(f"unsupported value {obj!r}")
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xcb)
        out += struct.pack(">d", obj)
    elif isinstance(obj, np.ndarray):
        _pack_ndarray(obj, out)
    else:
        raise TypeError(f"unsupported type {type(obj)}")


def _pack_int(x, out):
    if 0 <= x <= 0x7f:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x & 0xff)
    elif x > 0:
        for code, fmt in ((0xcc, ">B"), (0xcd, ">H"), (0xce, ">I"),
                          (0xcf, ">Q")):
            if x < 1 << (8 * struct.calcsize(fmt)):
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise ValueError(f"int too large for msgpack: {x}")
    else:
        for code, fmt in ((0xd0, ">b"), (0xd1, ">h"), (0xd2, ">i"),
                          (0xd3, ">q")):
            if x >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise ValueError(f"int too small for msgpack: {x}")


def _pack_ndarray(arr, out):
    if arr.nbytes > _MAX_ARRAY_BYTES:
        raise ValueError("arrays over 1 GiB are chunked by flax; not "
                         "supported")
    data = np.ascontiguousarray(arr).reshape(-1)      # 0-D arrays too
    # the payload is [shape, dtype name, bin of the C-order bytes]; its
    # head is packed here and the bytes are handed over uncopied
    head = bytearray()
    _header(head, 3, 0x90, 15, ((0xdc, ">H"), (0xdd, ">I")))
    _pack([int(s) for s in arr.shape], head)
    _pack(arr.dtype.name, head)
    _header(head, data.nbytes, 0, -1,
            ((0xc4, ">B"), (0xc5, ">H"), (0xc6, ">I")))
    n = len(head) + data.nbytes
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _header(out, n, 0, -1, ((0xc7, ">B"), (0xc8, ">H"), (0xc9, ">I")))
    out += struct.pack(">b", _EXT_NDARRAY)
    out += head
    out.raw(memoryview(data.view(np.uint8)))


class _Chunks:
    """The packer's output: small values gather in a bytearray, array
    bytes are kept as views of the arrays, in order."""

    def __init__(self):
        self.parts = []
        self.buf = bytearray()

    def append(self, byte):
        self.buf.append(byte)

    def __iadd__(self, data):
        self.buf += data
        return self

    def raw(self, view):
        if self.buf:
            self.parts.append(self.buf)
            self.buf = bytearray()
        self.parts.append(view)

    def done(self):
        if self.buf:
            self.parts.append(self.buf)
            self.buf = bytearray()
        return self.parts


def _packed(tree):
    out = _Chunks()
    _pack(tree, out)
    return out.done()


def dumps(tree):
    """Nested dict of numpy arrays -> msgpack bytes (flax's layout)."""
    return b"".join(_packed(tree))


def load(path):
    with open(path, "rb") as f:
        return loads(f.read())


def save(path, tree):
    """``dumps(tree)`` written to ``path``, its arrays' bytes straight from
    the arrays."""
    parts = _packed(tree)
    with open(path, "wb") as f:
        for part in parts:
            f.write(part)
