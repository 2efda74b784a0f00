"""
msgpack state dicts in flax's format, in pure Python (counterpart of
``flax.serialization`` as the JAX package uses it for checkpoints and
deployment weights: ``to_bytes``, ``msgpack_serialize`` and
``msgpack_restore``).

A state dict is a tree of dicts with string keys, lists and tuples (both
written as msgpack arrays), and leaves: numpy arrays, numpy scalars, Python
scalars, strings, bytes and None. Arrays are msgpack ext type 1 holding the
msgpack array ``(shape, dtype name, C-order bytes)``; numpy scalars are ext
type 3 with the same body; Python complex numbers are ext type 2 holding
``(real, imag)``. Every value takes the smallest msgpack encoding, so
``packb`` writes the bytes flax writes for the same tree, and ``unpackb``
reads what flax writes, including arrays over 1 GiB that flax splits into
chunks. The standard library and numpy only: the card's machine has no
msgpack and no flax.
"""
import struct

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
# flax splits larger array leaves into chunks (msgpack caps a bin at 4 GiB)
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"


class _Writer:
    def __init__(self):
        self.parts = []

    def _sized(self, n, fixed, fix_max, codes):
        """The header of a sized type: a fix code when ``n`` fits, else
        the first of the 8/16/32-bit codes that holds it (``codes`` maps
        each to its length format)."""
        if fixed is not None and n <= fix_max:
            self.parts.append(bytes([fixed | n]))
            return
        for code, fmt, limit in codes:
            if n <= limit:
                self.parts.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise ValueError(f"object of size {n} is too large for msgpack")

    def _int(self, v):
        out = self.parts
        if 0 <= v <= 0x7F:
            out.append(bytes([v]))
        elif -32 <= v < 0:
            out.append(struct.pack(">b", v))
        elif v > 0:
            for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                     (0xCE, ">I", 0xFFFFFFFF),
                                     (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
                if v <= limit:
                    out.append(bytes([code]) + struct.pack(fmt, v))
                    return
            raise OverflowError(f"integer {v} too large for msgpack")
        else:
            for code, fmt, limit in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                     (0xD2, ">i", -0x80000000),
                                     (0xD3, ">q", -0x8000000000000000)):
                if v >= limit:
                    out.append(bytes([code]) + struct.pack(fmt, v))
                    return
            raise OverflowError(f"integer {v} too small for msgpack")

    def _str(self, s):
        data = s.encode("utf-8")
        self._sized(len(data), 0xA0, 31, ((0xD9, ">B", 0xFF),
                                          (0xDA, ">H", 0xFFFF),
                                          (0xDB, ">I", 0xFFFFFFFF)))
        self.parts.append(data)

    def _bin(self, data):
        self._sized(len(data), None, 0, ((0xC4, ">B", 0xFF),
                                         (0xC5, ">H", 0xFFFF),
                                         (0xC6, ">I", 0xFFFFFFFF)))
        self.parts.append(data)

    def _ext(self, code, data):
        n = len(data)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            self.parts.append(bytes([fixext[n], code]))
        else:
            self._sized(n, None, 0, ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                                     (0xC9, ">I", 0xFFFFFFFF)))
            self.parts.append(bytes([code]))
        self.parts.append(data)

    def write(self, obj):
        if obj is None:
            self.parts.append(b"\xc0")
        elif obj is True:
            self.parts.append(b"\xc3")
        elif obj is False:
            self.parts.append(b"\xc2")
        elif type(obj) is int:
            self._int(obj)
        elif type(obj) is float:
            self.parts.append(b"\xcb" + struct.pack(">d", obj))
        elif type(obj) is str:
            self._str(obj)
        elif type(obj) in (bytes, bytearray):
            self._bin(bytes(obj))
        elif type(obj) is dict:
            self._sized(len(obj), 0x80, 15, ((0xDE, ">H", 0xFFFF),
                                             (0xDF, ">I", 0xFFFFFFFF)))
            for k, v in obj.items():
                self.write(k)
                self.write(v)
        elif type(obj) in (list, tuple):
            self._sized(len(obj), 0x90, 15, ((0xDC, ">H", 0xFFFF),
                                              (0xDD, ">I", 0xFFFFFFFF)))
            for v in obj:
                self.write(v)
        elif isinstance(obj, np.ndarray):
            self._ext(EXT_NDARRAY, _ndarray_to_bytes(obj))
        elif isinstance(obj, np.generic):
            self._ext(EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(obj)))
        elif type(obj) is complex:
            self._ext(EXT_COMPLEX, packb((obj.real, obj.imag)))
        else:
            raise TypeError(f"cannot serialize {type(obj).__name__}")


def _ndarray_to_bytes(arr):
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return packb((tuple(int(d) for d in arr.shape), arr.dtype.name,
                  arr.tobytes("C")))


def _ndarray_from_bytes(data):
    shape, dtype_name, buffer = unpackb(data, raw=True)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode("ascii")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(
        shape, order="C")


class _Reader:
    def __init__(self, data, raw=False, ext_hook=None):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw
        self.ext_hook = ext_hook

    def _take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def _str(self, n):
        data = bytes(self._take(n))
        return data if self.raw else data.decode("utf-8")

    def _ext(self, n):
        code = self._unpack(">b")
        data = bytes(self._take(n))
        if self.ext_hook is None:
            raise ValueError(f"msgpack ext type {code} without an ext hook")
        return self.ext_hook(code, data)

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            value = self._unpack(ints[b])
            return float(value) if b == 0xCA else value
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                 0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in sizes:
            n = self._unpack(sizes[b])
            if b in (0xC4, 0xC5, 0xC6):
                return bytes(self._take(n))
            if b in (0xD9, 0xDA, 0xDB):
                return self._str(n)
            if b in (0xDC, 0xDD):
                return self._array(n)
            if b in (0xDE, 0xDF):
                return self._map(n)
            return self._ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")

    def _array(self, n):
        return [self.read() for _ in range(n)]

    def _map(self, n):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def packb(obj):
    """msgpack bytes of ``obj`` (strings as str, bytes as bin)."""
    writer = _Writer()
    writer.write(obj)
    return b"".join(writer.parts)


def unpackb(data, raw=False, ext_hook=None):
    """The object of msgpack ``data``; arrays come back as lists. ``raw``
    keeps str values as bytes."""
    reader = _Reader(data, raw=raw, ext_hook=ext_hook)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def _ext_unpack(code, data):
    if code == EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == EXT_COMPLEX:
        real, imag = unpackb(data)
        return complex(real, imag)
    if code == EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    raise ValueError(f"unknown msgpack ext type {code}")


def to_state_dict(tree):
    """flax's ``to_state_dict`` for plain trees: lists, tuples and named
    tuples become dicts keyed ``"0"``, ``"1"``, ... or by field name, dict
    keys become strings, and leaves stay as they are (tensors as numpy)."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: to_state_dict(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    if hasattr(tree, "detach") and hasattr(tree, "numpy"):  # a tensor
        return tree.detach().cpu().numpy()
    return tree


def _chunk_leaves(tree):
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        size = max(1, MAX_CHUNK_SIZE // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
        return {_CHUNKED: True,
                "shape": {str(i): d for i, d in enumerate(tree.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def _unchunk_leaves(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk_leaves(v) for k, v in tree.items()}
    return tree


def msgpack_serialize(state_dict):
    """Bytes of a state dict (``flax.serialization.msgpack_serialize``)."""
    return packb(_chunk_leaves(state_dict))


def msgpack_restore(data):
    """The state dict of msgpack bytes (``flax.serialization
    .msgpack_restore``): nested dicts with numpy array leaves."""
    return _unchunk_leaves(unpackb(data, ext_hook=_ext_unpack))


def to_bytes(tree):
    """``flax.serialization.to_bytes`` of a plain tree."""
    return msgpack_serialize(to_state_dict(tree))
