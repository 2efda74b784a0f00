"""
Self-contained Kaldi binary ark/scp matrix IO (a copy of
``lidbox_tpu.features.kaldi_io``: numpy only).

The reference delegated Kaldi interop to the ``kaldiio`` package
(reference: lidbox/features/__init__.py:113-118, lidbox/data/steps.py:
1002-1018, 1058-1074). This module implements the subset the toolkit
actually uses — binary float/double matrices in ark archives with scp
index files — directly, so Kaldi pipelines work with zero extra
dependencies. ``kaldiio`` (when installed) is still preferred by the
callers for exotic variants (compressed matrices, gzipped pipes).

Format notes (Kaldi src/util/kaldi-io.cc, kaldi-matrix.cc):
- ark entry:  ``<key> \\0B<Token> \\x04<int32 rows>\\x04<int32 cols><data>``
  where Token is ``FM`` (float32) or ``DM`` (float64) and data is
  row-major little-endian.
- scp line:   ``<key> <ark_path>:<offset>`` with offset pointing at the
  ``\\0B`` binary marker of that entry.
"""
import os
from collections.abc import Mapping as _Mapping

import numpy as np

_BINARY_MARKER = b"\0B"
_TOKENS = {b"FM": np.dtype("<f4"), b"DM": np.dtype("<f8")}
_REV_TOKEN = {np.dtype(np.float32): b"FM", np.dtype(np.float64): b"DM"}


def _read_token(f):
    tok = b""
    while True:
        c = f.read(1)
        if not c or c == b" ":
            break
        tok += c
    return tok


def _read_int32(f):
    size = f.read(1)
    if size != b"\x04":
        raise ValueError(f"expected int32 size marker, got {size!r} "
                         "(compressed or non-matrix Kaldi data is not "
                         "supported by the built-in reader; install kaldiio)")
    return int(np.frombuffer(f.read(4), "<i4")[0])


def _read_matrix(f):
    marker = f.read(2)
    if marker != _BINARY_MARKER:
        raise ValueError("text-mode Kaldi archives are not supported "
                         f"(marker {marker!r})")
    tok = _read_token(f)
    if tok not in _TOKENS:
        raise ValueError(f"unsupported Kaldi matrix token {tok!r} "
                         "(compressed 'CM' needs kaldiio)")
    dtype = _TOKENS[tok]
    rows = _read_int32(f)
    cols = _read_int32(f)
    data = np.frombuffer(f.read(rows * cols * dtype.itemsize), dtype)
    # .copy(): frombuffer views are read-only; callers own a writable array
    return data.reshape(rows, cols).copy()


def read_mat(rxspecifier):
    """Load one matrix from ``"archive.ark:offset"`` (scp entry form) or
    from a bare ark path holding a single entry.

    A spec only parses as the offset form when the prefix is an existing
    file and the spec itself is not — a bare ark named e.g. ``feats:2``
    opens as a plain path instead of being misread as offset 2 into
    ``feats``."""
    spec = str(rxspecifier)
    path, sep, offset = spec.rpartition(":")
    if (sep and offset.isdigit() and not os.path.isfile(spec)
            and os.path.isfile(path)):
        with open(path, "rb") as f:
            f.seek(int(offset))
            return _read_matrix(f)
    with open(spec, "rb") as f:
        _read_key(f)
        return _read_matrix(f)


def _read_key(f):
    key = b""
    while True:
        c = f.read(1)
        if not c:
            return None
        if c == b" ":
            return key.decode()
        key += c


def read_ark(path):
    """Iterate (key, matrix) over a binary ark archive."""
    with open(path, "rb") as f:
        while True:
            key = _read_key(f)
            if key is None:
                return
            yield key, _read_matrix(f)


def read_scp(path):
    """scp file -> list of (key, rxspecifier)."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, _, rx = line.partition(" ")
            out.append((key, rx))
    return out


class _LazyScp(_Mapping):
    """Mapping resolving rxspecifiers to matrices on EVERY access path —
    ``[]``, ``.get``, ``.items``, ``.values``, iteration — so no raw
    specifier strings leak through any part of the mapping API."""

    def __init__(self, entries):
        self._rx = dict(entries)

    def __getitem__(self, key):
        return read_mat(self._rx[key])

    def __iter__(self):
        return iter(self._rx)

    def __len__(self):
        return len(self._rx)

    def __repr__(self):
        return f"_LazyScp({len(self._rx)} entries)"


def load_scp(path):
    """scp file -> lazy {key: matrix} mapping (matrices load per access)."""
    return _LazyScp(read_scp(path))


class MatrixWriter:
    """Write float32/float64 matrices to ``ark`` (+ optional ``scp``
    index), kaldiio.WriteHelper-compatible call shape::

        with MatrixWriter("ark,scp:feats.ark,feats.scp") as w:
            w("utt1", mat)
    """

    def __init__(self, wxspecifier):
        spec = str(wxspecifier)
        kinds, _, paths = spec.partition(":")
        kinds = kinds.split(",")
        paths = paths.split(",")
        if len(kinds) != len(paths) or not set(kinds) <= {"ark", "scp"}:
            raise ValueError(f"unsupported write specifier {spec!r}")
        targets = dict(zip(kinds, paths))
        if "ark" not in targets:
            raise ValueError("write specifier needs an ark target")
        self.ark_path = targets["ark"]
        self._ark = open(self.ark_path, "wb")
        self._scp = None
        if "scp" in targets:
            try:
                self._scp = open(targets["scp"], "w", encoding="utf-8")
            except OSError:
                self._ark.close()
                raise

    def __call__(self, key, matrix):
        matrix = np.asarray(matrix)
        if matrix.ndim != 2:
            raise ValueError(f"Kaldi matrix writer needs rank-2, got "
                             f"{matrix.shape}")
        if matrix.dtype not in _REV_TOKEN:
            matrix = matrix.astype(np.float32)
        tok = _REV_TOKEN[matrix.dtype]
        self._ark.write(key.encode() + b" ")
        offset = self._ark.tell()
        self._ark.write(_BINARY_MARKER + tok + b" ")
        for dim in matrix.shape:
            self._ark.write(b"\x04" + np.int32(dim).tobytes())
        self._ark.write(np.ascontiguousarray(matrix).tobytes())
        if self._scp is not None:
            self._scp.write(f"{key} {os.path.abspath(self.ark_path)}:"
                            f"{offset}\n")

    def close(self):
        self._ark.close()
        if self._scp is not None:
            self._scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
