"""
Orbax checkpoint directories, read and written without Orbax (the layout
of the JAX package's ``OrbaxCheckpointer``, a ``StandardCheckpointHandler``
PyTree checkpoint).

A directory holds ``_METADATA`` (JSON: every leaf's key path, with the
kind of each key, and its value type), ``_CHECKPOINT_METADATA``,
``array_metadatas/process_0``, Orbax's ``_sharding`` (each array's
device, which this reader does not need) and the arrays, each a zarr v2
array named by its key path joined with dots (``params.w/.zarray`` plus
chunks ``params.w/0.0``). The arrays live in one of two stores:

- OCDBT (``"use_ocdbt": true``, Orbax's default): a copy-on-write B+tree
  whose root manifest is ``manifest.ocdbt`` (the processes' trees merged
  into one); its nodes and out-of-line values sit in data files under
  ``d/`` and ``ocdbt.process_<n>/d/``.
  Every manifest and node is a header (magic, length, version,
  compression), a zstd frame and a CRC-32C. The chunks are zstd
  compressed.
- plain files (``"use_ocdbt": false``): ``<param name>/.zarray`` and its
  chunk files in the directory itself.

``read_checkpoint`` reads both, with the zstd decoder and CRC-32C of
``native/zstd.cpp``. ``write_checkpoint`` writes the plain layout with
uncompressed chunks, which Orbax reads back; so the port needs no zstd or
OCDBT writer. It writes no ``_sharding``: a device named there binds
Orbax's raw restore to a host that has that device (it raises "Device
... was not found" elsewhere), while without it Orbax places the arrays
on its default device.
"""
import concurrent.futures
import itertools
import json
import math
import os
import struct
import time

import numpy as np
import torch

from lidbox_tpu_torch.native import zstd

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
ARRAY_METADATA = os.path.join("array_metadatas", "process_0")
MANIFEST = "manifest.ocdbt"
MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
KEY_SEQUENCE, KEY_DICT = 1, 2  # key_type in _METADATA
ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")
EMPTY_VALUES = {"None": lambda: None, "Dict": dict, "List": list,
                "Tuple": tuple}
READ_WORKERS = min(8, os.cpu_count() or 1)  # threads that decode leaves


# ---------------------------------------------------------------- OCDBT

class _Cursor:
    """Varints, fixed-width fields and byte runs of one decoded node."""

    def __init__(self, data, where):
        self.data, self.pos, self.where = data, 0, where

    def _need(self, n):
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.where}: truncated OCDBT record")

    def varint(self):
        value = shift = 0
        while True:
            self._need(1)
            byte = self.data[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            shift += 7
            if byte < 0x80:
                return value

    def varints(self, n):
        return [self.varint() for _ in range(n)]

    def byte(self):
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n):
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def fixed(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def end(self):
        if self.pos != len(self.data):
            raise ValueError(f"{self.where}: {len(self.data) - self.pos} "
                             "bytes left after the OCDBT record")


class OcdbtStore:
    """The keys and values of an OCDBT store, as of its latest version.

    ``root`` is the directory of ``manifest.ocdbt``; the data files that
    the nodes name are relative to it. The whole B+tree is walked once,
    every node's CRC-32C checked; values stay where they are (inline in a
    node or a range of a data file) until ``get`` asks for them."""

    def __init__(self, root):
        self.root = root
        self._files = {}
        self._values = {}
        manifest = self._file(MANIFEST)
        body = _Cursor(self._unwrap(manifest, MANIFEST_MAGIC, MANIFEST),
                       MANIFEST)
        body.take(16)  # uuid
        kind = body.varint()
        if kind != 0:
            raise ValueError(f"{root}: numbered OCDBT manifests (kind "
                             f"{kind}) are not supported")
        body.varint()  # max_inline_value_bytes
        body.varint()  # max_decoded_node_bytes
        body.byte()  # version_tree_arity_log2
        if body.varint() == 1:
            body.fixed("<i")  # zstd level
        files = self._data_files(body)
        n = body.varint()
        generation = body.varints(n)
        height = [body.byte() for _ in range(n)]
        file_id, offset, length = (body.varints(n), body.varints(n),
                                   body.varints(n))
        num_keys = body.varints(n)
        # the rest (tree and value byte counts, commit times, older
        # version-tree nodes) is not needed for the latest version
        if n == 0:
            return
        last = max(range(n), key=generation.__getitem__)
        if num_keys[last]:
            self._walk(files[file_id[last]], offset[last], length[last],
                       height[last], b"")

    def _file(self, name):
        if name not in self._files:
            with open(os.path.join(self.root, name), "rb") as f:
                self._files[name] = f.read()
        return self._files[name]

    def _range(self, name, offset, length):
        data = self._file(name)
        if offset + length > len(data):
            raise ValueError(f"{self.root}/{name}: a reference reaches past "
                             "the end of the file")
        return memoryview(data)[offset:offset + length]

    @staticmethod
    def _unwrap(raw, magic, where):
        """A manifest's or node's body: header and CRC-32C checked, the
        zstd frame decoded."""
        if len(raw) < 18:
            raise ValueError(f"{where}: too short for an OCDBT record")
        got_magic, length = struct.unpack(">I", raw[:4])[0], \
            struct.unpack("<Q", raw[4:12])[0]
        if got_magic != magic:
            raise ValueError(f"{where}: bad OCDBT magic {got_magic:#010x}")
        if length != len(raw):
            raise ValueError(f"{where}: OCDBT length {length} != {len(raw)}")
        want = struct.unpack("<I", raw[-4:])[0]
        if zstd.crc32c(raw[:-4]) != want:
            raise ValueError(f"{where}: OCDBT CRC-32C mismatch")
        head = _Cursor(bytes(raw[12:-4]), where)
        version, compression = head.varint(), head.varint()
        if version != 0 or compression not in (0, 1):
            raise ValueError(f"{where}: OCDBT version {version}, "
                             f"compression {compression} not supported")
        body = head.data[head.pos:]
        return zstd.decompress(body) if compression == 1 else body

    @staticmethod
    def _data_files(c):
        """A data file table: paths prefix-compressed against the previous
        one (the base path / relative path split does not matter here)."""
        n = c.varint()
        prefix = [0] + c.varints(n - 1) if n else []
        suffix = c.varints(n)
        c.varints(n)  # base path lengths
        paths, previous = [], b""
        for p, s in zip(prefix, suffix):
            previous = previous[:p] + c.take(s)
            paths.append(previous.decode())
        return paths

    def _walk(self, name, offset, length, height, prefix):
        where = f"{self.root}/{name}@{offset}"
        c = _Cursor(self._unwrap(self._range(name, offset, length),
                                 NODE_MAGIC, where), where)
        if c.byte() != height:
            raise ValueError(f"{where}: node height differs from its "
                             "reference's")
        files = self._data_files(c)
        n = c.varint()
        key_prefix = [0] + c.varints(n - 1) if n else []
        key_suffix = c.varints(n)
        common = c.varints(n) if height > 0 else None
        keys, previous = [], b""
        for p, s in zip(key_prefix, key_suffix):
            previous = previous[:p] + c.take(s)
            keys.append(previous)
        if height > 0:  # children: their keys drop the common prefix
            child = [c.varints(n) for _ in range(3)]  # file, offset, length
            for _ in range(3):  # num_keys, tree bytes, value bytes
                c.varints(n)
            c.end()
            for i, key in enumerate(keys):
                self._walk(files[child[0][i]], child[1][i], child[2][i],
                           height - 1, prefix + key[:common[i]])
            return
        lengths = c.varints(n)
        kinds = [c.byte() for _ in range(n)]
        out_of_line = [i for i, k in enumerate(kinds) if k == 1]
        if any(k > 1 for k in kinds):
            raise ValueError(f"{where}: unknown OCDBT value kind")
        file_ids = c.varints(len(out_of_line))
        offsets = c.varints(len(out_of_line))
        refs = dict(zip(out_of_line, zip(file_ids, offsets)))
        for i, key in enumerate(keys):
            if i in refs:
                value = (files[refs[i][0]], refs[i][1], lengths[i])
            else:
                value = bytes(c.take(lengths[i]))
            self._values[(prefix + key).decode()] = value
        c.end()

    def keys(self):
        return list(self._values)

    def get(self, key):
        """The value of ``key`` as bytes, None if absent."""
        value = self._values.get(key)
        if isinstance(value, tuple):
            return bytes(self._range(*value))
        return value


class DirectoryStore:
    """The plain layout: each key is a file under ``root``."""

    def __init__(self, root):
        self.root = root

    def get(self, key):
        path = os.path.join(self.root, *key.split("/"))
        if not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            return f.read()


def open_store(path, use_ocdbt):
    if not use_ocdbt:
        return DirectoryStore(path)
    if not os.path.exists(os.path.join(path, MANIFEST)):
        raise ValueError(f"{path}: an OCDBT checkpoint without {MANIFEST}")
    return OcdbtStore(path)


# ---------------------------------------------------------------- zarr v2

def _bfloat16_bits(value):
    return int(torch.tensor(float(value), dtype=torch.bfloat16)
               .view(torch.int16).item()) & 0xFFFF


def read_array(store, name):
    """One zarr v2 array of ``store``: a numpy array, or a torch.bfloat16
    tensor for ``"dtype": "bfloat16"`` (numpy has no bfloat16)."""
    raw = store.get(f"{name}/.zarray")
    if raw is None:
        raise ValueError(f"checkpoint array {name!r} is missing")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2 or meta.get("filters"):
        raise ValueError(f"{name}: unsupported zarr array {meta}")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: unsupported compressor {compressor}")
    bf16 = meta["dtype"] == "bfloat16"
    dtype = np.dtype(np.uint16 if bf16 else meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    order = meta.get("order", "C")
    fill = meta.get("fill_value")
    if fill is None:
        fill = 0
    elif bf16:
        fill = _bfloat16_bits(fill)
    out = np.full(shape, fill, dtype.newbyteorder("="))
    sep = meta.get("dimension_separator", ".")
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    for index in itertools.product(*(range(g) for g in grid)):
        data = store.get(f"{name}/{sep.join(map(str, index)) or '0'}")
        if data is None:
            continue  # an absent chunk holds the fill value
        if compressor is not None:
            data = zstd.decompress(data)
        chunk = np.frombuffer(data, dtype).reshape(chunks, order=order)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    if bf16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


# ---------------------------------------------------------------- trees

def _assemble(entries):
    """Nested dicts and lists from (key path, value) pairs; a key path is a
    list of (key, key_type), key_type 1 an index into a list."""
    root, kinds = {}, {}
    for path, value in entries:
        node = root
        for depth, (key, kind) in enumerate(path):
            kinds[id(node)] = kind
            if depth == len(path) - 1:
                node[key] = value
            else:
                node = node.setdefault(key, {})

    def finish(node):
        if not isinstance(node, dict) or id(node) not in kinds:
            return node  # a leaf, an empty dict leaf too
        items = {k: finish(v) for k, v in node.items()}
        if kinds[id(node)] == KEY_SEQUENCE:
            return [items[k] for k in sorted(items, key=int)]
        return items
    return finish(root)


def read_checkpoint(path):
    """An Orbax checkpoint directory as the nested dicts and lists of its
    raw restore (the JAX package's ``load_raw_checkpoint``): numpy arrays,
    torch.bfloat16 tensors for bfloat16 leaves, None and empty containers
    where the tree had them. The arrays decode on READ_WORKERS threads."""
    if not os.path.isfile(os.path.join(path, METADATA)):
        raise ValueError(f"{path} is not an Orbax checkpoint (no "
                         f"{METADATA})")
    with open(os.path.join(path, METADATA), encoding="utf-8") as f:
        meta = json.load(f)
    store = open_store(path, meta.get("use_ocdbt", True))
    leaves = []
    for entry in meta["tree_metadata"].values():
        keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        leaves.append((keys, value["value_type"]))

    def load(item):
        keys, kind = item
        if kind in EMPTY_VALUES:
            return EMPTY_VALUES[kind]()
        if kind not in ARRAY_TYPES:
            raise ValueError(f"{path}: unsupported leaf type {kind!r} at "
                             f"{[k for k, _ in keys]}")
        value = read_array(store, ".".join(k for k, _ in keys))
        return value.item() if kind == "scalar" else value

    with concurrent.futures.ThreadPoolExecutor(READ_WORKERS) as pool:
        values = list(pool.map(load, leaves))
    return _assemble([(keys, v) for (keys, _), v in zip(leaves, values)])


def _flatten(tree, path=()):
    """(key path, leaf) pairs in the order of a JAX pytree flatten (dict
    keys sorted); an empty dict or list and None are leaves."""
    if isinstance(tree, dict) and tree:
        for key in sorted(tree):
            yield from _flatten(tree[key], path + ((str(key), KEY_DICT),))
    elif isinstance(tree, (list, tuple)) and tree:
        for i, value in enumerate(tree):
            yield from _flatten(value, path + ((str(i), KEY_SEQUENCE),))
    else:
        yield path, tree


def _dtype_name(array):
    if array.dtype == torch.bfloat16:
        return "bfloat16"
    return np.dtype(array.dtype).str  # '<f4', '<i4', '|b1', ...


def _host_array(value):
    """A leaf as a C-contiguous numpy array (bfloat16 as its uint16 bits)
    and the zarr dtype name."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        value = t.numpy()
    a = np.asarray(value, order="C")  # 0-d stays 0-d
    return a, _dtype_name(a)


def write_checkpoint(path, tree):
    """Write ``tree`` (nested dicts, lists and tuples of numpy arrays,
    torch tensors, numbers; None and empty containers allowed) as an Orbax
    checkpoint directory in the plain layout with uncompressed chunks. A
    number becomes a 0-d array of its numpy type, so give an int32 step
    as ``np.int32``. ``path`` must not exist; the caller renames it into
    place."""
    os.makedirs(path)
    started = time.time_ns()
    tree_meta, arrays = {}, []
    for keys, value in _flatten(tree):
        if not keys:
            raise ValueError("a checkpoint tree must be a container")
        name = ".".join(k for k, _ in keys)
        entry = {"key_metadata": [{"key": k, "key_type": t} for k, t in keys]}
        if value is None or isinstance(value, (dict, list, tuple)):
            kind = ("None" if value is None else
                    "Dict" if isinstance(value, dict) else
                    "Tuple" if isinstance(value, tuple) else "List")
            entry["value_metadata"] = {"value_type": kind,
                                       "skip_deserialize": True}
        else:
            array, dtype = _host_array(value)
            shape = list(array.shape)
            entry["value_metadata"] = {"value_type": "jax.Array",
                                       "skip_deserialize": False,
                                       "write_shape": shape}
            os.makedirs(os.path.join(path, name))
            zarray = {"chunks": shape, "compressor": None,
                      "dimension_separator": ".", "dtype": dtype,
                      "fill_value": None, "filters": None, "order": "C",
                      "shape": shape, "zarr_format": 2}
            _write(os.path.join(path, name, ".zarray"),
                   json.dumps(zarray, separators=(",", ":")))
            chunk = ".".join("0" for _ in shape) or "0"
            _write(os.path.join(path, name, chunk), array.tobytes())
            arrays.append({"array_metadata": {
                "param_name": name, "write_shape": shape,
                "chunk_shape": shape, "ext_metadata": None}})
        tree_meta[str(tuple(k for k, _ in keys))] = entry
    os.makedirs(os.path.dirname(os.path.join(path, ARRAY_METADATA)))
    _write(os.path.join(path, ARRAY_METADATA),
           json.dumps({"array_metadatas": arrays}))
    _write(os.path.join(path, METADATA), json.dumps({
        "tree_metadata": tree_meta, "use_ocdbt": False, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True,
        "custom_metadata": None}))
    _write(os.path.join(path, CHECKPOINT_METADATA), json.dumps({
        "item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": started,
        "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}}))


def _write(path, data):
    with open(path, "wb") as f:
        f.write(data.encode() if isinstance(data, str) else data)
