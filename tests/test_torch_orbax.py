"""
Orbax checkpoints in the port against lidbox_tpu's, on the CPU.

- The zstd decoder (``native/zstd.cpp``) against the ``zstandard`` package
  on random and structured payloads at levels 1, 3 and 19, with and
  without the content checksum; corrupt input raises; CRC-32C gives its
  check value, from concurrent threads too.
- OCDBT: a tensorstore key-value store with interior nodes, several data
  files and values out of line reads key for key; a flipped byte fails
  the manifest's CRC-32C.
- JAX-written checkpoints read by ``train.orbax.read_checkpoint`` leaf for
  leaf (dtype, shape and bits) against the JAX package's raw restore
  (``lidbox_tpu.train.checkpoint.load_raw_checkpoint``): the default OCDBT
  layout, the plain layout, bfloat16 and 0-d leaves, a two-chunk array,
  None and empty leaves, and an x-vector train state at published widths,
  which a port Trainer restores (parameters, moments, counts, epoch).
- Port-written checkpoints (``OrbaxCheckpointer``) read by the JAX
  package's ``restore_checkpoint`` with a ``TrainState`` target and by
  its ``load_raw_checkpoint``, for several optimizers' states; every leaf
  kind ``write_checkpoint`` takes (bfloat16, 0-d, None, empty) read back
  by both packages alike.
- ``ModelCheckpoint(backend="orbax")`` in the port's CLI: the same names
  and restored weights as the msgpack backend's; the JAX CLI's ``train
  --resume`` from the port's directory and the port's from the JAX one's.
- The committed fixture ``tests/data/orbax_jax_xvector_small`` (a narrow
  x-vector's JAX train state after 2 Adam steps, in the default layout and
  as msgpack) against its regeneration by ``make_fixture``.
- A writer that dies mid-write leaves only a ``.orbax-checkpoint-tmp``
  entry, which best-checkpoint selection skips.
- ``OrbaxCheckpointer.best_checkpoint_path`` picks as the JAX package's
  among ``epoch*`` directories only (``.ckpt`` files, tmp entries and other
  directories beside them), by epoch, a min key and a max key; a NaN value
  never wins, where the JAX method's pick follows the scan order.
"""
import concurrent.futures
import json
import os
import pathlib
import re

import numpy as np
import pytest
import torch
import zstandard

import flax.linen as nn
import jax
import orbax.checkpoint as ocp
import tensorstore
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import lidbox_tpu.models as jmodels
import lidbox_tpu_torch.models as tmodels
from lidbox_tpu import cli as jcli
from lidbox_tpu import losses as jlosses
from lidbox_tpu.models import layers as jlayers
from lidbox_tpu.models.model_api import Model as JModel
from lidbox_tpu.train import checkpoint as jckpt
from lidbox_tpu.train import loop as jloop
from lidbox_tpu.train import optimizers as jopt
from lidbox_tpu_torch import cli as tcli
from lidbox_tpu_torch import losses as tlosses
from lidbox_tpu_torch import testutil
from lidbox_tpu_torch.features import io as audio_io
from lidbox_tpu_torch.models.model_api import params_from_flax
from lidbox_tpu_torch.native import zstd
from lidbox_tpu_torch.train import checkpoint as tckpt
from lidbox_tpu_torch.train import loop as tloop
from lidbox_tpu_torch.train import optimizers as topt
from lidbox_tpu_torch.train import orbax

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "orbax_jax_xvector_small"
FIXTURE_SEED = 5
FIXTURE_NAME = "epoch000002__val_loss0.500000000000"
RATE = 16000
LABELS = ("aa", "bb", "cc")
FRAMES, N_MEL = 48, 24


# -- the leaf-by-leaf comparison ---------------------------------------------

def assert_same_tree(ref, ours, where="tree"):
    """``ours`` (the port's read) holds ``ref`` (the JAX raw restore) leaf
    for leaf: containers alike, arrays of one dtype, shape and bits,
    bfloat16 as torch.bfloat16 tensors."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and set(ours) == set(ref), where
        for k in ref:
            assert_same_tree(ref[k], ours[k], f"{where}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert type(ours) is type(ref) and len(ours) == len(ref), where
        for i, (r, o) in enumerate(zip(ref, ours)):
            assert_same_tree(r, o, f"{where}[{i}]")
    elif ref is None or isinstance(ref, (int, float)):
        assert type(ours) is type(ref) and ours == ref, where
    else:
        ref = np.asarray(ref)
        if ref.dtype.name == "bfloat16":
            assert isinstance(ours, torch.Tensor), where
            assert ours.dtype == torch.bfloat16, where
            assert tuple(ours.shape) == ref.shape, where
            np.testing.assert_array_equal(
                ours.view(torch.int16).numpy().view(np.uint16),
                ref.view(np.uint16), err_msg=where)
        else:
            assert isinstance(ours, np.ndarray), where
            assert (ours.dtype, ours.shape) == (ref.dtype, ref.shape), where
            np.testing.assert_array_equal(ours, ref, err_msg=where)


def assert_same_state(a, b):
    """Two of the port's raw states (``load_raw_checkpoint``, moments in
    one order) bit-equal."""
    assert a["step"] == b["step"]
    for key in ("params", "batch_stats"):
        assert set(a[key]) == set(b[key])
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (key, k)
    flat_a, flat_b = tree_leaves(a["opt_state"]), tree_leaves(b["opt_state"])
    assert len(flat_a) == len(flat_b)
    for x, y in zip(flat_a, flat_b):
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


# -- zstd --------------------------------------------------------------------

def payloads():
    rng = np.random.default_rng(0)
    words = [rng.bytes(int(n)) for n in rng.integers(1, 12, 64)]
    return {
        "random": rng.bytes(200_000),
        "floats": rng.normal(0, 1, 60_000).astype(np.float32).tobytes(),
        "text": b"the quick brown fox jumps over the lazy dog " * 4000,
        "zeros": bytes(300_000),
        "ramp": (np.arange(80_000) % 1000).astype(np.int32).tobytes(),
        # runs of repeated random words: matches at many offsets
        "words": b"".join(words[i] * int(r) for i, r in zip(
            rng.integers(0, 64, 8000), rng.integers(1, 5, 8000))),
        "alphabet": rng.integers(0, 4, 150_000).astype(np.uint8).tobytes(),
        "short": b"a",
        "empty": b"",
    }


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", [1, 3, 19])
def test_zstd_matches_zstandard(level, checksum):
    compressor = zstandard.ZstdCompressor(level=level,
                                          write_checksum=checksum)
    for name, data in payloads().items():
        frame = compressor.compress(data)
        assert zstd.decompress(frame) == data, name


def test_zstd_refuses_corrupt_input_and_checks_crc32c():
    data = payloads()["text"]
    frame = bytearray(zstandard.ZstdCompressor(
        level=3, write_checksum=True).compress(data))
    frame[-1] ^= 1
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(frame))
    with pytest.raises(ValueError, match="truncated|corrupt"):
        zstd.decompress(bytes(frame[:len(frame) // 2]))
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(b"not a zstd frame")
    # frames concatenate, skippable frames are skipped
    two = (zstandard.ZstdCompressor(level=1).compress(b"abc")
           + b"\x50\x2a\x4d\x18\x02\x00\x00\x00xx"
           + zstandard.ZstdCompressor(level=19).compress(data))
    assert zstd.decompress(two) == b"abc" + data
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd._LIB == os.path.join(ROOT, "lidbox_tpu_torch", "_build",
                                     "libzstd.so")
    assert os.path.exists(zstd._LIB)


def test_crc32c_from_concurrent_threads():
    """read_checkpoint verifies OCDBT files on a thread pool: crc32c gives
    every thread the same value."""
    data = [payloads()["text"][i:] for i in range(16)]
    want = [zstd.crc32c(d) for d in data]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        for _ in range(4):
            assert list(pool.map(zstd.crc32c, data)) == want


def test_ocdbt_store_with_interior_nodes(tmp_path):
    """300 versions of a store whose small nodes make a B+tree of height
    3 over many data files; values inline and out of line."""
    root = tmp_path / "kv"
    kv = tensorstore.KvStore.open({
        "driver": "ocdbt", "base": f"file://{root}/",
        "config": {"max_decoded_node_bytes": 600,
                   "max_inline_value_bytes": 40,
                   "compression": {"id": "zstd", "level": 7}}}).result()
    rng = np.random.default_rng(1)
    values = {}
    for i in range(300):
        key = f"key{i:04d}/{'x' * (i % 7)}"
        values[key] = rng.bytes(int(rng.integers(0, 90)))
        kv.write(key, values[key]).result()
    store = orbax.OcdbtStore(str(root))
    assert sorted(store.keys()) == sorted(values)
    for key, value in values.items():
        assert store.get(key) == value
    assert store.get("absent") is None
    manifest = root / orbax.MANIFEST
    data = bytearray(manifest.read_bytes())
    data[20] ^= 0xFF
    manifest.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC-32C"):
        orbax.OcdbtStore(str(root))


# -- JAX writes, the port reads ------------------------------------------------

class NarrowXVector(nn.Module):
    """The x-vector's layers and names at narrow widths (32 channels, 64
    before the pooling, 32 in the segments), for a small fixture."""
    num_outputs: int

    @nn.compact
    def __call__(self, x, train=False, mask=None, output="logits"):
        x = jlayers.FrameLayer(32, 5, 1, name="frame1")(x)
        x = jlayers.FrameLayer(32, 3, 2, name="frame2")(x)
        x = jlayers.FrameLayer(32, 3, 3, name="frame3")(x)
        x = jlayers.FrameLayer(32, 1, 1, name="frame4")(x)
        x = jlayers.FrameLayer(64, 1, 1, name="frame5")(x)
        x = jlayers.GlobalMeanStddevPooling1D(name="stats_pooling")(x)
        x = nn.Dense(32, name="segment1")(x)
        if output == "embedding":
            return x
        x = nn.relu(nn.Dense(32, name="segment2")(nn.relu(x)))
        return nn.log_softmax(nn.Dense(self.num_outputs, name="outputs")(x))


def make_fixture(directory, seed=FIXTURE_SEED):
    """The committed fixture: a narrow x-vector (40 mel bins in, 5 classes)
    from ``PRNGKey(seed)``, trained 2 Adam steps on seeded features by the
    JAX Trainer, saved as the epoch-2 checkpoint in both of the JAX
    package's formats: the Orbax directory (OCDBT + zstd) and msgpack.
    Returns (directory path, .ckpt path)."""
    model = JModel(module=NarrowXVector(5), input_shape=(None, 40),
                   name="narrow-x-vector").init(jax.random.PRNGKey(seed))
    optimizer, _ = jopt.optimizer_from_config(
        {"cls": "Adam", "kwargs": {"learning_rate": 1e-3}})
    trainer = jloop.Trainer(model, optimizer, jlosses.nll_loss)
    rng = np.random.default_rng(seed)
    batches = [{"input": rng.normal(0, 1, (4, 48, 40)).astype(np.float32),
                "target": rng.integers(0, 5, 4).astype(np.int32)}
               for _ in range(2)]
    trainer.create_state()
    trainer.fit(lambda: batches, epochs=1, verbose=False)
    os.makedirs(directory, exist_ok=True)
    path = jckpt.OrbaxCheckpointer(use_async=False).save(
        str(directory), trainer.state, epoch=2, val_loss=0.5)
    ckpt = jckpt.save_checkpoint(str(directory), trainer.state, epoch=2,
                                 val_loss=0.5)
    return path, ckpt


def mixed_tree():
    """Every leaf kind: float32, bfloat16, int32 and bool 0-d, int64 (as
    int32 without x64), None, an empty dict, list and tuple, numpy arrays,
    Python numbers, and a float32 array sharded over 2 devices (two
    chunks)."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    rng = np.random.default_rng(2)
    return {
        "a": jax.numpy.asarray(rng.normal(0, 1, (3, 4)).astype(np.float32)),
        "b": jax.numpy.asarray(rng.normal(0, 1, 10), jax.numpy.bfloat16),
        "c": [jax.numpy.int32(7), jax.numpy.asarray(True), None, {}],
        "d": jax.device_put(
            jax.numpy.asarray(rng.normal(0, 1, (8, 5)).astype(np.float32)),
            NamedSharding(mesh, PartitionSpec("x"))),
        "e": jax.numpy.asarray(np.arange(6).reshape(2, 3)),
        "host": [np.arange(3, dtype=np.float32), np.int32(3), 5, 2.5, [],
                 ()],
    }


def published_state():
    """The full-width x-vector's JAX train state (298 x 64 input, 5
    classes) with Adam moments of random values: about 54 MB, mostly
    incompressible."""
    model = jmodels.create("xvector", (298, 64), 5)
    model.variables = jax.jit(model.module.init)(
        jax.random.PRNGKey(3), np.zeros((1, 298, 64), np.float32))
    optimizer, _ = jopt.optimizer_from_config(
        {"cls": "Adam", "kwargs": {"learning_rate": 1e-3}})
    state = jloop.Trainer(model, optimizer, jlosses.nll_loss).create_state()
    rng = np.random.default_rng(4)
    adam = state.opt_state[0]
    noise = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: rng.normal(0, 1e-3, x.shape).astype(np.float32), t)
    return state.replace(step=jax.numpy.int32(17), opt_state=(adam._replace(
        count=jax.numpy.int32(17), mu=noise(adam.mu),
        nu=jax.tree_util.tree_map(np.abs, noise(adam.nu))),
        state.opt_state[1]))


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_written")
    paths = {"narrow_ocdbt": make_fixture(root / "narrow")[0]}
    tree = mixed_tree()
    for name, handler in (("plain", ocp.PyTreeCheckpointHandler(
            use_ocdbt=False)), ("ocdbt", ocp.StandardCheckpointHandler())):
        path = str(root / name)
        args = (ocp.args.PyTreeSave(tree) if name == "plain"
                else ocp.args.StandardSave(tree))
        ocp.Checkpointer(handler).save(path, args=args)
        paths[f"mixed_{name}"] = path
    paths["published"] = jckpt.OrbaxCheckpointer(use_async=False).save(
        str(root / "published"), published_state(), epoch=1, val_loss=1.0)
    return paths


@pytest.mark.parametrize("case", ["narrow_ocdbt", "mixed_plain",
                                  "mixed_ocdbt", "published"])
def test_port_reads_jax_checkpoints(jax_written, case):
    path = jax_written[case]
    with open(os.path.join(path, orbax.METADATA)) as f:
        assert json.load(f)["use_ocdbt"] == (case != "mixed_plain")
    assert_same_tree(jckpt.load_raw_checkpoint(path),
                     orbax.read_checkpoint(path))


def test_port_trainer_restores_a_jax_orbax_train_state(jax_written):
    """The published-width JAX state (OCDBT + zstd) restored into a port
    Trainer: parameters, Adam moments and counts equal the JAX tree's
    through ``params_from_flax``, and the epoch comes from the name."""
    path = jax_written["published"]
    model = tmodels.create("xvector", (298, 64), 5, device="cpu")
    trainer = tloop.Trainer(model, topt.adam(1e-3), tlosses.nll_loss,
                            device="cpu")
    trainer.restore(path)
    raw = jckpt.load_raw_checkpoint(path)
    assert trainer.initial_epoch == 1 and trainer.state.step == 17
    ours = params_from_flax(raw["params"])
    mu = params_from_flax(raw["opt_state"][0]["mu"])
    adam = trainer.state.opt_state[0]
    assert adam["count"] == 17
    for (k, v), m in zip(trainer.state.params.items(), adam["mu"]):
        assert torch.equal(v, ours[k]) and torch.equal(m, mu[k]), k
    for k, v in model.module.named_parameters():  # synced for serving
        assert torch.equal(v.detach(), ours[k]), k


def test_committed_fixture_matches_its_regeneration(tmp_path):
    directory, ckpt = make_fixture(tmp_path)
    committed = FIXTURE / FIXTURE_NAME
    assert os.path.basename(directory) == FIXTURE_NAME
    assert_same_tree(orbax.read_checkpoint(directory),
                     orbax.read_checkpoint(str(committed)))
    assert_same_tree(jckpt.load_raw_checkpoint(str(committed)),
                     orbax.read_checkpoint(str(committed)))
    assert_same_state(tckpt.load_raw_checkpoint(str(committed)),
                      tckpt.load_raw_checkpoint(
                          str(FIXTURE / (FIXTURE_NAME + ".ckpt"))))
    assert_same_state(tckpt.load_raw_checkpoint(ckpt),
                      tckpt.load_raw_checkpoint(
                          str(FIXTURE / (FIXTURE_NAME + ".ckpt"))))
    size = sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file())
    assert size < 600_000


# -- the port writes, JAX reads ----------------------------------------------

@pytest.fixture(scope="module")
def jax_xvector():
    model = jmodels.create("xvector", (FRAMES, N_MEL), len(LABELS))
    model.variables = jax.jit(model.module.init)(
        jax.random.PRNGKey(0), np.zeros((1, FRAMES, N_MEL), np.float32))
    return model


OPTIMIZERS = {
    "Adam": {"cls": "Adam", "kwargs": {"learning_rate": 1e-3}},
    "AdamW": {"cls": "AdamW", "kwargs": {"learning_rate": 1e-3}},
    "SGD": {"cls": "SGD", "kwargs": {"learning_rate": 1e-2,
                                     "momentum": 0.9}},
    "clipped": {"cls": "RMSprop", "kwargs": {
        "learning_rate": 1e-3, "clipnorm": 1.0,
        "lr_scheduler": {"cls": "ExponentialDecay", "kwargs": {
            "initial_learning_rate": 1e-3, "decay_steps": 10,
            "decay_rate": 0.9}}}},
}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_jax_reads_port_checkpoints(jax_xvector, opt, tmp_path):
    model = tmodels.create("xvector", (FRAMES, N_MEL), len(LABELS),
                           device="cpu")
    model.load_flax_params(jax.device_get(jax_xvector.variables["params"]))
    trainer = tloop.Trainer(model, topt.optimizer_from_config(
        OPTIMIZERS[opt])[0], tlosses.nll_loss, device="cpu")
    rng = np.random.default_rng(6)
    batch = {"input": rng.normal(0, 1, (4, FRAMES, N_MEL)).astype(np.float32),
             "target": np.array([0, 1, 2, 0], np.int32)}
    trainer.fit(lambda: [batch, batch], epochs=1, verbose=False)
    writer = tckpt.OrbaxCheckpointer()
    path = writer.save(str(tmp_path), trainer.state, epoch=1, val_loss=0.25)
    writer.wait()
    target = jloop.Trainer(jax_xvector, jopt.optimizer_from_config(
        OPTIMIZERS[opt])[0], jlosses.nll_loss).create_state()
    restored = jckpt.restore_checkpoint(path, target)
    state = trainer.state
    assert int(restored.step) == state.step == 2
    ours = params_from_flax(jax.device_get(restored.params))
    for k, v in state.params.items():
        assert torch.equal(ours[k], v), k
    opt_state = topt.opt_state_from_optax(
        jax.device_get(restored.opt_state), state.params)
    for a, b in zip(tree_leaves(opt_state), tree_leaves(state.opt_state)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert_same_tree(jckpt.load_raw_checkpoint(path),
                     orbax.read_checkpoint(path))


def test_jax_reads_every_leaf_kind_the_port_writes(tmp_path):
    """``write_checkpoint`` of float32, bfloat16, int32, bool, 0-d and
    empty leaves: the JAX raw restore and the port's read agree, and give
    back what was written."""
    rng = np.random.default_rng(7)
    bf16 = torch.tensor(rng.normal(0, 1, 6), dtype=torch.bfloat16)
    tree = {"w": rng.normal(0, 1, (3, 4)).astype(np.float32), "b": bf16,
            "n": [np.int32(3), np.asarray(True), None, {}, [], ()],
            "k": torch.arange(5, dtype=torch.int32)}
    path = str(tmp_path / "ckpt")
    orbax.write_checkpoint(path, tree)
    assert not os.path.exists(os.path.join(path, "_sharding"))
    ours = orbax.read_checkpoint(path)
    assert_same_tree(jckpt.load_raw_checkpoint(path), ours)
    np.testing.assert_array_equal(ours["w"], tree["w"])
    assert torch.equal(ours["b"], bf16)
    assert ours["n"][0] == 3 and ours["n"][1] and ours["n"][2:] == [
        None, {}, [], ()]
    np.testing.assert_array_equal(ours["k"], np.arange(5, dtype=np.int32))


def test_killed_writer_leaves_only_a_tmp_entry(tmp_path, monkeypatch):
    model = tmodels.create("xvector", (FRAMES, N_MEL), len(LABELS),
                           device="cpu")
    trainer = tloop.Trainer(model, topt.adam(1e-3), tlosses.nll_loss,
                            device="cpu")
    trainer.create_state()
    real, calls = orbax._write, []

    def dying(path, data):
        calls.append(path)
        if len(calls) == 5:
            raise OSError("killed")
        real(path, data)
    monkeypatch.setattr(orbax, "_write", dying)
    writer = tckpt.OrbaxCheckpointer()
    writer.save(str(tmp_path), trainer.state, epoch=1, val_loss=0.5)
    with pytest.raises(OSError, match="killed"):
        writer.wait()
    (entry,) = os.listdir(tmp_path)
    assert re.fullmatch(r"epoch000001__val_loss0\.500000000000"
                        r"\.orbax-checkpoint-tmp-\d+", entry)
    assert tckpt.get_best_checkpoint_path(str(tmp_path)) is None
    monkeypatch.setattr(orbax, "_write", real)
    path = writer.save(str(tmp_path), trainer.state, epoch=2, val_loss=0.4)
    writer.wait()
    assert tckpt.get_best_checkpoint_path(str(tmp_path)) == path
    assert tckpt.get_best_checkpoint_path(str(tmp_path), "val_loss",
                                          "min") == path


def checkpoint_entries(root, dirs, files=()):
    for name in dirs:
        (root / name).mkdir()
    for name in files:
        (root / name).write_bytes(b"")


def test_orbax_best_checkpoint_path_matches_jax(tmp_path):
    """Only ``epoch*`` directories are candidates: the ``.ckpt`` files
    (which win every key here, and which ``get_best_checkpoint_path``
    picks), the tmp entry (best on every key too) and the other
    directories are not."""
    checkpoint_entries(
        tmp_path,
        ["epoch000001__val_loss0.400000000000__accuracy0.900000",
         "epoch000002__val_loss0.200000000000__accuracy0.600000",
         "epoch000003__val_loss0.300000000000__accuracy0.700000",
         "epoch000008__val_loss0.010000000000__accuracy0.990000"
         ".orbax-checkpoint-tmp-1700000000",
         "logs", "tensorboard"],
        ["epoch000009__val_loss0.050000000000__accuracy0.950000.ckpt",
         "epoch000010__notes.txt"])
    cases = [(None, None, "epoch000003"), ("epoch", None, "epoch000003"),
             ("val_loss", "min", "epoch000002"),
             ("accuracy", "max", "epoch000001")]
    for key, mode, best in cases:
        ours = tckpt.OrbaxCheckpointer.best_checkpoint_path(str(tmp_path),
                                                            key, mode)
        ref = jckpt.OrbaxCheckpointer.best_checkpoint_path(str(tmp_path), key,
                                                           mode)
        assert ours == ref and os.path.basename(ours).startswith(best)
        assert tckpt.get_best_checkpoint_path(
            str(tmp_path), key, mode).endswith(".ckpt")
    with pytest.raises(ValueError, match="mode"):
        tckpt.OrbaxCheckpointer.best_checkpoint_path(str(tmp_path),
                                                     "val_loss", "mean")
    assert tckpt.OrbaxCheckpointer.best_checkpoint_path(
        str(tmp_path / "absent")) is None
    assert tckpt.OrbaxCheckpointer.best_checkpoint_path(
        str(tmp_path / "logs")) is None


def test_orbax_best_checkpoint_path_skips_nan(tmp_path, monkeypatch):
    """A NaN metric never wins, whatever the scan order; the JAX method's
    pick under NaN follows the scan order (ROADMAP §3, a divergence)."""
    checkpoint_entries(tmp_path, ["epoch000001__val_lossnan",
                                  "epoch000002__val_loss0.300000000000",
                                  "epoch000003__val_loss0.200000000000"])
    scandir = os.scandir
    jax_picks = set()
    for reverse in (False, True):
        monkeypatch.setattr(os, "scandir", lambda path, r=reverse: sorted(
            scandir(path), key=lambda e: e.name, reverse=r))
        ours = tckpt.OrbaxCheckpointer.best_checkpoint_path(str(tmp_path),
                                                            "val_loss", "min")
        assert os.path.basename(ours) == "epoch000003__val_loss0.200000000000"
        jax_picks.add(os.path.basename(jckpt.OrbaxCheckpointer
                                       .best_checkpoint_path(str(tmp_path),
                                                             "val_loss",
                                                             "min")))
    assert jax_picks == {"epoch000001__val_lossnan",
                         "epoch000003__val_loss0.200000000000"}
    monkeypatch.setattr(os, "scandir", scandir)
    for name in ("epoch000002__val_loss0.300000000000",
                 "epoch000003__val_loss0.200000000000"):
        os.rename(tmp_path / name,
                  tmp_path / (name.split("__")[0] + "__val_lossnan"))
    # every value NaN: the greatest epoch
    assert os.path.basename(tckpt.OrbaxCheckpointer.best_checkpoint_path(
        str(tmp_path), "val_loss", "max")) == "epoch000003__val_lossnan"


# -- the CLI journeys ----------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """3 labels x (4 train + 2 test) noisy sines of 0.5 s and their CSV."""
    root = tmp_path_factory.mktemp("corpus")
    lines = ["id,path,label,split"]
    for k, label in enumerate(LABELS):
        for i in range(6):
            path = root / f"{label}{i}.wav"
            audio_io.write_mono_wav(path, testutil.noisy_sinewave(
                200.0 + 300.0 * k + 7 * i, RATE, 0.3, 0.5, seed=10 * k + i),
                RATE)
            lines.append(f"{label}{i},{path},{label},"
                         f"{'train' if i < 4 else 'test'}")
    (root / "meta.csv").write_text("\n".join(lines) + "\n")
    return str(root / "meta.csv")


def cli_config(csv_path, cache, epochs, backend):
    return {
        "metadata": {"csv": csv_path},
        "features": {"type": "logmelspectrogram",
                     "melspectrogram": {"num_mel_bins": N_MEL},
                     "group_by_input_length": {"max_batch_size": 8}},
        "experiment": {
            "cache_directory": str(cache), "name": "ob",
            "input_shape": [FRAMES, N_MEL], "output_shape": [len(LABELS)],
            "model": {"key": "xvector"},
            "optimizer": {"cls": "Adam", "kwargs": {"learning_rate": 1e-3}},
            "loss": {"cls": "SparseCategoricalCrossentropy"},
            "callbacks": [{"cls": "ModelCheckpoint", "kwargs": {
                "monitor": "val_loss", "mode": "min", "backend": backend}}],
            "epochs": epochs,
            "data": {"train": {"split": "train", "batch_size": 4},
                     "test": {"split": "test"}}}}


def write_config(config, path):
    path.write_text(json.dumps(config))
    return str(path)


def port_main(argv):
    return tcli.main(argv, device="cpu")


def test_orbax_backend_and_resume_across_packages(corpus, tmp_path):
    """The port's CLI trains 2 epochs with each backend: the same names
    (their val_loss to 12 digits) and bit-equal weights. The JAX CLI
    resumes the Orbax run to epoch 3, the port's CLI resumes the JAX
    directory to epoch 4, and evaluate restores the best directory."""
    dirs = {}
    for backend in ("msgpack", "orbax"):
        cache = tmp_path / backend
        path = write_config(cli_config(corpus, cache, 2, backend),
                            tmp_path / f"{backend}.json")
        assert port_main(["train", path]) == 0
        dirs[backend] = cache / "xvector" / "ob" / "checkpoints"
    msgpack = sorted(p.name for p in dirs["msgpack"].iterdir())
    orbax_names = sorted(p.name for p in dirs["orbax"].iterdir())
    assert [n[:-len(".ckpt")] for n in msgpack] == orbax_names
    assert all((dirs["orbax"] / n).is_dir() for n in orbax_names)
    assert len(orbax_names) == 2
    for a, b in zip(msgpack, orbax_names):
        ref = tckpt.load_raw_checkpoint(str(dirs["msgpack"] / a))
        assert_same_state(ref, tckpt.load_raw_checkpoint(
            str(dirs["orbax"] / b), params=ref["params"]))

    cache = tmp_path / "orbax"
    path = write_config(cli_config(corpus, cache, 3, "orbax"),
                        tmp_path / "resume3.json")
    assert jcli.main(["train", path, "--resume"]) == 0
    names = sorted(p.name for p in dirs["orbax"].iterdir())
    assert len(names) == 3 and names[-1].startswith("epoch000003")
    with open(dirs["orbax"] / names[-1] / orbax.METADATA) as f:
        assert json.load(f)["use_ocdbt"]  # the JAX package wrote it
    path = write_config(cli_config(corpus, cache, 4, "orbax"),
                        tmp_path / "resume4.json")
    assert port_main(["train", path, "--resume"]) == 0
    names = sorted(p.name for p in dirs["orbax"].iterdir())
    assert len(names) == 4 and names[-1].startswith("epoch000004")
    state = tckpt.load_raw_checkpoint(str(dirs["orbax"] / names[-1]))
    assert state["step"] == 4 * 3  # 12 train wavs in batches of 4
    assert port_main(["evaluate", path]) == 0
