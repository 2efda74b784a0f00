"""
The port's feed options against lidbox_tpu's, on the CPU: staging
compression, packed targets, grouped dispatch, cached replay and the
memory guard.

- stage_signals and pack_targets_int16 give the JAX package's values and
  layouts (exactly; bfloat16 compared after the upcast).
- ModelWrapper.fit_fused with augmentation off and ``feed {stage_dtype:
  int16, steps_per_dispatch: 2, cache_staged: true}`` for each
  ``cache_shuffle`` in False, True and "rows", against the JAX package's
  fit_signals with the same options (its fit_fused leaves cache_shuffle at
  True): history within rtol 1e-4. 2 epochs of 4 batches of b4 x 0.5 s;
  epoch 2 replays the cache, in the order both packages draw from
  ``np.random.default_rng(RANDOM_SEED + epoch)``.
- In the port alone, with every augmentation stage on: grouped dispatch
  equals per-step dispatch exactly, replay with cache_shuffle False equals
  streaming exactly (also with interleaved shapes, per-entry replay) and
  transfers no signals after epoch 1, a restored run draws the same
  augmentation as an uninterrupted one, and a small cache_bytes_limit
  releases the cache with a warning and keeps the trajectory; the
  configuration of chip_smoke.py's augmented phase trains. The same
  for Trainer.fit's grouped dispatch and replay of feature batches. (Its
  feed options against the JAX Trainer are in tests/test_torch_train.py.)
"""
import logging
import types

import numpy as np
import pytest
import torch

import jax

import lidbox_tpu_torch.models as tmodels
from lidbox_tpu.data import on_device as jdev
from lidbox_tpu.models.model_utils import ModelWrapper as JWrapper
from lidbox_tpu.train import loop as jloop
from lidbox_tpu_torch import losses as tlosses
from lidbox_tpu_torch.data import on_device as tdev
from lidbox_tpu_torch.features import io as tio
from lidbox_tpu_torch.models.model_utils import ModelWrapper
from lidbox_tpu_torch.train import feed as tfeed
from lidbox_tpu_torch.train import loop as tloop
from lidbox_tpu_torch.train import optimizers as topt

torch.set_num_threads(2)

RATE = 16000
B, N_CLASSES, MEL = 4, 5, 24
# Adam's first updates are about lr * sign(g): where a gradient sits near
# zero, two float32 runs step apart, and over 12 steps at lr 1e-3 the val
# loss of the two packages drifts 4e-4 apart. lr 1e-4 and eps 1e-4 keep the
# comparison about the feed (1e-7 apart), as tests/test_torch_train.py does.
ADAM = {"cls": "Adam", "kwargs": {"learning_rate": 1e-4, "epsilon": 1e-4}}
CAVG = {"cls": "SparseAverageDetectionCost", "N": N_CLASSES,
        "threshold_linspace": {"start": -10.0, "stop": 0.0, "num": 11}}
FEED = {"stage_dtype": "int16", "steps_per_dispatch": 2, "cache_staged": True}


def noisy_sines(n_batches, seed, samples=8000):
    rng = np.random.default_rng(seed)
    time = np.arange(samples) / RATE
    out = []
    for _ in range(n_batches):
        y = rng.integers(0, N_CLASSES, B)
        x = (np.sin(2 * np.pi * (200.0 + 300.0 * y[:, None]) * time)
             + 0.3 * rng.normal(0, 1, (B, samples)))
        x[:, 3000:3400] = 0.0
        x = 0.5 * x / np.abs(x).max(axis=1, keepdims=True)
        out.append((x.astype(np.float32), y.astype(np.int32)))
    return out


def config(cache_dir, feed, augment=None, callbacks=()):
    return {
        "features": {"type": "logmelspectrogram", "sample_rate": RATE,
                     "melspectrogram": {"num_mel_bins": MEL},
                     "stft_method": "matmul",
                     "on_device_augment": dict(augment or {})},
        "experiment": {
            "cache_directory": str(cache_dir), "name": "feed",
            "input_shape": [None, MEL], "output_shape": [N_CLASSES],
            "model": {"key": "xvector"}, "optimizer": ADAM,
            "loss": {"cls": "SparseCategoricalCrossentropy"},
            "metrics": [CAVG], "callbacks": list(callbacks),
            "feed": dict(feed)}}


# -- staging -------------------------------------------------------------------

STAGE_CASES = {
    "float_int16": (np.float32, "int16"),
    "float_bfloat16": (np.float32, "bfloat16"),
    "int16_bfloat16": (np.int16, "bfloat16"),
    "int16_int16": (np.int16, "int16"),
    "float64_none": (np.float64, None),
    "int16_none": (np.int16, None),
    "float_float32": (np.float32, "float32"),
}


@pytest.mark.parametrize("case", list(STAGE_CASES))
def test_stage_signals_matches_jax(case):
    src, stage = STAGE_CASES[case]
    x = np.random.default_rng(1).uniform(-1.0, 1.0, (3, 400))
    x[0, :3] = (1.0, -1.0, 0.99999)  # clipping and rounding at full scale
    x = (np.rint(x * 32767) if src == np.int16 else x).astype(src)
    ours = tdev.stage_signals(x, stage)
    ref = jdev.stage_signals(x, stage)
    assert str(ours.dtype).replace("torch.", "") == str(ref.dtype)
    as_float = (ours.float().numpy() if isinstance(ours, torch.Tensor)
                else ours.astype(np.float64))
    np.testing.assert_array_equal(as_float, np.asarray(ref, np.float64))
    back = tdev.signals_to_float(torch.as_tensor(as_float).to(
        ours.dtype if isinstance(ours, torch.Tensor)
        else getattr(torch, str(ours.dtype))))
    ref_back = np.asarray(jdev.signals_to_float(jax.numpy.asarray(ref)))
    np.testing.assert_array_equal(back.numpy(), ref_back)


@pytest.mark.parametrize("case", ["single", "stack", "b_gt_t", "negative",
                                  "too_large", "float"])
def test_pack_targets_int16_matches_jax(case):
    rng = np.random.default_rng(2)
    shape = {"stack": (3, 4, 16), "b_gt_t": (8, 6)}.get(case, (4, 16))
    x = rng.integers(-300, 300, shape).astype(
        np.float32 if case == "float" else np.int16)
    y = rng.integers(0, 5, shape[:-1])
    y.flat[0] = {"negative": -1, "too_large": 40000}.get(case, y.flat[0])
    ours, ref = tdev.pack_targets_int16(x, y), jdev.pack_targets_int16(x, y)
    assert (ours is None) == (ref is None)
    if case in ("single", "stack"):
        np.testing.assert_array_equal(ours, ref)
        assert ours.shape == shape[:-2] + (shape[-2] + 1, shape[-1])
    else:
        assert ours is None


# -- fit_fused against the JAX package ------------------------------------------

@pytest.fixture(scope="module")
def jax_feed_runs(tmp_path_factory):
    """The JAX package's fit_signals with the feed options, one run per
    cache_shuffle, from one trainer reset to the same initial weights."""
    root = tmp_path_factory.mktemp("jax_feed")
    train, val = noisy_sines(4, seed=3), noisy_sines(1, seed=4)
    conf = config(root, FEED)
    jw = JWrapper.from_config(conf)
    jw.trainer.create_state()
    init = jax.device_get(jw.model.variables)
    features = conf["features"]
    fn = jdev.feature_fn_from_config(RATE, features)
    clean = jdev.feature_fn_from_config(
        RATE, {k: v for k, v in features.items() if k != "on_device_augment"})
    runs = {}
    for shuffle in (False, True, "rows"):
        jw.model.variables = init
        jw.trainer.state = None
        jw.trainer.create_state()
        runs[str(shuffle)] = jdev.fit_signals(
            jw.trainer, fn, lambda: train, epochs=2, verbose=False,
            val_batches=lambda: val, val_feature_fn=clean,
            steps_per_dispatch=2, cache_shuffle=shuffle)
    return runs, init["params"], train, val


@pytest.mark.parametrize("shuffle", [False, True, "rows"])
def test_fit_fused_feed_matches_jax(jax_feed_runs, tmp_path, shuffle):
    runs, params, train, val = jax_feed_runs
    tw = ModelWrapper.from_config(
        config(tmp_path, dict(FEED, cache_shuffle=shuffle)), device="cpu")
    assert tw.trainer.stage_dtype == "int16" and tw.trainer.cache_staged
    tw.model.load_flax_params(params)
    ours = tw.fit_fused(lambda: train, epochs=2,
                        val_signal_batches=lambda: val, verbose=False)
    ref = runs[str(shuffle)]
    assert len(ours) == len(ref) == 2
    for o, r in zip(ours, ref):
        for k in ("loss", "val_loss", "val_SparseAverageDetectionCost"):
            np.testing.assert_allclose(o[k], r[k], rtol=1e-4, err_msg=k)
    if shuffle:  # a reshuffled replay is not epoch 1's order
        assert ours[1]["loss"] != runs["False"][1]["loss"]


def feature_batches(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = rng.integers(0, N_CLASSES, B).astype(np.int32)
        x = rng.normal(0, 1, (B, 40, MEL)).astype(np.float32)
        for i, k in enumerate(y):
            x[i, :, 4 * k:4 * k + 4] += 1.0
        out.append({"input": x, "target": y})
    return out


# -- the port alone: trajectories ------------------------------------------------

@pytest.fixture(scope="module")
def noise_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("noise")
    rng = np.random.default_rng(7)
    for i in range(2):
        tio.write_mono_wav(str(root / f"n{i}.wav"),
                           rng.uniform(-0.5, 0.5, RATE).astype(np.float32),
                           RATE)
    return root


def augmented(noise_dir):
    return {"noise_datadir": str(noise_dir), "noise_max_seconds": 1.0,
            "snr_range": [5, 20], "augment_prob": 0.5, "fir_coefs": 10,
            "speed_range": [0.9, 1.1], "vad": True,
            "vad_min_non_speech_ms": 0,
            "specaug": {"time_masks": 2, "freq_masks": 2}}


class SignalTransfers:
    """Counts the host-to-device transfers of signal batches (the last
    axis holds samples) per epoch of a fit."""

    def __init__(self, monkeypatch, samples):
        self.per_epoch, self.epoch = {}, 0
        original = tdev.to_device

        def counting(value, device):
            if np.shape(value)[-1] == samples:
                self.per_epoch[self.epoch] = self.per_epoch.get(self.epoch,
                                                                0) + 1
            return original(value, device)
        monkeypatch.setattr(tdev, "to_device", counting)

    def on_epoch_begin(self, trainer, epoch):
        self.epoch = epoch


def fused(tmp_path, noise_dir, feed, batches, epochs=2, name="run",
          callbacks=(), restore=None, counter=None):
    """fit_fused of the port with every augmentation stage on; returns
    (history, trainer)."""
    tw = ModelWrapper.from_config(
        config(tmp_path / name, feed, augmented(noise_dir), callbacks),
        device="cpu")
    if restore is not None:
        tw.trainer.restore(restore)
    if counter is not None:
        hook = tloop.Callback()
        hook.on_epoch_begin = counter.on_epoch_begin
        tw.trainer.callbacks.append(hook)
    return tw.fit_fused(lambda: batches, epochs=epochs, verbose=False), \
        tw.trainer


def same_state(a, b):
    return a.step == b.step and all(torch.equal(a.params[k], b.params[k])
                                    for k in a.params)


@pytest.fixture(scope="module")
def streamed(tmp_path_factory, noise_dir):
    """The per-step, streaming reference run (int16 staging)."""
    return fused(tmp_path_factory.mktemp("streamed"), noise_dir,
                 {"stage_dtype": "int16"}, noisy_sines(4, seed=8))


def test_grouped_dispatch_equals_per_step(tmp_path, noise_dir, streamed):
    history, trainer = fused(tmp_path, noise_dir,
                             {"stage_dtype": "int16", "steps_per_dispatch": 2},
                             noisy_sines(4, seed=8))
    assert history == streamed[0]
    assert same_state(trainer.state, streamed[1].state)


@pytest.mark.parametrize("spd", [1, 2])
def test_replay_equals_streaming(tmp_path, noise_dir, streamed, monkeypatch,
                                 spd):
    counter = SignalTransfers(monkeypatch, 8000)
    history, trainer = fused(
        tmp_path, noise_dir, {"stage_dtype": "int16", "cache_staged": True,
                              "cache_shuffle": False,
                              "steps_per_dispatch": spd},
        noisy_sines(4, seed=8), counter=counter)
    assert history == streamed[0]
    assert same_state(trainer.state, streamed[1].state)
    assert counter.per_epoch == {1: 4 // spd}  # epoch 2 ran from the cache


def test_chip_smoke_configuration_trains_on_the_cpu(tmp_path, noise_dir,
                                                   monkeypatch):
    """The augmented phase of chip_smoke.py at a small size: every stage,
    int16 staging, 2 steps per dispatch, the cache replayed with the rows
    reshuffle. Epoch 1 transfers 2 packed groups, later epochs none."""
    counter = SignalTransfers(monkeypatch, 8000)
    history, trainer = fused(
        tmp_path, noise_dir, {"stage_dtype": "int16", "steps_per_dispatch": 2,
                              "cache_staged": True, "cache_shuffle": "rows"},
        noisy_sines(4, seed=8), epochs=3, counter=counter)
    assert len(history) == 3 and np.isfinite(history).all()
    assert trainer.state.step == 12
    assert counter.per_epoch == {1: 2}


def test_interleaved_shapes_replay_per_entry(tmp_path, noise_dir):
    """Shapes A, B, A with cache_shuffle False: stack-major replay would
    reorder them, so each entry replays in epoch 1's order."""
    mixed = noisy_sines(1, 9) + noisy_sines(1, 10, 7200) + noisy_sines(1, 11)
    ref, ref_trainer = fused(tmp_path, noise_dir, {}, mixed, name="a")
    history, trainer = fused(tmp_path, noise_dir,
                             {"cache_staged": True, "cache_shuffle": False},
                             mixed, name="b")
    assert history == ref and same_state(trainer.state, ref_trainer.state)


def test_restored_run_draws_the_same_augmentation(tmp_path, noise_dir,
                                                  streamed):
    ckpt = {"cls": "ModelCheckpoint", "kwargs": {"monitor": "loss"}}
    fused(tmp_path, noise_dir, {"stage_dtype": "int16"},
          noisy_sines(4, seed=8), epochs=1, name="first", callbacks=[ckpt])
    path = next((tmp_path / "first" / "xvector" / "feed" / "checkpoints")
                .iterdir())
    history, trainer = fused(tmp_path, noise_dir, {"stage_dtype": "int16"},
                             noisy_sines(4, seed=8), name="resumed",
                             restore=str(path))
    assert history == streamed[0][1:]
    assert same_state(trainer.state, streamed[1].state)


def test_cache_guard_releases_the_cache(tmp_path, noise_dir, streamed,
                                        monkeypatch, caplog):
    counter = SignalTransfers(monkeypatch, 8000)
    with caplog.at_level(logging.WARNING, logger="lidbox_tpu_torch"):
        history, trainer = fused(
            tmp_path, noise_dir, {"stage_dtype": "int16",
                                  "cache_staged": True,
                                  "cache_bytes_limit": 1000},
            noisy_sines(4, seed=8), counter=counter)
    assert any("releasing the cache" in r.message for r in caplog.records)
    assert history == streamed[0]
    assert same_state(trainer.state, streamed[1].state)
    assert counter.per_epoch == {1: 4, 2: 4}  # every epoch streamed


def test_streamed_validation_is_listed_once_an_epoch(tmp_path, noise_dir,
                                                     caplog):
    """A budget that holds the packed training cache but not the staged
    validation set: fit_signals lists ``val_feature_batches`` once an
    epoch, for the feed's staging attempt and the streamed evaluation
    alike."""
    val, calls = feature_batches(6, seed=12), []

    def val_batches():
        calls.append(len(calls))
        return iter(val)
    train_cache = 2 * (B + 1) * 8000 * 2  # 2 packed int16 batches
    tw = ModelWrapper.from_config(
        config(tmp_path, {"stage_dtype": "int16", "cache_staged": True,
                          "cache_bytes_limit": 2 * train_cache + 10000}),
        device="cpu")
    with caplog.at_level(logging.WARNING, logger="lidbox_tpu_torch"):
        history = tw.fit_fused(lambda: noisy_sines(2, seed=8), epochs=2,
                               verbose=False, val_feature_batches=val_batches)
    warnings = [r.message for r in caplog.records]
    assert any("streaming validation instead" in m for m in warnings)
    assert not any("releasing the cache" in m for m in warnings)
    assert calls == [0, 1]
    assert all(np.isfinite(h["val_loss"]) for h in history)


def fit_features(n_batches=4, **feed):
    model = tmodels.create("xvector", (40, MEL), N_CLASSES, device="cpu")
    trainer = tloop.Trainer(model, topt.adam(1e-3), tlosses.nll_loss,
                            device="cpu")
    batches = feature_batches(n_batches, 12)
    history = trainer.fit(lambda: batches, lambda: batches[:2], epochs=2,
                          verbose=False, **feed)
    return [{k: h[k] for k in ("loss", "val_loss")} for h in history], trainer


@pytest.fixture(scope="module")
def fit_streamed():
    return fit_features()


@pytest.mark.parametrize("feed", [
    {"steps_per_dispatch": 2},
    {"cache_staged": True, "cache_shuffle": False},
    {"cache_staged": True, "cache_shuffle": False, "steps_per_dispatch": 3}])
def test_trainer_fit_feed_equals_streaming(fit_streamed, feed):
    history, trainer = fit_features(**feed)
    assert history == fit_streamed[0]
    assert same_state(trainer.state, fit_streamed[1].state)


@pytest.mark.parametrize("spd", [1, 2])
def test_trainer_fit_steps_per_epoch(spd):
    """steps_per_epoch=3 of 4 batches: every epoch trains the first 3
    (grouped 2 + 1 at 2 steps a dispatch), as a fit on those 3 does, and
    a cut epoch fills no cache."""
    history, trainer = fit_features(steps_per_epoch=3, cache_staged=True,
                                    steps_per_dispatch=spd)
    ref_history, ref = fit_features(n_batches=3)
    assert history == ref_history and trainer.state.step == 6
    assert same_state(trainer.state, ref.state)


# -- helpers ---------------------------------------------------------------------

def staged_entry(layout, frames):
    """A staged entry of the feed, (count, step inputs): a feature batch,
    or a waveform batch in the plain or the packed int16 layout."""
    if layout == "features":
        return (B, 0), {"input": torch.zeros(B, frames, MEL),
                        "target": torch.zeros(B, dtype=torch.int64)}
    packed = layout == "packed"
    return (B, B * frames), tdev._inputs(
        torch.zeros(B + packed, frames, dtype=torch.int16),
        None if packed else torch.zeros(B, dtype=torch.int64), None)


@pytest.mark.parametrize("layout", ["features", "signals", "packed"])
def test_consolidation_and_its_order_bail_out(layout):
    sigs = [("a",), ("a",), ("b",), ("a",)]
    for s in (sigs, sigs[:3], [], [("x",)]):
        assert (tfeed._signature_runs_contiguous(s)
                == jloop._signature_runs_contiguous(s))

    interleaved = [staged_entry(layout, n) for n in (800, 600, 800)]
    assert tfeed.consolidate(interleaved, preserve_order=True) is None
    groups = tfeed.consolidate(interleaved)
    assert [len(g["counts"]) for g in groups] == [2, 1]
    count, inputs = interleaved[0]
    assert groups[0]["counts"] == [count, count]
    for k, v in inputs.items():
        got = groups[0]["stack"][k]
        assert got is None if v is None else got.shape == (2,) + v.shape
    # groups of 2 steps a transfer: [2, ...] entries, 4 steps in all
    stacked = [([count] * 2, {k: None if v is None else torch.stack([v, v])
                              for k, v in inputs.items()})] * 2
    [group] = tfeed.consolidate(stacked, stacked=True)
    assert group["counts"] == [count] * 4
    for k, v in inputs.items():
        got = group["stack"][k]
        assert got is None if v is None else got.shape == (4,) + v.shape


def test_packed_rows_replay_gathers_from_the_cached_stack():
    """cache_shuffle="rows" over a packed int16 cache: every step gathers
    its signals from the cached [K, B + 1, T] stack itself, the same
    storage every epoch, and its targets from that stack's row B; every
    row of the corpus is trained once an epoch."""
    K, T = 3, 16
    rng = np.random.default_rng(13)
    signals = rng.integers(-300, 300, (K, B, T)).astype(np.int16)
    targets = rng.integers(0, N_CLASSES, (K, B))
    packed = torch.as_tensor(tdev.pack_targets_int16(signals, targets))
    seen = []

    def step(state, inputs, generator):
        seen.append(inputs)
        return state + 1, torch.zeros(())
    trainer = types.SimpleNamespace(
        data_mesh=None, device=torch.device("cpu"), state=0, generator=None)
    feed = tfeed.Feed(trainer, step, None, stage=None, stage_group=None,
                      count=tdev._signal_count,
                      signature=tdev._signal_signature,
                      rows=tdev._example_rows, cache_staged=True,
                      cache_shuffle="rows")
    feed._freeze([((B, B * T), tdev._inputs(packed[k].clone(), None, None))
                  for k in range(K)])
    cached = feed.stacks[0]["rows"][1]["signals"][0]
    assert cached.shape == (K * (B + 1), T)
    for epoch in (2, 3):
        seen.clear()
        assert len(list(feed.epoch(epoch))) == K and trainer.state == K * (
            epoch - 1)
        rows = []
        for inputs in seen:
            sig, tgt = inputs["signals"], inputs["targets"]
            assert inputs["example_mask"] is None
            assert sig.source.data_ptr() == cached.data_ptr()
            assert sig.source.untyped_storage().nbytes() == packed.nbytes
            # row r of the corpus: row r % B of batch r // B, at a pitch of
            # B + 1 rows in the stack
            r = tgt.rows.numpy()
            np.testing.assert_array_equal(sig.rows.numpy(),
                                          (r // B) * (B + 1) + r % B)
            np.testing.assert_array_equal(sig.materialize().numpy(),
                                          signals.reshape(K * B, T)[r])
            np.testing.assert_array_equal(tgt.materialize().numpy(),
                                          targets.reshape(-1)[r])
            rows.extend(r.tolist())
        assert sorted(rows) == list(range(K * B))


def test_cache_budget_and_bytes():
    tree = {"a": torch.zeros(3, 5), "b": (np.zeros(4, np.int16), None)}
    assert tfeed._tree_device_nbytes(tree) == 3 * 5 * 4 + 4 * 2
    assert tfeed._cache_budget_bytes(1234) == 1234.0
    assert tfeed._cache_budget_bytes(None, "cpu") == float("inf")
