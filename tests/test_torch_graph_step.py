"""
The port's one-program train step (``lidbox_tpu_torch/train/graphs.py``) on
the CPU, against the functional step it replaces.

- The donating step (``Trainer._donating_step`` through ``_fit_step``)
  writes the same bits into the state's tensors as the functional
  ``_train_step`` computes, over 4 steps with channel dropout on, for every
  optimizer ``optimizer_from_config`` builds (Adam, AdamW, SGD with and
  without momentum, RMSprop, Adagrad), each with and without a learning
  rate schedule; its counts advance as the functional update's do.
- ``fit_fused`` clean and through the whole augmentation chain, with
  ``steps_per_dispatch: 2`` and each ``cache_shuffle``, gives the
  functional path's losses and state bit for bit: run eagerly (what the
  CPU runs) and as replays of a stand-in graph, whose capture keeps the
  step's static buffers and whose replay runs the donating step on them
  (what a CUDA graph replays), so the host side of a replay (input copies
  and row gathers into the buffers, scalar fills, the re-seeded
  augmentation generator, the counts) is exercised here too. The same
  for ``Trainer.fit`` of a BatchNorm model with grouped dispatch and the
  rows replay. A fit frees its captured steps when it ends.
- The signature cache keys one captured step per input shape, packed
  layout, example-mask case and dropout generator, and captures anew for
  another state's tensors; the process counts its captures, and the CPU
  counts no kernel launch.
- A capture holds the kernel's cached operands (basis and mel tiles), so
  they outlive the caches that made them.
- A trainer and its captured steps form no reference cycle.
- Only a mesh of several ranks is not captured, by rule, logged once: it
  runs the donating step eagerly. A BiGRU fed frame masks, ``remat`` and a
  one-rank mesh are captured.
- Replayed against the functional step, bit for bit: ``fit_signals`` of
  bi_gru and crnn through the length-tracking chain (VAD and speed change:
  every batch carries a frame mask), and the ``remat`` donating step with
  channel dropout 0.5.
"""
import gc
import logging
import types
import weakref

import numpy as np
import pytest
import torch

import lidbox_tpu_torch.models as tmodels
from lidbox_tpu_torch import losses as tlosses
from lidbox_tpu_torch import parallel
from lidbox_tpu_torch.data import on_device as tdev
from lidbox_tpu_torch.features import io as tio
from lidbox_tpu_torch.models.model_utils import ModelWrapper
from lidbox_tpu_torch.ops import logmel
from lidbox_tpu_torch.train import graphs
from lidbox_tpu_torch.train import loop as tloop
from lidbox_tpu_torch.train import optimizers as topt
from torch_init_cache import memoized

torch.set_num_threads(2)

RATE = 16000
B, N_CLASSES, MEL, FRAMES = 4, 5, 24, 40
DECAY = {"cls": "ExponentialDecay", "kwargs": {
    "initial_learning_rate": 0.01, "decay_steps": 2, "decay_rate": 0.5}}
COSINE = {"cls": "CosineDecay", "kwargs": {"initial_learning_rate": 0.01,
                                           "decay_steps": 3, "alpha": 0.1}}
OPTIMIZERS = {
    "adam": ("Adam", {"learning_rate": 0.01}),
    "adamw": ("AdamW", {"learning_rate": 0.01, "weight_decay": 0.05}),
    "sgd": ("SGD", {"learning_rate": 0.05}),
    "sgd_momentum": ("SGD", {"learning_rate": 0.05, "momentum": 0.9,
                             "nesterov": True}),
    "rmsprop": ("RMSprop", {"learning_rate": 0.01, "momentum": 0.5}),
    "adagrad": ("Adagrad", {"learning_rate": 0.1}),
}


def feature_batches(n, seed, frames=FRAMES):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = rng.integers(0, N_CLASSES, B).astype(np.int32)
        x = rng.normal(0, 1, (B, frames, MEL)).astype(np.float32)
        for i, k in enumerate(y):
            x[i, :, 4 * k:4 * k + 4] += 1.0
        out.append({"input": x, "target": y})
    return out


def as_tensors(batch):
    return {k: torch.as_tensor(np.asarray(v, np.int64 if k == "target"
                                          else v.dtype))
            for k, v in batch.items()}


def same_tensors(a, b):
    ta, tb = graphs.state_tensors(a), graphs.state_tensors(b)
    return len(ta) == len(tb) and all(torch.equal(x, y)
                                      for x, y in zip(ta, tb))


def same_counts(a, b):
    def ints(node):
        if isinstance(node, dict):
            return [i for v in node.values() for i in ints(v)]
        if isinstance(node, (list, tuple)):
            return [i for v in node for i in ints(v)]
        return [node] if isinstance(node, int) else []
    return a.step == b.step and ints(a.opt_state) == ints(b.opt_state)


@pytest.fixture(scope="module", autouse=True)
def memoized_init():
    """Each model structure and seed draws its weights once in this file."""
    with memoized():
        yield


# -- the donating step -----------------------------------------------------------

@pytest.fixture(scope="module")
def dropout_model():
    return tmodels.create("xvector", (FRAMES, MEL), N_CLASSES,
                          channel_dropout_rate=0.3, device="cpu")


@pytest.mark.parametrize("scheduled", [False, True],
                         ids=["constant", "scheduled"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_donating_step_equals_functional(dropout_model, name, scheduled):
    cls, kwargs = OPTIMIZERS[name]
    if scheduled:
        kwargs = dict(kwargs, lr_scheduler=COSINE if name == "sgd"
                      else DECAY)
    trainers = []
    for _ in range(2):
        opt, lr = topt.optimizer_from_config({"cls": cls, "kwargs": kwargs})
        trainer = tloop.Trainer(dropout_model, opt, tlosses.nll_loss,
                                lr_schedule=lr, rng=3, device="cpu")
        trainer.create_state()
        trainers.append(trainer)
    functional, donating = trainers
    held = graphs.state_tensors(donating.state)
    for batch in feature_batches(4, seed=1):
        batch = as_tensors(batch)
        functional.state, ref = functional._train_step(
            functional.state, batch, functional.generator)
        donating.state, loss = donating._fit_step(donating.state, batch,
                                                  donating.generator)
        assert torch.equal(loss, ref)
        assert same_tensors(donating.state, functional.state)
        assert same_counts(donating.state, functional.state)
    # written in place: the same tensors throughout
    assert all(a is b for a, b in zip(graphs.state_tensors(donating.state),
                                      held))
    assert torch.equal(donating.generator.get_state(),
                       functional.generator.get_state())


def test_step_scalars_are_the_eager_floats():
    """The scalars a graph's buffers receive are the floats the functional
    update divides and multiplies by, and advance_counts is what one
    update does to the counts."""
    params = {"w": torch.ones(3)}
    for cls, kwargs in list(OPTIMIZERS.values()) + [
            ("Adam", {"learning_rate": 0.0, "lr_scheduler": DECAY,
                      "clipnorm": 1.0})]:
        opt, _ = topt.optimizer_from_config({"cls": cls, "kwargs": kwargs})
        state = opt.init(params)
        for _ in range(3):
            scalars = opt.scalars(state)
            assert all(isinstance(v, float) for v in scalars)
            grads = {"w": torch.full((3,), 0.5)}
            eager, new = opt.update(grads, state, params)
            tensor, _ = opt.update(grads, state, params, scalars=[
                torch.tensor(v, dtype=torch.float32) for v in scalars])
            assert torch.equal(eager["w"], tensor["w"])
            assert same_counts(
                tloop.TrainState(0, {}, {}, topt.advance_counts(state)),
                tloop.TrainState(0, {}, {}, new))
            state = new
    adam, _ = topt.optimizer_from_config({"cls": "Adam", "kwargs": {
        "lr_scheduler": DECAY}})
    state = topt.advance_counts(adam.init(params))
    c1, c2, step = adam.scalars(state)
    assert c1 == float(np.float32(1) - np.float32(0.9) ** np.float32(2))
    assert c2 == float(np.float32(1) - np.float32(0.999) ** np.float32(2))
    assert step == -0.01 * 0.5 ** 0.5


# -- fit_fused: donating and replayed against functional --------------------------

class FakeGraph:
    def __init__(self, run):
        self.run = run

    def replay(self):
        self.run()


def fake_capture(program, trainer, state, inputs, generator, scalars, seed):
    """A stand-in capture: the static buffers of a real one, and a replay
    that runs the donating step on them with the program's generators."""
    device = trainer.device
    static, buffers, loss = program.static_buffers(device, inputs, scalars)
    augment = (program._augment_generator(device, seed) if program.augment
               else None)
    graphs.captures[program.kind] += 1
    owner = weakref.ref(trainer)  # as a graph, no reference to the trainer

    def run():
        program._body(owner(), state, static, generator, augment, buffers,
                      loss)
    return graphs._Captured(FakeGraph(run), static, buffers, loss, [],
                            generator)


@pytest.fixture
def replayed(monkeypatch):
    monkeypatch.setattr(graphs.StepProgram, "_graphed",
                        lambda self, trainer: True)
    monkeypatch.setattr(graphs.StepProgram, "_capture", fake_capture)


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


@pytest.fixture(scope="module")
def noise_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("noise")
    rng = np.random.default_rng(7)
    for i in range(2):
        tio.write_mono_wav(str(root / f"n{i}.wav"),
                           rng.uniform(-0.5, 0.5, RATE).astype(np.float32),
                           RATE)
    return root


def fused_config(cache_dir, shuffle, noise_dir=None):
    augment = {}
    if noise_dir is not None:
        augment = {"noise_datadir": str(noise_dir), "noise_max_seconds": 1.0,
                   "snr_range": [5, 20], "augment_prob": 0.5, "fir_coefs": 10,
                   "speed_range": [0.9, 1.1], "vad": True,
                   "vad_min_non_speech_ms": 0,
                   "specaug": {"time_masks": 2, "freq_masks": 2}}
    return {
        "features": {"type": "logmelspectrogram", "sample_rate": RATE,
                     "melspectrogram": {"num_mel_bins": MEL},
                     "stft_method": "pallas", "on_device_augment": augment},
        "experiment": {
            "cache_directory": str(cache_dir), "name": "graphs",
            "input_shape": [None, MEL], "output_shape": [N_CLASSES],
            "model": {"key": "xvector",
                      "kwargs": {"channel_dropout_rate": 0.2}},
            "optimizer": {"cls": "Adam", "kwargs": {"learning_rate": 1e-3}},
            "loss": {"cls": "SparseCategoricalCrossentropy"},
            "callbacks": [],
            "feed": {"stage_dtype": "int16", "steps_per_dispatch": 2,
                     "cache_staged": True, "cache_shuffle": shuffle}}}


def fit_fused(root, shuffle, noise_dir, eager):
    """2 epochs of 4 batches (epoch 2 replays the cache) and the trainer."""
    wrapper = ModelWrapper.from_config(fused_config(root, shuffle, noise_dir),
                                       device="cpu")
    wrapper.model.init(torch.Generator().manual_seed(5))
    conf = wrapper.config["features"]
    feature_fn = tdev.feature_fn_from_config(RATE, conf, device="cpu")
    batches = noisy_sines(4, seed=8)
    history = tdev.fit_signals(
        wrapper.trainer, feature_fn, lambda: batches, epochs=2, verbose=False,
        steps_per_dispatch=2, cache_staged=True, cache_shuffle=shuffle,
        eager=eager)
    return history, wrapper.trainer


SHUFFLES = [False, True, "rows"]


@pytest.fixture(scope="module")
def functional_runs(tmp_path_factory, noise_dir):
    root = tmp_path_factory.mktemp("functional")
    return {(chain, str(shuffle)): fit_fused(
        root / f"{chain}{shuffle}", shuffle,
        noise_dir if chain == "augmented" else None, eager=True)
            for chain in ("clean", "augmented") for shuffle in SHUFFLES}


@pytest.mark.parametrize("mode", ["donating", "replayed"])
@pytest.mark.parametrize("shuffle", SHUFFLES, ids=str)
@pytest.mark.parametrize("chain", ["clean", "augmented"])
def test_fit_fused_equals_functional(functional_runs, tmp_path, noise_dir,
                                     request, chain, shuffle, mode):
    if mode == "replayed":
        request.getfixturevalue("replayed")
    ref_history, ref = functional_runs[(chain, str(shuffle))]
    before = graphs.captures["fused"]
    history, trainer = fit_fused(
        tmp_path, shuffle, noise_dir if chain == "augmented" else None,
        eager=False)
    assert history == ref_history
    assert same_tensors(trainer.state, ref.state)
    assert same_counts(trainer.state, ref.state) and trainer.state.step == 8
    assert not trainer._programs  # the fit freed its captured steps
    # one capture per signature: the packed stream and the row gathers
    assert graphs.captures["fused"] - before == (
        0 if mode == "donating" else 2 if shuffle == "rows" else 1)


# -- Trainer.fit -----------------------------------------------------------------

def fit_features(feed, eager_reference=False):
    model = tmodels.create("xvector_2d", (FRAMES, MEL), N_CLASSES,
                           device="cpu")
    model.init(torch.Generator().manual_seed(4))
    trainer = tloop.Trainer(model, topt.adam(1e-3), tlosses.nll_loss,
                            device="cpu")
    if eager_reference:
        trainer._fit_step = lambda state, batch, generator=None: (
            trainer._train_step(state, graphs._materialized(batch),
                                generator))
    batches = feature_batches(4, 12)
    history = trainer.fit(lambda: batches, lambda: batches[:2], epochs=2,
                          verbose=False, **feed)
    return [{k: h[k] for k in ("loss", "val_loss")} for h in history], trainer


@pytest.mark.parametrize("feed", [
    {"steps_per_dispatch": 2, "cache_staged": True, "cache_shuffle": "rows"},
    {"cache_staged": True, "cache_shuffle": True}], ids=["rows", "batches"])
def test_trainer_fit_replayed_equals_functional(replayed, feed):
    ref_history, ref = fit_features(feed, eager_reference=True)
    history, trainer = fit_features(feed)
    assert history == ref_history
    assert same_tensors(trainer.state, ref.state)
    assert trainer.state.batch_stats and same_counts(trainer.state, ref.state)


# -- the signature cache ---------------------------------------------------------

def test_signature_cache_and_launch_counts(replayed):
    model = tmodels.create("xvector", (FRAMES, MEL), N_CLASSES, device="cpu")
    trainer = tloop.Trainer(model, topt.adam(1e-3), tlosses.nll_loss,
                            device="cpu")
    trainer.create_state()
    feature_fn = tdev.feature_fn_from_config(
        RATE, {"type": "logmelspectrogram", "sample_rate": RATE,
               "melspectrogram": {"num_mel_bins": MEL},
               "stft_method": "pallas"}, device="cpu")
    step = tdev.make_fused_train_step(trainer, feature_fn)
    program = trainer._programs["fused"][2]
    x = torch.zeros((B, 8000), dtype=torch.int16)
    y = torch.zeros(B, dtype=torch.int64)
    packed = torch.zeros((B + 1, 8000), dtype=torch.int16)
    mask = torch.ones(B, dtype=torch.bool)
    before = graphs.captures["fused"]
    cases = [(x, y, None), (x[:, :7200].contiguous(), y, None),
             (packed, None, None), (x, y, mask), (x, y, None),
             (packed, None, None)]
    for signals, targets, example_mask in cases:
        trainer.state, _ = step(trainer.state, signals, targets,
                                trainer.generator, example_mask)
    assert len(program._captured) == graphs.captures["fused"] - before == 4
    # the kernels count their launches on the card: none on the CPU
    assert logmel.launch_counts("cpu") == {"logmel_kernel": 0,
                                           "logmel_reduce": 0}
    trainer.state, _ = step(trainer.state, x, y, None)  # another generator
    assert len(program._captured) == 5
    # another state's tensors (a restore): captured anew for them
    trainer.create_state()
    trainer.state, _ = step(trainer.state, x, y, trainer.generator)
    assert (len(program._captured) == 1
            and graphs.captures["fused"] - before == 6)
    keys = {graphs.StepProgram.signature(
        {"signals": s, "targets": t, "example_mask": m}, (1.0, 1.0), None)
        for s, t, m in cases}
    assert len(keys) == 4
    # released: the trainer holds no program, the program no graph
    trainer.release_graphs()
    assert not trainer._programs and not program._captured


def test_capture_holds_the_kernel_operands(monkeypatch):
    """The tiles a launch reads come from caches that may drop them; within
    ``holding_operands`` (a capture) each launch's tiles are appended to
    the held list, which keeps them alive after the caches drop them."""
    monkeypatch.setattr(logmel, "device_limits",
                        lambda device: (132, 227 * 1024))
    cpu = torch.device("cpu")
    key = logmel._key(RATE, 400, 512, MEL, 0.0, 8000.0, "highest")

    def evict():
        logmel._launch_config.cache_clear()
        logmel._device_bases.cache_clear()
        gc.collect()

    evict()
    try:
        with logmel.holding_operands([]) as held:
            W, M = logmel._operands(key, B, 8000, 160, cpu)[:2]
            logmel._operands(key, B, 7200, 160, cpu)
        logmel._operands(key, B, 6400, 160, cpu)  # no capture: not held
        assert len(held) == 2 and held[0][0] is W and held[0][1] is M
        refs = [weakref.ref(t) for pair in held for t in pair]
        del W, M
        evict()
        assert all(r() is not None for r in refs)
        held.clear()
        gc.collect()
        assert all(r() is None for r in refs)
    finally:
        evict()


# -- eager by rule ---------------------------------------------------------------

def test_eager_by_rule_is_logged_once(replayed, caplog):
    batch = as_tensors(feature_batches(1, 3)[0])
    ragged = torch.arange(FRAMES)[None, :] < torch.tensor(
        [FRAMES, 31, 1, 17])[:, None]
    masked = dict(batch, input_mask=ragged)

    def trainer_for(key, **kw):
        model = tmodels.create(key, (FRAMES, MEL), N_CLASSES, device="cpu")
        trainer = tloop.Trainer(model, topt.adam(1e-3), tlosses.nll_loss,
                                device="cpu", **kw)
        trainer.create_state()
        return trainer

    def run(trainer, batch, times=2):
        """The number of captures of ``times`` steps; the steps write into
        the state's tensors whether captured or not."""
        held = graphs.state_tensors(trainer.state)
        before = graphs.captures["features"]
        for _ in range(times):
            trainer.state, _ = trainer._fit_step(trainer.state, batch,
                                                 trainer.generator)
        assert all(a is b for a, b in zip(
            graphs.state_tensors(trainer.state), held))
        return graphs.captures["features"] - before

    with caplog.at_level(logging.INFO, logger="lidbox_tpu_torch"):
        bigru = trainer_for("bi_gru")
        assert run(bigru, batch) == 1     # no mask: captured
        assert run(bigru, masked) == 1    # masked: captured, its own graph
        remat = trainer_for("xvector")
        remat.remat = True
        assert run(remat, batch) == 1
        one_rank = trainer_for("xvector", mesh=parallel.get_mesh(
            device="cpu"))
        assert one_rank.mesh.size == 1 and run(one_rank, batch) == 1
        for trainer in (bigru, remat, one_rank):
            assert graphs.eager_reason(trainer) is None
        meshed = trainer_for("xvector")
        meshed.mesh = types.SimpleNamespace(size=2)  # the rule reads its size
        calls = []
        program = meshed.step_program("features")
        program._run_eagerly = lambda trainer, state, inputs, *args: (
            calls.append(inputs) or torch.zeros(()))
        assert run(meshed, batch) == 0
        assert len(calls) == 2
    logged = [r.getMessage() for r in caplog.records
              if "runs eagerly" in r.getMessage()]
    assert len(logged) == 1, logged
    assert "several ranks" in logged[0]
    assert graphs.eager_reason(meshed) == graphs.forward_reason(meshed.mesh)


# -- recurrent models on frame masks, remat ------------------------------------

# VAD and speed change: the feature fn tracks lengths, so every batch
# carries a frame mask (different lengths per row)
LENGTH_CHAIN = {"speed_range": [0.9, 1.1], "vad": True,
                "vad_min_non_speech_ms": 0}
RNN_MEL = 32  # crnn's five 2 x 2 pools need 32 bins
# samples of a batch's signals: crnn's pools halve its frames 5 times
RNN_SAMPLES = {"bi_gru": RATE // 2, "crnn": RATE}


def fit_masked(root, key, eager):
    """``fit_signals`` of ``key`` for one epoch of 2 batches through the
    length-tracking chain, validating on 1 batch through it: (history,
    trainer, the masks of the first batch's features)."""
    features = {"type": "logmelspectrogram", "sample_rate": RATE,
                "melspectrogram": {"num_mel_bins": RNN_MEL},
                "stft_method": "pallas", "on_device_augment": LENGTH_CHAIN}
    wrapper = ModelWrapper.from_config({
        "features": features,
        "experiment": {
            "cache_directory": str(root), "name": "masked",
            "input_shape": [None, RNN_MEL], "output_shape": [N_CLASSES],
            "model": {"key": key},
            "optimizer": {"cls": "Adam", "kwargs": {"learning_rate": 1e-3}},
            "loss": {"cls": "SparseCategoricalCrossentropy"},
            "callbacks": []}}, device="cpu")
    wrapper.model.init(torch.Generator().manual_seed(5))
    feature_fn = tdev.feature_fn_from_config(RATE, features, device="cpu")
    assert feature_fn.tracks_lengths
    batches = noisy_sines(3, seed=9, samples=RNN_SAMPLES[key])
    x = torch.as_tensor(batches[0][0])
    _, mask = feature_fn(tloop.keyed_generator("cpu", 0, 0, 7), x)
    history = tdev.fit_signals(
        wrapper.trainer, feature_fn, lambda: batches[:2], epochs=1,
        verbose=False, val_batches=lambda: batches[2:], eager=eager)
    return history, wrapper.trainer, mask


@pytest.fixture(scope="module")
def masked_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("masked")
    return {key: fit_masked(root / key, key, eager=True)
            for key in ("bi_gru", "crnn")}


@pytest.mark.parametrize("key", ["bi_gru", "crnn"])
def test_masked_recurrent_fit_equals_functional(masked_runs, tmp_path,
                                                replayed, key):
    ref_history, ref, mask = masked_runs[key]
    lengths = mask.sum(dim=1)
    assert len(set(lengths.tolist())) > 1 and (lengths < mask.shape[1]).any()
    before = graphs.captures["fused"]
    history, trainer, _ = fit_masked(tmp_path, key, eager=False)

    def results(h):  # the epochs' results, without the throughputs
        return [{k: v for k, v in e.items()
                 if k not in ("examples_per_sec", "audio_rtf")} for e in h]
    assert results(history) == results(ref_history)
    assert np.isfinite(history[0]["val_loss"])
    assert same_tensors(trainer.state, ref.state)
    assert same_counts(trainer.state, ref.state) and trainer.state.step == 2
    assert graphs.captures["fused"] - before == 1


@pytest.mark.parametrize("mode", ["donating", "replayed"])
def test_remat_step_equals_functional(request, mode):
    """The remat step with channel dropout 0.5: the recompute draws the
    forward's masks, so the donating step (replayed or not) writes the
    functional remat step's bits and leaves the dropout generator where it
    leaves it."""
    if mode == "replayed":
        request.getfixturevalue("replayed")
    model = tmodels.create("xvector", (FRAMES, MEL), N_CLASSES,
                           channel_dropout_rate=0.5, device="cpu")
    trainers = []
    for _ in range(2):
        trainer = tloop.Trainer(model, topt.adam(1e-3), tlosses.nll_loss,
                                rng=3, device="cpu")
        trainer.remat = True
        trainer.create_state()
        trainers.append(trainer)
    functional, donating = trainers
    before = graphs.captures["features"]
    for batch in feature_batches(4, seed=2):
        batch = as_tensors(batch)
        functional.state, ref = functional._train_step(
            functional.state, batch, functional.generator)
        donating.state, loss = donating._fit_step(donating.state, batch,
                                                  donating.generator)
        assert torch.equal(loss, ref)
        assert same_tensors(donating.state, functional.state)
    assert torch.equal(donating.generator.get_state(),
                       functional.generator.get_state())
    assert graphs.captures["features"] - before == (mode == "replayed")


def test_a_trainer_goes_with_its_last_reference(replayed):
    """A program holds no reference to its trainer, so a trainer and its
    captured steps form no cycle: they go with the last reference to the
    trainer, without the cyclic collector."""
    model = tmodels.create("xvector", (FRAMES, MEL), N_CLASSES, device="cpu")
    trainer = tloop.Trainer(model, topt.adam(1e-3), tlosses.nll_loss,
                            device="cpu")
    trainer.create_state()
    feature_fn = tdev.feature_fn_from_config(
        RATE, {"type": "logmelspectrogram", "sample_rate": RATE,
               "melspectrogram": {"num_mel_bins": MEL},
               "stft_method": "pallas"}, device="cpu")
    step = tdev.make_fused_train_step(trainer, feature_fn)
    trainer.state, _ = step(trainer.state, torch.zeros((B, 8000)),
                            torch.zeros(B, dtype=torch.int64),
                            trainer.generator)
    trainer.state, _ = trainer._fit_step(
        trainer.state, as_tensors(feature_batches(1, 5)[0]),
        trainer.generator)
    programs = [p for _, _, p in trainer._programs.values()]
    assert len(programs) == 2 and all(p._captured for p in programs)
    freed = weakref.ref(trainer)
    gc.disable()
    try:
        del trainer, step
        assert freed() is None
    finally:
        gc.enable()
