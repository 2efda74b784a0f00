"""
The port's training path against lidbox_tpu's, on the CPU.

- Checkpoints: the same file names and best-checkpoint choices as
  lidbox_tpu.train.checkpoint on the same file lists (NaN included); a
  save/restore round trip is exact.
- Trainer.fit on feature batches (full-width x-vector, b4 x 48 frames x 24
  mel, Adam, 3 steps) from the JAX model's initial weights
  (``params_from_flax``): step losses within rtol 1e-4, params after one
  step within atol 1e-6 + rtol 1e-5, and evaluate() with an example mask:
  val_loss within 1e-5 and C_avg within 1e-6. The data puts every score
  more than 1e-3 from every C_avg threshold (asserted), so the two float32
  evaluations cannot count a decision differently.
- compute_dtype=torch.bfloat16 trains within the bound that
  tests/test_train.py::test_bf16_compute_trains_and_matches_f32_trajectory
  asserts for the JAX package.
- The slice as a whole: ModelWrapper.from_config(...).fit_fused with
  ``stft_method: "pallas"`` and ``on_device_augment: {}`` on the CPU (the
  kernel's plain version) against the JAX package's fit_fused with its
  Pallas kernel in interpret mode: 2 epochs of 2 batches of b4 x 0.5 s,
  history within rtol 1e-4 and the same checkpoint names.
- The faults this slice repaired: fused_logmel refuses a signal that
  requires grad, and dropout masks come from the trainer's generator.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import lidbox_tpu.models as jmodels
import lidbox_tpu_torch.models as tmodels
from lidbox_tpu import losses as jlosses
from lidbox_tpu import metrics as jmetrics
from lidbox_tpu.train import checkpoint as jckpt
from lidbox_tpu.train import loop as jloop
from lidbox_tpu.train import optimizers as jopt
from lidbox_tpu_torch import losses as tlosses
from lidbox_tpu_torch import metrics as tmetrics
from lidbox_tpu_torch.data import on_device
from lidbox_tpu_torch.models import layers
from lidbox_tpu_torch.models.model_utils import ModelWrapper
from lidbox_tpu_torch.ops import logmel
from lidbox_tpu_torch.train import checkpoint as tckpt
from lidbox_tpu_torch.train import loop as tloop
from lidbox_tpu_torch.train import optimizers as topt

torch.set_num_threads(2)

RATE = 16000
B, T, FEAT, N_CLASSES = 4, 48, 24, 5
ADAM = {"cls": "Adam", "kwargs": {"learning_rate": 1e-3}}
# Adam's first update is lr * g / (|g| + eps): where |g| sits near Keras'
# eps of 1e-7 (a few of the x-vector's weights), two float32 gradients
# that agree to 1e-9 give updates 1e-5 apart. eps 1e-4 keeps the
# one-step parameter comparison about the gradients, not that division.
ADAM_COMPARED = {"cls": "Adam", "kwargs": {"learning_rate": 1e-3,
                                           "epsilon": 1e-4}}
THRESHOLDS = tuple(float(t) for t in np.linspace(-10.0, 0.0, 11))


def feature_batches(n, seed, mask=False):
    """Class-separable features: class k has mean +1 in channels 4k..4k+3."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = rng.integers(0, N_CLASSES, B).astype(np.int32)
        x = rng.normal(0, 1, (B, T, FEAT)).astype(np.float32)
        for i, k in enumerate(y):
            x[i, :, 4 * k:4 * k + 4] += 1.0
        batch = {"input": x, "target": y}
        if mask:
            batch["example_mask"] = np.array([True, True, False, True])
        out.append(batch)
    return out


def one_per_epoch(batches):
    """A train feed whose every epoch is the next batch: a 1-step epoch's
    loss is that step's loss."""
    it = iter(batches)
    return lambda: [next(it)]


@pytest.fixture(scope="module")
def feature_runs():
    """The same 3 Adam steps and evaluations in both packages."""
    jm = jmodels.create("xvector", (T, FEAT), N_CLASSES).init()
    tm = tmodels.create("xvector", (T, FEAT), N_CLASSES, device="cpu")
    tm.load_flax_params(jax.device_get(jm.variables["params"]))
    trainers = {}
    for name, pkg in (("jax", (jopt, jloop, jlosses, jmetrics, jm)),
                      ("torch", (topt, tloop, tlosses, tmetrics, tm))):
        opt, loop, losses, metrics, model = pkg
        optimizer, _ = opt.optimizer_from_config(ADAM_COMPARED)
        kw = {} if name == "jax" else {"device": "cpu"}
        trainers[name] = loop.Trainer(
            model, optimizer, losses.nll_loss,
            metrics={"C_avg": metrics.SparseAverageDetectionCost(
                N_CLASSES, THRESHOLDS)}, **kw)
    train, val = feature_batches(3, seed=0), feature_batches(2, 1, mask=True)
    out = {}
    for name, trainer in trainers.items():
        trainer.create_state()
        h1 = trainer.fit(one_per_epoch(train[:1]), epochs=1, verbose=False)
        params1 = jax.tree_util.tree_map(np.asarray, jax.device_get(
            trainer.state.params)) if name == "jax" else {
                k: v.numpy().copy() for k, v in trainer.state.params.items()}
        h2 = trainer.fit(one_per_epoch(train[1:]), epochs=2, verbose=False)
        out[name] = {"losses": [h["loss"] for h in h1 + h2],
                     "params1": params1,
                     "eval": trainer.evaluate(lambda: val),
                     "trainer": trainer}
    return out, val


def test_trainer_losses_match_jax(feature_runs):
    runs, _ = feature_runs
    assert len(runs["torch"]["losses"]) == 3
    np.testing.assert_allclose(runs["torch"]["losses"], runs["jax"]["losses"],
                               rtol=1e-4)


def test_params_after_one_step_match_jax(feature_runs):
    runs, _ = feature_runs
    ours = runs["torch"]["params1"]
    ref = {k: v.numpy() for k, v in tmodels.model_api.params_from_flax(
        runs["jax"]["params1"]).items()}
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-6, rtol=1e-5,
                                   err_msg=k)


def test_evaluate_with_example_mask_matches_jax(feature_runs):
    runs, val = feature_runs
    jt = runs["jax"]["trainer"]
    scores = np.concatenate([np.asarray(jt.model.apply(
        {"params": jt.state.params}, jnp.asarray(b["input"])))[b["example_mask"]]
        for b in val])
    margin = np.abs(scores[..., None] - np.asarray(THRESHOLDS)).min()
    assert margin > 1e-3, margin
    ours, ref = runs["torch"]["eval"], runs["jax"]["eval"]
    assert set(ours) == set(ref) == {"val_loss", "val_C_avg"}
    np.testing.assert_allclose(ours["val_loss"], ref["val_loss"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ours["val_C_avg"], ref["val_C_avg"], atol=1e-6)
    # the masked example counts nowhere: dropping it gives the same loss
    tt = runs["torch"]["trainer"]
    kept = [{"input": b["input"][b["example_mask"]],
             "target": b["target"][b["example_mask"]]} for b in val]
    np.testing.assert_allclose(tt.evaluate(lambda: kept)["val_loss"],
                               ours["val_loss"], rtol=1e-6)


def test_trainer_state_and_model_after_fit(feature_runs):
    runs, val = feature_runs
    tt = runs["torch"]["trainer"]
    assert tt.state.step == 3 and not tt.model.module.training
    for k, p in tt.model.module.named_parameters():
        assert torch.equal(p, tt.state.params[k])  # synced, not aliased
        assert p.data_ptr() != tt.state.params[k].data_ptr()
    out = tt.predict(lambda: val)
    assert out.shape == (2 * B, N_CLASSES) and out.dtype == np.float32


def test_checkpoint_round_trip_is_exact(feature_runs, tmp_path):
    runs, val = feature_runs
    tt = runs["torch"]["trainer"]
    path = tckpt.save_checkpoint(str(tmp_path), tt.state, epoch=3,
                                 val_loss=0.25)
    assert os.path.basename(path) == "epoch000003__val_loss0.250000000000.ckpt"
    model = tmodels.create("xvector", (T, FEAT), N_CLASSES, device="cpu")
    fresh = tloop.Trainer(model,
                          topt.optimizer_from_config(ADAM_COMPARED)[0],
                          tlosses.nll_loss, metrics=tt.metrics, device="cpu")
    fresh.restore(path)
    assert fresh.initial_epoch == 3 and fresh.state.step == tt.state.step
    for k in tt.state.params:
        assert torch.equal(fresh.state.params[k], tt.state.params[k])
    adam, ref = fresh.state.opt_state[0], tt.state.opt_state[0]
    assert adam["count"] == ref["count"] == 3
    assert all(torch.equal(a, b) for a, b in zip(adam["nu"], ref["nu"]))
    assert fresh.evaluate(lambda: val) == tt.evaluate(lambda: val)
    with pytest.raises(ValueError, match="keys differ"):
        tckpt.restore_checkpoint(path, fresh.state.replace(
            params={"frame1.conv.weight": fresh.state.params[
                "frame1.conv.weight"]}))


CKPT_CASES = [
    ([(1, 0.5), (2, 0.25), (3, 0.4)], "val_loss", "min"),
    ([(1, 0.5), (2, 0.25), (3, 0.4)], "val_loss", "max"),
    ([(1, float("nan")), (2, 0.3), (3, 0.7)], "val_loss", "min"),
    ([(1, float("nan")), (2, float("nan"))], "val_loss", "min"),
    ([(4, 0.1), (12, 0.9), (7, 0.2)], None, None),
]


@pytest.mark.parametrize("entries,key,mode", CKPT_CASES)
def test_checkpoint_names_and_best_match_jax(tmp_path, entries, key, mode):
    """Both packages write the same names for the same (epoch, val_loss)
    and pick the same best file out of the same directory, with an Orbax
    directory and a killed-write temp directory among the candidates."""
    state = tloop.TrainState(step=0, params={"w": torch.zeros(2)},
                             batch_stats={}, opt_state=())
    for epoch, value in entries:
        ours = tckpt.save_checkpoint(str(tmp_path), state, epoch, value)
        os.unlink(ours)
        ref = jckpt.save_checkpoint(str(tmp_path), {"w": np.zeros(2)}, epoch,
                                    value)
        assert os.path.basename(ours) == os.path.basename(ref)
    (tmp_path / "epoch000005__val_loss0.050000000000").mkdir()
    (tmp_path / "epoch000009.orbax-checkpoint-tmp-1").mkdir()
    (tmp_path / "notes.txt").write_text("not a checkpoint")
    best = tckpt.get_best_checkpoint_path(str(tmp_path), key, mode)
    assert best == jckpt.get_best_checkpoint_path(str(tmp_path), key, mode)
    if key is not None:
        with pytest.raises(ValueError):
            tckpt.get_best_checkpoint_path(str(tmp_path), key, "median")
    assert tckpt.get_best_checkpoint_path(str(tmp_path / "none")) is None


def test_foreign_checkpoints_raise(tmp_path):
    msgpack = jckpt.save_checkpoint(str(tmp_path), {"w": np.zeros(2)}, 1, 0.1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tckpt.load_raw_checkpoint(msgpack)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tckpt.load_raw_checkpoint(str(tmp_path))


def toy_batches(n_batches=6, batch=16, seed=0):
    """tests/test_train.py's toy data: class k has mean +2 in channel k."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        y = rng.integers(0, 3, batch)
        x = rng.normal(0, 1, (batch, 24, 8)).astype(np.float32)
        for i, k in enumerate(y):
            x[i, :, k] += 2.0
        out.append({"input": x, "target": y.astype(np.int32)})
    return out


def test_bf16_compute_trains_within_the_jax_bound():
    model = tmodels.create("xvector", (24, 8), 3, device="cpu")
    trainer = tloop.Trainer(model, topt.adam(5e-3), tlosses.nll_loss,
                            compute_dtype=torch.bfloat16, device="cpu")
    batches = toy_batches()
    h = trainer.fit(lambda: batches, epochs=4, verbose=False)
    assert h[-1]["loss"] < h[0]["loss"] * 0.8, h
    assert all(p.dtype == torch.float32 for p in trainer.state.params.values())
    assert all(m.dtype == torch.float32
               for m in trainer.state.opt_state[0]["mu"])
    out = trainer.predict(lambda: toy_batches(1))
    assert out.dtype == np.float32
    np.testing.assert_allclose(np.exp(out).sum(axis=1), 1.0, rtol=1e-2)
    # Model.apply takes the same casts
    x = torch.as_tensor(batches[0]["input"])
    with torch.no_grad():
        y16 = model.apply(x, compute_dtype=torch.bfloat16)
        y32 = model.apply(x)
    assert y16.dtype == torch.float32
    # bfloat16 keeps 8 significant bits: 0.4% per rounding
    np.testing.assert_allclose(y16.numpy(), y32.numpy(), rtol=2e-2, atol=0.1)


def noisy_sines(n_batches, seed, seconds=0.5):
    rng = np.random.default_rng(seed)
    t = np.arange(int(RATE * seconds)) / RATE
    out = []
    for _ in range(n_batches):
        y = rng.integers(0, N_CLASSES, B)
        x = (np.sin(2 * np.pi * (200.0 + 300.0 * y[:, None]) * t)
             + 0.1 * rng.normal(0, 1, (B, t.size)))
        out.append((x.astype(np.float32), y.astype(np.int32)))
    return out


def fused_config(cache_dir, **features):
    return {
        "features": {"type": "logmelspectrogram", "sample_rate": RATE,
                     "melspectrogram": {"num_mel_bins": 64},
                     "stft_method": "pallas", "on_device_augment": {},
                     **features},
        "experiment": {
            "cache_directory": str(cache_dir), "name": "fused",
            "input_shape": [None, 64], "output_shape": [N_CLASSES],
            "model": {"key": "xvector"}, "optimizer": ADAM,
            "loss": {"cls": "SparseCategoricalCrossentropy"},
            "metrics": [{"cls": "SparseAverageDetectionCost", "N": N_CLASSES,
                         "threshold_linspace": {"start": -10.0, "stop": 0.0,
                                                "num": 11}}],
            "callbacks": [{"cls": "ModelCheckpoint",
                           "kwargs": {"monitor": "val_loss", "mode": "min"}},
                          {"cls": "EarlyStopping",
                           "kwargs": {"patience": 3}}]}}


@pytest.fixture(scope="module")
def fused_runs(tmp_path_factory):
    """ModelWrapper.fit_fused, 2 epochs of 2 batches, in both packages
    from the same initial weights."""
    from lidbox_tpu.models.model_utils import ModelWrapper as JWrapper
    root = tmp_path_factory.mktemp("fused")
    train, val = noisy_sines(2, seed=5), noisy_sines(1, seed=6)
    jw = JWrapper.from_config(fused_config(root / "jax"))
    jw.trainer.create_state()
    tw = ModelWrapper.from_config(fused_config(root / "torch"), device="cpu")
    tw.model.load_flax_params(jax.device_get(jw.model.variables["params"]))
    before = logmel.fused_logmel.launches
    th = tw.fit_fused(lambda: train, epochs=2, val_signal_batches=lambda: val,
                      verbose=False)
    assert logmel.fused_logmel.launches == before  # the CPU runs no kernel
    saved = os.environ.get("LIDBOX_PALLAS_INTERPRET")
    os.environ["LIDBOX_PALLAS_INTERPRET"] = "1"
    try:
        with pltpu.force_tpu_interpret_mode():
            jh = jw.fit_fused(lambda: train, epochs=2,
                              val_signal_batches=lambda: val, verbose=False)
    finally:
        if saved is None:
            del os.environ["LIDBOX_PALLAS_INTERPRET"]
        else:
            os.environ["LIDBOX_PALLAS_INTERPRET"] = saved
    dirs = {name: root / name / "xvector" / "fused" / "checkpoints"
            for name in ("jax", "torch")}
    return jh, th, dirs, tw


def test_fit_fused_history_matches_jax(fused_runs):
    jh, th, _, _ = fused_runs
    assert len(th) == len(jh) == 2
    for ours, ref in zip(th, jh):
        assert set(ours) == set(ref)
        for k in ("loss", "val_loss", "val_SparseAverageDetectionCost"):
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, err_msg=k)


def test_fit_fused_writes_the_same_checkpoints(fused_runs):
    """Same names, up to the float32 rounding of the val_loss digits: the
    epochs match and the values agree within rtol 1e-4."""
    _, _, dirs, _ = fused_runs
    names = {k: sorted(os.listdir(d)) for k, d in dirs.items()}
    assert len(names["torch"]) == len(names["jax"]) == 2
    for ours, ref in zip(names["torch"], names["jax"]):
        assert ours[:len("epoch000001__val_loss")] == \
            ref[:len("epoch000001__val_loss")]
        assert ours.endswith(".ckpt") and ref.endswith(".ckpt")
        np.testing.assert_allclose(
            float(tckpt.parse_checkpoint_value(ours, "val_loss")),
            float(jckpt.parse_checkpoint_value(ref, "val_loss")), rtol=1e-4)
    best = tckpt.get_best_checkpoint_path(str(dirs["torch"]), "val_loss", "min")
    ref = jckpt.get_best_checkpoint_path(str(dirs["jax"]), "val_loss", "min")
    assert os.path.basename(best)[:11] == os.path.basename(ref)[:11]


def test_fit_fused_entry_points(fused_runs, tmp_path):
    _, _, _, tw = fused_runs
    assert tw.count_params() == tw.model.num_params()
    cfg = fused_config(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ModelWrapper.from_config(cfg)
    no_rate = fused_config(tmp_path)
    del no_rate["features"]["sample_rate"]
    with pytest.raises(ValueError, match="sample_rate"):
        ModelWrapper.from_config(no_rate, device="cpu").fit_fused(lambda: [])
    with pytest.raises(ValueError, match="no training batches"):
        ModelWrapper.from_config(cfg, device="cpu").fit_fused(
            iter(noisy_sines(1, seed=7)), epochs=2)


@pytest.mark.parametrize("what", [
    "noise", "fir", "speed", "vad", "specaug", "snr_without_noise",
    "bad_prob", "steps_per_dispatch", "cache_staged", "mesh",
    "embedding_extractor", "orbax"])
def test_left_options_raise(tmp_path, what):
    cfg = fused_config(tmp_path)
    aug = {"noise": {"noise_paths": ["n.wav"], "snr_range": [5, 20]},
           "fir": {"fir_coefs": 5}, "speed": {"speed_range": [0.9, 1.1]},
           "vad": {"vad": True}, "specaug": {"specaug": {"time_masks": 1}},
           "snr_without_noise": {"snr_range": [5, 20]},
           "bad_prob": {"augment_prob": 5}}.get(what)
    if aug is not None:
        cfg["features"]["on_device_augment"] = aug
        error = (ValueError if what in ("snr_without_noise", "bad_prob")
                 else NotImplementedError)
        with pytest.raises(error):
            on_device.feature_fn_from_config(RATE, cfg["features"])
        return
    if what == "steps_per_dispatch":
        cfg["experiment"]["feed"] = {"steps_per_dispatch": 2}
    if what == "cache_staged":
        cfg["experiment"]["feed"] = {"cache_staged": True}
    if what == "orbax":
        cfg["experiment"]["callbacks"][0]["kwargs"]["backend"] = "orbax"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if what == "mesh":
            ModelWrapper.from_config(cfg, mesh=object(), device="cpu")
        elif what == "embedding_extractor":
            ModelWrapper.from_config_as_embedding_extractor_fn({})
        else:
            ModelWrapper.from_config(cfg, device="cpu").fit_fused(
                lambda: noisy_sines(1, seed=8))


class _ClaimsCuda(torch.Tensor):
    @property
    def device(self):
        return torch.device("cuda")


def test_fused_logmel_refuses_a_signal_that_requires_grad(monkeypatch):
    """The kernel has no backward: on either device a signal that requires
    grad raises, before any kernel or plain version runs."""
    monkeypatch.setattr(logmel, "_load_library", None)
    monkeypatch.setattr(logmel, "logmel_plain", None)
    cpu = torch.zeros(2, 16000, requires_grad=True)
    cuda = torch.Tensor._make_subclass(_ClaimsCuda, torch.zeros(2, 16000),
                                       require_grad=True)
    for x in (cpu, cuda):
        with pytest.raises(ValueError, match="no gradient"):
            logmel.fused_logmel(x, RATE)


def test_feature_fn_runs_without_grad():
    fn = on_device.make_augmented_feature_fn(
        RATE, {"melspectrogram": {"num_mel_bins": 24},
               "stft_method": "pallas"}, on_device.AugmentConfig(snr_range=None))
    x = torch.as_tensor(noisy_sines(1, seed=9)[0][0])
    with torch.enable_grad():
        feats = fn(None, x)
    assert feats.shape == (B, 48, 24) and not feats.requires_grad


def test_spatial_dropout_masks_come_from_the_generator():
    drop = layers.SpatialDropout1D(0.5).train()
    x = torch.ones(4, 9, 16)

    def draw(seed):
        return drop(x, generator=torch.Generator().manual_seed(seed))

    a, b, c = draw(3), draw(3), draw(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a, a.amax(dim=1, keepdim=True).expand_as(a))
    assert set(a.unique().tolist()) == {0.0, 2.0}


def test_trainer_dropout_is_seeded_by_its_generator():
    """Two trainers with one seed take identical dropout steps; another
    seed draws other masks. The module is back in eval mode after."""
    def losses(seed):
        model = tmodels.create("xvector", (24, 8), 3, device="cpu",
                               channel_dropout_rate=0.5)
        trainer = tloop.Trainer(model, topt.adam(1e-3), tlosses.nll_loss,
                                rng=seed, device="cpu")
        h = trainer.fit(lambda: toy_batches(2, batch=4), epochs=2,
                        verbose=False)
        assert not model.module.training
        return [e["loss"] for e in h]

    assert losses(1) == losses(1)
    assert losses(1) != losses(2)


@pytest.mark.parametrize("conf", [
    {"cls": "ModelCheckpoint", "kwargs": {"monitor": "val_loss",
                                          "filepath": "x", "verbose": 1}},
    {"cls": "ModelCheckpoint", "kwargs": {"save_freq_typo": 1}},
    {"cls": "EarlyStopping", "kwargs": {"patience": 2, "baseline": 0.1}},
    {"cls": "EarlyStopping", "kwargs": {"restore_best": True}},
    {"cls": "LearningRateDateLogger"},
    {"cls": "TensorBoard"},
    {"cls": "CSVLogger"},
])
def test_callback_factory_matches_jax(tmp_path, conf):
    """The same callbacks, and the same errors for unknown options and
    classes, from the config factory of both packages."""
    from lidbox_tpu.models import model_utils as jutils
    from lidbox_tpu_torch.models import model_utils as tutils
    try:
        ref = jutils.init_callback_from_config(conf, str(tmp_path))
    except Exception as e:  # the port must raise the same type
        with pytest.raises(type(e)):
            tutils.init_callback_from_config(conf, str(tmp_path))
        return
    ours = tutils.init_callback_from_config(conf, str(tmp_path))
    assert type(ours).__name__ == type(ref).__name__
    if ref is None:  # TensorBoard: the JSONL events log stands in
        return
    assert vars(ours).keys() <= vars(ref).keys()
    for k in ("monitor", "mode", "patience", "checkpoints_dir"):
        assert getattr(ours, k, None) == getattr(ref, k, None)


def test_loss_and_metric_factories_match_jax(fused_runs):
    from lidbox_tpu.models import model_utils as jutils
    from lidbox_tpu_torch.models import model_utils as tutils
    for conf, activation in (
            ({"cls": "SparseCategoricalCrossentropy"}, "log_softmax"),
            ({"cls": "SparseCategoricalCrossentropy"}, "softmax"),
            ({"cls": "SparseCategoricalCrossentropy"}, None),
            ({"cls": "SparseCategoricalCrossentropy",
              "kwargs": {"from_logits": True}}, "softmax"),
            ({"cls": "nll"}, "log_softmax")):
        assert (tutils.init_loss_from_config(conf, activation).__name__
                == jutils.init_loss_from_config(conf, activation).__name__)
    with pytest.raises(TypeError):
        tutils.init_loss_from_config({"cls": "SparseCategoricalCrossentropy",
                                      "kwargs": {"reduction": "sum"}})
    ap = tutils.init_loss_from_config({"cls": "AngularProximity",
                                       "kwargs": {"N": 3, "D": 4}})
    assert isinstance(ap, tlosses.AngularProximity)
    mconf = {"cls": "SparseAverageDetectionCost", "N": 3,
             "threshold_linspace": {"start": -4.0, "stop": 0.0, "num": 9}}
    ours, ref = (u.init_metric_from_config(mconf) for u in (tutils, jutils))
    assert ours.thresholds == ref.thresholds and ours.N == ref.N
    assert type(ours).__name__ == type(ref).__name__
    with pytest.raises(KeyError):
        tutils.init_metric_from_config({"cls": "Accuracy"})
    # the best checkpoint of the fit_fused run, as the config names it
    _, _, dirs, tw = fused_runs
    best = tutils.best_model_checkpoint_from_config(tw.config)
    assert best == tckpt.get_best_checkpoint_path(str(dirs["torch"]),
                                                  "val_loss", "min")


def test_early_stopping_restores_the_best_weights():
    """monitor="loss" in mode "max" makes every later (lower) epoch a miss:
    with patience 1 training stops after epoch 2 and the params go back to
    epoch 1's, the optimizer state stays epoch 2's."""
    model = tmodels.create("xvector", (24, 8), 3, device="cpu")
    stop = tloop.EarlyStopping(monitor="loss", mode="max", patience=1,
                               restore_best_weights=True)
    seen = {}

    class Snapshot(tloop.Callback):
        def on_epoch_end(self, trainer, epoch, logs):
            seen[epoch] = {k: v.clone() for k, v in trainer.state.params.items()}

    trainer = tloop.Trainer(model, topt.adam(5e-3), tlosses.nll_loss,
                            callbacks=[Snapshot(), stop], device="cpu")
    h = trainer.fit(lambda: toy_batches(2, batch=8), epochs=4, verbose=False)
    assert len(h) == 2 and h[1]["loss"] < h[0]["loss"] and trainer.stop_training
    assert trainer.state.step == 4 and trainer.state.opt_state[0]["count"] == 4
    for k, p in trainer.state.params.items():
        assert torch.equal(p, seen[1][k])
        assert torch.equal(dict(model.module.named_parameters())[k], p)


def test_batch_helpers_match_jax():
    """batches_from_dataset (padded to buckets, frame mask) and
    signal_batches_from_dataset give the JAX package's arrays."""
    rng = np.random.default_rng(11)
    feats = [{"input": rng.normal(0, 1, (n, 4)).astype(np.float32),
              "target": i % 3} for i, n in enumerate((5, 9, 7, 3, 8))]
    sigs = [{"signal": rng.normal(0, 1, 400).astype(np.float32),
             "target": i % 3} for i in range(5)]
    kw = dict(pad_buckets=[8, 16], frame_mask=True)
    for ours, ref in zip(tloop.batches_from_dataset(feats, 2, **kw)(),
                         jloop.batches_from_dataset(feats, 2, **kw)()):
        assert ours.keys() == ref.keys() == {"input", "target", "input_mask"}
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k])
    ours = list(tloop.signal_batches_from_dataset(sigs, 2,
                                                  drop_remainder=True)())
    ref = list(jloop.signal_batches_from_dataset(sigs, 2,
                                                 drop_remainder=True)())
    assert len(ours) == len(ref) == 2
    for (s, t), (rs, rt) in zip(ours, ref):
        np.testing.assert_array_equal(s, rs)
        np.testing.assert_array_equal(t, rt)
    ragged = sigs[:1] + [{"signal": np.zeros(300, np.float32), "target": 0}]
    with pytest.raises(ValueError, match="equal-length"):
        list(tloop.signal_batches_from_dataset(ragged, 2)())
