"""
The port's metadata, system and CLI layers against lidbox_tpu's, on the
CPU.

- ``meta``: the same CSV read by both packages, then verify_integrity,
  read_audio_durations, generate_label2target and the duration-weighted
  over- and undersamplers (whole and per split), with the same rows drawn
  for the same ``random_state``; Common Voice tsv corpora load to the same
  tables.
- ``system``: checksums, durations, command batching and ARFF features
  (the metric logs are read in tests/test_torch_backend.py).
- ``cli.validate_config``: the JAX test's configs give the same messages;
  a YAML config without ``yaml`` fails with a clear message.
- Checkpoints: a train state saved by ``lidbox_tpu.train.checkpoint
  .save_checkpoint`` from a JAX ModelWrapper restores in the port to the
  parameters of ``params_from_flax`` and the optimizer state of
  ``opt_state_from_optax``; every optimizer's msgpack state converts as
  its optax state does.
- Both CLIs from that one checkpoint: ``evaluate`` reports (predictions
  within EMBED_ATOL 1e-4, the confusion matrix and supports equal),
  ``classify`` CSVs (same header, ids and labels, scores within ATOL
  1e-4, whole and chunked) and ``extract-embeddings`` files (ids equal,
  embeddings within 1e-4); ``train --resume`` from it for one epoch of 3
  steps in both CLIs, with the same epoch numbering and losses within
  rtol 1e-3.
- The port's own ``train`` -> ``train --resume`` -> ``export`` journey,
  the user_script hook, and the options that are not ported raising.
"""
import contextlib
import csv
import io
import json
import os
import shutil
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from flax import serialization

import jax

from lidbox_tpu import cli as jcli
from lidbox_tpu import meta as jmeta
from lidbox_tpu import system as jsystem
from lidbox_tpu import util as jutil
from lidbox_tpu.meta import common_voice as jcv
from lidbox_tpu.models.model_utils import ModelWrapper as JWrapper
from lidbox_tpu.train import checkpoint as jckpt
from lidbox_tpu.train import optimizers as jopt
from lidbox_tpu_torch import cli as tcli
from lidbox_tpu_torch import meta as tmeta
from lidbox_tpu_torch import system as tsystem
from lidbox_tpu_torch import testutil
from lidbox_tpu_torch import util as tutil
from lidbox_tpu_torch.features import io as audio_io
from lidbox_tpu_torch.meta import common_voice as tcv
from lidbox_tpu_torch.models.model_api import params_from_flax
from lidbox_tpu_torch.models.model_utils import ModelWrapper as TWrapper
from lidbox_tpu_torch.train import checkpoint as tckpt
from lidbox_tpu_torch.train import optimizers as topt

torch.set_num_threads(2)

RATE = 16000
LABELS = ("aa", "bb", "cc")
EMBED_ATOL = 1e-4   # tests/test_torch_pipeline.py
ATOL = 1e-4         # tests/test_torch_serve.py
LOSS_RTOL = 1e-3
FRAMES, N_MEL = 48, 24  # 0.5 s at 25 / 10 ms


def run(main, argv):
    """(exit code, stdout) of one in-process CLI call."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = main(argv)
    return code, out.getvalue()


def jax_main(argv):
    return jcli.main(argv)


def port_main(argv):
    return tcli.main(argv, device="cpu")


# -- metadata ----------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """3 labels x (4 train + 2 test) noisy sines of 0.5 s, and a metadata
    CSV with speakers and durations (label durations differ, so the
    samplers draw)."""
    root = tmp_path_factory.mktemp("corpus")
    rows = []
    for k, label in enumerate(LABELS):
        for i in range(6):
            sig = testutil.noisy_sinewave(200.0 + 300.0 * k + 7 * i, RATE,
                                          0.3, 0.5, seed=10 * k + i)
            path = root / f"{label}{i}.wav"
            audio_io.write_mono_wav(path, sig, RATE)
            rows.append({"id": f"{label}{i}", "path": str(path),
                         "label": label,
                         "split": "train" if i < 4 else "test",
                         "client_id": f"spk_{label}{i}",
                         "duration": 0.5 + 0.25 * k + 0.125 * (i % 3)})
    csv_path = root / "meta.csv"
    pd.DataFrame(rows).to_csv(csv_path, index=False)
    return {"root": root, "csv": str(csv_path), "rows": rows}


def assert_table_is_frame(table, df):
    assert list(table["id"]) == [str(i) for i in df.index]
    for column in df.columns:
        expected = df[column].to_numpy()
        ours = table[column]
        if expected.dtype.kind in "fiub":
            assert np.asarray(ours).dtype.kind == expected.dtype.kind, column
            np.testing.assert_array_equal(np.asarray(ours), expected)
        else:
            assert list(ours) == list(expected), column


def read_both(csv_path):
    return (jmeta.set_unique_index(pd.read_csv(csv_path)),
            tmeta.set_unique_index(tmeta.read_csv(csv_path)))


def test_read_csv_and_label2target(corpus):
    df, table = read_both(corpus["csv"])
    assert_table_is_frame(table, df)
    jdf, jl2t = jmeta.generate_label2target(df)
    ttab, tl2t = tmeta.generate_label2target(table)
    assert list(tl2t.items()) == list(jl2t.items())
    assert_table_is_frame(ttab, jdf)
    np.testing.assert_array_equal(tmeta.read_audio_durations(table),
                                  jmeta.read_audio_durations(df))


@pytest.mark.parametrize("random_state", [None, 3, 11])
def test_samplers_draw_as_pandas(corpus, random_state):
    df, table = read_both(corpus["csv"])
    for ref_fn, port_fn, kwargs in (
            (jmeta.random_oversampling, tmeta.random_oversampling, {}),
            (jmeta.random_oversampling_on_split,
             tmeta.random_oversampling_on_split, {"split": "train"}),
            (jmeta.random_undersampling, tmeta.random_undersampling,
             {"target_label": "bb"}),
            (jmeta.random_undersampling_on_split,
             tmeta.random_undersampling_on_split,
             {"split": "train", "target_label": "aa"})):
        if random_state is None:  # numpy's global state, seeded alike
            np.random.seed(5)
            ref = ref_fn(df, **kwargs)
            np.random.seed(5)
            ours = port_fn(table, **kwargs)
        else:
            ref = ref_fn(df, random_state=random_state, **kwargs)
            ours = port_fn(table, random_state=random_state, **kwargs)
        assert len(ref) != len(df)  # the sampler drew rows
        assert_table_is_frame(ours, ref)


def test_verify_integrity_matches_jax(corpus, tmp_path):
    df, table = read_both(corpus["csv"])
    jmeta.verify_integrity(df)
    tmeta.verify_integrity(table)
    cases = {
        "missing column": (df.drop(columns=["split"]),
                           {k: v for k, v in table.items() if k != "split"}),
        "missing file": (df.assign(path=["/nonexistent.wav"] + list(df.path[1:])),
                         dict(table, path=["/nonexistent.wav"] + table["path"][1:])),
        "speaker leak": (df.assign(client_id="same"),
                         dict(table, client_id=["same"] * len(df))),
        "missing value": (df.assign(duration=[np.nan] + list(df.duration[1:])),
                          dict(table, duration=np.r_[np.nan,
                                                     table["duration"][1:]])),
    }
    for name, (ref_meta, port_meta) in cases.items():
        with pytest.raises(Exception) as ref:
            jmeta.verify_integrity(ref_meta)
        with pytest.raises(type(ref.value)) as ours:
            tmeta.verify_integrity(port_meta)
        assert str(ours.value) == str(ref.value), name


def _common_voice_corpus(root, lang):
    d = root / lang
    (d / "clips").mkdir(parents=True)
    for split, n in (("train", 3), ("dev", 1), ("test", 2), ("validated", 5)):
        lines = ["client_id\tpath\tsentence"]
        for i in range(n):
            # validated repeats train's speakers and one train clip, and
            # shares one speaker with test
            spk = (f"spk_test{i}" if split == "validated" and i == 4
                   else f"spk_{split}{i}")
            clip = (f"{lang}_train_0.mp3" if split == "validated" and i == 3
                    else f"{lang}_{split}_{i}imp3.mp3")
            lines.append(f"{spk}\t{clip}\thello {i}")
        (d / f"{split}.tsv").write_text("\n".join(lines) + "\n")


def test_common_voice_matches_jax(tmp_path):
    for lang in ("fi", "sv"):
        _common_voice_corpus(tmp_path, lang)
    root = str(tmp_path)
    assert_table_is_frame(tcv.load(root, "fi"), jcv.load(root, "fi"))
    ref = jcv.load_all(root, ["fi", "sv"], num_processes=1)
    ours = tcv.load_all(root, ["fi", "sv"], num_processes=1)
    assert_table_is_frame(ours, ref)
    assert_table_is_frame(tcv.load_all_validated_data(ours, root, "fi"),
                          jcv.load_all_validated_data(ref, root, "fi"))


# -- system ------------------------------------------------------------------

def test_system_helpers_match_jax(corpus, tmp_path):
    paths = [r["path"] for r in corpus["rows"]]
    assert tsystem.all_md5sums(p for p in paths) == jsystem.all_md5sums(paths)
    assert tsystem.get_total_duration(paths) == jsystem.get_total_duration(paths)
    assert (tsystem.format_duration((1, 2, 3))
            == jsystem.format_duration((1, 2, 3)) == "01h 02min 03sec")
    assert tsystem.get_audio_type(paths[0]) == "wav"
    odd = tmp_path / "a b;c.txt"
    odd.write_text("x")
    assert (list(tsystem.run_for_files("wc -c", [odd, odd], batch_size=1))
            == list(jsystem.run_for_files("wc -c", [odd, odd], batch_size=1)))
    arff = tmp_path / "f.arff"
    arff.write_text("@relation r\n@attribute frameTime numeric\n"
                    "@attribute f0 numeric\n@attribute f1 numeric\n"
                    "@data\n0.0,1.5,2.5\n0.01,3.5,4.5\n")
    ours, keys = tsystem.read_arff_features(str(arff))
    ref, ref_keys = jsystem.read_arff_features(str(arff))
    assert keys == ref_keys == ["f0", "f1"]
    np.testing.assert_array_equal(ours, ref)


# -- config validation -------------------------------------------------------

_BASE = {"cache_directory": "/c", "name": "n", "model": {},
         "input_shape": [1], "output_shape": [1], "optimizer": {}, "loss": {}}
VALIDATE_CASES = {
    "ok": {"metadata": {"csv": "x.csv"}},
    "no metadata": {"experiment": {}},
    "bad metadata": {"metadata": {"tsv": "x"}},
    "fused, no rate or noise": {
        "metadata": {"csv": "x.csv"},
        "features": {"on_device_augment": {"snr_range": [5, 20]}}},
    "fused ok": {"metadata": {"csv": "x.csv"},
                 "features": {"sample_rate": 16000, "on_device_augment": {
                     "snr_range": [5, 20], "noise_paths": ["n.wav"]}}},
    "callback typo": {"metadata": {"csv": "x.csv"},
                      "experiment": dict(_BASE, callbacks=[
                          {"cls": "EarlyStoping"}])},
    "feed ok": {"metadata": {"csv": "x"}, "experiment": dict(_BASE, feed={
        "prefetch": 4, "stage_dtype": "bfloat16", "steps_per_dispatch": 2,
        "cache_staged": True})},
    "feed typos": {"metadata": {"csv": "x"}, "experiment": dict(_BASE, feed={
        "prefetsh": 4, "stage_dtype": "floatx", "cache_shuffle": "cols"})},
}


@pytest.mark.parametrize("case", list(VALIDATE_CASES))
def test_validate_config_messages_match_jax(case, tmp_path):
    config = VALIDATE_CASES[case]
    assert tcli.validate_config(config) == jcli.validate_config(config)
    path = tmp_path / "c.json"
    path.write_text(json.dumps(config))
    argv = ["utils", "--validate-config", str(path)]
    assert run(tcli.main, argv) == run(jcli.main, argv)


def test_yaml_config_without_yaml_fails_clearly(tmp_path, monkeypatch):
    path = tmp_path / "c.yaml"
    path.write_text("metadata:\n  csv: x.csv\n")
    assert tcli.load_config(path) == {"metadata": {"csv": "x.csv"}}
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(RuntimeError, match="write the config as JSON"):
        tcli.load_config(path)


# -- checkpoints -------------------------------------------------------------

OPTIMIZERS = {
    "adam": {"cls": "Adam", "kwargs": {"learning_rate": 1e-3}},
    "adamw_schedule_clip": {"cls": "AdamW", "kwargs": {
        "learning_rate": 1e-3, "clipnorm": 1.0, "lr_scheduler": {
            "cls": "ExponentialDecay", "kwargs": {
                "initial_learning_rate": 1e-3, "decay_steps": 10,
                "decay_rate": 0.5}}}},
    "sgd_momentum": {"cls": "SGD", "kwargs": {"learning_rate": 0.1,
                                              "momentum": 0.9}},
    "rmsprop": {"cls": "RMSprop", "kwargs": {"momentum": 0.5}},
    "adagrad": {"cls": "Adagrad"},
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_msgpack_optimizer_state_converts_as_optax(name):
    """A checkpoint holds the optax state as flax's state dict (chains as
    "0", "1", ..., states as their fields): it converts to the state the
    optax namedtuples give."""
    rng = np.random.default_rng(4)
    jparams = {"dense": {"kernel": rng.normal(size=(3, 2)).astype(np.float32),
                         "bias": rng.normal(size=2).astype(np.float32)}}
    opt, _ = jopt.optimizer_from_config(OPTIMIZERS[name])
    state = opt.init(jparams)
    grads = jax.tree_util.tree_map(lambda p: p * 0.1, jparams)
    _, state = opt.update(grads, state, jparams)
    state = jax.device_get(state)
    tparams = params_from_flax(jparams)
    ref = topt.opt_state_from_optax(state, tparams)
    ours = topt.opt_state_from_optax(serialization.to_state_dict(state),
                                     tparams)
    ref_leaves, ref_def = jax.tree_util.tree_flatten(
        ref, is_leaf=lambda x: isinstance(x, torch.Tensor))
    leaves, tree_def = jax.tree_util.tree_flatten(
        ours, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert tree_def == ref_def
    for a, b in zip(leaves, ref_leaves):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)


def experiment_config(corpus, cache, epochs=1, embeddings=False):
    """The CLI journeys' config: 24-bin log-Mel over 0.5 s wavs in
    groups of 8, the full-width x-vector, Adam, checkpoints by val_loss,
    and with ``embeddings`` the section extract-embeddings reads."""
    experiment = {
        "cache_directory": str(cache), "name": "cli",
        "input_shape": [FRAMES, N_MEL], "output_shape": [len(LABELS)],
        "model": {"key": "xvector"},
        "optimizer": {"cls": "Adam", "kwargs": {"learning_rate": 1e-3}},
        "loss": {"cls": "SparseCategoricalCrossentropy"},
        "callbacks": [{"cls": "ModelCheckpoint",
                       "kwargs": {"monitor": "val_loss", "mode": "min"}}],
        "epochs": epochs,
        "data": {"train": {"split": "train", "batch_size": 4},
                 "test": {"split": "test"}}}
    config = {
        "metadata": {"csv": corpus["csv"]},
        "features": {"type": "logmelspectrogram",
                     "melspectrogram": {"num_mel_bins": N_MEL},
                     "group_by_input_length": {"max_batch_size": 8}},
        "experiment": experiment,
    }
    if embeddings:
        config["embeddings"] = {"extractors": [{
            "cache_directory": str(cache), "model": {"key": "xvector"},
            "experiment_name": "cli", "input_shape": [FRAMES, N_MEL],
            "output_shape": [len(LABELS)],
            "best_checkpoint": {"monitor": "val_loss", "mode": "min"}}],
            "batch_size": 8}
    return config


def write_config(config, path):
    path.write_text(json.dumps(config))
    return str(path)


@pytest.fixture(scope="module")
def jax_checkpoint(corpus, tmp_path_factory):
    """A JAX ModelWrapper's initial train state saved as the epoch-1
    checkpoint of the experiment cache; returns (config path, checkpoint
    path, the JAX wrapper)."""
    root = tmp_path_factory.mktemp("jax_ckpt")
    config = experiment_config(corpus, root / "cache")
    wrapper = JWrapper.from_config(config)
    wrapper.trainer.create_state()
    ckpt_dir = root / "cache" / "xvector" / "cli" / "checkpoints"
    path = jckpt.save_checkpoint(str(ckpt_dir), wrapper.trainer.state,
                                 epoch=1, val_loss=1.0)
    return write_config(config, root / "config.json"), path, wrapper


def test_jax_checkpoint_restores_in_port(jax_checkpoint):
    config_path, path, jwrapper = jax_checkpoint
    wrapper = TWrapper.from_config(tcli.load_config(config_path),
                                   device="cpu")
    wrapper.trainer.restore(path)
    assert wrapper.trainer.initial_epoch == 1
    state = wrapper.trainer.state
    jstate = jax.device_get(jwrapper.trainer.state)
    assert state.step == int(jstate.step) == 0
    ref = params_from_flax(jstate.params)
    assert list(state.params) == list(
        dict(wrapper.model.module.named_parameters()))
    for k, v in ref.items():
        assert torch.equal(state.params[k], v), k
        assert torch.equal(dict(wrapper.model.module.named_parameters())[k]
                           .detach(), v)
    ref_opt = topt.opt_state_from_optax(jstate.opt_state, state.params)
    for a, b in zip(jax.tree_util.tree_leaves(
            state.opt_state, is_leaf=lambda x: isinstance(x, torch.Tensor)),
            jax.tree_util.tree_leaves(
                ref_opt, is_leaf=lambda x: isinstance(x, torch.Tensor))):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    raw = tckpt.load_raw_checkpoint(path)
    assert set(raw) == set(tckpt.STATE_KEYS) and raw["batch_stats"] == {}


# -- both CLIs from one checkpoint --------------------------------------------

@pytest.fixture
def captured_reports(monkeypatch):
    """The (true, predictions) each package's classification_report is
    called with."""
    calls = {}
    for name, module in (("jax", jutil), ("port", tutil)):
        original = module.classification_report

        def capture(true, pred, *args, _name=name, _orig=original, **kw):
            calls[_name] = (np.asarray(true), np.asarray(pred))
            return _orig(true, pred, *args, **kw)
        monkeypatch.setattr(module, "classification_report", capture)
    return calls


def test_evaluate_from_one_checkpoint(jax_checkpoint, captured_reports):
    config_path = jax_checkpoint[0]
    code, jax_out = run(jax_main, ["evaluate", config_path])
    assert code == 0
    code, port_out = run(port_main, ["evaluate", config_path])
    assert code == 0
    ref, ours = json.loads(jax_out), json.loads(port_out)
    assert list(ours) == list(ref)
    true_ref, pred_ref = captured_reports["jax"]
    true, pred = captured_reports["port"]
    assert np.array_equal(true, true_ref)
    np.testing.assert_allclose(pred, pred_ref, atol=EMBED_ATOL, rtol=0)
    assert ours["confusion_matrix"] == ref["confusion_matrix"]
    for label in LABELS:
        assert ours[label]["support"] == ref[label]["support"] == 2.0
    assert ours["accuracy"] == ref["accuracy"]


def _read_csv(text):
    rows = list(csv.reader(io.StringIO(text)))
    return rows[0], rows[1:]


@pytest.mark.parametrize("chunk_ms", [None, 250])
def test_classify_from_one_checkpoint(jax_checkpoint, corpus, chunk_ms):
    config_path = jax_checkpoint[0]
    wavs = [r["path"] for r in corpus["rows"] if r["split"] == "test"]
    argv = ["classify", config_path] + wavs
    if chunk_ms:
        argv += ["--chunk-length-ms", str(chunk_ms)]
    code, jax_out = run(jax_main, argv)
    assert code == 0
    code, port_out = run(port_main, argv)
    assert code == 0
    header, rows = _read_csv(port_out)
    ref_header, ref_rows = _read_csv(jax_out)
    assert header == ref_header == ["id", "label"] + [
        f"score_{l}" for l in LABELS]
    assert [r[:2] for r in rows] == [r[:2] for r in ref_rows]
    assert [r[0] for r in rows] == sorted(wavs)
    np.testing.assert_allclose(
        np.asarray([r[2:] for r in rows], float),
        np.asarray([r[2:] for r in ref_rows], float), atol=ATOL, rtol=0)


def test_classify_ragged_wavs_in_one_batch(jax_checkpoint, tmp_path):
    """Files of different lengths share one padded, masked batch and score
    as each file alone does (the JAX package's padded batch also stacks
    the elements' signals and raises on such files)."""
    config_path = jax_checkpoint[0]
    wavs = []
    for i, seconds in enumerate((0.5, 0.8, 1.3)):
        wavs.append(str(tmp_path / f"r{i}.wav"))
        audio_io.write_mono_wav(wavs[-1], testutil.noisy_sinewave(
            300.0 + 100 * i, RATE, 0.2, seconds, seed=i), RATE)
    code, together = run(port_main, ["classify", config_path] + wavs)
    assert code == 0
    _, rows = _read_csv(together)
    for wav, row in zip(wavs, rows):
        _, (alone,) = _read_csv(run(port_main, ["classify", config_path,
                                                wav])[1])
        assert row[:2] == alone[:2]
        np.testing.assert_allclose(np.asarray(row[2:], float),
                                   np.asarray(alone[2:], float),
                                   atol=1e-5, rtol=0)


def test_extract_embeddings_from_one_checkpoint(jax_checkpoint, corpus,
                                                tmp_path):
    config = tcli.load_config(jax_checkpoint[0])
    config = experiment_config(corpus, config["experiment"]["cache_directory"],
                               embeddings=True)
    config_path = write_config(config, tmp_path / "embed.json")
    ref_path, port_path = tmp_path / "jax.npz", tmp_path / "port.npz"
    assert run(jax_main, ["extract-embeddings", config_path,
                          str(ref_path)])[0] == 0
    assert run(port_main, ["extract-embeddings", config_path,
                           str(port_path), "--split", "test"])[0] == 0
    ref, ours = np.load(ref_path), np.load(port_path)
    assert list(ours["ids"]) == list(ref["ids"])
    assert ours["embeddings"].shape == (6, 512)
    np.testing.assert_allclose(ours["embeddings"], ref["embeddings"],
                               atol=EMBED_ATOL, rtol=0)


def _epoch_logs(cache):
    with open(os.path.join(cache, "xvector", "cli", "logs",
                           "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_resume_from_jax_checkpoint_in_both_clis(jax_checkpoint,
                                                       corpus, tmp_path):
    """One epoch (12 train wavs in batches of 4: 3 steps) on from the JAX
    checkpoint's epoch 1, in each CLI's own copy of the cache."""
    src_ckpt = jax_checkpoint[1]
    results = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        cache = tmp_path / name / "cache"
        ckpt_dir = cache / "xvector" / "cli" / "checkpoints"
        ckpt_dir.mkdir(parents=True)
        shutil.copy(src_ckpt, ckpt_dir)
        path = write_config(experiment_config(corpus, cache, epochs=2),
                            tmp_path / name / "config.json")
        assert run(main, ["train", path, "--resume"])[0] == 0
        results[name] = (sorted(p.name[:len("epoch000002")]
                                for p in ckpt_dir.iterdir()),
                         _epoch_logs(str(cache)))
    names, logs = results["port"]
    ref_names, ref_logs = results["jax"]
    assert names == ref_names == ["epoch000001", "epoch000002"]
    assert [r["step"] for r in logs] == [r["step"] for r in ref_logs] == [2]
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(logs[0]["metrics"][key],
                                   ref_logs[0]["metrics"][key],
                                   rtol=LOSS_RTOL)


# -- the port alone ---------------------------------------------------------

def test_port_train_resume_export_journey(corpus, tmp_path):
    cache = tmp_path / "cache"
    path = write_config(experiment_config(corpus, cache, epochs=1),
                        tmp_path / "c.json")
    assert run(port_main, ["train", path])[0] == 0
    path = write_config(experiment_config(corpus, cache, epochs=2),
                        tmp_path / "c.json")
    assert run(port_main, ["train", path, "--resume"])[0] == 0
    ckpt_dir = cache / "xvector" / "cli" / "checkpoints"
    assert sorted(p.name[:11] for p in ckpt_dir.iterdir()) == [
        "epoch000001", "epoch000002"]
    assert [r["step"] for r in _epoch_logs(str(cache))] == [1, 2]
    out = tmp_path / "deploy"
    assert run(port_main, ["export", path, str(out), "--torch-export"])[0] == 0
    assert sorted(p.name for p in out.iterdir()) == [
        "forward.pt2", "model.json", "variables.msgpack"]


def test_user_script_replaces_create_dataset(corpus, tmp_path):
    script = tmp_path / "user.py"
    marker = tmp_path / "called"
    script.write_text(
        "from lidbox_tpu_torch.data.pipelines import create_dataset as base\n"
        f"MARKER = {str(marker)!r}\n"
        "def create_dataset(split, labels, init_data, config):\n"
        "    open(MARKER, 'a').write(split + '\\n')\n"
        "    return base(split, labels, init_data, config)\n")
    config = dict(experiment_config(corpus, tmp_path / "cache"),
                  user_script=str(script))
    path = write_config(config, tmp_path / "c.json")
    code, out = run(port_main, ["evaluate", path])
    assert code == 0 and "accuracy" in json.loads(out)
    assert marker.read_text() == "test\n"


def test_options_not_ported_raise(corpus, jax_checkpoint, tmp_path):
    """``--data-parallel`` runs (a 1-rank mesh in this process: the
    numbers of the run without it); ``export --platforms cpu`` writes a
    program for the CPU, ``tpu`` is refused, and a resume from a
    checkpoint directory that holds no Orbax checkpoint raises (the Orbax
    journeys are in tests/test_torch_orbax.py)."""
    runs = {}
    for flag in ([], ["--data-parallel"]):
        cache = tmp_path / f"cache{len(flag)}"
        path = write_config(experiment_config(corpus, cache),
                            tmp_path / f"c{len(flag)}.json")
        assert run(port_main, ["train", path] + flag)[0] == 0
        runs[len(flag)] = sorted(os.listdir(cache / "xvector" / "cli" /
                                            "checkpoints"))
    assert runs[0] == runs[1] and len(runs[1]) == 1  # the same val_loss
    config_path = jax_checkpoint[0]
    embed_path = write_config(experiment_config(
        corpus, tcli.load_config(config_path)["experiment"]
        ["cache_directory"], embeddings=True), tmp_path / "embed.json")
    wavs = [r["path"] for r in corpus["rows"] if r["split"] == "test"][:3]
    outputs = {}
    for flag in ([], ["--data-parallel"]):
        _, report = run(port_main, ["evaluate", config_path] + flag)
        npz = tmp_path / f"e{len(flag)}.npz"
        assert run(port_main, ["extract-embeddings", embed_path, str(npz)]
                   + flag)[0] == 0
        _, csv_text = run(port_main, ["classify", config_path] + wavs + flag)
        outputs[len(flag)] = (json.loads(report), np.load(npz),
                              _read_csv(csv_text)[1])
    (r0, e0, c0), (r1, e1, c1) = outputs[0], outputs[1]
    assert r1["confusion_matrix"] == r0["confusion_matrix"]
    np.testing.assert_allclose(r1["avg_detection_cost"],
                               r0["avg_detection_cost"], atol=1e-6)
    assert list(e1["ids"]) == list(e0["ids"])
    np.testing.assert_allclose(e1["embeddings"], e0["embeddings"], atol=1e-5,
                               rtol=0)
    assert [row[:2] for row in c1] == [row[:2] for row in c0]
    np.testing.assert_allclose(np.asarray([row[2:] for row in c1], float),
                               np.asarray([row[2:] for row in c0], float),
                               atol=1e-5, rtol=0)
    path = write_config(experiment_config(corpus, tmp_path / "cache"),
                        tmp_path / "c.json")
    out = tmp_path / "deploy"
    assert port_main(["export", config_path, str(out), "--platforms",
                      "cpu"]) == 0
    assert (out / "forward.pt2").is_file()
    with pytest.raises(ValueError, match="tpu"):
        port_main(["export", config_path, str(out), "--platforms", "tpu"])
    orbax = tmp_path / "cache" / "xvector" / "cli" / "checkpoints" / \
        "epoch000001__val_loss1.000000000000"
    orbax.mkdir(parents=True)
    with pytest.raises(ValueError, match="not an Orbax checkpoint"):
        port_main(["train", path, "--resume"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(["evaluate", path])
