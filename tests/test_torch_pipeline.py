"""
The port's config-driven data pipeline against lidbox_tpu.data: the
Dataset, every step of the registry, the config compiler
(``pipelines.create_dataset``), ``from_steps`` over the example config,
the embedding extractor and the serving dtype flags. The same wavs, numpy
inputs and converted weights go through both packages.

Tolerances:
- host steps are numpy on both sides: ids, order, targets, signals, VAD
  decisions, augmentation draws, shuffle orders, caches and statistics
  are exactly equal;
- features (``extract_features``, both modes): the port runs
  ``logmel_plain`` for ``stft_method: "pallas"`` on the CPU and the JAX
  package its matmul path, within atol 1e-4 + rtol 1e-4 (FEATURE_*);
- embeddings from the same converted weights: within atol 1e-4 (EMBED_ATOL);
- bfloat16 serving flags: within the JAX tests' rtol 0.05 + atol 0.05
  (BF16_TOL) of the JAX outputs; a bfloat16-staged feed rounds the same
  inputs in both packages, so it is also held to EMBED_ATOL.
"""
import copy
import os
import pickle
import types

import numpy as np
import pandas as pd
import pytest
import torch

import jax

import lidbox_tpu.data.steps as jsteps
import lidbox_tpu.models as jmodels
import lidbox_tpu.util as jutil
import lidbox_tpu_torch.data.steps as tsteps
import lidbox_tpu_torch.models as tmodels
import lidbox_tpu_torch.util as tutil
from lidbox_tpu_torch import parallel
from lidbox_tpu import testutil
from lidbox_tpu.data import pipelines as jpipelines
from lidbox_tpu.data.dataset import Dataset as JDataset
from lidbox_tpu.features import io as jio
from lidbox_tpu.features import kaldi_io as jkaldi
from lidbox_tpu.models.model_utils import ModelWrapper as JWrapper
from lidbox_tpu.train import checkpoint as jckpt
from lidbox_tpu_torch.data import pipelines as tpipelines
from lidbox_tpu_torch.data.dataset import Dataset as TDataset
from lidbox_tpu_torch.models.model_api import params_from_flax
from lidbox_tpu_torch.models.model_utils import ModelWrapper as TWrapper
from lidbox_tpu_torch.train import checkpoint as tckpt

torch.set_num_threads(2)

RATE = 16000
LABELS = ["aa", "bb", "cc"]
MEL = 24
FEATURE_ATOL = FEATURE_RTOL = 1e-4
EMBED_ATOL = 1e-4
BF16_TOL = 0.05
DOCS_CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs", "config.md")
FEATURES = {"type": "logmelspectrogram",
            "melspectrogram": {"num_mel_bins": MEL, "fmin": 20.0,
                               "fmax": 7000.0},
            "window_normalization": {"window_len": 300},
            "stft_method": "pallas"}
EMB_T = 48  # frames of the embedding extractor's inputs


def assert_same(ours, ref, close=()):
    """Recursive equality of step outputs: dict keys, dtypes and shapes,
    array values exactly (within the feature/embedding tolerances for the
    keys in ``close``), scalar values and types."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and list(ours) == list(ref)
        for k in ref:
            assert_same(ours[k], ref[k], close if k in close else ())
            if k in close:
                tol = EMBED_ATOL if k == "embedding" else FEATURE_ATOL
                np.testing.assert_allclose(ours[k], ref[k], atol=tol,
                                           rtol=0 if k == "embedding"
                                           else FEATURE_RTOL)
    elif isinstance(ref, (list, tuple)):
        assert type(ours) is type(ref) and len(ours) == len(ref)
        for a, b in zip(ours, ref):
            assert_same(a, b, close)
    elif isinstance(ref, np.ndarray):
        assert isinstance(ours, np.ndarray)
        assert ours.dtype == ref.dtype and ours.shape == ref.shape
        if not close:
            np.testing.assert_array_equal(ours, ref)
    else:
        assert type(ours) is type(ref) and ours == ref, (ours, ref)


def _collect(out):
    return list(out) if hasattr(out, "_gen_factory") else out


# ---------------------------------------------------------------------------
# Fixtures: a 3-label corpus of short wavs, a noise directory, checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    meta = {"id": [], "path": [], "label": []}
    for i in range(12):
        lab = LABELS[i % 3]
        seconds = (1.25, 1.35, 1.45)[i // 4]
        sig = testutil.noisy_sinewave(150 + 150 * (i % 3)
                                      + int(rng.integers(-20, 20)), RATE, 0.2,
                                      seconds, seed=i)
        start = int(rng.integers(1000, 6000))
        sig[start:start + int(0.2 * RATE)] = 0.0  # a pause for the VAD
        path = str(root / f"{lab}_{i:02d}.wav")
        jio.write_mono_wav(path, sig, RATE)
        meta["id"].append(f"{lab}_{i:02d}")
        meta["path"].append(path)
        meta["label"].append(lab)
    noise_dir = root / "noise"
    noise_dir.mkdir()
    id2label, id2path = [], []
    for j, kind in enumerate(("noise", "speech", "music")):
        p = str(noise_dir / f"n{j}.wav")
        jio.write_mono_wav(p, (0.3 * rng.uniform(-1, 1, RATE // 2)).astype(
            np.float32), RATE)
        id2label.append(f"n{j} {kind}\n")
        id2path.append(f"n{j} {p}\n")
    (noise_dir / "id2label").write_text("".join(id2label))
    (noise_dir / "id2path").write_text("".join(id2path))
    bad = str(root / "bad.wav")
    with open(meta["path"][0], "rb") as f:
        head = f.read(2000)
    with open(bad, "wb") as f:
        f.write(head)
    ark = {}
    with jkaldi.MatrixWriter(f"ark,scp:{root}/k.ark,{root}/k.scp") as w:
        for i in range(4):
            key = f"utt{i}"
            w(key, rng.normal(0, 1, (20 + i, MEL)).astype(np.float32))
    for key, rx in jkaldi.read_scp(root / "k.scp"):
        ark[key] = rx
    return {"root": root, "meta": meta, "noise_dir": str(noise_dir),
            "bad": bad, "ark": ark}


def _stage(corpus, name, n=6):
    """Element lists that the registry cases start from."""
    meta = corpus["meta"]
    rows = [{"id": meta["id"][i], "path": meta["path"][i],
             "label": meta["label"][i],
             "target": np.int32(LABELS.index(meta["label"][i]))}
            for i in range(0, 12, 12 // n)][:n]
    if name == "meta":
        return rows
    if name == "meta_bad":
        return rows[:3] + [dict(rows[0], id="bad", path=corpus["bad"])]
    if name == "kaldi":
        return [{"id": k, "label": "aa", "target": np.int32(0),
                 "kaldi_ark_key": rx} for k, rx in corpus["ark"].items()]
    out = []
    for x in rows:
        sig, rate = jio.read_wav(x["path"])
        out.append(dict(x, signal=sig.astype(np.float32),
                        sample_rate=np.int32(rate)))
    if name == "signal":
        return out
    if name == "signal_empty":
        return out[:3] + [dict(out[0], id="empty",
                               signal=np.zeros(0, np.float32))]
    if name == "vad":
        return [dict(x, vad_is_speech=jsteps.rms_vad_numpy(
            x["signal"], RATE, 10, min_non_speech_ms=300, strength=0.1),
            vad_frame_length_ms=np.int32(10)) for x in out]
    rng = np.random.default_rng(7)
    if name == "input":
        inputs = [rng.normal(0, 2, (30 + 5 * i, MEL)).astype(np.float32)
                  for i in range(len(out))]
        inputs[1][3, 4] = np.nan
    else:  # "input_fixed": equal shapes, as the batching steps need
        out = [dict(x, signal=x["signal"][:RATE]) for x in out]
        inputs = [rng.normal(0, 1, (EMB_T, MEL)).astype(np.float32)
                  for _ in out]
    return [dict(x, input=v) for x, v in zip(out, inputs)]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The same x-vector weights in each package's checkpoint format, under
    each package's experiment layout."""
    root = tmp_path_factory.mktemp("ckpt")
    jm = jmodels.create("xvector", (EMB_T, MEL), len(LABELS)).init()
    params = jax.tree_util.tree_map(np.asarray, jm.variables["params"])
    jckpt.save_checkpoint(str(root / "jax" / "xvector" / "exp" / "checkpoints"),
                          {"params": params}, epoch=1, val_loss=0.5)
    state = types.SimpleNamespace(step=0, params=params_from_flax(params),
                                  batch_stats={}, opt_state={})
    tckpt.save_checkpoint(str(root / "port" / "xvector" / "exp"
                              / "checkpoints"), state, epoch=1, val_loss=0.5)

    def config(side):
        return {"cache_directory": str(root / side),
                "model": {"key": "xvector"}, "experiment_name": "exp",
                "input_shape": [EMB_T, MEL], "output_shape": [len(LABELS)],
                "best_checkpoint": {"monitor": "val_loss", "mode": "min"}}
    return jm, config


# ---------------------------------------------------------------------------
# The registry, one case per step key
# ---------------------------------------------------------------------------

def _case(key, corpus, checkpoints, tmp, side):
    """(stage, kwargs) of one registry key; ``side`` ("jax" or "port")
    names the package, for the arguments that must differ (output paths,
    checkpoint layouts)."""
    root = tmp / side
    return {
        "append_predictions": ("signal", {"predictions": np.arange(18.0).reshape(6, 3)}),
        "apply_filters": ("signal", {"config": {
            "equal": {"key": "sample_rate", "value": RATE},
            "min_signal_length_ms": 1300}}),
        "apply_vad": ("vad", {}),
        "augment_by_additive_noise": ("signal", {
            "noise_datadir": corpus["noise_dir"],
            "snr_list": [["noise", 5, 15], ["speech", 15, 20], ["music", 10, 20]]}),
        "augment_signals": ("signal", {"augment_configs": [
            {"type": "additive_noise", "split": "train",
             "noise_datadir": corpus["noise_dir"],
             "snr_list": [["noise", 5, 15], ["music", 10, 20]]},
            {"type": "random_resampling", "split": "train", "min": 0.9,
             "max": 1.1}]}),
        "as_supervised": ("input", {}),
        "cache": ("signal", {"directory": str(root / "cache"), "batch_size": 4,
                             "cache_key": "k"}),
        "compute_rms_vad": ("signal", {"strength": 0.1, "vad_frame_length_ms": 10,
                                       "min_non_speech_length_ms": 300}),
        "compute_webrtc_vad": ("signal", {"aggressiveness": 2,
                                          "vad_frame_length_ms": 10}),
        "consume": ("signal", {"log_interval": 2}),
        "consume_to_tensorboard": ("input_fixed", {
            "summary_dir": str(root / "tb"),
            "config": {"batch_size": 2, "num_batches": 1}}),
        "convert_to_binary_classification": ("meta", {"positive_class": "bb"}),
        "create_input_chunks": ("input", {"length": 20, "step": 10}),
        "create_signal_chunks": ("signal", {"length_ms": 500, "step_ms": 250,
                                            "max_pad_ms": 100}),
        "drop_empty": ("signal_empty", {}),
        "drop_invalid_wavs": ("meta_bad", {}),
        "extract_embeddings": ("input_fixed", {"config": {
            "extractors": [checkpoints[1](side)], "batch_size": 4}}),
        "extract_features": ("signal", {"config": dict(
            FEATURES, group_by_input_length={"max_batch_size": 2})}),
        "filter_keys_in_set": ("signal", {"keys": ["id", "target"]}),
        "group_by_axis_length": ("signal", {"element_key": "signal",
                                            "max_batch_size": 2}),
        "initialize": (None, {"labels": LABELS,
                              "init_data": copy.deepcopy(corpus["meta"])}),
        "lambda": ("signal", {"fn": lambda ds: ds.take(2)}),
        "load_audio": ("meta", {}),
        "load_kaldi_data": ("kaldi", {"shape": [None, MEL]}),
        "normalize": ("input", {"config": {"key": "input"}}),
        "random_signal_fir_filtering": ("signal", {"num_coefs": 10}),
        "random_signal_speed_change": ("signal", {"min": 0.9, "max": 1.1}),
        "reduce_stats": (None, {}),
        "remap_keys": ("signal", {"new_keys": {"signal": None, "label": "lang"}}),
        "repeat_too_short_signals": ("signal", {"min_length_ms": 2500}),
        "shuffle": ("signal", {"buffer_size": 4}),
        "show_all_elements": ("signal", {"shapes_only": True}),
        "unstable_reduce_features_mean_variance": ("input_fixed", {}),
        "write_to_kaldi_files": ("input", {"output_dir": str(root / "kaldi")}),
    }[key]


REDUCE_STATS = [("num_elements", "signal", {}), ("vad_ratio", "vad", {}),
                ("size_counts", "input", {"key": "input", "ndims": 2}),
                ("num_non_finite", "input", {"key": "input"}),
                ("min_max_mean", "input_fixed", {"key": "input"})]


def test_registries_have_the_same_keys():
    assert list(tsteps.VALID_STEP_FUNCTIONS) == list(jsteps.VALID_STEP_FUNCTIONS)
    assert len(tsteps.VALID_STEP_FUNCTIONS) == 34


@pytest.mark.parametrize("key", list(jsteps.VALID_STEP_FUNCTIONS))
def test_step_matches_jax(key, corpus, checkpoints, tmp_path):
    """Each registry step on the same elements in both packages: host
    steps exactly equal, feature and embedding values within their
    tolerances (their other keys exactly)."""
    def run(steps_mod, dataset_cls, side, stage=None, **extra):
        s, kwargs = _case(key, corpus, checkpoints, tmp_path, side)
        kwargs = dict(kwargs, **extra)
        fn = steps_mod.VALID_STEP_FUNCTIONS[key]
        if key in ("extract_features", "extract_embeddings") and side == "port":
            kwargs["device"] = "cpu"
        if key == "initialize":
            return _collect(fn(**kwargs))
        ds = dataset_cls.from_elements(copy.deepcopy(_stage(corpus, stage or s)))
        return _collect(fn(ds, **kwargs))

    if key == "reduce_stats":
        for statistic, stage, kw in REDUCE_STATS:
            run(jsteps, JDataset, "jax", stage, statistic=statistic, **kw)
            run(tsteps, TDataset, "port", stage, statistic=statistic, **kw)
            assert_same(tsteps.reduce_stats.last_result,
                        jsteps.reduce_stats.last_result)
        return
    if key == "compute_webrtc_vad":  # no webrtcvad here or on the card
        with pytest.raises(ImportError) as ref:
            run(jsteps, JDataset, "jax")
        with pytest.raises(ImportError) as ours:
            run(tsteps, TDataset, "port")
        assert str(ours.value) == str(ref.value)
        return
    ref = run(jsteps, JDataset, "jax")
    ours = run(tsteps, TDataset, "port")
    close = {"extract_features": ("input",),
             "extract_embeddings": ("embedding",)}.get(key, ())
    assert len(ours) == len(ref) > 0
    assert_same(ours, ref, close)
    if key == "cache":  # the second pass reads the file; both write one format
        assert_same(run(tsteps, TDataset, "port"), ref)
        assert ((tmp_path / "port" / "cache" / "k.cache").read_bytes()
                == (tmp_path / "jax" / "cache" / "k.cache").read_bytes())
    elif key == "unstable_reduce_features_mean_variance":
        assert_same(
            tsteps.unstable_reduce_features_mean_variance_step.last_result,
            jsteps.unstable_reduce_features_mean_variance_step.last_result)
    elif key == "write_to_kaldi_files":
        files = [tmp_path / side / "kaldi" / "utt2feat.ark"
                 for side in ("port", "jax")]
        assert files[0].read_bytes() == files[1].read_bytes()
        scps = [[(k, rx.rsplit(":", 1)[1]) for k, rx in
                 jkaldi.read_scp(f.with_suffix(".scp"))] for f in files]
        assert scps[0] == scps[1]
    elif key == "consume_to_tensorboard":
        for side in ("port", "jax"):
            assert any(p.name.startswith("events")
                       for p in (tmp_path / side / "tb").iterdir())
    elif key == "extract_features":
        assert [x["input"].shape for x in ours] == [(n, MEL) for n in
                                                    (123, 123, 133, 133, 143, 143)]


def test_apply_filters_reads_each_key(corpus):
    """With ``equal`` and ``min_shape`` both set, each predicate reads its
    own key: the port keeps what the JAX package's filters keep one at a
    time. (The JAX package's combined filter drops every element: its
    ``equal`` predicate reads the key ``min_shape`` rebinds.)"""
    config = {"equal": {"key": "sample_rate", "value": RATE},
              "min_signal_length_ms": 1100,
              "min_shape": {"key": "signal", "shape": [21000]}}
    elements = _stage(corpus, "signal")
    ref = JDataset.from_elements(elements)
    for name, conf in config.items():
        ref = jsteps.apply_filters(ref, {name: conf})
    ref = ref.collect()
    ours = tsteps.apply_filters(TDataset.from_elements(elements), config)
    assert_same(ours.collect(), ref)
    assert [x["id"] for x in ref] == ["bb_04", "aa_06", "cc_08", "bb_10"]
    assert jsteps.apply_filters(JDataset.from_elements(elements),
                                config).collect() == []


def test_extract_features_batch_mode_matches(corpus):
    """The fixed ``batch_size`` mode (padded buckets, features sliced back
    to true frame counts) against the JAX package's."""
    config = dict(FEATURES, batch_size=4)
    elements = _stage(corpus, "signal")
    ref = list(jsteps.extract_features(JDataset.from_elements(elements), config))
    ours = list(tsteps.extract_features(TDataset.from_elements(elements), config,
                                        device="cpu"))
    assert_same(ours, ref, close=("input",))


def test_from_steps_device():
    steps = [tsteps.Step("initialize", {"labels": LABELS, "init_data": {
        "id": ["a"], "label": ["aa"]}})]
    assert [x["target"] for x in tsteps.from_steps(steps, device="cpu")] == [0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tsteps.from_steps(steps)  # device defaults to "cuda"
    with pytest.raises(ValueError, match="initialize"):
        tsteps.from_steps(steps[1:], device="cpu")


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------

def _elements(n=11):
    return [{"id": f"e{i:02d}", "x": np.full(3, i, np.float32),
             "y": np.int32(i % 3)} for i in range(n)]


DATASET_OPS = {
    "from_dict_of_lists": lambda D: D.from_dict_of_lists(
        {"id": ["a", "b"], "v": [1, 2]}),
    "map_parallel": lambda D: D.from_elements(_elements()).map(
        lambda x: dict(x, z=x["x"] * 2), num_parallel_calls=4),
    "map_unordered": lambda D: D.from_elements(_elements()).map(
        lambda x: dict(x, z=x["x"] * 2), num_parallel_calls=4,
        deterministic=False),
    "filter": lambda D: D.from_elements(_elements()).filter(
        lambda x: x["y"] == 1),
    "shuffle": lambda D: D.from_elements(_elements()).shuffle(4, seed=3),
    "shuffle_default_seed": lambda D: D.from_elements(_elements()).shuffle(100),
    "batch": lambda D: D.from_elements(_elements()).batch(4),
    "batch_drop_remainder": lambda D: D.from_elements(_elements()).batch(
        4, drop_remainder=True),
    "unbatch": lambda D: D.from_elements(_elements()).batch(4).unbatch(),
    "take": lambda D: D.from_elements(_elements()).take(3),
    "concatenate": lambda D: D.from_elements(_elements(2)).concatenate(
        D.from_elements(_elements(3))),
    "cache_to_memory": lambda D: D.from_elements(_elements()).cache_to_memory(),
    "sample_from_datasets": lambda D: D.sample_from_datasets(
        [D.from_elements(_elements(5)), D.from_elements(_elements(7))],
        weights=[0.3, 0.7], seed=5),
    "prefetch": lambda D: D.from_elements(_elements()).prefetch(2),
    "flat_map": lambda D: D.from_elements(_elements(3)).flat_map(
        lambda x: [x, x]),
}


@pytest.mark.parametrize("op", list(DATASET_OPS))
def test_dataset_op_matches(op):
    def settle(elements):  # unordered: completion order, the same multiset
        if op == "map_unordered":
            return sorted(elements, key=lambda x: x["id"])
        return elements
    ref_ds, ours_ds = DATASET_OPS[op](JDataset), DATASET_OPS[op](TDataset)
    ours = settle(ours_ds.collect())
    assert_same(ours, settle(ref_ds.collect()))
    assert_same(settle(list(ours_ds.as_numpy_iterator())), ours)  # replayable
    assert_same(settle(list(iter(ours_ds))), ours)


def test_dataset_validation_and_abandoned_prefetch():
    with pytest.raises(ValueError, match="ragged"):
        TDataset.from_dict_of_lists({"a": [1, 2], "b": [1]})
    pulled = []

    def source():
        for x in _elements(1000):
            pulled.append(x)
            yield x
    it = iter(TDataset(source).prefetch(2))
    next(it)
    it.close()  # the consumer abandons the stream
    import time
    time.sleep(0.5)
    assert len(pulled) < 10  # the worker stopped instead of filling forever


@pytest.mark.parametrize("writer", ["jax", "port", "per_element"])
def test_cache_file_reads_across_packages(tmp_path, writer):
    """A cache written by either package (and the old per-element pickle
    format) reads in both; the batched files are byte-equal."""
    path = str(tmp_path / "c.cache")
    elements = _elements()
    if writer == "per_element":
        with open(path, "wb") as f:
            for x in elements:
                pickle.dump(x, f, protocol=pickle.HIGHEST_PROTOCOL)
        with open(path + ".done", "w") as f:
            f.write("ok")
    else:
        D = JDataset if writer == "jax" else TDataset
        assert_same(D.from_elements(elements).cache_to_file(path, 4).collect(),
                    elements)
        assert os.path.exists(path + ".done")
        other = str(tmp_path / "other.cache")
        (TDataset if writer == "jax" else JDataset).from_elements(
            elements).cache_to_file(other, 4).collect()
        assert open(path, "rb").read() == open(other, "rb").read()
    never = JDataset(lambda: iter(()))  # a read never touches the source
    for D in (JDataset, TDataset):
        assert_same(D(never._gen_factory).cache_to_file(path, 4).collect(),
                    elements)


# ---------------------------------------------------------------------------
# pre_initialize, validate_cache and the config compiler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shuffle,allow_unknown", [(False, False), (True, False),
                                                   (True, True)])
def test_pre_initialize_matches_pandas(shuffle, allow_unknown):
    rng = np.random.default_rng(1)
    labels = [LABELS[i] for i in rng.integers(0, 3, 40)] + ["zz", "yy"]
    meta = {"id": [f"u{i:02d}" for i in range(42)],
            "label": labels, "duration": rng.uniform(1, 3, 42)}
    df = pd.DataFrame(meta).set_index("id", drop=False)
    ref = jsteps.pre_initialize(df, LABELS, shuffle_utterances=shuffle,
                                allow_unknown_labels=allow_unknown)
    ours = tsteps.pre_initialize(meta, LABELS, shuffle_utterances=shuffle,
                                 allow_unknown_labels=allow_unknown)
    assert ours["id"] == list(ref["id"])
    assert ours["label"] == list(ref["label"])
    np.testing.assert_array_equal(ours["duration"], ref["duration"].to_numpy())
    if shuffle:  # the permutation pandas' sample(frac=1.0) draws
        n = len(ref)
        assert list(ref.reset_index(drop=True).index) == list(range(n))
        kept = pd.DataFrame(meta) if allow_unknown else \
            pd.DataFrame(meta)[pd.Series(labels).isin(LABELS)]
        order = np.random.RandomState(tsteps.RANDOM_SEED).choice(
            n, n, replace=False)
        assert ours["id"] == list(kept["id"].to_numpy()[order])


def test_validate_cache_sidecar_matches(tmp_path):
    meta = {"id": ["a", "b", "c"], "label": ["aa", "bb", "cc"]}
    jsteps.validate_cache(pd.DataFrame(meta), str(tmp_path / "j"), "k")
    tsteps.validate_cache(meta, str(tmp_path / "t"), "k")
    assert ((tmp_path / "t" / "k_meta.json").read_text()
            == (tmp_path / "j" / "k_meta.json").read_text())
    tsteps.validate_cache(meta, str(tmp_path / "t"), "k")  # passes
    with pytest.raises(ValueError, match="shape"):
        tsteps.validate_cache({k: v[:2] for k, v in meta.items()},
                              str(tmp_path / "t"), "k")


def _docs_config():
    import yaml
    text = open(DOCS_CONFIG, encoding="utf-8").read()
    block = text.split("```yaml", 1)[1].split("```", 1)[0]
    return yaml.safe_load(block)


def _example_config(root, noise_dir=None):
    """The config of examples/end_to_end.py."""
    return {
        "pre_process": {
            "rms_vad": {"strength": 0.05, "vad_frame_length_ms": 10},
            "chunks": {"length_ms": 1000, "step_ms": 500},
        },
        "features": {"type": "logmelspectrogram",
                     "melspectrogram": {"num_mel_bins": 40},
                     "group_by_input_length": {"max_batch_size": 32}},
        "post_process": {"normalize": {"key": "input"}},
        "experiment": {
            "cache_directory": os.path.join(str(root), "cache"),
            "name": "demo",
            "input_shape": [98, 40], "output_shape": [len(LABELS)],
            "model": {"key": "xvector"},
            "optimizer": {"cls": "Adam", "kwargs": {"learning_rate": 2e-3}},
            "loss": {"cls": "SparseCategoricalCrossentropy"},
            "callbacks": [{"cls": "ModelCheckpoint",
                           "kwargs": {"monitor": "val_loss", "mode": "min"}}],
            "data": {"train": {"split": "train", "shuffle_buffer_size": 128},
                     "test": {"split": "test"}}},
    }


def _all_sections_config(root):
    """Every section create_dataset reads, on the docs config."""
    cfg = _docs_config()
    cfg["pre_process"]["cache"] = {"directory": str(root), "key": "pre",
                                   "consume": True, "log_interval": 10}
    cfg["post_process"]["cache"] = {"directory": str(root), "key": "post",
                                    "consume": False}
    cfg["embeddings"] = {"extractors": [], "remap_keys": {"input": None},
                         "cache": {"directory": str(root), "key": "emb"}}
    return cfg


def _on_device_config(root):
    cfg = _example_config(root)
    cfg["features"] = dict(cfg["features"], sample_rate=RATE,
                           on_device_augment={"snr_range": [5, 20]})
    return cfg


@pytest.mark.parametrize("which", ["docs", "end_to_end", "all_sections",
                                   "on_device_augment"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_create_dataset_step_lists_match(which, split, tmp_path):
    config = {"docs": _docs_config, "end_to_end": _example_config,
              "all_sections": _all_sections_config,
              "on_device_augment": _on_device_config}[which]
    config = config(tmp_path) if which != "docs" else config()
    init = {"id": ["a"], "path": ["a.wav"], "label": ["aa"]}
    ref = jpipelines.create_dataset(split, LABELS, init, config)
    ours = tpipelines.create_dataset(split, LABELS, init, config)
    assert [s.key for s in ours] == [s.key for s in ref]
    for a, b in zip(ours, ref):
        assert list(a.kwargs) == list(b.kwargs)
        for k in b.kwargs:
            if callable(b.kwargs[k]):  # post_initialize.file_limit's take
                ds = JDataset.from_elements(_elements())
                assert_same(a.kwargs[k](ds).collect(), b.kwargs[k](ds).collect())
            else:
                assert a.kwargs[k] == b.kwargs[k], (a.key, k)
    assert {s.key for s in ours} <= set(tsteps.VALID_STEP_FUNCTIONS)


def test_from_steps_example_config_matches(corpus, tmp_path):
    """examples/end_to_end.py's config through from_steps on a 3-label,
    12-wav corpus: train (shuffled) and test splits."""
    meta = corpus["meta"]
    config = _example_config(tmp_path)
    for split, rows in (("train", range(0, 12, 2)), ("test", range(1, 12, 2))):
        init = {k: [meta[k][i] for i in rows] for k in meta}
        ref = jsteps.from_steps(jpipelines.create_dataset(
            split, LABELS, init, config)).collect()
        ours = tsteps.from_steps(tpipelines.create_dataset(
            split, LABELS, init, config), device="cpu").collect()
        assert len(ours) == len(ref) == len(rows)  # one 1 s chunk each
        assert_same(ours, ref, close=("input",))
        assert all(x["input"].shape == (98, 40) for x in ours)


# ---------------------------------------------------------------------------
# The embedding extractor and the serving dtype flags
# ---------------------------------------------------------------------------

def test_embedding_extractor_matches_jax(checkpoints):
    """The same converted weights, each package's checkpoint format:
    from_config_as_embedding_extractor_fn gives the same embeddings."""
    _, config = checkpoints
    x = np.random.default_rng(3).normal(0, 1, (5, EMB_T, MEL)).astype(np.float32)
    ref = np.asarray(JWrapper.from_config_as_embedding_extractor_fn(
        config("jax"))(x))
    ours = TWrapper.from_config_as_embedding_extractor_fn(config("port"),
                                                          device="cpu")(x)
    assert ours.shape == ref.shape == (5, 512)
    np.testing.assert_allclose(ours, ref, atol=EMBED_ATOL, rtol=0)
    staged = TWrapper.from_config_as_embedding_extractor_fn(
        dict(config("port"), stage_dtype="bfloat16"), device="cpu")(x)
    ref_staged = np.asarray(JWrapper.from_config_as_embedding_extractor_fn(
        dict(config("jax"), stage_dtype="bfloat16"))(x))
    np.testing.assert_allclose(staged, ref_staged, atol=EMBED_ATOL, rtol=0)
    assert not np.array_equal(staged, ours)  # the feed was rounded
    # data-parallel extraction runs (a 1-rank mesh here; two ranks in
    # tests/test_torch_parallel.py), its batch padded to a mesh multiple
    mesh = parallel.get_mesh(device="cpu")
    on_mesh = TWrapper.from_config_as_embedding_extractor_fn(
        config("port"), mesh=mesh, device="cpu")(x)
    np.testing.assert_allclose(on_mesh, ref, atol=EMBED_ATOL, rtol=0)
    with pytest.raises(TypeError):
        TWrapper.from_config_as_embedding_extractor_fn(config("port"),
                                                       mesh=object(),
                                                       device="cpu")
    ds = tsteps.extract_embeddings(TDataset.from_elements(
        [{"id": str(i), "input": row} for i, row in enumerate(x)]), {
        "extractors": [config("port")], "data_parallel": True,
        "batch_size": 4}, device="cpu")
    np.testing.assert_allclose(np.stack([e["embedding"] for e in ds]), ref,
                               atol=EMBED_ATOL, rtol=0)
    with pytest.raises(FileNotFoundError):
        TWrapper.from_config_as_embedding_extractor_fn(
            dict(config("port"), experiment_name="none"), device="cpu")


@pytest.mark.parametrize("flag", ["stage_dtype", "compute_dtype"])
def test_batch_predict_dtype_flags_match(checkpoints, flag):
    jm, _ = checkpoints
    tm = tmodels.create("xvector", (EMB_T, MEL), len(LABELS), device="cpu")
    tm.load_flax_params(jax.tree_util.tree_map(np.asarray,
                                               jm.variables["params"]))
    x = np.random.default_rng(4).normal(0, 1, (6, EMB_T, MEL)).astype(np.float32)
    mask = np.ones((6, EMB_T), bool)
    mask[2, 30:] = False
    ref32 = jutil.make_batch_predict_fn(jm)(x, mask)
    for kw in ({flag: "bfloat16"},
               {flag: torch.bfloat16 if flag == "compute_dtype" else "bfloat16"}):
        ours = tutil.make_batch_predict_fn(tm, **kw)(x, mask)
        ref = jutil.make_batch_predict_fn(jm, **{flag: "bfloat16"})(x, mask)
        assert ours.dtype == np.float32 and ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, rtol=BF16_TOL, atol=BF16_TOL)
        np.testing.assert_allclose(ours, ref32, rtol=BF16_TOL, atol=BF16_TOL)
        if flag == "stage_dtype":  # the same rounded inputs in both
            np.testing.assert_allclose(ours, ref, atol=EMBED_ATOL, rtol=0)
    with pytest.raises(ValueError, match="stage_dtype must be floating"):
        tutil.make_batch_predict_fn(tm, stage_dtype="int16")
    mesh = parallel.get_mesh(device="cpu")  # a 1-rank mesh runs
    np.testing.assert_allclose(tutil.make_batch_predict_fn(
        tm, batch_size=8 * mesh.size, mesh=mesh)(x, mask), ref32,
        atol=EMBED_ATOL, rtol=0)
    with pytest.raises(TypeError):
        tutil.make_batch_predict_fn(tm, mesh=object())
    # score_fn (ported with the language-vector models) maps the outputs
    # on the device before the readback, as the JAX package's does
    scored = tutil.make_batch_predict_fn(tm, score_fn=lambda s: -2.0 * s)
    np.testing.assert_allclose(scored(x, mask),
                               -2.0 * tutil.make_batch_predict_fn(tm)(x, mask),
                               rtol=1e-6)
