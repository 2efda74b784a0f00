"""
The step-based data pipeline (counterpart of ``lidbox_tpu.data.steps``):
the same step-name registry, element-dict contract and semantics.

- Host steps (decode, VAD bookkeeping, chunking, augmentation, shuffling,
  caching) run as numpy over the streaming ``Dataset`` with thread-pool
  parallelism, and give the JAX package's outputs exactly.
- Feature extraction (``extract_features``) and embedding extraction
  (``extract_embeddings``) run batched on the device that ``from_steps``
  passes them (``"cuda"`` by default; ``"cpu"`` on request).
- Randomness is explicit: every stochastic step derives a per-utterance
  seed from (global seed, element id), so pipelines are deterministic and
  replayable regardless of thread scheduling, and draw what the JAX
  package draws.

Element keys follow the reference convention: id, path, label, target,
signal, sample_rate, input, embedding, prediction, duration,
vad_is_speech, vad_frame_length_ms, kaldi_ark_key.
"""
import collections
import hashlib
import json
import os
import time

import numpy as np

import lidbox_tpu_torch
from lidbox_tpu_torch import RANDOM_SEED, get_device, get_logger, parallel
from lidbox_tpu_torch.data.dataset import Dataset, _stack_elements
from lidbox_tpu_torch.data.device_pipeline import DeviceFeatureExtractor
from lidbox_tpu_torch.features import io as audio_io

logger = get_logger("data.steps")

Step = collections.namedtuple("Step", ("key", "kwargs"))

#: host-side parallelism default for IO-bound maps
NUM_PARALLEL_CALLS = min(32, (os.cpu_count() or 1) * 4)

#: the steps that run on the device ``from_steps`` is given
DEVICE_STEPS = ("extract_features", "extract_embeddings")


def element_seed(element_id, salt=""):
    """Stable per-utterance RNG seed derived from the global seed and the
    utterance id (reference: lidbox/data/steps.py:283-284, with a
    deterministic scheme)."""
    h = hashlib.blake2s(f"{RANDOM_SEED}:{salt}:{element_id}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little")


def _rng_for(x, salt=""):
    return np.random.default_rng(element_seed(x.get("id", ""), salt))


# ---------------------------------------------------------------------------
# Running a step list
# ---------------------------------------------------------------------------

def from_steps(steps, device="cuda"):
    """Fold step functions over a dataset; the first step must be
    ``initialize`` (reference: lidbox/data/steps.py:34-58). The steps that
    touch the device (``DEVICE_STEPS``) run on ``device``; "cuda" raises
    without CUDA."""
    device = get_device(device)
    if not steps or steps[0].key != "initialize":
        raise ValueError("first step of a pipeline must be 'initialize'")
    ds = initialize(**steps[0].kwargs)
    for step in steps[1:]:
        fn = VALID_STEP_FUNCTIONS.get(step.key)
        if fn is None:
            logger.error("Skipping unknown step '%s'", step.key)
            continue
        kwargs = dict(step.kwargs)
        if step.key in DEVICE_STEPS:
            kwargs["device"] = device
        ds = fn(ds, **kwargs)
    return ds


def pre_initialize(meta, labels, shuffle_utterances=False,
                   allow_unknown_labels=False):
    """Drop utterances with labels outside ``labels`` (unless
    ``allow_unknown_labels``) and optionally shuffle the row order before
    the pipeline is built (reference: lidbox/data/steps.py:61-91).

    ``meta`` is a dict of equal-length columns with a ``"label"`` column
    (the JAX package takes a DataFrame). The shuffle is the permutation of
    pandas' ``sample(frac=1.0, random_state=RANDOM_SEED)``."""
    n = len(meta["label"])
    keep = np.arange(n)
    if not allow_unknown_labels:
        known = set(labels)
        is_known = np.asarray([l in known for l in meta["label"]], bool)
        if not is_known.all():
            invalid = collections.Counter(
                l for l, k in zip(meta["label"], is_known) if not k)
            logger.warning("Dropping %d utterances with unknown labels: %s",
                           int((~is_known).sum()), dict(invalid))
        keep = keep[is_known]
    if shuffle_utterances:
        order = np.random.RandomState(RANDOM_SEED).choice(
            len(keep), len(keep), replace=False)
        keep = keep[order]
    return {k: _take_rows(v, keep) for k, v in meta.items()}


def _take_rows(column, rows):
    if isinstance(column, np.ndarray):
        return column[rows]
    return [column[i] for i in rows]


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def initialize(labels, init_data):
    """Columnar metadata dict -> element stream with integer ``target``
    appended from the position of each label in ``labels``
    (reference: lidbox/data/steps.py:776-800)."""
    label2target = {l: t for t, l in enumerate(labels)}
    logger.info("Initializing dataset of %d utterances over %d labels",
                len(next(iter(init_data.values()))), len(labels))
    ds = Dataset.from_dict_of_lists(init_data)
    return ds.map(lambda x: dict(x, target=np.int32(label2target.get(x["label"], -1))))


def load_audio(ds, num_prefetch=None):
    """Read wav/mp3 from ``path``, append ``signal`` and ``sample_rate``;
    decode runs on a thread pool with prefetch
    (reference: lidbox/data/steps.py:803-818)."""
    def _read(x):
        signal, rate = audio_io.read_audio(x["path"])
        return dict(x, signal=signal.astype(np.float32), sample_rate=np.int32(rate))
    ds = ds.map(_read, num_parallel_calls=NUM_PARALLEL_CALLS)
    return ds.prefetch(num_prefetch if num_prefetch else 8)


# ---------------------------------------------------------------------------
# Filters
# ---------------------------------------------------------------------------

def drop_empty(ds):
    """Drop elements with empty ``signal``/``input``
    (reference: lidbox/data/steps.py:635-650)."""
    def not_empty(x):
        for k in ("signal", "input"):
            if k in x and np.size(x[k]) == 0:
                return False
        return True
    return ds.filter(not_empty)


def drop_invalid_wavs(ds):
    """Drop elements whose wav header is corrupted; validity flags are
    computed in parallel (reference: lidbox/data/steps.py:653-671)."""
    flagged = ds.map(
        lambda x: dict(x, _wav_ok=audio_io.wav_header_is_valid(x["path"])),
        num_parallel_calls=NUM_PARALLEL_CALLS)
    return (flagged.filter(lambda x: x["_wav_ok"])
                   .map(lambda x: {k: v for k, v in x.items() if k != "_wav_ok"}))


def apply_filters(ds, config):
    """Config-driven predicates: ``equal``, ``min_signal_length_ms``,
    ``min_shape`` (reference: lidbox/data/steps.py:137-180).

    Each predicate reads its own key. (The JAX package's ``equal``
    predicate reads the variable that ``min_shape`` rebinds, so with both
    set it compares the ``min_shape`` key's value and drops every element.)
    """
    filters = []
    if "equal" in config:
        eq_key, value = config["equal"]["key"], config["equal"]["value"]
        filters.append(lambda x: eq_key not in x or np.all(x[eq_key] == value))
    if "min_signal_length_ms" in config:
        min_sec = 1e-3 * config["min_signal_length_ms"]
        filters.append(lambda x: "signal" not in x or
                       np.size(x["signal"]) >= int(x["sample_rate"] * min_sec))
    if "min_shape" in config:
        shape_key = config["min_shape"]["key"]
        min_shape = tuple(config["min_shape"]["shape"])
        filters.append(lambda x: shape_key not in x or all(
            s >= m for s, m in zip(np.shape(x[shape_key]), min_shape)))
    if not filters:
        logger.warning("No filters defined, skipping filtering")
        return ds
    return ds.filter(lambda x: all(f(x) for f in filters))


def convert_to_binary_classification(ds, positive_class):
    """Binary targets: 1 for ``positive_class``, 0 otherwise (the
    reference's config emitted this step without implementing it,
    lidbox/data/pipelines.py:45)."""
    def _to_binary(x):
        return dict(x, target=np.int32(1 if x["label"] == positive_class else 0))
    return ds.map(_to_binary)


# ---------------------------------------------------------------------------
# VAD
# ---------------------------------------------------------------------------

def _invert_short_false_runs_numpy(mask, min_length):
    if min_length <= 0 or mask.size == 0:
        return mask
    change = np.empty(mask.size, bool)
    change[0] = True
    np.not_equal(mask[1:], mask[:-1], out=change[1:])
    run_id = np.cumsum(change) - 1
    run_len = np.bincount(run_id, minlength=run_id[-1] + 1)
    return mask | (run_len[run_id] < min_length)


def rms_vad_numpy(signal, sample_rate, frame_step_ms, min_non_speech_ms=0,
                  strength=0.05, min_rms_threshold=1e-3):
    """Host numpy energy VAD, the per-utterance form of
    features.audio.framewise_rms_energy_vad_decisions
    (reference: lidbox/features/audio.py:299-329)."""
    step = int(sample_rate * 1e-3 * frame_step_ms)
    n = len(signal) // step
    frames = np.asarray(signal[:n * step], np.float32).reshape(n, step)
    rms = np.sqrt(np.mean(np.square(frames), axis=1))
    threshold = strength * max(min_rms_threshold, float(rms.mean()) if n else 0.0)
    decisions = rms > threshold
    min_frames = int(sample_rate * 1e-3 * min_non_speech_ms) // step
    return _invert_short_false_runs_numpy(decisions, min_frames)


def compute_rms_vad(ds, strength, vad_frame_length_ms, min_non_speech_length_ms=0):
    """Append framewise energy-VAD decisions
    (reference: lidbox/data/steps.py:417-432)."""
    def _append(x):
        vad = rms_vad_numpy(x["signal"], int(x["sample_rate"]), vad_frame_length_ms,
                            min_non_speech_ms=min_non_speech_length_ms,
                            strength=strength)
        return dict(x, vad_is_speech=vad,
                    vad_frame_length_ms=np.int32(vad_frame_length_ms))
    return ds.map(_append, num_parallel_calls=NUM_PARALLEL_CALLS)


def compute_webrtc_vad(ds, aggressiveness, vad_frame_length_ms,
                       min_non_speech_length_ms=0):
    """Append WebRTC VAD decisions (reference: lidbox/data/steps.py:435-457).
    Requires the optional ``webrtcvad`` package."""
    min_frames = min_non_speech_length_ms // vad_frame_length_ms

    def _append(x):
        vad = audio_io.get_webrtcvad_decisions(
            x["signal"], int(x["sample_rate"]), vad_frame_ms=vad_frame_length_ms,
            aggressiveness=aggressiveness, min_non_speech_frames=min_frames)
        return dict(x, vad_is_speech=vad,
                    vad_frame_length_ms=np.int32(vad_frame_length_ms))
    return ds.map(_append, num_parallel_calls=NUM_PARALLEL_CALLS)


def apply_vad(ds):
    """Keep voiced frames using previously computed decisions, dropping the
    VAD keys (reference: lidbox/data/steps.py:183-200)."""
    drop_keys = {"vad_frame_length_ms", "vad_is_speech"}

    def _apply(x):
        frame_len = int(int(x["sample_rate"]) * 1e-3 * int(x["vad_frame_length_ms"]))
        sig = x["signal"]
        n = len(sig) // frame_len
        frames = sig[:n * frame_len].reshape(n, frame_len)
        voiced = frames[np.asarray(x["vad_is_speech"][:n], bool)].reshape(-1)
        return {k: v for k, v in dict(x, signal=voiced).items() if k not in drop_keys}
    return ds.map(_apply, num_parallel_calls=NUM_PARALLEL_CALLS)


# ---------------------------------------------------------------------------
# Signal surgery and augmentation
# ---------------------------------------------------------------------------

def repeat_too_short_signals(ds, min_length_ms):
    """Tile signals until they reach min_length_ms
    (reference: lidbox/data/steps.py:950-969)."""
    min_sec = 1e-3 * min_length_ms

    def _repeat(x):
        sig = x["signal"]
        need = min_sec * int(x["sample_rate"])
        if sig.size == 0 or sig.size >= need:
            return x
        reps = int(np.ceil(need / sig.size))
        return dict(x, signal=np.tile(sig, reps))
    return ds.map(_repeat)


def create_signal_chunks(ds, length_ms, step_ms, max_pad_ms=0,
                         deterministic_output_order=True,
                         max_num_chunks_per_signal=int(1e6),
                         avg_num_chunks_from_signals=100):
    """Split each signal into fixed-length chunks; chunk ids are the parent
    id suffixed with a zero-padded chunk number, and ``duration`` is updated
    (reference: lidbox/data/steps.py:579-632). The host pipeline is
    deterministic by construction, so deterministic_output_order is always
    honored."""
    id_width = int(round(np.log10(max_num_chunks_per_signal)))

    def _chunks(x):
        rate = int(x["sample_rate"])
        chunk_len = int(rate * 1e-3 * length_ms)
        chunk_step = int(rate * 1e-3 * step_ms)
        max_pad = int(rate * 1e-3 * max_pad_ms)
        sig = x["signal"]
        num_full = max(0, 1 + (sig.size - chunk_len) // chunk_step)
        last_len = sig.size - num_full * chunk_step
        if last_len < chunk_len and chunk_len <= last_len + max_pad:
            sig = np.pad(sig, (0, chunk_len - last_len))
        num_chunks = max(0, 1 + (sig.size - chunk_len) // chunk_step)
        for c in range(num_chunks):
            chunk = sig[c * chunk_step: c * chunk_step + chunk_len]
            out = dict(x, signal=chunk,
                       id=f"{x['id']}-{c + 1:0{id_width}d}")
            if "duration" in x:
                out["duration"] = np.float32(chunk.size / rate)
            yield out
    return ds.flat_map(_chunks)


def create_input_chunks(ds, length, step):
    """Chunk the feature tensor ``input`` along the time axis
    (reference: lidbox/data/steps.py:558-576)."""
    id_width = 6

    def _chunks(x):
        feats = x["input"]
        num_chunks = max(0, 1 + (feats.shape[0] - length) // step)
        for c in range(num_chunks):
            yield dict(x, input=feats[c * step: c * step + length],
                       id=f"{x['id']}-{c + 1:0{id_width}d}")
    return ds.flat_map(_chunks)


def random_signal_speed_change(ds, min, max, flag=None):
    """Uniform random speed ratio in [min, max] via FFT resampling
    (reference: lidbox/data/steps.py:331-352)."""
    def _change(x):
        if flag and not x.get(flag, False):
            return x
        rng = _rng_for(x, "speed")
        ratio = rng.uniform(min, max)
        rate = int(x["sample_rate"])
        in_rate = int(ratio * rate)
        resampled, _ = audio_io.resample(x["signal"], in_rate, rate)
        return dict(x, signal=resampled)
    return ds.map(_change, num_parallel_calls=NUM_PARALLEL_CALLS)


def random_signal_fir_filtering(ds, num_coefs=10, flag=None):
    """Random normal FIR filtering (reference: lidbox/data/steps.py:355-368)."""
    def _filter(x):
        if flag and not x.get(flag, False):
            return x
        rng = _rng_for(x, "fir")
        fir = rng.normal(0.0, 1.0, num_coefs).astype(np.float32)
        sig = np.convolve(np.pad(x["signal"], (num_coefs - 1, 0)), fir,
                          mode="valid").astype(np.float32)
        return dict(x, signal=sig)
    return ds.map(_filter, num_parallel_calls=NUM_PARALLEL_CALLS)


def _numpy_snr_mixer(clean, noise, snr):
    """MS-SNSD mixer (reference: lidbox/features/audio.py:100-121)."""
    rms_c = np.sqrt(np.mean(np.square(clean, dtype=np.float64)))
    clean = clean * (10 ** (-25 / 20) / max(rms_c, 1e-12))
    rms_c = np.sqrt(np.mean(np.square(clean, dtype=np.float64)))
    rms_n = np.sqrt(np.mean(np.square(noise, dtype=np.float64)))
    noise = noise * (10 ** (-25 / 20) / max(rms_n, 1e-12))
    rms_n = np.sqrt(np.mean(np.square(noise, dtype=np.float64)))
    scalar = np.sqrt(rms_c / (10 ** (snr / 20)) / max(rms_n, 1e-12))
    return (clean + scalar * noise).astype(np.float32)


def augment_by_additive_noise(ds, noise_datadir, snr_list,
                              copy_noise_files_to_tmpdir=False):
    """MUSAN-style additive noise: per element, pick one random noise file
    and SNR per (type, low, high) triple, tile/trim the noise to the signal
    length, mix, and emit elements with ids
    ``augmented-<id>-<type>-snr<x>`` (reference: lidbox/data/steps.py:235-328).
    """
    id2type = dict(lidbox_tpu_torch.iter_metadata_file(
        os.path.join(noise_datadir, "id2label"), 2))
    type2paths = collections.defaultdict(list)
    for noise_id, path in lidbox_tpu_torch.iter_metadata_file(
            os.path.join(noise_datadir, "id2path"), 2):
        type2paths[id2type[noise_id]].append(path)

    def _augment(x):
        rng = _rng_for(x, "noise")
        for noise_type, snr_low, snr_high in snr_list:
            paths = type2paths.get(noise_type, [])
            if not paths:
                continue
            noise, noise_rate = audio_io.read_audio(paths[rng.integers(len(paths))])
            if noise_rate != int(x["sample_rate"]):
                raise ValueError(
                    f"noise sample rate {noise_rate} != speech sample "
                    f"rate {int(x['sample_rate'])} (resample the noise "
                    f"corpus first)")
            snr = float(rng.uniform(snr_low, snr_high))
            sig = x["signal"]
            reps = 1 + sig.size // max(noise.size, 1)
            noise = np.tile(noise, reps)[:sig.size]
            mixed = _numpy_snr_mixer(sig, noise, snr)
            yield dict(x, signal=mixed,
                       id=f"augmented-{x['id']}-{noise_type}-snr{snr:.2f}")
    return ds.flat_map(_augment)


def augment_signals(ds, augment_configs):
    """Build augmented copies of ds per config and sample randomly from the
    original + augmented streams (reference: lidbox/data/steps.py:215-229)."""
    augmented = []
    for conf in augment_configs:
        kwargs = {k: v for k, v in conf.items() if k not in ("type", "split")}
        if conf["type"] == "random_resampling":
            augmented.append(random_signal_speed_change(ds, **kwargs))
        elif conf["type"] == "additive_noise":
            augmented.append(augment_by_additive_noise(ds, **kwargs))
        else:
            logger.warning("Unknown signal augmentation type '%s', skipping",
                           conf["type"])
    return Dataset.sample_from_datasets([ds] + augmented, seed=RANDOM_SEED)


# ---------------------------------------------------------------------------
# Features
# ---------------------------------------------------------------------------

def group_by_axis_length(ds, element_key, max_batch_size, min_batch_size=0,
                         axis=0, extra_key_fn=None):
    """Batches where all tensors under ``element_key`` share the size of
    ``axis`` (reference: lidbox/data/steps.py:751-773). Groups are emitted
    as they fill, remainder groups at the end. ``extra_key_fn(element)``
    optionally extends the grouping key (e.g. sample rate, so equal-length
    signals at different rates never share a batch)."""
    def gen():
        groups = {}
        for x in ds:
            length = np.shape(x[element_key])[axis]
            if extra_key_fn is not None:
                length = (length, extra_key_fn(x))
            bucket = groups.setdefault(length, [])
            bucket.append(x)
            if len(bucket) >= max_batch_size:
                yield _stack_elements(groups.pop(length))
        for g in groups.values():
            if len(g) >= min_batch_size:
                yield _stack_elements(g)
    return Dataset(gen)


def extract_features(ds, config, device="cuda", extractor=None):
    """Extract features from ``signal`` into ``input`` on ``device``
    (reference: lidbox/data/steps.py:708-736). With ``stft_method:
    "pallas"`` log-Mel and MFCC run through the fused log-Mel kernel on a
    CUDA device (its plain version on the CPU). On the card each
    extraction is one CUDA graph replay per shape
    (``DeviceFeatureExtractor``). ``extractor``: a
    ``DeviceFeatureExtractor`` of this config to run, whose captured
    graphs a caller keeps across datasets (a service); one built with
    ``eager=True`` runs the extractions eagerly.

    Two batching modes, as in the reference:
    - ``group_by_input_length``: equal-length groups of at most
      ``max_batch_size`` (one sample rate each), one extractor call per
      group, unpadded: exact numerics;
    - fixed ``batch_size``: ragged batches are padded to shape buckets and
      the features sliced back to true frame counts.
    """
    config = dict(config)
    feature_type = config.get("type", "logmelspectrogram")
    if extractor is None:
        extractor = DeviceFeatureExtractor(config, device=device)

    if "group_by_input_length" in config:
        max_bs = config["group_by_input_length"]["max_batch_size"]
        # rate is part of the grouping key: equal-length signals at
        # different sample rates must never share a batch (one mel
        # filterbank per batch)
        grouped = group_by_axis_length(
            ds, "signal", max_bs, axis=0,
            extra_key_fn=lambda x: int(x.get("sample_rate", 0)))

        def _extract_equal(batch):
            rates = np.atleast_1d(batch["sample_rate"])
            if not np.all(rates == rates[0]):
                raise ValueError("one sample rate per batch required")
            feats = extractor(np.stack(list(batch["signal"])), int(rates[0]))
            return dict(batch, input=feats,
                        feature_type=[feature_type] * len(feats))
        return grouped.map(_extract_equal).unbatch()

    batch_size = config.get("batch_size", 32)

    def gen():
        pending = []
        rate = None
        for x in ds:
            if rate is not None and int(x["sample_rate"]) != rate and pending:
                yield from _flush(pending, rate)
                pending = []
            rate = int(x["sample_rate"])
            pending.append(x)
            if len(pending) >= batch_size:
                yield from _flush(pending, rate)
                pending = []
        if pending:
            yield from _flush(pending, rate)

    def _flush(pending, rate):
        feats = extractor.extract_ragged([p["signal"] for p in pending], rate)
        for p, f in zip(pending, feats):
            yield dict(p, input=f, feature_type=feature_type)
    return Dataset(gen).prefetch(2)


def normalize(ds, config):
    """Per-element CMVN over a key, on the host
    (reference: lidbox/data/steps.py:821-834)."""
    key = config["key"]
    kwargs = config.get("kwargs", {})
    axis = kwargs.get("axis", 1)

    def _norm(x):
        v = np.asarray(x[key], np.float32)[np.newaxis]  # [1, T, F]
        mean = v.mean(axis=axis, keepdims=True)
        std = v.std(axis=axis, keepdims=True)
        out = np.divide(v - mean, std, out=np.zeros_like(v), where=std != 0)
        return dict(x, **{key: out[0]})
    return ds.map(_norm, num_parallel_calls=NUM_PARALLEL_CALLS)


def load_kaldi_data(ds, shape):
    """Load per-element matrices from Kaldi archives into ``input``
    (reference: lidbox/data/steps.py:1002-1018). Uses kaldiio when
    installed; otherwise the built-in binary ark reader."""
    from lidbox_tpu_torch.features import load_tensor_from_kaldi_archive

    def _load(x):
        data = load_tensor_from_kaldi_archive(str(x["kaldi_ark_key"]))
        out = dict(x, input=data)
        out.pop("kaldi_ark_key", None)
        return out
    return ds.map(_load, num_parallel_calls=NUM_PARALLEL_CALLS)


def write_to_kaldi_files(ds, output_dir, element_key="input"):
    """Dump features to Kaldi ark+scp (reference: lidbox/data/steps.py:
    1058-1074); built-in binary matrix writer, no kaldiio needed."""
    from lidbox_tpu_torch.features.kaldi_io import MatrixWriter
    os.makedirs(output_dir, exist_ok=True)
    spec = "ark,scp:{0}.ark,{0}.scp".format(os.path.join(output_dir, "utt2feat"))
    with MatrixWriter(spec) as writer:
        for x in ds:
            writer(str(x["id"]), np.asarray(x[element_key]))
    return ds


# ---------------------------------------------------------------------------
# Caching, shuffling, key surgery
# ---------------------------------------------------------------------------

def cache(ds, directory=None, batch_size=64, cache_key=None):
    """Cache elements to disk in ``batch_size`` pickle records (or to
    memory when no directory) (reference: lidbox/data/steps.py:371-392)."""
    if directory is None:
        logger.warning("Caching dataset into memory")
        return ds.cache_to_memory()
    if cache_key is None:
        cache_key = str(int(time.time()))
    os.makedirs(directory, exist_ok=True)
    return ds.cache_to_file(os.path.join(directory, cache_key + ".cache"),
                            batch_size=batch_size)


def validate_cache(table, path, cache_key):
    """JSON sidecar of the metadata table's keys and shape; raises on a
    mismatch with an existing sidecar (reference: lidbox/data/steps.py:
    395-414). ``table`` is a dict of equal-length columns (the JAX package
    takes a DataFrame); the sidecar is the same for the same table."""
    keys = list(table)
    num_rows = len(table[keys[0]]) if keys else 0
    values = {"keys": keys, "shape": [num_rows, len(keys)]}
    sidecar = os.path.join(path, f"{cache_key}_meta.json")
    if os.path.exists(sidecar):
        with open(sidecar, encoding="utf-8") as f:
            existing = json.load(f)
        if existing["keys"] != values["keys"]:
            raise ValueError(f"cache keys changed: {existing['keys']} vs {values['keys']}")
        if existing["shape"] != values["shape"]:
            raise ValueError(f"cache shape changed: {existing['shape']} vs {values['shape']}")
        logger.info("Cache validation passed")
    else:
        os.makedirs(path, exist_ok=True)
        with open(sidecar, "w", encoding="utf-8") as f:
            json.dump(values, f, indent=2)


def shuffle(ds, buffer_size):
    return ds.shuffle(buffer_size)


def as_supervised(ds):
    """dict elements -> (input, target) tuples
    (reference: lidbox/data/steps.py:203-212)."""
    def gen():
        for x in ds:
            yield x["input"], x["target"]
    return Dataset(gen)


def remap_keys(ds, new_keys):
    """Rename keys; keys mapped to None are dropped
    (reference: lidbox/data/steps.py:938-944)."""
    def _remap(x):
        return {new_keys.get(k, k): v for k, v in x.items()
                if new_keys.get(k, k) is not None}
    return ds.map(_remap)


def filter_keys_in_set(ds, keys):
    """(reference: lidbox/data/steps.py:739-748)"""
    keep = set(keys)
    return ds.map(lambda x: {k: v for k, v in x.items() if k in keep})


def append_predictions(ds, predictions):
    """Zip a [N, ...] prediction array back into the element stream
    (reference: lidbox/data/steps.py:125-134)."""
    def gen():
        for x, pred in zip(ds, predictions):
            yield dict(x, prediction=np.asarray(pred))
    return Dataset(gen)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

_PARALLEL_KEYS = ("mesh", "data_parallel", "devices")


def _resolve_embedding_mesh(config, device):
    """The mesh of data-parallel extraction from a config section:
    ``"data_parallel": true`` spans every rank of the process group,
    ``"devices": N`` its first N ranks; a live ``"mesh"`` entry (a
    ``parallel.Mesh``) wins. None without any."""
    mesh = config.get("mesh")
    if mesh is not None:
        return parallel.as_mesh(mesh)
    if config.get("data_parallel") or config.get("devices"):
        num = config.get("devices")
        return parallel.get_mesh(num_devices=int(num) if num else None,
                                 device=device)
    return None


def extract_embeddings(ds, config, device="cuda"):
    """Extract embeddings to ``embedding`` from ``input`` with trained
    extractors restored from checkpoints, on ``device``
    (reference: lidbox/data/steps.py:674-705); embeddings from multiple
    extractors are concatenated.

    Data-parallel extraction is declared with ``"data_parallel": true``
    (every rank of the process group) or ``"devices": N`` (its first N
    ranks), or given a live ``"mesh"``; an extractor that names any of
    these keys overrides the section's. Every rank runs the same pipeline
    and returns every element's embedding: the ranks of the mesh each
    embed their rows of a batch and gather the rest, and ranks outside an
    N-rank sub-mesh run no forward and receive the embeddings from rank 0
    (``util.make_batch_predict_fn``). Under a mesh the extractor calls run
    one at a time (``num_parallel_calls`` is 1): each is a collective."""
    from lidbox_tpu_torch.models.model_utils import ModelWrapper

    mesh = _resolve_embedding_mesh(config, device)

    def _extractor_mesh(e):
        # an extractor that mentions parallelism at all overrides the
        # section default, turning it off too (data_parallel: false)
        if any(k in e for k in _PARALLEL_KEYS):
            return _resolve_embedding_mesh(e, device)
        return mesh

    batch_size = config.get("batch_size", 32)
    meshes = [_extractor_mesh(e) for e in config["extractors"]]
    extractors = [ModelWrapper.from_config_as_embedding_extractor_fn(
                      dict(e, batch_size=e.get("batch_size", batch_size),
                           stage_dtype=e.get("stage_dtype",
                                             config.get("stage_dtype"))),
                      mesh=m, device=device)
                  for e, m in zip(config["extractors"], meshes)]

    def _append(batch):
        inputs = np.stack(list(batch["input"]))
        embeddings = [np.asarray(fn(inputs)) for fn in extractors]
        return dict(batch, embedding=np.concatenate(embeddings, axis=1))

    # num_parallel_calls > 1 keeps several extractor calls in flight
    # (ordered), so batch i+1's transfer can overlap batch i's readback;
    # collectives must run in one order on every rank
    parallel_calls = (1 if any(m is not None for m in meshes)
                      else int(config.get("num_parallel_calls", 1)))
    ds = ds.batch(batch_size).prefetch(2).map(
        _append, num_parallel_calls=parallel_calls)
    if not config.get("no_unbatch", False):
        ds = ds.unbatch()
    return ds


# ---------------------------------------------------------------------------
# Introspection / statistics
# ---------------------------------------------------------------------------

def consume(ds, log_interval=-1):
    """Exhaust the pipeline, logging elements/sec
    (reference: lidbox/data/steps.py:460-484)."""
    t0 = time.perf_counter()
    last_i, last_t = 0, t0
    i = 0
    for i, _ in enumerate(ds, start=1):
        if log_interval > 0 and i % log_interval == 0:
            now = time.perf_counter()
            logger.info("%d done, %.3f elements per second.",
                        i, (i - last_i) / max(now - last_t, 1e-9))
            last_i, last_t = i, now
    total = time.perf_counter() - t0
    logger.info("%d done, %.3f elements per second.", i, i / max(total, 1e-9))
    return ds


def consume_to_tensorboard(ds, summary_dir, config, exist_ok=False):
    """Write dataset samples (feature images, audio, ids) to TensorBoard
    summaries (reference: lidbox/data/steps.py:487-554) with
    ``torch.utils.tensorboard`` when it imports; otherwise logs a warning
    and passes the dataset through."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        logger.warning("torch.utils.tensorboard unavailable; skipping "
                       "tensorboard step")
        return ds
    if (not exist_ok and os.path.isdir(summary_dir)
            and any(p.name.startswith("events") for p in os.scandir(summary_dir)
                    if p.is_file())):
        logger.error("Skipping TensorBoard step: '%s' already has event files",
                     summary_dir)
        return ds
    batch_size = config["batch_size"]
    max_outputs = config.get("max_elements_per_batch", batch_size)
    num_batches = config.get("num_batches", -1)
    colors = _colormap_lut(config.get("colormap", "viridis"))
    size_multiplier = int(config.get("image_size_multiplier", 1))
    batched = ds.batch(batch_size, drop_remainder=True)
    if num_batches > -1:
        batched = batched.take(num_batches)
    writer = SummaryWriter(summary_dir)
    try:
        for step_i, batch in enumerate(batched):
            inputs = np.stack(list(batch["input"]))[:max_outputs]
            writer.add_histogram(
                "targets", np.asarray(batch["target"])[:max_outputs], step_i)
            writer.add_histogram("inputs", inputs, step_i)
            writer.add_images(
                "inputs/img",
                _features_to_rgb_images(inputs, colors, size_multiplier),
                step_i, dataformats="NHWC")
            if "signal" in batch:
                rate = int(np.atleast_1d(batch["sample_rate"])[0])
                signals = np.stack(list(batch["signal"]))[:max_outputs]
                for i, s in enumerate(signals):
                    writer.add_audio(f"utterances/{i}", s, step_i,
                                     sample_rate=rate)
            ids = [f"{i + 1}: {u}" for i, u in enumerate(batch["id"][:max_outputs])]
            writer.add_text("utterance_ids", "\n\n".join(ids), step_i)
            if "transcript" in batch:
                transcripts = [str(t) for t in batch["transcript"][:max_outputs]]
                writer.add_text("transcripts", "\n\n".join(transcripts), step_i)
    finally:
        writer.close()
    return ds


def _colormap_lut(colormap_key):
    """RGB lookup table for feature images, the reference's
    ``matplotlib_colormap_to_tensor`` (lidbox/data/tf_utils.py:39-47):
    ``cmap(arange(N + 1))[:, :3]`` (index N clamps into the last color).
    Returns None when matplotlib is unavailable (grayscale fallback)."""
    try:
        import matplotlib
        try:
            cmap = matplotlib.colormaps[colormap_key]
        except AttributeError:  # matplotlib < 3.6
            from matplotlib.cm import get_cmap
            cmap = get_cmap(colormap_key)
        return np.asarray(cmap(np.arange(cmap.N + 1)))[:, :3]
    except (ImportError, KeyError, ValueError) as e:
        logger.warning("colormap %r unavailable (%s); feature images will "
                       "be grayscale", colormap_key, e)
        return None


def _features_to_rgb_images(inputs, colors, size_multiplier=1):
    """[B, T, F] feature batch -> image batch [B, F, T, C]: global min-max
    scale to [0, 1], colormap LUT gather, transpose to freq x time, flip so
    low frequencies render at the bottom, integer upscale
    (reference: lidbox/data/tf_utils.py:50-75, tensors_to_rgb_images)."""
    span = inputs.max() - inputs.min()
    scaled = ((inputs - inputs.min()) / span if span > 0
              else np.zeros_like(inputs))
    if colors is None:
        imgs = scaled[..., None]  # grayscale
    else:
        idx = np.round(scaled * (colors.shape[0] - 1)).astype(np.int64)
        imgs = colors[idx]  # [B, T, F, 3]
    imgs = imgs.transpose(0, 2, 1, 3)[:, ::-1]
    if size_multiplier > 1:
        imgs = imgs.repeat(size_multiplier, axis=1).repeat(size_multiplier,
                                                           axis=2)
    return imgs.astype(np.float32)


def show_all_elements(ds, shapes_only=True):
    """Log shapes (and optionally contents) of every element
    (reference: lidbox/data/steps.py:972-994)."""
    i = 0
    for i, x in enumerate(ds, start=1):
        shapes = {k: np.shape(v) for k, v in x.items()}
        if shapes_only:
            logger.info("Element %d shapes: %s", i, shapes)
        else:
            logger.info("Element %d shapes: %s contents: %s", i, shapes, x)
    logger.info("All %d elements shown.", i)
    return ds


def reduce_stats(ds, statistic, batch_size=1, **kwargs):
    """Whole-dataset statistics (reference: lidbox/data/steps.py:845-935).
    Returns the dataset; results are logged and also stored on the function
    attribute ``reduce_stats.last_result`` for programmatic access."""
    result = None
    if statistic == "num_elements":
        result = sum(1 for _ in ds)
        logger.info("total num elements: %d", result)
    elif statistic == "vad_ratio":
        num, speech, total = 0, 0, 0
        for x in ds:
            num += 1
            v = np.asarray(x["vad_is_speech"], bool)
            speech += int(v.sum())
            total += v.size
        result = {"num_signals": num, "kept": speech, "dropped": total - speech,
                  "ratio": speech / max(total, 1)}
        logger.info("VAD frame statistics: %s", result)
    elif statistic == "size_counts":
        key, ndims = kwargs["key"], kwargs["ndims"]
        counters = [collections.Counter() for _ in range(ndims)]
        for x in ds:
            for axis, size in enumerate(np.shape(x[key])[:ndims]):
                counters[axis][int(size)] += 1
        result = [dict(c) for c in counters]
        logger.info("size counts by axis for '%s': %s", key, result)
    elif statistic == "num_non_finite":
        key = kwargs["key"]
        total, bad = 0, 0
        for x in ds:
            total += 1
            bad += int(not np.all(np.isfinite(np.asarray(x[key], np.float32))))
        result = {"total": total, "num_non_finite": bad}
        logger.info("%d of %d tensors under '%s' have non-finite values",
                    bad, total, key)
    elif statistic == "min_max_mean":
        key = kwargs["key"]
        mn, mx, num, total = np.inf, -np.inf, 0, 0.0
        for x in ds:
            v = np.asarray(x[key], np.float64)
            mn, mx = min(mn, float(v.min())), max(mx, float(v.max()))
            num += v.size
            total += float(v.sum())
        result = {"min": mn, "max": mx, "num": num, "mean": total / max(num, 1)}
        logger.info("stats for '%s': %s", key, result)
    else:
        logger.error("Unknown statistic type '%s'", statistic)
    reduce_stats.last_result = result
    return ds


reduce_stats.last_result = None


def unstable_reduce_features_mean_variance(ds, axis=0, key="input"):
    """Two-pass float64 dataset mean/variance feeding util.standard_scaler
    (reference: lidbox/data/steps.py:1021-1055)."""
    num_frames = 0
    sums = None
    for x in ds:
        v = np.asarray(x[key], np.float64)
        s = v.sum(axis=axis, keepdims=True)
        sums = s if sums is None else sums + s
        num_frames += v.shape[axis]
    if num_frames <= 1:
        raise ValueError(
            f"need more than one frame to compute variance, got {num_frames}")
    means = sums / num_frames
    sq = None
    for x in ds:
        v = np.asarray(x[key], np.float64)
        s = np.square(v - means).sum(axis=axis, keepdims=True)
        sq = s if sq is None else sq + s
    variances = sq / (num_frames - 1)
    return num_frames, means, variances


def unstable_reduce_features_mean_variance_step(ds, axis=0, key="input"):
    """Step-contract wrapper for the registry: computes the stats, stashes
    them on ``.last_result`` (like reduce_stats) and returns the dataset
    unchanged (the reference registered the raw reducer, whose tuple
    broke the from_steps fold, lidbox/data/steps.py:1109)."""
    result = unstable_reduce_features_mean_variance(ds, axis=axis, key=key)
    unstable_reduce_features_mean_variance_step.last_result = result
    logger.info("dataset feature stats over %d frames: mean shape %s",
                result[0], np.shape(result[1]))
    return ds


unstable_reduce_features_mean_variance_step.last_result = None


def lambda_fn(ds, fn):
    """Arbitrary dataset transform for debugging
    (reference: lidbox/data/steps.py:837-842)."""
    return fn(ds)


# The JAX package's registry (lidbox_tpu/data/steps.py:901-937): the
# reference's (lidbox/data/steps.py:1077-1111) plus
# convert_to_binary_classification.
VALID_STEP_FUNCTIONS = {
    "append_predictions": append_predictions,
    "apply_filters": apply_filters,
    "apply_vad": apply_vad,
    "augment_by_additive_noise": augment_by_additive_noise,
    "augment_signals": augment_signals,
    "as_supervised": as_supervised,
    "cache": cache,
    "compute_rms_vad": compute_rms_vad,
    "compute_webrtc_vad": compute_webrtc_vad,
    "consume": consume,
    "consume_to_tensorboard": consume_to_tensorboard,
    "convert_to_binary_classification": convert_to_binary_classification,
    "create_input_chunks": create_input_chunks,
    "create_signal_chunks": create_signal_chunks,
    "drop_empty": drop_empty,
    "drop_invalid_wavs": drop_invalid_wavs,
    "extract_embeddings": extract_embeddings,
    "extract_features": extract_features,
    "filter_keys_in_set": filter_keys_in_set,
    "group_by_axis_length": group_by_axis_length,
    "initialize": initialize,
    "lambda": lambda_fn,
    "load_audio": load_audio,
    "load_kaldi_data": load_kaldi_data,
    "normalize": normalize,
    "random_signal_fir_filtering": random_signal_fir_filtering,
    "random_signal_speed_change": random_signal_speed_change,
    "reduce_stats": reduce_stats,
    "remap_keys": remap_keys,
    "repeat_too_short_signals": repeat_too_short_signals,
    "shuffle": shuffle,
    "show_all_elements": show_all_elements,
    "unstable_reduce_features_mean_variance":
        unstable_reduce_features_mean_variance_step,
    "write_to_kaldi_files": write_to_kaldi_files,
}
