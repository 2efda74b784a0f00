"""
Batched inference service: wav files in, language scores out (counterpart
of ``lidbox_tpu.serve``).

decode -> optional chunking -> features on the device (the fused log-Mel
kernel with ``stft_method: "pallas"``) -> model forward -> chunk-score merge.
Results are plain tables (``util``): dicts of columns sorted by id.
"""
import numpy as np
import torch

import lidbox_tpu_torch.util as util
from lidbox_tpu_torch import get_device
from lidbox_tpu_torch.data import steps as steps_mod
from lidbox_tpu_torch.data.dataset import Dataset
from lidbox_tpu_torch.data.device_pipeline import DeviceFeatureExtractor
from lidbox_tpu_torch.features import io as audio_io

DEFAULT_FEATURE_CONFIG = {"type": "logmelspectrogram",
                          "melspectrogram": {"num_mel_bins": 64}}


def _check_device(model, device):
    device = get_device(device)
    if model.device.type != device.type:
        raise ValueError(f"model is on {model.device}, the service on "
                         f"{device}: create the model with device={device.type!r}")
    return device


class Classifier:
    """End-to-end LId classifier over audio files."""

    def __init__(self, model, labels, feature_config=None, chunk_length_ms=None,
                 chunk_step_ms=None, batch_size=32, compute_dtype=None,
                 mesh=None, score_fn=None, stage_dtype=None, device="cuda"):
        """Args:
            model: a lidbox_tpu_torch Model on ``device``.
            labels: ordered label list (index = model output).
            feature_config: features section of the config (defaults to
                64-bin log-Mel); every field reaches the extractor.
            chunk_length_ms/chunk_step_ms: optional utterance chunking;
                chunk scores are averaged back per utterance
                (reference merge semantics, util.py:41-57).
            compute_dtype, mesh, score_fn, stage_dtype: not ported yet
                (ROADMAP queue 1); passing one raises.
        """
        self.device = _check_device(model, device)
        self.model = model
        self.labels = list(labels)
        self.feature_config = dict(feature_config or DEFAULT_FEATURE_CONFIG)
        self.chunk_length_ms = chunk_length_ms
        self.chunk_step_ms = chunk_step_ms
        self.batch_size = batch_size
        self._predict_fn = util.make_batch_predict_fn(
            model, batch_size=batch_size, mesh=mesh,
            compute_dtype=compute_dtype, score_fn=score_fn,
            stage_dtype=stage_dtype)

    def _dataset(self, paths, ids=None):
        ids = ids or [str(p) for p in paths]

        def gen():
            for pid, path in zip(ids, paths):
                signal, rate = audio_io.read_audio(path)
                yield {"id": pid, "signal": signal.astype(np.float32),
                       "sample_rate": np.int32(rate)}
        ds = Dataset(gen)
        if self.chunk_length_ms:
            def _pad_short(x):
                # an input shorter than one chunk is padded to one chunk,
                # or the chunker would emit nothing and drop the utterance
                chunk_len = int(int(x["sample_rate"]) * 1e-3
                                * self.chunk_length_ms)
                if x["signal"].size < chunk_len:
                    x = dict(x, signal=np.pad(
                        x["signal"], (0, chunk_len - x["signal"].size)))
                return x
            ds = steps_mod.create_signal_chunks(
                ds.map(_pad_short), self.chunk_length_ms,
                self.chunk_step_ms or self.chunk_length_ms)
        return steps_mod.extract_features(
            ds, {**self.feature_config, "batch_size": self.batch_size},
            device=self.device)

    def scores(self, paths, ids=None):
        """``{"id", "prediction"}`` table of per-utterance score vectors
        (chunk scores averaged)."""
        chunk_scores = util.predict_with_model(
            self.model, self._dataset(paths, ids),
            predict_fn=self._predict_fn, batch_size=self.batch_size)
        if self.chunk_length_ms:
            return util.merge_chunk_predictions(chunk_scores)
        return chunk_scores

    def classify(self, paths, ids=None):
        """Table with ``id``, the predicted ``label`` and one
        ``score_<label>`` column per label."""
        table = self.scores(paths, ids)
        if len(table["id"]) == 0:
            raise ValueError("no utterances produced scores (empty input?)")
        scores = table["prediction"]
        out = {"id": table["id"],
               "label": [self.labels[i] for i in scores.argmax(axis=1)]}
        for i, lab in enumerate(self.labels):
            out[f"score_{lab}"] = scores[:, i]
        return out


class StreamingClassifier:
    """Online LId over an incrementally-fed audio stream.

    Fixed-size analysis chunks with a fixed hop; each completed chunk runs
    features and forward in one call on the device, and the per-chunk
    scores are merged by running mean — the offline chunk-merge semantics
    (reference: lidbox/util.py:41-57), so a stream scored online equals the
    same audio scored offline with the same chunking.

    Usage::

        sc = StreamingClassifier(model, labels)
        for block in audio_blocks:          # arbitrary block sizes
            scores = sc.feed(block)          # updated after each new chunk
        final = sc.scores()
    """

    def __init__(self, model, labels, feature_config=None, sample_rate=16000,
                 chunk_seconds=2.0, hop_seconds=1.0, score_fn=None,
                 device="cuda"):
        if score_fn is not None:
            raise NotImplementedError("score_fn (language-vector models) is "
                                      "not ported yet (ROADMAP queue 1)")
        self.device = _check_device(model, device)
        self.model = model
        self.labels = list(labels)
        self.sample_rate = int(sample_rate)
        self.chunk_len = int(chunk_seconds * sample_rate)
        self.hop = int(hop_seconds * sample_rate)
        if not 0 < self.hop <= self.chunk_len:
            raise ValueError("need 0 < hop_seconds <= chunk_seconds")
        self.extractor = DeviceFeatureExtractor(
            dict(feature_config or DEFAULT_FEATURE_CONFIG), device=self.device)
        self.reset()

    def reset(self):
        self._buffer = np.zeros(0, np.float32)
        self._score_sum = None
        self._num_chunks = 0

    @torch.inference_mode()
    def _score_chunk(self, chunk):
        x = torch.as_tensor(chunk[None, :], device=self.device)
        feats = self.extractor.extract(x, self.sample_rate)
        if self.extractor.validate_finite:
            self.extractor.to_host(feats)
        return self.model.apply(feats)[0].float().cpu().numpy()

    def feed(self, samples):
        """Append audio samples (any length); runs the model on every
        completed chunk. Returns the current running score vector, or None
        if no chunk has completed yet."""
        self._buffer = np.concatenate(
            [self._buffer, np.asarray(samples, np.float32).ravel()])
        while self._buffer.size >= self.chunk_len:
            s = self._score_chunk(self._buffer[:self.chunk_len])
            self._buffer = self._buffer[self.hop:]
            self._score_sum = s if self._score_sum is None else self._score_sum + s
            self._num_chunks += 1
        return self.scores()

    def scores(self):
        """Running mean of per-chunk score vectors (None before the first
        completed chunk)."""
        if self._num_chunks == 0:
            return None
        return self._score_sum / self._num_chunks

    def label(self):
        s = self.scores()
        return None if s is None else self.labels[int(np.argmax(s))]
