"""
Batched inference service: wav files in, language scores out (counterpart
of ``lidbox_tpu.serve``).

decode -> optional chunking -> features on the device (the fused log-Mel
kernel with ``stft_method: "pallas"``) -> model forward -> chunk-score merge.
Results are plain tables (``util``): dicts of columns sorted by id.

On the card each step is one CUDA graph replay per shape
(``graphs.ForwardProgram``), the JAX package's jitted programs: the
extractor's features, the batch forward (``util.make_batch_predict_fn``)
and, for a stream, the features and forward of a chunk fused into one.
``eager=True`` runs them eagerly, the graphs' reference.
"""
import numpy as np
import torch

import lidbox_tpu_torch.util as util
from lidbox_tpu_torch import get_device, parallel
from lidbox_tpu_torch.data import steps as steps_mod
from lidbox_tpu_torch.data.dataset import Dataset
from lidbox_tpu_torch.data.device_pipeline import DeviceFeatureExtractor
from lidbox_tpu_torch.features import io as audio_io
from lidbox_tpu_torch.train import graphs

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
                 mesh=None, score_fn=None, stage_dtype=None, device="cuda",
                 eager=False):
        """Args:
            model: a lidbox_tpu_torch Model on ``device``.
            labels: ordered label list (index = model output).
            feature_config: features section of the config (defaults to
                64-bin log-Mel); every field reaches the extractor.
            chunk_length_ms/chunk_step_ms: optional utterance chunking;
                chunk scores are averaged back per utterance
                (reference merge semantics, util.py:41-57).
            compute_dtype: e.g. ``"bfloat16"``, the forward's dtype (scores
                come back float32).
            stage_dtype: e.g. ``"bfloat16"``: the feature feed is rounded
                to it on the host (half the transfer bytes) and upcast on
                the device; scores differ only by that input rounding.
            score_fn: raw outputs -> [B, len(labels)] scores, for headless
                language-vector models (pass AngularProximity.predict);
                log-probability heads leave it None.
            mesh: a ``parallel.Mesh``: every rank serves the same files,
                extracts their features on its card, runs the forward of
                its rows of each batch (``batch_size`` must divide over
                the mesh) and returns the whole table
                (``util.make_batch_predict_fn``).
            eager: run the features and the forward eagerly instead of as
                graph replays (the graphs' reference).
        """
        self.device = _check_device(model, device)
        self.model = model
        self.labels = list(labels)
        self.feature_config = dict(feature_config or DEFAULT_FEATURE_CONFIG)
        # one extractor for every call: its graphs serve them all
        self.extractor = DeviceFeatureExtractor(self.feature_config,
                                                device=self.device,
                                                eager=eager)
        self.chunk_length_ms = chunk_length_ms
        self.chunk_step_ms = chunk_step_ms
        self.batch_size = batch_size
        self._predict_fn = util.make_batch_predict_fn(
            model, batch_size=batch_size, mesh=mesh,
            compute_dtype=compute_dtype, score_fn=score_fn,
            stage_dtype=stage_dtype, eager=eager)

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
            device=self.device, extractor=self.extractor)

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
    features and forward (and ``score_fn``) as one program on the device,
    one CUDA graph for the chunk shape [1, chunk_len] (the JAX package's
    ``_fused_chunk``; ``validate_finite`` keeps the features apart, checked
    on the host before the forward), and the per-chunk scores are merged by
    running mean — the offline chunk-merge semantics
    (reference: lidbox/util.py:41-57), so a stream scored online equals the
    same audio scored offline with the same chunking. With a
    ``parallel.Mesh`` of several ranks every rank is fed the same stream
    and each chunk's forward runs data-parallel (a batch of one row padded
    to the mesh size, eagerly by rule: ``graphs.forward_reason``), every
    rank holding the scores. A one-rank mesh has nothing to split or
    gather: its chunks run the fused program, as without a mesh (every
    rank of a larger group scoring its own stream).

    Usage::

        sc = StreamingClassifier(model, labels)
        for block in audio_blocks:          # arbitrary block sizes
            scores = sc.feed(block)          # updated after each new chunk
        final = sc.scores()
    """

    def __init__(self, model, labels, feature_config=None, sample_rate=16000,
                 chunk_seconds=2.0, hop_seconds=1.0, score_fn=None,
                 mesh=None, device="cuda", eager=False):
        self.score_fn = score_fn  # outputs -> [B, N] (language vectors)
        self.device = _check_device(model, device)
        self._mesh_predict = None
        if graphs.forward_reason(parallel.as_mesh(mesh)) is not None:
            self._mesh_predict = util.make_batch_predict_fn(
                model, batch_size=mesh.size, mesh=mesh, score_fn=score_fn)
        self.model = model
        self.labels = list(labels)
        self.sample_rate = int(sample_rate)
        self.chunk_len = int(chunk_seconds * sample_rate)
        self.hop = int(hop_seconds * sample_rate)
        if not 0 < self.hop <= self.chunk_len:
            raise ValueError("need 0 < hop_seconds <= chunk_seconds")
        self.extractor = DeviceFeatureExtractor(
            dict(feature_config or DEFAULT_FEATURE_CONFIG), device=self.device,
            eager=eager)
        # the fused chunk program, or with validate_finite the forward
        self.program = graphs.ForwardProgram(
            "forward" if self.extractor.validate_finite else "stream",
            eager=eager)
        self.reset()

    def reset(self):
        self._buffer = np.zeros(0, np.float32)
        self._score_sum = None
        self._num_chunks = 0

    def _forward(self, feats):
        out = self.model.apply(feats)
        if self.score_fn is not None:
            out = self.score_fn(out)
        return out[0].float()

    def _fused(self, signals):
        return self._forward(self.extractor.features(signals,
                                                     self.sample_rate))

    @torch.inference_mode()
    def _score_chunk(self, chunk):
        x = self.extractor.host_tensor(chunk[None, :])
        held = graphs.module_tensors(self.model.module)
        if self._mesh_predict is None and not self.extractor.validate_finite:
            return self.program(self._fused, {"signals": x}, self.device,
                                held=held).cpu().numpy()
        feats = self.extractor.extract(x, self.sample_rate)
        if self.extractor.validate_finite:
            self.extractor.to_host(feats)
        if self._mesh_predict is not None:
            return self._mesh_predict(feats.cpu().numpy())[0]
        return self.program(self._forward, {"feats": feats}, self.device,
                            held=held).cpu().numpy()

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
