"""
The serving steps of the data pipeline (counterpart of the same-named
functions in ``lidbox_tpu.data.steps``): signal chunking and batched
feature extraction on the device.
"""
import numpy as np

from lidbox_tpu_torch.data.dataset import Dataset
from lidbox_tpu_torch.data.device_pipeline import DeviceFeatureExtractor


def create_signal_chunks(ds, length_ms, step_ms, max_pad_ms=0,
                         max_num_chunks_per_signal=int(1e6)):
    """Split each signal into fixed-length chunks; chunk ids are the parent
    id suffixed with a zero-padded chunk number, and ``duration`` is updated
    (reference: lidbox/data/steps.py:579-632)."""
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


def extract_features(ds, config, device="cuda"):
    """Extract features from ``signal`` into ``input`` on ``device``
    (reference: lidbox/data/steps.py:708-736): ragged batches of
    ``batch_size`` are padded to shape buckets and the features sliced back
    to true frame counts. The ``group_by_input_length`` mode is not ported
    yet (ROADMAP queue 1, item 8)."""
    config = dict(config)
    if "group_by_input_length" in config:
        raise NotImplementedError("group_by_input_length feature batching is "
                                  "not ported yet (ROADMAP queue 1, item 8)")
    feature_type = config.get("type", "logmelspectrogram")
    extractor = DeviceFeatureExtractor(config, device=device)
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
