"""
Prediction and chunk-score merging (counterpart of the serving half of
``lidbox_tpu.util``; reference: lidbox/util.py).

Results are plain Python/numpy tables in place of the JAX package's pandas
DataFrames: a dict of equal-length columns whose ``"id"`` column is sorted
and unique, e.g. ``{"id": [...], "prediction": np.ndarray [N, C]}``.
"""
import collections

import numpy as np
import torch

from lidbox_tpu_torch.data.dataset import padded_batch


def predictions_table(ids, predictions):
    """``{"id", "prediction"}`` table sorted by id; duplicate ids raise
    (reference: util.py:17-20)."""
    ids = [str(i) for i in ids]
    dupes = [i for i, n in collections.Counter(ids).items() if n > 1]
    if dupes:
        raise ValueError(f"duplicate utterance ids, e.g. {dupes[:5]}")
    order = sorted(range(len(ids)), key=ids.__getitem__)
    preds = [np.asarray(predictions[i]) for i in order]
    return {"id": [ids[i] for i in order],
            "prediction": np.stack(preds) if preds else np.zeros((0, 0),
                                                                 np.float32)}


def make_batch_predict_fn(model, batch_size=32, mesh=None, compute_dtype=None,
                          apply_kwargs=None, score_fn=None, stage_dtype=None):
    """``(inputs [B, T, F] numpy, frame_mask [B, T] or None) -> numpy
    outputs [B, ...]``: one forward on the model's device.

    ``apply_kwargs`` forwards model.apply options, e.g.
    ``{"output": "embedding"}``. The JAX package's ``mesh``,
    ``compute_dtype``, ``score_fn`` and ``stage_dtype`` options are not
    ported yet (ROADMAP queue 1) and raise."""
    for name, value in (("mesh", mesh), ("compute_dtype", compute_dtype),
                        ("score_fn", score_fn), ("stage_dtype", stage_dtype)):
        if value is not None:
            raise NotImplementedError(f"{name} is not ported yet (ROADMAP "
                                      "queue 1, 'left for later slices')")
    kwargs = dict(apply_kwargs or {})

    @torch.inference_mode()
    def predict_fn(inputs, mask=None):
        x = torch.as_tensor(np.asarray(inputs, np.float32), device=model.device)
        if mask is not None:
            mask = torch.as_tensor(np.asarray(mask, bool), device=model.device)
        return model.apply(x, mask=mask, **kwargs).float().cpu().numpy()
    return predict_fn


def predict_with_model(model, ds, predict_fn=None, batch_size=32,
                       pad_buckets=None):
    """Map a model over all elements of ds (dict elements with ``input``)
    in batches of ``batch_size``; returns the ``{"id", "prediction"}``
    table (reference: util.py:23-38).

    A ragged batch is zero-padded (to ``pad_buckets`` when given) and its
    frame mask passed to ``predict_fn(inputs, mask)``, so stats-pooling
    models see only real frames."""
    if predict_fn is None:
        predict_fn = make_batch_predict_fn(model, batch_size=batch_size)
    ids, predictions = [], []

    def run(pending):
        lengths = {p["input"].shape[0] for p in pending}
        mask = None
        if len(lengths) == 1:
            inputs = np.stack([p["input"] for p in pending])
        else:
            batch = padded_batch(pending, "input", buckets=pad_buckets)
            inputs = batch["input"]
            mask = (np.arange(inputs.shape[1])[None, :]
                    < batch["input_length"][:, None])
        preds = predict_fn(np.asarray(inputs, np.float32), mask)
        for p, pred in zip(pending, preds):
            ids.append(str(p["id"]))
            predictions.append(np.asarray(pred))

    pending = []
    for x in ds:
        pending.append(x)
        if len(pending) == batch_size:
            run(pending)
            pending = []
    if pending:
        run(pending)
    return predictions_table(ids, predictions)


def chunk_parent_id(chunk_id):
    """(reference: util.py:41-42)"""
    return chunk_id.rsplit("-", 1)[0]


def stack_and_average(v):
    return np.stack(list(v)).mean(axis=0)


def merge_chunk_predictions(chunk_predictions, merge_rows_fn=None):
    """Group the rows of a ``{"id", "prediction"}`` table by parent
    utterance id and merge their predictions (mean by default)
    (reference: util.py:47-57)."""
    if merge_rows_fn is None:
        merge_rows_fn = stack_and_average
    groups = {}
    for cid, pred in zip(chunk_predictions["id"],
                         chunk_predictions["prediction"]):
        groups.setdefault(chunk_parent_id(cid), []).append(pred)
    return predictions_table(list(groups),
                             [merge_rows_fn(rows) for rows in groups.values()])
