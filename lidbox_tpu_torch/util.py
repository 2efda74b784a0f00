"""
High-level API: prediction, chunk merging, classification reports
(counterpart of ``lidbox_tpu.util``; reference: lidbox/util.py).

Results are plain Python/numpy tables in place of the JAX package's pandas
DataFrames: a dict of equal-length columns whose ``"id"`` column is sorted
and unique, e.g. ``{"id": [...], "prediction": np.ndarray [N, C]}``. The
report is numpy where the JAX package calls ``sklearn.metrics`` (absent on
the card's machine), to the same values.
"""
import collections
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from lidbox_tpu_torch import parallel
from lidbox_tpu_torch.data.dataset import padded_batch
from lidbox_tpu_torch.metrics import SparseAverageDetectionCost
from lidbox_tpu_torch.metrics import equal_error_rate as metrics_eer
from lidbox_tpu_torch.train import graphs


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


def _torch_dtype(dtype):
    """A torch dtype from a torch dtype or its name (``"bfloat16"``)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    value = getattr(torch, str(dtype), None)
    if not isinstance(value, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return value


def make_batch_predict_fn(model, batch_size=32, mesh=None, compute_dtype=None,
                          apply_kwargs=None, score_fn=None, stage_dtype=None,
                          eager=False):
    """``(inputs [B, T, F] numpy, frame_mask [B, T] or None) -> numpy
    outputs [B, ...]``: one forward on the model's device.

    ``apply_kwargs`` forwards model.apply options, e.g.
    ``{"output": "embedding"}``. ``compute_dtype`` (e.g. ``"bfloat16"``)
    runs the forward on parameters and input cast to it, the output coming
    back float32. ``score_fn`` maps the raw outputs to [B, N] class scores
    on the device before the readback: language-vector models (ap_lstm)
    pass ``AngularProximity.predict``, so every consumer (C_avg, reports,
    Classifier) sees scores. ``stage_dtype`` (a floating type, e.g.
    ``"bfloat16"``) rounds float inputs to it on the host before the
    transfer (half the bytes) and upcasts them on the device: outputs
    differ from the float32 feed only by that input rounding.

    The forward (the upcast, ``compute_dtype`` and ``score_fn`` included)
    is one CUDA graph per (input shape, staged dtype, masked), the JAX
    package's ``apply_jit`` / ``apply_jit_masked`` (``graphs.ForwardProgram``,
    kind "forward"): the staged input is copied from pinned host memory
    into the graph's input buffer, and the output cloned out of the
    graph's before the next replay. The graphs read the model's parameters
    and buffers in place: weights updated in place are served by the next
    call, replaced tensors are captured anew, a frame-masked batch of a
    recurrent model too. ``eager=True`` runs every forward eagerly, the
    graphs' reference; the CPU runs them eagerly. Calls from several
    threads are served one replay at a time.

    With a ``parallel.Mesh`` inference is data-parallel: every rank calls
    the function with the same inputs (in lockstep: each call is a
    collective), every batch is zero-padded to ``batch_size`` (a multiple
    of the mesh size; larger inputs run in ``batch_size`` chunks), each
    rank runs the forward of its rows, and the rows are gathered back, so
    every rank returns the whole batch's outputs. Ranks outside a sub-mesh
    (``get_mesh(num_devices=N)`` below the group's size) run no forward
    and receive the outputs from rank 0. Only the forward of a rank's rows
    is a program, captured as without a mesh (on ``[batch_size / mesh
    size, ...]``), the gather and the share outside it. A mesh of several
    ranks runs it eagerly, by rule (``graphs.forward_reason``, logged
    once); at one rank the gather and the share return their input, so
    the mesh runs the mesh-less graph of a full batch.

    ``predict_fn.refresh()``, as the JAX package's, drops what the
    function keeps of the weights: the captured graphs, which hold the
    tensors they read at capture. ``predict_fn.mesh`` is the mesh, or
    None: a mesh's calls are collectives, which every rank makes in the
    same order."""
    mesh = parallel.as_mesh(mesh)
    if mesh is not None and batch_size % mesh.size:
        raise ValueError(f"batch_size {batch_size} must divide over the "
                         f"{mesh.size}-rank mesh")
    compute_dtype = _torch_dtype(compute_dtype)
    stage = _torch_dtype(stage_dtype)
    if stage is not None and not stage.is_floating_point:
        raise ValueError(f"stage_dtype must be floating, got {stage_dtype!r}"
                         " (integer PCM staging is a waveform-path "
                         "feature: on_device.stage_signals)")
    kwargs = dict(apply_kwargs or {})
    if compute_dtype is not None:
        kwargs["compute_dtype"] = compute_dtype

    def body(x, mask=None):
        # with compute_dtype, model.apply casts the input itself
        if compute_dtype is None and x.is_floating_point():
            x = x.float()
        out = model.apply(x, mask=mask, **kwargs)
        if score_fn is not None:
            out = score_fn(out)
        return out.float()

    def staged(inputs, mask):
        """The host tensors of one batch: the input cast to the staging
        dtype on the host (the transfer carries its bytes), pinned when
        they go to the card."""
        x = torch.as_tensor(np.asarray(inputs))
        if stage is not None and x.is_floating_point():
            x = x.to(stage)
        if mask is not None:
            mask = torch.as_tensor(np.asarray(mask, bool))
        if model.device.type == "cuda":
            x = x.pin_memory()
            mask = None if mask is None else mask.pin_memory()
        return x, mask

    program = graphs.ForwardProgram("forward", eager=eager)
    reason = graphs.forward_reason(mesh)

    def forward(inputs, mask=None):
        x, mask = staged(inputs, mask)
        return program(body, {"x": x, "mask": mask}, model.device,
                       held=graphs.module_tensors(model.module),
                       reason=reason)

    if mesh is None:
        def predict_fn(inputs, mask=None):
            return forward(inputs, mask).cpu().numpy()
        predict_fn.refresh = program.release
        predict_fn.mesh = None
        return predict_fn

    @torch.inference_mode()
    def predict_fn(inputs, mask=None):
        inputs = np.asarray(inputs)
        n = inputs.shape[0]
        if n > batch_size:  # chunk oversized batches
            return np.concatenate(
                [predict_fn(inputs[i:i + batch_size],
                            None if mask is None else mask[i:i + batch_size])
                 for i in range(0, n, batch_size)])
        out = None
        if mesh.is_member:
            pad = batch_size - n
            if pad:  # one copy on the host, none for a full batch
                inputs = np.concatenate([inputs, np.zeros(
                    (pad,) + inputs.shape[1:], inputs.dtype)])
                if mask is not None:
                    # pad rows get an all-True mask: their (discarded)
                    # forwards stay finite instead of pooling over zero
                    # valid frames
                    mask = np.asarray(mask, bool)
                    mask = np.concatenate(
                        [mask, np.ones((pad,) + mask.shape[1:], bool)])
            m = batch_size // mesh.size
            rows = slice(mesh.rank * m, (mesh.rank + 1) * m)
            out = parallel.all_gather_rows(
                forward(inputs[rows], None if mask is None else mask[rows]),
                mesh)
        return parallel.share_with_world(out, mesh)[:n].cpu().numpy()
    predict_fn.refresh = program.release
    predict_fn.mesh = mesh
    return predict_fn


def _batch_arrays(pending, pad_buckets):
    """(inputs, frame mask or None) of a batch of elements: only ``input``
    is batched, zero-padded (to ``pad_buckets`` when given) when ragged."""
    lengths = {p["input"].shape[0] for p in pending}
    if len(lengths) == 1:
        return np.stack([p["input"] for p in pending]).astype(np.float32), None
    batch = padded_batch([{"input": p["input"]} for p in pending], "input",
                         buckets=pad_buckets)
    inputs = np.asarray(batch["input"], np.float32)
    mask = (np.arange(inputs.shape[1])[None, :]
            < batch["input_length"][:, None])
    return inputs, mask


def predict_with_model(model, ds, predict_fn=None, batch_size=32,
                       pad_buckets=None, mesh=None, score_fn=None):
    """Map a model over all elements of ds (dict elements with ``input``)
    in batches of ``batch_size``; returns the ``{"id", "prediction"}``
    table (reference: util.py:23-38).

    A ragged batch is zero-padded (to ``pad_buckets`` when given) and its
    frame mask passed to ``predict_fn(inputs, mask)``, so stats-pooling
    models see only real frames. Only ``input`` is batched: other keys of
    the elements (a ``signal`` of another length) may differ in shape,
    where the JAX package's padded batch raises on them. ``score_fn`` maps
    the outputs to class scores (``make_batch_predict_fn``; applied to a
    custom ``predict_fn``'s outputs too). With a ``mesh`` every rank maps
    the same dataset and each batch's forward is data-parallel
    (``make_batch_predict_fn``); every rank returns the whole table.

    Batches run in the JAX package's 2-deep pipeline: the predict fn runs
    on 2 worker threads, so batch i + 1's transfer and forward are queued
    while batch i's outputs are read back, and the results drain in order
    (on one thread with a ``mesh``, or a predict fn with one, its
    ``mesh``: each call is a collective, made in order on every rank). An
    exception of any batch is raised here."""
    in_order = (mesh is not None
                or getattr(predict_fn, "mesh", None) is not None)
    if predict_fn is None:
        if mesh is not None:
            batch_size = -(-batch_size // mesh.size) * mesh.size
        predict_fn = make_batch_predict_fn(model, batch_size=batch_size,
                                           mesh=mesh, score_fn=score_fn)
    elif score_fn is not None:
        base_fn = predict_fn

        def predict_fn(inputs, mask):
            out = torch.as_tensor(np.asarray(base_fn(inputs, mask)))
            return score_fn(out).float().cpu().numpy()
    pool = ThreadPoolExecutor(max_workers=1 if in_order else 2)
    ids, predictions = [], []
    queued = collections.deque()

    def drain_one():
        pending, future = queued.popleft()
        for p, pred in zip(pending, future.result()):
            ids.append(str(p["id"]))
            predictions.append(np.asarray(pred))

    def submit(pending):
        queued.append((pending, pool.submit(
            lambda: predict_fn(*_batch_arrays(pending, pad_buckets)))))
        while len(queued) > 2:
            drain_one()

    try:
        pending = []
        for x in ds:
            pending.append(x)
            if len(pending) == batch_size:
                submit(pending)
                pending = []
        if pending:
            submit(pending)
        while queued:
            drain_one()
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
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


def _divide(numerator, denominator):
    """Elementwise ``numerator / denominator``, 0 where the denominator is
    0 (scikit-learn's ``zero_division=0``)."""
    numerator = np.asarray(numerator, np.float64)
    denominator = np.asarray(denominator, np.float64)
    safe = np.where(denominator == 0.0, 1.0, denominator)
    return np.where(denominator == 0.0, 0.0, numerator / safe)


def _label_counts(true_sparse, pred_sparse, num_labels):
    """Per-label true positive, predicted and true counts."""
    tp = np.zeros(num_labels, np.int64)
    pred_sum = np.zeros(num_labels, np.int64)
    true_sum = np.zeros(num_labels, np.int64)
    for t, p in zip(true_sparse, pred_sparse):
        if 0 <= p < num_labels:
            pred_sum[p] += 1
        if 0 <= t < num_labels:
            true_sum[t] += 1
            tp[t] += t == p
    return tp, pred_sum, true_sum


def _prf(tp, pred_sum, true_sum):
    """Precision, recall and f1 from counts (scikit-learn's formulas)."""
    return (_divide(tp, pred_sum), _divide(tp, true_sum),
            _divide(2.0 * tp, true_sum.astype(np.float64) + pred_sum))


def confusion_matrix(true_sparse, pred_sparse, num_labels):
    """[N, N] counts, row = true class, column = predicted class; every
    class keeps its row even when absent from the data."""
    cm = np.zeros((num_labels, num_labels), np.int64)
    for t, p in zip(true_sparse, pred_sparse):
        if 0 <= t < num_labels and 0 <= p < num_labels:
            cm[t, p] += 1
    return cm


def classification_report(true_sparse, pred_dense, label2target,
                          dense2sparse_fn=None, num_cavg_thresholds=100,
                          eer_convention="fpr"):
    """Per-class precision, recall, f1 and support, accuracy, macro and
    weighted averages (``sklearn.metrics.classification_report`` with
    ``labels=range(N)``, ``output_dict=True``, ``zero_division=0``), min
    C_avg over a threshold grid spanning the score range, per-class EER
    and its nanmean, and the [N, N] confusion matrix
    (reference: util.py:60-105).

    C_avg runs through ``metrics.SparseAverageDetectionCost`` on the CPU,
    EER through ``metrics.equal_error_rate`` with ``eer_convention``
    (``"fpr"``, the reference's, or ``"midpoint"``); a class absent from
    the test set (or covering all of it) has EER NaN and is left out of
    the average."""
    if dense2sparse_fn is None:
        dense2sparse_fn = lambda pred: pred.argmax(axis=1)
    true_sparse = np.asarray(true_sparse)
    pred_dense = np.asarray(pred_dense)
    pred_sparse = np.asarray(dense2sparse_fn(pred_dense))
    num_labels = len(label2target)
    names = list(label2target)

    tp, pred_sum, true_sum = _label_counts(true_sparse, pred_sparse,
                                           num_labels)
    precision, recall, f1 = _prf(tp, pred_sum, true_sum)
    headers = ("precision", "recall", "f1-score", "support")
    report = {name: dict(zip(headers, (float(p), float(r), float(f), float(n))))
              for name, p, r, f, n in zip(names, precision, recall, f1,
                                          true_sum)}
    support = float(np.sum(true_sum))
    micro = [float(v[0]) for v in _prf(tp.sum(keepdims=True),
                                        pred_sum.sum(keepdims=True),
                                        true_sum.sum(keepdims=True))]
    seen = set(np.unique(true_sparse).tolist()) | set(
        np.unique(pred_sparse).tolist())
    if seen <= set(range(num_labels)):
        report["accuracy"] = micro[0]  # micro precision is the accuracy
    else:
        report["micro avg"] = dict(zip(headers, (*micro, support)))
    report["macro avg"] = dict(zip(headers, (
        float(np.nanmean(precision)), float(np.nanmean(recall)),
        float(np.nanmean(f1)), support)))
    if np.sum(true_sum) == 0:
        weighted = (np.nanmean(precision), np.nanmean(recall), np.nanmean(f1))
    else:
        weighted = tuple(np.average(v, weights=true_sum)
                         for v in (precision, recall, f1))
    report["weighted avg"] = dict(zip(headers, (*map(float, weighted),
                                                support)))

    thresholds = np.linspace(pred_dense.min(), pred_dense.max(),
                             num_cavg_thresholds)
    cavg = SparseAverageDetectionCost(num_labels, tuple(thresholds.tolist()))
    state = cavg.update_sparse(cavg.init_state(),
                               torch.as_tensor(true_sparse),
                               torch.as_tensor(pred_dense))
    report["avg_detection_cost"] = float(cavg.result(state))

    true_dense = np.eye(num_labels)[true_sparse]
    eer = np.zeros(num_labels)
    for l in range(num_labels):
        eer[l] = metrics_eer(pred_dense[:, l], true_dense[:, l],
                             convention=eer_convention)
    report["avg_equal_error_rate"] = float(np.nanmean(eer))
    for label, i in label2target.items():
        report[label]["equal_error_rate"] = eer[i]
    report["confusion_matrix"] = confusion_matrix(true_sparse, pred_sparse,
                                                  num_labels)
    return report


def evaluate_testset_with_model(model, test_ds, test_meta, lang2target,
                                score_fn=None, mesh=None):
    """predict + join on metadata + report (reference: util.py:108-119).

    ``test_meta`` is a table with ``"id"`` and ``"target"`` columns.
    Chunk-level predictions (ids carrying a ``-<chunknum>`` suffix from
    create_signal_chunks / create_input_chunks) are merged back to
    utterance level by averaging before the join; a join whose id sets
    differ raises. ``score_fn`` maps the raw model outputs to [B, N] class
    scores first (required for language-vector models: pass the
    AngularProximity loss's ``predict``). With a ``mesh`` the predictions
    are data-parallel (``predict_with_model``)."""
    utt2pred = predict_with_model(model, test_ds, score_fn=score_fn,
                                  mesh=mesh)
    meta_ids = {str(i) for i in test_meta["id"]}
    pred_ids = utt2pred["id"]
    if (pred_ids and not set(pred_ids) <= meta_ids
            and {chunk_parent_id(i) for i in pred_ids} <= meta_ids):
        utt2pred = merge_chunk_predictions(utt2pred)
    if set(utt2pred["id"]) != meta_ids:
        raise AssertionError("Failed to join predictions with test_meta: "
                             "utterance id sets differ")
    target = dict(zip((str(i) for i in test_meta["id"]), test_meta["target"]))
    true_sparse = np.asarray([target[i] for i in utt2pred["id"]], np.int32)
    return classification_report(true_sparse, utt2pred["prediction"],
                                 lang2target)


def model2function(model):
    """Model -> inference callable ``x [B, T, F] -> outputs`` on the
    model's device with its configured head, the analogue of the
    reference's concrete tf.function (reference: util.py:122-127);
    ``export.export_program`` makes the ahead-of-time version."""
    @torch.inference_mode()
    def model_fn(x):
        x = torch.as_tensor(np.asarray(x, np.float32), device=model.device)
        return model.apply(x, output=model.output)
    return model_fn


def standard_scaler(dataset, axis=0, key="input"):
    """Dataset-level standardization closure from two-pass float64 moments
    (reference: util.py:130-146)."""
    from lidbox_tpu_torch.data import steps as data_steps
    _, means, variances = data_steps.unstable_reduce_features_mean_variance(
        dataset, axis=axis, key=key)
    stddevs = np.sqrt(np.maximum(1e-9, variances))

    def scale_dataset(ds):
        def _scale(x):
            scaled = (np.asarray(x[key], np.float64) - means) / stddevs
            return dict(x, **{key: scaled.astype(np.asarray(x[key]).dtype)})
        return ds.map(_scale)
    return scale_dataset
