"""
Ranks of the port's data- and tensor-parallel tests
(tests/test_torch_parallel*.py, tests/test_torch_tensor_parallel*.py).

``start_ranks`` launches this file once per rank as a subprocess that
imports torch and the port only. The ranks rendezvous through a
``torch.distributed.FileStore`` under the test's tmp directory (no TCP
port, so parallel test workers cannot collide), start a gloo group with a
60 s collective timeout, run one scenario on the CPU with the parent's
inputs (``spec.pt``: seeded numpy data and weights converted from the JAX
package) and write their results to ``rank<r>.pt``. ``finish_ranks`` waits
with a hard timeout and kills every rank when one fails or hangs, so a
hung collective fails its own test.
"""
import logging
import os
import subprocess
import sys

import numpy as np
import torch

from torch_init_cache import memoized

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLLECTIVE_TIMEOUT_S = 60
RANK_TIMEOUT_S = 150

THRESHOLDS = tuple(float(t) for t in np.linspace(-10.0, 0.0, 11))
# Adam eps 1e-4, as tests/test_torch_train.py: the one-step parameter
# comparison is about the gradients, not lr * g / |g|
ADAM = {"cls": "Adam", "kwargs": {"learning_rate": 1e-3, "epsilon": 1e-4}}


def start_ranks(scenario, spec, tmp_path, world=2):
    """Write ``spec`` and launch ``world`` ranks running ``scenario``."""
    tmp_path = str(tmp_path)
    torch.save(spec, os.path.join(tmp_path, "spec.pt"))
    procs = []
    for rank in range(world):
        env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="-1",
                   PYTHONPATH=REPO, OMP_NUM_THREADS="2",
                   COORDINATOR_ADDRESS="file://" + os.path.join(tmp_path,
                                                                "store"),
                   NUM_PROCESSES=str(world), PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), scenario, tmp_path],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return procs, tmp_path


def finish_ranks(handle, timeout=RANK_TIMEOUT_S):
    """Every rank's results; raises (after killing them all) when a rank
    fails or outlives ``timeout``."""
    procs, tmp_path = handle
    errors = []
    try:
        for rank, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {rank} timed out") from None
            if p.returncode != 0:
                errors.append(f"rank {rank} exit {p.returncode}:\n"
                              f"{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [torch.load(os.path.join(tmp_path, f"rank{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


def numpy_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(numpy_tree(v) for v in tree)
    return tree


def one_per_epoch(batches):
    """A feed whose every epoch is the next batch: a 1-step epoch's loss is
    that step's loss."""
    it = iter(batches)
    return lambda: [next(it)]


# -- the ranks -----------------------------------------------------------------

def _checksum(mesh, tensors):
    """Every rank's float64 sum of ``tensors`` (a dict), gathered."""
    from lidbox_tpu_torch import parallel
    total = sum(float(t.double().sum()) for t in tensors.values())
    return parallel.host_allgather(np.float64(total), mesh)[:, 0]


def _trainer(model, mesh, metrics=True, **kw):
    from lidbox_tpu_torch import losses, metrics as tmetrics
    from lidbox_tpu_torch.train import loop
    from lidbox_tpu_torch.train.optimizers import optimizer_from_config
    optimizer, _ = optimizer_from_config(ADAM)
    m = ({"C_avg": tmetrics.SparseAverageDetectionCost(
        model.num_outputs, THRESHOLDS)} if metrics else {})
    return loop.Trainer(model, optimizer, losses.nll_loss, metrics=m,
                        mesh=mesh, device="cpu", **kw)


def _model(key, spec_model):
    import lidbox_tpu_torch.models as tmodels
    model = tmodels.create(key, spec_model["shape"], spec_model["outputs"],
                           device="cpu")
    model.module.load_state_dict(spec_model["state"])
    model.num_outputs = spec_model["outputs"]
    return model


def scenario_trainer(spec, mesh, out):
    """Trainer.fit / evaluate / predict, the feed options, a BatchNorm
    model, the explicit-collective step, uneven feeds and checkpoints."""
    from lidbox_tpu_torch import losses, parallel
    from lidbox_tpu_torch.models.model_utils import ModelWrapper
    from lidbox_tpu_torch.parallel import spmd
    from lidbox_tpu_torch.train import ModelCheckpoint, loop
    from lidbox_tpu_torch.train.optimizers import optimizer_from_config

    local = lambda batches: [parallel.local_slice(b, mesh) for b in batches]

    # x-vector: 3 steps, parameters after the first, evaluate, predict
    trainer = _trainer(_model("xvector", spec["xvector"]), mesh)
    train = local(spec["xv_train"])
    h = trainer.fit(one_per_epoch(train[:1]), epochs=1, verbose=False)
    params1 = numpy_tree(trainer.state.params)
    h += trainer.fit(one_per_epoch(train[1:]), epochs=2, verbose=False)
    out["xv"] = {"losses": [e["loss"] for e in h], "params1": params1,
                 "eval": trainer.evaluate(lambda: local(spec["xv_val"])),
                 "predict": trainer.predict(lambda: local(spec["xv_val"])),
                 "checksums": _checksum(mesh, trainer.state.params)}

    # the feed options on the dnn, a ragged tail included
    for shuffle in (True, "rows", False):
        t = _trainer(_model("dnn", spec["dnn"]), mesh, metrics=False,
                     cache_staged=True)
        h = t.fit(lambda: local(spec["dnn_train"]), epochs=3,
                  steps_per_dispatch=2, cache_shuffle=shuffle, verbose=False)
        out[f"feed_{shuffle}"] = {
            "losses": [e["loss"] for e in h], "step": t.state.step,
            "checksums": _checksum(mesh, t.state.params)}

    # crnn: BatchNorm on the global batch's statistics
    wrapper = ModelWrapper.from_config(spec["crnn_config"], mesh=mesh,
                                       device="cpu")
    wrapper.model.module.load_state_dict(spec["crnn"]["state"])
    h = wrapper.fit(one_per_epoch(local(spec["crnn_train"])),
                    lambda: local(spec["crnn_val"]), epochs=3, verbose=False)
    state = wrapper.trainer.state
    out["crnn"] = {"losses": [e["loss"] for e in h],
                   "val_loss": [e["val_loss"] for e in h],
                   "state": numpy_tree({**state.params, **state.batch_stats}),
                   "checksums": _checksum(mesh, state.params),
                   "bn_checksums": _checksum(mesh, state.batch_stats)}

    # the explicit-collective step (pmean) on the deterministic dnn
    model = _model("dnn", spec["dnn"])
    optimizer, _ = optimizer_from_config(ADAM)
    step = spmd.make_shard_map_train_step(model, optimizer, losses.nll_loss,
                                          mesh)
    st = _trainer(model, mesh, metrics=False).create_state()
    spmd_losses = []
    for b in local(spec["dnn_train"][:2]):
        st, loss = step(st, {k: torch.as_tensor(v) for k, v in b.items()}, 0)
        spmd_losses.append(float(loss))
    out["spmd"] = {"losses": spmd_losses, "params": numpy_tree(st.params)}

    # uneven feeds raise on every rank; the guard is not sticky
    t = _trainer(_model("dnn", spec["dnn"]), mesh, metrics=False)
    batches = local(spec["dnn_train"][:1]) * (3 if mesh.rank == 0 else 2)
    try:
        t.fit(lambda: batches, epochs=1, verbose=False)
        out["uneven"] = "no error"
    except RuntimeError as e:
        out["uneven"] = str(e)
    out["even_loss"] = t.fit(lambda: batches[:2], epochs=1,
                             verbose=False)[0]["loss"]
    t = _trainer(_model("dnn", spec["dnn"]), mesh, metrics=False,
                 cache_staged=True)
    try:
        t.fit(lambda: batches[:2], lambda: batches, epochs=2, verbose=False)
        out["uneven_val"] = "no error"
    except RuntimeError as e:
        out["uneven_val"] = str(e)

    # rank 0 writes the checkpoints; every rank restores them
    ckpt_dir = spec["ckpt_dir"]
    t = _trainer(_model("dnn", spec["dnn"]), mesh, metrics=False,
                 callbacks=[ModelCheckpoint(ckpt_dir)])
    t.fit(lambda: local(spec["dnn_train"][:2]), epochs=2, verbose=False)
    fresh = _trainer(_model("dnn", spec["dnn"]), mesh, metrics=False)
    fresh.restore(loop.ckpt_lib.get_best_checkpoint_path(ckpt_dir))
    out["ckpt"] = {"files": sorted(os.listdir(ckpt_dir)),
                   "epoch": fresh.initial_epoch,
                   "equal": all(torch.equal(fresh.state.params[k], v)
                                for k, v in t.state.params.items())}


def scenario_serving(spec, mesh, out):
    """psum_state, the differentiable all-reduce, fit_fused, the embedding
    extractor (a 1-rank sub-mesh too) and the classifiers."""
    from lidbox_tpu_torch import metrics as tmetrics
    from lidbox_tpu_torch import parallel, serve
    from lidbox_tpu_torch.data import steps
    from lidbox_tpu_torch.data.dataset import Dataset
    from lidbox_tpu_torch.models.model_utils import ModelWrapper

    cavg = tmetrics.SparseAverageDetectionCost(3, THRESHOLDS)
    labels, scores = spec["psum"][mesh.rank]
    state = cavg.update_sparse(cavg.init_state(), torch.as_tensor(labels),
                               torch.as_tensor(scores))
    out["psum"] = numpy_tree(cavg.psum_state(state, mesh))
    out["psum_by_name"] = numpy_tree(cavg.psum_state(state, "data"))

    x = torch.tensor([1.0 + mesh.rank], requires_grad=True)
    y = parallel.all_reduce_sum(x * x, mesh)
    (y * (1.0 + mesh.rank)).sum().backward()
    out["grad"] = float(x.grad)

    for name, cfg in spec["fused_configs"].items():
        wrapper = ModelWrapper.from_config(cfg, mesh=mesh, device="cpu")
        wrapper.model.module.load_state_dict(spec["fused_state"])
        h = wrapper.fit_fused(
            parallel.local_batches(spec["fused_train"], mesh), epochs=2,
            val_signal_batches=parallel.local_batches(spec["fused_val"],
                                                      mesh),
            verbose=False)
        out[f"fused_{name}"] = {
            "history": h, "checksums": _checksum(
                mesh, wrapper.trainer.state.params)}

    ext = spec["extractor"]
    fn = ModelWrapper.from_config_as_embedding_extractor_fn(
        ext, mesh=mesh, device="cpu")
    out["embed"] = fn(spec["embed_x"])
    elements = [{"id": f"e{i}", "input": x}
                for i, x in enumerate(spec["embed_x"])]
    for key, value in (("devices", 1), ("data_parallel", True)):
        ds = steps.extract_embeddings(Dataset.from_elements(elements), {
            "extractors": [ext], "batch_size": 4, key: value}, device="cpu")
        out[f"embed_{key}"] = np.stack([e["embedding"] for e in ds])

    model = _model("xvector", spec["serve_model"])
    logs = []  # the eager rule's messages of the classifiers' programs
    handler = logging.Handler()
    handler.emit = lambda record: logs.append(record.getMessage())
    graphs_logger = logging.getLogger("lidbox_tpu_torch.train.graphs")
    graphs_logger.addHandler(handler)
    try:
        clf = serve.Classifier(model, spec["labels"],
                               feature_config=spec["serve_features"],
                               batch_size=4, mesh=mesh, device="cpu")
        out["scores"] = clf.scores(spec["wavs"], ids=spec["wav_ids"])
        stream = serve.StreamingClassifier(
            model, spec["labels"], feature_config=spec["serve_features"],
            chunk_seconds=0.5, hop_seconds=0.25, mesh=mesh, device="cpu")
        stream.feed(spec["stream"])
    finally:
        graphs_logger.removeHandler(handler)
    out["stream"] = stream.scores()
    out["stream_on_mesh"] = stream._mesh_predict is not None
    out["eager_logs"] = logs


# -- tensor parallelism (tests/test_torch_tensor_parallel.py) -----------------

PRODUCT_OPS = ("linear", "conv1d", "conv2d", "lstm", "gru")


def record_products(fn):
    """(fn's result, [(op, weight shape)] of every Dense / Conv product
    and recurrent layer it runs): what a rank computes."""
    seen = []

    class Record(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            if name in PRODUCT_OPS:
                # a recurrent layer's flat weights: its longest list
                w = (max((a for a in args if isinstance(a, (list, tuple))),
                         key=len)[0]
                     if name in ("lstm", "gru") else args[1])
                seen.append((name, tuple(w.shape)))
            return func(*args, **(kwargs or {}))
    with Record():
        result = fn()
    return result, seen


def tp_trainer(model, mesh, optimizer=None, **kw):
    """A Trainer on the CPU, column-parallel over a 2-D ``mesh`` (None:
    mesh-less), Adam 5e-3 as tests/test_train.py:58 unless given."""
    from lidbox_tpu_torch import losses, parallel
    from lidbox_tpu_torch.train import loop, optimizers
    rule = None if mesh is None else parallel.column_parallel_rule(mesh)
    return loop.Trainer(model, optimizer or optimizers.adam(5e-3),
                        losses.nll_loss, mesh=mesh, param_sharding=rule,
                        device="cpu", **kw)


def tp_local(batches, mesh):
    from lidbox_tpu_torch import parallel
    return batches if mesh is None else [parallel.local_slice(b, mesh)
                                         for b in batches]


def tp_dnn(spec, mesh, epochs=2, exact=False, **kw):
    """The dnn of tests/test_train.py:181 for ``epochs`` over the toy
    batches: (trainer, epoch losses). ``exact`` takes Adam's epsilon to
    1e-4: at optax's 1e-8 the first updates are about lr * sign(g), and
    gradients near zero (the dead relu units) turn the column-parallel
    sums' float32 rounding into 1e-4 of loss within 3 steps."""
    from lidbox_tpu_torch.train import optimizers
    if exact:
        kw["optimizer"] = optimizers.adam(5e-3, eps=1e-4)
    t = tp_trainer(_model("dnn", spec["dnn"]), mesh, **kw)
    feed = tp_local(spec["dnn_train"], mesh)
    h = t.fit(lambda: feed, epochs=epochs, verbose=False,
              cache_shuffle=False)
    return t, [e["loss"] for e in h]


def tp_xvector(spec, mesh, augment):
    """A small x-vector (channel dropout with ``augment``) through
    fit_signals with ``stft_method: "pallas"`` (the kernel's wrapper; its
    plain version on the CPU), SpecAugment with ``augment``: (trainer,
    history)."""
    from lidbox_tpu_torch.data import on_device
    from lidbox_tpu_torch.train import optimizers
    import lidbox_tpu_torch.models as tmodels
    model = tmodels.create("xvector", spec["xv_shape"], spec["outputs"],
                           channel_dropout_rate=0.3 if augment else 0.0,
                           device="cpu")
    model.module.load_state_dict(spec["xvector"]["state"])
    t = tp_trainer(model, mesh, optimizer=optimizers.adam(1e-3, eps=1e-4))
    fn = on_device.make_augmented_feature_fn(
        spec["rate"], spec["xv_features"], on_device.AugmentConfig(
            snr_range=None, specaug_time_masks=2 if augment else 0,
            specaug_time_width=5, specaug_freq_masks=2 if augment else 0,
            specaug_freq_width=4))
    h = on_device.fit_signals(t, fn, tp_local(spec["xv_train"], mesh),
                              epochs=2, verbose=False,
                              val_batches=tp_local(spec["xv_val"], mesh))
    return t, h


def tp_remat(spec, mesh, remat):
    """The x-vector with channel dropout 0.5 for 3 one-batch epochs of
    feature batches, its forward recomputed in the backward with
    ``remat``: the step losses."""
    from lidbox_tpu_torch.train import optimizers
    import lidbox_tpu_torch.models as tmodels
    model = tmodels.create("xvector", spec["xv_shape"], spec["outputs"],
                           channel_dropout_rate=0.5, device="cpu")
    model.module.load_state_dict(spec["xvector"]["state"])
    t = tp_trainer(model, mesh, optimizer=optimizers.adam(1e-3, eps=1e-4))
    t.remat = remat
    h = t.fit(one_per_epoch(tp_local(spec["remat_train"], mesh)), epochs=3,
              verbose=False)
    return [e["loss"] for e in h]


def tp_crnn(spec, mesh):
    """crnn (Conv2d + BatchNorm + the bidirectional LSTM, which gathers
    its split weights) for 3 one-batch epochs with validation: (trainer,
    history)."""
    from lidbox_tpu_torch.train.optimizers import optimizer_from_config
    t = tp_trainer(_model("crnn", spec["crnn"]), mesh,
                   optimizer=optimizer_from_config(ADAM)[0])
    h = t.fit(one_per_epoch(tp_local(spec["crnn_train"], mesh)),
              lambda: tp_local(spec["crnn_val"], mesh), epochs=3,
              verbose=False)
    return t, h


def _tp_summary(trainer, batch):
    """A TP trainer's split parameters (names, shard shapes), its gathered
    full parameters and batch statistics, the products of one eval
    forward on ``batch`` and a digest of the model's synced weights on
    every rank."""
    from lidbox_tpu_torch import parallel
    state = trainer.checkpoint_state()
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    _, products = record_products(lambda: trainer._apply(
        trainer.state.params, trainer.state.batch_stats, batch, train=False))
    synced = {k: v.detach() for k, v in
              trainer.model.module.state_dict().items()}
    return {"specs": dict(trainer.param_specs),
            "shards": {k: tuple(trainer.state.params[k].shape)
                       for k in trainer.param_specs},
            "full": numpy_tree({**state.params, **state.batch_stats}),
            "products": products,
            "synced": _checksum(trainer.mesh, synced).tolist(),
            "synced_equal": all(torch.equal(synced[k], v) for k, v in
                                {**state.params,
                                 **state.batch_stats}.items())}


def scenario_tensor_parallel(spec, world, out):
    """1 x 2 (data, model): the dnn (shards before and after fit, the
    products, cached replay, restore), the x-vector through fit_signals
    and with ``remat``, crnn and clip_by_global_norm."""
    from lidbox_tpu_torch import parallel
    from lidbox_tpu_torch.train import ModelCheckpoint, loop, optimizers
    mesh = parallel.get_mesh_2d(data_size=1, model_size=2, device="cpu")
    out["coords"] = (mesh.data_index, mesh.model_index)

    t = tp_trainer(_model("dnn", spec["dnn"]), mesh)
    t.create_state()
    before = {k: tuple(t.state.params[k].shape) for k in t.param_specs}
    moments = {k: tuple(v.shape) for k, v in zip(
        t.state.params, t.state.opt_state[0]["mu"])}
    ckpt_dir = os.path.join(spec["tmp"], "tp_ckpt")
    orbax_dir = os.path.join(spec["tmp"], "tp_orbax")
    t, losses = tp_dnn(spec, mesh, callbacks=[
        ModelCheckpoint(ckpt_dir), ModelCheckpoint(orbax_dir,
                                                   backend="orbax")])
    out["dnn"] = dict(_tp_summary(t, spec["dnn_train"][0]), losses=losses,
                      exact=tp_dnn(spec, mesh, exact=True)[1],
                      before=before, moments=moments)
    # rank 0 writes the gathered state, in the mesh-less format, with
    # either backend
    for key, path in (("ckpt", ckpt_dir), ("orbax", orbax_dir)):
        out["dnn"][key] = numpy_tree(loop.ckpt_lib.load_raw_checkpoint(
            loop.ckpt_lib.get_best_checkpoint_path(path))["params"])

    # cached replay against streaming
    replay = {}
    for cache in (True, False):
        t, losses = tp_dnn(spec, mesh, epochs=3, cache_staged=cache)
        replay[cache] = {"losses": losses, "full": numpy_tree(
            t.checkpoint_state().params)}
    out["replay"] = replay

    # a mesh-less checkpoint restored into the sharded trainer
    t = tp_trainer(_model("dnn", spec["dnn"]), mesh)
    t.restore(spec["ckpt"])
    out["restore"] = {
        "epoch": t.initial_epoch,
        "shards": {k: tuple(t.state.params[k].shape) for k in t.param_specs},
        "full": numpy_tree(t.checkpoint_state().params),
        "opt": numpy_tree(t.checkpoint_state().opt_state),
        "losses": [e["loss"] for e in t.fit(
            lambda: tp_local(spec["dnn_train"], mesh), epochs=3,
            verbose=False)]}

    for name, augment in (("xvector", True), ("xvector_clean", False)):
        t, h = tp_xvector(spec, mesh, augment)
        out[name] = dict(_tp_summary(t, {"input": spec["xv_feats"]}),
                         history=h)

    t, h = tp_crnn(spec, mesh)
    out["crnn"] = dict(_tp_summary(t, spec["crnn_train"][0]), history=h)

    # remat re-enters the mesh scopes for the recompute
    out["remat"] = {remat: tp_remat(spec, mesh, remat)
                    for remat in (False, True)}

    grads = {k: torch.as_tensor(v) for k, v in spec["clip_grads"].items()}
    shards, specs = parallel.shard_params(grads, mesh)
    with parallel.tensor_parallel(mesh, specs):
        clipped, _ = optimizers.clip_by_global_norm(1.0).update(shards, {})
    out["clip"] = {k: parallel.unshard(v, specs[k], mesh).numpy()
                   if k in specs else v.numpy() for k, v in clipped.items()}


def scenario_tensor_parallel_2x2(spec, world, out):
    """2 x 2 (data, model): the dnn; the ranks of one data row feed the
    same rows."""
    from lidbox_tpu_torch import parallel
    mesh = parallel.get_mesh_2d(data_size=2, model_size=2, device="cpu")
    out["coords"] = (mesh.data_index, mesh.model_index)
    out["rows"] = tp_local(spec["dnn_train"][:1], mesh)[0]["target"]
    t, losses = tp_dnn(spec, mesh)
    out["dnn"] = dict(_tp_summary(t, spec["dnn_train"][0]), losses=losses,
                      exact=tp_dnn(spec, mesh, exact=True)[1])


def _step_grads(key, kw, shape, batch, mesh, compute_dtype=None):
    """The first train step of ``key`` (weights from seed 3) on ``batch``:
    (loss, gradients gathered whole in float64, split names, the forward's
    products)."""
    from lidbox_tpu_torch import losses, parallel
    import lidbox_tpu_torch.models as tmodels
    from lidbox_tpu_torch.train import loop, optimizers
    model = tmodels.create(key, shape, 3, device="cpu", **kw)
    model.init(torch.Generator().manual_seed(3))
    rule = None if mesh is None else parallel.column_parallel_rule(mesh)
    t = loop.Trainer(model, optimizers.adam(1e-3, eps=1e-4),
                     losses.nll_loss, mesh=mesh, param_sharding=rule,
                     compute_dtype=compute_dtype, device="cpu")
    state = t.create_state()
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    (loss, grads, _), products = record_products(
        lambda: t._loss_and_grads(state, batch, t.generator))
    grads = {k: (parallel.unshard(g, t.param_specs[k], mesh)
                 if k in t.param_specs else g).double().numpy()
             for k, g in grads.items()}
    return float(loss), grads, sorted(t.param_specs), products


def scenario_tensor_parallel_zoo(spec, world, out):
    """Every model configuration's first train step in float64 on a 1 x 2
    mesh and mesh-less: the losses, the gradients' distance (|tp - ref| /
    |ref| over all of them), the split names, the TP forward's products
    and the parameters' full shapes."""
    from lidbox_tpu_torch import parallel
    mesh = parallel.get_mesh_2d(data_size=1, model_size=2, device="cpu")
    for name, key, kw in spec["zoo"]:
        tp_loss, tp, split, products = _step_grads(
            key, kw, spec["shape"], spec["batch"], mesh, torch.float64)
        loss, ref = _step_grads(key, kw, spec["shape"], spec["batch"], None,
                                torch.float64)[:2]
        num = sum(float(((tp[k] - ref[k]) ** 2).sum()) for k in ref)
        den = sum(float((v ** 2).sum()) for v in ref.values())
        out[name] = {"losses": (tp_loss, loss),
                     "distance": float(np.sqrt(num / den)), "split": split,
                     "products": products,
                     "full": {k: v.shape for k, v in ref.items()}}


def main(scenario, tmp_path):
    from lidbox_tpu_torch import parallel
    torch.set_num_threads(2)
    assert parallel.initialize_distributed(device="cpu",
                                           timeout=COLLECTIVE_TIMEOUT_S)
    mesh = parallel.get_mesh()
    spec = torch.load(os.path.join(tmp_path, "spec.pt"), weights_only=False)
    out = {}
    with memoized():
        globals()[f"scenario_{scenario}"](spec, mesh, out)
    torch.save(out, os.path.join(tmp_path, f"rank{mesh.rank}.pt"))
    parallel.shutdown_distributed()


if __name__ == "__main__":
    main(*sys.argv[1:])
