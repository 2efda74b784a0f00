"""
Ranks of the port's data-parallel tests (tests/test_torch_parallel*.py).

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
import os
import subprocess
import sys

import numpy as np
import torch

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
    clf = serve.Classifier(model, spec["labels"],
                           feature_config=spec["serve_features"],
                           batch_size=4, mesh=mesh, device="cpu")
    out["scores"] = clf.scores(spec["wavs"], ids=spec["wav_ids"])
    stream = serve.StreamingClassifier(
        model, spec["labels"], feature_config=spec["serve_features"],
        chunk_seconds=0.5, hop_seconds=0.25, mesh=mesh, device="cpu")
    stream.feed(spec["stream"])
    out["stream"] = stream.scores()


def main(scenario, tmp_path):
    from lidbox_tpu_torch import parallel
    torch.set_num_threads(2)
    assert parallel.initialize_distributed(device="cpu",
                                           timeout=COLLECTIVE_TIMEOUT_S)
    mesh = parallel.get_mesh()
    spec = torch.load(os.path.join(tmp_path, "spec.pt"), weights_only=False)
    out = {}
    globals()[f"scenario_{scenario}"](spec, mesh, out)
    torch.save(out, os.path.join(tmp_path, f"rank{mesh.rank}.pt"))
    parallel.shutdown_distributed()


if __name__ == "__main__":
    main(*sys.argv[1:])
