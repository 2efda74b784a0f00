"""
Data-parallel training in the port against the JAX package's mesh Trainer,
on the CPU.

Two ranks of the port (subprocesses over gloo, ``torch_parallel_common``)
each feed their rows of every global batch (``parallel.local_slice``);
the reference is the JAX ``Trainer`` with ``mesh=parallel.get_mesh(
num_devices=2)`` over two of conftest's virtual CPU devices, fed the global
batches, from the same weights (the x-vector's and the dnn's JAX init
through ``params_from_flax``, crnn's seeded port init with its batch
statistics moved, through ``params_to_flax``). Held:

- the full-width x-vector, b4 x 48 frames x 24 mel, Adam, 3 steps: step
  losses within rtol 1e-4, the parameters after one step within atol 1e-6
  + rtol 1e-5, evaluate() with an example mask (val_loss within 1e-5,
  C_avg within 1e-6) and predict() (tests/test_train.py:144, :334);
- ``steps_per_dispatch: 2`` + ``cache_staged`` with each ``cache_shuffle``
  (True, "rows", False) on the dnn, 4 batches of 8 and a ragged tail of 5,
  3 epochs: losses within rtol 1e-4 (tests/test_train.py:948-1087);
- crnn (BatchNorm on the global batch's statistics), b4 x 64 x 32, 3
  steps with validation: losses, the parameters and the batch statistics
  against the JAX mesh run and against the port's single process at the
  global batch (rtol 1e-4 + atol 1e-5, the zoo tests' budget);
- the replicas' parameters and batch statistics bit-equal across ranks
  after every run (a float64 checksum per rank);
- ``parallel.spmd.make_shard_map_train_step`` against the JAX one on the
  deterministic dnn;
- an uneven feed raises on both ranks, for training and for cached
  validation (tests/test_multihost.py:472); rank 0 alone writes the
  checkpoints, every rank restores them.
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import lidbox_tpu.models as jmodels
from lidbox_tpu import RANDOM_SEED
from lidbox_tpu import losses as jlosses
from lidbox_tpu import metrics as jmetrics
from lidbox_tpu import parallel as jparallel
from lidbox_tpu.models.model_utils import ModelWrapper as JWrapper
from lidbox_tpu.parallel import spmd as jspmd
from lidbox_tpu.train import loop as jloop
from lidbox_tpu.train import optimizers as jopt
from lidbox_tpu_torch.models.model_api import params_from_flax
from lidbox_tpu_torch.models.model_utils import ModelWrapper as TWrapper
from torch_parallel_common import (ADAM, THRESHOLDS, finish_ranks,
                                   one_per_epoch, start_ranks)
from torch_zoo_common import ATOL, RTOL, flax_variables, port_model

torch.set_num_threads(2)

B, T, FEAT, N = 4, 48, 24, 5
DNN_T, DNN_F = 20, 8
CRNN_T, CRNN_F = 64, 32


def feature_batches(n, seed, b=B, frames=T, feat=FEAT, mask=False):
    """Class-separable features: class k has mean +1 in channels 4k..4k+3."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = rng.integers(0, N, b).astype(np.int32)
        x = rng.normal(0, 1, (b, frames, feat)).astype(np.float32)
        for i, k in enumerate(y):
            x[i, :, 4 * k:4 * k + 4] += 1.0
        batch = {"input": x, "target": y}
        if mask:
            batch["example_mask"] = np.arange(b) % 3 != 2
        out.append(batch)
    return out


def crnn_config(root):
    return {"experiment": {
        "cache_directory": str(root), "name": "crnn",
        "input_shape": [CRNN_T, CRNN_F], "output_shape": [N],
        "model": {"key": "crnn"},
        "optimizer": ADAM,
        "loss": {"cls": "SparseCategoricalCrossentropy"},
        "callbacks": [{"cls": "ModelCheckpoint",
                       "kwargs": {"monitor": "val_loss", "mode": "min"}}]}}


def state_numpy(trainer):
    tree = jax.device_get({"params": trainer.state.params,
                           "batch_stats": trainer.state.batch_stats})
    out = params_from_flax(tree["params"])
    out.update(params_from_flax(tree["batch_stats"]))
    return {k: np.asarray(v) for k, v in out.items()}


def jax_trainer(model, mesh, metrics=True, **kw):
    optimizer, _ = jopt.optimizer_from_config(ADAM)
    m = ({"C_avg": jmetrics.SparseAverageDetectionCost(N, THRESHOLDS)}
         if metrics else {})
    return jloop.Trainer(model, optimizer, jlosses.nll_loss, metrics=m,
                         mesh=mesh, **kw)


def jax_model(key, shape, seed):
    """The JAX model with its ``init(PRNGKey(seed))`` weights, traced once
    (the same values; the eager init of the full-width x-vector takes
    twice as long)."""
    jm = jmodels.create(key, shape, N)
    dummy = jnp.zeros((1,) + shape, jnp.float32)
    jm.variables = jax.jit(lambda r: jm.module.init(
        {"params": r, "dropout": r, "noise": r}, dummy, train=False,
        **jm.apply_kwargs))(jax.random.PRNGKey(seed))
    return jm


def spec_model(shape, variables):
    return {"shape": shape, "outputs": N,
            "state": params_from_flax(jax.device_get(variables))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results (started first, so the JAX references compute
    while the ranks run) and the references."""
    root = tmp_path_factory.mktemp("parallel_train")
    jmesh = jparallel.get_mesh(num_devices=2)
    jxv = jax_model("xvector", (T, FEAT), RANDOM_SEED)
    jdnn = jax_model("dnn", (DNN_T, DNN_F), 0)
    crnn = port_model("crnn", (CRNN_T, CRNN_F), N, {}, seed=11)
    spec = {
        "xvector": spec_model((T, FEAT), jxv.variables["params"]),
        "xv_train": feature_batches(3, seed=0),
        "xv_val": feature_batches(2, seed=1, mask=True),
        "dnn": spec_model((DNN_T, DNN_F), jdnn.variables["params"]),
        "dnn_train": feature_batches(4, 2, 8, DNN_T, DNN_F) + [
            {k: v[:5] for k, v in feature_batches(1, 3, 8, DNN_T,
                                                  DNN_F)[0].items()}],
        "crnn": {"state": {k: v.detach().clone() for k, v in
                           crnn.module.state_dict().items()}},
        "crnn_config": crnn_config(root / "port"),
        "crnn_train": feature_batches(3, 4, B, CRNN_T, CRNN_F),
        "crnn_val": feature_batches(1, 5, B, CRNN_T, CRNN_F),
        "ckpt_dir": str(root / "ckpts"),
    }
    handle = start_ranks("trainer", spec, root)
    ref = {}
    try:
        # the x-vector (tests/test_torch_train.py's sequence)
        t = jax_trainer(jxv, jmesh)
        h = t.fit(one_per_epoch(spec["xv_train"][:1]), epochs=1,
                  verbose=False)
        params1 = params_from_flax(jax.device_get(t.state.params))
        h += t.fit(one_per_epoch(spec["xv_train"][1:]), epochs=2,
                   verbose=False)
        ref["xv"] = {"losses": [e["loss"] for e in h],
                     "params1": {k: v.numpy() for k, v in params1.items()},
                     "eval": t.evaluate(lambda: spec["xv_val"]),
                     "predict": t.predict(lambda: spec["xv_val"])}
        for shuffle in (True, "rows", False):
            jm = jmodels.create("dnn", (DNN_T, DNN_F), N)
            jm.variables = jdnn.variables
            t = jax_trainer(jm, jmesh, metrics=False, cache_staged=True)
            h = t.fit(lambda: spec["dnn_train"], epochs=3,
                      steps_per_dispatch=2, cache_shuffle=shuffle,
                      verbose=False)
            ref[f"feed_{shuffle}"] = [e["loss"] for e in h]
        # crnn: the JAX mesh run and the port's single process
        jw = JWrapper.from_config(crnn_config(root / "jax"), mesh=jmesh)
        jw.model.variables = flax_variables(crnn)
        tw = TWrapper.from_config(crnn_config(root / "single"), device="cpu")
        tw.model.module.load_state_dict(spec["crnn"]["state"])
        for name, w in (("crnn_jax", jw), ("crnn_single", tw)):
            h = w.fit(one_per_epoch(spec["crnn_train"]),
                      lambda: spec["crnn_val"], epochs=3, verbose=False)
            ref[name] = {"losses": [e["loss"] for e in h],
                         "val_loss": [e["val_loss"] for e in h],
                         "state": (state_numpy(w.trainer) if w is jw else {
                             k: v.numpy() for k, v in
                             {**w.trainer.state.params,
                              **w.trainer.state.batch_stats}.items()})}
        # the explicit-collective step
        optimizer, _ = jopt.optimizer_from_config(ADAM)
        step = jspmd.make_shard_map_train_step(jdnn, optimizer,
                                               jlosses.nll_loss, jmesh)
        t = jax_trainer(jdnn, jmesh, metrics=False)
        state = t.create_state()
        spmd_losses = []
        for b in spec["dnn_train"][:2]:
            state, loss = step(state, {"input": b["input"],
                                       "target": b["target"]},
                               jax.random.PRNGKey(0))
            spmd_losses.append(float(loss))
        ref["spmd"] = {"losses": spmd_losses, "params": {
            k: v.numpy() for k, v in params_from_flax(
                jax.device_get(state.params)).items()}}
    finally:
        ranks = finish_ranks(handle)
    return ranks, ref


def test_fit_losses_match_jax_mesh(runs):
    ranks, ref = runs
    for out in ranks:
        assert len(out["xv"]["losses"]) == 3
        np.testing.assert_allclose(out["xv"]["losses"], ref["xv"]["losses"],
                                   rtol=1e-4)


def test_params_after_one_step_match_jax_mesh(runs):
    ranks, ref = runs
    expected = ref["xv"]["params1"]
    for out in ranks:
        assert set(out["xv"]["params1"]) == set(expected)
        for k, v in expected.items():
            np.testing.assert_allclose(out["xv"]["params1"][k], v, atol=1e-6,
                                       rtol=1e-5, err_msg=k)


def test_evaluate_and_predict_match_jax_mesh(runs):
    ranks, ref = runs
    for out in ranks:
        ours, theirs = out["xv"]["eval"], ref["xv"]["eval"]
        np.testing.assert_allclose(ours["val_loss"], theirs["val_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(ours["val_C_avg"], theirs["val_C_avg"],
                                   atol=1e-6)
        assert out["xv"]["predict"].shape == (2 * B, N)
        np.testing.assert_allclose(out["xv"]["predict"],
                                   np.asarray(ref["xv"]["predict"]),
                                   atol=1e-5, rtol=1e-5)


def test_replicas_stay_bit_equal(runs):
    ranks, _ = runs
    sums = [ranks[0]["xv"]["checksums"], ranks[0]["crnn"]["checksums"],
            ranks[0]["crnn"]["bn_checksums"]] + [
        ranks[0][f"feed_{s}"]["checksums"] for s in (True, "rows", False)]
    for s in sums:
        assert s.shape == (2,) and s[0] == s[1], s
    for k, v in ranks[0]["crnn"]["state"].items():
        np.testing.assert_array_equal(v, ranks[1]["crnn"]["state"][k],
                                      err_msg=k)


@pytest.mark.parametrize("shuffle", [True, "rows", False])
def test_feed_options_match_jax_mesh(runs, shuffle):
    ranks, ref = runs
    for out in ranks:
        run = out[f"feed_{shuffle}"]
        assert run["step"] == 15
        np.testing.assert_allclose(run["losses"], ref[f"feed_{shuffle}"],
                                   rtol=1e-4)


def test_batch_norm_takes_global_statistics(runs):
    ranks, ref = runs
    stats = [k for k in ref["crnn_jax"]["state"]
             if k.endswith((".mean", ".var"))]
    assert stats
    for out in ranks:
        ours = out["crnn"]
        for side in ("crnn_jax", "crnn_single"):
            np.testing.assert_allclose(ours["losses"], ref[side]["losses"],
                                       rtol=RTOL)
            np.testing.assert_allclose(ours["val_loss"],
                                       ref[side]["val_loss"], rtol=RTOL)
            assert set(ours["state"]) == set(ref[side]["state"])
            for k, v in ref[side]["state"].items():
                np.testing.assert_allclose(ours["state"][k], v, rtol=RTOL,
                                           atol=ATOL, err_msg=f"{side} {k}")


def test_shard_map_step_matches_jax(runs):
    ranks, ref = runs
    for out in ranks:
        np.testing.assert_allclose(out["spmd"]["losses"],
                                   ref["spmd"]["losses"], rtol=1e-5)
        for k, v in ref["spmd"]["params"].items():
            np.testing.assert_allclose(out["spmd"]["params"][k], v,
                                       atol=1e-6, rtol=1e-5, err_msg=k)


def test_uneven_feed_raises_on_every_rank(runs):
    ranks, _ = runs
    for out in ranks:
        assert "uneven multi-process training feed" in out["uneven"]
        assert "after 2 batches" in out["uneven"]
        assert "rank(s) 1 ran out" in out["uneven"]
        assert np.isfinite(out["even_loss"])
        assert "uneven multi-process validation feed" in out["uneven_val"]
    assert ranks[0]["even_loss"] == ranks[1]["even_loss"]


def test_checkpoints_written_once_and_restored(runs):
    ranks, _ = runs
    for out in ranks:
        files = out["ckpt"]["files"]
        assert len(files) == 2 and all(f.endswith(".ckpt") for f in files)
        assert out["ckpt"]["epoch"] == 2 and out["ckpt"]["equal"]
