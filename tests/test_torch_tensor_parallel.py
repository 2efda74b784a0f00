"""
Tensor parallelism in the port against the JAX package's 2-D mesh
Trainer, on the CPU.

The ranks of the port are subprocesses over gloo (``torch_parallel_
common``): two as a 1 x 2 (data, model) mesh, four as 2 x 2, each with
``param_sharding=parallel.column_parallel_rule(mesh)``. The references are
the JAX ``Trainer`` on ``parallel.get_mesh_2d`` over conftest's virtual
CPU devices with the JAX rule (tests/test_train.py:181, :215, :1115), from
the same weights, and the port's mesh-less run of the same code. Held:

- the dnn of tests/test_train.py:181 (Adam 5e-3, 6 toy batches of 16, 2
  epochs) on 1 x 2 and on 2 x 2: first-epoch loss within rtol 1e-4 and
  last within 1e-3 of the JAX 2-D mesh (the JAX test's tolerances), and,
  with Adam's epsilon at 1e-4 (``tp_dnn(exact=True)``: optax's 1e-8 turns
  float32 rounding of near-zero gradients into 1e-4 of loss), within
  rtol 1e-5 of the port's mesh-less run;
- the split parameters' names equal the JAX rule's ``PartitionSpec``s
  (dnn, x-vector, crnn), mapped through ``params_from_flax`` names; each
  rank holds half of each split weight before and after training, and
  its Dense and non-grouped Conv products run on those halves (the
  recurrent layer on gathered weights);
- ``restore`` of a mesh-less checkpoint re-splits it, its gathered
  parameters and moments equal to the file's; the checkpoints the sharded
  trainer writes hold the gathered state in the mesh-less format (an
  Orbax directory holds the same);
- cached replay equal to streaming (rtol 1e-6, tests/test_train.py:1115);
- ``sync_model_variables`` leaves bit-identical full weights on every
  rank, equal to the gathered state;
- a small x-vector through ``fit_signals`` (the kernel's wrapper, its
  plain version here): with SpecAugment and channel dropout against the
  port's mesh-less run (rtol 1e-5; the draws are the same), and clean
  against the JAX ``fit_signals`` on the 2-D mesh;
- ``remat`` on 1 x 2: the x-vector with channel dropout 0.5 for 3 steps,
  step losses equal to the plain run's in float32;
- crnn (Conv2d, BatchNorm, the bidirectional LSTM on the weight-gather
  route), 3 steps with validation: losses against the JAX 2-D mesh and
  the mesh-less port, parameters and batch statistics within rtol 1e-4 +
  atol 1e-5 of the JAX run (the zoo tests' budget);
- ``clip_by_global_norm`` on split gradients equal to optax's on the
  whole ones (rtol 1e-6).
"""
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import lidbox_tpu.models as jmodels
from lidbox_tpu import losses as jlosses
from lidbox_tpu import parallel as jparallel
from lidbox_tpu.data import on_device as jon_device
from lidbox_tpu.train import loop as jloop
from lidbox_tpu.train import optimizers as jopt
from lidbox_tpu_torch import parallel
from lidbox_tpu_torch.models.model_api import params_from_flax
from lidbox_tpu_torch.train import ModelCheckpoint
from torch_parallel_common import (ADAM, finish_ranks, numpy_tree,
                                   one_per_epoch, start_ranks, tp_crnn,
                                   tp_dnn, tp_xvector)
from torch_zoo_common import ATOL, RTOL, flax_variables, port_model

torch.set_num_threads(2)

N = 3
T, F = 24, 8  # tests/test_train.py's toy task
RATE, XV_SAMPLES, XV_MELS = 16000, 8000, 24
XV_FRAMES = 1 + (XV_SAMPLES - 400) // 160
CRNN_T, CRNN_F = 64, 32
XV_FEATURES = {"type": "logmelspectrogram", "stft_method": "pallas",
               "melspectrogram": {"num_mel_bins": XV_MELS}}


def toy_batches(n_batches=6, batch=16, seed=0):
    """tests/test_train.py's separable toy task: class k has mean 2 in
    channel k."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        y = rng.integers(0, N, batch)
        x = rng.normal(0, 1, (batch, T, F)).astype(np.float32)
        for i, k in enumerate(y):
            x[i, :, k] += 2.0
        out.append({"input": x, "target": y.astype(np.int32)})
    return out


def class_sines(n, seed, batch=4):
    """(signals [batch, XV_SAMPLES], targets) pairs: class k a noisy sine
    at 300 (k + 1) Hz."""
    rng = np.random.default_rng(seed)
    t = np.arange(XV_SAMPLES) / RATE
    out = []
    for _ in range(n):
        y = rng.integers(0, N, batch)
        x = np.stack([0.3 * np.sin(2 * np.pi * 300 * (k + 1) * t)
                      + rng.normal(0, 0.05, XV_SAMPLES) for k in y])
        out.append((x.astype(np.float32), y.astype(np.int32)))
    return out


def feature_batches(n, seed, shape, batch=4):
    rng = np.random.default_rng(seed)
    return [{"input": rng.normal(0, 1, (batch,) + shape).astype(np.float32),
             "target": rng.integers(0, N, batch).astype(np.int32)}
            for _ in range(n)]


def jax_model(key, shape, seed, **kw):
    """The JAX model with its jitted ``init(PRNGKey(seed))`` weights."""
    jm = jmodels.create(key, shape, N, **kw)
    dummy = jnp.zeros((1,) + shape, jnp.float32)
    jm.variables = jax.jit(lambda r: jm.module.init(
        {"params": r, "dropout": r, "noise": r}, dummy, train=False,
        **jm.apply_kwargs))(jax.random.PRNGKey(seed))
    return jm


def port_state(variables):
    return {"shape": None, "outputs": N,
            "state": params_from_flax(jax.device_get(variables))}


def jax_rule_names(key, shape):
    """The port names of the parameters the JAX column-parallel rule
    splits over a (1, 2) mesh (``jax.eval_shape`` of the JAX init)."""
    jm = jmodels.create(key, shape, N)
    rng = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.module.init(
        {"params": rng, "dropout": rng, "noise": rng},
        jnp.zeros((1,) + shape, jnp.float32), train=False))["params"]
    rule = jparallel.column_parallel_rule(
        jparallel.get_mesh_2d(data_size=1, model_size=2))
    names = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        if jparallel.MODEL_AXIS in rule(path, leaf).spec:
            keys = [p.key for p in path]
            names.add(".".join(keys[:-1] + ["weight"]))
    return names


def jax_history(trainer, **fit):
    return [dict(e) for e in trainer.fit(verbose=False, **fit)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results (started first, so the references compute while
    the ranks run) and the references."""
    root = tmp_path_factory.mktemp("tensor_parallel")
    jdnn = jax_model("dnn", (T, F), 0)
    jxv = jax_model("xvector", (XV_FRAMES, XV_MELS), 3)
    crnn = port_model("crnn", (CRNN_T, CRNN_F), N, {}, seed=11)
    rng = np.random.default_rng(7)
    spec = {
        "tmp": str(root), "rate": RATE, "outputs": N,
        "dnn": dict(port_state(jdnn.variables["params"]), shape=(T, F)),
        "dnn_train": toy_batches(),
        "xvector": port_state(jxv.variables["params"]),
        "xv_shape": (XV_FRAMES, XV_MELS), "xv_features": XV_FEATURES,
        "xv_train": class_sines(2, 1), "xv_val": class_sines(1, 2),
        "xv_feats": feature_batches(1, 4, (XV_FRAMES, XV_MELS))[0]["input"],
        "crnn": {"shape": (CRNN_T, CRNN_F), "outputs": N,
                 "state": {k: v.detach().clone() for k, v in
                           crnn.module.state_dict().items()}},
        "remat_train": feature_batches(3, 8, (XV_FRAMES, XV_MELS)),
        "crnn_train": feature_batches(3, 5, (CRNN_T, CRNN_F)),
        "crnn_val": feature_batches(1, 6, (CRNN_T, CRNN_F)),
        "clip_grads": {k: rng.normal(0, 10, v.shape).astype(np.float32)
                       for k, v in params_from_flax(jax.device_get(
                           jdnn.variables["params"])).items()},
    }
    # the mesh-less checkpoint the sharded trainer restores
    ckpt_dir = str(root / "meshless_ckpt")
    _, ckpt_losses = tp_dnn(spec, None, epochs=1,
                            callbacks=[ModelCheckpoint(ckpt_dir)])
    spec["ckpt"] = os.path.join(ckpt_dir, os.listdir(ckpt_dir)[0])
    for sub in ("r12", "r22"):
        (root / sub).mkdir()
    handle = start_ranks("tensor_parallel", spec, root / "r12")
    spec4 = {k: spec[k] for k in ("dnn", "dnn_train")}
    handle4 = start_ranks("tensor_parallel_2x2", spec4, root / "r22",
                          world=4)
    try:
        ref = {"spec": spec, "ckpt_losses": ckpt_losses}
        for shape in ((1, 2), (2, 2)):
            mesh = jparallel.get_mesh_2d(*shape)
            jm = jmodels.create("dnn", (T, F), N)
            jm.variables = jdnn.variables
            ref[f"jax_dnn{shape}"] = [e["loss"] for e in jax_history(
                jloop.Trainer(jm, optax.adam(5e-3), jlosses.nll_loss,
                              mesh=mesh, param_sharding=jparallel
                              .column_parallel_rule(mesh)),
                train_batches=lambda: spec["dnn_train"], epochs=2)]
        mesh = jparallel.get_mesh_2d(1, 2)
        rule = jparallel.column_parallel_rule(mesh)
        jc = jmodels.create("crnn", (CRNN_T, CRNN_F), N)
        jc.variables = flax_variables(crnn)
        tc = jloop.Trainer(jc, jopt.optimizer_from_config(ADAM)[0],
                           jlosses.nll_loss, mesh=mesh, param_sharding=rule)
        ref["jax_crnn"] = jax_history(
            tc, train_batches=one_per_epoch(spec["crnn_train"]),
            validation_batches=lambda: spec["crnn_val"], epochs=3)
        tree = jax.device_get({"params": tc.state.params,
                               "batch_stats": tc.state.batch_stats})
        ref["jax_crnn_state"] = {
            k: np.asarray(v) for k, v in {
                **params_from_flax(tree["params"]),
                **params_from_flax(tree["batch_stats"])}.items()}
        jxv_clean = jmodels.create("xvector", (XV_FRAMES, XV_MELS), N)
        jxv_clean.variables = jxv.variables
        tx = jloop.Trainer(jxv_clean, optax.adam(1e-3, eps=1e-4),
                           jlosses.nll_loss, mesh=mesh, param_sharding=rule)
        ref["jax_xvector_clean"] = jon_device.fit_signals(
            tx, jon_device.make_augmented_feature_fn(
                RATE, dict(XV_FEATURES, stft_method="matmul"),
                jon_device.AugmentConfig(snr_range=None)),
            spec["xv_train"], epochs=2, verbose=False,
            val_batches=spec["xv_val"])
        ref["jax_names"] = {
            "dnn": jax_rule_names("dnn", (T, F)),
            "xvector": jax_rule_names("xvector", (XV_FRAMES, XV_MELS)),
            "crnn": jax_rule_names("crnn", (CRNN_T, CRNN_F))}
        ref["dnn"] = tp_dnn(spec, None, exact=True)[1]
        ref["xvector"] = tp_xvector(spec, None, True)[1]
        t, h = tp_crnn(spec, None)
        ref["crnn"], ref["crnn_state"] = h, numpy_tree(
            {**t.state.params, **t.state.batch_stats})
        ref["clip"] = optax.clip_by_global_norm(1.0).update(
            spec["clip_grads"], optax.EmptyState())[0]
    finally:
        ranks = finish_ranks(handle)
        ranks4 = finish_ranks(handle4)
    return ranks, ranks4, ref


def losses_of(history):
    return [e["loss"] if isinstance(e, dict) else e for e in history]


def assert_trajectory(ours, jax_losses, meshless, exact=None):
    """First and last losses against the JAX run (rtol 1e-4, 1e-3), all
    against the mesh-less port (rtol 1e-5; ``exact`` the run to compare
    when it is another)."""
    np.testing.assert_allclose(ours[0], jax_losses[0], rtol=1e-4)
    np.testing.assert_allclose(ours[-1], jax_losses[-1], rtol=1e-3)
    np.testing.assert_allclose(ours if exact is None else exact, meshless,
                               rtol=1e-5)


def test_mesh_coordinates(runs):
    ranks, ranks4, _ = runs
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1)]
    assert [r["coords"] for r in ranks4] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    # the ranks of one data row take the same rows, the rows split by row
    rows = [r["rows"] for r in ranks4]
    np.testing.assert_array_equal(rows[0], rows[1])
    np.testing.assert_array_equal(rows[2], rows[3])
    np.testing.assert_array_equal(np.concatenate([rows[0], rows[2]]),
                                  runs[2]["spec"]["dnn_train"][0]["target"])


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_dnn_matches_jax_2d_mesh_and_meshless(runs, shape):
    ranks = runs[0] if shape == (1, 2) else runs[1]
    for r in ranks:
        assert_trajectory(r["dnn"]["losses"], runs[2][f"jax_dnn{shape}"],
                          runs[2]["dnn"], exact=r["dnn"]["exact"])


@pytest.mark.parametrize("key", ["dnn", "xvector", "crnn"])
def test_split_names_match_the_jax_rule(runs, key):
    ranks, _, ref = runs
    for r in ranks:
        assert set(r[key]["specs"]) == ref["jax_names"][key]
        assert set(r[key]["specs"].values()) == {0}


@pytest.mark.parametrize("key", ["dnn", "xvector", "crnn"])
def test_each_rank_computes_its_columns(runs, key):
    """Every split weight is half on each rank, before and after training
    (Adam's moments too), and the rank's Dense / Conv products run on the
    halves; the recurrent layer runs on gathered weights."""
    ranks, ranks4, _ = runs
    for r in ranks + (ranks4 if key == "dnn" else []):
        out = r[key]
        full = {k: v.shape for k, v in out["full"].items()}
        for name, shard in out["shards"].items():
            assert shard == (full[name][0] // 2,) + full[name][1:], name
        if "before" in out:
            assert out["before"] == out["shards"]
            for name, shape in out["moments"].items():
                assert shape == out["shards"].get(name, full[name])
        recurrent = {k for k in full if "Cell_" in k}
        split = {s for k, s in out["shards"].items() if k not in recurrent}
        whole = {full[k] for k in full if k.endswith("weight")
                 and k not in out["shards"] and k not in recurrent}
        products = out["products"]
        for op, shape in products:
            if op == "lstm":  # crnn's 256 units, 4 gates, gathered whole
                assert shape[0] == 4 * 256, shape
            else:
                assert shape in split | whole, (op, shape)
        assert split <= {s for op, s in products if op != "lstm"}
    if key == "dnn":
        assert ranks[0]["dnn"]["products"] == [
            ("linear", (100, 8)), ("linear", (200, 200)),
            ("linear", (300, 400)), ("linear", (400, 600)),
            ("linear", (3, 800))]


def test_restore_resplits_a_meshless_checkpoint(runs):
    ranks, _, ref = runs
    raw = torch.load(ref["spec"]["ckpt"], weights_only=True)
    for r in ranks:
        out = r["restore"]
        assert out["epoch"] == 1
        assert out["shards"] == r["dnn"]["shards"]
        for k, v in raw["params"].items():
            np.testing.assert_array_equal(out["full"][k], v.numpy())
        for field in ("mu", "nu"):
            for a, b in zip(out["opt"][0][field], raw["opt_state"][0][field]):
                np.testing.assert_array_equal(a, b.numpy())
        assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
        # the sharded trainer's own checkpoints: the gathered state, the
        # same in an Orbax directory
        for k, v in r["dnn"]["ckpt"].items():
            assert v.shape == r["dnn"]["full"][k].shape
            np.testing.assert_array_equal(r["dnn"]["orbax"][k], v)


def test_cached_replay_equals_streaming(runs):
    for r in runs[0]:
        cached, streamed = r["replay"][True], r["replay"][False]
        np.testing.assert_allclose(cached["losses"], streamed["losses"],
                                   rtol=1e-6)
        for k, v in streamed["full"].items():
            np.testing.assert_allclose(cached["full"][k], v, rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("scenario", ["1x2", "2x2"])
def test_sync_model_variables_is_bit_identical(runs, scenario):
    ranks = runs[0] if scenario == "1x2" else runs[1]
    keys = ("dnn", "xvector", "crnn") if scenario == "1x2" else ("dnn",)
    for key in keys:
        for r in ranks:
            assert r[key]["synced_equal"], key
            assert len(set(r[key]["synced"])) == 1, (key, r[key]["synced"])
        for k, v in ranks[0][key]["full"].items():
            for r in ranks[1:]:
                np.testing.assert_array_equal(r[key]["full"][k], v)


def test_xvector_through_fit_signals(runs):
    ranks, _, ref = runs
    for r in ranks:
        ours = r["xvector"]["history"]
        np.testing.assert_allclose(losses_of(ours), losses_of(ref["xvector"]),
                                   rtol=1e-5)
        np.testing.assert_allclose([e["val_loss"] for e in ours],
                                   [e["val_loss"] for e in ref["xvector"]],
                                   rtol=1e-5)
        clean = losses_of(r["xvector_clean"]["history"])
        jax_clean = losses_of(ref["jax_xvector_clean"])
        np.testing.assert_allclose(clean[0], jax_clean[0], rtol=1e-4)
        np.testing.assert_allclose(clean[-1], jax_clean[-1], rtol=1e-3)


def test_remat_on_a_two_rank_mesh(runs):
    """``remat`` with channel dropout 0.5 over 1 x 2: the recompute
    re-enters the mesh scopes and redraws the forward's masks, so the
    step losses equal the plain run's in float32."""
    ranks, _, _ = runs
    for r in ranks:
        assert len(r["remat"][True]) == 3
        assert r["remat"][True] == r["remat"][False]
    assert ranks[0]["remat"] == ranks[1]["remat"]


def test_crnn_weight_gather_route(runs):
    ranks, _, ref = runs
    for r in ranks:
        ours = r["crnn"]["history"]
        for field in ("loss", "val_loss"):
            got = [e[field] for e in ours]
            assert_trajectory(got, [e[field] for e in ref["jax_crnn"]],
                              [e[field] for e in ref["crnn"]])
        for k, v in ref["jax_crnn_state"].items():
            np.testing.assert_allclose(r["crnn"]["full"][k], v, rtol=RTOL,
                                       atol=ATOL, err_msg=k)
            np.testing.assert_allclose(r["crnn"]["full"][k],
                                       ref["crnn_state"][k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_clip_by_global_norm_matches_optax(runs):
    ranks, _, ref = runs
    for r in ranks:
        for k, v in ref["clip"].items():
            np.testing.assert_allclose(r["clip"][k], np.asarray(v),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


def test_param_sharding_needs_a_2d_mesh():
    import lidbox_tpu_torch.models as tmodels
    from lidbox_tpu_torch import losses
    from lidbox_tpu_torch.train import loop, optimizers
    model = tmodels.create("dnn", (T, F), N, device="cpu")
    for mesh in (None, parallel.get_mesh(device="cpu")):
        with pytest.raises(ValueError, match="2-D"):
            loop.Trainer(model, optimizers.adam(5e-3), losses.nll_loss,
                         mesh=mesh, param_sharding=lambda name, leaf: None,
                         device="cpu")
