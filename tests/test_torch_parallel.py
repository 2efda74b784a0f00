"""
The port's data-parallel layer (``lidbox_tpu_torch.parallel``) against the
JAX package's mesh, on the CPU.

In this process (a 1-rank gloo group where a test needs one): the host
helpers (``pad_batch_to``, ``local_slice``, ``shard_batch``,
``global_batch_from_local``, ``stack_on_mesh``, the structure digest), the
launcher variables, the 2-D mesh and the sharding rule on one rank, and a
non-mesh ``mesh`` raising.

Two ranks (subprocesses over gloo, ``torch_parallel_common``), held to:

- ``psum_state``: the two ranks' C_avg counters summed, equal to the JAX
  package's ``psum_state`` under ``pmap`` over two devices
  (tests/test_losses_metrics.py:208) and to ``merge_states``;
- ``all_reduce_sum``: its backward is the all-reduce of the gradients;
- ``ModelWrapper.fit_fused`` with ``stft_method: "pallas"`` (the kernel's
  plain version on the CPU) through speed change, FIR, SpecAugment
  (``augment_prob`` 0.5) and an x-vector with channel dropout, plain and
  with ``{stage_dtype: int16, steps_per_dispatch: 2, cache_staged,
  cache_shuffle: rows}``: every draw is the global batch's, so the history
  equals the single-process port's at the global batch of 4 (losses
  within rtol 1e-4, C_avg within 1e-6);
- the mesh embedding extractor on 5 rows (a ragged tail) against the
  mesh-less port (atol 1e-5) and the JAX package's mesh extractor
  (tests/test_train.py:241; the pipeline tests' 1e-4);
  ``extract_embeddings`` with ``data_parallel`` and with ``devices: 1``
  (rank 1 outside the 1-rank sub-mesh receives rank 0's embeddings);
- ``Classifier(mesh=)`` against the mesh-less port (atol 1e-5) and the
  JAX package's ``Classifier(mesh=)`` (tests/test_serve.py:60, atol 1e-4),
  and ``StreamingClassifier(mesh=)`` against the mesh-less port; both
  predict fns eager by rule on two ranks, the reason logged once each.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

import lidbox_tpu.models as jmodels
import lidbox_tpu.serve as jserve
from lidbox_tpu import metrics as jmetrics
from lidbox_tpu import parallel as jparallel
from lidbox_tpu.models.model_utils import ModelWrapper as JWrapper
from lidbox_tpu.train import checkpoint as jckpt
from lidbox_tpu_torch import metrics as tmetrics
from lidbox_tpu_torch import parallel
from lidbox_tpu_torch import serve as tserve
from lidbox_tpu_torch.features import io as tio
from lidbox_tpu_torch.models.model_utils import ModelWrapper as TWrapper
from lidbox_tpu_torch.train import TrainState
from lidbox_tpu_torch.train import checkpoint as tckpt
from torch_parallel_common import THRESHOLDS, finish_ranks, start_ranks
from torch_zoo_common import flax_variables, port_model

torch.set_num_threads(2)

RATE, B, N, MEL = 16000, 4, 5, 24
LABELS = ["l0", "l1", "l2", "l3", "l4"]
EMB_T = 48
SERVE_FEATURES = {"type": "logmelspectrogram",
                  "melspectrogram": {"num_mel_bins": MEL}}
AUGMENT = {"fir_coefs": 5, "speed_range": [0.9, 1.1], "augment_prob": 0.5,
           "specaug": {"time_masks": 1, "time_width": 5, "freq_masks": 1,
                       "freq_width": 4}}
FEED = {"stage_dtype": "int16", "steps_per_dispatch": 2,
        "cache_staged": True, "cache_shuffle": "rows"}


def noisy_sines(n_batches, seed, seconds=0.5):
    rng = np.random.default_rng(seed)
    t = np.arange(int(RATE * seconds)) / RATE
    out = []
    for _ in range(n_batches):
        y = rng.integers(0, N, B)
        x = (np.sin(2 * np.pi * (200.0 + 300.0 * y[:, None]) * t)
             + 0.1 * rng.normal(0, 1, (B, t.size)))
        out.append(((0.5 * x).astype(np.float32), y.astype(np.int32)))
    return out


def fused_config(cache_dir, feed=None):
    return {
        "features": {"type": "logmelspectrogram", "sample_rate": RATE,
                     "melspectrogram": {"num_mel_bins": MEL},
                     "stft_method": "pallas", "on_device_augment": AUGMENT},
        "experiment": {
            "cache_directory": str(cache_dir), "name": "fused",
            "input_shape": [None, MEL], "output_shape": [N],
            "model": {"key": "xvector",
                      "kwargs": {"channel_dropout_rate": 0.2}},
            "optimizer": {"cls": "Adam", "kwargs": {"learning_rate": 1e-3}},
            "loss": {"cls": "SparseCategoricalCrossentropy"},
            "metrics": [{"cls": "SparseAverageDetectionCost", "N": N,
                         "name": "C_avg",
                         "threshold_linspace": {"start": -10.0, "stop": 0.0,
                                                "num": 11}}],
            "feed": feed or {}}}


def extractor_config(root):
    return {"cache_directory": str(root), "model": {"key": "xvector"},
            "experiment_name": "exp", "input_shape": [EMB_T, MEL],
            "output_shape": [N], "batch_size": 4,
            "best_checkpoint": {"monitor": "val_loss", "mode": "min"}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    psum = [(rng.integers(0, 3, 8), rng.normal(-3, 2, (8, 3)))
            for _ in range(2)]
    fused = port_model("xvector", (None, MEL), N, {}, seed=1)
    served = port_model("xvector", (None, MEL), N, {}, seed=2)
    variables = flax_variables(served)
    # the same weights as a checkpoint of each package
    jckpt.save_checkpoint(str(root / "jax" / "xvector" / "exp" /
                               "checkpoints"),
                          {"params": variables["params"]}, epoch=1,
                          val_loss=0.5)
    tckpt.save_checkpoint(str(root / "port" / "xvector" / "exp" /
                               "checkpoints"),
                          TrainState(0, dict(served.module.named_parameters()),
                                     {}, {}), epoch=1, val_loss=0.5)
    wavs = []
    for i in range(6):
        path = str(root / f"u{i}.wav")
        tio.write_mono_wav(path, 0.3 * np.sin(
            np.arange(int(RATE * 0.8)) * (0.05 + 0.02 * i))
            .astype(np.float32), RATE)
        wavs.append(path)
    spec = {
        "psum": psum,
        "fused_state": fused.module.state_dict(),
        "fused_configs": {"plain": fused_config(root / "rank_plain"),
                          "feed": fused_config(root / "rank_feed", FEED)},
        "fused_train": noisy_sines(2, seed=5), "fused_val": noisy_sines(1, 6),
        "extractor": extractor_config(root / "port"),
        "embed_x": rng.normal(0, 1, (5, EMB_T, MEL)).astype(np.float32),
        "serve_model": {"shape": (None, MEL), "outputs": N,
                        "state": served.module.state_dict()},
        "serve_features": SERVE_FEATURES, "labels": LABELS,
        "wavs": wavs, "wav_ids": [f"u{i}" for i in range(6)],
        "stream": rng.uniform(-0.3, 0.3, int(1.3 * RATE)).astype(np.float32),
    }
    handle = start_ranks("serving", spec, root)
    ref = {}
    try:
        jmesh = jparallel.get_mesh(num_devices=2)
        m = jmetrics.AverageDetectionCost(3, THRESHOLDS)
        onehot = [np.eye(3, dtype=np.float32)[lab] for lab, _ in psum]

        def shard(t, s):
            return m.psum_state(m.update(m.init_state(), t, s), "data")
        states = jax.pmap(shard, axis_name="data", devices=jax.devices()[:2])(
            jnp.asarray(np.stack(onehot)),
            jnp.asarray(np.stack([s for _, s in psum]), jnp.float32))
        ref["psum"] = {k: np.asarray(v[0]) for k, v in states.items()}
        tm = tmetrics.SparseAverageDetectionCost(3, THRESHOLDS)
        ref["merged"] = tm.merge_states(*[
            tm.update_sparse(tm.init_state(), torch.as_tensor(lab),
                             torch.as_tensor(s)) for lab, s in psum])

        for name, cfg in spec["fused_configs"].items():
            w = TWrapper.from_config(
                fused_config(root / f"single_{name}",
                             cfg["experiment"]["feed"]), device="cpu")
            w.model.module.load_state_dict(spec["fused_state"])
            ref[f"fused_{name}"] = w.fit_fused(
                lambda: spec["fused_train"], epochs=2,
                val_signal_batches=lambda: spec["fused_val"], verbose=False)

        ext = spec["extractor"]
        ref["embed"] = TWrapper.from_config_as_embedding_extractor_fn(
            ext, device="cpu")(spec["embed_x"])
        ref["embed_jax"] = np.asarray(
            JWrapper.from_config_as_embedding_extractor_fn(
                extractor_config(root / "jax"), mesh=jmesh)(spec["embed_x"]))

        ref["scores"] = tserve.Classifier(
            served, LABELS, feature_config=SERVE_FEATURES, batch_size=4,
            device="cpu").scores(wavs, ids=spec["wav_ids"])
        jm = jmodels.create("xvector", (None, MEL), N)
        jm.variables = variables
        ref["scores_jax"] = jserve.Classifier(
            jm, LABELS, feature_config=SERVE_FEATURES, batch_size=4,
            mesh=jmesh).scores(wavs, ids=spec["wav_ids"])
        stream = tserve.StreamingClassifier(
            served, LABELS, feature_config=SERVE_FEATURES, chunk_seconds=0.5,
            hop_seconds=0.25, device="cpu")
        stream.feed(spec["stream"])
        ref["stream"] = stream.scores()
    finally:
        ranks = finish_ranks(handle)
    return ranks, ref


def test_psum_state_matches_jax(runs):
    ranks, ref = runs
    for out in ranks:
        for state in (out["psum"], out["psum_by_name"]):
            assert set(state) == set(ref["psum"])
            for k, v in ref["psum"].items():
                np.testing.assert_array_equal(state[k], v, err_msg=k)
                np.testing.assert_array_equal(state[k],
                                              ref["merged"][k].numpy())


def test_all_reduce_backward_sums_gradients(runs):
    ranks, _ = runs
    # L = sum_r (1 + r) * sum_j x_j^2 with x_r = 1 + r: dL/dx_r = 3 * 2 x_r
    assert [out["grad"] for out in ranks] == [6.0, 12.0]


@pytest.mark.parametrize("name", ["plain", "feed"])
def test_fit_fused_equals_single_process(runs, name):
    ranks, ref = runs
    single = ref[f"fused_{name}"]
    assert len(single) == 2
    for out in ranks:
        ours = out[f"fused_{name}"]["history"]
        assert len(ours) == 2
        for a, b in zip(ours, single):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
            np.testing.assert_allclose(a["val_loss"], b["val_loss"],
                                       rtol=1e-4)
            np.testing.assert_allclose(a["val_C_avg"], b["val_C_avg"],
                                       atol=1e-6)
    assert len(set(ranks[0][f"fused_{name}"]["checksums"])) == 1


def test_embedding_extractor_on_mesh(runs):
    ranks, ref = runs
    assert ref["embed"].shape == (5, 512)
    for out in ranks:
        np.testing.assert_allclose(out["embed"], ref["embed"], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(out["embed"], ref["embed_jax"],
                                   atol=1e-4, rtol=0)
        for key in ("devices", "data_parallel"):
            np.testing.assert_allclose(out[f"embed_{key}"], ref["embed"],
                                       atol=1e-5, rtol=0)
    # rank 1 ran no forward under devices: 1, it received rank 0's rows
    np.testing.assert_array_equal(ranks[0]["embed_devices"],
                                  ranks[1]["embed_devices"])


def test_classifiers_on_mesh(runs):
    ranks, ref = runs
    for out in ranks:
        assert out["scores"]["id"] == ref["scores"]["id"]
        np.testing.assert_allclose(out["scores"]["prediction"],
                                   ref["scores"]["prediction"], atol=1e-5)
        jax_scores = np.stack([ref["scores_jax"].loc[i].prediction
                               for i in out["scores"]["id"]])
        np.testing.assert_allclose(out["scores"]["prediction"], jax_scores,
                                   atol=1e-4)
        np.testing.assert_allclose(out["stream"], ref["stream"], atol=1e-5)
        # two ranks: the Classifier's predict fn and the stream's run
        # eagerly by rule, each logged once
        assert out["stream_on_mesh"]
        assert len(out["eager_logs"]) == 2 and all(
            m.startswith("forward program runs eagerly")
            and "several ranks" in m for m in out["eager_logs"]), (
                out["eager_logs"])


# -- in this process ---------------------------------------------------------------

def test_host_helpers():
    batch = {"input": np.arange(10, dtype=np.float32).reshape(5, 2),
             "target": np.arange(5)}
    padded, valid = parallel.pad_batch_to(batch, 6)
    jpadded, jvalid = jparallel.pad_batch_to(batch, 6)
    np.testing.assert_array_equal(valid, jvalid)
    for k in batch:
        np.testing.assert_array_equal(padded[k], jpadded[k])

    class Rank:  # local_slice reads only the mesh's data size and index
        data_size = 2

        def __init__(self, rank):
            self.data_index = rank
    parts = [parallel.local_slice(batch, Rank(r)) for r in range(2)]
    assert [p["input"].shape for p in parts] == [(3, 2), (3, 2)]
    np.testing.assert_array_equal(
        np.concatenate([p["example_mask"] for p in parts]), valid)
    np.testing.assert_array_equal(
        np.concatenate([p["input"] for p in parts]), padded["input"])
    sig = (np.ones((4, 7), np.float32), np.arange(4))
    parts = [parallel.local_slice(sig, Rank(r)) for r in range(2)]
    assert all(len(p) == 2 and p[0].shape == (2, 7) for p in parts)
    signals, targets, mask = parallel.local_slice(
        (sig[0][:3], sig[1][:3]), Rank(1))
    assert signals.shape == (2, 7) and targets.tolist() == [2, 0]
    assert mask.tolist() == [True, False]
    a = parallel.structure_digest({"x": torch.zeros(2, 3), "n": 4})
    assert a == parallel.structure_digest({"n": 5, "x": torch.ones(2, 3)})
    assert a != parallel.structure_digest({"x": torch.zeros(3, 3), "n": 4})
    assert a != parallel.structure_digest({"x": torch.zeros(2, 3)})


def test_launcher_variables_and_what_still_raises(monkeypatch):
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    if not dist.is_initialized():
        assert parallel.initialize_distributed() is False
    # the tensor-parallel entry points run: a 1 x 1 mesh of this process
    # splits nothing (tests/test_torch_tensor_parallel.py splits over 2)
    mesh = parallel.get_mesh_2d(data_size=1, model_size=1, device="cpu")
    assert mesh.shape == (1, 1) and mesh.axis_names == ("data", "model")
    assert mesh.data_mesh.size == 1 and mesh.model_mesh.size == 1
    assert parallel.get_mesh_2d(1, 1) is mesh
    params = {"w": torch.ones(64, 3), "b": torch.zeros(64)}
    shards, specs = parallel.shard_params(
        params, mesh, parallel.column_parallel_rule(mesh))
    assert specs == {} and shards["w"] is params["w"]
    with pytest.raises(ValueError):
        parallel.get_mesh_2d(data_size=2, model_size=dist.get_world_size())
    with pytest.raises(TypeError):
        parallel.as_mesh(object())
    assert parallel.as_mesh(None) is None


def test_one_rank_mesh_in_process():
    mesh = parallel.get_mesh(device="cpu")
    assert dist.is_initialized() and mesh.size == dist.get_world_size()
    assert mesh is parallel.get_mesh() and mesh.is_member
    assert not parallel.mesh_spans_processes(mesh) or mesh.size > 1
    assert not parallel.mesh_spans_processes(None)
    batch = {"input": np.ones((4, 3), np.float32)}
    if mesh.size == 1:
        local = parallel.shard_batch(batch, mesh)
        assert torch.equal(local["input"], torch.ones(4, 3))
    tree = {"a": torch.arange(3.0), "b": [torch.ones(2, dtype=torch.int64)]}
    rep = parallel.put_replicated(tree, mesh)
    assert torch.equal(rep["a"], tree["a"]) and rep["b"][0].dtype == torch.int64
    stacked = parallel.stack_on_mesh([{"x": torch.zeros(2)}] * 3, mesh)
    assert stacked["x"].shape == (3, 2)
    with parallel.data_parallel(mesh):
        draws = parallel.draw_rows(lambda n: torch.arange(n), 3)
    assert draws.tolist() == [0, 1, 2]
    with pytest.raises(ValueError):
        parallel.get_mesh(num_devices=mesh.size + 1)
