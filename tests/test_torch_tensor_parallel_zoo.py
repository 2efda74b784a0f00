"""
Every model configuration of the zoo under tensor parallelism, on the CPU.

Two ranks of the port (subprocesses over gloo, ``torch_parallel_common``)
run the first train step of each of the 17 configurations of
``chip_smoke.py``'s zoo phase (the 14 keys, clstm's two options,
convnet_extractor's MobileNetV2) on a 1 x 2 (data, model) mesh with
``parallel.column_parallel_rule``, and the mesh-less step beside it, on
the same seeded weights and batch (4 x 32 frames x 32 channels; the
stochastic layers draw the same values in both), in float64
(``compute_dtype``): the deep BatchNorm trunks' float32 training steps
sit far from float64 (ROADMAP §3), so in float32 two summation orders of
one step differ by up to a few percent of the gradient there. Held:

- the loss (the float32 output's) within rtol 1e-7 of the mesh-less
  step and the gradients, gathered whole, within 1e-7 of it relative to
  their norm: the models without BatchNorm read 0 to 1e-16, the deep
  BatchNorm trunks amplify float64 rounding to 1e-10 (ResNet50V2) and
  1e-9 (MobileNetV2 at 4 rows), and a wrong column or a missed reduction
  moves them by far more than float32 rounding;
- the route each layer takes: Dense and non-grouped Conv products run on
  this rank's rows of a split weight; the recurrent cells (cuDNN's
  concatenated gates) and MobileNetV2's depthwise convolutions run on the
  split weights gathered whole; ap_lstm's 62-unit cells and 5-wide head
  split nothing (the JAX rule's 64 minimum).
"""
import numpy as np
import pytest
import torch

from torch_parallel_common import finish_ranks, start_ranks

torch.set_num_threads(2)

SHAPE = (32, 32)
BATCH = 4
ZOO = [(key, key, {}) for key in (
    "ap_lstm", "bi_gru", "clstm", "cnn", "convnet_extractor", "crnn", "dnn",
    "lstm", "multilevel_attention", "spherespeaker", "xvector",
    "xvector_2d", "xvector_extended", "xvector_freq_attention")] + [
    ("clstm+conv2d", "clstm", {"use_conv2d": True}),
    ("clstm+attention+lstm", "clstm",
     {"use_attention": True, "use_lstm": True}),
    ("mobilenet_v2", "convnet_extractor", {"core": "mobilenet_v2"})]
# the layers whose split weights are gathered whole for the layer
GATHERED = {"bi_gru": "gru", "crnn": "lstm", "lstm": "lstm",
            "spherespeaker": "lstm", "clstm+attention+lstm": "lstm",
            "mobilenet_v2": "conv2d"}
# splits nothing: 62-unit cells and a 5-wide head, under the 64 minimum
NOTHING_SPLIT = ("ap_lstm",)
# splits only recurrent weights: an LSTM and its 3-wide head
ONLY_GATHERED = ("lstm",)
# the ranks' liveness bound: 17 configurations, each stepped twice in
# float64 on both ranks, each model's weights drawn once a rank
# (``torch_init_cache``), take about 40 s alone and 113 s beside five other
# test workers (60 s alone when every model drew its weights twice, which
# outlived 150 s beside them)
RANKS_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rng = np.random.default_rng(0)
    spec = {"zoo": ZOO, "shape": SHAPE,
            "batch": {"input": rng.normal(0, 1, (BATCH,) + SHAPE).astype(
                np.float32), "target": np.array([0, 1, 2, 0], np.int64)}}
    return finish_ranks(start_ranks(
        "tensor_parallel_zoo", spec, tmp_path_factory.mktemp("tp_zoo")),
        timeout=RANKS_TIMEOUT_S)


@pytest.mark.parametrize("name", [n for n, _, _ in ZOO])
def test_first_step_matches_the_meshless_one(ranks, name):
    for r in ranks:
        tp_loss, loss = r[name]["losses"]
        np.testing.assert_allclose(tp_loss, loss, rtol=1e-7)
        assert r[name]["distance"] <= 1e-7, r[name]["distance"]


@pytest.mark.parametrize("name", [n for n, _, _ in ZOO])
def test_each_layer_takes_its_route(ranks, name):
    for r in ranks:
        out = r[name]
        split, products, full = out["split"], out["products"], out["full"]
        shards = {(full[k][0] // 2,) + full[k][1:] for k in split}
        whole = {full[k] for k in split}
        if name in NOTHING_SPLIT:
            assert split == []
            continue
        assert split and all(full[k][0] % 2 == 0 for k in split)
        on_shards = {op for op, w in products if w in shards}
        assert bool(on_shards) == (name not in ONLY_GATHERED), products
        gathered = {op for op, w in products
                    if op in ("lstm", "gru") or (w in whole
                                                 and w not in shards)}
        assert gathered == ({GATHERED[name]} if name in GATHERED
                            else set()), (name, gathered)
