"""
ECAPA-TDNN in the port (``models/ecapa_tdnn.py``), on the CPU at small
widths (channels 64, Res2Net scale 8, MFA 192, 40 frames), against the
benchmark's plain float64 reference (``port_bench/reference/ecapa_tdnn.py``,
the one copy of it) on seeded weights:

- the training-mode log-probabilities and the first step's gradients, and
  3 Adam steps through ``ModelWrapper.fit``, unmasked and frame-masked;
- a padded batch in eval mode scores each row as the row does alone, and
  so does ``serve.Classifier`` on files of several lengths;
- the masked ``BatchNorm`` equals a BatchNorm over the valid frames alone;
  a row with no valid frame is finite;
- the frame statistics are counted (``stats_masked``, ``stats_full``) and
  reach the program's spans;
- ``create()``'s defaults are the configuration's widths and its
  parameter count;
- ``BatchNorm``'s defaults leave bi_gru and the x-vector bit-equal to the
  BatchNorm they had before it took a mask, an epsilon and a momentum.
"""
import collections
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lidbox_tpu_torch.models as tmodels
import lidbox_tpu_torch.serve as tserve
from lidbox_tpu_torch.features import io as tio
from lidbox_tpu_torch.models import ecapa_tdnn, layers
from lidbox_tpu_torch.models.model_utils import ModelWrapper
from lidbox_tpu_torch.train import observability
from port_bench import common
from port_bench.reference import ecapa_tdnn as ref
from port_bench.reference import nn as ref_nn

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
B, T, MEL, N = 4, 40, 20, 5
SMALL = {"channels": [64, 64, 64, 64, 192], "kernel_sizes": [5, 3, 3, 3, 1],
         "dilations": [1, 2, 3, 4, 1], "res2net_scale": 8, "se_channels": 16,
         "attention_channels": 16, "embedding_dim": 32,
         "classifier_blocks": 1, "classifier_neurons": 24}
CONFIG = dict(SMALL, num_outputs=N, features={"num_mel_bins": MEL},
              batch_norm={"epsilon": 1e-5})
LENGTHS = [40, 33, 21, 9]
# frame statistics of one training forward: the input mean, block 0's
# BatchNorm, per SE-Res2Net block 2 + 7 BatchNorms and the squeeze, MFA's
# BatchNorm, the pooling's two and its TDNN's BatchNorm
STATISTICS = 1 + 1 + 3 * (2 + 7 + 1) + 1 + 3
# float32 against float64 through some 30 batch normalizations of 4 x 40
# frames: the log-probabilities part by 4e-6 .. 3e-5 (4 seeds, plain and
# masked), so 1e-4 holds them to float32's rounding
LOGP_ATOL = 1e-4
# a leaf's first gradient: its largest |port - reference| over the larger
# of its own largest reference element and the median leaf's (the
# benchmark's gap; the pooling convolution's bias has a zero gradient,
# softmax over time cancelling it): measured 1.3e-5 .. 9.3e-5, so 5e-4
GRAD_RTOL = 5e-4
# 3 Adam steps (lr 1e-3, epsilon 1e-4) through the trainer: the losses
# part by float32 rounding alone (1e-5); each leaf's change, the norm of
# its gap over the larger of its own and the median leaf's change (the
# benchmark's ``update_norm_gap``), leaves whose first gradient is under a
# thousandth of the median leaf's left out (the pooling convolution's
# bias, which only rounding moves): measured 3.5e-3 (masked) and 5.4e-3
# (plain), Adam's normalization turning float32 rounding of small gradient
# elements into whole steps, so 2e-2
LOSS_RTOL = 1e-5
CHANGE_RTOL = 2e-2


def weights(seed=3):
    return common.make_weights(ref.param_specs(CONFIG), seed, CPU)


def port_model(seed=3):
    model = tmodels.create("ecapa_tdnn", (None, MEL), N, device="cpu",
                           **SMALL)
    model.module.load_state_dict(weights(seed), strict=True)
    return model


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, T, MEL)).astype(np.float32)
    y = rng.integers(0, N, B)
    mask = np.arange(T)[None] < np.array(LENGTHS)[:, None]
    return torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(mask)


def reference(params, x, y, lengths):
    live = {k: v.double().detach().requires_grad_(not k.endswith(
        (".mean", ".var"))) for k, v in params.items()}
    logp = ref.forward(live, x.double(), CONFIG, lengths)
    loss = ref_nn.nll(logp, y)
    names = [k for k in live if live[k].requires_grad]
    grads = dict(zip(names, torch.autograd.grad(
        loss, [live[k] for k in names])))
    return logp.detach(), grads


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_forward_and_gradients_match_reference(masked):
    x, y, mask = inputs()
    model = port_model()
    params = dict(model.module.named_parameters())
    logp, _ = model.apply(x, mask=mask if masked else None, train=True)
    grads = dict(zip(params, torch.autograd.grad(
        ref_nn.nll(logp, y), list(params.values()))))
    ref_logp, ref_grads = reference(weights(), x, y,
                                    LENGTHS if masked else None)
    np.testing.assert_allclose(logp.detach().double(), ref_logp, rtol=0,
                               atol=LOGP_ATOL)
    assert set(grads) == set(ref_grads)
    median = float(np.median([float(g.abs().max())
                              for g in ref_grads.values()]))
    for k, g in ref_grads.items():
        scale = max(float(g.abs().max()), median)
        gap = float((grads[k].double() - g).abs().max())
        assert gap <= GRAD_RTOL * scale, (k, gap, scale)


def trainer_config(root):
    return {"experiment": {
        "cache_directory": str(root), "name": "ecapa",
        "input_shape": [T, MEL], "output_shape": [N],
        "model": {"key": "ecapa_tdnn", "kwargs": SMALL},
        "optimizer": {"cls": "Adam", "kwargs": {"learning_rate": 1e-3,
                                                "epsilon": 1e-4}},
        "loss": {"cls": "SparseCategoricalCrossentropy"},
        "metrics": [], "callbacks": []}}


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_three_adam_steps_through_the_trainer(masked, tmp_path):
    batches = []
    for seed in range(3):
        x, y, mask = inputs(seed)
        batch = {"input": x.numpy(), "target": y.numpy().astype(np.int32)}
        if masked:
            batch["input_mask"] = mask.numpy()
        batches.append(batch)
    wrapper = ModelWrapper.from_config(trainer_config(tmp_path),
                                       device="cpu")
    wrapper.model.module.load_state_dict(weights(), strict=True)
    it = iter(batches)
    history = wrapper.fit(lambda: [next(it)], None, epochs=3, verbose=False)
    adam = ref_nn.Adam(1e-3, eps=1e-4)
    params = {k: v.double() for k, v in weights().items()}
    losses, first = [], None
    for batch in batches:
        x = torch.as_tensor(batch["input"]).double()
        y = torch.as_tensor(batch["target"]).long()
        live = {k: v.detach().requires_grad_(not k.endswith((".mean",
                                                             ".var")))
                for k, v in params.items()}
        loss = ref_nn.nll(ref.forward(live, x, CONFIG,
                                      LENGTHS if masked else None), y)
        names = [k for k in live if live[k].requires_grad]
        grads = dict(zip(names, torch.autograd.grad(
            loss, [live[k] for k in names])))
        params.update(adam.step({k: params[k] for k in names}, grads))
        losses.append(float(loss.detach()))
        if first is None:
            first = grads
    np.testing.assert_allclose([h["loss"] for h in history], losses,
                               rtol=LOSS_RTOL)
    state = wrapper.trainer.state.params
    assert set(state) == set(names)
    start = weights()
    change = {k: float(torch.linalg.vector_norm(params[k] - start[k]))
              for k in names}
    median = float(np.median(list(change.values())))
    g_median = float(np.median([float(torch.linalg.vector_norm(g))
                                for g in first.values()]))
    gaps = {k: float(torch.linalg.vector_norm(state[k].double() - params[k]))
            / max(change[k], median) for k in names
            if float(torch.linalg.vector_norm(first[k])) >= 1e-3 * g_median}
    assert "asp.conv.bias" not in gaps
    assert max(gaps.values()) <= CHANGE_RTOL, max(gaps.items(),
                                                  key=lambda kv: kv[1])


def test_padded_rows_score_as_alone():
    """Eval mode (running statistics): each row of a padded batch, the
    padding filled with noise, scores as the row alone within float32
    rounding (another frame count sums the convolutions in another
    order)."""
    x, _, mask = inputs(4)
    x = torch.where(mask[..., None], x, torch.full_like(x, 7.0))
    model = port_model()
    with torch.no_grad():
        batch = model.apply(x, mask=mask)
        for i, n in enumerate(LENGTHS):
            alone = model.apply(x[i:i + 1, :n])
            np.testing.assert_allclose(batch[i], alone[0], atol=1e-5)
            emb = model.with_output("embedding")
            np.testing.assert_allclose(
                emb.apply(x[i:i + 1], mask=mask[i:i + 1])[0],
                emb.apply(x[i:i + 1, :n])[0], atol=1e-5)


@pytest.mark.parametrize("axis", [1, -1], ids=["channels_first", "last"])
def test_masked_batch_norm_is_batch_norm_of_valid_frames(axis):
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(2, 3, (B, T, 6)), dtype=torch.float32)
    _, _, mask = inputs()
    valid = x[mask]  # [frames, 6]
    if axis == 1:
        x = x.transpose(1, 2)
    norm = layers.BatchNorm(6, axis=axis, epsilon=1e-5, momentum=0.9)
    plain = layers.BatchNorm(6, epsilon=1e-5, momentum=0.9)
    for bn in (norm, plain):
        with torch.no_grad():
            bn.scale.copy_(torch.linspace(0.5, 2, 6))
            bn.bias.copy_(torch.linspace(-1, 1, 6))
    with layers.collect_batch_stats(norm.train()) as got, \
            layers.collect_batch_stats(plain.train()) as want, \
            torch.no_grad():
        y = norm(x, mask)
        expected = plain(valid)
    if axis == 1:
        y = y.transpose(1, 2)
    np.testing.assert_allclose(y[mask], expected, rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)
    # momentum 0.9: a tenth of the batch's statistic over the old
    np.testing.assert_allclose(got["mean"], 0.1 * valid.mean(0), rtol=1e-5,
                               atol=1e-6)


def test_row_without_frames_is_finite():
    x, y, mask = inputs(5)
    mask[2] = False
    model = port_model()
    params = dict(model.module.named_parameters())
    logp, _ = model.apply(x, mask=mask, train=True)
    grads = torch.autograd.grad(ref_nn.nll(logp, y), list(params.values()))
    assert torch.isfinite(logp).all()
    assert all(torch.isfinite(g).all() for g in grads)
    with torch.no_grad():
        assert torch.isfinite(model.apply(x, mask=mask)).all()
    ref_logp, _ = reference(weights(), x, y,
                            [int(n) for n in mask.sum(1)])
    assert torch.isfinite(ref_logp).all()


def test_statistics_are_counted_and_reach_the_spans(tmp_path):
    x, y, mask = inputs()
    model = port_model()
    with observability.tallying(collections.Counter()) as counted:
        model.apply(x, mask=mask, train=True)
    assert counted == {"stats_masked": STATISTICS}
    with observability.tallying(collections.Counter()) as counted:
        model.apply(x, train=True)
    assert counted == {"stats_full": STATISTICS}
    with observability.tallying(collections.Counter()) as counted:
        with torch.no_grad():
            model.apply(x, mask=mask)
    # eval: no BatchNorm statistic, the input mean, squeezes and pooling
    assert counted == {"stats_masked": 1 + 3 + 2}
    wrapper = ModelWrapper.from_config(trainer_config(tmp_path),
                                       device="cpu")
    batch = {"input": x.numpy(), "target": y.numpy().astype(np.int32),
             "input_mask": mask.numpy()}
    observability.clear_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            wrapper.fit(lambda: [batch], None, epochs=1, verbose=False)
        records = observability.spans()
    finally:
        observability.clear_spans()
    runs = [r for r in records if r.name == "lidbox.graph.eager"]
    assert runs and all(r.attrs.get("stats_masked") == STATISTICS
                        for r in runs)
    names = {r.name for r in records}
    assert {"lidbox.ecapa.input", "lidbox.ecapa.block0",
            "lidbox.ecapa.block3", "lidbox.ecapa.mfa", "lidbox.ecapa.asp",
            "lidbox.ecapa.head"} <= names


def test_defaults_are_the_configuration():
    with open(os.path.join(ROOT, "port_bench", "configs",
                           "ecapa_tdnn.json")) as f:
        config = json.load(f)
    model = tmodels.create("ecapa_tdnn", (None, 60), config["num_outputs"],
                           device="cpu")
    module = model.module
    assert [b.conv.out_channels for b in (module.blocks[0], module.mfa)] == [
        config["channels"][0], config["channels"][-1]]
    assert [b.tdnn1.conv.out_channels for b in module.blocks[1:]] == \
        config["channels"][1:-1]
    assert list(ecapa_tdnn.CHANNELS) == config["channels"]
    assert list(ecapa_tdnn.KERNEL_SIZES) == config["kernel_sizes"]
    assert list(ecapa_tdnn.DILATIONS) == config["dilations"]
    block = module.blocks[2]
    assert block.res2net.scale == config["res2net_scale"]
    assert block.res2net.blocks[0].conv.dilation == (config["dilations"][2],)
    assert block.se.conv1.out_channels == config["se_channels"]
    assert module.asp.tdnn.conv.out_channels == config["attention_channels"]
    assert module.fc.out_features == config["embedding_dim"]
    assert len(module.dnn) == config["classifier_blocks"]
    assert module.dnn[0].linear.out_features == config["classifier_neurons"]
    assert module.blocks[0].norm.epsilon == config["batch_norm"]["epsilon"]
    assert model.num_params() == config["parameters"]
    specs = ref.param_specs(config)
    assert sum(int(np.prod(s)) for n, s, _ in specs
               if not n.endswith((".mean", ".var"))) == config["parameters"]
    assert {n: tuple(s) for n, s, _ in specs} == {
        k: tuple(v.shape) for k, v in module.state_dict().items()}


def test_classifier_scores_padded_batches_as_single_files(tmp_path):
    rng = np.random.default_rng(7)
    paths = []
    for i, seconds in enumerate((1.0, 1.7, 2.3)):
        t = np.arange(int(16000 * seconds)) / 16000
        sig = (0.3 * np.sin(2 * np.pi * (200 + 150 * i) * t)
               + 0.1 * rng.normal(size=t.size)).astype(np.float32)
        path = tmp_path / f"u{i}.wav"
        tio.write_mono_wav(path, sig, 16000)
        paths.append(str(path))
    model = port_model()
    labels = [f"l{i}" for i in range(N)]
    fc = {"type": "logmelspectrogram", "melspectrogram": {"num_mel_bins": MEL}}
    batched = tserve.Classifier(model, labels, feature_config=fc,
                                batch_size=3, device="cpu").classify(paths)
    single = tserve.Classifier(model, labels, feature_config=fc,
                               batch_size=1, device="cpu").classify(paths)
    assert batched["id"] == single["id"] == paths
    for lab in labels:
        scores = batched[f"score_{lab}"]
        assert np.isfinite(scores).all() and (scores < 0).all()
        np.testing.assert_allclose(scores, single[f"score_{lab}"], atol=1e-5)


def _seed_batch_norm(self, x):
    """``BatchNorm.forward`` as it was before the mask, epsilon and
    momentum, outside a mesh: momentum 0.99, epsilon 1e-3."""
    axis = self.axis % x.dim()
    shape = [1] * x.dim()
    shape[axis] = -1
    if self.training:
        dims = [d for d in range(x.dim()) if d != axis]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=dims)
        var = torch.square(xf - mean.reshape(shape)).mean(dim=dims)
        if self.collector is not None:
            self.collector[self] = (0.99 * self.mean + (1 - 0.99) * mean,
                                    0.99 * self.var + (1 - 0.99) * var)
    else:
        mean, var = self.mean, self.var
    mul = torch.rsqrt(var + 1e-3) * self.scale
    y = (x - mean.reshape(shape)) * mul.reshape(shape)
    y = y + self.bias.reshape(shape)
    return y.to(torch.promote_types(x.dtype, torch.promote_types(
        self.scale.dtype, self.bias.dtype)))


@pytest.mark.parametrize("key", ["bi_gru", "xvector"])
def test_defaults_keep_other_models_bit_equal(key, monkeypatch):
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.normal(0, 1, (3, 24, 16)), dtype=torch.float32)
    y = torch.as_tensor([0, 2, 1])
    mask = torch.arange(24)[None] < torch.tensor([24, 17, 9])[:, None]
    model = tmodels.create(key, (None, 16), 3, device="cpu")
    params = dict(model.module.named_parameters())

    def run():
        logp, stats = model.apply(x, mask=mask, train=True)
        grads = torch.autograd.grad(ref_nn.nll(logp, y),
                                    list(params.values()))
        with torch.no_grad():
            return [logp, model.apply(x, mask=mask), *grads,
                    *stats.values()]
    now = run()
    monkeypatch.setattr(layers.BatchNorm, "forward", _seed_batch_norm)
    before = run()
    assert len(now) == len(before)
    for a, b in zip(now, before):
        assert torch.equal(a, b)
