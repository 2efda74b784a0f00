"""
convnet_extractor with its ResNet50V2 trunk against lidbox_tpu.models on
the CPU, at one small image (b3 x 40 frames x 32 bins): the parameter and
batch-stats trees equal Flax's, eval logits and embeddings (unmasked, and
with the approximate-mask pooling) within rtol 1e-4 + atol 1e-5, and
training mode: Flax's batch-stats update at the same tolerance, the
outputs within the JAX package's own float32 distance from a float64
evaluation (16 bottlenecks of chained batch statistics, the last ones over
a few pixels per channel, amplify float32 rounding in both packages).
"""
import copy

import numpy as np
import pytest
import torch

import jax

from lidbox_tpu_torch.models.model_api import params_from_flax
from torch_zoo_common import (ATOL, RTOL, flax_variables, inputs,
                              jax_init_shapes, jax_outputs, port_model,
                              port_outputs, tree_shapes)

torch.set_num_threads(2)

B, T, FEAT, N = 3, 40, 32, 5
LENGTHS = [T, 29, 17]
KEY, KW = "convnet_extractor", {"core": "resnet50_v2"}


@pytest.fixture(scope="module")
def run():
    x, mask = inputs(B, T, FEAT, LENGTHS)
    model = port_model(KEY, (T, FEAT), N, KW)
    variables = flax_variables(model)
    return {"x": x, "model": model, "variables": variables,
            "ref": jax_outputs(KEY, (T, FEAT), N, KW, variables, x, mask),
            "ours": port_outputs(model, x, mask)}


def test_parameter_tree_matches_flax(run):
    assert tree_shapes(run["variables"]) == jax_init_shapes(KEY, (T, FEAT),
                                                            N, KW)
    state = params_from_flax(run["variables"]["params"])
    state.update(params_from_flax(run["variables"]["batch_stats"]))
    for k, v in run["model"].module.state_dict().items():
        assert torch.equal(state.pop(k), v), k
    assert not state


@pytest.mark.parametrize("out", ["logits", "embedding", "logits_masked",
                                 "embedding_masked"])
def test_eval_forward_matches_jax(run, out):
    ours, ref = run["ours"][out], run["ref"][out]
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_train_mode_matches_flax_mutable(run):
    model, ref = run["model"], run["ref"]
    logits, new_bs = model.apply(torch.as_tensor(run["x"]), train=True)
    ref_bs = params_from_flax(jax.device_get(ref["batch_stats"]))
    assert set(new_bs) == set(ref_bs)
    for k, v in ref_bs.items():
        np.testing.assert_allclose(new_bs[k].numpy(), v.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    exact_model = copy.deepcopy(model.module).double().train()
    with torch.no_grad():
        exact = exact_model(torch.as_tensor(run["x"], dtype=torch.float64))
    exact = exact.numpy()
    assert (np.abs(logits.detach().numpy() - exact).max()
            <= np.abs(ref["train"] - exact).max())
