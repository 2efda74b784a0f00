"""
Deployment directories of the model zoo across both packages, on the CPU:
for every key (and convnet_extractor's MobileNetV2 trunk) the port's
``export.save_model`` writes the JAX package's directory, Flax's variable
tree with its batch stats in msgpack, and a directory the JAX package's
``save_model`` writes loads in the port's ``load_model`` with the same
weights; the JAX package's own ``load_model`` reads the port's directory
of a BatchNorm model.
"""
import jax
import numpy as np
import pytest
import torch

import lidbox_tpu.export as jexport
import lidbox_tpu.models as jmodels
import lidbox_tpu_torch.export as texport
import lidbox_tpu_torch.models as tmodels
from lidbox_tpu_torch.train import serialization
from torch_zoo_common import (flax_variables, jax_init_shapes, port_model,
                              tree_shapes)

torch.set_num_threads(2)

T, FEAT, N = 40, 32, 5


EXPORTED = [(k, {}) for k in tmodels.PORTED_KEYS] + [
    ("convnet_extractor", {"core": "mobilenet_v2"})]


@pytest.mark.parametrize("key,kw", EXPORTED,
                         ids=[k + ("_" + v["core"] if v else "")
                              for k, v in EXPORTED])
def test_deployment_directories_cross_packages(key, kw, tmp_path):
    """The port's ``save_model`` writes the JAX package's directory (Flax's
    variable tree, batch stats included, in msgpack); a directory the JAX
    package writes loads in the port with the same weights."""
    model = port_model(key, (T, FEAT), N, kw, seed=4)
    texport.save_model(model, key, str(tmp_path / "port"),
                       model_kwargs={"num_outputs": N, **kw})
    with open(tmp_path / "port" / texport.WEIGHTS_NAME, "rb") as f:
        written = serialization.msgpack_restore(f.read())
    variables = flax_variables(model)
    assert tree_shapes(written) == jax_init_shapes(key, (T, FEAT), N, kw)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, written, variables))
    jm = jmodels.create(key, (T, FEAT), N, **kw).with_variables(variables)
    jexport.save_model(jm, key, str(tmp_path / "jax"),
                       model_kwargs={"num_outputs": N, **kw})
    loaded = texport.load_model(str(tmp_path / "jax"), device="cpu")
    for k, v in model.module.state_dict().items():
        assert torch.equal(loaded.module.state_dict()[k], v), k
    if key == "multilevel_attention":  # the JAX loader itself, BN included
        back = jexport.load_model(str(tmp_path / "port"))
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(
            np.array_equal, jax.device_get(back.variables), variables))
