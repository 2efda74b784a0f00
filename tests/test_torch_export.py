"""
The port's deployment export against lidbox_tpu's, on the CPU.

- ``export.save_model`` / ``load_model`` round trip to the same outputs,
  and the deployment directories of the two packages load in each other:
  a JAX ``save_model`` directory in the port and a port directory in the
  JAX package, outputs within 1e-5 on the same input, weight files
  byte-equal for the same weights.
- ``export.export_program`` with a symbolic batch and a symbolic time
  dimension: the reloaded program serves batches 1, 2 and 5 at several
  lengths as the live model does; a static batch stays static.
- The slice as a whole: ``examples/end_to_end_torch.main(device="cpu")``
  at 2 epochs (pipeline, training, checkpoints, embeddings, the numpy
  back-end's report, export).
"""
import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest
import torch

import jax

import lidbox_tpu.models as jmodels
import lidbox_tpu_torch.models as tmodels
from lidbox_tpu import export as jexport
from lidbox_tpu_torch import export as texport
from lidbox_tpu_torch.models.model_api import params_from_flax

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = RTOL = 1e-5
N_OUT, FEAT = 3, 16


@pytest.fixture(scope="module")
def models():
    """The JAX x-vector at [None, 16] and the port's with its weights."""
    jm = jmodels.create("xvector", (None, FEAT), N_OUT)
    jm.init(jax.random.PRNGKey(5))
    tm = tmodels.create("xvector", (None, FEAT), N_OUT, device="cpu")
    tm.module.load_state_dict(params_from_flax(
        jax.device_get(jm.variables["params"])))
    return jm, tm


def _inputs(batch, frames, seed=0):
    return np.random.default_rng(seed).normal(
        0, 1, (batch, frames, FEAT)).astype(np.float32)


def _port_out(model, x):
    with torch.inference_mode():
        return model.apply(torch.as_tensor(x)).numpy()


def _jax_out(model, x):
    return np.asarray(model.apply(model.variables, x, train=False))


def test_save_load_round_trip(models, tmp_path):
    _, tm = models
    texport.save_model(tm, "xvector", tmp_path,
                       model_kwargs={"num_outputs": N_OUT})
    spec = json.loads((tmp_path / texport.SPEC_NAME).read_text())
    assert spec == {"model_key": "xvector", "input_shape": [None, FEAT],
                    "name": "x-vector", "output": "logits",
                    "kwargs": {"num_outputs": N_OUT}}
    loaded = texport.load_model(tmp_path, device="cpu")
    x = _inputs(3, 40)
    assert np.array_equal(_port_out(loaded, x), _port_out(tm, x))
    embedder = tmodels.create("xvector", (None, FEAT), N_OUT, device="cpu")
    embedder.module.load_state_dict(tm.module.state_dict())
    texport.save_model(embedder.with_output("embedding"), "xvector",
                       tmp_path / "emb", model_kwargs={"num_outputs": N_OUT})
    emb = texport.load_model(tmp_path / "emb", device="cpu")
    assert emb.output == "embedding" and _port_out(emb, x).shape == (3, 512)


def test_directories_load_across_packages(models, tmp_path):
    jm, tm = models
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jexport.save_model(jm, "xvector", str(jdir),
                       model_kwargs={"num_outputs": N_OUT})
    texport.save_model(tm, "xvector", tdir,
                       model_kwargs={"num_outputs": N_OUT})
    assert ((jdir / jexport.WEIGHTS_NAME).read_bytes()
            == (tdir / texport.WEIGHTS_NAME).read_bytes())
    assert (json.loads((jdir / jexport.SPEC_NAME).read_text())
            == json.loads((tdir / texport.SPEC_NAME).read_text()))
    x = _inputs(4, 37, seed=1)
    ref = _jax_out(jm, x)
    port_from_jax = texport.load_model(jdir, device="cpu")
    np.testing.assert_allclose(_port_out(port_from_jax, x), ref,
                               atol=ATOL, rtol=RTOL)
    jax_from_port = jexport.load_model(str(tdir))
    np.testing.assert_allclose(_jax_out(jax_from_port, x), ref,
                               atol=ATOL, rtol=RTOL)


def test_export_program_symbolic_batch_and_time(models, tmp_path):
    _, tm = models
    path = texport.export_program(tm, tmp_path)
    assert path == os.path.join(tmp_path, texport.PROGRAM_NAME)
    program = texport.load_program(path)
    with torch.inference_mode():
        for batch, frames in ((1, 40), (2, 23), (5, 64)):
            x = _inputs(batch, frames, seed=batch)
            out = program(torch.as_tensor(x)).numpy()
            assert out.shape == (batch, N_OUT)
            np.testing.assert_allclose(out, _port_out(tm, x), atol=ATOL,
                                       rtol=RTOL)


def test_export_program_static_batch(models, tmp_path):
    _, tm = models
    program = texport.load_program(texport.export_program(tm, tmp_path,
                                                          batch_size=2))
    x = _inputs(2, 30, seed=7)
    with torch.inference_mode():
        np.testing.assert_allclose(program(torch.as_tensor(x)).numpy(),
                                   _port_out(tm, x), atol=ATOL, rtol=RTOL)
        with pytest.raises(Exception):
            program(torch.as_tensor(_inputs(3, 30)))


def test_end_to_end_example_on_cpu(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "end_to_end_torch", ROOT / "examples" / "end_to_end_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    report = example.main(device="cpu", epochs=2, workdir=str(tmp_path))
    assert 0.0 <= report["accuracy"] <= 1.0
    assert np.isfinite(report["avg_detection_cost"])
    assert report["confusion_matrix"].shape == (3, 3)
    assert report["confusion_matrix"].sum() == report["macro avg"]["support"]
    ckpts = list((tmp_path / "cache" / "xvector" / "demo" / "checkpoints")
                 .glob("epoch*.ckpt"))
    assert len(ckpts) == 2
    assert (tmp_path / "deploy" / texport.PROGRAM_NAME).exists()
