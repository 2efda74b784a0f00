"""
Model persistence and deployment export (counterpart of
``lidbox_tpu.export``).

Maps two reference surfaces:
- ``KerasWrapper.to_disk`` whole-model saving (reference:
  lidbox/models/keras_utils.py:182-185): ``save_model`` / ``load_model``
  write and read the JAX package's deployment directory, ``model.json``
  (the architecture spec) and ``variables.msgpack`` (the weights in
  flax's layout and msgpack format, ``train.serialization``), so a
  directory written by either package loads in the other;
- the TF.js stats-pooling shim for browser deployment of trained
  x-vectors (reference: lidbox/models/xvector_stats_pooling.js), whose
  analogue in the JAX package is an ahead-of-time StableHLO forward:
  ``export_program`` / ``load_program`` here save and load a
  ``torch.export`` program of the forward (``forward.pt2``), runnable
  without the model's Python code.
"""
import json
import os

import torch

import lidbox_tpu_torch.models as model_registry
from lidbox_tpu_torch import get_logger
from lidbox_tpu_torch.models.model_api import params_from_flax, params_to_flax
from lidbox_tpu_torch.train.serialization import msgpack_restore, to_bytes

logger = get_logger("export")

SPEC_NAME = "model.json"
WEIGHTS_NAME = "variables.msgpack"
PROGRAM_NAME = "forward.pt2"


def save_model(model, model_key, directory, model_kwargs=None):
    """Save a Model (architecture spec + weights) to a directory."""
    os.makedirs(directory, exist_ok=True)
    spec = {
        "model_key": model_key,
        "input_shape": list(model.input_shape),
        "name": model.name,
        "output": model.output,
        "kwargs": model_kwargs or {},
    }
    with open(os.path.join(directory, SPEC_NAME), "w", encoding="utf-8") as f:
        json.dump(spec, f, indent=2)
    variables = {"params": params_to_flax(dict(model.module.named_parameters()))}
    buffers = dict(model.module.named_buffers())
    if buffers:
        variables["batch_stats"] = params_to_flax(buffers)
    with open(os.path.join(directory, WEIGHTS_NAME), "wb") as f:
        f.write(to_bytes(variables))
    logger.info("Saved model '%s' to %s", model_key, directory)
    return directory


def load_model(directory, num_outputs=None, device="cuda"):
    """Rebuild a saved Model with its weights on ``device``."""
    with open(os.path.join(directory, SPEC_NAME), encoding="utf-8") as f:
        spec = json.load(f)
    kwargs = dict(spec.get("kwargs", {}))
    if num_outputs is None:
        num_outputs = kwargs.pop("num_outputs", None)
    else:
        kwargs.pop("num_outputs", None)
    model = model_registry.create(spec["model_key"],
                                  tuple(spec["input_shape"]),
                                  num_outputs, device=device, **kwargs)
    with open(os.path.join(directory, WEIGHTS_NAME), "rb") as f:
        variables = msgpack_restore(f.read())
    state = params_from_flax(variables["params"])
    state.update(params_from_flax(variables.get("batch_stats") or {}))
    model.module.load_state_dict(state)
    if spec.get("output") and spec["output"] != "logits":
        model = model.with_output(spec["output"])
    return model


class _Forward(torch.nn.Module):
    """The inference forward with the Model's head, as one module."""

    def __init__(self, module, output):
        super().__init__()
        self.module = module
        self.output = output

    def forward(self, x):
        return self.module(x, output=self.output)


def export_program(model, directory, batch_size=None):
    """Export the inference forward ahead of time with ``torch.export`` and
    save it as ``forward.pt2``.

    ``batch_size=None`` (default) exports a symbolic batch dimension: one
    program serves every batch size. Every None in the model's
    ``input_shape`` gets a symbolic dimension too, whose least size
    ``torch.export`` derives from the trace (7 frames for the x-vector:
    its strided convolutions must leave more than one frame to pool). Pass
    a concrete int for models whose trace needs a static batch."""
    dims = {}
    if batch_size is None:
        dims[0] = torch.export.Dim("batch")
    shape = [2 if batch_size is None else int(batch_size)]
    for i, d in enumerate(model.input_shape):
        if d is None:
            dims[i + 1] = torch.export.Dim.AUTO
            d = 64
        shape.append(int(d))
    example = torch.zeros(shape, dtype=torch.float32, device=model.device)
    forward = _Forward(model.module, model.output).eval()
    try:
        with torch.no_grad():
            program = torch.export.export(
                forward, (example,),
                dynamic_shapes={"x": dims} if dims else None)
    except Exception as e:
        if batch_size is None:
            raise RuntimeError(
                f"symbolic-batch export failed ({type(e).__name__}: {e}) — "
                f"this model's trace may need a static batch; retry "
                f"with export_program(..., batch_size=N)") from e
        raise
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, PROGRAM_NAME)
    torch.export.save(program, path)
    logger.info("Exported the forward to %s (batch %s, device %s)", path,
                "symbolic" if batch_size is None else batch_size,
                model.device)
    return path


def load_program(path):
    """A saved program as a callable module: float32 tensors [B, ...] on
    the device it was exported on -> the model's outputs."""
    return torch.export.load(path).module()
