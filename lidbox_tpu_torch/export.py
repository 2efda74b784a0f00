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
  without the model's Python code. As the JAX package's ``platforms``
  embeds lowerings for several backends in one artifact, ``platforms``
  here names the torch devices one program deploys to: each is checked
  against the live model before the file is written, recorded in it, and
  ``load_program`` moves the program to any of them.
"""
import copy
import json
import os

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

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


PLATFORMS_FILE = "platforms.json"  # an extra file inside forward.pt2
# JAX platform names -> torch device types; a TPU has no torch device
PLATFORM_NAMES = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}
# a moved program against the live model on the same device: the same
# kernels, so float32 agrees to its rounding
PLATFORM_ATOL = PLATFORM_RTOL = 1e-5


def torch_platforms(platforms):
    """Platform names (``cuda``, ``cpu``, or the JAX names ``gpu`` and
    ``cpu``) -> torch device types, in order, without repeats."""
    out = []
    for name in platforms:
        name = name.strip().lower()
        if name == "tpu":
            raise ValueError("--platforms: this package exports torch "
                             "programs, which run on cuda and cpu, not tpu")
        if name not in PLATFORM_NAMES:
            raise ValueError(f"--platforms: unknown platform {name!r} "
                             f"(expected one of {sorted(PLATFORM_NAMES)})")
        if PLATFORM_NAMES[name] not in out:
            out.append(PLATFORM_NAMES[name])
    if not out:
        raise ValueError("--platforms names no platform")
    return out


def export_program(model, directory, batch_size=None, platforms=None):
    """Export the inference forward ahead of time with ``torch.export`` and
    save it as ``forward.pt2``.

    ``batch_size=None`` (default) exports a symbolic batch dimension: one
    program serves every batch size. Every None in the model's
    ``input_shape`` gets a symbolic dimension too, whose least size
    ``torch.export`` derives from the trace (7 frames for the x-vector:
    its strided convolutions must leave more than one frame to pool). Pass
    a concrete int for models whose trace needs a static batch.

    ``platforms`` (torch device types, e.g. ``("cuda", "cpu")``; default
    the model's device) are the devices the program deploys to: before
    the file is written, the program moved to each must reproduce the
    live model, moved there too, on a seeded batch (within PLATFORM_ATOL
    + PLATFORM_RTOL), and the list is saved in the file."""
    platforms = torch_platforms(platforms or [model.device.type])
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
    x = np.random.default_rng(0).normal(0, 1, shape).astype(np.float32)
    for device in platforms:
        _check_platform(program, forward, torch.from_numpy(x), device)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, PROGRAM_NAME)
    torch.export.save(program, path,
                      extra_files={PLATFORMS_FILE: json.dumps(platforms)})
    logger.info("Exported the forward to %s (batch %s, exported on %s, "
                "platforms %s)", path,
                "symbolic" if batch_size is None else batch_size,
                model.device, ",".join(platforms))
    return path


def _program_device(program):
    tensors = list(program.state_dict.values()) + list(program.constants
                                                       .values())
    return next((t.device for t in tensors if isinstance(t, torch.Tensor)),
                torch.device("cpu"))


def _same_device(a, b):
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def _check_platform(program, forward, x, device):
    """Raise unless ``program`` moved to ``device`` reproduces ``forward``
    (the live model) moved there."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--platforms names cuda, but CUDA is not "
                           "available here to check the program on it")
    moved = program
    if not _same_device(_program_device(program), device):
        moved = move_to_device_pass(program, device)
    live = forward
    if not _same_device(next(forward.parameters()).device, device):
        live = copy.deepcopy(forward).to(device)
    with torch.no_grad():
        got = moved.module()(x.to(device))
        ref = live(x.to(device))
    if not torch.allclose(got, ref, atol=PLATFORM_ATOL, rtol=PLATFORM_RTOL):
        raise RuntimeError(f"the exported program on {device} differs from "
                           f"the live model by "
                           f"{(got - ref).abs().max().item():.3e}")


def load_program(path, device=None):
    """A saved program as a callable module on ``device`` (default: the
    device it was exported on): float32 tensors [B, ...] on that device ->
    the model's outputs. A device whose type the export did not name in
    its ``platforms`` is refused."""
    extra = {PLATFORMS_FILE: ""}
    program = torch.export.load(path, extra_files=extra)
    exported_on = _program_device(program)
    platforms = (json.loads(extra[PLATFORMS_FILE]) if extra[PLATFORMS_FILE]
                 else [exported_on.type])
    device = torch.device(device) if device is not None else exported_on
    if device.type not in platforms:
        raise ValueError(f"{path} was exported for {platforms}, not "
                         f"{device.type} (export it with --platforms)")
    if not _same_device(device, exported_on):
        program = move_to_device_pass(program, device)
    return program.module()
