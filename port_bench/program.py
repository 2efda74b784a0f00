"""Where the benchmark meets the measured package, ``lidbox_tpu_torch``:
its configuration sections built from a benchmark configuration, its models
loaded with the benchmark's weights, and the kernel shapes it launched.
Nothing else of the benchmark imports the package."""
import contextlib
import functools
import importlib

import torch

from port_bench import common, reference


def reference_model(config):
    """The plain model that the configuration's ``reference`` names."""
    return reference.model(config["reference"])


def labels(config):
    return [f"lang{i:02d}" for i in range(config["num_outputs"])]


def feature_config(config):
    """The package's ``features`` section for the configuration."""
    f = config["features"]
    return {"type": "logmelspectrogram",
            "spectrogram": {"frame_length_ms": f["frame_length_ms"],
                            "frame_step_ms": f["frame_step_ms"],
                            "fft_length": f["fft_length"]},
            "melspectrogram": {"num_mel_bins": f["num_mel_bins"],
                               "fmin": f["fmin"], "fmax": f["fmax"]},
            "stft_method": f["stft_method"], "precision": f["precision"]}


def train_config(config, traffic, cache_dir):
    """The package's whole configuration for ``fit_fused``: the features
    with the traffic's on-device augmentation and feed, the model, Adam,
    the loss; no metrics, callbacks or checkpoints."""
    opt = config["optimizer"]
    return {
        "features": dict(feature_config(config),
                         sample_rate=config["features"]["sample_rate"],
                         on_device_augment=dict(traffic["on_device_augment"])),
        "experiment": {
            "cache_directory": cache_dir, "name": "port_bench",
            "input_shape": [None, config["features"]["num_mel_bins"]],
            "output_shape": [config["num_outputs"]],
            "model": {"key": config["model"]},
            "optimizer": {"cls": opt["cls"], "kwargs": {
                k: opt[k] for k in ("learning_rate", "beta_1", "beta_2",
                                    "epsilon")}},
            "loss": {"cls": "SparseCategoricalCrossentropy"},
            "metrics": [], "callbacks": [],
            "feed": dict(traffic["feed"])}}


def load_weights(module, weights):
    """The benchmark's weights into ``module``, every name and shape
    matching."""
    with torch.no_grad():
        module.load_state_dict(weights, strict=True)


def model(config, weights, device):
    """The package's model of the configuration, holding ``weights``."""
    from lidbox_tpu_torch import models
    m = models.create(config["model"],
                      (None, config["features"]["num_mel_bins"]),
                      config["num_outputs"], device=device.type)
    load_weights(m.module, weights)
    return m


def weights(config, seed, device):
    return common.make_weights(reference_model(config).param_specs(config),
                               seed, device)


@contextlib.contextmanager
def kernel_shapes(shapes):
    """Within it, the [batch, samples] of every ``fused_logmel`` call that
    runs in Python (eagerly, or while a graph is captured) go into the set
    ``shapes``."""
    from lidbox_tpu_torch.ops import logmel
    launch = logmel.fused_logmel

    def recording(signals, *args, **kwargs):
        shapes.add(tuple(signals.shape))
        return launch(signals, *args, **kwargs)
    logmel.fused_logmel = recording
    try:
        yield shapes
    finally:
        logmel.fused_logmel = launch


def fused_logmel(signals, config):
    """The package's public log-Mel call on ``signals`` with the
    configuration's features."""
    from lidbox_tpu_torch.ops import logmel
    f = config["features"]
    return logmel.fused_logmel(
        signals, f["sample_rate"], frame_length_ms=f["frame_length_ms"],
        frame_step_ms=f["frame_step_ms"], fft_length=f["fft_length"],
        num_mel_bins=f["num_mel_bins"], fmin=f["fmin"], fmax=f["fmax"],
        precision=f["precision"])


def vad_lengths(signals, sample_rate, vad):
    """The samples the package's energy VAD keeps of each row of a [B, T]
    float tensor (a diagnostic beside the check)."""
    from lidbox_tpu_torch.data import on_device
    lengths = torch.full((signals.shape[0],), signals.shape[1],
                         device=signals.device)
    _, kept = on_device.energy_vad_compact_batch(
        signals.float(), lengths, sample_rate, frame_ms=vad["frame_ms"],
        min_non_speech_ms=vad["min_non_speech_ms"],
        strength=vad["strength"])
    return kept.tolist()


@contextlib.contextmanager
def host_spans(names):
    """Within it, each package function named "module:qualname" runs inside
    a ``torch.profiler.record_function`` span of its qualname, so a traced
    stretch names the host work that leaves the device idle."""
    undo = []
    try:
        for name in names:
            module_name, qualname = name.split(":")
            owner = importlib.import_module(module_name)
            *path, attr = qualname.split(".")
            for part in path:
                owner = getattr(owner, part)
            fn = getattr(owner, attr)

            def spanned(*args, _fn=fn, _name=qualname, **kwargs):
                with torch.profiler.record_function(_name):
                    return _fn(*args, **kwargs)
            functools.update_wrapper(spanned, fn)
            setattr(owner, attr, spanned)
            undo.append((owner, attr, fn))
        yield
    finally:
        for owner, attr, fn in reversed(undo):
            setattr(owner, attr, fn)
