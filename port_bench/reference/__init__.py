"""
The benchmark's frozen plain reference: what a cell's output should be,
worked out from the benchmark's own inputs in plain PyTorch and NumPy.

It imports nothing of the measured package and nothing of the JAX one, and
takes nothing the program made: it quantizes a staged corpus to 16-bit
PCM itself, and recomputes
the log-Mel, the energy VAD, the models, the loss, the gradients and Adam
from the definitions. It runs in float64 on whatever device it is handed;
TF32 does not touch float64 products.

Modules: ``wav`` (16-bit PCM values), ``logmel`` (periodic Hann, 512-point DFT, HTK
mel, ``log(x + 1e-6)``), ``vad`` (energy VAD with voiced windows compacted),
``nn`` (the layers, the loss and Adam), one module per plain model
(``xvector``, ``bi_gru``: ``param_specs(config)``, ``forward`` and
``macs(config, frames)``), found by name (``model``), and ``train`` (the
first steps of training).
"""
import importlib


def model(name):
    """The plain model module ``<name>.py`` of this package, so that a
    configuration names its model and a new one is a file of its own."""
    return importlib.import_module(f"{__name__}.{name}")
