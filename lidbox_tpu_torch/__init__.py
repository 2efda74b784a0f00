"""
lidbox_tpu_torch — the PyTorch/CUDA port of lidbox_tpu.

A second package beside ``lidbox_tpu`` (the JAX reference it is tested
against). Its modules keep the reference's structure and names; inside,
plain tensor code is PyTorch and the JAX package's Pallas kernel is a CUDA
C++ kernel for Hopper (``ops/logmel.py`` + ``csrc/logmel.cu``).

The package imports torch, numpy and scipy only: nothing of jax, flax or
lidbox_tpu (it keeps its own copies of the jax-free helpers it needs).

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``
and raises when CUDA is absent and the caller did not ask for ``"cpu"``.

Environment variables (as in lidbox_tpu):
- ``LIDBOX_RANDOM_SEED``: global RNG seed (default 42).
- ``LIDBOX_DEBUG``: verbose logging.
"""
import logging
import os
import sys

import torch

__version__ = "0.1.0"

RANDOM_SEED = int(os.environ.get("LIDBOX_RANDOM_SEED", 42))
DEBUG = bool(os.environ.get("LIDBOX_DEBUG", False))


class _MaxLevelFilter(logging.Filter):
    """Pass only records at or below a maximum level (INFO -> stdout)."""

    def __init__(self, max_level):
        super().__init__()
        self.max_level = max_level

    def filter(self, record):
        return record.levelno <= self.max_level


def _configure_logging(level):
    """INFO and below to stdout, WARNING and above to stderr
    (reference: lidbox/__init__.py:20-35)."""
    logger = logging.getLogger("lidbox_tpu_torch")
    logger.handlers.clear()
    fmt = logging.Formatter(
        fmt="%(asctime)s.%(msecs)03d %(name)s %(levelname)s: %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")
    out = logging.StreamHandler(sys.stdout)
    out.setLevel(logging.DEBUG)
    out.addFilter(_MaxLevelFilter(logging.INFO))
    out.setFormatter(fmt)
    err = logging.StreamHandler(sys.stderr)
    err.setLevel(logging.WARNING)
    err.setFormatter(fmt)
    logger.addHandler(out)
    logger.addHandler(err)
    logger.setLevel(level)
    return logger


_logger = _configure_logging(logging.DEBUG if DEBUG else logging.INFO)


def get_logger(name=None):
    return _logger if name is None else _logger.getChild(name)


def reset_global_loglevel(level):
    """Set the loglevel of the package's logger (a ``logging`` level or
    its name, e.g. ``"debug"``); its children follow it."""
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    _logger.setLevel(level)


def get_package_root():
    """The directory of this package."""
    return os.path.dirname(os.path.abspath(__file__))


def iter_metadata_file(path, num_columns):
    """Iterate rows of a space-separated metadata file, yielding tuples of
    the first ``num_columns`` columns (reference lidbox/__init__.py:41-46)."""
    with open(path, encoding="utf-8") as f:
        for line in f:
            cols = line.strip().split(" ", num_columns - 1)
            if len(cols) == num_columns:
                yield tuple(cols)


def get_device(device="cuda"):
    """``device`` as a torch.device; raises when CUDA is requested but
    absent (entry points never fall back to the CPU silently)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device
