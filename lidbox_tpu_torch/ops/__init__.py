"""Fused log-Mel kernel (CUDA) and its plain PyTorch version."""
from .logmel import fused_logmel, logmel_plain  # noqa: F401
