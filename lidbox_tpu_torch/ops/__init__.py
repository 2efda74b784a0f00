"""The port's CUDA kernels and their plain PyTorch versions: the fused
log-Mel (``logmel``) and ECAPA-TDNN's TDNN tail (``tdnn_norm``)."""
from .logmel import fused_logmel, logmel_plain  # noqa: F401
