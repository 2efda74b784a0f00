"""
Embedding back-end: self-contained PLDA and a numpy classifier pipeline
(counterpart of ``lidbox_tpu.embed``; reference subsystem: lidbox/embed/).
"""
from .plda import PLDA  # noqa: F401
