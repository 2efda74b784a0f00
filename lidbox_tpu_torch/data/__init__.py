"""
Data pipeline of the port: host streaming Dataset, the step registry and
batched device featurization (counterpart of ``lidbox_tpu.data``).
"""
from .dataset import Dataset, padded_batch  # noqa: F401
from .device_pipeline import DeviceFeatureExtractor  # noqa: F401
from .steps import Step, VALID_STEP_FUNCTIONS, from_steps, pre_initialize  # noqa: F401
