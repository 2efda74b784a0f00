"""
Model zoo with the reference's per-module contract:
``create(input_shape, num_outputs, **kw) -> Model`` and optional
``as_embedding_extractor(model)`` (counterpart of ``lidbox_tpu.models``).

Every key of the JAX package's registry is ported (``PORTED_KEYS``); the
port adds keys of its own (``PORT_ONLY_KEYS``: ECAPA-TDNN), which the JAX
package lacks. ``MODEL_KEYS`` is both.
"""
import importlib

PORTED_KEYS = (
    "ap_lstm",
    "bi_gru",
    "clstm",
    "cnn",
    "convnet_extractor",
    "crnn",
    "dnn",
    "lstm",
    "multilevel_attention",
    "spherespeaker",
    "xvector",
    "xvector_2d",
    "xvector_extended",
    "xvector_freq_attention",
)
PORT_ONLY_KEYS = (
    "ecapa_tdnn",
)
MODEL_KEYS = PORTED_KEYS + PORT_ONLY_KEYS


def get_module(key):
    """Import the model module for a config key."""
    if key not in MODEL_KEYS:
        raise KeyError(f"unknown model key {key!r}; valid: {MODEL_KEYS}")
    return importlib.import_module(f"lidbox_tpu_torch.models.{key}")


def create(key, input_shape, num_outputs, **kwargs):
    """Build a model by registry key (``device=`` defaults to "cuda")."""
    return get_module(key).create(input_shape, num_outputs=num_outputs, **kwargs)


def as_embedding_extractor(key, model):
    """The module's embedding-extractor transform (the generic
    pre-activation-output transform where the module has none)."""
    mod = get_module(key)
    if hasattr(mod, "as_embedding_extractor"):
        return mod.as_embedding_extractor(model)
    from .model_api import as_embedding_extractor as _generic
    return _generic(model)
