"""
Model zoo with the reference's per-module contract:
``create(input_shape, num_outputs, **kw) -> Model`` and optional
``as_embedding_extractor(model)`` (counterpart of ``lidbox_tpu.models``).

Only ``"xvector"`` is ported; the other keys of the JAX package raise
``NotImplementedError`` until their slice (ROADMAP queue 1, item 9).
"""
import importlib

MODEL_KEYS = (
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
PORTED_KEYS = ("xvector",)


def get_module(key):
    """Import the model module for a config key."""
    if key not in MODEL_KEYS:
        raise KeyError(f"unknown model key {key!r}; valid: {MODEL_KEYS}")
    if key not in PORTED_KEYS:
        raise NotImplementedError(
            f"model {key!r} is not ported yet (ROADMAP queue 1, item 9); "
            f"ported: {PORTED_KEYS}")
    return importlib.import_module(f"lidbox_tpu_torch.models.{key}")


def create(key, input_shape, num_outputs, **kwargs):
    """Build a model by registry key (``device=`` defaults to "cuda")."""
    return get_module(key).create(input_shape, num_outputs=num_outputs, **kwargs)


def as_embedding_extractor(key, model):
    """The module's embedding-extractor transform."""
    return get_module(key).as_embedding_extractor(model)
