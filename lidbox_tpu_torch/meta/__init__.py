"""
Metadata layer: tables (dicts of columns) with required columns ``id,
path, label, split`` (counterpart of ``lidbox_tpu.meta``, whose tables are
pandas DataFrames indexed by utterance id; reference: lidbox/meta/
__init__.py, lidbox/meta/utils.py:14-18).
"""
from .utils import (  # noqa: F401
    REQUIRED_COLUMNS,
    generate_label2target,
    random_oversampling,
    random_oversampling_on_split,
    random_undersampling,
    random_undersampling_on_split,
    read_audio_durations,
    read_csv,
    set_unique_index,
    verify_integrity,
)
