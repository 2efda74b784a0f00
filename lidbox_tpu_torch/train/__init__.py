"""
Training subsystem: hand-written optimizer updates, the loop, checkpoints,
observability (counterpart of ``lidbox_tpu.train``).
"""
from .checkpoint import (  # noqa: F401
    get_best_checkpoint_path,
    initial_epoch_from_path,
    parse_checkpoint_value,
    restore_checkpoint,
    save_checkpoint,
)
from .loop import (  # noqa: F401
    Callback,
    EarlyStopping,
    LearningRateDateLogger,
    ModelCheckpoint,
    Trainer,
    TrainState,
    batches_from_dataset,
    signal_batches_from_dataset,
)
from .optimizers import (  # noqa: F401
    opt_state_from_optax,
    optimizer_from_config,
    schedule_from_config,
)
