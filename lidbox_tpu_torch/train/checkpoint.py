"""
Checkpointing with the reference's best-by-metric filename semantics
(counterpart of ``lidbox_tpu.train.checkpoint``).

The reference stored Keras weights as
``epoch{epoch:06d}__val_loss{val_loss:.12f}.hdf5`` and selected/resumed by
parsing metric values back out of filenames
(reference: lidbox/models/keras_utils.py:41-42, 58, 102-118, 187-203).
Here a checkpoint is one ``torch.save`` file of the train state (step,
params, batch stats, optimizer state) under the JAX package's name scheme
and ``.ckpt`` suffix, so best-checkpoint selection and ``initial_epoch``
resume behave identically. Writes go through a temp file + rename so a
crashed run never leaves a torn checkpoint.

Not ported yet (ROADMAP queue 1, item 6): the Orbax directory backend, and
reading the JAX package's msgpack ``.ckpt`` files; both raise.
"""
import os
import tempfile

import numpy as np
import torch

from lidbox_tpu_torch import get_logger

logger = get_logger("train.checkpoint")

CHECKPOINT_SUFFIX = ".ckpt"
DEFAULT_FORMAT = "epoch{epoch:06d}__val_loss{val_loss:.12f}" + CHECKPOINT_SUFFIX
STATE_KEYS = ("step", "params", "batch_stats", "opt_state")


def parse_checkpoint_value(path, key):
    """Parse the value following ``key`` from a checkpoint filename
    (reference: keras_utils.py:41-42)."""
    return (os.path.basename(path).split(key)[-1]
            .split("__")[0].split(CHECKPOINT_SUFFIX)[0])


def get_best_checkpoint_path(checkpoints_dir, key=None, mode=None):
    """Best checkpoint by parsed filename value: greatest epoch when key is
    "epoch"/None, else min/max of the monitored metric
    (reference: keras_utils.py:102-118). Selects over ``.ckpt`` files and
    checkpoint directories (``epoch...`` dirs, the JAX package's Orbax
    layout) alike, as the JAX package does."""
    if key is None:
        key = "epoch"
    if not os.path.isdir(checkpoints_dir):
        return None
    ckpts = [p.path for p in os.scandir(checkpoints_dir)
             if (p.is_file() and p.name.endswith(CHECKPOINT_SUFFIX))
             or (p.is_dir() and p.name.startswith("epoch")
                 # skip uncommitted async-orbax writes from a killed run
                 and ".orbax-checkpoint-tmp" not in p.name)]
    if not ckpts:
        return None
    if key == "epoch":
        return max(ckpts, key=lambda p: int(parse_checkpoint_value(p, key)))
    if mode not in ("min", "max"):
        raise ValueError(f"mode must be min or max, got {mode}")
    # NaN metric values (diverged epochs write val_lossnan filenames) must
    # never win: min()/max() against NaN depend on the scan order
    finite = [p for p in ckpts
              if np.isfinite(float(parse_checkpoint_value(p, key)))]
    if not finite:
        logger.warning("all %d checkpoints in %s have non-finite %r; "
                       "falling back to the greatest epoch",
                       len(ckpts), checkpoints_dir, key)
        return max(ckpts,
                   key=lambda p: int(parse_checkpoint_value(p, "epoch")))
    pick = min if mode == "min" else max
    return pick(finite, key=lambda p: float(parse_checkpoint_value(p, key)))


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(checkpoints_dir, state, epoch, val_loss=0.0,
                    fmt=DEFAULT_FORMAT):
    """Write a train state (any object with the ``STATE_KEYS`` attributes)
    atomically, its tensors copied to the host; returns the path."""
    os.makedirs(checkpoints_dir, exist_ok=True)
    path = os.path.join(checkpoints_dir,
                        fmt.format(epoch=epoch, val_loss=float(val_loss)))
    payload = _to_cpu({k: getattr(state, k) for k in STATE_KEYS})
    fd, tmp = tempfile.mkstemp(dir=checkpoints_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    logger.info("Saved checkpoint %s (%d bytes)", path, os.path.getsize(path))
    return path


def load_raw_checkpoint(path):
    """A checkpoint as a dict of its ``STATE_KEYS``, tensors on the CPU."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is an Orbax checkpoint directory; the Orbax backend is "
            "not ported yet (ROADMAP queue 1, item 6)")
    with open(path, "rb") as f:
        if f.read(2) != b"PK":  # torch.save writes a zip archive
            raise NotImplementedError(
                f"{path} is not a torch.save checkpoint (the JAX package's "
                "msgpack checkpoints are not read yet, ROADMAP queue 1, "
                "item 6)")
    return torch.load(path, map_location="cpu", weights_only=True)


def _restore_into(target, value, where):
    """``value`` in the structure of ``target``, each tensor on the device
    and in the dtype of the target's tensor at the same place."""
    if isinstance(target, torch.Tensor):
        if not isinstance(value, torch.Tensor) or value.shape != target.shape:
            raise ValueError(f"checkpoint {where}: expected a tensor of shape "
                             f"{tuple(target.shape)}, got {value!r:.80}")
        return value.to(device=target.device, dtype=target.dtype)
    if isinstance(target, dict):
        if not isinstance(value, dict) or set(value) != set(target):
            raise ValueError(f"checkpoint {where}: keys differ from the "
                             "train state's")
        return {k: _restore_into(target[k], value[k], f"{where}.{k}")
                for k in target}
    if isinstance(target, (list, tuple)):
        if not isinstance(value, (list, tuple)) or len(value) != len(target):
            raise ValueError(f"checkpoint {where}: length differs from the "
                             "train state's")
        return type(target)(_restore_into(t, v, f"{where}[{i}]")
                            for i, (t, v) in enumerate(zip(target, value)))
    return value


def restore_checkpoint(path, target):
    """Restore a checkpoint into the structure of ``target`` (a train
    state with ``replace``); raises when the structures differ."""
    raw = load_raw_checkpoint(path)
    return target.replace(**{k: _restore_into(getattr(target, k), raw[k], k)
                             for k in STATE_KEYS})


def initial_epoch_from_path(path):
    """Epoch to resume from, parsed out of the checkpoint name
    (reference: keras_utils.py:187-189)."""
    return int(parse_checkpoint_value(path, "epoch"))
