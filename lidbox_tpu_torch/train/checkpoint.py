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

The JAX package's checkpoints read too, both its msgpack ``.ckpt`` files
(``flax.serialization``) and its Orbax directories (``train/orbax.py``):
``load_raw_checkpoint`` converts their parameters, batch statistics and
optax state to this port's train state, so a model trained by the JAX
package resumes, evaluates and serves here. ``OrbaxCheckpointer`` writes
Orbax directories (the JAX package's key paths and dtypes) from a writer
thread, and the JAX package restores them.
"""
import os
import shutil
import tempfile
import threading
import time

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
    return _best_of(checkpoints_dir, lambda entry: (
        entry.is_file() and entry.name.endswith(CHECKPOINT_SUFFIX))
        or _is_orbax_dir(entry), key, mode)


def _is_orbax_dir(entry):
    """An ``epoch...`` checkpoint directory; an uncommitted async-orbax
    write from a killed run is none."""
    return (entry.is_dir() and entry.name.startswith("epoch")
            and ".orbax-checkpoint-tmp" not in entry.name)


def _best_of(checkpoints_dir, candidate, key, mode):
    """The best of the entries of ``checkpoints_dir`` that ``candidate``
    takes, by ``key`` (None when there are none)."""
    if key is None:
        key = "epoch"
    if not os.path.isdir(checkpoints_dir):
        return None
    ckpts = [p.path for p in os.scandir(checkpoints_dir) if candidate(p)]
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


def load_raw_checkpoint(path, params=None):
    """A checkpoint as a dict of its ``STATE_KEYS``, tensors on the CPU.

    Reads this port's ``torch.save`` files and, from either package,
    msgpack files and Orbax directories. A JAX train state converts on
    the way: its parameters and batch statistics through
    ``params_from_flax``, its optax state through
    ``opt_state_from_optax`` with the moments listed in the order of
    ``params`` (a name -> tensor dict; default the checkpoint's own order),
    and its step to an int."""
    if os.path.isdir(path):
        from lidbox_tpu_torch.train.orbax import read_checkpoint
        return _from_jax_state(read_checkpoint(path), path, params)
    with open(path, "rb") as f:
        head = f.read(2)
    if head == b"PK":  # torch.save writes a zip archive
        return torch.load(path, map_location="cpu", weights_only=True)
    if head[:1] and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        from lidbox_tpu_torch.train.serialization import msgpack_restore
        with open(path, "rb") as f:
            return _from_jax_state(msgpack_restore(f.read()), path, params)
    raise ValueError(f"{path} is neither a torch.save checkpoint nor a "
                     "msgpack state dict")


def _from_jax_state(raw, path, params):
    """A JAX package train state, as its msgpack state dict or its Orbax
    raw tree, as this port's raw state."""
    from lidbox_tpu_torch.models.model_api import params_from_flax
    from lidbox_tpu_torch.train.optimizers import opt_state_from_optax
    missing = [k for k in STATE_KEYS if k not in raw]
    if missing:
        raise ValueError(f"{path}: not a train state (missing {missing})")
    state = {"step": int(np.asarray(raw["step"])),
             "params": params_from_flax(raw["params"]),
             "batch_stats": params_from_flax(raw["batch_stats"] or {})}
    order = state["params"] if params is None else params
    state["opt_state"] = opt_state_from_optax(raw["opt_state"], order)
    return state


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
    raw = load_raw_checkpoint(path, params=target.params)
    return target.replace(**{k: _restore_into(getattr(target, k), raw[k], k)
                             for k in STATE_KEYS})


def jax_state_tree(state):
    """A train state as the JAX package's ``TrainState`` tree (as Orbax
    restores it raw), on the host: the inverse of ``load_raw_checkpoint``'s
    conversion, copied off the state's tensors."""
    from lidbox_tpu_torch.models.model_api import params_to_flax
    from lidbox_tpu_torch.train.optimizers import opt_state_to_optax
    return {"step": np.asarray(int(state.step), np.int32),
            "params": params_to_flax(state.params),
            "batch_stats": params_to_flax(state.batch_stats),
            "opt_state": opt_state_to_optax(state.opt_state,
                                            list(state.params))}


class OrbaxCheckpointer:
    """Orbax checkpoint directories under the best-by-metric names (the
    JAX package's ``OrbaxCheckpointer``): ``epoch{epoch:06d}__val_loss
    {val_loss:.12f}``, a directory the JAX package's ``restore_checkpoint``
    and ``load_raw_checkpoint`` read.

    ``save`` copies the state to the host and converts it to the JAX
    package's tree at once, then writes from a writer thread (with
    ``use_async``), into ``<name>.orbax-checkpoint-tmp-<n>``, renamed into
    place when complete: a killed run leaves only a tmp entry, which
    best-checkpoint selection skips. One write runs at a time; ``wait``
    drains it and raises what it raised."""

    def __init__(self, use_async=True):
        self.use_async = use_async
        self._thread = None
        self._error = None

    def save(self, checkpoints_dir, state, epoch, val_loss=0.0):
        name = DEFAULT_FORMAT.format(epoch=epoch, val_loss=float(val_loss))
        name = name[:-len(CHECKPOINT_SUFFIX)]  # orbax uses a directory
        path = os.path.abspath(os.path.join(checkpoints_dir, name))
        os.makedirs(checkpoints_dir, exist_ok=True)
        tree = jax_state_tree(state)
        self.wait()
        if not self.use_async:
            _commit(path, tree)
            return path
        self._thread = threading.Thread(target=self._run, args=(path, tree),
                                        name="orbax-writer", daemon=True)
        self._thread.start()
        return path

    def _run(self, path, tree):
        try:
            _commit(path, tree)
        except BaseException as e:  # raised again by wait()
            self._error = e

    def restore(self, path, target=None):
        """The raw state (``target=None``) or ``target`` restored."""
        if target is None:
            return load_raw_checkpoint(path)
        return restore_checkpoint(path, target)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        if error is not None:
            raise error

    @staticmethod
    def best_checkpoint_path(checkpoints_dir, key=None, mode=None):
        """``get_best_checkpoint_path`` over the Orbax directories alone
        (``epoch*``, tmp entries skipped; ``.ckpt`` files are no
        candidates): the greatest epoch when ``key`` is "epoch" or None,
        else the min or max of the parsed ``key``. A NaN value never wins
        (the JAX package's method lets the scan order decide); when every
        value is NaN, the greatest epoch."""
        return _best_of(checkpoints_dir, _is_orbax_dir, key, mode)


def _commit(path, tree):
    """Write ``tree`` beside ``path`` and rename it into place (replacing
    an older checkpoint of the same name, as Orbax's ``force=True``)."""
    from lidbox_tpu_torch.train.orbax import write_checkpoint
    started = time.perf_counter()
    tmp = f"{path}.orbax-checkpoint-tmp-{time.time_ns()}"
    write_checkpoint(tmp, tree)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    logger.info("Saved checkpoint %s (%.3f s)", path,
                time.perf_counter() - started)


def initial_epoch_from_path(path):
    """Epoch to resume from, parsed out of the checkpoint name
    (reference: keras_utils.py:187-189)."""
    return int(parse_checkpoint_value(path, "epoch"))
