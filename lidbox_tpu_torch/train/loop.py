"""
The training loop: hand-written optimizer updates, eager PyTorch steps and
checkpoint hooks (counterpart of ``lidbox_tpu.train.loop``).

Replaces the reference's Keras ``compile``/``fit`` path
(reference: lidbox/models/keras_utils.py:124-149, 191-203) with an explicit
functional loop, as the JAX package does:

- TrainState (step, params, batch_stats, opt_state): the float32 master
  parameters are a dict name -> tensor apart from the module's own,
- one train step: the forward runs on the state's tensors through
  ``torch.func.functional_call``, ``torch.autograd.grad`` takes the
  gradients, the optimizer (``train/optimizers.py``) the update. ``fit``
  runs the donating form of the step through a ``graphs.StepProgram``,
  the JAX package's jitted step with ``donate_argnums``: on the card one
  CUDA graph replay a step, which writes the new state into the tensors of
  the old one; on the CPU the same step eagerly, as a mesh of several
  ranks runs it on the card. A state ``fit`` trained
  is therefore written in place: copy what must outlive the next step.
  ``_train_step`` is the functional form (new tensors every step), the
  donating step's reference,
- eval steps stream the C_avg metric as counter tensors on the device,
  read back once per evaluation,
- Python callback hooks (ModelCheckpoint, EarlyStopping, LR logger) with
  the reference's best-by-metric checkpoint naming and ``initial_epoch``
  resume.

Host batches reach the device through one ordered prefetch thread (pinned
memory, non_blocking copies on the current stream), optionally compressed
on the host (``stage_dtype``), grouped K to a transfer
(``steps_per_dispatch``), or cached on the device after epoch 1
(``cache_staged``, with ``cache_shuffle`` and a device-memory guard).
Dropout draws from a ``torch.Generator`` the Trainer owns. The module is
put in training mode for a train step only, and back in eval mode after.

With a ``mesh`` (``parallel.get_mesh``) each rank feeds its own rows of
every global batch (``parallel.local_slice`` splits a global feed) and the
steps reproduce the mesh-less step on the concatenated batch: the loss is
the global example-mask mean, the gradients one bucketed all-reduce,
BatchNorm takes the global batch's statistics and every draw is the global
batch's (``parallel.data_parallel``). The state is replicated from rank 0
at creation and at restore, the feed-parity guard makes uneven feeds raise
on every rank, metric states are summed over the ranks, and rank 0 alone
writes checkpoints and the metrics log.

With ``param_sharding`` (``parallel.column_parallel_rule``) over a 2-D
mesh (``parallel.get_mesh_2d``) the state holds this rank's shards of the
split parameters and of their optimizer moments (``parallel.shard_params``
of the full, seeded state, so the trajectory is the mesh-less one), the
forwards run column-parallel (``parallel.tensor_parallel``), the batch
reductions run over the data group of the rank's model column, and
checkpoints, ``sync_model_variables`` and ``restore`` go through the
gathered full state (``checkpoint_state``), in the mesh-less format.

``remat`` recomputes the forward during the backward
(``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``), with
the dropout generator rewound so the recompute draws the forward's masks;
on the card the rewind is one a CUDA graph captures (``_remat_apply``).
"""
import contextlib
import dataclasses
import functools
import queue
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch
import torch.utils.checkpoint

from lidbox_tpu_torch import RANDOM_SEED, get_device, get_logger, parallel
from lidbox_tpu_torch.data.dataset import padded_batch
from lidbox_tpu_torch.models.model_api import functional_forward
from lidbox_tpu_torch.train import checkpoint as ckpt_lib
from lidbox_tpu_torch.train import graphs, observability
from lidbox_tpu_torch.train.observability import MetricsLogger, ThroughputMeter
from lidbox_tpu_torch.train.optimizers import apply_updates, copy_state_

logger = get_logger("train.loop")


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    batch_stats: Any
    opt_state: Any

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


class Callback:
    """Hook protocol replacing Keras callbacks (reference
    keras_utils.py:55-78)."""

    def on_train_begin(self, trainer):
        pass

    def on_epoch_begin(self, trainer, epoch):
        pass

    def on_epoch_end(self, trainer, epoch, logs):
        pass

    def on_train_end(self, trainer):
        pass


class ModelCheckpoint(Callback):
    """Save state each epoch with metric-bearing filenames
    (reference: keras_utils.py:55-64).

    ``backend="msgpack"`` (the JAX package's default name) writes atomic
    single-file ``.ckpt`` checkpoints, here with ``torch.save``;
    ``backend="orbax"`` writes Orbax checkpoint directories that the JAX
    package reads (``ckpt_lib.OrbaxCheckpointer``) from a writer thread,
    drained at train end, under the same metric names, so best-checkpoint
    selection and resume work alike across backends. On a mesh rank 0
    writes before the barrier, so every rank may read the checkpoint
    after it."""

    def __init__(self, checkpoints_dir, monitor="val_loss", mode="min",
                 save_best_only=False, backend="msgpack"):
        if backend not in ("msgpack", "orbax"):
            raise ValueError(f"unknown checkpoint backend {backend!r} "
                             "(expected 'msgpack' or 'orbax')")
        self.checkpoints_dir = checkpoints_dir
        self.monitor = monitor
        self.mode = mode
        self.save_best_only = save_best_only
        self.best = None
        self.backend = backend
        self._orbax = None

    def on_epoch_end(self, trainer, epoch, logs):
        value = logs.get(self.monitor)
        if self.save_best_only:
            if value is None:
                # as Keras: without the monitored metric there is no
                # "best" ordering; warn and skip
                logger.warning(
                    "ModelCheckpoint: monitored metric %r not in epoch "
                    "logs %s; skipping save", self.monitor, sorted(logs))
                return
            if self.best is not None:
                better = (value < self.best if self.mode == "min"
                          else value > self.best)
                if not better:
                    return
            self.best = value
        # filename metric: val_loss when present, else the train loss
        fname_val = logs.get("val_loss", logs.get("loss", 0.0))
        mesh = getattr(trainer, "mesh", None)
        state = trainer.checkpoint_state()  # a collective under sharding
        if mesh is None or mesh.rank == 0:  # one writer of the replicas
            if self.backend == "orbax":
                if self._orbax is None:
                    self._orbax = ckpt_lib.OrbaxCheckpointer(
                        use_async=mesh is None)
                self._orbax.save(self.checkpoints_dir, state, epoch=epoch,
                                 val_loss=fname_val)
            else:
                ckpt_lib.save_checkpoint(self.checkpoints_dir, state,
                                         epoch=epoch, val_loss=fname_val)
        if mesh is not None:
            parallel.barrier(mesh)  # every rank may read it from here on

    def on_train_end(self, trainer):
        if self._orbax is not None:
            self._orbax.wait()  # drain the writer before the caller reads


class EarlyStopping(Callback):
    """Stop training when the monitored metric stops improving by
    ``min_delta`` for ``patience`` epochs (Keras EarlyStopping semantics;
    reference: lidbox/models/keras_utils.py:74-78). State resets on every
    train begin.

    ``restore_best_weights``: when stopping, restore the params and
    batch_stats of the best-monitored epoch, copied when it ended (the
    train steps write into the state's tensors)."""

    def __init__(self, monitor="val_loss", mode="min", patience=5,
                 min_delta=0.0, restore_best_weights=False):
        self.monitor, self.mode = monitor, mode
        self.patience, self.min_delta = patience, min_delta
        self.restore_best_weights = bool(restore_best_weights)
        self.best, self.wait = None, 0
        self._best_state = None

    def on_train_begin(self, trainer):
        self.best, self.wait = None, 0
        self._best_state = None

    def on_epoch_end(self, trainer, epoch, logs):
        value = logs.get(self.monitor)
        if value is None:
            return
        improved = (self.best is None
                    or (value < self.best - self.min_delta if self.mode == "min"
                        else value > self.best + self.min_delta))
        if improved:
            self.best, self.wait = value, 0
            if self.restore_best_weights:
                self._best_state = tuple(
                    {k: v.clone() for k, v in part.items()}
                    for part in (trainer.state.params,
                                 trainer.state.batch_stats))
            return
        self.wait += 1
        if self.wait >= self.patience:
            logger.info("EarlyStopping: no %s improvement in %d epochs",
                        self.monitor, self.patience)
            if self.restore_best_weights and self._best_state is not None:
                params, batch_stats = self._best_state
                trainer.state = trainer.state.replace(
                    params=params, batch_stats=batch_stats)
                logger.info("EarlyStopping: restored best weights "
                            "(%s=%s)", self.monitor, self.best)
            trainer.stop_training = True


class LearningRateDateLogger(Callback):
    """Log the decayed learning rate at each epoch start
    (reference: keras_utils.py:81-93)."""

    def on_epoch_begin(self, trainer, epoch):
        lr = trainer.current_learning_rate()
        logger.info("%s - learning rate: %.8g",
                    time.strftime("%Y-%m-%d %H:%M:%S"), lr)


@contextlib.contextmanager
def _rewound(generator, start):
    """Inside the block ``generator`` draws from ``start``
    (``Trainer._rewind_point``); after it, it stands where it stood
    before."""
    host = generator.device.type == "cpu"
    get = generator.get_state if host else generator.graphsafe_get_state
    put = generator.set_state if host else generator.graphsafe_set_state
    resume = get()
    put(start)
    try:
        yield
    finally:
        put(resume)


def key_seed(*key):
    """The seed of ``keyed_generator(device, *key)``: numpy's SeedSequence
    of the non-negative integers ``key``."""
    return int(np.random.SeedSequence([int(k) for k in key]).generate_state(
        1, np.uint64)[0])


def keyed_generator(device, *key):
    """A ``torch.Generator`` on ``device`` whose seed depends on the
    non-negative integers ``key`` alone (numpy's SeedSequence mixes them),
    as ``jax.random.fold_in`` keys a stream: a train step's augmentation
    generator is keyed (trainer seed, step, 7) and needs no device read.
    A captured step re-seeds one generator with ``key_seed(*key)``
    instead (``graphs.StepProgram``)."""
    return torch.Generator(device=device).manual_seed(key_seed(*key))


def torch_dtype(dtype):
    """A stage dtype given by name ("int16", "bfloat16", ...) or as a torch
    dtype, as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype)
    return getattr(torch, name if name == "bfloat16" else np.dtype(name).name)


def _tree_device_nbytes(tree):
    """Bytes a staged tree (tensors and arrays in dicts, lists and tuples)
    pins: the staged-cache accounting unit, compared against
    _cache_budget_bytes."""
    if isinstance(tree, dict):
        return sum(_tree_device_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_device_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return int(getattr(tree, "nbytes", 0))


def _cache_budget_bytes(limit=None, device=None):
    """Device memory available to ``cache_staged``: ``limit``
    (Trainer.cache_bytes_limit) when given, else on a CUDA device 90% of
    the total less what is in use (``torch.cuda.mem_get_info``), else +inf
    (the CPU)."""
    if limit is not None:
        return float(limit)
    if device is not None and torch.device(device).type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        return 0.9 * float(total) - float(total - free)
    return float("inf")


def _signature_runs_contiguous(sigs):
    """True when every distinct value in ``sigs`` appears as one contiguous
    run: then stack-major cached replay reproduces the original sequence
    exactly (Trainer._consolidate_cache, on_device._consolidate_signal_cache)."""
    runs = 1 + sum(a != b for a, b in zip(sigs, sigs[1:]))
    return runs == len(set(sigs))


def _leaf_signature(value):
    if isinstance(value, torch.Tensor):
        return tuple(value.shape), str(value.dtype)
    value = np.asarray(value)
    return value.shape, value.dtype.str


def _map_moments(opt_state, names, fn):
    """An optimizer state with ``fn(name, tensor)`` applied to every
    per-parameter tensor: the lists of tensors in the params' order
    (``names``) that ``train/optimizers.py`` states hold (Adam's ``mu`` and
    ``nu``, ``trace``, ``sum_of_squares``); counts and empty states pass."""
    if isinstance(opt_state, dict):
        return {k: _map_moments(v, names, fn) for k, v in opt_state.items()}
    if isinstance(opt_state, tuple):
        return tuple(_map_moments(v, names, fn) for v in opt_state)
    if isinstance(opt_state, list) and len(opt_state) == len(names):
        return [fn(k, t) for k, t in zip(names, opt_state)]
    return opt_state


def to_device(value, device):
    """A numpy array or tensor on ``device``: host data bound for a CUDA
    device is pinned and copied with ``non_blocking`` on the current
    stream, so the copy is ordered before every later kernel of it."""
    t = torch.as_tensor(value)
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class Trainer:
    """Functional trainer binding a Model, an optimizer, a per-example
    loss, and streaming metrics.

    Args:
        model: lidbox_tpu_torch.models.model_api.Model on ``device``.
        optimizer: train.optimizers.GradientTransformation.
        loss_fn: loss_fn(targets [B], outputs) -> per-example losses [B].
        metrics: dict name -> AverageDetectionCost-like object with
            init_state/update_sparse/result.
        lr_schedule: schedule or float, used only for logging.
        rng: integer seed (default RANDOM_SEED) of the Trainer's
            ``torch.Generator`` (dropout) and of the fused path's per-step
            augmentation generators (``keyed_generator``).
        compute_dtype: e.g. torch.bfloat16: forwards run on parameters and
            inputs cast to it, while master parameters, optimizer state,
            loss and gradients stay float32.
        stage_dtype: host-side compression of the feed ("bfloat16" for
            feature batches; "int16" also for waveforms on the fused path),
            upcast on the device.
        cache_staged: keep the staged batches on the device after epoch 1
            (fit's default), held to ``cache_bytes_limit`` bytes (None:
            90% of the device's memory less what is in use; inf on the CPU;
            under a mesh the least over its ranks).
        mesh: a ``parallel.Mesh`` for data parallelism (None: one device);
            this rank must be a member, and ``device`` its card.
        param_sharding: a parameter sharding rule, (name, tensor) -> split
            axis or None (``parallel.column_parallel_rule``), for tensor
            parallelism over ``mesh``, which must be 2-D
            (``parallel.get_mesh_2d``).
        tensorboard: mirror the epoch records of the ``log_dir`` metrics
            log to TensorBoard (``observability.MetricsLogger``).
        device: the model's device; default "cuda", which raises without
            CUDA.
    """

    def __init__(self, model, optimizer, loss_fn, metrics=None, mesh=None,
                 callbacks: Sequence[Callback] = (), lr_schedule=None,
                 log_dir=None, rng=None, compute_dtype=None,
                 param_sharding=None, prefetch=4, stage_dtype=None,
                 score_fn=None, cache_staged=False, cache_bytes_limit=None,
                 tensorboard=False, device="cuda"):
        self.device = get_device(device)
        if parallel.as_mesh(mesh) is not None:
            if not mesh.is_member:
                raise ValueError(f"this rank is not a member of {mesh}")
            parallel.check_device(mesh, self.device)
        if param_sharding is not None and (
                mesh is None or parallel.MODEL_AXIS not in mesh.axis_names):
            raise ValueError("param_sharding needs a 2-D (data, model) mesh "
                             "(parallel.get_mesh_2d)")
        self.mesh = mesh
        # where batch reductions run: the ranks of this rank's model column
        self.data_mesh = None if mesh is None else mesh.data_mesh
        self.param_sharding = param_sharding
        self.param_specs = {}  # name -> split axis, set by create_state
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the "
                             f"trainer on {self.device}")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.compute_dtype = compute_dtype
        self.prefetch = max(1, int(prefetch))
        self.stage_dtype = stage_dtype
        self.cache_staged = bool(cache_staged)
        self.cache_bytes_limit = cache_bytes_limit
        # Maps raw model outputs -> per-class scores [B, N] for metrics
        # (None = identity; AngularProximity.predict for language vectors)
        self.score_fn = score_fn
        self.remat = False
        self.metrics = dict(metrics or {})
        self.callbacks = list(callbacks)
        self.lr_schedule = lr_schedule
        self.stop_training = False
        self.initial_epoch = 0
        self.seed = RANDOM_SEED if rng is None else int(rng)
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.seed)
        self.metrics_logger = (
            MetricsLogger(log_dir, tensorboard=tensorboard)
            if log_dir and (mesh is None or mesh.rank == 0) else None)
        self.state = None
        self._programs = {}  # kind -> (owner, eager, graphs.StepProgram)
        # remat's rewind point while a step program captures a remat step
        self.capture_rewind = None

    # -- state --------------------------------------------------------------

    def create_state(self):
        """A fresh TrainState from copies of the model's weights (so the
        model stays servable while the state trains); under
        ``param_sharding`` this rank's shards of it."""
        module = self.model.module
        params = {k: p.detach().clone() for k, p in module.named_parameters()}
        batch_stats = {k: b.detach().clone()
                       for k, b in module.named_buffers()}
        self.state = self._placed(TrainState(
            step=0, params=params, batch_stats=batch_stats,
            opt_state=self.optimizer.init(params)))
        return self.state

    def _placed(self, state):
        """A full state as this rank holds it: under a mesh replicated from
        rank 0, then under ``param_sharding`` cut to this rank's shards of
        the split parameters and of their optimizer moments (Adam's
        moments of a shard are the shard's)."""
        if self.mesh is None:
            return state
        state = state.replace(**{k: parallel.put_replicated(
            getattr(state, k), self.mesh)
            for k in ("params", "batch_stats", "opt_state")})
        if self.param_sharding is None:
            return state
        params, self.param_specs = parallel.shard_params(
            state.params, self.mesh, self.param_sharding)
        return state.replace(params=params, opt_state=_map_moments(
            state.opt_state, list(params), self._shard))

    def _shard(self, name, tensor):
        """This rank's shard of a full tensor of split parameter ``name``
        (or of its optimizer moment); other tensors pass."""
        axis = self.param_specs.get(name)
        return tensor if axis is None else parallel.shard(tensor, axis,
                                                          self.mesh)

    def _unshard(self, name, tensor):
        """``_shard``'s inverse, gathered over the model group."""
        axis = self.param_specs.get(name)
        return tensor if axis is None else parallel.unshard(tensor, axis,
                                                            self.mesh)

    def checkpoint_state(self):
        """The train state with every split parameter and optimizer moment
        gathered whole: the mesh-less state, in the format a mesh-less
        Trainer checkpoints. A collective over the model groups under
        ``param_sharding`` (every rank calls it); the state itself
        otherwise."""
        state = self.state
        if not self.param_specs:
            return state
        return state.replace(
            params={k: self._unshard(k, v) for k, v in state.params.items()},
            opt_state=_map_moments(state.opt_state, list(state.params),
                                   self._unshard))

    def restore(self, checkpoint_path):
        """Resume from a checkpoint; sets initial_epoch from the filename
        (reference: keras_utils.py:187-189, 202). Every rank of a mesh
        reads the file, the state is replicated from rank 0 and, under
        ``param_sharding``, split again."""
        if self.state is None:
            self.create_state()
        self.state = self._placed(ckpt_lib.restore_checkpoint(
            checkpoint_path, self.checkpoint_state()))
        self.initial_epoch = ckpt_lib.initial_epoch_from_path(checkpoint_path)
        self.sync_model_variables()
        return self.state

    def sync_model_variables(self):
        """Copy the current trained weights into the model's module, so the
        model is directly servable after fit/restore; split parameters are
        gathered whole first (a collective under ``param_sharding``), so
        every rank holds the same full weights."""
        if self.state is None:
            return
        state = self.checkpoint_state()
        with torch.no_grad():
            for k, p in self.model.module.named_parameters():
                p.copy_(state.params[k])
            for k, b in self.model.module.named_buffers():
                b.copy_(state.batch_stats[k])

    def current_learning_rate(self):
        if self.lr_schedule is None:
            return float("nan")
        if callable(self.lr_schedule):
            return float(self.lr_schedule(self.state.step if self.state else 0))
        return float(self.lr_schedule)

    # -- steps --------------------------------------------------------------

    def _apply(self, params, batch_stats, batch, train, generator=None):
        """Model outputs of one batch on the given state tensors and the
        batch stats after it: with ``train`` the module runs in training
        mode for the call, dropout and noise draw from ``generator``, and
        every BatchNorm's running statistics come back updated, in
        float32 under ``compute_dtype`` too (the JAX package's
        ``mutable=["batch_stats"]``, lidbox_tpu/train/loop.py:507-538);
        in eval mode they come back as they were. The state's tensors are
        never written. Split parameters compute column-parallel
        (``parallel.tensor_parallel``)."""
        kwargs = {"output": self.model.output}
        if "input_mask" in batch:
            kwargs["mask"] = batch["input_mask"]
        with parallel.tensor_parallel(self.mesh, self.param_specs):
            if not train:
                return functional_forward(
                    self.model.module, params, batch_stats, batch["input"],
                    compute_dtype=self.compute_dtype, **kwargs), batch_stats
            return functional_forward(
                self.model.module, params, batch_stats, batch["input"],
                compute_dtype=self.compute_dtype, train=True,
                generator=generator, **kwargs)

    def _remat_apply(self, params, batch_stats, batch, generator=None):
        """The training-mode ``_apply`` under ``torch.utils.checkpoint``
        (the JAX package's ``jax.checkpoint``): only its inputs are kept,
        and the backward runs the forward again. The model draws from
        ``generator`` alone (torch's global generators are not saved, which
        a capture would refuse), so the recompute rewinds it to where the
        forward started and leaves it where the forward left it: it draws
        the forward's dropout masks and noise. On the card the rewind swaps
        the generator's state for a rewind point and back
        (``_rewind_point``, ``graphsafe_set_state``), which a CUDA graph
        captures; on the CPU it sets the state on the host. The
        scopes the forward reads are entered inside, since the recompute
        may run on the autograd engine's device thread; the batch
        statistics come from the first forward alone."""
        start = None if generator is None else self._rewind_point(generator)
        calls = []

        def run(params):
            calls.append(1)
            with parallel.data_parallel(self.mesh), (
                    _rewound(generator, start) if start is not None
                    and len(calls) > 1 else contextlib.nullcontext()):
                return self._apply(params, batch_stats, batch, train=True,
                                   generator=generator)
        return torch.utils.checkpoint.checkpoint(
            run, params, use_reentrant=False, preserve_rng_state=False)

    def _rewind_point(self, generator):
        """Where remat's recompute rewinds ``generator`` to: the state it
        holds now. On the CPU the state's bytes; on the card a generator
        holding it, which ``graphsafe_set_state`` swaps in: a clone
        eagerly, and under capture, where a clone cannot draw, the one the
        step program registered with the graph (``capture_rewind``: each
        replay sets its state to the generator's before the graph draws,
        and the remat forward is the step's first draw from the
        generator)."""
        if generator.device.type == "cpu":
            return generator.get_state()
        if torch.cuda.is_current_stream_capturing():
            if self.capture_rewind is None:
                raise RuntimeError("remat under capture needs a rewind point "
                                   "registered with the graph "
                                   "(graphs.StepProgram)")
            return self.capture_rewind
        return generator.clone_state()

    @staticmethod
    def _masked_mean(losses, batch):
        if "example_mask" in batch:
            m = batch["example_mask"].to(losses.dtype)
            return torch.sum(losses * m) / torch.clamp(torch.sum(m), min=1.0)
        return torch.mean(losses)

    def _global_mean(self, losses, batch):
        """(the global batch's example-mask mean loss, this rank's part of
        it): the rank's loss sum and example count are all-reduced in one
        call, and the rank's part, its sum over the global count, is what
        its backward differentiates."""
        if "example_mask" in batch:
            m = batch["example_mask"].to(losses.dtype)
            local, count = torch.sum(losses * m), torch.sum(m)
        else:
            local = torch.sum(losses)
            count = losses.new_tensor(float(losses.shape[0]))
        total, count = parallel.all_reduce_tree(
            torch.stack([local.detach(), count]), self.data_mesh)
        count = torch.clamp(count, min=1.0)
        return total / count, local / count

    def _loss_and_grads(self, state, batch, generator=None):
        """Forward and backward of one batch: (loss as a 0-dim device
        tensor, the example-mask mean; grads in params' order; new batch
        stats). Under a mesh the loss is the global batch's and the
        gradients are summed over the data group in one bucketed
        all-reduce. With ``remat`` the forward is recomputed in the
        backward (``_remat_apply``)."""
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        with torch.enable_grad(), parallel.data_parallel(self.mesh):
            if self.remat:
                outputs, new_bs = self._remat_apply(params, state.batch_stats,
                                                    batch, generator)
            else:
                outputs, new_bs = self._apply(params, state.batch_stats,
                                              batch, train=True,
                                              generator=generator)
            losses = self.loss_fn(batch["target"], outputs)
            if parallel.mesh_spans_processes(self.data_mesh):
                loss, objective = self._global_mean(losses, batch)
            else:
                objective = self._masked_mean(losses, batch)
                loss = objective.detach()
            grads = torch.autograd.grad(objective, list(params.values()),
                                        allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(state.params.items(), grads)}
        if self.data_mesh is not None:
            grads = parallel.all_reduce_tree(grads, self.data_mesh)
        return loss, grads, new_bs

    def _apply_gradients(self, state, grads, new_bs):
        """The optimizer update: a new state one step on (a global norm
        over split gradients is the global arrays', ``parallel
        .sum_of_squares``)."""
        with parallel.tensor_parallel(self.mesh, self.param_specs):
            updates, new_opt_state = self.optimizer.update(
                grads, state.opt_state, state.params)
        return TrainState(step=state.step + 1,
                          params=apply_updates(state.params, updates),
                          batch_stats=new_bs, opt_state=new_opt_state)

    def _train_step(self, state, batch, generator=None):
        """One step: forward, loss (example-mask mean), gradients, update.
        Returns (new state, loss as a 0-dim device tensor); the functional
        form, whose new state is new tensors."""
        loss, grads, new_bs = self._loss_and_grads(state, batch, generator)
        return self._apply_gradients(state, grads, new_bs), loss

    def _donating_step(self, state, batch, generator, scalars, loss_out):
        """``_train_step`` written into ``state``'s tensors: the new
        parameters, batch statistics and optimizer moments go into the
        tensors they replace and the loss into ``loss_out``, a 0-dim
        buffer; ``scalars`` are the optimizer's per-step scalars as 0-dim
        tensors (``GradientTransformation.scalars``). The counts are left
        to the caller (``graphs.advance``). Reads nothing back from the
        device, so a CUDA graph captures it (``graphs.StepProgram``); the
        same operations in the same order as ``_train_step``, so the same
        bits."""
        loss, grads, new_bs = self._loss_and_grads(state, batch, generator)
        with parallel.tensor_parallel(self.mesh, self.param_specs):
            updates, new_opt_state = self.optimizer.update(
                grads, state.opt_state, state.params, scalars=scalars)
        torch._foreach_add_(list(state.params.values()),
                            list(updates.values()))
        pairs = [(state.batch_stats[k], v) for k, v in new_bs.items()
                 if v is not state.batch_stats[k]]
        if pairs:
            torch._foreach_copy_([d for d, _ in pairs], [v for _, v in pairs])
        copy_state_(state.opt_state, new_opt_state)
        loss_out.copy_(loss)

    def step_program(self, kind, owner=None, eager=False, **options):
        """The ``graphs.StepProgram(kind, eager=eager, **options)`` of
        ``kind`` ("features" for fit's feature batches, "fused" for the
        waveform steps of ``on_device``) for ``owner`` (the fused step's
        feature fn): one per kind, replaced when the owner or ``eager``
        changes, so a later fit's graphs free an earlier's."""
        cached = self._programs.get(kind)
        if cached is None or cached[0] is not owner or cached[1] != eager:
            cached = (owner, eager,
                      graphs.StepProgram(kind, eager=eager, **options))
            self._programs[kind] = cached
        return cached[2]

    def forward_program(self, kind, eager=False):
        """The ``graphs.ForwardProgram`` of ``kind`` ("eval" for
        ``evaluate``'s steps, "forward" for ``predict``'s), kept across
        calls; with ``eager=True`` a new one, which captures nothing."""
        if eager:
            return graphs.ForwardProgram(kind, eager=True)
        cached = self._programs.get(kind)
        if cached is None:
            cached = (None, False, graphs.ForwardProgram(kind))
            self._programs[kind] = cached
        return cached[2]

    def _eval_held(self, state):
        """The state tensors a forward reads: its graphs' key."""
        return list(state.params.values()) + list(state.batch_stats.values())

    def release_graphs(self):
        """Free the captured train steps and forwards (graphs, memory
        pools, buffers): ``fit`` and ``fit_signals`` do when they end, and
        a later step captures anew."""
        for _, _, program in self._programs.values():
            program.release()
        self._programs.clear()

    def _fit_step(self, state, batch, generator=None):
        """One of fit's train steps on feature batches, through a
        ``graphs.StepProgram``: a CUDA graph replay on the card, which
        writes the new state into ``state``'s tensors. Returns (state,
        loss)."""
        return self.step_program("features")(self, state, batch, generator)

    def _replay_train_step(self, state, stacked, generator, order):
        """Whole-epoch cached replay: train steps over the device-resident
        stacked batch dict [K, B, ...] in ``order`` (a host permutation of
        range(K)) -> (state, losses [K]); each step's batch is a view of
        the stack, copied into the step's input buffers on the card."""
        losses = []
        for i in np.asarray(order).tolist():
            state, loss = self._fit_step(
                state, {k: v[i] for k, v in stacked.items()}, generator)
            losses.append(loss)
        return state, torch.stack(losses)

    def _multi_train_step(self, state, stacked, generator=None):
        """K train steps over a stacked batch dict [K, B, ...] that crossed
        to the device as one transfer; per-step numerics identical to K
        single steps."""
        return self._replay_train_step(state, stacked, generator,
                                       np.arange(self._batch_rows(stacked)))

    def _replay_rows_train_step(self, state, stacked, generator, idx):
        """Whole-epoch cached replay with a row-level reshuffle
        (cache_shuffle="rows"): ``idx`` is a host [K, B] permutation of the
        K*B cached example rows, so every epoch re-draws batch composition
        (the reference re-shuffled elements every epoch,
        lidbox/data/steps.py:997-999). Each step gathers its rows on the
        device from the [K * B, ...] view of the stack (into the step's
        input buffers on the card); masks and targets travel with their
        rows."""
        flat = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                for k, v in stacked.items()}
        rows_all = to_device(np.asarray(idx, np.int64), self.device)
        losses = []
        for rows in rows_all:
            state, loss = self._fit_step(
                state, {k: graphs.Gather(v, rows) for k, v in flat.items()},
                generator)
            losses.append(loss)
        return state, torch.stack(losses)

    @torch.no_grad()
    def _eval_step(self, state, batch, metric_states):
        outputs, _ = self._apply(state.params, state.batch_stats, batch,
                                 train=False)
        losses = self.loss_fn(batch["target"], outputs)
        weights = batch.get("example_mask")
        if weights is not None:
            m = weights.to(losses.dtype)
            loss_sum, count = torch.sum(losses * m), torch.sum(m)
        else:
            loss_sum, count = torch.sum(losses), float(losses.shape[0])
        scores = outputs if self.score_fn is None else self.score_fn(outputs)
        new_metric_states = {
            name: metric.update_sparse(metric_states[name], batch["target"],
                                       scores, weights=weights)
            for name, metric in self.metrics.items()}
        return loss_sum, count, new_metric_states

    @torch.no_grad()
    def _eval_step_into(self, state, sums, **batch):
        """``_eval_step`` added into ``sums`` in place ({"loss", "count":
        0-dim float32, "metrics": name -> metric state}): its sums and its
        new metric states copied over the old, the same additions in the
        same order as a functional accumulation, so the same bits. Reads
        nothing back, so a CUDA graph captures it
        (``graphs.ForwardProgram``, kind "eval")."""
        loss_sum, count, metric_states = self._eval_step(state, batch,
                                                         sums["metrics"])
        sums["loss"].add_(loss_sum)
        sums["count"].add_(count)
        for name, new in metric_states.items():
            old = sums["metrics"][name]
            torch._foreach_copy_([old[k] for k in new], list(new.values()))

    # -- host loop ----------------------------------------------------------

    @staticmethod
    def _batch_rows(batch):
        """Leading dim of a batch dict: from ``target`` when present, else
        ``input`` (predict() feeds unlabeled batches), else any value."""
        for key in ("target", "input"):
            if key in batch:
                return int(np.shape(batch[key])[0])
        return int(np.shape(next(iter(batch.values())))[0])

    def _compress(self, batch):
        """Host-side staging compression: a floating ``stage_dtype`` (e.g.
        bfloat16, half the bytes of the transfer) converts float inputs to
        it, and _apply upcasts on the device. Integer stage dtypes (int16
        PCM) apply to the fused waveform route only (on_device
        .stage_signals): feature batches pass through."""
        if self.stage_dtype is None:
            return batch
        dt = torch_dtype(self.stage_dtype)
        if not dt.is_floating_point:
            return batch
        x = batch["input"]
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
            if not np.issubdtype(x.dtype, np.floating):
                return batch
            x = torch.from_numpy(np.ascontiguousarray(x))
        if x.is_floating_point() and x.dtype != dt:
            batch = dict(batch)
            batch["input"] = x.to(dt)
        return batch

    def _put(self, batch):
        """A host batch dict on the trainer's device, compressed first."""
        return {k: to_device(v, self.device)
                for k, v in self._compress(batch).items()}

    @staticmethod
    def _grouped_batches(batches, spd, limit=None):
        """Consecutive same-signature batch dicts in lists of up to ``spd``
        (one stacked transfer per list). ``limit`` caps the number of
        batches emitted, and group edges align with it: a stacked group
        runs whole."""
        buf, sig = [], None
        for b in batches:
            s = tuple(sorted((k, _leaf_signature(v)) for k, v in b.items()))
            if buf and s != sig:
                yield buf
                if limit is not None:
                    limit -= len(buf)
                    if limit <= 0:
                        return
                buf = []
            sig = s
            buf.append(b)
            if len(buf) == spd or (limit is not None and len(buf) >= limit):
                yield buf
                if limit is not None:
                    limit -= len(buf)
                    if limit <= 0:
                        return
                buf = []
        if buf:
            yield buf

    def _put_group(self, group):
        """A list of same-shape host batches as one stacked transfer (dict of
        [K, B, ...] tensors) for _multi_train_step."""
        group = [self._compress(b) for b in group]
        return {k: to_device(torch.stack([torch.as_tensor(b[k])
                                          for b in group]), self.device)
                for k in group[0]}

    def _consolidate_cache(self, items, grouped, preserve_order=False):
        """Merge epoch 1's staged entries into per-shape device stacks for
        whole-epoch replay: ``items`` are (n, batch dict [B, ...]) pairs, or
        with ``grouped`` (list of n, stacked dict [k, B, ...]). Returns a
        list of {"stack": dict of [K, B, ...] tensors, "ns": int64 [K]}, one
        per distinct per-step batch signature. Consolidation holds the
        originals and the stacks at once (~2x the corpus); callers release
        the entries after.

        ``preserve_order=True`` (the cache_shuffle=False contract: replay
        epoch 1's sequence exactly) returns None when the signatures
        interleave (e.g. padded buckets A, B, A), since stack-major replay
        would reorder them; the caller keeps per-entry replay."""
        lead = 1 if grouped else 0
        sigs = [tuple(sorted((k, tuple(v.shape[lead:]), str(v.dtype))
                             for k, v in batch.items()))
                for _, batch in items]
        if preserve_order and not _signature_runs_contiguous(sigs):
            return None
        order, by_sig = [], {}
        for (n, batch), s in zip(items, sigs):
            if s not in by_sig:
                by_sig[s] = {"batches": [], "ns": []}
                order.append(s)
            by_sig[s]["batches"].append(batch)
            by_sig[s]["ns"].extend(list(n) if grouped else [n])
        return [{"stack": parallel.stack_on_mesh(e["batches"], self.mesh,
                                                 concat=grouped),
                 "ns": np.asarray(e["ns"], np.int64)}
                for e in (by_sig[s] for s in order)]

    def _cache_budget(self):
        """The cache_staged memory budget of this trainer's device
        (_cache_budget_bytes); under a mesh the least over its ranks, so
        every rank takes the same cache-or-stream decision (the steps that
        follow it are collectives)."""
        budget = _cache_budget_bytes(self.cache_bytes_limit, self.device)
        if parallel.mesh_spans_processes(self.mesh):
            budget = float(parallel.host_allgather(
                np.float64(budget), self.mesh).min())
        return budget

    def _rows_factor(self, cache_shuffle):
        """How many times its own rows a rank caches: the data size for
        cache_shuffle="rows" under a mesh (every rank replays from the
        global cache), else 1."""
        if cache_shuffle == "rows" and parallel.mesh_spans_processes(
                self.data_mesh):
            return self.data_mesh.size
        return 1

    def _gather_stacks(self, groups):
        """cache_shuffle="rows" under a mesh: each per-shape stack [K, b,
        ...] becomes the global one [K, ranks x b, ...] on every rank, so a
        replayed batch can take rows that other ranks cached, as the JAX
        package's flattened global cache does."""
        for g in groups:
            g["stack"] = {k: parallel.all_gather_rows(
                v.transpose(0, 1), self.data_mesh).transpose(0, 1)
                for k, v in g["stack"].items()}
        return groups

    def _local_columns(self, idx):
        """This rank's columns of a [K, global rows] replay index."""
        if not parallel.mesh_spans_processes(self.data_mesh):
            return idx
        b = idx.shape[1] // self.data_mesh.size
        return idx[:, self.data_mesh.rank * b:(self.data_mesh.rank + 1) * b]

    def _feed_parity_guard(self, source, what="training"):
        """Fail fast on uneven feeds under a mesh: every step is a
        collective, so a rank whose loader yields an extra batch would
        block forever against ranks that left the loop. Before each step
        the ranks allgather (has a batch, digest of its structure, shapes
        and dtypes) over the CPU group; a mismatch raises the same error on
        every rank instead of hanging. Every rank must feed the same number
        of structurally identical batches (``parallel.local_slice`` pads a
        ragged global batch for that). Outside a multi-rank mesh the source
        passes through."""
        if not parallel.mesh_spans_processes(self.mesh):
            yield from source
            return
        it = iter(source)
        step = 0
        try:
            while True:
                try:
                    item = next(it)
                    have = 1
                except StopIteration:
                    item, have = None, 0
                pair = parallel.host_allgather(np.int64(
                    [have, parallel.structure_digest(item) if have else 0]),
                    self.mesh)
                flags, digests = pair[:, 0], pair[:, 1]
                if flags.min() != flags.max():
                    exhausted = [str(i) for i, f in enumerate(flags) if not f]
                    feeding = [str(i) for i, f in enumerate(flags) if f]
                    raise RuntimeError(
                        f"uneven multi-process {what} feed: after {step} "
                        f"batches, rank(s) {', '.join(exhausted)} ran out "
                        f"while rank(s) {', '.join(feeding)} still have "
                        "batches. Every rank must yield the same number of "
                        "batches per epoch: pad or truncate the local "
                        "corpora to a common batch count (without this "
                        "check the extra step would hang in a collective).")
                if have and digests.min() != digests.max():
                    raise RuntimeError(
                        f"divergent multi-process {what} feed: at batch "
                        f"{step} the staged batch's structure or tensor "
                        "shapes and dtypes differ across ranks (digests "
                        f"{digests.tolist()}). Every rank must stage "
                        "structurally identical batches: a padding mask on "
                        "one rank but not another, or unequal local batch "
                        "sizes, would hang the collective step.")
                if not have:
                    return
                yield item
                step += 1
        finally:
            if hasattr(it, "close"):
                it.close()

    def _staged(self, batches, count_fn=None, put=None):
        """Iterate ``batches`` with up to ``self.prefetch`` staged batches
        ready ahead: one producer thread
        drains the (possibly slow) batch iterator, in order, and stages
        each batch with ``put`` (default ``_put``), so host-side batching
        and pinning overlap the device running earlier steps.

        Yields ``(n, staged_batch)`` with ``n`` from ``count_fn`` (default
        the batch's rows). While a profiler runs, each staging is a
        ``lidbox.feed.stage`` span on the producer thread, with its staged
        ``bytes``, and each wait of the consumer for a staged batch a
        ``lidbox.feed.wait`` span; the first of them, before this feed has
        handed anything on, carries ``first``."""
        count_fn = self._batch_rows if count_fn is None else count_fn
        put = self._put if put is None else put
        q = queue.Queue(maxsize=self.prefetch)
        done = object()
        err = []
        stop = threading.Event()

        def offer(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                it = batches() if callable(batches) else batches
                for b in it:
                    with observability.span("lidbox.feed.stage") as span:
                        n, staged = count_fn(b), put(b)
                        if span is not None:
                            span.attrs["bytes"] = _tree_device_nbytes(staged)
                    if not offer((n, staged)):
                        return  # the consumer closed early
            except Exception as e:  # re-raised in the consumer
                err.append(e)
            finally:
                offer(done)

        t = threading.Thread(target=producer, name="lidbox-stage", daemon=True)
        t.start()
        try:
            first = True
            while True:
                with observability.span("lidbox.feed.wait", first=first):
                    item = q.get()
                first = False
                if item is done:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()
            # drain the queue so a producer blocked in q.put wakes now
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            # bounded join: the abandoned producer must stop pulling the
            # loader before the next consumer reuses it
            t.join(timeout=10.0)
            if t.is_alive():
                logger.warning("staging producer did not stop within 10 s; "
                               "continuing without it")

    def fit(self, train_batches, validation_batches=None, epochs=1,
            steps_per_epoch=None, verbose=True, cache_staged=None,
            cache_shuffle=True, steps_per_dispatch=1):
        """Run the training loop.

        ``train_batches``/``validation_batches`` are callables returning an
        iterable of batch dicts (numpy arrays or tensors) with keys
        ``input`` [B, T, F], ``target`` [B] and optional
        ``input_mask``/``example_mask``, or plain re-iterable collections.
        Epoch numbering resumes from ``initial_epoch`` and ``epochs`` is
        the absolute target. Returns one logs dict per epoch.

        ``steps_per_dispatch=K`` stages K consecutive same-shape batches as
        one transfer for K train steps (_multi_train_step), per-step
        numerics identical to single steps.

        ``cache_staged`` (default: the Trainer's setting) keeps every staged
        training and validation batch on the device after epoch 1 and
        replays them in later epochs: no transfers, at the cost of freezing
        both sets to their epoch-1 contents. The cached batches consolidate
        into per-shape stacks (_consolidate_cache). ``cache_shuffle``
        (default True) re-permutes the cached batch order each epoch,
        drawn from ``np.random.default_rng(RANDOM_SEED + epoch)`` as in the
        JAX package; ``"rows"`` re-draws batch composition too, permuting
        the cached example rows within each shape stack
        (_replay_rows_train_step); False replays epoch 1's order. A
        ``steps_per_epoch``-truncated first epoch does not populate the
        cache. A memory guard counts the staged bytes against
        ``cache_bytes_limit`` (_cache_budget_bytes) and, when twice the
        corpus (the consolidation transient) would not fit, releases the
        cache with a warning and streams."""
        if self.state is None:
            self.create_state()
        # a fresh fit() trains anew even if a previous fit on this trainer
        # was stopped early (Keras resets the flag on fit entry)
        self.stop_training = False
        if cache_staged is None:
            cache_staged = self.cache_staged
        spd = max(1, int(steps_per_dispatch))
        staged_cache = None
        val_staged = None  # staged validation stacks (False: did not fit)
        cached_bytes = 0
        cache_budget = None  # resolved at the first cached batch
        for cb in self.callbacks:
            cb.on_train_begin(self)
        history = []
        for epoch in range(self.initial_epoch + 1, epochs + 1):
            if self.stop_training:
                break
            for cb in self.callbacks:
                cb.on_epoch_begin(self, epoch)
            meter = ThroughputMeter()
            losses = []
            truncated = False
            collecting = None
            if staged_cache is not None:
                rng_epoch = np.random.default_rng(RANDOM_SEED + epoch)
                if isinstance(staged_cache[0], dict):
                    # per-shape stacks
                    gorder = (rng_epoch.permutation(len(staged_cache))
                              if cache_shuffle
                              else np.arange(len(staged_cache)))
                    for gi in gorder:
                        g = staged_cache[gi]
                        K = len(g["ns"])
                        if cache_shuffle == "rows":
                            B = self._batch_rows(
                                {k: v[0] for k, v in g["stack"].items()})
                            idx = rng_epoch.permutation(K * B).reshape(K, B)
                            self.state, loss_k = self._replay_rows_train_step(
                                self.state, g["stack"], self.generator,
                                self._local_columns(idx))
                        else:
                            order = (rng_epoch.permutation(K)
                                     if cache_shuffle else np.arange(K))
                            self.state, loss_k = self._replay_train_step(
                                self.state, g["stack"], self.generator, order)
                        losses.append(loss_k)
                        meter.update(int(g["ns"].sum()))
                else:
                    # per-entry replay: the order-exact fallback when
                    # cache_shuffle=False met interleaved shape signatures
                    replay = staged_cache
                    if cache_shuffle:
                        order = rng_epoch.permutation(len(staged_cache))
                        replay = [staged_cache[i] for i in order]
                    for n, batch in replay:
                        if isinstance(n, list):  # a steps_per_dispatch stack
                            self.state, loss = self._multi_train_step(
                                self.state, batch, self.generator)
                            meter.update(int(sum(n)))
                        else:
                            self.state, loss = self._fit_step(
                                self.state, batch, self.generator)
                            meter.update(n)
                        losses.append(loss)
            else:
                batches = (train_batches() if callable(train_batches)
                           else train_batches)
                if spd > 1:
                    source = self._staged(
                        self._grouped_batches(batches, spd,
                                              limit=steps_per_epoch),
                        count_fn=lambda g: [self._batch_rows(b) for b in g],
                        put=self._put_group)
                else:
                    source = self._staged(batches)
                source = self._feed_parity_guard(source)
                # a steps_per_epoch-truncated epoch never populates the cache
                collecting = ([] if cache_staged and steps_per_epoch is None
                              else None)
                steps_done = 0
                try:
                    for n, batch in source:
                        if (steps_per_epoch is not None
                                and steps_done >= steps_per_epoch):
                            truncated = True
                            break
                        if collecting is not None:
                            collecting.append((n, batch))
                            cached_bytes += _tree_device_nbytes(batch)
                            if cache_budget is None:
                                cache_budget = self._cache_budget()
                            # consolidation holds originals and stacks at
                            # once, so the guard trips at 2x staged bytes
                            # (1 + ranks x under a mesh's rows replay)
                            if ((1.0 + self._rows_factor(cache_shuffle))
                                    * cached_bytes > cache_budget):
                                logger.warning(
                                    "cache_staged: staged corpus (%.0f MB "
                                    "so far, ~2x transient during "
                                    "consolidation) exceeds the device "
                                    "memory budget (%.0f MB) — releasing "
                                    "the cache and streaming every epoch "
                                    "instead", cached_bytes / 1e6,
                                    cache_budget / 1e6)
                                collecting = None
                                cache_staged = False
                                val_staged = False
                        if spd > 1:
                            self.state, loss = self._multi_train_step(
                                self.state, batch, self.generator)
                            steps_done += len(n)
                            meter.update(int(sum(n)))
                        else:
                            self.state, loss = self._fit_step(
                                self.state, batch, self.generator)
                            steps_done += 1
                            meter.update(n)
                        losses.append(loss)
                finally:
                    # release the producer thread and its staged batches on
                    # every exit (normal, truncation, a raising train step)
                    source.close()
            if collecting is not None and not truncated:
                if not collecting:
                    # freezing an empty epoch-1 cache would make every later
                    # epoch silently train on nothing
                    raise ValueError(
                        "cache_staged: the first epoch produced no training "
                        "batches — train_batches must be a callable or "
                        "re-iterable collection that yields at least one "
                        "batch")
                # the stacks hold the cache: the per-batch entries go
                staged_cache = (self._consolidate_cache(
                    collecting, grouped=spd > 1,
                    preserve_order=not cache_shuffle) or collecting)
                if self._rows_factor(cache_shuffle) > 1:
                    staged_cache = self._gather_stacks(staged_cache)
            train_loss = (float(torch.cat([l.reshape(-1) for l in losses])
                                .mean()) if losses else float("nan"))
            logs = {"loss": train_loss, **meter.rates(),
                    "learning_rate": self.current_learning_rate()}
            if validation_batches is not None:
                if cache_staged and val_staged is not False:
                    if val_staged is None:
                        entries = list(self._feed_parity_guard(
                            self._staged(validation_batches), "validation"))
                        vbytes = sum(_tree_device_nbytes(b)
                                     for _, b in entries)
                        if cache_budget is None:
                            cache_budget = self._cache_budget()
                        if cached_bytes + 2.0 * vbytes > cache_budget:
                            # keep the training cache (the bigger win) and
                            # stream validation
                            logger.warning(
                                "cache_staged: staged validation set (%.0f "
                                "MB, ~2x transient) on top of the training "
                                "cache (%.0f MB) exceeds the device memory "
                                "budget (%.0f MB) — streaming validation "
                                "instead", vbytes / 1e6, cached_bytes / 1e6,
                                cache_budget / 1e6)
                            val_staged = False
                        else:
                            val_staged = self._consolidate_cache(
                                entries, grouped=False)
                    if val_staged is not False:
                        logs.update(self.evaluate(val_staged, staged=True))
                if not cache_staged or val_staged is False:
                    logs.update(self.evaluate(validation_batches))
            history.append(logs)
            if self.metrics_logger:
                self.metrics_logger.log(epoch, logs)
            if verbose:
                logger.info("epoch %d/%d: %s", epoch, epochs,
                            " ".join(f"{k}={v:.6g}" for k, v in logs.items()))
            for cb in self.callbacks:
                cb.on_epoch_end(self, epoch, logs)
        self.release_graphs()
        self.sync_model_variables()
        for cb in self.callbacks:
            cb.on_train_end(self)
        return history

    def evaluate(self, batches, prefix="val_", staged=False, eager=False):
        """Evaluate ``batches``: host batch dicts, staged through _put
        unless ``staged=True``, in which case they are (n, batch) pairs
        already on the device or _consolidate_cache stacks (the
        cache_staged path, whose K batches are K steps). Loss sums, counts
        and metric states accumulate on the device and are read back once;
        under a mesh they are summed over the data group first
        (``psum_state``).

        Each step is one CUDA graph replay per batch signature on the card
        (``_eval_step_into``, the JAX package's ``_jit_eval_step``), which
        adds into buffers the program keeps; the CPU, a mesh of several
        ranks (logged once) and ``eager=True`` run the same step eagerly,
        the graphs' reference."""
        if self.state is None:
            self.create_state()
        state = self.state
        it = batches() if callable(batches) else batches
        if staged and isinstance(it, list) and it and "stack" in it[0]:
            source = [(g["ns"], g["stack"]) for g in it]
            stacks = True
        else:
            source = self._feed_parity_guard(
                it if staged else self._staged(it), "validation")
            stacks = False
        program = self.forward_program("eval", eager=eager)
        sums = program.buffers
        if sums is None:
            sums = program.buffers = {
                "loss": torch.zeros((), device=self.device),
                "count": torch.zeros((), device=self.device),
                "metrics": {name: m.init_state(self.device)
                            for name, m in self.metrics.items()}}
        else:
            torch._foreach_zero_(graphs.tensors_of(sums))
        step = functools.partial(self._eval_step_into, state, sums)
        held = self._eval_held(state)
        steps = 0
        try:
            for _, batch in source:
                for b in ([{k: v[i] for k, v in batch.items()}
                           for i in range(self._batch_rows(batch))]
                          if stacks else [batch]):
                    steps += 1
                    program(step, b, self.device, held=held,
                            reason=graphs.forward_reason(self.mesh))
        finally:
            if hasattr(source, "close"):
                source.close()  # release staging on any exit path
        metric_states = sums["metrics"]
        total = count = None
        if steps:
            total, count = sums["loss"], sums["count"]
        if self.mesh is not None and total is not None:
            sums = parallel.all_reduce_tree(torch.stack([
                torch.as_tensor(v, dtype=torch.float32,
                                device=self.device).reshape(())
                for v in (total, count)]), self.data_mesh)
            total, count = sums[0], sums[1]
            metric_states = {name: metric.psum_state(metric_states[name],
                                                     self.data_mesh)
                             for name, metric in self.metrics.items()}
        results = {name: metric.result(metric_states[name])
                   for name, metric in self.metrics.items()}
        values = [float("nan") if total is None else total,
                  0.0 if count is None else count, *results.values()]
        host = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                            device=self.device).reshape(())
                            for v in values]).cpu().tolist()
        logs = {prefix + "loss": host[0] / max(host[1], 1.0)}
        for name, value in zip(results, host[2:]):
            logs[prefix + name] = float(value)
        return logs

    @torch.no_grad()
    def predict(self, batches, eager=False):
        """Model outputs for every batch, concatenated on the host. Each
        batch's readback lags one forward behind, so the next forward is
        queued before the host waits. Under a mesh every rank returns the
        global batches' outputs (the ranks' rows in rank order).

        The forward is one CUDA graph replay per batch signature on the
        card (the JAX package's ``_jit_apply_eval``); the CPU, a mesh of
        several ranks and ``eager=True`` run it eagerly."""
        if self.state is None:
            self.create_state()
        state = self.state
        program = self.forward_program("forward", eager=eager)
        held = self._eval_held(state)

        def forward(**batch):
            return self._apply(state.params, state.batch_stats, batch,
                               train=False)[0]
        outs = []
        prev = None
        source = self._feed_parity_guard(self._staged(batches), "predict")
        try:
            for n, batch in source:
                out = program(forward, batch, self.device, held=held,
                              reason=graphs.forward_reason(self.mesh))
                if self.mesh is not None:
                    out = parallel.all_gather_rows(out[:n], self.data_mesh)
                    n = out.shape[0]
                if prev is not None:
                    outs.append(prev[1][:prev[0]].cpu().numpy())
                prev = (n, out)
        finally:
            source.close()
        if prev is not None:
            outs.append(prev[1][:prev[0]].cpu().numpy())
        if not outs:
            raise ValueError(
                "predict() received no batches (empty iterable, or a "
                "one-shot generator that was already consumed)")
        return np.concatenate(outs, axis=0)


def signal_batches_from_dataset(ds, batch_size, drop_remainder=False):
    """Collect element dicts into (signals [B, T], targets [B]) numpy
    pairs for the fused training path (on_device.fit_signals). Signals must
    share one length: chunk them in pre_process."""
    def make():
        pending = []
        for x in ds:
            pending.append(x)
            if len(pending) == batch_size:
                yield _finalize(pending)
                pending = []
        if pending and not drop_remainder:
            yield _finalize(pending)

    def _finalize(pending):
        lengths = {np.shape(p["signal"])[0] for p in pending}
        if len(lengths) != 1:
            raise ValueError(
                f"fused training needs equal-length signals, got {sorted(lengths)}; "
                "add pre_process chunks (create_signal_chunks) to the config")
        signals = np.stack([np.asarray(p["signal"], np.float32)
                            for p in pending])
        targets = np.asarray([p["target"] for p in pending], np.int32)
        return signals, targets
    return make


def batches_from_dataset(ds, batch_size, input_key="input", target_key="target",
                         pad_buckets=None, drop_remainder=False,
                         frame_mask=False):
    """Collect element dicts from a Dataset into padded training batches
    (numpy). Returns a callable for Trainer.fit.

    Ragged time axes are right-padded to ``pad_buckets``; an
    ``input_mask`` [B, T] marks real frames when frame_mask=True.
    """
    def make():
        pending = []
        for x in ds:
            pending.append(x)
            if len(pending) == batch_size:
                yield _finalize(pending)
                pending = []
        if pending and not drop_remainder:
            yield _finalize(pending)

    def _finalize(pending):
        batch = padded_batch(pending, input_key, pad_axis=0, buckets=pad_buckets)
        out = {"input": np.asarray(batch[input_key], np.float32),
               "target": np.asarray(batch[target_key], np.int32)}
        if frame_mask:
            lengths = batch[input_key + "_length"]
            out["input_mask"] = (np.arange(out["input"].shape[1])[None, :]
                                 < lengths[:, None])
        return out
    return make
