"""
The training loop: hand-written optimizer updates, eager PyTorch steps and
checkpoint hooks (counterpart of ``lidbox_tpu.train.loop``).

Replaces the reference's Keras ``compile``/``fit`` path
(reference: lidbox/models/keras_utils.py:124-149, 191-203) with an explicit
functional loop, as the JAX package does:

- TrainState (step, params, batch_stats, opt_state): the float32 master
  parameters are a dict name -> tensor apart from the module's own, and
  every step makes new tensors (nothing in a state is written in place),
- one train step: the forward runs on the state's tensors through
  ``torch.func.functional_call``, ``torch.autograd.grad`` takes the
  gradients, the optimizer (``train/optimizers.py``) the update,
- eval steps stream the C_avg metric as counter tensors on the device,
  read back once per evaluation,
- Python callback hooks (ModelCheckpoint, EarlyStopping, LR logger) with
  the reference's best-by-metric checkpoint naming and ``initial_epoch``
  resume.

Host batches reach the device through one ordered prefetch thread (pinned
memory, non_blocking copies on the current stream). Dropout draws from a
``torch.Generator`` the Trainer owns. The module is put in training mode
for a train step only, and back in eval mode after.

Not ported yet, and raising (ROADMAP queue 1): ``mesh`` and
``param_sharding`` (item 12), ``steps_per_dispatch > 1``,
``cache_staged`` / ``cache_bytes_limit`` and ``stage_dtype`` (item 7),
``remat`` (item 6).
"""
import dataclasses
import queue
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch

from lidbox_tpu_torch import RANDOM_SEED, get_device, get_logger
from lidbox_tpu_torch.data.dataset import padded_batch
from lidbox_tpu_torch.models.model_api import functional_forward
from lidbox_tpu_torch.train import checkpoint as ckpt_lib
from lidbox_tpu_torch.train.observability import MetricsLogger, ThroughputMeter
from lidbox_tpu_torch.train.optimizers import apply_updates

logger = get_logger("train.loop")


def _not_ported(name, item):
    raise NotImplementedError(f"{name} is not ported yet (ROADMAP queue 1, "
                              f"item {item})")


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
    ``backend="orbax"`` is not ported (ROADMAP queue 1, item 6)."""

    def __init__(self, checkpoints_dir, monitor="val_loss", mode="min",
                 save_best_only=False, backend="msgpack"):
        if backend == "orbax":
            _not_ported("the Orbax checkpoint backend", 6)
        if backend != "msgpack":
            raise ValueError(f"unknown checkpoint backend {backend!r} "
                             "(expected 'msgpack' or 'orbax')")
        self.checkpoints_dir = checkpoints_dir
        self.monitor = monitor
        self.mode = mode
        self.save_best_only = save_best_only
        self.best = None
        self.backend = backend

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
        ckpt_lib.save_checkpoint(self.checkpoints_dir, trainer.state,
                                 epoch=epoch, val_loss=fname_val)


class EarlyStopping(Callback):
    """Stop training when the monitored metric stops improving by
    ``min_delta`` for ``patience`` epochs (Keras EarlyStopping semantics;
    reference: lidbox/models/keras_utils.py:74-78). State resets on every
    train begin.

    ``restore_best_weights``: when stopping, restore the params and
    batch_stats of the best-monitored epoch. Holding that epoch's state
    tensors is enough: no train step writes into a state's tensors."""

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
                self._best_state = (trainer.state.params,
                                    trainer.state.batch_stats)
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
        rng: integer seed of the Trainer's ``torch.Generator`` (dropout);
            default RANDOM_SEED.
        compute_dtype: e.g. torch.bfloat16: forwards run on parameters and
            inputs cast to it, while master parameters, optimizer state,
            loss and gradients stay float32.
        device: the model's device; default "cuda", which raises without
            CUDA.
    """

    def __init__(self, model, optimizer, loss_fn, metrics=None, mesh=None,
                 callbacks: Sequence[Callback] = (), lr_schedule=None,
                 log_dir=None, rng=None, compute_dtype=None,
                 param_sharding=None, prefetch=4, stage_dtype=None,
                 score_fn=None, cache_staged=False, cache_bytes_limit=None,
                 device="cuda"):
        for name, value, item in (("mesh", mesh, 12),
                                  ("param_sharding", param_sharding, 12),
                                  ("stage_dtype", stage_dtype, 7),
                                  ("cache_bytes_limit", cache_bytes_limit, 7)):
            if value is not None:
                _not_ported(name, item)
        if cache_staged:
            _not_ported("cache_staged", 7)
        self.device = get_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the "
                             f"trainer on {self.device}")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.compute_dtype = compute_dtype
        self.prefetch = max(1, int(prefetch))
        # Maps raw model outputs -> per-class scores [B, N] for metrics
        # (None = identity; AngularProximity.predict for language vectors)
        self.score_fn = score_fn
        self.remat = False
        self.metrics = dict(metrics or {})
        self.callbacks = list(callbacks)
        self.lr_schedule = lr_schedule
        self.stop_training = False
        self.initial_epoch = 0
        self.generator = torch.Generator(device=self.device).manual_seed(
            RANDOM_SEED if rng is None else int(rng))
        self.metrics_logger = MetricsLogger(log_dir) if log_dir else None
        self.state = None

    # -- state --------------------------------------------------------------

    def create_state(self):
        """A fresh TrainState from copies of the model's weights (so the
        model stays servable while the state trains)."""
        module = self.model.module
        params = {k: p.detach().clone() for k, p in module.named_parameters()}
        batch_stats = {k: b.detach().clone()
                       for k, b in module.named_buffers()}
        self.state = TrainState(step=0, params=params,
                                batch_stats=batch_stats,
                                opt_state=self.optimizer.init(params))
        return self.state

    def restore(self, checkpoint_path):
        """Resume from a checkpoint; sets initial_epoch from the filename
        (reference: keras_utils.py:187-189, 202)."""
        if self.state is None:
            self.create_state()
        self.state = ckpt_lib.restore_checkpoint(checkpoint_path, self.state)
        self.initial_epoch = ckpt_lib.initial_epoch_from_path(checkpoint_path)
        self.sync_model_variables()
        return self.state

    def sync_model_variables(self):
        """Copy the current trained weights into the model's module, so the
        model is directly servable after fit/restore."""
        if self.state is None:
            return
        with torch.no_grad():
            for k, p in self.model.module.named_parameters():
                p.copy_(self.state.params[k])
            for k, b in self.model.module.named_buffers():
                b.copy_(self.state.batch_stats[k])

    def current_learning_rate(self):
        if self.lr_schedule is None:
            return float("nan")
        if callable(self.lr_schedule):
            return float(self.lr_schedule(self.state.step if self.state else 0))
        return float(self.lr_schedule)

    # -- steps --------------------------------------------------------------

    def _apply(self, params, batch_stats, batch, train, generator=None):
        """Model outputs of one batch on the given state tensors, with the
        module in training mode only for the call when ``train``. The
        batch stats come back unchanged: no ported model updates buffers
        in training (BatchNorm comes with ROADMAP queue 1, item 9)."""
        kwargs = {"output": self.model.output}
        if "input_mask" in batch:
            kwargs["mask"] = batch["input_mask"]
        if train:
            kwargs["generator"] = generator
        module = self.model.module
        module.train(train)
        try:
            out = functional_forward(module, params, batch_stats,
                                     batch["input"],
                                     compute_dtype=self.compute_dtype,
                                     **kwargs)
        finally:
            module.eval()
        return out, batch_stats

    @staticmethod
    def _masked_mean(losses, batch):
        if "example_mask" in batch:
            m = batch["example_mask"].to(losses.dtype)
            return torch.sum(losses * m) / torch.clamp(torch.sum(m), min=1.0)
        return torch.mean(losses)

    def _loss_and_grads(self, state, batch, generator=None):
        """Forward and backward of one batch: (loss as a 0-dim device
        tensor, the example-mask mean; grads in params' order; new batch
        stats)."""
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        with torch.enable_grad():
            outputs, new_bs = self._apply(params, state.batch_stats, batch,
                                          train=True, generator=generator)
            loss = self._masked_mean(
                self.loss_fn(batch["target"], outputs), batch)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(state.params.items(), grads)}
        return loss.detach(), grads, new_bs

    def _apply_gradients(self, state, grads, new_bs):
        """The optimizer update: a new state one step on."""
        updates, new_opt_state = self.optimizer.update(
            grads, state.opt_state, state.params)
        return TrainState(step=state.step + 1,
                          params=apply_updates(state.params, updates),
                          batch_stats=new_bs, opt_state=new_opt_state)

    def _train_step(self, state, batch, generator=None):
        """One step: forward, loss (example-mask mean), gradients, update.
        Returns (new state, loss as a 0-dim device tensor)."""
        loss, grads, new_bs = self._loss_and_grads(state, batch, generator)
        return self._apply_gradients(state, grads, new_bs), loss

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

    # -- host loop ----------------------------------------------------------

    @staticmethod
    def _batch_rows(batch):
        """Leading dim of a batch dict: from ``target`` when present, else
        ``input`` (predict() feeds unlabeled batches), else any value."""
        for key in ("target", "input"):
            if key in batch:
                return int(np.shape(batch[key])[0])
        return int(np.shape(next(iter(batch.values())))[0])

    def _put(self, batch):
        """A host batch dict on the trainer's device."""
        return {k: to_device(v, self.device) for k, v in batch.items()}

    def _staged(self, batches, count_fn=None, put=None):
        """Iterate ``batches`` with up to ``self.prefetch`` staged batches
        ready ahead: one producer thread
        drains the (possibly slow) batch iterator, in order, and stages
        each batch with ``put`` (default ``_put``), so host-side batching
        and pinning overlap the device running earlier steps.

        Yields ``(n, staged_batch)`` with ``n`` from ``count_fn`` (default
        the batch's rows)."""
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
                    if not offer((count_fn(b), put(b))):
                        return  # the consumer closed early
            except Exception as e:  # re-raised in the consumer
                err.append(e)
            finally:
                offer(done)

        t = threading.Thread(target=producer, name="lidbox-stage", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
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

        Not ported yet (ROADMAP queue 1, item 7): ``steps_per_dispatch >
        1`` and ``cache_staged`` (so ``cache_shuffle`` has nothing to
        shuffle)."""
        if int(steps_per_dispatch) > 1:
            _not_ported("steps_per_dispatch > 1", 7)
        if cache_staged:
            _not_ported("cache_staged", 7)
        if self.remat:
            _not_ported("remat", 6)
        if self.state is None:
            self.create_state()
        # a fresh fit() trains anew even if a previous fit on this trainer
        # was stopped early (Keras resets the flag on fit entry)
        self.stop_training = False
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
            batches = (train_batches() if callable(train_batches)
                       else train_batches)
            source = self._staged(batches)
            try:
                for n, batch in source:
                    if (steps_per_epoch is not None
                            and len(losses) >= steps_per_epoch):
                        break
                    self.state, loss = self._train_step(self.state, batch,
                                                        self.generator)
                    meter.update(n)
                    losses.append(loss)
            finally:
                # release the producer thread and its staged batches on
                # every exit (normal, truncation, a raising train step)
                source.close()
            train_loss = (float(torch.stack(losses).mean()) if losses
                          else float("nan"))
            logs = {"loss": train_loss, **meter.rates(),
                    "learning_rate": self.current_learning_rate()}
            if validation_batches is not None:
                logs.update(self.evaluate(validation_batches))
            history.append(logs)
            if self.metrics_logger:
                self.metrics_logger.log(epoch, logs)
            if verbose:
                logger.info("epoch %d/%d: %s", epoch, epochs,
                            " ".join(f"{k}={v:.6g}" for k, v in logs.items()))
            for cb in self.callbacks:
                cb.on_epoch_end(self, epoch, logs)
        self.sync_model_variables()
        for cb in self.callbacks:
            cb.on_train_end(self)
        return history

    def evaluate(self, batches, prefix="val_", staged=False):
        """Evaluate ``batches`` (host batch dicts, staged through _put
        unless ``staged=True``, in which case they are (n, batch) pairs
        already on the device). Loss sums, counts and metric states
        accumulate on the device and are read back once."""
        if self.state is None:
            self.create_state()
        metric_states = {name: m.init_state(self.device)
                         for name, m in self.metrics.items()}
        total = count = None
        it = batches() if callable(batches) else batches
        source = it if staged else self._staged(it)
        try:
            for _, batch in source:
                loss_sum, n, metric_states = self._eval_step(
                    self.state, batch, metric_states)
                total = loss_sum if total is None else total + loss_sum
                count = n if count is None else count + n
        finally:
            if hasattr(source, "close"):
                source.close()  # release staging on any exit path
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
    def predict(self, batches):
        """Model outputs for every batch, concatenated on the host. Each
        batch's readback lags one forward behind, so the next forward is
        queued before the host waits."""
        if self.state is None:
            self.create_state()
        outs = []
        prev = None
        source = self._staged(batches)
        try:
            for n, batch in source:
                out, _ = self._apply(self.state.params,
                                     self.state.batch_stats, batch,
                                     train=False)
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
