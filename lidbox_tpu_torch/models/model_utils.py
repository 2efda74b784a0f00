"""
Config-driven model wrapper, the training subset (counterpart of
``lidbox_tpu.models.model_utils``; the analogue of the reference's
KerasWrapper, reference: lidbox/models/keras_utils.py:96-214), binding the
model zoo to the Trainer, the optimizers, the metric/callback factories
and the best-by-metric checkpoint layout.

Cache layout parity: ``<cache_directory>/<model key>/<experiment name>``
(reference: keras_utils.py:19-24), checkpoints under ``checkpoints/`` with
metric-bearing filenames.

With ``mesh=`` (a ``parallel.Mesh``) training and embedding extraction
run data-parallel over its ranks.
"""
import os

import numpy as np
import torch

import lidbox_tpu_torch.models as model_registry
from lidbox_tpu_torch import get_logger, parallel
from lidbox_tpu_torch.losses import (AngularProximity, cross_entropy_with_logits,
                                     get_loss, nll_loss, nll_loss_from_probs)
from lidbox_tpu_torch.metrics import (AverageDetectionCost,
                                      SparseAverageDetectionCost)
from lidbox_tpu_torch.train import checkpoint as ckpt_lib
from lidbox_tpu_torch.train.loop import (EarlyStopping, LearningRateDateLogger,
                                         ModelCheckpoint, Trainer)
from lidbox_tpu_torch.train.optimizers import (add_decayed_weights, chain,
                                               optimizer_from_config)

logger = get_logger("models.utils")


def experiment_cache_from_config(config):
    """(reference: keras_utils.py:19-24; sklearn_experiment takes
    precedence over experiment when both exist, reference parity)."""
    if config.get("sklearn_experiment") and config.get("experiment"):
        logger.warning(
            "config defines both 'experiment' and 'sklearn_experiment': "
            "the cache/checkpoint directory resolves under "
            "sklearn_experiment (name=%r), matching the reference's "
            "precedence — embeddings sections pointing at the experiment "
            "name will not find these checkpoints",
            config["sklearn_experiment"].get("name"))
    experiment_config = config.get("sklearn_experiment") or config["experiment"]
    return os.path.join(experiment_config["cache_directory"],
                        experiment_config["model"]["key"],
                        experiment_config["name"])


def best_model_checkpoint_from_config(config):
    """(reference: keras_utils.py:27-38)"""
    checkpoint_callbacks = [d for d in config["experiment"].get("callbacks", [])
                            if d["cls"] == "ModelCheckpoint"]
    kwargs = checkpoint_callbacks[0].get("kwargs", {}) if checkpoint_callbacks else {}
    checkpoints_dir = os.path.join(experiment_cache_from_config(config),
                                   "checkpoints")
    return ckpt_lib.get_best_checkpoint_path(
        checkpoints_dir, key=kwargs.get("monitor"), mode=kwargs.get("mode"))


def init_metric_from_config(config):
    """(reference: keras_utils.py:45-52)"""
    cls = config["cls"]
    if cls.endswith("AverageDetectionCost"):
        lin = config["threshold_linspace"]
        thresholds = np.linspace(lin["start"], lin["stop"], lin["num"]).tolist()
        metric_cls = (SparseAverageDetectionCost if cls.startswith("Sparse")
                      else AverageDetectionCost)
        return metric_cls(config["N"], tuple(thresholds),
                          **config.get("kwargs", {}))
    raise KeyError(f"unknown metric class {cls!r}")


def init_loss_from_config(config, output_activation="log_softmax"):
    """Map reference Keras loss class names onto the loss registry.

    ``output_activation`` is the model head's activation: sparse CCE on a
    log_softmax head is plain NLL, on a softmax head the probabilities get
    a clipped log first (Keras SCC(from_logits=False)), and a bare-logits
    head gets log_softmax folded into the loss."""
    cls = config["cls"]
    kwargs = dict(config.get("kwargs", {}))
    if cls in ("SparseCategoricalCrossentropy", "sparse_categorical_crossentropy"):
        # honor an explicit Keras-style from_logits; anything else unknown
        # raises (the contract of losses.LOSS_REGISTRY)
        from_logits = kwargs.pop("from_logits", None)
        if kwargs:
            raise TypeError(
                "SparseCategoricalCrossentropy only accepts from_logits, "
                f"got {sorted(kwargs)}")
        if from_logits:
            return cross_entropy_with_logits
        if output_activation == "softmax":
            return nll_loss_from_probs
        if not output_activation:  # raw logits head
            return cross_entropy_with_logits
        return nll_loss
    if cls in ("SparseAngularProximity", "AngularProximity"):
        return AngularProximity(**kwargs)
    return get_loss(cls, **kwargs)


def _conv_kernel_decay_mask(params):
    """True for conv-layer kernels (``weight`` of a module whose path has a
    part starting with "conv"): the parameter set the reference
    regularizes with ``kernel_regularizer=l2`` (reference crnn.py:30-38),
    the JAX package's ``_conv_kernel_decay_mask`` on this port's names."""
    def is_conv_kernel(name):
        *path, leaf = name.split(".")
        return leaf == "weight" and any(p.startswith("conv") for p in path)
    return {name: is_conv_kernel(name) for name in params}


def init_callback_from_config(config, cache_dir):
    """(reference: keras_utils.py:55-78)"""
    cls = config["cls"]
    kwargs = dict(config.get("kwargs", {}))

    def _take(supported, cosmetic=()):
        """Split kwargs into supported / tolerated-Keras-cosmetic /
        unknown; unknown (typos, unimplemented behavior switches) raise
        instead of being silently dropped."""
        ignored = sorted(k for k in kwargs if k in cosmetic)
        if ignored:
            logger.warning("callback %s: ignoring Keras-only options %s",
                           cls, ignored)
        unknown = sorted(k for k in kwargs
                         if k not in supported and k not in cosmetic)
        if unknown:
            raise TypeError(f"callback {cls} got unsupported options "
                            f"{unknown} (supported: {sorted(supported)})")
        return {k: v for k, v in kwargs.items() if k in supported}

    if cls == "ModelCheckpoint":
        kwargs.setdefault("checkpoints_dir", os.path.join(cache_dir, "checkpoints"))
        kwargs.pop("filepath", None)
        return ModelCheckpoint(**_take(
            ("checkpoints_dir", "monitor", "mode", "save_best_only",
             "backend"),
            cosmetic=("verbose", "save_weights_only", "save_freq")))
    if cls == "EarlyStopping":
        return EarlyStopping(**_take(
            ("monitor", "mode", "patience", "min_delta",
             "restore_best_weights"),
            cosmetic=("verbose", "baseline")))
    if cls == "LearningRateDateLogger":
        return LearningRateDateLogger()
    if cls == "TensorBoard":
        # no callback: the Trainer's MetricsLogger mirrors its records to
        # TensorBoard (ModelWrapper.from_config passes tensorboard=True)
        return None
    raise KeyError(f"unknown callback class {cls!r}")


class ModelWrapper:
    """Model + Trainer built from a config dict."""

    def __init__(self, model, model_key, trainer):
        self.model = model
        self.model_key = model_key
        self.trainer = trainer
        self.config = None  # set by from_config (fit_fused needs it)
        self.score_fn = None  # outputs -> [B, N] scores; set by from_config
        self.steps_per_dispatch = 1  # feed.steps_per_dispatch from config
        self.cache_shuffle = True

    @property
    def initial_epoch(self):
        """Resume epoch, live from the Trainer (reference
        keras_utils.py:179-202)."""
        return self.trainer.initial_epoch

    @initial_epoch.setter
    def initial_epoch(self, value):
        self.trainer.initial_epoch = int(value)

    @classmethod
    def from_config(cls, config, mesh=None, device="cuda"):
        """(reference: keras_utils.py:124-149). The model, the trainer and
        every step live on ``device``; "cuda" raises without CUDA. With a
        ``parallel.Mesh`` the trainer is data-parallel over its ranks
        (``Trainer``), ``device`` being this rank's card."""
        experiment = config["experiment"]
        cache_dir = experiment_cache_from_config(config)
        os.makedirs(cache_dir, exist_ok=True)
        model_key = experiment["model"]["key"]
        input_shape = tuple(experiment["input_shape"])
        num_outputs = int(np.squeeze(experiment["output_shape"]))
        model = model_registry.create(model_key, input_shape, num_outputs,
                                      device=device,
                                      **experiment["model"].get("kwargs", {}))
        optimizer, lr_schedule = optimizer_from_config(experiment["optimizer"])
        # Keras kernel_regularizer=l2(wd) adds wd * sum(w^2) to the loss, so
        # grad += 2 * wd * w flows through the optimizer: a coupled decay of
        # the conv kernels ahead of it (reference crnn.py:30-38)
        weight_decay = float(getattr(model.module, "weight_decay", 0.0) or 0.0)
        if weight_decay:
            optimizer = chain(add_decayed_weights(2.0 * weight_decay,
                                                  mask=_conv_kernel_decay_mask),
                              optimizer)
        loss = init_loss_from_config(
            experiment["loss"],
            output_activation=getattr(model.module, "output_activation",
                                      "log_softmax"))
        metrics = {}
        for mconf in experiment.get("metrics", []):
            metric = init_metric_from_config(mconf)
            name = mconf.get("name", mconf["cls"])
            if name in metrics:  # the reference kept a LIST: never drop one
                suffix = 2
                while f"{name}_{suffix}" in metrics:
                    suffix += 1
                name = f"{name}_{suffix}"
            metrics[name] = metric
        callbacks = [c for c in
                     (init_callback_from_config(c, cache_dir)
                      for c in experiment.get("callbacks", []))
                     if c is not None]
        compute_dtype = experiment.get("compute_dtype")
        if isinstance(compute_dtype, str):
            compute_dtype = getattr(torch, compute_dtype)
        feed = experiment.get("feed") or {}  # 'feed:' with no children
        # parses to None in YAML
        # Language-vector losses (AngularProximity) expose ``predict``
        # mapping [B, D] vectors -> [B, N] class scores (-theta)
        score_fn = getattr(loss, "predict", None)
        trainer = Trainer(model, optimizer, loss, metrics=metrics,
                          callbacks=callbacks, lr_schedule=lr_schedule,
                          log_dir=os.path.join(cache_dir, "logs"),
                          compute_dtype=compute_dtype, score_fn=score_fn,
                          prefetch=feed.get("prefetch", 4),
                          stage_dtype=feed.get("stage_dtype"),
                          cache_staged=feed.get("cache_staged", False),
                          cache_bytes_limit=feed.get("cache_bytes_limit"),
                          tensorboard=any(
                              c["cls"] == "TensorBoard"
                              for c in experiment.get("callbacks", [])),
                          mesh=mesh, device=device)
        wrapper = cls(model, model_key, trainer)
        wrapper.steps_per_dispatch = int(feed.get("steps_per_dispatch", 1))
        wrapper.cache_shuffle = feed.get("cache_shuffle", True)
        wrapper.score_fn = score_fn
        wrapper.config = config
        return wrapper

    @classmethod
    def from_config_as_embedding_extractor_fn(cls, config, mesh=None,
                                              device="cuda"):
        """Restore the best checkpoint of the config's experiment and
        return an ``inputs [B, T, F] -> embeddings [B, D]`` numpy function
        running on ``device`` (reference: keras_utils.py:151-174). The
        config's ``stage_dtype`` applies (``util.make_batch_predict_fn``).

        With a ``parallel.Mesh`` extraction is data-parallel: every rank
        is handed the same batch, the config's ``batch_size`` (default 32)
        is rounded up to a multiple of the mesh size, each rank embeds its
        rows, and every rank returns the whole batch's embeddings
        (``util.make_batch_predict_fn``)."""
        mesh = parallel.as_mesh(mesh)
        cache_dir = experiment_cache_from_config({"experiment": {
            "cache_directory": config["cache_directory"],
            "model": config["model"],
            "name": config["experiment_name"]}})
        model_key = config["model"]["key"]
        input_shape = tuple(config["input_shape"])
        num_outputs = int(np.squeeze(config["output_shape"]))
        model = model_registry.create(model_key, input_shape, num_outputs,
                                      device=device,
                                      **config["model"].get("kwargs", {}))
        best = ckpt_lib.get_best_checkpoint_path(
            os.path.join(cache_dir, "checkpoints"),
            key=config["best_checkpoint"].get("monitor"),
            mode=config["best_checkpoint"].get("mode"))
        if best is None:
            raise FileNotFoundError(
                f"no checkpoints under {cache_dir}/checkpoints")
        logger.info("Restoring extractor weights from %s", best)
        raw = ckpt_lib.load_raw_checkpoint(best)
        model.module.load_state_dict({**raw["params"],
                                      **(raw.get("batch_stats") or {})})
        extractor = model_registry.as_embedding_extractor(model_key, model)

        from lidbox_tpu_torch.util import make_batch_predict_fn
        batch_size = int(config.get("batch_size", 32))
        if mesh is not None:
            batch_size = -(-batch_size // mesh.size) * mesh.size
        predict_fn = make_batch_predict_fn(
            extractor, batch_size=batch_size, mesh=mesh,
            apply_kwargs={"output": "embedding"},
            stage_dtype=config.get("stage_dtype"))
        return lambda x: predict_fn(np.asarray(x))

    def fit(self, train_batches, validation_batches, **kwargs):
        """(reference: keras_utils.py:191-203). The config's
        ``feed.steps_per_dispatch`` and ``feed.cache_shuffle`` apply,
        overridable per call."""
        kwargs.setdefault("steps_per_dispatch", self.steps_per_dispatch)
        kwargs.setdefault("cache_shuffle", self.cache_shuffle)
        return self.trainer.fit(train_batches, validation_batches, **kwargs)

    def fit_fused(self, signal_batches, epochs=1, sample_rate=None,
                  verbose=True, val_signal_batches=None,
                  val_feature_batches=None, steps_per_dispatch=None):
        """Train from raw waveform batches (train.signal_batches_from_dataset)
        through the fused chain declared in the config's ``features``
        section and its ``on_device_augment`` subsection: every step
        augments and featurizes its batch on the device (with
        ``stft_method: "pallas"`` the fused log-Mel kernel) and trains on
        it. Validation batches are featurized clean (same features config,
        augmentation stripped) and evaluated after every epoch. The
        config's ``experiment.feed`` applies: ``stage_dtype``,
        ``steps_per_dispatch`` (overridable per call), ``cache_staged``,
        ``cache_shuffle`` and ``cache_bytes_limit``. (The JAX package's
        fit_fused leaves ``cache_shuffle`` at True whatever the config
        says; here the config's value holds.)
        """
        from lidbox_tpu_torch.data import on_device
        features_conf = dict((self.config or {}).get("features") or {})
        if "on_device_augment" not in features_conf:
            raise ValueError(
                "fit_fused needs a features.on_device_augment config section")
        if sample_rate is None:
            if "sample_rate" not in features_conf:
                # a silent 16 kHz default would compute the mel filterbank
                # for the wrong rate on e.g. an 8 kHz telephone corpus
                raise ValueError(
                    "fit_fused needs the audio sample rate: set "
                    "features.sample_rate in the config (the fused chain "
                    "builds rate-dependent stages ahead of the data)")
            sample_rate = int(features_conf["sample_rate"])
        feature_fn = on_device.feature_fn_from_config(
            sample_rate, features_conf, device=self.trainer.device)
        val_feature_fn = None
        if val_signal_batches is not None:
            clean_conf = {k: v for k, v in features_conf.items()
                          if k != "on_device_augment"}
            val_feature_fn = on_device.feature_fn_from_config(
                sample_rate, clean_conf, device=self.trainer.device)
        return on_device.fit_signals(self.trainer, feature_fn, signal_batches,
                                     epochs=epochs, verbose=verbose,
                                     val_batches=val_signal_batches,
                                     val_feature_fn=val_feature_fn,
                                     val_feature_batches=val_feature_batches,
                                     steps_per_dispatch=(
                                         self.steps_per_dispatch
                                         if steps_per_dispatch is None
                                         else steps_per_dispatch),
                                     cache_shuffle=self.cache_shuffle)

    def count_params(self):
        return self.model.num_params()

    def __str__(self):
        return f"{self.model_key}: {self.model.module}"
