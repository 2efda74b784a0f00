"""
Declarative config -> Step-list compiler (counterpart of
``lidbox_tpu.data.pipelines``; reference: lidbox/data/pipelines.py:20-142).

Config sections are interpreted in the same order as the reference:
``post_initialize`` -> audio loading -> ``pre_process`` (filters, VAD,
repeat, augment, chunks, cache) -> ``features`` -> ``post_process``
(filters, chunks, normalize, shuffle, tensorboard, remap, cache) ->
``experiment`` shuffle -> ``embeddings``.

The Step lists are the JAX package's, key for key and kwarg for kwarg; the
device is chosen when they run (``steps.from_steps(steps, device=...)``).
The reference's ``user_script`` key, which replaces this module's
``create_dataset`` from the command line, is read by the CLI
(``cli.py``).
"""
import os

from lidbox_tpu_torch.data.steps import Step
from lidbox_tpu_torch.models.model_utils import experiment_cache_from_config


def _get_cache_steps(config, split):
    """(reference: lidbox/data/pipelines.py:10-17)"""
    yield Step("cache", {
        "directory": os.path.join(config["directory"], "dataset", split),
        "cache_key": config.get("key"),
        # default matches steps.cache/cache_to_file (batched pickle
        # records; per-element dumps are pickle-overhead-bound)
        "batch_size": config.get("batch_size", 64)})
    if config.get("consume", True):
        yield Step("consume", {"log_interval": config.get("log_interval", -1)})


def create_dataset(split, labels, init_data, config):
    """Compile the config into an ordered Step list for one split.

    Args:
        split: split key (e.g. "train").
        labels: all labels from all datasets (ordering defines targets).
        init_data: columnar metadata for this split.
        config: full config dict (see docs/config.md).
    """
    steps = [Step("initialize", {"labels": labels, "init_data": init_data})]

    post_init = config.get("post_initialize", {})
    if post_init:
        if "file_limit" in post_init:
            steps.append(Step("lambda", {
                "fn": lambda ds, n=post_init["file_limit"]: ds.take(n)}))
        if "shuffle_buffer_size" in post_init:
            steps.append(Step("shuffle", {
                "buffer_size": post_init["shuffle_buffer_size"]}))
        if "binary_classification" in post_init:
            steps.append(Step("convert_to_binary_classification", {
                "positive_class": post_init["binary_classification"]}))
        if post_init.get("check_wav_headers", False):
            steps.append(Step("drop_invalid_wavs", {}))

    features_conf = config.get("features", {})
    if features_conf.get("type") != "kaldi":
        steps.extend([
            Step("load_audio", {
                "num_prefetch": post_init.get("num_prefetched_signals")}),
            Step("drop_empty", {})])

    pre = config.get("pre_process", {})
    if pre:
        if "filters" in pre:
            steps.append(Step("apply_filters", {"config": pre["filters"]}))
        if "webrtcvad" in pre or "rms_vad" in pre:
            if "webrtcvad" in pre:
                steps.append(Step("compute_webrtc_vad", pre["webrtcvad"]))
            else:
                steps.append(Step("compute_rms_vad", pre["rms_vad"]))
            steps.extend([Step("apply_vad", {}), Step("drop_empty", {})])
        if "repeat_too_short_signals" in pre:
            steps.append(Step("repeat_too_short_signals",
                              pre["repeat_too_short_signals"]))
        if "augment" in pre:
            augment_configs = [c for c in pre["augment"] if c["split"] == split]
            if augment_configs:
                steps.append(Step("augment_signals",
                                  {"augment_configs": augment_configs}))
        if "chunks" in pre:
            steps.append(Step("create_signal_chunks", pre["chunks"]))
        if "cache" in pre:
            steps.extend(_get_cache_steps(pre["cache"], split))

    if features_conf:
        if features_conf.get("type") == "kaldi":  # 'type' is optional
            # (DeviceFeatureExtractor defaults to logmelspectrogram)
            steps.append(Step("load_kaldi_data",
                              {"shape": features_conf["kaldi"]["shape"]}))
        elif "on_device_augment" in features_conf:
            # fused on-device chain: the TRAIN pipeline stops at raw
            # signals; augmentation + features run inside the training
            # step itself (on_device.feature_fn_from_config,
            # ModelWrapper.fit_fused). Every other split featurizes CLEAN
            # (augmentation is train-only), so evaluate / embeddings /
            # classification work on the same config.
            train_split = (config.get("experiment", {}).get("data", {})
                           .get("train", {}).get("split", "train"))
            if split != train_split:
                clean = {k: v for k, v in features_conf.items()
                         if k != "on_device_augment"}
                steps.append(Step("extract_features", {"config": clean}))
        else:
            steps.append(Step("extract_features", {"config": features_conf}))

    post = config.get("post_process", {})
    if post:
        if "filters" in post:
            steps.append(Step("apply_filters", {"config": post["filters"]}))
        if "chunks" in post:
            steps.append(Step("create_input_chunks", post["chunks"]))
        if "normalize" in post:
            steps.append(Step("normalize", {"config": post["normalize"]}))
        if "shuffle_buffer_size" in post:
            steps.append(Step("shuffle",
                              {"buffer_size": post["shuffle_buffer_size"]}))
        if "tensorboard" in post:
            steps.append(Step("consume_to_tensorboard", {
                "summary_dir": os.path.join(
                    experiment_cache_from_config(config),
                    "tensorboard", "dataset", split),
                "config": post["tensorboard"]}))
        if "remap_keys" in post:
            steps.append(Step("remap_keys", {"new_keys": post["remap_keys"]}))
        if "cache" in post:
            steps.extend(_get_cache_steps(post["cache"], split))

    if "experiment" in config:
        for experiment_conf in config["experiment"].get("data", {}).values():
            if (experiment_conf.get("split") == split
                    and "shuffle_buffer_size" in experiment_conf):
                steps.append(Step("shuffle", {
                    "buffer_size": experiment_conf["shuffle_buffer_size"]}))
                break

    if "embeddings" in config:
        steps.append(Step("extract_embeddings", {"config": config["embeddings"]}))
        if "remap_keys" in config["embeddings"]:
            steps.append(Step("remap_keys",
                              {"new_keys": config["embeddings"]["remap_keys"]}))
        if "cache" in config["embeddings"]:
            steps.extend(_get_cache_steps(config["embeddings"]["cache"], split))
    return steps
