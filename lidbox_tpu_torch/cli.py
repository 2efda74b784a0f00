"""
Command line interface (counterpart of ``lidbox_tpu.cli``: the same
subcommands, arguments, outputs and exit codes over the same config-dict
contract):

    python -m lidbox_tpu_torch train config.json [--resume]
    python -m lidbox_tpu_torch evaluate config.json
    python -m lidbox_tpu_torch extract-embeddings config.json out.npz
    python -m lidbox_tpu_torch classify config.json a.wav b.mp3
    python -m lidbox_tpu_torch export config.json out_dir --torch-export
    python -m lidbox_tpu_torch utils --validate-config config.json

Every command but ``utils`` runs on ``--device`` (default ``cuda``) and
fails without CUDA unless ``--device cpu`` is given.
``--data-parallel`` (``train``, ``evaluate``, ``extract-embeddings``,
``classify``) runs the command over a ``parallel.get_mesh()``: launch it
once per card with the JAX package's variables (``COORDINATOR_ADDRESS``,
``NUM_PROCESSES``, ``PROCESS_ID``); without them it is a 1-rank mesh on
the one card. Every rank reads the whole corpus and feeds its rows of
each global batch (``parallel.local_batches``), so the run gives the
mesh-less numbers of the same batch size; rank 0 alone writes the
command's output. Configs are JSON, or YAML when the ``yaml`` package
imports. Metadata comes from a ``metadata`` section: either ``csv:
<path>`` (columns: id, path, label, split[, duration]) or
``common_voice: {corpus_dir, langs}``. The best checkpoint of the
experiment cache may be this package's or the JAX package's, a ``.ckpt``
file or an Orbax directory (``ModelCheckpoint`` with ``backend: orbax``).
``export --platforms cuda,cpu`` writes one program for every named device
(the JAX package's ``gpu`` is ``cuda``).
"""
import argparse
import csv
import io
import json
import math
import os
import sys

import numpy as np

from lidbox_tpu_torch import get_device, get_logger

logger = get_logger("cli")

REQUIRED_CONFIG_KEYS = ("metadata",)


def load_config(path):
    with open(path, encoding="utf-8") as f:
        if str(path).endswith((".yaml", ".yml")):
            try:
                import yaml
            except ImportError as e:
                raise RuntimeError(
                    f"{path}: YAML configs need the 'yaml' package, which "
                    "is not installed here; write the config as JSON") from e
            return yaml.safe_load(f)
        return json.load(f)


def _is_dtype_name(name):
    import torch
    return isinstance(getattr(torch, str(name), None), torch.dtype)


def validate_config(config):
    problems = []
    for key in REQUIRED_CONFIG_KEYS:
        if key not in config:
            problems.append(f"missing required config section '{key}'")
    if "experiment" in config:
        for key in ("cache_directory", "name", "model", "input_shape",
                    "output_shape", "optimizer", "loss"):
            if key not in config["experiment"]:
                problems.append(f"missing experiment key '{key}'")
    meta = config.get("metadata", {})
    if meta and not ("csv" in meta or "common_voice" in meta):
        problems.append("metadata section must define 'csv' or 'common_voice'")
    features = config.get("features") or {}
    aug = features.get("on_device_augment")
    if aug is not None:
        aug = aug or {}
        if "sample_rate" not in features:
            problems.append(
                "features.on_device_augment requires features.sample_rate "
                "(the fused chain compiles rate-dependent stages ahead of "
                "the data)")
        if (aug.get("snr_range") is not None
                and not aug.get("noise_paths")
                and not aug.get("noise_datadir")):
            problems.append(
                "on_device_augment.snr_range is set but no noise source is "
                "configured (noise_paths or noise_datadir)")
    for cb in config.get("experiment", {}).get("callbacks", []) or []:
        if cb.get("cls") not in ("ModelCheckpoint", "EarlyStopping",
                                 "LearningRateDateLogger", "TensorBoard"):
            problems.append(f"unknown callback cls {cb.get('cls')!r}")
    feed = config.get("experiment", {}).get("feed") or {}
    if feed:
        known = {"prefetch", "stage_dtype", "steps_per_dispatch",
                 "cache_staged", "cache_shuffle"}
        cs = feed.get("cache_shuffle", True)
        if cs not in (True, False, "rows"):
            problems.append(
                f"experiment.feed.cache_shuffle must be true, false, or "
                f"'rows', got {cs!r}")
        for key in set(feed) - known:
            problems.append(f"unknown experiment.feed key '{key}' "
                            f"(valid: {sorted(known)})")
        sd = feed.get("stage_dtype")
        if sd is not None and not _is_dtype_name(sd):
            problems.append(f"experiment.feed.stage_dtype {sd!r} is "
                            "not a dtype (use e.g. bfloat16 or int16)")
    return problems


def load_metadata(config):
    """(metadata table, sorted labels); the table keeps the CSV's row
    order, as the JAX package's DataFrame does."""
    meta_conf = config["metadata"]
    if "csv" in meta_conf:
        from lidbox_tpu_torch.meta import read_csv, set_unique_index
        meta = set_unique_index(read_csv(meta_conf["csv"]))
    elif "common_voice" in meta_conf:
        from lidbox_tpu_torch.meta import common_voice
        cv = meta_conf["common_voice"]
        meta = common_voice.load_all(cv["corpus_dir"], cv["langs"])
    else:
        raise ValueError("metadata section must define 'csv' or 'common_voice'")
    labels = sorted(set(meta["label"]))
    return meta, labels


def build_split_dataset(split, meta, labels, config, device="cuda"):
    from lidbox_tpu_torch.data import from_steps
    if config.get("user_script"):
        # A config can replace the whole pipelines module with a user
        # script defining create_dataset (reference: lidbox/data/pipelines.py:3).
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "lidbox_tpu_torch_user_script", config["user_script"])
        user_mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(user_mod)
        create_dataset = user_mod.create_dataset
    else:
        from lidbox_tpu_torch.data.pipelines import create_dataset
    rows = [i for i, s in enumerate(meta["split"]) if s == split]
    init_data = {k: [meta[k][i] for i in rows] for k in ("id", "path", "label")}
    return from_steps(create_dataset(split, labels, init_data, config),
                      device=device)


def _mesh(args):
    """The command's mesh: every rank of the group under
    ``--data-parallel`` (``parallel.get_mesh``), else None."""
    if not getattr(args, "data_parallel", False):
        return None
    from lidbox_tpu_torch import parallel
    return parallel.get_mesh(device=args.device)


def _writes(mesh):
    """True on the rank that writes a command's output (rank 0 of a mesh,
    or the one process)."""
    return mesh is None or mesh.rank == 0


def _local(batches, mesh):
    """This rank's rows of each global batch under a mesh."""
    if mesh is None:
        return batches
    from lidbox_tpu_torch import parallel
    return parallel.local_batches(batches, mesh)


def cmd_train(args):
    config = load_config(args.config)
    meta, labels = load_metadata(config)
    from lidbox_tpu_torch.models.model_utils import ModelWrapper
    from lidbox_tpu_torch.train import batches_from_dataset

    data_conf = config["experiment"]["data"]
    train_split = data_conf["train"]["split"]
    val_split = data_conf.get("validation", data_conf.get("test", {})).get(
        "split", train_split)
    train_ds = build_split_dataset(train_split, meta, labels, config,
                                   args.device)
    val_ds = build_split_dataset(val_split, meta, labels, config, args.device)

    mesh = _mesh(args)
    wrapper = ModelWrapper.from_config(config, mesh=mesh, device=args.device)
    if getattr(args, "resume", False):
        # resume from the LATEST checkpoint (greatest epoch; this package's
        # or the JAX package's); epoch numbering continues from the
        # checkpoint name (reference resume semantics,
        # keras_utils.py:187-203)
        from lidbox_tpu_torch.models.model_utils import \
            experiment_cache_from_config
        from lidbox_tpu_torch.train import get_best_checkpoint_path
        latest = get_best_checkpoint_path(
            os.path.join(experiment_cache_from_config(config), "checkpoints"))
        if latest:
            wrapper.trainer.restore(latest)
            logger.info("Resuming from %s (epoch %d)", latest,
                        wrapper.trainer.initial_epoch)
        else:
            logger.warning("--resume: no checkpoints found, starting fresh")
    logger.info("Training %s (%d params) on split '%s'",
                wrapper.model_key, wrapper.count_params(), train_split)
    batch_size = data_conf["train"].get("batch_size", 32)
    epochs = config["experiment"].get("epochs", 1)
    if "on_device_augment" in config.get("features", {}):
        # fused route: the pipeline stopped at raw signals; augmentation
        # and features run inside the training step
        from lidbox_tpu_torch.train import signal_batches_from_dataset
        logger.info("Fused on-device augmentation enabled "
                    "(features.on_device_augment)")
        # non-train splits featurize CLEAN through the pipeline (augmentation
        # is train-only), so validation comes as feature batches
        val_feature_batches = (batches_from_dataset(val_ds, batch_size,
                                                    frame_mask=True)
                               if val_split != train_split else
                               signal_batches_from_dataset(val_ds, batch_size))
        val_feature_batches = _local(val_feature_batches, mesh)
        kwargs = ({"val_feature_batches": val_feature_batches}
                  if val_split != train_split else
                  {"val_signal_batches": val_feature_batches})
        history = wrapper.fit_fused(
            _local(signal_batches_from_dataset(train_ds, batch_size), mesh),
            epochs=epochs,
            sample_rate=config.get("features", {}).get("sample_rate"),
            **kwargs)
        logger.info("Training done, final fused epoch: %s",
                    history[-1] if history else None)
        return 0
    history = wrapper.fit(
        _local(batches_from_dataset(train_ds, batch_size), mesh),
        _local(batches_from_dataset(val_ds, batch_size), mesh),
        epochs=epochs)
    logger.info("Training done, final: %s", history[-1] if history else {})
    return 0


def _wrapper_with_best_checkpoint(config, device):
    """ModelWrapper.from_config with the best checkpoint's weights loaded
    into the model (fresh weights, with a warning, when the experiment
    cache has no checkpoint yet)."""
    from lidbox_tpu_torch.models.model_utils import (
        ModelWrapper, best_model_checkpoint_from_config)
    wrapper = ModelWrapper.from_config(config, device=device)
    best = best_model_checkpoint_from_config(config)
    if best:
        wrapper.trainer.restore(best)  # also copies the weights to the model
    else:
        logger.warning("no checkpoint found; using fresh weights")
    return wrapper


def cmd_evaluate(args):
    config = load_config(args.config)
    meta, labels = load_metadata(config)
    from lidbox_tpu_torch import util
    from lidbox_tpu_torch.meta import generate_label2target

    test_split = config["experiment"]["data"].get("test", {}).get("split", "test")
    test_ds = build_split_dataset(test_split, meta, labels, config,
                                  args.device)
    wrapper = _wrapper_with_best_checkpoint(config, args.device)
    meta_with_targets, label2target = generate_label2target(meta)
    rows = [i for i, s in enumerate(meta_with_targets["split"])
            if s == test_split]
    test_meta = {"id": [meta_with_targets["id"][i] for i in rows],
                 "target": meta_with_targets["target"][rows]}
    mesh = _mesh(args)
    report = util.evaluate_testset_with_model(
        wrapper.model, test_ds, test_meta, label2target,
        score_fn=wrapper.score_fn, mesh=mesh)
    if not _writes(mesh):
        return 0
    print(json.dumps({k: (v.tolist() if isinstance(v, np.ndarray) else v)
                      for k, v in report.items()}, indent=2))
    return 0


def cmd_extract_embeddings(args):
    config = load_config(args.config)
    meta, labels = load_metadata(config)
    if "embeddings" not in config:
        logger.error("config has no 'embeddings' section")
        return 1
    mesh = _mesh(args)
    if mesh is not None:
        # declarative: the extract_embeddings step builds the mesh
        config["embeddings"]["data_parallel"] = True
    ds = build_split_dataset(args.split, meta, labels, config, args.device)
    ids, embeddings = [], []
    for x in ds:
        ids.append(str(x["id"]))
        embeddings.append(np.asarray(x["embedding"]))
    if not _writes(mesh):
        return 0
    np.savez(args.output, ids=np.asarray(ids),
             embeddings=np.stack(embeddings))
    logger.info("Wrote %d embeddings to %s", len(ids), args.output)
    return 0


def _csv_cell(value):
    """A cell as ``DataFrame.to_csv`` writes it: numpy floats in their
    shortest repr, NaN empty."""
    if isinstance(value, (float, np.floating)):
        return "" if math.isnan(value) else str(value)
    return str(value)


def table_to_csv(table):
    """A table (dict of columns with ``"id"`` first) as the CSV text
    ``DataFrame.to_csv()`` gives for the same frame indexed by id."""
    out = io.StringIO()
    writer = csv.writer(out, lineterminator="\n")
    columns = list(table)
    writer.writerow(columns)
    for i in range(len(table["id"])):
        writer.writerow([_csv_cell(table[c][i]) for c in columns])
    return out.getvalue()


def cmd_classify(args):
    """Classify audio files from the shell: best checkpoint -> language
    scores per utterance (CSV on stdout or --output). The reference had no
    serving path at all; classification lived in notebooks
    (reference: lidbox/util.py:23-57). Under ``--data-parallel`` the
    batch size is rounded up to a multiple of the mesh size."""
    config = load_config(args.config)
    _, labels = load_metadata(config)
    from lidbox_tpu_torch import serve

    wrapper = _wrapper_with_best_checkpoint(config, args.device)
    mesh = _mesh(args)
    batch_size = args.batch_size
    if mesh is not None:
        batch_size = -(-batch_size // mesh.size) * mesh.size
    clf = serve.Classifier(
        wrapper.model, labels,
        feature_config=config.get("features"),
        chunk_length_ms=args.chunk_length_ms,
        chunk_step_ms=args.chunk_step_ms,
        batch_size=batch_size, mesh=mesh, score_fn=wrapper.score_fn,
        stage_dtype=args.stage_dtype, device=args.device)
    out = clf.classify(args.audio_files)
    if not _writes(mesh):
        return 0
    text = table_to_csv(out)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(text)
        logger.info("Wrote %d classifications to %s", len(out["id"]),
                    args.output)
    else:
        print(text, end="")
    return 0


def cmd_export(args):
    """Export the best checkpoint as a deployment artifact: architecture
    spec + weights (export.save_model, readable by both packages),
    optionally an ahead-of-time ``torch.export`` forward (--torch-export)
    with a symbolic batch dimension so one file serves every batch size
    (the reference's deployment analogue was the hand-run tfjs-converter,
    reference: lidbox/models/xvector_stats_pooling.js). ``--platforms``
    names the devices the program deploys to, and implies
    ``--torch-export``."""
    config = load_config(args.config)
    from lidbox_tpu_torch import export as export_mod

    platforms = (export_mod.torch_platforms(args.platforms.split(","))
                 if args.platforms else None)

    wrapper = _wrapper_with_best_checkpoint(config, args.device)
    exp = config["experiment"]
    model_kwargs = dict(exp["model"].get("kwargs", {}))
    model_kwargs["num_outputs"] = int(np.squeeze(exp["output_shape"]))
    export_mod.save_model(wrapper.model, exp["model"]["key"], args.output,
                          model_kwargs=model_kwargs)
    if args.torch_export or platforms:
        export_mod.export_program(wrapper.model, args.output,
                                  batch_size=args.batch_size,
                                  platforms=platforms)
    return 0


def cmd_utils(args):
    if args.validate_config:
        config = load_config(args.validate_config)
        problems = validate_config(config)
        if problems:
            for p in problems:
                print(f"ERROR: {p}")
            return 1
        print("config ok")
    return 0


def create_argparser():
    parser = argparse.ArgumentParser(
        prog="lidbox_tpu_torch",
        description="Spoken language identification on PyTorch and CUDA")
    parser.add_argument("--device", default=None,
                        help="torch device of every command but utils "
                             "(default cuda; fails without CUDA unless "
                             "'cpu' is given)")
    parser.add_argument("--run-cProfile", action="store_true",
                        help="profile host Python, writing cProfile.log "
                             "(reference: lidbox/__main__.py:13-20)")
    parser.add_argument("--run-torch-profiler", metavar="DIR", default=None,
                        help="capture a torch.profiler trace into DIR "
                             "(the analogue of --run-tf-profiler)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="train a model from a config file")
    p.add_argument("config")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in the "
                        "experiment cache (this package's or the JAX "
                        "package's)")
    p.add_argument("--data-parallel", action="store_true",
                   help="train data-parallel over the process group's "
                        "ranks, one card each (a 1-rank mesh without "
                        "COORDINATOR_ADDRESS)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("evaluate", help="evaluate the best checkpoint")
    p.add_argument("config")
    p.add_argument("--data-parallel", action="store_true",
                   help="predict data-parallel over the process group's "
                        "ranks")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("extract-embeddings", help="dump embeddings to npz")
    p.add_argument("config")
    p.add_argument("output")
    p.add_argument("--split", default="test")
    p.add_argument("--data-parallel", action="store_true",
                   help="extract data-parallel over the process group's "
                        "ranks")
    p.set_defaults(fn=cmd_extract_embeddings)

    p = sub.add_parser("classify",
                       help="classify audio files with the best checkpoint")
    p.add_argument("config")
    p.add_argument("audio_files", nargs="+")
    p.add_argument("--output", default=None,
                   help="write CSV here instead of stdout")
    p.add_argument("--chunk-length-ms", type=int, default=None,
                   help="score fixed chunks and average per utterance")
    p.add_argument("--chunk-step-ms", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--stage-dtype", default=None,
                   help="compress the feature feed host-side (e.g. "
                        "bfloat16): half the host->device bytes; scores "
                        "differ only by input rounding")
    p.add_argument("--data-parallel", action="store_true",
                   help="run inference batches data-parallel over the "
                        "process group's ranks")
    p.set_defaults(fn=cmd_classify)

    p = sub.add_parser("export",
                       help="export the best checkpoint as a deployment "
                            "artifact (spec + weights, optional "
                            "torch.export program)")
    p.add_argument("config")
    p.add_argument("output", help="output directory")
    p.add_argument("--torch-export", action="store_true",
                   help="also export the forward ahead of time with "
                        "torch.export (runnable without model code)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="concrete batch for --torch-export "
                        "(default: symbolic, serves any batch size)")
    p.add_argument("--platforms", default=None,
                   help="comma-separated devices the --torch-export program "
                        "deploys to, e.g. cuda,cpu (checked on each; "
                        "implies --torch-export)")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("utils", help="config validation and helpers")
    p.add_argument("--validate-config", metavar="CONFIG")
    p.set_defaults(fn=cmd_utils)
    return parser


def main(argv=None, device="cuda"):
    """Run one command; returns its exit code. ``--device`` overrides
    ``device``."""
    args = create_argparser().parse_args(argv)
    args.device = args.device or device
    if args.cmd != "utils":
        try:  # no CUDA and no --device cpu: fail before any work
            get_device(args.device)
        except RuntimeError as e:
            raise RuntimeError(f"{e} (on the command line: --device cpu)") \
                from None
    from lidbox_tpu_torch.train.observability import cprofile, profiler
    with cprofile(enabled=args.run_cProfile), \
            profiler(args.run_torch_profiler,
                     enabled=bool(args.run_torch_profiler)):
        return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
