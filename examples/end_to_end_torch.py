"""
End-to-end example on PyTorch and CUDA (``lidbox_tpu_torch``, the
counterpart of examples/end_to_end.py): synthetic 3-language corpus ->
config-driven pipeline (the fused log-Mel CUDA kernel once per
``group_by_input_length`` group on the card) -> x-vector training with
C_avg -> checkpoints -> embedding extraction -> PLDA back-end ->
classification report -> deployment export.

Runs on the card by default; pass ``--device cpu`` to run the plain
PyTorch version on the CPU:

    python examples/end_to_end_torch.py [--device cpu] [--epochs N]
"""
import argparse
import glob
import os
import sys
import tempfile

# runnable without installation: `python examples/end_to_end_torch.py`
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from lidbox_tpu_torch import testutil, util
from lidbox_tpu_torch.data import from_steps, steps as steps_mod
from lidbox_tpu_torch.data.pipelines import create_dataset
from lidbox_tpu_torch.embed import sklearn_utils as backend
from lidbox_tpu_torch.features import io as audio_io
from lidbox_tpu_torch.models.model_utils import ModelWrapper
from lidbox_tpu_torch.train import batches_from_dataset

RATE = 16000
LABELS = ["aa", "bb", "cc"]


def make_corpus(root):
    """Synthetic 'languages' = distinct dominant frequencies."""
    rng = np.random.default_rng(0)
    rows = []
    for lang, freq in zip(LABELS, (120, 300, 520)):
        for i in range(10):
            sig = testutil.noisy_sinewave(freq + int(rng.integers(-25, 25)),
                                          RATE, 0.2, 2.0, seed=i)
            path = os.path.join(root, f"{lang}_{i}.wav")
            audio_io.write_mono_wav(path, sig, RATE)
            rows.append((f"{lang}_{i}", path, lang,
                         "train" if i < 7 else "test"))
    return rows


def main(device="cuda", epochs=10, workdir=None):
    """Run the whole journey on ``device``; returns the back-end's
    classification report."""
    workdir = workdir or tempfile.mkdtemp(prefix="lidbox_tpu_torch_example_")
    corpus = os.path.join(workdir, "corpus")
    os.makedirs(corpus)
    rows = make_corpus(corpus)
    cache = os.path.join(workdir, "cache")

    config = {
        "pre_process": {
            "rms_vad": {"strength": 0.05, "vad_frame_length_ms": 10},
            "chunks": {"length_ms": 1000, "step_ms": 500},
        },
        "features": {"type": "logmelspectrogram",
                     "melspectrogram": {"num_mel_bins": 40},
                     "group_by_input_length": {"max_batch_size": 32},
                     "stft_method": "pallas"},
        "post_process": {"normalize": {"key": "input"}},
        "experiment": {
            "cache_directory": cache,
            "name": "demo",
            "input_shape": [98, 40], "output_shape": [len(LABELS)],
            "model": {"key": "xvector"},
            "optimizer": {"cls": "Adam", "kwargs": {"learning_rate": 2e-3}},
            "loss": {"cls": "SparseCategoricalCrossentropy"},
            "metrics": [{"cls": "SparseAverageDetectionCost", "N": len(LABELS),
                         "threshold_linspace": {"start": -5.0, "stop": 0.0,
                                                "num": 50}}],
            "callbacks": [{"cls": "ModelCheckpoint",
                           "kwargs": {"monitor": "val_loss", "mode": "min"}}],
            "data": {"train": {"split": "train", "shuffle_buffer_size": 128},
                     "test": {"split": "test"}}},
    }

    def split_ds(split):
        init = {"id": [r[0] for r in rows if r[3] == split],
                "path": [r[1] for r in rows if r[3] == split],
                "label": [r[2] for r in rows if r[3] == split]}
        return from_steps(create_dataset(split, LABELS, init, config),
                          device=device)

    train_ds, test_ds = split_ds("train"), split_ds("test")
    name = (torch.cuda.get_device_name(0) if torch.device(device).type == "cuda"
            else "cpu")
    print(f"device: {name}")
    wrapper = ModelWrapper.from_config(config, device=device)
    print(f"model: x-vector, {wrapper.count_params():,} params")
    history = wrapper.fit(batches_from_dataset(train_ds, 32),
                          batches_from_dataset(test_ds, 32), epochs=epochs)
    print("final epoch:", {k: round(v, 4) for k, v in history[-1].items()})

    ckpts = glob.glob(os.path.join(cache, "xvector/demo/checkpoints/*"))
    print(f"checkpoints: {len(ckpts)}")

    # Embeddings from the best checkpoint, then the PLDA back-end.
    emb_conf = {"cache_directory": cache,
                "model": {"key": "xvector"}, "experiment_name": "demo",
                "input_shape": [98, 40], "output_shape": [len(LABELS)],
                "best_checkpoint": {"monitor": "val_loss", "mode": "min"}}
    emb_train = steps_mod.extract_embeddings(
        train_ds, {"extractors": [emb_conf], "batch_size": 32},
        device=device).collect()
    emb_test = steps_mod.extract_embeddings(
        test_ds, {"extractors": [emb_conf], "batch_size": 32},
        device=device).collect()
    label2target = {l: i for i, l in enumerate(LABELS)}

    def as_xy(elems):
        return {"X": np.stack([e["embedding"] for e in elems]),
                "y": np.asarray([label2target[e["label"]] for e in elems])}

    pipeline = backend.fit_classifier(
        as_xy(emb_train), as_xy(emb_test), LABELS,
        {"sklearn_experiment": {"cache_directory": cache,
                                "model": {"key": "xvector"}, "name": "demo"}},
        {v: k for k, v in label2target.items()},
        backend.GaussianNB, plot_demo=False)
    preds = backend.predict_with_trained_classifier(
        as_xy(emb_test), None, None, pipeline)
    report = util.classification_report(as_xy(emb_test)["y"], preds,
                                        label2target)
    print(f"back-end accuracy: {report['accuracy']:.3f}, "
          f"C_avg: {report['avg_detection_cost']:.3f}")

    # Deployment export: spec + weights, and a torch.export forward with a
    # symbolic batch dimension, reloaded and checked against the live
    # model.
    from lidbox_tpu_torch import export as export_mod
    deploy = os.path.join(workdir, "deploy")
    export_mod.save_model(wrapper.model, "xvector", deploy,
                          model_kwargs={"num_outputs": len(LABELS)})
    program = export_mod.load_program(
        export_mod.export_program(wrapper.model, deploy))
    x = torch.as_tensor(np.random.default_rng(1).normal(
        0, 1, (2, 98, 40)).astype(np.float32), device=device)
    with torch.inference_mode():
        np.testing.assert_allclose(program(x).cpu().numpy(),
                                   wrapper.model.apply(x).cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    print(f"exported deployment artifacts to {deploy} "
          "(torch.export forward verified against the live model)")
    print("done; artifacts in", workdir)
    return report


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--epochs", type=int, default=10)
    args = parser.parse_args()
    main(device=args.device, epochs=args.epochs)
