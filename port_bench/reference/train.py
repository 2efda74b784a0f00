"""The first steps of training, from the benchmark's waveform batches.

Each step: the batch as 16-bit PCM (``wav.pcm_values``), the energy
VAD where the traffic turns it on, the log-Mel of each row's kept samples,
the model's forward over each row's frames, the mean negative
log-likelihood, its gradient by autograd, and Adam's update; float64
throughout."""
import torch

from . import logmel, nn, vad, wav


def is_buffer(name):
    """Batch normalization's running statistics: weights that no gradient
    moves."""
    return name.endswith(".mean") or name.endswith(".var")


def batch_features(signals, features, vad_args=None):
    """([B, frames, mel] zero-padded float64 features, per-row frame
    counts) of an int16 or float [B, T] numpy batch on
    ``features["device"]``."""
    x = torch.as_tensor(wav.pcm_values(signals),
                        device=features.get("device", "cpu"))
    rows = []
    for row in x:
        if vad_args is not None:
            row = vad.remove_silence(row, features["sample_rate"], **vad_args)
        rows.append(logmel.logmel_of(row, features))
    lengths = [r.shape[0] for r in rows]
    out = x.new_zeros(len(rows), max(lengths), rows[0].shape[1])
    for i, r in enumerate(rows):
        out[i, :r.shape[0]] = r
    return out, lengths


def train_steps(model, params, batches, config, vad_args=None, device="cpu",
                dtype=torch.float64):
    """Adam steps over ``batches`` ((signals [B, T], targets [B]) numpy
    pairs) from ``params`` (name -> tensor). Returns (losses, the first
    step's gradients, the parameters after the last step), float64."""
    features = dict(config["features"], device=device)
    opt = config["optimizer"]
    adam = nn.Adam(opt["learning_rate"], opt["beta_1"], opt["beta_2"],
                   opt["epsilon"])
    params = {k: torch.as_tensor(v, device=device).to(dtype)
              for k, v in params.items()}
    names = [k for k in params if not is_buffer(k)]
    losses, first_grads = [], None
    for signals, targets in batches:
        feats, lengths = batch_features(signals, features, vad_args)
        feats = feats.to(dtype)
        live = {k: v.detach().requires_grad_(k in names)
                for k, v in params.items()}
        log_probs = model.forward(live, feats, config,
                                  lengths if vad_args is not None else None)
        loss = nn.nll(log_probs, torch.as_tensor(targets, device=device,
                                                 dtype=torch.int64))
        grads = dict(zip(names, torch.autograd.grad(
            loss, [live[k] for k in names])))
        if first_grads is None:
            first_grads = grads
        params.update(adam.step({k: params[k] for k in names}, grads))
        losses.append(float(loss.detach()))
    return losses, first_grads, params
