"""Layers, the loss and Adam in plain PyTorch, for the reference models.

Activations are [batch, time, channels]. Parameters are a dict of tensors
under the names of the benchmark's weight layout: a convolution's weight
is [out, in, kernel], a dense layer's [out, in], a GRU direction's input
weights ``ir``/``iz``/``in`` [units, in] with biases, and hidden weights
``hr``/``hz``/``hn`` [units, units] with a bias on ``hn`` only.
"""
import torch
import torch.nn.functional as F

BN_EPSILON = 1e-3
VARIANCE_FLOOR = 1e-10


def causal_conv(x, weight, bias, stride):
    """Causal 1-D convolution (left pad kernel - 1): [B, T, Cin] ->
    [B, ceil(T / stride), Cout]."""
    k = weight.shape[-1]
    y = F.conv1d(F.pad(x.transpose(1, 2), (k - 1, 0)), weight, bias,
                 stride=stride)
    return y.transpose(1, 2)


def dense(x, params, name):
    return x @ params[f"{name}.weight"].T + params[f"{name}.bias"]


def mean_stddev_pooling(x):
    """Concatenated mean and standard deviation over time, the variance
    floored at 1e-10: [B, T, C] -> [B, 2C]."""
    mean = x.mean(dim=1)
    var = ((x - mean[:, None]) ** 2).mean(dim=1)
    return torch.cat([mean, torch.sqrt(torch.clamp(var, min=VARIANCE_FLOOR))],
                     dim=-1)


def batch_norm_train(x, params, name):
    """Batch normalization with the batch's statistics over axis 0 (the
    biased variance), epsilon 1e-3, then scale and bias."""
    mean = x.mean(dim=0)
    var = ((x - mean) ** 2).mean(dim=0)
    return ((x - mean) / torch.sqrt(var + BN_EPSILON)
            * params[f"{name}.scale"] + params[f"{name}.bias"])


def gru_direction(x, lengths, params, name, reverse):
    """One GRU direction over each row's first ``lengths[b]`` steps of
    [B, T, I]; with ``reverse`` over that prefix backwards. Returns
    (outputs [B, T, U] in the input's time order, zero past each length;
    the final states [B, U]):
    r = s(W_ir x + b_ir + W_hr h), z = s(W_iz x + b_iz + W_hz h),
    n = tanh(W_in x + b_in + r (W_hn h + b_hn)), h' = (1 - z) n + z h."""
    B, T, _ = x.shape
    lengths = torch.as_tensor(lengths, device=x.device)
    t = torch.arange(T, device=x.device)
    if reverse:
        idx = torch.where(t[None] < lengths[:, None],
                          lengths[:, None] - 1 - t[None], t[None])
        x = torch.take_along_dim(x, idx[..., None], dim=1)
    w_i = torch.cat([params[f"{name}.i{g}.weight"] for g in "rzn"])
    b_i = torch.cat([params[f"{name}.i{g}.bias"] for g in "rzn"])
    w_h = torch.cat([params[f"{name}.h{g}.weight"] for g in "rzn"])
    units = w_h.shape[1]
    b_hn = params[f"{name}.hn.bias"]
    xi = x @ w_i.T + b_i
    h = x.new_zeros(B, units)
    outs = []
    for step in range(T):
        xr, xz, xn = xi[:, step].split(units, dim=-1)
        hr, hz, hn = (h @ w_h.T).split(units, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * (hn + b_hn))
        valid = (step < lengths)[:, None]
        h = torch.where(valid, (1 - z) * n + z * h, h)
        outs.append(torch.where(valid, h, torch.zeros_like(h)))
    y = torch.stack(outs, dim=1)
    if reverse:
        y = torch.take_along_dim(y, idx[..., None], dim=1)
    return y, h


def bidirectional_gru(x, lengths, params, name, cell_names):
    """Forward and backward directions concatenated: ([B, T, 2U] outputs,
    [B, 2U] the forward direction's last valid step and the backward
    direction's step 0)."""
    yf, hf = gru_direction(x, lengths, params, f"{name}.{cell_names[0]}",
                           False)
    yb, hb = gru_direction(x, lengths, params, f"{name}.{cell_names[1]}",
                           True)
    return torch.cat([yf, yb], dim=-1), torch.cat([hf, hb], dim=-1)


def nll(log_probs, targets):
    """Mean negative log-likelihood of the targets."""
    return -log_probs.gather(1, targets[:, None]).mean()


class Adam:
    """Adam with bias correction (Kingma and Ba 2015; optax's form:
    update = -lr * m_hat / (sqrt(v_hat) + eps))."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.count = 0
        self.mu = self.nu = None

    def step(self, params, grads):
        """New parameters (a dict) after one update with ``grads``."""
        if self.mu is None:
            self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
            self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = self.b1 * self.mu[k] + (1.0 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1.0 - self.b2) * g * g
            out[k] = p - self.lr * (self.mu[k] / c1) / (
                torch.sqrt(self.nu[k] / c2) + self.eps)
        return out
