"""ECAPA-TDNN (Desplanques, Thienpondt and Demuynck 2020, Interspeech,
arXiv:2005.07143) with the classifier head of SpeechBrain's VoxLingua107
language identifier (speechbrain/lang-id-voxlingua107-ecapa;
lobes/models/ECAPA_TDNN.py, Xvector.py::Classifier), in plain float64
PyTorch, on a padded batch whose row b has ``lengths[b]`` valid frames.

``TDNN(i -> o, k, d)``: Conv1d with zero "same" padding and a bias on the
input zeroed past each row's length, ReLU, batch normalization over the
batch's valid frames. Activations are [B, C, T].

- input: x - its mean over the row's valid frames;
- block 0: TDNN(F -> C, k0, d0);
- SE-Res2Net block b: r = x; x = TDNN(C -> C, 1)(x); chunks x_0 .. x_{s-1}
  of C / s channels, y_0 = x_0, y_1 = T_1(x_1), y_i = T_i(x_i + y_{i-1}),
  T_i = TDNN(C/s -> C/s, k_b, d_b), concatenated; x = TDNN(C -> C, 1)(x);
  s = sigmoid(W2 relu(W1 mean(x) + b1) + b2), the mean over valid frames;
  s x + r;
- MFA: the SE-Res2Net blocks' outputs concatenated, TDNN(nC -> C', k, d);
- attentive statistics pooling: mu, sigma the mean and standard deviation
  of h (zero past each row's length) over valid frames (sigma =
  sqrt(clamp(var, 1e-12))); a =
  Conv(A -> C')(tanh(TDNN(3C' -> A, 1)([h; mu; sigma]))); alpha = softmax
  of a over the valid frames, per channel (over every frame in a row with
  none); [sum alpha h; sqrt(clamp(sum alpha (h - mu~)^2, 1e-12))];
- embedding: batch normalization, Linear(2C' -> E);
- classifier: LeakyReLU(0.01), batch normalization, then per block
  Linear, LeakyReLU, batch normalization; Linear to the outputs;
  log-softmax.

Batch normalization uses the batch's statistics (the biased variance), as
in training, with the configuration's epsilon. Counts are floored at 1.

Departures from SpeechBrain (also the configuration's ``assumed``): zero
padding where it reflects; statistics over valid frames where its
BatchNorm counts padding; the benchmark's log-Mel features where it takes
Fbank.
"""
import contextlib

import torch
import torch.nn.functional as F

STD_CLAMP = 1e-12
LEAKY_SLOPE = 0.01


@contextlib.contextmanager
def _float32_products():
    """TF32 off in cuBLAS and cuDNN while the reference runs (float64
    products never use it; the reference holds to it whatever it is
    handed), as it was after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _blocks(config):
    """(in, out, kernel, dilation) of block 0, of each SE-Res2Net block,
    and of MFA."""
    c, k, d = config["channels"], config["kernel_sizes"], config["dilations"]
    first = (config["features"]["num_mel_bins"], c[0], k[0], d[0])
    middle = [(c[i - 1], c[i], k[i], d[i]) for i in range(1, len(c) - 1)]
    return first, middle, (sum(c[1:-1]), c[-1], k[-1], d[-1])


def _conv(name, cin, cout, kernel):
    return [(f"{name}.weight", (cout, cin, kernel), ("fan_in", cin * kernel)),
            (f"{name}.bias", (cout,), "zeros")]


def _norm(name, width):
    return [(f"{name}.scale", (width,), "ones"),
            (f"{name}.bias", (width,), "zeros"),
            (f"{name}.mean", (width,), "zeros"),
            (f"{name}.var", (width,), "ones")]


def _tdnn(name, cin, cout, kernel):
    return _conv(f"{name}.conv", cin, cout, kernel) + _norm(f"{name}.norm",
                                                            cout)


def _dense(name, cin, cout):
    return [(f"{name}.weight", (cout, cin), ("fan_in", cin)),
            (f"{name}.bias", (cout,), "zeros")]


def param_specs(config):
    """[(name, shape, init)] in the benchmark's weight layout; init is
    ("fan_in", n), "zeros" or "ones"."""
    first, middle, mfa = _blocks(config)
    scale, se = config["res2net_scale"], config["se_channels"]
    specs = _tdnn("blocks.0", *first[:3])
    for b, (_, c, k, _) in enumerate(middle, 1):
        p = f"blocks.{b}"
        specs += _tdnn(f"{p}.tdnn1", c, c, 1)
        for i in range(scale - 1):
            specs += _tdnn(f"{p}.res2net.blocks.{i}", c // scale,
                           c // scale, k)
        specs += _tdnn(f"{p}.tdnn2", c, c, 1)
        specs += _conv(f"{p}.se.conv1", c, se, 1) + _conv(f"{p}.se.conv2",
                                                          se, c, 1)
    specs += _tdnn("mfa", *mfa[:3])
    width, attention = mfa[1], config["attention_channels"]
    specs += _tdnn("asp.tdnn", 3 * width, attention, 1)
    specs += _conv("asp.conv", attention, width, 1)
    specs += _norm("asp_bn", 2 * width)
    specs += _dense("fc", 2 * width, config["embedding_dim"])
    width = config["embedding_dim"]
    specs += _norm("norm", width)
    for i in range(config["classifier_blocks"]):
        specs += _dense(f"dnn.{i}.linear", width,
                        config["classifier_neurons"])
        width = config["classifier_neurons"]
        specs += _norm(f"dnn.{i}.norm", width)
    specs += _dense("out", width, config["num_outputs"])
    return specs


def forward(params, feats, config, lengths=None):
    """Log-probabilities [B, num_outputs] of [B, T, num_mel_bins] features
    whose row b has ``lengths[b]`` valid frames (all T when None)."""
    with _float32_products():
        return _forward(params, feats, config, lengths)


def _forward(params, feats, config, lengths):
    B, T, _ = feats.shape
    if lengths is None:
        lengths = [T] * B
    lengths = torch.as_tensor(lengths, device=feats.device)
    valid = torch.arange(T, device=feats.device)[None] < lengths[:, None]
    m = valid[:, None, :].to(feats.dtype)
    count = torch.clamp(lengths, min=1).to(feats.dtype)[:, None, None]
    eps = config["batch_norm"]["epsilon"]

    def frame_norm(x, name):
        total = torch.clamp(m.sum(), min=1.0)
        mean = (x * m).sum(dim=(0, 2), keepdim=True) / total
        var = (((x - mean) * m) ** 2).sum(dim=(0, 2), keepdim=True) / total
        return ((x - mean) / torch.sqrt(var + eps)
                * params[f"{name}.scale"][:, None]
                + params[f"{name}.bias"][:, None])

    def conv(x, name, dilation=1):
        return F.conv1d(x * m, params[f"{name}.weight"],
                        params[f"{name}.bias"], dilation=dilation,
                        padding="same")

    def tdnn(x, name, dilation=1):
        return frame_norm(torch.relu(conv(x, f"{name}.conv", dilation)),
                          f"{name}.norm")

    def time_mean(x):
        return (x * m).sum(dim=2, keepdim=True) / count

    first, middle, mfa = _blocks(config)
    scale = config["res2net_scale"]
    x = feats.transpose(1, 2)
    x = x - time_mean(x)
    x = tdnn(x, "blocks.0", first[3])
    outs = []
    for b, (_, _, _, d) in enumerate(middle, 1):
        p = f"blocks.{b}"
        r = x
        chunks = torch.chunk(tdnn(x, f"{p}.tdnn1"), scale, dim=1)
        ys = [chunks[0]]
        for i in range(1, scale):
            ys.append(tdnn(chunks[i] if i == 1 else chunks[i] + ys[-1],
                           f"{p}.res2net.blocks.{i - 1}", d))
        x = tdnn(torch.cat(ys, dim=1), f"{p}.tdnn2")
        s = time_mean(x)  # [B, C, 1]
        for name, act in (("conv1", torch.relu), ("conv2", torch.sigmoid)):
            s = act(F.conv1d(s, params[f"{p}.se.{name}.weight"],
                             params[f"{p}.se.{name}.bias"]))
        x = s * x + r
        outs.append(x)
    # zero past each row's length: a row with no valid frame pools zeros
    h = tdnn(torch.cat(outs, dim=1), "mfa", mfa[3]) * m

    def moments(weights):
        mean = (weights * h).sum(dim=2, keepdim=True)
        var = (weights * (h - mean) ** 2).sum(dim=2, keepdim=True)
        return mean, torch.sqrt(torch.clamp(var, min=STD_CLAMP))

    mu, sigma = moments(m / count)
    context = torch.cat([h, mu.expand(-1, -1, T), sigma.expand(-1, -1, T)],
                        dim=1)
    a = conv(torch.tanh(tdnn(context, "asp.tdnn")), "asp.conv")
    has_valid = (lengths > 0)[:, None, None]
    a = a.masked_fill(~valid[:, None, :] & has_valid, float("-inf"))
    mu, sigma = moments(torch.softmax(a, dim=2))
    x = torch.cat([mu, sigma], dim=1)[..., 0]

    def norm(x, name):
        mean = x.mean(dim=0)
        var = ((x - mean) ** 2).mean(dim=0)
        return ((x - mean) / torch.sqrt(var + eps) * params[f"{name}.scale"]
                + params[f"{name}.bias"])

    def dense(x, name):
        return x @ params[f"{name}.weight"].T + params[f"{name}.bias"]

    x = dense(norm(x, "asp_bn"), "fc")
    x = norm(F.leaky_relu(x, LEAKY_SLOPE), "norm")
    for i in range(config["classifier_blocks"]):
        x = norm(F.leaky_relu(dense(x, f"dnn.{i}.linear"), LEAKY_SLOPE),
                 f"dnn.{i}.norm")
    return torch.log_softmax(dense(x, "out"), dim=-1)


def macs(config, frames):
    """(forward multiply-adds of one utterance over ``frames`` valid
    frames, those of the first layer): every convolution over every frame
    (block 0, the SE-Res2Net blocks' TDNNs, MFA, the attention's TDNN and
    convolution), the squeeze-excitations' and the head's products once an
    utterance. The pooling's weighted sums, like the normalizations, count
    nothing."""
    first, middle, mfa = _blocks(config)
    scale, se = config["res2net_scale"], config["se_channels"]
    attention = config["attention_channels"]
    head = frames * first[0] * first[1] * first[2]
    total = head
    for _, c, k, _ in middle:
        width = c // scale
        total += frames * (2 * c * c + (scale - 1) * width * width * k)
        total += 2 * c * se
    total += frames * mfa[0] * mfa[1] * mfa[2]
    total += frames * (3 * mfa[1] * attention + attention * mfa[1])
    width = config["embedding_dim"]
    total += 2 * mfa[1] * width
    for _ in range(config["classifier_blocks"]):
        total += width * config["classifier_neurons"]
        width = config["classifier_neurons"]
    total += width * config["num_outputs"]
    return total, head
