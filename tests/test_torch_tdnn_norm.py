"""
The fused tail of ECAPA-TDNN's ``TDNN`` (``ops/tdnn_norm.py``): conv bias,
ReLU, BatchNorm over the valid frames and the frame mask.

On the CPU, in float64 at [4, 128, 40]:

- the plain form of the tail, ``tdnn_norm_plain`` (the conv's bias folded
  in), meets the composed ``TDNN`` (``Conv1d`` with its bias, ReLU,
  ``layers.BatchNorm(mask=)``, the mask): the output, the batch statistics
  and every gradient (z, the bias, scale and shift), over a masked batch,
  a batch with a row of no valid frame, and a batch with every frame
  valid;
- a ``TDNN`` whose route is forced to the kernels' (the plain form on the
  CPU) meets the composed one: output, collected statistics, gradients;
- ``route`` takes the kernels only for a training-mode forward of a CUDA
  float32 input under a frame mask with no mesh, whose channel fits, and
  the composition for the CPU, float64, bfloat16, eval, an unmasked batch,
  an active mesh and a channel too long; ``cluster_split`` and
  ``vector_width`` at the widths ECAPA runs;
- a CPU training forward of the model counts ``norm_composed`` for each of
  its TDNNs and no ``norm_fused``; eval counts neither; the kernels' launch
  counts read zero on the CPU.

Tests marked ``cuda`` need the card and skip without one: the kernels
against ``tdnn_norm_plain`` in float32 at [32, 128, 298], [32, 1024, 298]
and [32, 3072, 298] (VAD-like lengths, one row empty): y, the mean and
variance, and every gradient, one launch of each kernel counted on the
card; then forward and backward captured in a CUDA graph and replayed
twice, bit for bit the eager run, each replay counted; and a training-mode
``TDNN`` under a frame mask takes the kernels (one launch of each, one
``norm_fused``) and meets the composed TDNN's output and statistics. This
file imports no
JAX; on the card run them with
``python -m pytest --noconftest tests/test_torch_tdnn_norm.py -m cuda``.
"""
import collections
import types

import pytest
import torch

from lidbox_tpu_torch import parallel
from lidbox_tpu_torch.models import ecapa_tdnn, layers
from lidbox_tpu_torch.ops import tdnn_norm
from lidbox_tpu_torch.train import observability

torch.set_num_threads(2)

B, C, T, IN = 4, 128, 40, 8
EPSILON = ecapa_tdnn.BN_EPSILON
LENGTHS = {"masked": [40, 33, 21, 9], "empty_row": [40, 0, 17, 26],
           "all_valid": [40, 40, 40, 40]}
# TDNNs of the small model below: block 0, per SE-Res2Net block tdnn1, 7
# Res2Net chunks and tdnn2, MFA, the pooling's attention TDNN
SMALL = {"channels": [64, 64, 64, 64, 192], "res2net_scale": 8,
         "se_channels": 16, "attention_channels": 16, "embedding_dim": 32,
         "classifier_neurons": 24}
TDNNS = 1 + 3 * (1 + 7 + 1) + 1 + 1
# ECAPA's widths at [32, C, 298] on an H100 (132 SMs)
H100_SMS = 132


def frame_mask(lengths, steps=T):
    return torch.arange(steps)[None, :] < torch.tensor(lengths)[:, None]


def tdnn(seed=0, dtype=torch.float64):
    torch.manual_seed(seed)
    module = ecapa_tdnn.TDNN(IN, C, 3, 2).to(dtype).train()
    with torch.no_grad():
        module.norm.scale.uniform_(0.5, 1.5)
        module.norm.bias.uniform_(-0.5, 0.5)
    return module


def inputs(seed=1, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, IN, T, generator=g, dtype=dtype),
            torch.randn(B, C, T, generator=g, dtype=dtype))


def run_tdnn(module, x, mask, weights):
    """Output, collected statistics and gradients (x, conv weight, conv
    bias, scale, shift) of ``module`` on ``x`` under ``mask``."""
    module.zero_grad()
    x = x.clone().requires_grad_(True)
    with layers.collect_batch_stats(module) as stats:
        y = module(x, ecapa_tdnn.Frames.of(mask, x.dtype))
    (y * weights).sum().backward()
    return (y.detach(), dict(stats), x.grad,
            [p.grad.clone() for p in module.parameters()])


@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_plain_tail_meets_composed_tdnn(case):
    module = tdnn()
    x, weights = inputs()
    mask = frame_mask(LENGTHS[case])
    with torch.no_grad():
        z0 = torch.nn.functional.conv1d(x, module.conv.weight, None,
                                        padding="same", dilation=2)
    # the composition: TDNN's own forward, its conv's gradient read at z
    z = z0.clone().requires_grad_(True)
    conv_out = z + module.conv.bias[:, None]
    composed = module.norm(torch.relu(conv_out), mask) * mask[:, None, :]
    with layers.collect_batch_stats(module) as stats:
        composed_y = module(x, ecapa_tdnn.Frames.of(mask, x.dtype))
    torch.testing.assert_close(composed, composed_y, rtol=1e-12, atol=1e-12)
    params = [module.conv.bias, module.norm.scale, module.norm.bias]
    want = torch.autograd.grad((composed * weights).sum(), [z] + params)

    zp = z0.clone().requires_grad_(True)
    y, mean, var = tdnn_norm.tdnn_norm_plain(
        zp, module.conv.bias, module.norm.scale, module.norm.bias, mask,
        EPSILON)
    got = torch.autograd.grad((y * weights).sum(), [zp] + params)
    torch.testing.assert_close(y, composed, rtol=1e-12, atol=1e-12)
    m = module.norm.momentum
    torch.testing.assert_close(m * module.norm.mean + (1 - m) * mean,
                               stats["norm.mean"].double(), rtol=1e-6,
                               atol=1e-7)
    torch.testing.assert_close(m * module.norm.var + (1 - m) * var,
                               stats["norm.var"].double(), rtol=1e-6,
                               atol=1e-7)
    for name, g, w in zip(("z", "bias", "scale", "shift"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12, msg=name)
    if case == "empty_row":
        assert not y[1].any() and not got[0][1].any()


@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_fused_route_meets_composition(case, monkeypatch):
    x, weights = inputs(seed=2)
    mask = frame_mask(LENGTHS[case])
    composed = run_tdnn(tdnn(seed=3), x, mask, weights)
    monkeypatch.setattr(tdnn_norm, "route", lambda *args: "fused")
    with observability.tallying(collections.Counter()) as counted:
        fused = run_tdnn(tdnn(seed=3), x, mask, weights)
    assert counted == {"stats_masked": 1, "norm_fused": 1}
    torch.testing.assert_close(fused[0], composed[0], rtol=1e-12, atol=1e-12)
    assert fused[1].keys() == composed[1].keys() == {"norm.mean", "norm.var"}
    for k in fused[1]:
        torch.testing.assert_close(fused[1][k], composed[1][k])
    torch.testing.assert_close(fused[2], composed[2], rtol=1e-10, atol=1e-12)
    for g, w in zip(fused[3], composed[3]):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)


def stand_in(dtype=torch.float32, cuda=True, shape=(32, 1024, 298)):
    """What ``route`` reads of the convolution's input."""
    return types.SimpleNamespace(is_cuda=cuda, dtype=dtype,
                                 shape=torch.Size(shape))


MASK = torch.ones(32, 298, dtype=torch.bool)


@pytest.mark.parametrize("x, mask, training, mesh, want", [
    (stand_in(), MASK, True, None, "fused"),
    (stand_in(shape=(32, 128, 298)), MASK, True, None, "fused"),
    (stand_in(cuda=False), MASK, True, None, "composed"),
    (stand_in(torch.float64), MASK, True, None, "composed"),
    (stand_in(torch.bfloat16), MASK, True, None, "composed"),
    (stand_in(), MASK, False, None, "composed"),
    (stand_in(), None, True, None, "composed"),
    (stand_in(), MASK, True, object(), "composed"),
    # a channel that 8 blocks cannot hold: 4 rows each of 8000 frames
    (stand_in(shape=(32, 128, 8000)), MASK, True, None, "composed"),
])
def test_route(x, mask, training, mesh, want, monkeypatch):
    monkeypatch.setattr(parallel, "active_mesh", lambda: mesh)
    assert tdnn_norm.route(x, mask, training) == want


def test_route_of_real_tensors():
    x = torch.zeros(2, 3, 5)
    mask = torch.ones(2, 5, dtype=torch.bool)
    assert tdnn_norm.route(x, mask, True) == "composed"  # the CPU
    assert tdnn_norm.route(x.double(), mask, True) == "composed"


@pytest.mark.parametrize("channels, value_bytes, want", [
    (128, tdnn_norm.FORWARD_BYTES, 4), (128, tdnn_norm.BACKWARD_BYTES, 4),
    (1024, tdnn_norm.FORWARD_BYTES, 1), (1024, tdnn_norm.BACKWARD_BYTES, 2),
    (3072, tdnn_norm.FORWARD_BYTES, 1), (3072, tdnn_norm.BACKWARD_BYTES, 2),
])
def test_cluster_split_at_ecapa_widths(channels, value_bytes, want):
    split = tdnn_norm.cluster_split(channels, 32, 298, value_bytes, H100_SMS)
    assert split == want
    assert (tdnn_norm.held_bytes(32, 298, split, value_bytes)
            <= tdnn_norm.SMEM_TARGET)


def test_cluster_split_limits():
    # never more blocks than rows, nor a split that is not a power of two
    assert tdnn_norm.cluster_split(4, 5, 298, 9, H100_SMS) == 4
    assert tdnn_norm.cluster_split(4, 1, 298, 9, H100_SMS) == 1
    assert tdnn_norm.cluster_split(128, 32, 8000, 9, H100_SMS) is None
    assert tdnn_norm.fits(32, 298) and not tdnn_norm.fits(32, 8000)


def test_vector_width():
    base = torch.zeros(64)
    assert tdnn_norm.vector_width(296, base) == 4
    assert tdnn_norm.vector_width(298, base) == 2
    assert tdnn_norm.vector_width(299, base) == 1
    # 8-byte aligned data takes 8-byte loads at most
    assert tdnn_norm.vector_width(296, base[2:]) == 2
    assert tdnn_norm.vector_width(296, base, base[1:]) == 1
    mask = torch.ones(80, dtype=torch.bool)
    assert tdnn_norm.vector_width(296, base, mask[2:]) == 2


def test_cpu_training_forward_counts_composed_tails():
    model = ecapa_tdnn.ECAPATDNN(20, 5, **SMALL).train()
    x = torch.randn(B, T, 20, generator=torch.Generator().manual_seed(4))
    mask = frame_mask(LENGTHS["masked"])
    for m in (mask, None):
        with observability.tallying(collections.Counter()) as counted:
            model(x, mask=m)
        assert counted["norm_composed"] == TDNNS
        assert "norm_fused" not in counted
    model.eval()
    with observability.tallying(collections.Counter()) as counted:
        with torch.no_grad():
            model(x, mask=mask)
    assert "norm_composed" not in counted and "norm_fused" not in counted


def test_launch_counts_on_the_cpu():
    tdnn_norm.reset_launch_counts("cpu")
    assert tdnn_norm.launch_counts("cpu") == {"tdnn_norm_forward": 0,
                                              "tdnn_norm_backward": 0}


# --- on the card ---------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# VAD-like valid lengths of [32, 298] crops (216-276 frames), one row empty
CARD_LENGTHS = [0] + [216 + (37 * i) % 61 for i in range(1, 32)]
# float32 kernel against the float32 plain form on the same card: y and
# dz element-wise within 2e-5 of their largest magnitude (a channel's
# statistics are float32 sums of 9,536 values in two orders), the
# per-channel sums within 1e-4 of theirs
ELEMENT_TOL, SUM_TOL = 2e-5, 1e-4
ONE_EACH = {"tdnn_norm_forward": 1, "tdnn_norm_backward": 1}


def card_operands(channels, device, seed=5):
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(32, channels, 298, generator=g, device=device)
    bias = 0.3 * torch.randn(channels, generator=g, device=device)
    scale = 1 + 0.2 * torch.randn(channels, generator=g, device=device)
    shift = 0.2 * torch.randn(channels, generator=g, device=device)
    dy = torch.randn(32, channels, 298, generator=g, device=device)
    mask = frame_mask(CARD_LENGTHS, 298).to(device)
    return z, bias, scale, shift, mask, dy


def tail_and_grads(fn, z, bias, scale, shift, mask, dy):
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (z, bias, scale, shift)]
    y, mean, var = fn(*leaves, mask, EPSILON)
    grads = torch.autograd.grad(y, leaves, dy)
    return [y.detach(), mean.detach(), var.detach(), *grads]


def near(got, want, tol):
    return (got - want).abs().max().item() <= tol * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [128, 1024, 3072])
def test_kernels_meet_plain_form(channels, cuda_device):
    operands = card_operands(channels, cuda_device)
    tdnn_norm.reset_launch_counts(cuda_device)
    got = tail_and_grads(tdnn_norm.tdnn_norm, *operands)
    assert tdnn_norm.launch_counts(cuda_device) == ONE_EACH
    want = tail_and_grads(tdnn_norm.tdnn_norm_plain, *operands)
    torch.cuda.synchronize()
    names = ("y", "mean", "var", "dz", "dbias", "dscale", "dshift")
    tols = (ELEMENT_TOL, SUM_TOL, SUM_TOL, ELEMENT_TOL, SUM_TOL, SUM_TOL,
            SUM_TOL)
    for name, g, w, tol in zip(names, got, want, tols):
        assert torch.isfinite(g).all(), name
        assert near(g, w, tol), (name, (g - w).abs().max().item())
    assert not got[0][0].any() and not got[3][0].any()  # the empty row


@pytest.mark.cuda
def test_kernels_replay_in_a_cuda_graph(cuda_device):
    z, bias, scale, shift, mask, dy = card_operands(1024, cuda_device)
    leaves = [t.clone().requires_grad_(True) for t in (z, bias, scale, shift)]

    def step():
        y, mean, var = tdnn_norm.tdnn_norm(*leaves, mask, EPSILON)
        return [y, mean, var,
                *torch.autograd.grad(y, leaves, dy)]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = [t.clone() for t in step()]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    tdnn_norm.reset_launch_counts(cuda_device)
    for replays in (1, 2):
        for t in captured:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)
        assert tdnn_norm.launch_counts(cuda_device) == {
            k: replays for k in ONE_EACH}


@pytest.mark.cuda
def test_training_tdnn_launches_the_kernels(cuda_device, monkeypatch):
    torch.manual_seed(6)
    module = ecapa_tdnn.TDNN(64, 1024, 3, 2).to(cuda_device).train()
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn(32, 64, 298, generator=g, device=cuda_device)
    frames = ecapa_tdnn.Frames.of(
        frame_mask(CARD_LENGTHS, 298).to(cuda_device), x.dtype)
    tdnn_norm.reset_launch_counts(cuda_device)
    with observability.tallying(collections.Counter()) as counted, \
            layers.collect_batch_stats(module) as stats:
        y = module(x.requires_grad_(True), frames)
        y.sum().backward()
    assert tdnn_norm.launch_counts(cuda_device) == ONE_EACH
    assert counted == {"stats_masked": 1, "norm_fused": 1}
    monkeypatch.setattr(tdnn_norm, "route", lambda *args: "composed")
    with torch.no_grad(), layers.collect_batch_stats(module) as want_stats:
        want = module(x, frames)
    assert tdnn_norm.launch_counts(cuda_device) == ONE_EACH
    # the forward is continuous in the convolution's output: ReLU
    # thresholds that the two convolutions' roundings put on either side
    # move y by no more than their rounding
    assert near(y.detach(), want, ELEMENT_TOL)
    assert stats.keys() == want_stats.keys() == {"norm.mean", "norm.var"}
    for k in stats:
        assert near(stats[k], want_stats[k], SUM_TOL), k
