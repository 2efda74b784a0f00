"""
How the port runs a frame-masked recurrent layer of two directions
(``models/layers.py::run_rnn``), on the CPU:

- the route is a function of the number of cells, whether lengths are
  given, whether the calls go to cuDNN and whether a CUDA graph captures
  them: "forked" (two CUDA streams) where both hold, "serial" otherwise,
  and no route (one call) for one direction or no lengths;
- ``tallying_rnn_runs`` counts one run a masked two-direction layer, by
  route, and nothing for an unmasked or one-direction layer;
- an eager run whose calls go to cuDNN runs serially and sets up the side
  stream and handle a capture forks onto;
- the forked route's composition, with stand-ins for the two streams
  (their calls in turns) and for the side direction's cuDNN call (the
  serial route's call), gives the serial route's outputs and gradients
  bit for bit, and counts as forked;
- the side caller runs each call on a thread of its own, raises a call's
  fault in the caller, and its thread ends when it is collected;
- a program's eager run carries its layers' runs on its
  ``lidbox.graph.eager`` span (``rnn_forked``, ``rnn_serial``; none where
  no such layer ran).

Tests marked ``cuda`` need the card and skip without one: the side
direction's cuDNN calls (``_SideRNN``) against ``torch.gru`` and
``torch.lstm``, and a masked layer captured in a CUDA graph (forked in
float32, serial in bfloat16) against its eager run, outputs and gradients
bit for bit. This file imports no JAX; on the card run them with
``python -m pytest --noconftest tests/test_torch_rnn_route.py -m cuda``.
``chip_smoke.py`` phase 17 checks whole models.
"""
import collections
import gc
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lidbox_tpu_torch.models import layers
from lidbox_tpu_torch.train import graphs, observability

torch.set_num_threads(2)

B, T, F, UNITS = 4, 9, 5, 6
LENGTHS = torch.tensor([9, 1, 4, 7])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("cells, masked, cudnn, capturing, route", [
    (2, True, False, False, "serial"),  # the CPU
    (2, True, True, True, "forked"),  # a capture on the card
    (2, True, True, False, "serial"),  # an eager run on the card
    (2, True, False, True, "serial"),  # bfloat16 or cuDNN off, captured
    (1, True, True, True, None), (2, False, True, True, None),
    (1, True, False, False, None), (2, False, False, False, None)])
def test_route_of_device_cells_and_lengths(cells, masked, cudnn, capturing,
                                           route):
    lengths = LENGTHS if masked else None
    assert layers.rnn_route(cells, lengths, cudnn, capturing) == route
    assert layers.rnn_route(cells, lengths) == (route and "serial")


def inputs(seed=0):
    return torch.randn(B, T, F, generator=torch.Generator().manual_seed(seed))


def seeded(make):
    with torch.random.fork_rng():
        torch.manual_seed(1)
        return make()


def bidirectional(cell):
    return seeded(lambda: layers.BidirectionalRNN(F, UNITS, cell=cell))


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_masked_two_direction_runs_are_counted(cell):
    layer = bidirectional(cell)
    one_way = seeded(lambda: layers.LSTMLayer(F, UNITS))
    x = inputs()
    with layers.tallying_rnn_runs(collections.Counter()) as tally:
        layer(x, lengths=LENGTHS)
        layer(x, lengths=LENGTHS)
        layer(x)
        one_way(x, lengths=LENGTHS)
    assert tally == {"serial": 2}
    with layers.tallying_rnn_runs(collections.Counter()) as tally:
        layer(x)
        one_way(x)
    assert not tally
    # a run counts in every enclosing tally
    with layers.tallying_rnn_runs(collections.Counter()) as outer:
        with layers.tallying_rnn_runs(collections.Counter()) as inner:
            layer(x, lengths=LENGTHS)
        layer(x, lengths=LENGTHS)
    assert inner == {"serial": 1} and outer == {"serial": 2}


def test_eager_cudnn_run_is_serial_and_sets_up_the_side(monkeypatch):
    # the calls go to cuDNN, with no capture: the eager run of a card
    layer = bidirectional("gru")
    x = inputs()
    plain = layer(x, lengths=LENGTHS)
    sides = []
    monkeypatch.setattr(torch.backends.cudnn, "is_acceptable", lambda x: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(layers, "_side", sides.append)
    with layers.tallying_rnn_runs(collections.Counter()) as tally:
        y = layer(x, lengths=LENGTHS)
        layer(x)
    assert tally == {"serial": 1} and sides == [x.device]
    assert torch.equal(y, plain)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_forked_composition_equals_serial(cell, monkeypatch):
    def run():
        layer = bidirectional(cell)
        x = inputs().requires_grad_(True)
        y = layer(x, lengths=LENGTHS)
        w = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
        (y * w).sum().backward()
        return y.detach(), x.grad, [p.grad for p in layer.parameters()]

    serial = run()
    # stand-ins for the card: the two streams run their calls in turns,
    # and the side direction's cuDNN call is the single-direction call the
    # serial route makes, asked of the side caller's thread
    calls = []

    def in_turns(first, second, device):
        a = first()
        calls.append("first")
        b = second(layers._SideCaller())
        return a, b

    def side_rnn(caller, kind, units, train, x, h0, *weights):
        calls.append(caller(lambda: "side"))
        fn = torch.lstm if kind == "lstm" else torch.gru
        hx = (h0, h0) if kind == "lstm" else h0
        assert h0.shape == (1, B, units) and len(weights) == 4
        return fn(x, hx, list(weights), True, 1, 0.0, train, False, True)[0]
    # the calls go to cuDNN, under a capture
    monkeypatch.setattr(torch.backends.cudnn, "is_acceptable", lambda x: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(layers, "_forked", in_turns)
    monkeypatch.setattr(layers._SideRNN, "apply", side_rnn)
    with layers.tallying_rnn_runs(collections.Counter()) as tally:
        forked = run()
    assert tally == {"forked": 1} and calls == ["first", "side"]
    assert torch.equal(forked[0], serial[0])
    assert torch.equal(forked[1], serial[1])
    assert len(forked[2]) == len(serial[2]) > 0
    assert all(torch.equal(a, b) for a, b in zip(forked[2], serial[2]))
    # past each row's length the outputs are zero on both routes
    past = torch.arange(T)[None, :] >= LENGTHS[:, None]
    assert not forked[0][past].any()


def test_side_caller_runs_calls_on_its_own_thread():
    caller = layers._SideCaller()
    here = threading.get_ident()
    there = caller(threading.get_ident)
    assert there != here and caller(threading.get_ident) == there
    with pytest.raises(ZeroDivisionError):
        caller(lambda: 1 / 0)
    assert caller(lambda: 3) == 3  # a fault does not end the thread
    names = {t.ident: t for t in threading.enumerate()}
    assert names[there].name == "lidbox-rnn-side"
    # the thread ends once its caller is collected
    del caller
    gc.collect()
    names[there].join(timeout=10)
    assert not names[there].is_alive()


def test_eager_program_span_carries_the_runs():
    observability.clear_spans()
    layer = bidirectional("gru")
    program = graphs.ForwardProgram("forward")
    x = inputs()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            program(lambda x, lengths: layer(x, lengths=lengths),
                     {"x": x, "lengths": LENGTHS}, "cpu")
            program(lambda x, lengths: layer(x), {"x": x, "lengths": None},
                    "cpu")
        runs = [r for r in observability.spans()
                if r.name == "lidbox.graph.eager"]
    finally:
        observability.clear_spans()
    assert [{k: v for k, v in r.attrs.items() if k.startswith("rnn_")}
            for r in runs] == [{"rnn_forked": 0, "rnn_serial": 1}, {}]


def test_capture_tally_gives_one_run():
    # a capture's body: a replay's runs
    assert graphs._rnn_attrs(collections.Counter(forked=2)) == {
        "rnn_forked": 2, "rnn_serial": 0}
    assert graphs._rnn_attrs(collections.Counter(serial=1)) == {
        "rnn_forked": 0, "rnn_serial": 1}
    assert graphs._rnn_attrs(collections.Counter()) == {}


def cudnn_weights(kind, units, features, device):
    """A single direction's (w_ih, w_hh, b_ih, b_hh), drawn on ``device``
    and needing gradients."""
    gates = 4 if kind == "lstm" else 3
    gen = torch.Generator(device=device).manual_seed(3)
    shapes = [(gates * units, features), (gates * units, units),
              (gates * units,), (gates * units,)]
    return [(0.3 * torch.randn(s, device=device, generator=gen))
            .requires_grad_(True) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("x_grad", [True, False])
@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_side_rnn_equals_one_direction_call(kind, x_grad, cuda_device):
    units, features = 32, 24
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(B, T, features, device=cuda_device, generator=gen)
    w = torch.randn(B, T, units, device=cuda_device, generator=gen)
    x.requires_grad_(x_grad)
    weights = cudnn_weights(kind, units, features, cuda_device)
    h0 = x.new_zeros(1, B, units)
    fn = torch.lstm if kind == "lstm" else torch.gru
    wrt = ([x] if x_grad else []) + weights
    caller = layers._SideCaller()
    y_side = layers._SideRNN.apply(caller, kind, units, True, x, h0,
                                   *weights)
    g_side = torch.autograd.grad((y_side * w).sum(), wrt)
    hx = (h0, h0) if kind == "lstm" else h0
    y = fn(x, hx, weights, True, 1, 0.0, True, False, True)[0]
    g = torch.autograd.grad((y * w).sum(), wrt)
    torch.cuda.synchronize()
    assert torch.equal(y_side, y)
    assert len(g_side) == len(g) == len(wrt)
    assert all(torch.equal(a, b) for a, b in zip(g_side, g))
    # cuDNN's backward consumes its reserve: a second backward raises
    again = layers._SideRNN.apply(caller, kind, units, True, x, h0, *weights)
    again.backward(w, retain_graph=True)
    with pytest.raises(RuntimeError, match="backward ran twice"):
        again.backward(w)


@pytest.mark.cuda
@pytest.mark.parametrize("cell, dtype, route", [
    ("gru", torch.float32, "forked"), ("lstm", torch.float32, "forked"),
    ("gru", torch.bfloat16, "serial")])
def test_captured_layer_equals_eager(cell, dtype, route, cuda_device):
    layer = bidirectional(cell).to(cuda_device, dtype)
    x = inputs().to(cuda_device, dtype)
    lengths = LENGTHS.to(cuda_device)
    w = torch.randn(B, T, 2 * UNITS, generator=torch.Generator().manual_seed(
        2)).to(cuda_device, dtype)

    def run():
        layer.zero_grad(set_to_none=True)
        xr = x.clone().requires_grad_(True)
        y = layer(xr, lengths=lengths)
        (y * w).sum().backward()
        return [y.detach(), xr.grad] + [p.grad for p in layer.parameters()]
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side), \
            layers.tallying_rnn_runs(collections.Counter()) as eager_runs:
        eager = [t.clone() for t in run()]
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with layers.tallying_rnn_runs(collections.Counter()) as captured_runs, \
            torch.cuda.graph(graph, stream=side,
                             capture_error_mode="thread_local"):
        captured = run()
    graph.replay()
    torch.cuda.synchronize()
    assert eager_runs == {"serial": 1} and captured_runs == {route: 1}
    assert len(captured) == len(eager) and None not in captured
    assert all(torch.equal(a, b) for a, b in zip(captured, eager))
