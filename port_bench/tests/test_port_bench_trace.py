"""``common.Trace.summary`` on a made-up timeline: the device's busy time
is the union of its operations, spans of ``record_function`` are not device
time, and each idle gap is named by the host operation overlapping it
most."""
import types

import pytest
import torch

from port_bench import common

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def event(name, device, start, end, annotation=False):
    return types.SimpleNamespace(
        name=name, device_type=device, is_user_annotation=annotation,
        time_range=types.SimpleNamespace(start=start, end=end))


def test_summary():
    trace = common.Trace.__new__(common.Trace)
    trace.window_s = 0.001
    events = [
        event("k1", CUDA, 0.0, 100.0), event("k2", CUDA, 50.0, 150.0),
        event("k1", CUDA, 400.0, 500.0), event("k3", CUDA, 505.0, 510.0),
        event("span", CUDA, 100.0, 900.0, annotation=True),
        event("span", CPU, 90.0, 900.0, annotation=True),
        event("decode", CPU, 160.0, 390.0), event("aten::copy_", CPU, 380.0, 420.0)]
    trace.prof = types.SimpleNamespace(events=lambda: events)
    s = trace.summary()
    assert s["busy_s"] == pytest.approx(255e-6)
    assert s["device_ops"][0] == ["k1", pytest.approx(200e-6)]
    assert "span" not in dict(s["device_ops"])
    gaps = dict(s["idle_gaps"])
    assert gaps["decode"] == pytest.approx(250e-6)
    assert gaps["gaps under 20 us"] == pytest.approx(5e-6)
