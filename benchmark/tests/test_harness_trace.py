"""The trace reduction: a device operation belongs to the span whose host
range its runtime launch fell in, whatever thread launched it; busy time
is the union of device intervals; gaps are named by the host's span."""

from __future__ import annotations

import types

import pytest
from torch.autograd import DeviceType

from harness import trace as T


def _ev(name, start_us, end_us, cuda=False, cid=0):
    return types.SimpleNamespace(
        name=name, id=cid,
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        time_range=types.SimpleNamespace(start=start_us, end=end_us))


def test_spans_busy_and_gaps():
    evs = [
        # host: forward 0-100 us with forward_tiles inside 40-60, then the
        # backward 100-300 us, whose kernels another thread launches
        _ev("get_outputs", 0, 100), _ev("forward_tiles", 40, 60),
        _ev("autograd_grad", 100, 300),
        _ev("cudaLaunchKernel", 10, 12, cid=1),   # forward, plain op
        _ev("cuLaunchKernel", 45, 47, cid=2),     # forward_tiles via ctypes
        _ev("cudaLaunchKernel", 150, 152, cid=3),  # backward thread
        _ev("cudaMemcpyAsync", 320, 321, cid=4),  # outside every span
        # device: each op runs later than it was launched
        _ev("k_fwd", 50, 70, cuda=True, cid=1),
        _ev("forward_tiles_kernel", 70, 100, cuda=True, cid=2),
        _ev("k_bwd", 200, 260, cuda=True, cid=3),
        _ev("Memcpy DtoH", 330, 340, cuda=True, cid=4),
        # the profiler's mirror of a range on the device timeline
        _ev("get_outputs", 50, 100, cuda=True),
    ]
    prof = types.SimpleNamespace(events=lambda: evs)
    r = T.reduce_trace(prof, 400e-6, T.LABELS)
    sp = r["span_device_s"]
    assert sp["get_outputs"] == pytest.approx(50e-6)
    assert sp["forward_tiles"] == pytest.approx(30e-6)
    assert sp["autograd_grad"] == pytest.approx(60e-6)
    assert r["busy_s"] == pytest.approx(120e-6)
    assert r["kernels"] == 3
    assert r["device_ops"][0] == ["k_bwd", pytest.approx(60e-6)]
    # the longest gap (100-200 us) began while the host was in the
    # backward's span
    assert r["idle_gaps"][0] == ["autograd_grad", pytest.approx(100e-6)]


def test_a_driver_passes_its_own_span_table():
    """A label outside the driver's table is no span: its range neither
    takes device time nor names a gap, and the gap falls to the
    enclosing span or outside every span."""
    evs = [
        _ev("infer", 0, 100), _ev("get_outputs", 20, 80),
        _ev("cudaLaunchKernel", 30, 32, cid=1),
        _ev("cudaLaunchKernel", 90, 92, cid=2),
        _ev("k_a", 40, 85, cuda=True, cid=1),
        _ev("k_b", 95, 99, cuda=True, cid=2),
    ]
    prof = types.SimpleNamespace(events=lambda: evs)
    r = T.reduce_trace(prof, 100e-6, ("infer",))
    assert r["span_device_s"] == {"infer": pytest.approx(49e-6)}
    assert r["idle_gaps"] == [["infer", pytest.approx(10e-6)]]
    r = T.reduce_trace(prof, 100e-6, T.LABELS)
    assert r["span_device_s"] == {"get_outputs": pytest.approx(45e-6)}
    assert r["idle_gaps"] == [["outside_spans", pytest.approx(10e-6)]]


def test_spans_installed_wraps_the_table_it_is_given():
    import math

    table = (("math", "sqrt", "sqrt_span"),)
    orig = math.sqrt
    with T.spans_installed(table):
        assert math.sqrt is not orig
        assert math.sqrt(4.0) == 2.0
    assert math.sqrt is orig


def test_no_device_activity_is_an_error():
    prof = types.SimpleNamespace(events=lambda: [_ev("get_outputs", 0, 1)])
    with pytest.raises(RuntimeError):
        T.reduce_trace(prof, 1.0, T.LABELS)
