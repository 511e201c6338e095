"""The idle share, the host time and the kernel time of a request, and
the idle gaps' labels, from a synthetic profiler trace."""

import json

import pytest

from perfbench import tracing


def _ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1}


@pytest.fixture
def trace(tmp_path):
    # times in microseconds: a 1000-us window with two requests
    ev = [
        _ev("user_annotation", tracing.WINDOW, 0, 1000),
        _ev("user_annotation", tracing.REQUEST, 0, 400),
        _ev("cpu_op", "aten::copy_", 50, 100),
        _ev("kernel", "k_render", 100, 200, tid=7),       # 100-300
        _ev("gpu_memcpy", "Memcpy DtoH", 300, 50, tid=7),  # 300-350
        _ev("user_annotation", tracing.REQUEST, 400, 600),
        _ev("kernel", "k_render", 450, 300, tid=7),       # 450-750
        _ev("kernel", "k_small", 700, 100, tid=7),        # overlaps to 800
        _ev("cpu_op", "aten::sum", 850, 100),
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return str(p)


def test_busy_and_idle(trace):
    a = tracing.analyze(trace)
    assert a.window_s == pytest.approx(1e-3)
    # busy: 100-350 and 450-800
    assert a.busy_s == pytest.approx(600e-6)
    idle = 100.0 * (1.0 - a.busy_s / a.window_s)
    assert idle == pytest.approx(40.0)


def test_per_request_host_and_kernel_time(trace):
    a = tracing.analyze(trace)
    (w0, b0, k0), (w1, b1, k1) = a.requests
    assert (w0, b0, k0) == pytest.approx((400e-6, 250e-6, 200e-6))
    assert (w1, b1, k1) == pytest.approx((600e-6, 350e-6, 350e-6))
    assert a.mean(0) - a.mean(1) == pytest.approx(200e-6)    # host


def test_device_ops_and_idle_gaps(trace):
    a = tracing.analyze(trace)
    assert a.device_ops[0] == ["k_render", pytest.approx(500e-6)]
    gaps = dict(a.idle_gaps)
    # 0-100 in aten::copy_ (its middle, 50, is in the op), 350-450 in the
    # first request only, 800-1000 in aten::sum (middle 900)
    assert gaps["aten::copy_"] == pytest.approx(100e-6)
    assert gaps[tracing.REQUEST] == pytest.approx(100e-6)
    assert gaps["aten::sum"] == pytest.approx(200e-6)


def test_union_covered():
    u = tracing.Union([(0, 2), (1, 3), (5, 6)])
    assert u.covered(-1, 10) == 4
    assert u.covered(1.5, 5.5) == pytest.approx(2.0)
    assert u.covered(3, 5) == 0
    assert u.gaps(0, 7) == [(3, 5), (6, 7)]
