"""The reductions from device intervals and host spans to the device's
busy time, its idle gaps and the breakdown, at intervals worked out by
hand."""
import pytest

from portbench import devtrace, readers

# (name, start, end), in order of start, overlapping and nested
IVS = [("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("k3", 2.0, 2.5),
       ("k1", 4.0, 5.0), ("k4", 6.5, 7.5)]


def test_busy_is_the_union_clipped_to_the_window():
    assert devtrace.busy_seconds(IVS, 0.0, 10.0) == pytest.approx(4.0)
    assert devtrace.busy_seconds(IVS, 1.5, 7.0) == pytest.approx(3.0)


def test_idle_gaps_fill_the_rest_of_the_window():
    gaps = devtrace.idle_gaps(IVS, 0.0, 10.0)
    assert gaps == [(0.0, 1.0), (3.0, 4.0), (5.0, 6.5), (7.5, 10.0)]
    busy = devtrace.busy_seconds(IVS, 0.0, 10.0)
    assert sum(b - a for a, b in gaps) + busy == pytest.approx(10.0)


def test_breakdown_splits_idle_time_by_the_host_span_open_meanwhile():
    spans = [("outer", 0.0, 9.0, 0), ("inner", 2.8, 3.5, 1),
             ("late", 3.5, 6.0, 1)]
    bd = devtrace.breakdown(IVS, spans, 0.0, 10.0)
    ops = dict(bd["device_ops"])
    assert ops["k1"] == pytest.approx(2.0) and ops["k2"] == pytest.approx(1.5)
    # gaps (0, 1): outer; (3, 4): inner 0.5, late 0.5; (5, 6.5): late 1.0,
    # outer 0.5; (7.5, 10): outer 1.5, then no span: the harness's 1.0
    assert dict(bd["idle_gaps"]) == pytest.approx(
        {"outer": 3.0, "inner": 0.5, "late": 1.5, "harness": 1.0})
    assert [v for _, v in bd["idle_gaps"]] == sorted(
        (v for _, v in bd["idle_gaps"]), reverse=True)


def test_idle_share_of_a_run():
    run = readers.Run(setup_s=1.0, t0=0.0, t1=10.0, requests=[],
                      intervals=IVS)
    assert readers.idle_share(run) == pytest.approx(60.0)
    assert readers.idle_share(readers.Run(1.0, 0.0, 10.0, [])) is None


class _Event:
    def __init__(self, name, start_ns, duration_ns):
        self._v = (name, start_ns, duration_ns)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        import torch
        return torch.autograd.DeviceType.CUDA


def test_device_trace_reads_intervals_in_order_of_start():
    """The profiler's records, in no order, come out on the host clock
    in order of start, the spin kernels left out; the last spin before
    the first operation is the clock mark."""
    from types import SimpleNamespace
    events = [_Event("zeta", 5_000, 1_000), _Event("alpha", 9_000, 500),
              _Event(devtrace.SPIN, 1_000, 100),
              _Event(devtrace.SPIN, 3_000, 100), _Event("mid", 4_000, 3_000)]
    dt = devtrace.DeviceTrace("cuda")
    dt.t_first = 100.0
    dt.prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    dt._read()
    assert [n for n, _, _ in dt.intervals] == ["mid", "zeta", "alpha"]
    assert dt.intervals[0][1:] == pytest.approx((100.0 + 1e-6, 100.0 + 4e-6))
    assert devtrace.busy_seconds(dt.intervals, 100.0, 101.0) == \
        pytest.approx(3.5e-6)
