"""What a traced run records: the program's own spans and phase laps,
kept in memory with host timestamps, and the device's kernel intervals
from ``torch.profiler``, put on the same clock.

* ``SpanRecorder`` takes the place of the program's profiler object
  (``libsnark_tpu_torch.profiling.PROFILER``, which ``enter_block`` looks
  up at each call): the same blocks, each ended by the same device
  synchronize, recorded as (name, start, end) without a printed line.
* ``Laps`` is the dict that ``prover(..., timings=)`` fills: each phase's
  seconds, recorded with the time it ended.
* ``DeviceTrace`` runs the window under the profiler (CUDA activity) and
  reads the union of the device's operation intervals, the way
  ``chip_smoke.py``'s ``device_profile`` does: spin kernels first, whose
  records the profiler may drop, then kept out of the count; the host
  launch time of the last, on an idle device, puts the device clock on
  the host's.
"""
from __future__ import annotations

import bisect
import contextlib
import time

import torch

SPIN = "spin_kernel"          # the kernel of torch.cuda._sleep


class SpanRecorder:
    """A stand-in for the program's ``Profiler`` that keeps its blocks."""

    enabled = True

    def __init__(self):
        self.spans = []
        self.depth = 0

    @contextlib.contextmanager
    def block(self, name: str, sync=None):
        t0 = time.perf_counter()
        self.depth += 1
        try:
            yield
        finally:
            if sync is not None:
                dev = sync.device if isinstance(sync, torch.Tensor) else sync
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            self.depth -= 1
            self.spans.append((name, t0, time.perf_counter(), self.depth))

    def count_op(self, name: str, n: int = 1):
        pass


class Laps(dict):
    """``timings`` for a prover: name -> seconds, and ``spans`` with each
    phase's (name, start, end) on the host clock."""

    def __init__(self):
        super().__init__()
        self.spans = []

    def __setitem__(self, name, seconds):
        end = time.perf_counter()
        self.spans.append((name, end - seconds, end, 0))
        super().__setitem__(name, seconds)


@contextlib.contextmanager
def installed_span_recorder(recorder: SpanRecorder):
    from libsnark_tpu_torch import profiling
    was = profiling.PROFILER
    profiling.PROFILER = recorder
    try:
        yield recorder
    finally:
        profiling.PROFILER = was


def _mark(device) -> float:
    """A spin kernel launched on an idle device; the host time just before
    its launch."""
    torch.cuda.synchronize(device)
    t = time.perf_counter()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize(device)
    return t


class DeviceTrace:
    """Device operation intervals over a window, on the host clock."""

    WARMUP = 32

    def __init__(self, device):
        self.device = device
        self.intervals = []           # (name, start, end), host seconds
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        for _ in range(self.WARMUP):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize(self.device)
        self.t_first = _mark(self.device)
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self._read()
        return False

    def _read(self):
        cuda = torch.autograd.DeviceType.CUDA
        events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in self.prof.profiler.kineto_results.events()
                  if e.device_type() == cuda]
        spins = sorted(s for name, s, _ in events if SPIN in name)
        work = [s for name, s, _ in events if SPIN not in name]
        # the clock mark is the last spin kernel before the first of the
        # window's operations (the profiler may keep no record of the
        # mark after the window); both clocks count real nanoseconds
        before = [s for s in spins if not work or s <= min(work)]
        if not before:
            raise RuntimeError("the profiler kept no record of the clock "
                               "mark: no device trace")
        d0 = before[-1]
        to_host = (lambda ns: self.t_first + (ns - d0) * 1e-9)
        # by start: busy_seconds and idle_gaps walk them in time order
        self.intervals = sorted(
            ((name, to_host(s), to_host(e)) for name, s, e in events
             if SPIN not in name and s >= d0), key=lambda iv: iv[1])
        if not self.intervals:
            raise RuntimeError("torch.profiler recorded no device activity")


def busy_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of the intervals (in order of start), clipped
    to [lo, hi]."""
    busy, end = 0.0, lo
    for _, a, b in intervals:
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    return busy


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """The device's idle (start, end) intervals inside [lo, hi], from the
    intervals in order of start."""
    gaps, end = [], lo
    for _, a, b in intervals:
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]


def host_activity(spans, t: float) -> str:
    """The innermost span open at host time t (the deepest, then the
    latest to start), or the harness's own time between requests."""
    best = None
    for name, a, b, depth in spans:
        if a <= t < b and (best is None or (depth, a) > best[0]):
            best = ((depth, a), name)
    return best[1] if best else "harness"


def breakdown(intervals, spans, lo: float, hi: float, top: int = 10):
    """The device operations that took most time, and the device's idle
    time split by what the host was doing meanwhile (the innermost span
    open at each moment): [[name, seconds], ...] each."""
    ops = {}
    for name, a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            ops[name[:160]] = ops.get(name[:160], 0.0) + (b - a)
    # the window cut at every span's ends, and the host's activity in each
    # piece
    cuts = sorted({lo, hi} | {x for _, a, b, _ in spans for x in (a, b)
                              if lo < x < hi})
    doing = [host_activity(spans, (p + q) / 2)
             for p, q in zip(cuts, cuts[1:])]
    idle = {}
    for a, b in idle_gaps(intervals, lo, hi):
        k = bisect.bisect_right(cuts, a) - 1
        while k < len(doing) and cuts[k] < b:
            part = min(b, cuts[k + 1]) - max(a, cuts[k])
            if part > 0:
                idle[doing[k]] = idle.get(doing[k], 0.0) + part
            k += 1

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]
    return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}
