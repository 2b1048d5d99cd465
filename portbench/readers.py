"""What the metric readers of ``metrics/`` share: a run's record and the
reductions from its spans, laps and device intervals to numbers. A
reader returns None where the run holds nothing for it to read, and the
harness then leaves its metric out of the result."""
from __future__ import annotations

import dataclasses
from typing import Optional

from portbench import devtrace


@dataclasses.dataclass
class Request:
    i: int
    start: float
    end: float
    failed: bool
    spans: list              # (name, start, end, depth), host seconds


@dataclasses.dataclass
class Run:
    setup_s: float
    t0: float                # the window, host seconds
    t1: float
    requests: list
    intervals: Optional[list] = None     # device (name, start, end)
    msm_seconds: Optional[list] = None   # least MSM time of each request

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def rate(run: Run) -> Optional[float]:
    """Requests completed in the window over its seconds."""
    done = sum(not q.failed for q in run.requests)
    return done / run.window_s if done else None


def span_seconds(q: Request, names) -> float:
    return sum(b - a for n, a, b, _ in q.spans if n in names)


def mean_ms(run: Run, names) -> Optional[float]:
    """Milliseconds a request spent in the named spans, on average over
    the requests that have any of them."""
    per = [span_seconds(q, names) for q in run.requests
           if any(s[0] in names for s in q.spans)]
    return 1e3 * sum(per) / len(per) if per else None


def roofline(run: Run, names) -> Optional[float]:
    """The MSMs' least time over the time of their spans, in %."""
    if not run.msm_seconds:
        return None
    least = spent = 0.0
    for q, s in zip(run.requests, run.msm_seconds):
        t = span_seconds(q, names)
        if t > 0:
            least += s
            spent += t
    return 100.0 * least / spent if spent else None


def idle_share(run: Run) -> Optional[float]:
    """The share of the window in which no operation ran on the device,
    in %."""
    if not run.intervals:
        return None
    busy = devtrace.busy_seconds(run.intervals, run.t0, run.t1)
    return 100.0 * (1.0 - busy / run.window_s)
