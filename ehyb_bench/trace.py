"""Device time, read on the card: CUDA-event times of a call run back to
back, and a ``torch.profiler`` window reduced to busy seconds, kernel
launches, the device operations that took most time and the idle gaps by
what the host was doing."""

from __future__ import annotations

import collections
import statistics
import time

import numpy as np
import torch

TOP = 10          # entries of each breakdown list
_NO_OP = "host: between profiled ops"


def event_ms(fn, min_ms: float = 50.0, rounds: int = 3) -> float:
    """Mean CUDA-event milliseconds of one call of ``fn`` when it runs back
    to back, as the main path runs it (L2 as the previous call left it):
    the median over ``rounds`` runs of enough calls to last ``min_ms``."""
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = max(10, int(min_ms / max(start.elapsed_time(end), 1e-3)))
    times = []
    for _ in range(rounds):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(work) -> dict:
    """Run ``work()`` (which ends in a synchronise) under the profiler and
    reduce its trace.  ``window_s`` is the host-clock length of the
    profiled call; ``busy_s`` the union of the device operations'
    intervals in it; ``kernels`` the kernels launched.  Returns None for
    the device numbers when the trace holds no device operation."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        info = work()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append(span)
        elif e.duration_ns() > 0:
            host.append(span)
    out = {"info": info, "window_s": window_s}
    if not device:
        return out
    by_name = collections.Counter()
    for s, e, name in device:
        by_name[name] += (e - s) / 1e9
    busy = _union([(s, e) for s, e, _ in device])
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    out.update(
        busy_s=sum(e - s for s, e in busy) / 1e9,
        kernels=sum(1 for _, _, name in device
                    if not name.startswith(("Memcpy", "Memset"))),
        device_ops=[[k, v] for k, v in by_name.most_common(TOP)],
        idle_gaps=_gaps_by_host(gaps, host))
    return out


def _gaps_by_host(gaps, host) -> list:
    """Idle seconds between device operations, summed by the innermost
    host operation running at each gap's middle: host operations, longest
    first, label the middles they hold, so the shortest holder labels
    last."""
    if not gaps:
        return []
    mids = np.array([(s + e) / 2 for s, e in gaps])
    order = np.argsort(mids)
    mids = mids[order]
    secs = np.array([(e - s) / 1e9 for s, e in gaps])[order]
    label = np.full(len(mids), -1)
    names = []
    for hs, he, name in sorted(host, key=lambda h: h[0] - h[1]):
        lo, hi = np.searchsorted(mids, [hs, he], side="left")
        if hi > lo:
            label[lo:hi] = len(names)
            names.append(name)
    by = collections.Counter()
    for lab, sec in zip(label.tolist(), secs.tolist()):
        by[names[lab] if lab >= 0 else _NO_OP] += sec
    return [[k, v] for k, v in by.most_common(TOP)]
