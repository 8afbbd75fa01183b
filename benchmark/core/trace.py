"""Reduction of a ``torch.profiler`` trace of the measured window.

``DeviceTrace`` holds the window's device operations (kernels, copies,
sets) and host events as ``(name, start_s, end_s)``, from which it
gives the device's busy seconds (the union of its operations), the time
by operation name, and the idle gaps labelled by the host events that
overlap them.
"""

import re
from collections import defaultdict

import numpy as np


def short_name(name):
    """``void ns::(anonymous namespace)::f<a, 1>(args)`` -> ``f<a, 1>``."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    name = name[:cut]
    depth, start = 0, 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == ":" and depth == 0:
            start = i + 1
    return name[start:].strip()


def _union(intervals):
    """Merged ``[(start, end)]`` of sorted intervals."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


class DeviceTrace:
    def __init__(self, device_ops, host_ops, window):
        """``device_ops``/``host_ops``: ``[(name, start_s, end_s)]``;
        ``window = (start_s, end_s)`` on the same clock."""
        w0, w1 = window
        self.window = (w0, w1)
        clip = lambda ops: [(n, max(s, w0), min(e, w1)) for n, s, e in ops
                            if e > w0 and s < w1]
        self.device_ops = sorted(clip(device_ops), key=lambda o: o[1])
        self.host_ops = sorted(clip(host_ops), key=lambda o: o[1])
        self.busy = _union([(s, e) for _, s, e in self.device_ops])

    @property
    def window_s(self):
        return self.window[1] - self.window[0]

    @property
    def busy_s(self):
        return float(sum(e - s for s, e in self.busy))

    def time_by_name(self):
        out = defaultdict(float)
        for n, s, e in self.device_ops:
            out[short_name(n)] += e - s
        return dict(out)

    def seconds_of(self, pattern):
        """Device seconds of the operations whose short name matches."""
        rx = re.compile(pattern)
        return float(sum(e - s for n, s, e in self.device_ops
                         if rx.search(short_name(n))))

    def idle_gaps(self, ignore=(), short=50e-6):
        """``{label: seconds}`` of the device's idle time in the window,
        each gap labelled by the host event that overlaps most of it
        (``"no host op"`` where none does); gaps under ``short`` seconds
        are summed under one label."""
        edges = [self.window[0]]
        for s, e in self.busy:
            edges += [s, e]
        edges.append(self.window[1])
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = [(n, s, e) for n, s, e in self.host_ops if n not in ignore]
        starts = np.array([s for _, s, _ in host]) if host else np.zeros(0)
        max_len = max((e - s for _, s, e in host), default=0.0)
        out = defaultdict(float)
        short_label = "gaps under %d us" % round(short * 1e6)
        for g0, g1 in gaps:
            if g1 - g0 < short:
                out[short_label] += g1 - g0
                continue
            lo = np.searchsorted(starts, g0 - max_len, side="left")
            hi = np.searchsorted(starts, g1, side="right")
            best, best_ov = "no host op", 0.0
            for n, s, e in host[lo:hi]:
                ov = min(e, g1) - max(s, g0)
                if ov > best_ov:
                    best, best_ov = n, ov
            out[best] += g1 - g0
        return dict(out)


def top(items, n=10):
    return [[k, float(v)] for k, v in
            sorted(items.items(), key=lambda kv: -kv[1])[:n]]
