"""A bounded slice of a run under ``torch.profiler``: device intervals by
kernel name, busy seconds, and the idle gaps named by the harness's own host
span (``span``) that was open when each gap began.

The trace is written as a Chrome trace into ``TMPDIR``, read and deleted.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from contextlib import contextmanager
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name: str):
    """A host span of the harness, named ``bench.<name>`` in the trace."""
    return torch.profiler.record_function("bench." + name)


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def digest(events: List[dict], t0_us: float, t1_us: float) -> Dict[str, object]:
    """Kernel seconds by name, busy seconds, and idle gaps by host span of a
    trace's events inside [t0_us, t1_us] (microseconds)."""
    dev, spans = [], []
    by_name: Dict[str, float] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        a, d = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if e.get("cat") in DEVICE_CATS:
            a, b = max(a, t0_us), min(a + d, t1_us)
            if b > a:
                dev.append((a, b))
                by_name[e.get("name", "?")] = by_name.get(e.get("name", "?"), 0.0) + (b - a) / 1e6
        elif str(e.get("name", "")).startswith("bench."):
            spans.append((a, a + d, e["name"][6:]))
    merged = _merge(dev)
    busy = sum(b - a for a, b in merged) / 1e6
    gaps: Dict[str, float] = {}
    edges = [t0_us] + [x for iv in merged for x in iv] + [t1_us]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        inner = [s for s in spans if s[0] <= a < s[1]]
        label = min(inner, key=lambda s: s[1] - s[0])[2] if inner else "outside the harness's spans"
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    return {"kernels": by_name, "busy_s": busy, "gaps": gaps}


@contextmanager
def profiled(out: Dict[str, object]):
    """Profile the body on the card (synchronised at both ends); fills
    ``out`` with ``digest``'s keys, ``window_s`` (the slice's span in the
    trace) and ``host_s`` (its host-clock seconds)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with span("slice_start"):
            t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        with span("slice_end"):
            t1 = time.perf_counter()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    starts = [float(e["ts"]) for e in events if e.get("name") == "bench.slice_start"]
    ends = [float(e["ts"]) + float(e.get("dur", 0.0)) for e in events if e.get("name") == "bench.slice_end"]
    out.update(digest(events, starts[0], ends[-1]))
    out["window_s"] = (ends[-1] - starts[0]) / 1e6
    out["host_s"] = t1 - t0


@contextmanager
def sampled(out: Dict[str, object], every: int, count: int):
    """Profile one of every ``every`` units for ``count`` units: yields the
    profiler, whose ``step()`` the caller calls after each unit, and which
    records each unit inside a ``span("unit")`` that ends on a read of the
    card. Fills ``out`` as ``profiled`` does, summed over the recorded units
    (``window_s`` their spans' sum)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    parts: List[dict] = []

    def ready(prof):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        units = [e for e in events if e.get("name") == "bench.unit"]
        t0 = min(float(e["ts"]) for e in units)
        t1 = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in units)
        parts.append(dict(digest(events, t0, t1), window_s=(t1 - t0) / 1e6))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], on_trace_ready=ready,
                 schedule=schedule(wait=every - 1, warmup=0, active=1, repeat=count)) as prof:
        yield prof
    kernels: Dict[str, float] = {}
    gaps: Dict[str, float] = {}
    for p in parts:
        for k, v in p["kernels"].items():
            kernels[k] = kernels.get(k, 0.0) + v
        for k, v in p["gaps"].items():
            gaps[k] = gaps.get(k, 0.0) + v
    out.update(kernels=kernels, gaps=gaps, busy_s=sum(p["busy_s"] for p in parts),
               window_s=sum(p["window_s"] for p in parts), units=len(parts))
