"""The port's spans, counters and device stage marks.

Host spans (``span``) and counters (``count``) sit at the port's layer
boundaries: the prefetcher's wait, the train step, graph captures and
replays, a decoded batch and its parts, kernel loading, the device corpus.
A span records its name, start, end and parent (a stack per thread).
Per-name totals are always kept: the number of spans and their total time.
A span nested in a span of its own name adds to the count, not to the
total, so that a name's total is the time it covers.

While a ``torch.profiler`` session records, a span also opens
``torch.profiler.record_function("asr." + name)``, so that it lands in the
Chrome trace on the timeline of the device's kernels (where the profiler
also mirrors it onto the card's timeline as a user annotation:
``utils/profiling.device_events`` leaves those out of the card's work).
Profiling perturbs the host, so every total is kept in two banks,
``untraced`` and ``traced`` (a profiler recording); the benchmark's readers
take the untraced one.

Device stage marks (``mark``). A replayed CUDA graph's kernels carry no
host range: a range opened while a graph is captured is not replayed, and
every kernel of a replay correlates only to the ``cudaGraphLaunch`` that
issued it. So the stages of the train step and the beam step are timed on
the device: ``mark(section)`` launches ``csrc/trace_mark.cu``, one thread
that reads the global timer, adds the time since the previous mark to the
section that mark opened and opens ``section``. ``mark(None, ...)`` is a
step's end; the next mark's ``gap`` names the section that the time until
it is charged to (the gap between steps, or between batches). A mark
launches only inside ``marking()``, which the train step's and the beam
step's caches enter around their captures, and only while the stream is
being captured: it never runs eagerly, on the CPU or in another graph, and
its cost is part of every replay of those graphs, profiled or not.

The device keeps the open section, the time of the previous mark and the
bank; the host writes the bank (when it sees the profiler start or stop at
a span's entry) and drops the open section after every capture, each by a
``fill_`` on the current stream. An interval across a change of bank or a
capture is dropped, not counted, so that neither a capture nor a
profiler's export lands in a section. The switch is seen at a span's entry:
where two profiler sessions follow each other with no span between them,
the interval across the first one's export lands in the traced bank (never
in the untraced one).

Device counters (``device_counter``): a count that code on the device adds
to, e.g. a kernel inside a replayed graph, where no host code runs at each
replay. Each is an int64 tensor [1 + banks] on its device: [0] the bank the
host set (written by a ``fill_`` on the current stream when the bank
changes, as the marks' bank), [1 + b] the count in bank b; the adder adds
to [1 + [0]]. ``fetch`` copies them with the sections, and ``snapshot``
reports them with the host counters.

``snapshot(bank)`` returns the spans' and counters' totals and the
sections' (one device-to-host read). ``set_marks(False)`` captures graphs
without marks (for comparisons; not a configuration option).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _prof

# the device sections, in the order of the device buffers' columns
SECTIONS = (
    "train.features", "train.encoder", "train.heads", "train.backward", "train.reduce", "train.optimizer",
    "train.between_steps",
    "beam.speller", "beam.lm", "beam.search", "beam.between_steps", "beam.between_batches",
    "train.speller",
)
BANKS = ("untraced", "traced")
_END = -2  # a step's end mark: the next mark names the gap (csrc/trace_mark.cu)
_INDEX = {s: i for i, s in enumerate(SECTIONS)}


def _profiling() -> int:
    """1 while a torch.profiler session records, else 0."""
    return int(_prof._is_profiler_enabled)


class Span:
    """One span: a context manager whose ``s`` is its duration (seconds)
    once it has ended."""

    __slots__ = ("tr", "name", "parent", "bank", "t0", "t1", "nested", "rf")

    def __init__(self, tr: "Tracer", name: str):
        self.tr, self.name = tr, name
        self.t0 = self.t1 = 0

    @property
    def s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def __enter__(self) -> "Span":
        tr = self.tr
        self.bank = _profiling()
        if self.bank != tr._bank:
            tr._switch(self.bank)
        stack = tr._stack()
        self.parent = stack[-1] if stack else None
        self.nested = any(s.name == self.name for s in stack)
        self.rf = None
        if self.bank:
            self.rf = torch.profiler.record_function("asr." + self.name)
            self.rf.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter_ns()
        tr = self.tr
        tr._stack().pop()
        with tr._lock:
            tot = tr._spans[self.bank].setdefault(self.name, [0, 0])
            tot[0] += 1
            tot[1] += 0 if self.nested else self.t1 - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)


class _Device:
    """One card's mark buffers: ``state`` int64 [4] (the open section, the
    global timer at the previous mark, the bank the host set, the bank at
    the previous mark) and ``totals`` int64 [bank, (ns, intervals),
    section]; ``host`` a pinned copy of ``totals`` and its event."""

    def __init__(self, index: int, bank: int):
        from e2e_asr_tpu_torch import cuda_build

        dev = torch.device("cuda", index)
        # normal tensors (not inference tensors, whatever mode the first
        # capture runs in): the host writes them in place in any mode
        with torch.cuda.device(dev), torch.inference_mode(False):
            self.state = torch.tensor([-1, 0, bank, bank], dtype=torch.int64, device=dev)
            self.totals = torch.zeros((len(BANKS), 2, len(SECTIONS)), dtype=torch.int64, device=dev)
            self.host = torch.empty(self.totals.shape, dtype=torch.int64, pin_memory=True)
            err = cuda_build.library("trace_mark").e2e_trace_mark_prepare()
        if err != 0:
            raise RuntimeError(f"trace_mark: the kernel did not load (CUDA error {err})")
        self.event: Optional[torch.cuda.Event] = None


class _Counter:
    """One device counter (``Tracer.device_counter``): ``buf`` int64 [1 +
    banks]; ``host`` its copy (pinned for a card's) and the copy's event."""

    def __init__(self, device: torch.device, bank: int):
        # a normal tensor (not an inference tensor, whatever mode its first
        # adder runs in): the host writes it in place in any mode
        with torch.inference_mode(False):
            self.buf = torch.zeros(1 + len(BANKS), dtype=torch.int64, device=device)
            self.buf[0] = bank
            self.host = torch.empty(self.buf.shape, dtype=torch.int64, pin_memory=device.type == "cuda")
        self.event: Optional[torch.cuda.Event] = None

    def fetch(self) -> None:
        self.host.copy_(self.buf, non_blocking=self.buf.is_cuda)
        if self.buf.is_cuda:
            with torch.cuda.device(self.buf.device):
                self.event = torch.cuda.Event()
                self.event.record()


class Tracer:
    """Spans, counters and the device marks of one process (``TRACER``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._bank = 0  # the bank the last span's entry saw
        self._spans: List[Dict[str, list]] = [{} for _ in BANKS]  # name: [n, total ns]
        self._counts: List[Dict[str, int]] = [{} for _ in BANKS]
        self._devices: Dict[int, _Device] = {}
        self._counters: Dict[tuple, _Counter] = {}  # (name, device): its device counter
        self.marks = True

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _switch(self, bank: int) -> None:
        """The profiler started or stopped: the devices' bank follows, on the
        current stream (not while this thread captures a graph: a later
        span's entry switches then)."""
        if (self._devices or self._counters) and _capturing():
            return
        self._bank = bank
        for d in self._devices.values():
            d.state[2].fill_(bank)
        for c in self._counters.values():
            c.buf[0].fill_(bank)

    def span(self, name: str) -> Span:
        return Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            c = self._counts[_profiling()]
            c[name] = c.get(name, 0) + n

    def device_counter(self, name: str, device) -> torch.Tensor:
        """The device counter ``name`` on ``device`` (int64 [1 + banks]: [0]
        the bank, [1 + b] the count in bank b), made at its first call, which
        may not be inside a graph's capture."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        with self._lock:
            c = self._counters.get((name, device))
            if c is None:
                if _capturing():
                    raise RuntimeError(f"tracing: the device counter {name} is made inside a graph's capture")
                c = self._counters[(name, device)] = _Counter(device, self._bank)
        return c.buf

    def total_s(self, name: str) -> float:
        """The total seconds of the spans of ``name``, both banks."""
        return sum(b[name][1] for b in self._spans if name in b) / 1e9

    def counted(self, name: str) -> int:
        """The count of ``name``, both banks."""
        return sum(b.get(name, 0) for b in self._counts)

    @contextmanager
    def marking(self, on: bool = True):
        """Arm ``mark`` on this thread for the graph captured in the body (the
        mark buffers and the kernel are made ready first, outside the
        capture); afterwards the open section is dropped on the current
        stream, so that no interval spans the capture."""
        if not (on and self.marks and torch.cuda.is_available()):
            yield
            return
        index = torch.cuda.current_device()
        dev = self._devices.get(index)
        if dev is None:
            dev = self._devices[index] = _Device(index, self._bank)
        self._local.armed = dev
        try:
            yield
        finally:
            self._local.armed = None
        self.drop()

    def drop(self) -> None:
        """Drop the open section on the current stream: the time until the
        next mark is not counted (after a capture; after work between steps
        that is not a gap, such as a validation)."""
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            return
        for d in self._devices.values():
            d.state[0].fill_(-1)

    def mark(self, section: Optional[str], gap: Optional[str] = None) -> None:
        """Close the open section and open ``section`` (None: the step's end;
        ``gap``: where the time since a step's end goes), on the device,
        where ``marking`` is armed and the stream is being captured."""
        dev = getattr(self._local, "armed", None)
        if dev is None or not torch.cuda.is_current_stream_capturing():
            return
        from e2e_asr_tpu_torch import cuda_build

        cuda_build.launch("trace_mark", "e2e_trace_mark", dev.state, dev.totals,
                          _END if section is None else _INDEX[section], -1 if gap is None else _INDEX[gap],
                          len(SECTIONS))

    def fetch(self) -> None:
        """Start copying the devices' section totals to the host (current
        stream); ``snapshot`` waits for the copy."""
        for d in self._devices.values():
            with torch.cuda.device(d.totals.device):
                d.host.copy_(d.totals, non_blocking=True)
                d.event = torch.cuda.Event()
                d.event.record()
        for c in self._counters.values():
            c.fetch()

    def snapshot(self, bank: str = "untraced") -> dict:
        """{"spans": {name: {"n", "total_s"}}, "counts": {name: n},
        "sections": {section: {"n", "total_ms"}}} of ``bank``
        (``untraced``, ``traced`` or ``all``), the device counters among the
        counts (summed over the devices); sections with no interval are left
        out."""
        banks = range(len(BANKS)) if bank == "all" else [BANKS.index(bank)]
        spans: Dict[str, dict] = {}
        counts: Dict[str, int] = {}
        with self._lock:
            for b in banks:
                for name, (n, tot) in self._spans[b].items():
                    s = spans.setdefault(name, {"n": 0, "total_s": 0.0})
                    s["n"] += n
                    s["total_s"] += tot / 1e9
                for name, n in self._counts[b].items():
                    counts[name] = counts.get(name, 0) + n
        if any(x.event is None for x in (*self._devices.values(), *self._counters.values())):
            self.fetch()
        for (name, _), c in self._counters.items():
            if c.event is not None:
                c.event.synchronize()
                c.event = None
            host = c.host.tolist()
            for b in banks:
                counts[name] = counts.get(name, 0) + host[1 + b]
        sections: Dict[str, dict] = {}
        for d in self._devices.values():
            d.event.synchronize()
            d.event = None
            host = d.host.tolist()
            for b in banks:
                for name, ns, n in zip(SECTIONS, *host[b]):
                    if n:
                        s = sections.setdefault(name, {"n": 0, "total_ms": 0.0})
                        s["n"] += n
                        s["total_ms"] += ns / 1e6
        return {"spans": spans, "counts": counts, "sections": sections}


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


TRACER = Tracer()


def span(name: str) -> Span:
    """A host span of ``name`` (``with span(...) as s``; ``s.s`` afterwards)."""
    return TRACER.span(name)


def count(name: str, n: int = 1) -> None:
    TRACER.count(name, n)


def device_counter(name: str, device) -> torch.Tensor:
    return TRACER.device_counter(name, device)


def total_s(name: str) -> float:
    return TRACER.total_s(name)


def counted(name: str) -> int:
    return TRACER.counted(name)


def marking(on: bool = True):
    return TRACER.marking(on)


def mark(section: Optional[str], gap: Optional[str] = None) -> None:
    TRACER.mark(section, gap)


def drop() -> None:
    TRACER.drop()


def fetch() -> None:
    TRACER.fetch()


def snapshot(bank: str = "untraced") -> dict:
    return TRACER.snapshot(bank)


def set_marks(on: bool) -> None:
    """Whether graphs captured from now on hold device marks."""
    TRACER.marks = bool(on)


def section_means(before: dict, after: dict, prefix: str, per: Optional[str] = None) -> Dict[str, float]:
    """{section without ``prefix``: mean ms an interval} of the sections
    starting with ``prefix`` between two snapshots; with ``per``, ms an
    interval of section ``per`` (one a step: ms a step, where a section
    has more than one interval a step, as ``beam.lm`` has)."""

    def added(name):
        a = after["sections"].get(name, {"n": 0, "total_ms": 0.0})
        b = before["sections"].get(name, {"n": 0, "total_ms": 0.0})
        return a["n"] - b["n"], a["total_ms"] - b["total_ms"]

    out = {}
    for name in after["sections"]:
        n, ms = added(name)
        if name.startswith(prefix) and n > 0:
            out[name[len(prefix):]] = ms / (n if per is None else max(added(per)[0], 1))
    return out
