"""The port's tracer (``e2e_asr_tpu_torch/utils/tracing.py``) on the CPU.

- Spans nest through a stack per thread, each carrying its parent; a
  name's total is the time its spans cover (a span nested in one of its
  own name adds nothing to it). Counters count.
- With no profiler recording, no ``record_function`` is opened; under one,
  the spans go to the ``traced`` bank.
- ``utils/profiling.device_events`` leaves the spans' user annotations out
  of the card's work.
- ``utils/profiling.trace`` around a CPU decode through ``bin/test_asr``'s
  ``Solver.decode_batch`` writes a Chrome trace in which
  ``asr.decode.batch`` encloses ``asr.decode.features``, ``.encoder``,
  ``.steps`` and ``.rank``.
- No device mark launches on the CPU, and the benchmark's five readers of
  the tracer (``asr_bench/metrics``) give their value on a hand-built
  snapshot, None on an empty one and None where the program has no tracer
  (a parent commit's).
The card's half (marks inside the replayed graphs) is in
``tests/test_torch_cuda.py``.
"""

import json
import sys
import threading
import time

import pytest
import torch

from e2e_asr_tpu_torch.utils import tracing


def _busy(ms: float) -> None:
    t = time.perf_counter() + ms / 1e3
    while time.perf_counter() < t:
        pass


def test_spans_nest_with_parent_id_total_and_self_time():
    """Parents and totals (a span keeps no id and no self time: nothing
    reads them)."""
    tr = tracing.Tracer()
    with tr.span("outer") as outer:
        _busy(2)
        with tr.span("inner") as inner:
            _busy(3)
            with tr.span("outer") as again:  # nested in its own name
                _busy(1)
        with tr.span("inner") as other:
            _busy(1)
    assert inner.parent is outer and again.parent is inner and other.parent is outer and outer.parent is None
    assert outer.s >= inner.s + other.s and inner.s >= again.s >= 1e-3
    snap = tr.snapshot()
    assert set(snap["spans"]) == {"outer", "inner"} and snap["counts"] == {} and snap["sections"] == {}
    o, i = snap["spans"]["outer"], snap["spans"]["inner"]
    assert o["n"] == 2 and i["n"] == 2
    assert o["total_s"] == pytest.approx(outer.s, abs=1e-9)  # the nested "outer" adds to no total
    assert i["total_s"] == pytest.approx(inner.s + other.s, abs=1e-9)
    assert tr.total_s("inner") == pytest.approx(i["total_s"]) and tr.total_s("absent") == 0.0
    assert tr.snapshot("traced")["spans"] == {} and tr.snapshot("all")["spans"] == snap["spans"]


def test_each_thread_has_its_own_stack():
    tr = tracing.Tracer()
    seen = {}

    def other():
        with tr.span("thread") as s:
            seen["parent"] = s.parent

    with tr.span("main"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen["parent"] is None
    assert tr.snapshot()["spans"]["thread"]["n"] == 1


def test_threads_lose_no_update():
    """More threads than cores entering spans and counting with a short
    switch interval: every span and count is kept."""
    tr = tracing.Tracer()
    n_threads, n_each = 16, 400

    def work():
        for _ in range(n_each):
            with tr.span("input.wait"):
                tr.count("input.batches")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    snap = tr.snapshot()
    assert snap["spans"]["input.wait"]["n"] == snap["counts"]["input.batches"] == n_threads * n_each


def test_counters_count():
    tr = tracing.Tracer()
    tr.count("graph.replays")
    tr.count("graph.replays", 4)
    tr.count("kernels.built", 0)
    assert tr.snapshot()["counts"] == {"graph.replays": 5, "kernels.built": 0}
    assert tr.counted("graph.replays") == 5 and tr.counted("absent") == 0


def test_no_profiler_opens_no_range_and_keeps_no_list(monkeypatch):
    """No range opened (and no list kept, profiler or not: the Chrome
    trace holds the spans)."""
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    tr = tracing.Tracer()
    for i in range(3):
        with tr.span("decode.batch"):
            with tr.span("decode.steps"):
                pass
    assert opened == []
    assert tr.snapshot()["spans"]["decode.batch"]["n"] == 3


def test_spans_under_a_profiler_go_to_the_traced_bank_and_the_list():
    """The traced bank (the spans' list is the Chrome trace's ranges)."""
    from torch.profiler import ProfilerActivity, profile

    tr = tracing.Tracer()
    with tr.span("input.wait"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with tr.span("decode.batch"):
            tr.count("input.batches")
            with tr.span("decode.rank"):
                pass
    with tr.span("input.wait"):
        pass
    untraced = tr.snapshot()
    assert set(untraced["spans"]) == {"input.wait"} and untraced["spans"]["input.wait"]["n"] == 2
    traced = tr.snapshot("traced")
    assert set(traced["spans"]) == {"decode.batch", "decode.rank"} and traced["counts"] == {"input.batches": 1}


def test_device_events_leave_out_the_spans_annotations():
    """``profiling.device_events`` keeps the card's kernels, copies and sets
    and leaves out the user annotations the profiler mirrors onto the
    card's timeline: an ``asr.*`` span (flagged, or only by its name on a
    torch that does not flag it), the benchmark's ``bench.*`` spans."""
    from types import SimpleNamespace as NS

    from e2e_asr_tpu_torch.utils import profiling

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [NS(key="sgemm_64x64", device_type=cuda, count=5, is_user_annotation=False),
              NS(key="Memcpy HtoD (Pinned -> Device)", device_type=cuda, count=2, is_user_annotation=False),
              NS(key="asr.decode.steps", device_type=cuda, count=1, is_user_annotation=True),
              NS(key="asr.graph.replay", device_type=cuda, count=7),
              NS(key="bench.window", device_type=cuda, count=1, is_user_annotation=True),
              NS(key="asr.decode.steps", device_type=cpu, count=1, is_user_annotation=True),
              NS(key="aten::add_", device_type=cpu, count=3, is_user_annotation=False)]
    prof = NS(key_averages=lambda: events)
    assert [e.key for e in profiling.device_events(prof)] == ["sgemm_64x64", "Memcpy HtoD (Pinned -> Device)"]
    assert profiling.device_launches(prof) == 7


def test_kernels_ready_logs_its_span_and_the_libraries_compiled(monkeypatch):
    """``solver.kernels_ready`` (every solver's, on the card): the build in
    a ``setup.kernels`` span and the libraries it compiled, in its log line."""
    from e2e_asr_tpu_torch import cuda_build, solver

    def build_all():
        for _ in range(2):
            tracing.count("kernels.built")

    monkeypatch.setattr(cuda_build, "build_all", build_all)
    before = tracing.snapshot()["spans"].get("setup.kernels", {"n": 0})["n"]
    said = []
    solver.kernels_ready(said.append)
    assert tracing.snapshot()["spans"]["setup.kernels"]["n"] == before + 1
    assert len(said) == 1 and said[0].startswith("CUDA kernels ready in ") and said[0].endswith(
        "(2 libraries compiled)"), said


def test_marks_launch_nothing_on_the_cpu(monkeypatch):
    from e2e_asr_tpu_torch import cuda_build

    monkeypatch.setattr(cuda_build, "launch", lambda *a, **k: pytest.fail("a mark launched"))
    tr = tracing.Tracer()
    tr.mark("train.features", gap="train.between_steps")
    with tr.marking():
        tr.mark("beam.search")
        tr.mark(None)
    tr.drop()
    assert tr.snapshot()["sections"] == {}


def test_section_means_between_two_snapshots():
    before = {"sections": {"train.optimizer": {"n": 2, "total_ms": 6.0}}}
    after = {"sections": {"train.optimizer": {"n": 6, "total_ms": 19.0}, "train.heads": {"n": 4, "total_ms": 80.0},
                          "beam.lm": {"n": 9, "total_ms": 1.0}}}
    assert tracing.section_means(before, after, "train.") == {"optimizer": 3.25, "heads": 20.0}
    assert tracing.section_means(after, after, "train.") == {}
    # a step of two LM intervals: ms a step, over the speller's intervals
    after["sections"].update({"beam.speller": {"n": 4, "total_ms": 2.0}})
    assert tracing.section_means(before, after, "beam.", per="beam.speller") == {"lm": 0.25, "speller": 0.5}


def _cpu_solver():
    """bin/test_asr's Solver at test size on the CPU (the flagship's
    structure: VGG prenet, two 32-wide BiLSTM layers, location attention,
    a 32-wide speller, CTC head; beam 4 with CTC prefix scores), made as
    the benchmark makes it."""
    from e2e_asr_tpu_torch.bin import test_asr
    from e2e_asr_tpu_torch.config import Config
    from e2e_asr_tpu_torch.models import asr as asr_mod

    cfg = Config.from_dict({
        "data": {"audio": {"feat_dim": 40}},
        "model": {
            "ctc_weight": 0.5,
            "encoder": {"prenet": "vgg", "dim": [32, 32], "dropout": [0.0, 0.0], "layer_norm": [False, False],
                        "proj": [True, True], "sample_rate": [1, 1], "sample_style": "drop"},
            "attention": {"mode": "location", "dim": 16, "num_head": 1, "loc_kernel_size": 5, "loc_kernel_num": 3},
            "decoder": {"dim": 32, "layer": 1},
        },
        "decode": {"beam_size": 4, "ctc_weight": 0.3, "lm_weight": 0.0, "max_len_ratio": 0.8, "min_len_ratio": 0.2},
    })
    solver = test_asr.Solver.__new__(test_asr.Solver)
    solver.config, solver.device = cfg, torch.device("cpu")
    solver.params, _ = asr_mod.asr_init(0, 40, 12, cfg.model, solver.device)
    solver.lm_params = solver.lm_cfg = solver.beam_graphs = None
    return solver


def test_chrome_trace_holds_a_decoded_batch_and_its_parts(tmp_path):
    from e2e_asr_tpu_torch.utils import profiling

    torch.manual_seed(0)
    solver = _cpu_solver()
    wav = 0.1 * torch.randn((2, 6000))
    wav_len = torch.tensor([6000, 4400])
    with profiling.trace(str(tmp_path), "decode"):
        res = solver.decode_batch(wav, wav_len)
    assert res.tokens.shape[:2] == (2, 4)
    events = json.load(open(tmp_path / "decode.json"))["traceEvents"]
    spans = {e["name"][4:]: (float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("asr.")}
    assert {"decode.batch", "decode.features", "decode.encoder", "decode.steps", "decode.rank"} <= set(spans)
    a, b = spans["decode.batch"]
    parts = [spans[f"decode.{p}"] for p in ("features", "encoder", "steps", "rank")]
    assert all(a <= s <= e <= b for s, e in parts)
    assert all(e0 <= s1 for (_, e0), (s1, _) in zip(parts, parts[1:]))  # in this order


BENCH_READERS = ("optimizer_ms.train", "lm_step_share.decode", "batch_gap_share.decode", "graph_capture_s",
                 "kernel_load_s")


def _snap(sections=(), spans=()):
    return {"spans": {k: {"n": 1, "total_s": v} for k, v in spans},
            "counts": {}, "sections": {k: {"n": n, "total_ms": ms} for k, n, ms in sections}}


@pytest.mark.parametrize("name,snap,want", [
    ("optimizer_ms.train", _snap([("train.optimizer", 4, 13.0), ("train.heads", 4, 80.0)]), 3.25),
    ("lm_step_share.decode", _snap([("beam.speller", 10, 5.0), ("beam.lm", 10, 2.0), ("beam.search", 10, 3.0),
                                    ("beam.between_steps", 9, 50.0)]), 20.0),
    ("batch_gap_share.decode", _snap([("beam.speller", 10, 5.0), ("beam.search", 10, 3.0),
                                      ("beam.between_steps", 9, 1.0), ("beam.between_batches", 1, 1.0),
                                      ("train.optimizer", 2, 90.0)]), 10.0),
    ("graph_capture_s", _snap(spans=[("graph.capture", 2.5), ("graph.replay", 9.0)]), 2.5),
    ("kernel_load_s", _snap(spans=[("setup.kernels", 0.75)]), 0.75),
])
def test_bench_readers_of_the_tracer(monkeypatch, name, snap, want):
    from asr_bench import spec

    read = spec.metric_reader(name)
    banks = []
    monkeypatch.setattr(tracing, "snapshot", lambda bank="untraced": banks.append(bank) or snap)
    assert read({}) == pytest.approx(want)
    monkeypatch.setattr(tracing, "snapshot", lambda bank="untraced": _snap())
    assert read({}) is None
    assert set(banks) == {"untraced"}


def test_bench_readers_are_silent_without_a_tracer(monkeypatch):
    """Where the program has no ``utils/tracing.py`` (a parent commit's), the
    readers return None and raise nothing."""
    from asr_bench import spec

    monkeypatch.setitem(sys.modules, "e2e_asr_tpu_torch.utils.tracing", None)
    monkeypatch.delattr("e2e_asr_tpu_torch.utils.tracing")
    for name in BENCH_READERS:
        assert spec.metric_reader(name)({}) is None, name
