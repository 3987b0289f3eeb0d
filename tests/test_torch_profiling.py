"""The port's measurement layer (``e2e_asr_tpu_torch/utils/profiling.py``)
against the JAX package's ``utils/profiling.py`` and against the bounds
that PERF.md's kernel tables print.

- ``bound_ms`` over the moved work counts gives PERF.md §6's bound column
  to the 3 significant figures printed, where the count depends on the
  shapes alone (the table's other rows counted the valid lengths of the
  card's random draws: their bounds lie between those of half-length and
  full-length rows).
- One formula a function: the storage type changes the bytes' element
  size only, never the operations.
- ``kernel_rooflines(...)["recurrence"]`` is the JAX package's count at the
  flagship's and asr_960h.yaml's shapes; ``Roofline.report()`` is its text.
- ``trace`` writes a Chrome trace on the CPU; ``time_fn`` times on the CPU.
"""

import json
import math
import types

import numpy as np
import pytest
import torch

from e2e_asr_tpu.config import Config as JConfig
from e2e_asr_tpu.utils import profiling as jprof
from e2e_asr_tpu_torch.config import Config as TConfig
from e2e_asr_tpu_torch.utils import profiling as prof

torch.set_num_threads(1)
FLAGSHIP = "configs/libri/asr_example.yaml"
R960 = "configs/libri/asr_960h.yaml"
BF = torch.bfloat16
# (B, S, Dk, E, K, P, H, Emb, V, L): the scan's shapes in PERF.md §6's tables
SCAN = {"flagship": (16, 204, 300, 640, 10, 201, 320, 320, 26, 200),
        "960h": (16, 764, 300, 1024, 10, 201, 512, 512, 26, 520)}
# PERF.md §6's bf16 bounds (ms) that count the valid lengths of the card's draws
BF16_PRINTED = {"bidir_fwd_train flagship": 0.0189, "bidir_bwd flagship": 0.0379, "bidir_fwd_train 960h": 0.1399,
                "bidir_bwd 960h": 0.2798, "scan_fwd flagship": 0.0173, "scan_bwd flagship": 0.0292,
                "scan_fwd 960h": 0.1399, "scan_bwd 960h": 0.2152}


def _meta(*shape, dt=torch.float32):
    return torch.empty(shape, dtype=dt, device="meta")


def _prefix_args(b, t, v, w, k):
    return (_meta(b, t, v), torch.full((b,), t, dtype=torch.int32), _meta(b, w, t, 2),
            _meta(b, w, dt=torch.int64), _meta(b, w, k, dt=torch.int64))


def _as_printed(x: float, printed: str) -> bool:
    """x rounded to the significant figures of ``printed`` (a table's
    number) is that number."""
    sig = len(printed.replace(".", "").lstrip("0"))
    return float(f"{x:.{sig}g}") == float(printed)


def _rows():
    """(name, work, dtype, the bound as PERF.md prints it) of every row whose count
    depends on its shapes alone."""
    fl, h9 = TConfig.load(FLAGSHIP), TConfig.load(R960)
    return [
        ("log_mel flagship", lambda: prof.log_mel_work(fl.data.audio, 16, 130800, 400, 512), None, "0.00312"),
        ("log_mel 960h", lambda: prof.log_mel_work(h9.data.audio, 16, 489200, 400, 512), None, "0.01168"),
        ("prefix flagship", lambda: prof.prefix_work(_prefix_args(16, 204, 26, 16, 24)), None, "0.00324"),
        ("prefix 960h", lambda: prof.prefix_work(_prefix_args(16, 104, 26, 16, 24)), None, "0.00166"),
        ("ctc flagship", lambda: prof.ctc_work(_meta(16, 204, 26), _meta(16, 199, dt=torch.int64),
                                               torch.full((16,), 204), torch.full((16,), 60)), None, "0.00021"),
        ("lstm_seq_fwd bf16 flagship", lambda: prof.lstm_seq_fwd_work(204, 16, 320, 3000.0, 2, BF), BF, "0.0180"),
        ("lstm_seq_bwd bf16 flagship", lambda: prof.lstm_seq_bwd_work(204, 16, 320, 3000.0, 2, BF), BF, "0.0197"),
        ("lstm_seq_fwd bf16 960h", lambda: prof.lstm_seq_fwd_work(764, 16, 512, 9000.0, 2, BF), BF, "0.1059"),
        ("lstm_seq_bwd bf16 960h", lambda: prof.lstm_seq_bwd_work(764, 16, 512, 9000.0, 2, BF), BF, "0.1146"),
    ]


@pytest.mark.parametrize("idx", range(9), ids=[r[0] for r in _rows()])
def test_bound_ms_gives_the_perf_tables_bound(idx):
    name, work, dtype, want = _rows()[idx]
    ms, _ = prof.bound_ms(*work(), dtype or torch.float32)
    assert _as_printed(ms, want), (name, ms, want)


def _bracket(fn, lo_valid, hi_valid, want, dtype=torch.float32):
    lo = prof.bound_ms(*fn(lo_valid), dtype)[0]
    hi = prof.bound_ms(*fn(hi_valid), dtype)[0]
    assert lo <= want <= hi, (lo, want, hi)


@pytest.mark.parametrize("row", ["lstm_bidir_fwd_train", "lstm_bidir_bwd", "lstm_seq_fwd", "lstm_seq_bwd",
                                 "bidir_fwd_train_bf16", "bidir_bwd_bf16", "bidir_fwd_train_bf16_960h",
                                 "bidir_bwd_bf16_960h"])
def test_length_dependent_lstm_bounds_lie_between_half_and_full_rows(row):
    """PERF.md §6's LSTM rows counted the valid rows of lengths drawn in
    [T/2, T] on the card: their bounds lie between the counts at half and at
    full length (float32 lstm_bidir rows: the mean of one D=1280 and three
    D=640 layers)."""
    t, b = 204, 16
    mean = lambda f: lambda v: tuple((f(1280, v)[i] + 3 * f(640, v)[i]) / 4 for i in range(2))  # noqa: E731
    if row == "lstm_bidir_fwd_train":
        _bracket(mean(lambda d, v: prof.lstm_bidir_fwd_work(t, b, d, 320, v, True)), t * b / 2, t * b, 0.228)
    elif row == "lstm_bidir_bwd":
        _bracket(mean(lambda d, v: prof.lstm_bidir_bwd_work(t, b, d, 320, v)), t * b / 2, t * b, 0.456)
    elif row == "lstm_seq_fwd":
        _bracket(lambda v: prof.lstm_seq_fwd_work(816, 32, 256, v), 816 * 16, 816 * 32, 0.317)
    elif row == "lstm_seq_bwd":
        _bracket(lambda v: prof.lstm_seq_bwd_work(816, 32, 256, v), 816 * 16, 816 * 32, 0.633)
    elif row == "bidir_fwd_train_bf16":
        _bracket(lambda v: prof.lstm_bidir_fwd_work(t, b, 1280, 320, v, True, BF), t * b / 2, t * b,
                 BF16_PRINTED["bidir_fwd_train flagship"], BF)
    elif row == "bidir_bwd_bf16":
        _bracket(lambda v: prof.lstm_bidir_bwd_work(t, b, 1280, 320, v, BF), t * b / 2, t * b,
                 BF16_PRINTED["bidir_bwd flagship"], BF)
    elif row == "bidir_fwd_train_bf16_960h":
        _bracket(lambda v: prof.lstm_bidir_fwd_work(764, 16, 1280, 512, v, True, BF), 764 * 8, 764 * 16,
                 BF16_PRINTED["bidir_fwd_train 960h"], BF)
    else:
        _bracket(lambda v: prof.lstm_bidir_bwd_work(764, 16, 1280, 512, v, BF), 764 * 8, 764 * 16,
                 BF16_PRINTED["bidir_bwd 960h"], BF)


@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("row", ["float32 flagship", "bf16 flagship", "bf16 960h"])
def test_length_dependent_scan_and_decode_bounds_lie_between_half_and_full_rows(which, row):
    """The scan rows (float32 0.255 / 0.350 ms at the flagship; bf16 at the
    flagship's and 960h's shapes) and the attention step's (0.00795 ms)
    counted the card's random lengths in [S/2, S], the first at S."""
    dtype, shape = (torch.float32 if row.startswith("float32") else BF), row.split()[1]
    dims = SCAN[shape]
    b, s = dims[:2]
    fn = prof.decoder_scan_fwd_work if which == "fwd" else prof.decoder_scan_bwd_work
    lo = prof.bound_ms(*fn(*dims, [s] + [s // 2] * (b - 1), dtype), dtype)[0]
    hi = prof.bound_ms(*fn(*dims, [s] * b, dtype), dtype)[0]
    want = {"fwd": 0.255, "bwd": 0.350}[which] if dtype == torch.float32 else BF16_PRINTED[f"scan_{which} {shape}"]
    assert lo <= want <= hi, (lo, want, hi)
    att = lambda n: (_meta(16, 16, 300), _meta(16, 16, 204), _meta(16, 204, 300), _meta(16, 204, 640),  # noqa: E731
                     torch.full((16,), n), _meta(10, 201))
    assert prof.bound_ms(*prof.att_step_work(att(102)))[0] <= 0.00795 <= prof.bound_ms(*prof.att_step_work(att(204)))[0]


@pytest.mark.parametrize("fn,args", [
    (prof.lstm_seq_fwd_work, (204, 16, 320, 3000.0, 2)),
    (prof.lstm_seq_bwd_work, (764, 16, 512, 9000.0, 1)),
    (prof.lstm_bidir_fwd_work, (204, 16, 1280, 320, 2500.0, True)),
    (prof.lstm_bidir_bwd_work, (764, 16, 1280, 512, 9000.0)),
    (prof.decoder_scan_fwd_work, SCAN["flagship"] + ([204] + [150] * 15,)),
    (prof.decoder_scan_bwd_work, SCAN["960h"] + ([764] + [400] * 15,)),
], ids=["lstm_seq_fwd", "lstm_seq_bwd", "lstm_bidir_fwd_train", "lstm_bidir_bwd", "decoder_scan_fwd",
        "decoder_scan_bwd"])
def test_the_storage_type_changes_only_the_element_size(fn, args):
    """A kernel's least work at bf16 is its float32 work with the tensors
    stored in bf16 read and written at 2 bytes: the same operations, and
    bytes fewer but more than half (the float32 residuals and the mask
    stay 4 bytes)."""
    nb32, nf32 = fn(*args, dtype=torch.float32)
    nb16, nf16 = fn(*args, dtype=BF)
    assert nf16 == nf32 > 0
    assert nb32 / 2 < nb16 < nb32

def test_conv_taps_counts_the_taps_on_valid_frames():
    # a 5-tap centred filter over 3 frames: 3 + 3 + 3 taps inside, over 6
    assert prof.conv_taps([3], 5) == 9.0
    assert prof.conv_taps([6], 5) == 3 + 4 + 5 + 5 + 4 + 3
    assert prof.conv_taps(torch.tensor([3, 6]), 5) == 9.0 + 24.0


@pytest.mark.parametrize("path,b,frames,l_tok", [(FLAGSHIP, 16, 816, 240), (R960, 16, 3056, 520),
                                                  (R960, 32, 416, 160)])
def test_kernel_rooflines_recurrence_is_jaxs_count(path, b, frames, l_tok):
    got = prof.kernel_rooflines(TConfig.load(path), b, frames, l_tok, 26)["recurrence"]
    want = jprof.kernel_rooflines(JConfig.load(path), b, frames, l_tok, 26)["recurrence"]
    assert got.flops == want.flops > 0 and got.bytes_moved == want.bytes_moved > 0
    assert got.name == want.name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_rooflines_cover_every_hand_kernel(dtype):
    """Every kernel of the flagship at a bucket, each entry the work
    function's count at full lengths and its peak; bf16 moves fewer bytes
    through the LSTM pair and the scan pair, and the decode kernels and the
    frontend stay float32."""
    cfg = TConfig.load(FLAGSHIP)
    r = prof.kernel_rooflines(cfg, 16, 816, 200, 26, dtype)
    assert set(r) == {"log_mel", "recurrence", "lstm_seq_fwd", "lstm_seq_bwd", "lstm_bidir_fwd",
                      "lstm_bidir_fwd_train", "lstm_bidir_bwd", "ctc_loss", "decoder_scan_fwd",
                      "decoder_scan_bwd", "att_step_beam_loc", "prefix_recursion"}
    dt = prof.as_dtype(dtype)
    # four layers of 204 frames: D 1280 then 640
    want = [prof.lstm_bidir_bwd_work(204, 16, d, 320, 204 * 16, dt) for d in (1280, 640, 640, 640)]
    assert r["lstm_bidir_bwd"].bytes_moved == sum(w[0] for w in want)
    assert r["lstm_bidir_bwd"].flops == sum(w[1] for w in want)
    nb, nf = prof.decoder_scan_fwd_work(*SCAN["flagship"][:-1], 200, [204] * 16, dt)
    assert (r["decoder_scan_fwd"].bytes_moved, r["decoder_scan_fwd"].flops) == (nb, nf)
    assert r["decoder_scan_fwd"].dtype_peak == prof.peak_flops(dt)
    for k in ("log_mel", "ctc_loss", "att_step_beam_loc", "prefix_recursion"):
        assert r[k].dtype_peak == prof.PEAK_F32_FLOPS and r[k].flops > 0 and r[k].bytes_moved > 0
    f32 = prof.kernel_rooflines(cfg, 16, 816, 200, 26, "float32")
    if dtype == "bfloat16":
        for k in ("lstm_seq_fwd", "lstm_seq_bwd", "decoder_scan_fwd", "decoder_scan_bwd"):
            assert r[k].bytes_moved < f32[k].bytes_moved
        assert r["ctc_loss"].bytes_moved == f32["ctc_loss"].bytes_moved


def test_bound_ms_picks_the_larger_time_at_the_dtypes_peak():
    assert prof.bound_ms(3.35e12, 0.0) == (1e3, "bytes")
    assert prof.bound_ms(0.0, 67e12) == (1e3, "operations")
    assert prof.bound_ms(0.0, 989e12, "bfloat16") == (1e3, "operations")
    assert prof.bound_ms(3.35e9, 67e9, torch.float32)[1] == "bytes"  # a tie goes to bytes


@pytest.mark.parametrize("flops,bytes_", [(1e12, 0.0), (0.0, 3e9), (5e11, 8e9), (2e13, 1e8)])
def test_roofline_report_is_jaxs_text(flops, bytes_):
    """The same fields give the JAX package's text; the default peaks are
    the card's."""
    kw = dict(flops=flops, bytes_moved=bytes_, dtype_peak=989e12, hbm_peak=3.35e12)
    got = prof.Roofline("stage", 0.0123, **kw)
    want = jprof.Roofline("stage", 0.0123, **kw)
    assert got.report() == want.report()
    assert got.achieved_tflops == want.achieved_tflops
    assert (got.sol_compute, got.sol_memory) == (want.sol_compute, want.sol_memory)
    assert (prof.Roofline("x", 1.0).dtype_peak, prof.Roofline("x", 1.0).hbm_peak) == (989e12, 3.35e12)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with prof.trace(str(tmp_path / "tr"), "cpu_matmul"):
        (x @ x).sum()
    path = tmp_path / "tr" / "cpu_matmul.json"
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("mm" in n or "matmul" in n for n in names), sorted(names)[:20]


def test_time_fn_on_the_cpu_is_the_median_of_three_rounds(monkeypatch):
    calls = []
    clock = iter([0.0, 3.0, 10.0, 11.0, 20.0, 22.0])
    monkeypatch.setattr(prof, "time", types.SimpleNamespace(perf_counter=lambda: next(clock)))
    s = prof.time_fn(lambda x: calls.append(x), 7, iters=1, warmup=2)
    assert calls == [7] * 5
    assert s == 2.0  # rounds of 3, 1 and 2 s
    monkeypatch.undo()
    t = prof.time_fn(lambda: torch.ones(8).sum(), iters=3, warmup=1)
    assert math.isfinite(t) and t > 0


def test_time_fn_times_the_card_by_default_where_one_is_present(monkeypatch):
    """With a card present ``time_fn`` takes CUDA events (``device_ms``)
    unless told the CPU, whatever its arguments hold (a closure over card
    work passes none); told the CPU, it synchronises the card around each
    host-clock round."""
    rounds, syncs = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: syncs.append(1))
    monkeypatch.setattr(prof, "device_ms", lambda f, iters, warmup: rounds.append(iters) or 4.0)
    assert prof.time_fn(lambda: None, iters=3, warmup=0) == 4.0e-3
    assert rounds == [3, 3, 3] and not syncs
    t = prof.time_fn(lambda: None, iters=2, warmup=0, device="cpu")
    assert math.isfinite(t) and rounds == [3, 3, 3] and len(syncs) == 6


def test_peaks_are_the_h100_data_sheet_at_700w():
    assert (prof.PEAK_BF16_FLOPS, prof.PEAK_F32_FLOPS, prof.PEAK_HBM_BYTES) == (989e12, 67e12, 3.35e12)
    assert prof.peak_flops("bfloat16") == 989e12 and prof.peak_flops(torch.float32) == 67e12
    assert prof.esize("bfloat16") == 2 and prof.esize(torch.float32) == 4
    assert np.isclose(prof.bound_ms(1, 1)[0], 1 / 3.35e12 * 1e3)
