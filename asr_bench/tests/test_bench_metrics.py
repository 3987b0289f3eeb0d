"""The per-layer readers' arithmetic, the name-list lookup by file and the
benchmark file's shape."""

import json
import os
import re
import shutil

import pytest

from asr_bench import shapes, spec, vocab, work
from asr_bench.cells import Run
from asr_bench.reference import model

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _batch(b, n, l, wav_len, text_len):
    uids = tuple(f"u{i}" if w else "" for i, w in enumerate(wav_len))
    return {"b": b, "n": n, "l": l, "wav_len": wav_len, "text_len": text_len, "uids": uids,
            "audio_s": sum(wav_len) / 16000}


def _ctx(run, workload="flagship.train.clean100"):
    bench = spec.benchmark()
    recipe = spec.config(bench, spec.cell(bench, workload)["config"])["recipe"]
    return {"run": run, "recipe": recipe, "arch": model, "vocab": vocab.CHARACTERS.size, "mix": {},
            "kernel_names": spec.kernel_names}


def test_bucket_fill_is_unpadded_over_padded_samples():
    run = Run("train", {}, wall_s=2.0, wait_s=0.5)
    run.batches = [_batch(2, 100, 10, [100, 50], [5, 3]), _batch(2, 200, 10, [200, 0], [7, 0])]
    assert spec.metric_reader("bucket_fill.train")(_ctx(run)) == pytest.approx(100 * 350 / 600)
    assert spec.metric_reader("input_wait_share.train")(_ctx(run)) == pytest.approx(25.0)
    assert spec.metric_reader("input_wait_share.decode")(_ctx(run)) is None


def test_idle_share_and_a_roofline_from_a_trace():
    run = Run("train", {})
    b = _batch(2, 130800, 240, [130800, 100000], [200, 150])
    run.slice_batches = [b]
    run.trace = {"busy_s": 0.75, "window_s": 1.0,
                 "kernels": {"void decoder_scan_fwd_kernel<__nv_bfloat16>(FwdArgs)": 0.004,
                             "void decoder_scan_bwd_kernel<float>(BwdArgs)": 0.006, "elementwise": 1.0}}
    ctx = _ctx(run)
    assert spec.metric_reader("device_idle_share.train")(ctx) == pytest.approx(25.0)
    m = ctx["recipe"]["model"]
    args = (2, shapes.enc_frames(ctx["recipe"], b), 300, 640, 10, 201, 320, 320, 31, 240,
            shapes.enc_lens(ctx["recipe"], b), "bfloat16")
    least = work.least_s(work.scan_fwd(*args), "bfloat16") + work.least_s(work.scan_bwd(*args), "bfloat16")
    assert m["attention"]["dim"] == 300
    assert spec.metric_reader("decoder_scan_roofline.train")(ctx) == pytest.approx(100 * least / 0.01)
    assert spec.metric_reader("lstm_seq_roofline.train")(ctx) is None  # no lstm kernel in the trace: silent


def test_a_name_list_is_every_file_of_the_operation(tmp_path, monkeypatch):
    assert spec.kernel_names("decoder_scan") == ["decoder_scan_fwd_kernel", "decoder_scan_bwd_kernel"]
    shutil.copytree(os.path.join(spec.HERE, "kernels"), tmp_path / "kernels")
    (tmp_path / "kernels" / "decoder_scan" / "redesign.txt").write_text("# a later kernel\nscan_v2_kernel\n")
    monkeypatch.setattr(spec, "HERE", str(tmp_path))
    assert spec.kernel_names("decoder_scan") == ["decoder_scan_fwd_kernel", "decoder_scan_bwd_kernel",
                                                 "scan_v2_kernel"]


def test_the_benchmark_file_names_files_that_exist():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    cells = {w["name"]: w for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and os.path.isfile(os.path.join(spec.ROOT, c["file"]))
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert os.path.isfile(os.path.join(spec.HERE, "traffic", w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(spec.HERE, "limits", w["name"] + ".json"))
        reported = [n for n, m in e2e.items() if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.per_layer(bench, w["name"], reported)
    for m in bench["per_layer"]:
        assert NAME.match(m["name"]) and os.path.isfile(os.path.join(spec.HERE, "metrics", m["name"] + ".py"))
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
    assert len(json.dumps(bench)) < 64 * 1024
