"""The port's decode CLI end to end on the CPU, its device rules, the kernel
wrappers' routing, and the rule that the port imports nothing of JAX or of
the JAX package."""

import ast
import csv
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from e2e_asr_tpu.config import Config as JConfig
from e2e_asr_tpu.models import asr as jasr
from e2e_asr_tpu_torch import convert, cuda_build
from e2e_asr_tpu_torch.config import AudioConfig
from e2e_asr_tpu_torch.data import corpus
from e2e_asr_tpu_torch.data.dataset import build_tokenizer
from e2e_asr_tpu_torch.decode import ctc_prefix, ctc_prefix_cuda
from e2e_asr_tpu_torch.device import resolve_device
from e2e_asr_tpu_torch.main import main as cli_main
from e2e_asr_tpu_torch.ops import att_step_cuda, ctc_cuda, decoder_cuda, frontend_cuda, rnn_cuda
from tests.torch_parity import small_config

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "e2e_asr_tpu_torch")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if os.path.join(dirpath, d) != cuda_build.BUILD_DIR]
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return out


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == "e2e_asr_tpu"


def test_port_imports_nothing_of_jax():
    """No file of the port, nor chip_smoke.py, imports jax or e2e_asr_tpu
    (e2e_asr_tpu_torch is the port itself)."""
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            bad += [f"{os.path.relpath(path, ROOT)}: {n}" for n in names if _forbidden(n)]
    assert not bad, bad
    # and at run time: importing every module of the port loads neither
    mods = [
        os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".").removesuffix(".__init__")
        for p in _port_sources()[1:]
    ]
    code = (
        "import sys\n"
        f"for m in {mods!r}: __import__(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'e2e_asr_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)


def test_decode_cli_on_cpu(tmp_path):
    """main --test --cpu on the shipped configs/synthetic_decode.yaml (splits
    shrunk, src pointed at a small training config) with a checkpoint that
    convert.py wrote from JAX weights: both CSVs for both splits."""
    train_d = small_config()
    train_d["data"] = {
        "corpus": {"name": "synthetic", "train_split": ["train:16"]},
        "audio": {"feat_dim": 40, "use_pallas": True},
        "text": {"mode": "character"},
    }
    train_yaml = tmp_path / "train.yaml"
    train_yaml.write_text(yaml.safe_dump(train_d))
    with open(os.path.join(ROOT, "configs", "synthetic_decode.yaml")) as f:
        d = yaml.safe_load(f)
    d["data"]["corpus"].update(
        train_split=["train:16"], dev_split=["dev:6"], test_split=["test:6"],
        buckets=[416], token_buckets=[48],
    )
    d["src"] = {"ckpt": "", "config": str(train_yaml)}
    d["decode"].update(beam_size=2, batch_size=2, max_len_ratio=0.3)
    decode_yaml = tmp_path / "decode.yaml"
    decode_yaml.write_text(yaml.safe_dump(d))

    tok = build_tokenizer(JConfig.from_dict(train_d).data, corpus.load_corpus("synthetic", "", ["train:16"]))
    jcfg = JConfig.from_dict(train_d)
    jp, _ = jasr.asr_init(jax.random.PRNGKey(0), 40, tok.vocab_size, jcfg.model)
    ckpt = str(tmp_path / "asr.pt")
    convert.save_checkpoint(ckpt, convert.params_from_jax(jax.device_get(jp)), tok.vocab_size, 40)

    out = tmp_path / "res"
    ers = cli_main(["--config", str(decode_yaml), "--test", "--cpu", "--load", ckpt,
                    "--name", "port", "--outdir", str(out), "--no-msg"])
    assert set(ers) == {"dev", "test"}
    for split in ("dev", "test"):
        with open(out / "port" / f"output_{split}.csv") as f:
            rows = list(csv.reader(f, delimiter="\t"))
        with open(out / "port" / f"beam_{split}.csv") as f:
            beams = list(csv.reader(f, delimiter="\t"))
        assert rows[0] == ["idx", "truth", "prediction"]
        assert beams[0] == ["idx", "truth", "prediction", "score"]
        assert len(rows) > 1 and len(beams) == 1 + 2 * (len(rows) - 1)
        assert all(np.isfinite(float(r[3])) for r in beams[1:])
        assert 0.0 <= ers[split] < 50.0


def _tiny_train_yaml(tmp_path, max_step=2):
    """The flagship's structure at test size on the synthetic corpus, with
    dither, SpecAugment, dropout and scheduled teacher forcing on."""
    d = small_config()
    d["data"] = {
        "corpus": {"name": "synthetic", "train_split": ["train:8"], "dev_split": ["dev:4"],
                   "batch_size": 4, "buckets": [416], "token_buckets": [48], "half_batch_len": 1000},
        "audio": {"feat_dim": 40, "use_pallas": True, "dither": 1e-5},
        "text": {"mode": "character"},
    }
    d["hparas"] = {"valid_step": 2, "max_step": max_step, "log_step": 1, "optimizer": "Adadelta",
                   "lr": 1.0, "eps": 1e-8, "grad_clip": 5.0, "curriculum": 1, "tf_start": 0.9,
                   "tf_end": 0.5, "tf_step": 10}
    d["model"]["encoder"]["dropout"] = [0.1, 0.0]
    d["model"]["decoder"]["dropout"] = 0.1
    d["model"]["specaugment"] = {"enable": True, "freq_mask_width": 5, "time_mask_width": 10}
    path = tmp_path / "tiny_train.yaml"
    path.write_text(yaml.safe_dump(d))
    return path


def test_train_cli_on_cpu_then_resume_and_decode(tmp_path):
    """main --cpu trains 2 steps and writes best_att / best_ctc / latest
    with the optimizer state; a second run resumes from latest; --test
    --load decodes the training checkpoint's params."""
    train_yaml = _tiny_train_yaml(tmp_path)
    dirs = ["--logdir", str(tmp_path / "log"), "--ckpdir", str(tmp_path / "ckpt"), "--no-msg"]
    cli_main(["--config", str(train_yaml), "--cpu", "--name", "tiny", *dirs])
    ck = tmp_path / "ckpt" / "tiny"
    for f in ("latest", "best_att", "best_ctc", "tokenizer.vocab"):
        assert (ck / f).is_file(), f
    payload = torch.load(ck / "latest", weights_only=True)
    assert payload["step"] == 2 and payload["opt_state"]["count"] == 2
    assert (ck / "latest.meta").read_text().splitlines()[1] == "global_step 2"
    with open(tmp_path / "log" / "tiny" / "scalars.jsonl") as f:
        recs = [json.loads(line) for line in f]
    tags = {r["tag"] for r in recs}
    assert {"loss", "grad_norm", "tf_rate", "throughput_audio_sec_per_sec", "dev_loss", "er"} <= tags
    assert all(np.isfinite(r["value"]) for r in recs if r["tag"] == "grad_norm")

    cli_main(["--config", str(train_yaml), "--cpu", "--name", "tiny", "-o", "hparas.max_step=3", *dirs])
    resumed = torch.load(ck / "latest", weights_only=True)
    assert resumed["step"] == 3 and resumed["opt_state"]["count"] == 3

    with open(os.path.join(ROOT, "configs", "synthetic_decode.yaml")) as f:
        d = yaml.safe_load(f)
    d["data"]["corpus"].update(train_split=["train:8"], dev_split=["dev:4"], test_split=["test:4"],
                               buckets=[416], token_buckets=[48])
    d["src"] = {"ckpt": "", "config": str(train_yaml)}
    d["decode"].update(beam_size=2, batch_size=2, max_len_ratio=0.3)
    decode_yaml = tmp_path / "decode.yaml"
    decode_yaml.write_text(yaml.safe_dump(d))
    ers = cli_main(["--config", str(decode_yaml), "--test", "--cpu", "--load", str(ck / "latest"),
                    "--name", "tiny", "--outdir", str(tmp_path / "res"), "--no-msg"])
    assert set(ers) == {"dev", "test"} and all(np.isfinite(v) for v in ers.values())


def test_train_cli_routes_fused_scan_and_lstm_seq(tmp_path, monkeypatch):
    """-o model.decoder.fused_scan=pallas and -o model.encoder.rnn_impl=pallas
    send the CLI's training through the fused scan (with failing coins and
    sampled feedback: tf 0.9 -> 0.5) and the fused-projection LSTM pair; the
    defaults ('auto') keep the Python loop on the CPU and take lstm_seq;
    'pallas' with decoder dropout raises."""
    train_yaml = _tiny_train_yaml(tmp_path)
    calls = {"scan": 0, "seq": 0}
    real_scan, real_seq = decoder_cuda.decoder_scan_fwd, rnn_cuda.lstm_seq_fwd

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(decoder_cuda, "decoder_scan_fwd", count("scan", real_scan))
    monkeypatch.setattr(rnn_cuda, "lstm_seq_fwd", count("seq", real_seq))

    def run(name, *overrides):
        dirs = ["--logdir", str(tmp_path / "log"), "--ckpdir", str(tmp_path / "ckpt"), "--no-msg"]
        cli_main(["--config", str(train_yaml), "--cpu", "--name", name, *dirs,
                  *[x for o in overrides for x in ("-o", o)]])
        with open(tmp_path / "log" / name / "scalars.jsonl") as f:
            recs = [json.loads(line) for line in f]
        assert all(np.isfinite(r["value"]) for r in recs if r["tag"] == "grad_norm")

    run("auto")  # the loop on the CPU; 'auto' routes the layers through lstm_seq
    assert calls["scan"] == 0 and calls["seq"] >= 4  # 2 steps (+ validation), 2 layers
    seq = calls["seq"]
    with pytest.raises(ValueError, match="envelope"):
        run("bad", "model.decoder.fused_scan=pallas", "model.encoder.rnn_impl=pallas")
    run("fused", "model.decoder.fused_scan=pallas", "model.decoder.dropout=0.0",
        "model.encoder.rnn_impl=pallas")
    assert calls["scan"] >= 2 and calls["seq"] == seq  # 'pallas': the fused-projection pair


def test_cli_later_slices_raise(tmp_path):
    """--lm is a later slice; training needs CUDA unless --cpu is given."""
    cfg = str(os.path.join(ROOT, "configs", "synthetic_decode.yaml"))
    with pytest.raises(NotImplementedError, match="later slice"):
        cli_main(["--config", cfg, "--lm", "--cpu"])
    if torch.cuda.is_available():
        return
    train_yaml = _tiny_train_yaml(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["--config", str(train_yaml), "--logdir", str(tmp_path / "log"),
                  "--ckpdir", str(tmp_path / "ckpt"), "--no-msg"])


def test_cuda_device_without_cuda_raises():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")


def _wrapper_calls():
    """(wrapper, plain version, args on CPU) for every kernel wrapper."""
    cfg = AudioConfig(feat_dim=40)
    wav = torch.randn(2, 2000)
    x, mask = torch.randn(5, 2, 8), torch.ones(5, 2)
    wx, wh, b = torch.randn(2, 8, 32), torch.randn(2, 8, 32), torch.randn(2, 32)
    q, prev = torch.randn(2, 3, 6), torch.rand(2, 3, 11)
    k, v, lens = torch.randn(2, 11, 6), torch.randn(2, 11, 7), torch.tensor([11, 6])
    taps, wlp, locv, locb = torch.randn(2, 5), torch.randn(2, 6), torch.randn(6), torch.randn(6)
    lp_c = torch.log_softmax(torch.randn(2, 9, 6), -1)
    lens_c = torch.tensor([9, 5])
    prefix = (lp_c, lens_c, ctc_prefix.init_empty_prefix(lp_c, lens_c, 3), torch.zeros((2, 3), dtype=torch.long),
              torch.randint(1, 6, (2, 3, 4)), True)
    ys, c, acts = rnn_cuda.lstm_bidir_fwd_train_plain(x, mask, wx, wh, b)
    dy = torch.randn(ys.shape)
    lp = torch.log_softmax(torch.randn(2, 9, 6), -1)
    labels, inlen, lablen = torch.tensor([[1, 2, 2], [3, 0, 0]]), torch.tensor([9, 5]), torch.tensor([3, 1])
    xw, mask2, wh1 = torch.randn(5, 4, 32), torch.ones(5, 4), torch.randn(2, 8, 32)
    sys_, sc, sacts = rnn_cuda.lstm_seq_fwd_plain(xw, mask2, wh1)
    scan = (k, v, lens, taps, torch.randn(8, 6), torch.randn(6), wlp, locv, locb, torch.randn(5, 4),
            torch.randn(11, 32), torch.randn(8, 32), torch.randn(32), torch.randn(8, 5), torch.randn(5),
            torch.randint(0, 5, (3, 2), dtype=torch.int32), torch.tensor([True, False, True]), 0.5)
    logits, align, hidden, (cseq, _, dacts, qs, ctxs) = decoder_cuda.decoder_scan_fwd_plain(*scan)
    scan_bwd = (k, v, lens, taps, scan[4], wlp, locv, locb, scan[10], scan[11], scan[13], align, hidden,
                cseq, dacts, qs, ctxs, torch.randn(logits.shape), torch.randn(align.shape),
                torch.randn(hidden.shape), 0.5)
    return [
        (frontend_cuda.log_mel, frontend_cuda.log_mel_plain, (wav, cfg, 400, 160, 512)),
        (rnn_cuda.lstm_bidir_fwd, rnn_cuda.lstm_bidir_fwd_plain, (x, mask, wx, wh, b)),
        (att_step_cuda.att_step_beam_loc, att_step_cuda.att_step_beam_loc_plain,
         (q, prev, k, v, lens, taps, wlp, locv, locb, 0.5)),
        (ctc_prefix_cuda.prefix_scores_fused, ctc_prefix_cuda.prefix_scores_fused_plain, prefix),
        (rnn_cuda.lstm_bidir_fwd_train, rnn_cuda.lstm_bidir_fwd_train_plain, (x, mask, wx, wh, b)),
        (rnn_cuda.lstm_bidir_bwd, rnn_cuda.lstm_bidir_bwd_plain, (x, mask, wx, wh, ys, c, acts, dy)),
        (ctc_cuda.ctc_lattice, ctc_cuda.ctc_lattice_grad_plain, (lp, labels, inlen, lablen)),
        (lambda *a: rnn_cuda.lstm_seq_fwd(*a, train=True), rnn_cuda.lstm_seq_fwd_plain, (xw, mask2, wh1)),
        (rnn_cuda.lstm_seq_bwd, rnn_cuda.lstm_seq_bwd_plain, (mask2, wh1, sys_, sc, sacts, torch.randn(sys_.shape))),
        (decoder_cuda.decoder_scan_fwd, decoder_cuda.decoder_scan_fwd_plain, scan),
        (decoder_cuda.decoder_scan_bwd, decoder_cuda.decoder_scan_bwd_plain, scan_bwd),
    ]


def _launches(wrapper):
    """The launch count behind a wrapper (the lstm_seq forward is wrapped to
    pass train=True)."""
    return (wrapper if hasattr(wrapper, "launches") else rnn_cuda.lstm_seq_fwd).launches


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


@pytest.mark.parametrize("idx", range(11))
def test_wrapper_routes_cpu_tensors_to_plain(idx):
    wrapper, plain, args = _wrapper_calls()[idx]
    before = _launches(wrapper)
    got, want = _flat(wrapper(*args)), _flat(plain(*args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert _launches(wrapper) == before


@pytest.mark.parametrize("idx", range(11))
def test_wrapper_raises_for_cuda_without_kernels(monkeypatch, tmp_path, idx):
    """A CUDA tensor goes to the kernel or raises: with no nvcc and no built
    library there is no fallback to the plain version."""
    wrapper, _, args = _wrapper_calls()[idx]
    monkeypatch.setattr(cuda_build, "use_plain", lambda x: False)  # as for a CUDA tensor
    monkeypatch.setattr(cuda_build, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "isfile", lambda p: False)
    before = _launches(wrapper)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wrapper(*args)
    assert _launches(wrapper) == before


def test_non_cuda_device_has_no_kernel():
    with pytest.raises(RuntimeError, match="no kernel for device"):
        cuda_build.use_plain(torch.empty(1, device="meta"))


@pytest.mark.parametrize("name", ["lstm_bidir_bwd", "ctc_loss", "decoder_scan", "decoder_scan_bwd",
                                  "lstm_bidir", "att_step"])
def test_library_name_follows_included_headers(monkeypatch, tmp_path, name):
    """A library's file name hashes its source and the csrc headers it
    includes: editing a header gives the sources that include it a new name
    (so no stale library is loaded), and leaves the others' names alone."""
    src = tmp_path / "csrc"
    src.mkdir()
    for f in os.listdir(cuda_build.CSRC_DIR):
        (src / f).write_bytes(open(os.path.join(cuda_build.CSRC_DIR, f), "rb").read())
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(src))
    assert '#include "tf32_mma.cuh"' in (src / f"{name}.cu").read_text()
    before = {n: cuda_build._lib_path(n) for n in cuda_build.SOURCES}
    header = src / "tf32_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: cuda_build._lib_path(n) for n in cuda_build.SOURCES}
    assert after[name] != before[name]
    assert after["log_mel"] == before["log_mel"]


def test_shared_gemm_header_renames_both_lstm_libraries(monkeypatch, tmp_path):
    """Both LSTM sources include the shared GEMM header (csrc/gemm_tf32.cuh):
    editing it renames both libraries and no other."""
    src = tmp_path / "csrc"
    src.mkdir()
    for f in os.listdir(cuda_build.CSRC_DIR):
        (src / f).write_bytes(open(os.path.join(cuda_build.CSRC_DIR, f), "rb").read())
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(src))
    before = {n: cuda_build._lib_path(n) for n in cuda_build.SOURCES}
    header = src / "gemm_tf32.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: cuda_build._lib_path(n) for n in cuda_build.SOURCES}
    assert {n for n in cuda_build.SOURCES if after[n] != before[n]} == {"lstm_bidir", "lstm_bidir_bwd"}
