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
from e2e_asr_tpu_torch.config import Config as TConfig
from e2e_asr_tpu_torch.data import corpus
from e2e_asr_tpu_torch.data.dataset import build_tokenizer
from e2e_asr_tpu_torch.decode import ctc_prefix, ctc_prefix_cuda
from e2e_asr_tpu_torch.device import resolve_device
from e2e_asr_tpu_torch.main import main as cli_main
from e2e_asr_tpu_torch.models import lm as lm_mod
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


def _decode_setup(tmp_path, n_eval=4):
    """(decode yaml, ASR checkpoint, vocabulary size):
    configs/synthetic_decode.yaml with its splits shrunk (``n_eval``
    utterances each for dev and test) and src pointed at a small training
    config, and a checkpoint that convert.py wrote from JAX weights
    (tokenizer of train:16)."""
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
    d["data"]["corpus"].update(train_split=["train:16"], dev_split=[f"dev:{n_eval}"],
                               test_split=[f"test:{n_eval}"], buckets=[416], token_buckets=[48])
    d["src"] = {"ckpt": "", "config": str(train_yaml)}
    d["decode"].update(beam_size=2, batch_size=2, max_len_ratio=0.3)
    decode_yaml = tmp_path / "decode.yaml"
    decode_yaml.write_text(yaml.safe_dump(d))
    tok = build_tokenizer(JConfig.from_dict(train_d).data, corpus.load_corpus("synthetic", "", ["train:16"]))
    jp, _ = jasr.asr_init(jax.random.PRNGKey(0), 40, tok.vocab_size, JConfig.from_dict(train_d).model)
    ckpt = str(tmp_path / "asr.pt")
    convert.save_checkpoint(ckpt, convert.params_from_jax(jax.device_get(jp)), tok.vocab_size, 40)
    return decode_yaml, ckpt, tok.vocab_size


def test_decode_cli_on_cpu(tmp_path):
    """main --test --cpu on the shipped configs/synthetic_decode.yaml (splits
    shrunk, src pointed at a small training config) with a checkpoint that
    convert.py wrote from JAX weights: both CSVs for both splits."""
    decode_yaml, ckpt, _ = _decode_setup(tmp_path, n_eval=6)
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


def _train_latest(tmp_path, capsys, name, *args):
    """main --cpu on the tiny recipe for 2 steps (+ validation): the
    ``latest`` checkpoint and the input line the solver logged."""
    train_yaml = _tiny_train_yaml(tmp_path)
    capsys.readouterr()
    cli_main(["--config", str(train_yaml), "--cpu", "--name", name, "--logdir", str(tmp_path / "log"),
              "--ckpdir", str(tmp_path / "ckpt"), *args])
    inputs = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[INFO] Input:")]
    assert len(inputs) == 1, inputs
    return torch.load(tmp_path / "ckpt" / name / "latest", weights_only=True), inputs[0]


def _assert_same_checkpoint(a, b):
    from e2e_asr_tpu_torch.training.step import param_leaves

    assert a["step"] == b["step"] == 2
    for part in ("params", "opt_state"):
        la, lb = param_leaves(a[part]), param_leaves(b[part])
        assert len(la) == len(lb) > 0
        for x, y in zip(la, lb):
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), part


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_train_cli_logs_the_compute_dtype(tmp_path, capsys, dtype):
    """A recipe whose hparas.dtype is bfloat16 (every shipped training
    recipe) trains one step in float32, and the solver says so beside the
    recipe's dtype; a float32 recipe gets no such line."""
    train_yaml = _tiny_train_yaml(tmp_path, max_step=1)
    d = yaml.safe_load(train_yaml.read_text())
    d["hparas"]["dtype"] = dtype
    train_yaml.write_text(yaml.safe_dump(d))
    capsys.readouterr()
    cli_main(["--config", str(train_yaml), "--cpu", "--name", dtype, "--logdir", str(tmp_path / "log"),
              "--ckpdir", str(tmp_path / "ckpt")])
    lines = [line for line in capsys.readouterr().out.splitlines() if "Compute dtype" in line]
    assert torch.load(tmp_path / "ckpt" / dtype / "latest", weights_only=True)["step"] == 1
    if dtype == "float32":
        assert lines == []
    else:
        assert lines == ["[INFO] Compute dtype: float32, not the recipe's hparas.dtype bfloat16 (the port trains "
                         "in float32 until bf16 is ported: ROADMAP Queue 1 item 4)"]


def test_train_cli_njobs_gives_the_same_checkpoint(tmp_path, capsys):
    """--njobs 0 (batches filled on the training thread) and --njobs 2 (two
    loader threads) train to the same ``latest`` checkpoint, bitwise, each
    through the prefetcher and the input mode it logs."""
    serial, line0 = _train_latest(tmp_path, capsys, "nj0", "--njobs", "0", "-o", "data.corpus.device_cache=off")
    threaded, line2 = _train_latest(tmp_path, capsys, "nj2", "--njobs", "2", "-o", "data.corpus.device_cache=off")
    assert "streaming" in line0 and "0 loader threads" in line0
    assert "streaming" in line2 and "2 loader threads" in line2
    _assert_same_checkpoint(serial, threaded)


def test_train_cli_device_cache_gives_the_same_checkpoint(tmp_path, capsys):
    """-o data.corpus.device_cache=on (the corpus uploaded once, offsets a
    step), =off (streaming) and the default auto (on: the tiny corpus fits)
    train to the same ``latest`` checkpoint, bitwise; a limit below the
    corpus's bytes makes auto stream; a value outside auto/on/off raises."""
    on, line_on = _train_latest(tmp_path, capsys, "on", "-o", "data.corpus.device_cache=on")
    off, line_off = _train_latest(tmp_path, capsys, "off", "-o", "data.corpus.device_cache=off",
                                  "-o", "data.corpus.cache_bytes=0")
    auto, line_auto = _train_latest(tmp_path, capsys, "auto")
    small, line_small = _train_latest(tmp_path, capsys, "small", "-o", "data.corpus.device_cache_bytes=1000")
    assert "device-resident corpus" in line_on and "flat_corpus" in line_on and "MB int16" in line_on
    assert "streaming" in line_off and "device_cache off" in line_off
    assert "device-resident corpus" in line_auto
    assert "streaming" in line_small and "device_cache auto" in line_small
    for other in (off, auto, small):
        _assert_same_checkpoint(on, other)
    with pytest.raises(ValueError, match="device_cache"):
        _train_latest(tmp_path, capsys, "bad", "-o", "data.corpus.device_cache=always")


def test_decode_cli_through_the_prefetcher_writes_the_same_csvs(tmp_path):
    """main --test through the prefetcher (--njobs 0 and 2) writes the csvs
    that decoding each loader batch directly on the calling thread gives,
    and reports the time it waited on the input."""
    from e2e_asr_tpu_torch.bin.test_asr import Solver
    from e2e_asr_tpu_torch.config import Config
    from e2e_asr_tpu_torch.main import apply_overrides, build_parser

    decode_yaml, ckpt, _ = _decode_setup(tmp_path, n_eval=5)
    out = tmp_path / "res"
    for nj in ("0", "2"):
        cli_main(["--config", str(decode_yaml), "--test", "--cpu", "--load", ckpt, "--name", f"nj{nj}",
                  "--outdir", str(out), "--no-msg", "--njobs", nj])
    paras = build_parser().parse_args(["--config", str(decode_yaml), "--test", "--cpu", "--load", ckpt,
                                       "--name", "direct", "--outdir", str(out), "--njobs", "0"])
    paras.verbose = False
    solver = Solver(apply_overrides(Config.load(paras.config), []), paras, "test")
    solver.load_data()
    solver.set_model()
    for split, loader in solver.eval_sets.items():
        want = [["idx", "truth", "prediction"]]
        for batch in loader.epoch():
            res = solver.decode_batch(torch.from_numpy(batch.wav), torch.from_numpy(batch.wav_len))
            for i, uid in enumerate(batch.uids):
                if uid:
                    toks = res.tokens[i, 0, : res.lengths[i, 0]].numpy()
                    want.append([uid, solver.tokenizer.decode(batch.text[i]), solver.tokenizer.decode(toks)])
        assert len(want) == 1 + loader.num_utts > 2
        for nj in ("0", "2"):
            with open(out / f"nj{nj}" / f"output_{split}.csv") as f:
                assert list(csv.reader(f, delimiter="\t")) == want, (split, nj)
        with open(out / "nj0" / f"beam_{split}.csv") as a, open(out / "nj2" / f"beam_{split}.csv") as b:
            assert a.read() == b.read()
    solver.exec()
    for split, st in solver.stats.items():
        assert st["utts"] == solver.eval_sets[split].num_utts
        assert 0.0 <= st["input_s"] <= st["wall_s"] and st["decode_s"] > 0


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


def _tiny_lm_yaml(tmp_path):
    """configs/synthetic_lm.yaml's recipe at test size, on the decode
    setup's train split (so that the two tokenizers agree)."""
    with open(os.path.join(ROOT, "configs", "synthetic_lm.yaml")) as f:
        d = yaml.safe_load(f)
    d["data"]["corpus"].update(train_split=["train:16"], dev_split=["dev:4"])
    d["hparas"].update(max_step=4, valid_step=4, log_step=2)
    d["lm"].update(emb_dim=16, dim=24, n_layers=2, batch_size=4)
    path = tmp_path / "lm.yaml"
    path.write_text(yaml.safe_dump(d))
    return path


def test_lm_cli_on_cpu_then_fused_decode(tmp_path):
    """main --lm --cpu trains a tiny LM (best_ppl, latest, tokenizer.vocab
    and the lm_loss / lm_ppl / dev_ppl scalars); main --test --cpu with -o
    decode.lm_weight=0.3 -o decode.lm_path=<best_ppl> fuses it into the
    beam search and writes both splits' csvs."""
    decode_yaml, ckpt, _ = _decode_setup(tmp_path)
    lm_yaml = _tiny_lm_yaml(tmp_path)
    cli_main(["--config", str(lm_yaml), "--lm", "--cpu", "--name", "lm", "--logdir", str(tmp_path / "log"),
              "--ckpdir", str(tmp_path / "ckpt"), "--no-msg"])
    ck = tmp_path / "ckpt" / "lm"
    for f in ("best_ppl", "latest", "tokenizer.vocab"):
        assert (ck / f).is_file(), f
    assert (ck / "latest.meta").read_text().splitlines()[1] == "global_step 4"
    with open(tmp_path / "log" / "lm" / "scalars.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert {"lm_loss", "lm_ppl", "dev_ppl"} <= {r["tag"] for r in recs}
    assert all(np.isfinite(r["value"]) for r in recs)

    out = tmp_path / "res"
    ers = cli_main(["--config", str(decode_yaml), "--test", "--cpu", "--load", ckpt, "--name", "fused",
                    "--outdir", str(out), "--no-msg", "-o", "decode.lm_weight=0.3",
                    "-o", f"decode.lm_path={ck / 'best_ppl'}", "-o", f"decode.lm_config={lm_yaml}"])
    assert set(ers) == {"dev", "test"} and all(np.isfinite(v) for v in ers.values())
    for split in ("dev", "test"):
        with open(out / "fused" / f"output_{split}.csv") as f:
            rows = list(csv.reader(f, delimiter="\t"))
        assert rows[0] == ["idx", "truth", "prediction"] and len(rows) > 1
        assert (out / "fused" / f"beam_{split}.csv").is_file()


def test_fused_decode_checks_the_lm_checkpoint(tmp_path):
    """lm_weight > 0 without decode.lm_path, an LM whose vocabulary is not
    the recogniser's, and an ASR checkpoint given as the LM all raise."""
    decode_yaml, ckpt, vocab = _decode_setup(tmp_path)
    lm_cfg = TConfig.from_dict({"lm": {"emb_dim": 8, "dim": 16, "n_layers": 1}}).lm
    gen = torch.Generator()
    gen.manual_seed(0)
    bad_lm = str(tmp_path / "lm_vocab_plus_one.pt")
    convert.save_checkpoint(bad_lm, lm_mod.lm_init(gen, vocab + 1, lm_cfg, torch.device("cpu")), vocab + 1, 0,
                            kind="lm")
    argv = ["--config", str(decode_yaml), "--test", "--cpu", "--load", ckpt, "--name", "x",
            "--outdir", str(tmp_path / "res"), "--no-msg", "-o", "decode.lm_weight=0.3"]
    with pytest.raises(ValueError, match="lm_path"):
        cli_main(argv)
    with pytest.raises(ValueError, match="vocabulary size"):
        cli_main(argv + ["-o", f"decode.lm_path={bad_lm}"])
    with pytest.raises(ValueError, match="kind 'asr'"):
        cli_main(argv + ["-o", f"decode.lm_path={ckpt}"])


def test_cli_later_slices_raise(tmp_path):
    """--lm --test raises (LM evaluation is part of --lm training, as in the
    JAX package); training needs CUDA unless --cpu is given."""
    cfg = str(os.path.join(ROOT, "configs", "synthetic_lm.yaml"))
    with pytest.raises(ValueError, match="--lm --test"):
        cli_main(["--config", cfg, "--lm", "--test", "--cpu"])
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
