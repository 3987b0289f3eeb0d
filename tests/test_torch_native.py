"""The port's native host library (``e2e_asr_tpu_torch/native.py``, its own
copies ``e2e_asr_tpu_torch/csrc/native.cpp`` and ``flac.cpp``) against the
JAX package's (``e2e_asr_tpu.native``) and against the plain versions.

- ``read_flac`` / ``flac_num_samples`` are JAX's bit for bit on streams of
  every subframe kind, Rice2 and escape codes, the stereo modes and several
  frames (``tests/flac_tools.py``, parametrised as ``tests/test_flac.py``).
- A LibriSpeech-layout ``.flac`` tree gives the JAX loader's batches, and
  trains and decodes through the port's CLI.
- A wav corpus's batches filled by one native ``pack_batch`` are bitwise
  the port's cache-route batches and JAX's, for one process and for each
  row block of two.
- The native Levenshtein equals ``edit_distance_plain``; ``cal_er`` equals
  JAX's counts.
- A truncated wav or FLAC raises on every route; a changed source gets a
  library of its own; ``cuda_build`` hands no ``.cpp`` to ``nvcc``.
"""

import os
import shutil
import subprocess
import wave

import numpy as np
import pytest
import torch
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from e2e_asr_tpu_torch import cuda_build, metrics, native
from e2e_asr_tpu_torch.config import Config as TConfig
from e2e_asr_tpu_torch.data import corpus
from e2e_asr_tpu_torch.data.dataset import load_dataset as tload
from tests.flac_tools import write_flac
from tests.torch_parity import small_config

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pcm(n, seed=0, amp=8000, smooth=True):
    """int PCM samples, correlated so that the predictors predict (as
    ``tests/test_flac.py``)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n)
    if smooth:
        for i in range(1, n):
            x[i] = 0.95 * x[i - 1] + 0.3 * x[i]
    return [int(v) for v in (x / np.abs(x).max() * amp).astype(np.int64)]


def write_wav(path, data, width=2):
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(width)
        f.setframerate(16000)
        scale = 32767 if width == 2 else 2147483647
        f.writeframes((np.clip(data, -1, 1) * scale).astype(f"<i{width}").tobytes())


# ------------------------------------------------------------------- FLAC
FLAC_STREAMS = {  # name: (channels of n samples, write_flac keywords)
    "constant": (lambda: [[1234] * 600], dict(block_size=256, kind="constant")),
    "verbatim": (lambda: [pcm(600, 1)], dict(block_size=256, kind="verbatim")),
    **{f"fixed{o}": (lambda: [pcm(600, 1)], dict(block_size=256, kind="fixed", order=o)) for o in range(5)},
    "lpc": (lambda: [pcm(600, 1)], dict(block_size=256, kind="lpc", lpc_coefs=[900, -200, 60], lpc_shift=10,
                                        lpc_precision=12)),
    "rice2": (lambda: [pcm(1024, 2)], dict(block_size=512, kind="fixed", order=2, porder=2, param=7, method=1)),
    "escape": (lambda: [pcm(512, 3)], dict(block_size=512, kind="fixed", order=1, escape_bits=18)),
    **{m: (lambda: [pcm(512, 4), pcm(512, 5)], dict(block_size=256, kind="fixed", order=2, stereo_mode=m))
       for m in ("independent", "left_side", "right_side", "mid_side")},
    "multiframe": (lambda: [pcm(3000, 6)], dict(block_size=1024, kind="fixed", order=3)),
}


@pytest.mark.parametrize("name", sorted(FLAC_STREAMS))
def test_read_flac_is_the_jax_decoders_bitwise(tmp_path, name):
    from e2e_asr_tpu.native import audio_io as jio

    make, kw = FLAC_STREAMS[name]
    channels = make()
    path = str(tmp_path / "t.flac")
    write_flac(path, channels, **kw)
    got, want = native.read_flac(path), jio.read_flac(path)
    assert native.flac_num_samples(path) == jio.flac_num_samples(path) == len(channels[0])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(channels[0], np.float32) / 32768.0)  # channel 0


def _flac_tree(root, splits, fixed=True):
    """A LibriSpeech-layout tree of FLAC files: {split: utterances} of
    synthetic waves, a speaker and chapter a split; VERBATIM subframes, and
    with ``fixed`` every other file FIXED order 2 (cut short: the Python
    encoder's FIXED mode is slow)."""
    for s, (split, spec) in enumerate(splits.items()):
        d = root / split / str(9 + s) / "9"
        d.mkdir(parents=True)
        lines = []
        for i, u in enumerate(corpus.load_corpus("synthetic", None, [spec])):
            x = np.clip(u.load() * 32768, -32768, 32767).astype(np.int16)
            uid = f"{9 + s}-9-{i:04d}"
            kind = dict(kind="fixed", order=2) if fixed and i % 2 == 0 else dict(kind="verbatim")
            if kind["kind"] == "fixed":
                x = x[:4000]
            write_flac(str(d / f"{uid}.flac"), [x.astype(np.int64).tolist()], block_size=4096, **kind)
            lines.append(f"{uid} {u.text}")
        (d / f"{9 + s}-9.trans.txt").write_text("\n".join(lines) + "\n")


def _libri_data(path, **corpus_kw):
    c = {"name": "librispeech", "path": str(path), "train_split": ["train-clean-100"],
         "dev_split": ["dev-clean"], "batch_size": 4, "buckets": [416, 816], "token_buckets": [48, 64]}
    c.update(corpus_kw)
    return {"corpus": c, "audio": {"feat_dim": 40}, "text": {"mode": "character"}}


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.uids == w.uids
        for k in ("wav", "wav_len", "text", "text_len"):
            a, b = getattr(g, k), getattr(w, k)
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_flac_corpus_gives_the_jax_loaders_batches(tmp_path):
    from e2e_asr_tpu.config import Config as JConfig
    from e2e_asr_tpu.data.dataset import load_dataset as jload

    _flac_tree(tmp_path, {"train-clean-100": "train:6", "dev-clean": "dev:3"})
    d = _libri_data(tmp_path)
    ttr, tdv = tload(TConfig.from_dict({"data": d}).data, num_workers=0)[:2]
    jtr, jdv = jload(JConfig.from_dict({"data": d}).data, num_workers=0)[:2]
    assert ttr.num_utts == 6 and tdv.num_utts == 3
    for t, j in ((ttr, jtr), (tdv, jdv)):
        _assert_same_batches(list(t.epoch(0)), list(j.epoch(0)))
    assert all(np.abs(b.wav[b.wav_len > 0]).max() > 0 for b in ttr.epoch(1))


def test_flac_corpus_trains_and_decodes_through_the_cli(tmp_path):
    """``main --cpu`` trains 2 steps on a LibriSpeech-layout FLAC tree and
    ``--test`` decodes its dev and test splits from the checkpoint."""
    from e2e_asr_tpu_torch.main import main as cli_main

    _flac_tree(tmp_path / "libri", {"train-clean-100": "train:8", "dev-clean": "dev:4", "test-clean": "test:4"},
               fixed=False)
    d = small_config()
    d["data"] = _libri_data(tmp_path / "libri", buckets=[416], token_buckets=[48], test_split=["test-clean"],
                            half_batch_len=1000)
    d["hparas"] = {"valid_step": 2, "max_step": 2, "log_step": 1, "optimizer": "Adadelta", "lr": 1.0,
                   "eps": 1e-8, "grad_clip": 5.0, "curriculum": 0, "dtype": "float32"}
    train_yaml = tmp_path / "train.yaml"
    train_yaml.write_text(yaml.safe_dump(d))
    cli_main(["--config", str(train_yaml), "--cpu", "--name", "flac", "--logdir", str(tmp_path / "log"),
              "--ckpdir", str(tmp_path / "ckpt"), "--no-msg"])
    ck = tmp_path / "ckpt" / "flac" / "latest"
    assert torch.load(ck, weights_only=True)["step"] == 2
    with open(os.path.join(ROOT, "configs", "synthetic_decode.yaml")) as f:
        dec = yaml.safe_load(f)
    dec["data"]["corpus"] = dict(d["data"]["corpus"])
    dec["src"] = {"ckpt": "", "config": str(train_yaml)}
    dec["decode"].update(beam_size=2, batch_size=2, max_len_ratio=0.3)
    decode_yaml = tmp_path / "decode.yaml"
    decode_yaml.write_text(yaml.safe_dump(dec))
    ers = cli_main(["--config", str(decode_yaml), "--test", "--cpu", "--load", str(ck), "--name", "flac",
                    "--outdir", str(tmp_path / "res"), "--no-msg"])
    assert set(ers) == {"dev", "test"} and all(np.isfinite(v) for v in ers.values())
    assert {"output_dev.csv", "output_test.csv"} <= set(os.listdir(tmp_path / "res" / "flac"))


# ----------------------------------------------------- wav: pack_batch route
def _wav_tree(root, n_train=10, width=2):
    rng = np.random.RandomState(4)
    for split, n, spk in (("train-clean-100", n_train, "1"), ("dev-clean", 3, "2")):
        d = root / split / spk / "3"
        d.mkdir(parents=True)
        lines = []
        for i in range(n):
            uid = f"{spk}-3-{i:04d}"
            write_wav(d / f"{uid}.wav", (rng.randn(20000 + 9000 * i) * 0.2).astype(np.float32), width)
            lines.append(f"{uid} HELLO WORLD {'AB' * i}")
        (d / f"{spk}-3.trans.txt").write_text("\n".join(lines) + "\n")


def _count_packs(monkeypatch):
    calls = []
    real = native.pack_batch
    monkeypatch.setattr(native, "pack_batch", lambda paths, n, *a: calls.append(len(paths)) or real(paths, n, *a))
    return calls


def _cache_route(loader):
    for it in loader._items:
        it[0].wav_path = None  # a row without a wav path takes the int16 wave cache
    return loader


@pytest.mark.parametrize("wire,width", [("int16", 2), ("float32", 2), ("int16", 4), ("float32", 4)])
@pytest.mark.parametrize("index,count", [(0, 1), (0, 2), (1, 2)])
def test_pack_batch_route_is_the_cache_routes_and_jaxs_bitwise(tmp_path, monkeypatch, wire, width, index, count):
    from e2e_asr_tpu.config import Config as JConfig
    from e2e_asr_tpu.data.dataset import load_dataset as jload

    _wav_tree(tmp_path, width=width)
    d = _libri_data(tmp_path, wire_dtype=wire, buckets=[208, 416, 816], token_buckets=[32, 48, 64])
    kw = dict(num_workers=0, process_index=index, process_count=count)
    calls = _count_packs(monkeypatch)
    packed = [list(x.epoch(0)) for x in tload(TConfig.from_dict({"data": d}).data, **kw)[:2]]
    assert calls and sum(calls) == sum(int((b.wav_len > 0).sum()) for bs in packed for b in bs)
    n_calls = len(calls)
    cached = [list(_cache_route(x).epoch(0)) for x in tload(TConfig.from_dict({"data": d}).data, **kw)[:2]]
    assert len(calls) == n_calls  # the cache route made no native call
    jax_ = [list(x.epoch(0)) for x in jload(JConfig.from_dict({"data": d}).data, **kw)[:2]]
    for p, c in zip(packed, cached):
        _assert_same_batches(p, c)
    if wire == "int16" or width == 2:  # JAX's native route skips the int16 pass on the float32 wire
        for p, j in zip(packed, jax_):
            _assert_same_batches(p, j)


def test_read_wav_and_pack_batch_equal_the_jax_natives(tmp_path):
    from e2e_asr_tpu.native import audio_io as jio

    rng = np.random.RandomState(7)
    paths = []
    for i, n in enumerate((100, 5000, 0, 777)):
        p = tmp_path / f"{i}.wav"
        write_wav(p, (rng.randn(n) * 0.3).astype(np.float32))
        paths.append(str(p))
        np.testing.assert_array_equal(native.read_wav(str(p)), jio.read_wav(str(p)))
        np.testing.assert_array_equal(native.read_wav(str(p)), corpus._load_wav(str(p)))
        assert native.wav_num_samples(str(p)) == jio.wav_num_samples(str(p)) == n
    for stride in (50, 4096):
        got, want = native.pack_batch(paths, stride), jio.pack_batch(paths, stride)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------- failures
def _truncate(path, keep):
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[: keep if keep >= 0 else len(data) + keep])


@pytest.mark.parametrize("cut", [-1, -100, 60])
def test_a_truncated_wav_raises_on_every_route(tmp_path, cut):
    _wav_tree(tmp_path, n_train=4)
    path = tmp_path / "train-clean-100" / "1" / "3" / "1-3-0001.wav"
    _truncate(path, cut)
    with pytest.raises(IOError):
        native.read_wav(str(path))
    with pytest.raises(IOError):
        native.pack_batch([str(path).replace("0001", "0000"), str(path)], 50000)
    with pytest.raises(IOError):
        corpus._load_wav(str(path))
    loader = tload(TConfig.from_dict({"data": _libri_data(tmp_path, batch_size=8)}).data, num_workers=0)[0]
    with pytest.raises(IOError):
        list(loader.epoch(0))
    with pytest.raises(IOError):
        list(_cache_route(loader).epoch(0))


@pytest.mark.parametrize("cut", [-1, -700, 40])
def test_a_truncated_flac_raises(tmp_path, cut):
    path = str(tmp_path / "t.flac")
    write_flac(path, [pcm(3000, 6)], block_size=1024, kind="fixed", order=3)
    _truncate(path, cut)
    with pytest.raises(IOError):
        native.read_flac(path)


def test_a_non_pcm_or_8_bit_wav_raises(tmp_path):
    p = tmp_path / "u8.wav"
    with wave.open(str(p), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(1)
        f.setframerate(16000)
        f.writeframes(bytes(range(200)))
    with pytest.raises(IOError):
        native.read_wav(str(p))
    with pytest.raises(IOError):
        native.pack_batch([str(p)], 300)


# ------------------------------------------------------------ edit distance
SEQ = st.lists(st.integers(0, 4), max_size=25)


@settings(max_examples=300, deadline=None)
@given(SEQ, SEQ)
def test_native_levenshtein_is_the_plain_loop(a, b):
    want = metrics.edit_distance_plain(a, b)
    assert native.levenshtein(a, b) == metrics.edit_distance(a, b) == want
    assert native.levenshtein([str(x) for x in a], [str(x) for x in b]) == want  # any hashables


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(SEQ, SEQ), max_size=12))
def test_levenshtein_batch_is_the_per_pair_distance(pairs):
    got = native.levenshtein_batch(pairs)
    assert got.dtype == np.int64 and got.shape == (len(pairs),)
    assert got.tolist() == [metrics.edit_distance_plain(a, b) for a, b in pairs]


@pytest.mark.parametrize("mode", ["wer", "cer"])
@pytest.mark.parametrize("ctc", [False, True])
def test_cal_er_counts_equal_the_jax_cal_er(mode, ctc):
    from e2e_asr_tpu.data.text import CharacterTextEncoder as JChar
    from e2e_asr_tpu.utils.metrics import cal_er as jcal_er

    from e2e_asr_tpu_torch.data.text import CharacterTextEncoder as TChar

    vocab = ["<sos>", "<eos>", "<unk>", " ", "A", "B", "C", "D"]
    rng = np.random.RandomState(3 + ctc)
    pred = rng.randint(0, len(vocab), size=(16, 30))
    truth = rng.randint(3, len(vocab), size=(16, 20))
    truth[:, 12:] = 0
    truth[2] = 0  # an empty reference: skipped
    truth[5, 4] = 1  # an eos ends the reference
    pred_len = rng.randint(0, 31, size=16) if ctc else None
    got = metrics.cal_er(TChar(vocab), pred, truth, mode=mode, ctc=ctc, pred_len=pred_len)
    want = jcal_er(JChar(vocab), pred, truth, mode=mode, ctc=ctc, pred_len=pred_len, counts=True)
    assert got == tuple(int(x) for x in want) and got[1] > 0


# ------------------------------------------------------------------- build
def test_a_changed_source_gets_a_library_of_its_own(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(native, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    first = native.lib_path()
    assert first == native.lib_path() and os.path.basename(first).startswith("native-")
    with open(csrc / "flac.cpp", "a") as f:
        f.write("\n// edited\n")
    second = native.lib_path()
    assert second != first
    assert native.build() == second and os.path.isfile(second) and not os.path.exists(first)
    lib = __import__("ctypes").CDLL(second)
    assert lib.levenshtein is not None
    with open(csrc / "flac.cpp", "rb") as f:
        text = f.read()
    with open(csrc / "flac.cpp", "wb") as f:
        f.write(text.replace(b"\n// edited\n", b""))
    assert native.lib_path() == first


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "native.cpp").write_text("this is not C++\n")
    (csrc / "flac.cpp").write_text("\n")
    monkeypatch.setattr(native, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="native library build failed"):
        native.build()
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path / "build"))


def test_cuda_build_hands_no_cpp_to_nvcc(tmp_path, monkeypatch):
    """``build_all`` compiles the ``.cu`` sources it names, one ``nvcc``
    each, and never the host library's ``.cpp`` sources beside them."""
    cmds = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **_):
            cmds.append(cmd)
            open(cmd[cmd.index("-o") + 1], "wb").close()

        def communicate(self):
            return b"", None

    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(subprocess, "Popen", FakeProc)
    cuda_build.build_all()
    srcs = sorted(c[-1] for c in cmds)
    assert len(cmds) == len(cuda_build.SOURCES)
    assert srcs == sorted(os.path.join(cuda_build.CSRC_DIR, f"{n}.cu") for n in cuda_build.SOURCES)
    assert not any(a.endswith(".cpp") for c in cmds for a in c)
    assert {f for f in os.listdir(cuda_build.CSRC_DIR) if f.endswith(".cpp")} == set(native.SOURCES)


def test_chip_smokes_flac_writer_is_the_test_encoders_verbatim_stream(tmp_path):
    """``chip_smoke.flac_verbatim`` (the smoke's fast writer of a FLAC
    corpus) writes the bytes of ``tests/flac_tools.write_flac(kind=
    "verbatim")``, and the port reads them back as the int16 samples."""
    from chip_smoke import flac_verbatim

    rng = np.random.RandomState(11)
    waves = [rng.randint(-32768, 32768, size=n).astype(np.int16) for n in (1, 4096, 5000, 3 * 4096 + 17)]
    for x, data in zip(waves, flac_verbatim(waves)):
        path = str(tmp_path / "t.flac")
        write_flac(path, [x.astype(np.int64).tolist()], block_size=4096, kind="verbatim")
        assert data == open(path, "rb").read()
        np.testing.assert_array_equal(native.read_flac(path), x.astype(np.float32) / 32768.0)


def test_chip_smokes_file_corpus_gives_the_synthetic_corpus_batches(tmp_path):
    """``chip_smoke.write_file_corpus``: the loader phase's wav and FLAC
    trees give the batches of the synthetic corpus they were written from
    (the wav tree by one native ``pack_batch`` a batch), bitwise."""
    from chip_smoke import write_file_corpus

    d = {"corpus": {"name": "synthetic_char", "train_split": ["train:12"], "dev_split": ["dev:4"],
                    "batch_size": 4, "buckets": [208, 416, 816], "token_buckets": [64, 96, 128],
                    "device_cache": "off"}, "audio": {"feat_dim": 40}, "text": {"mode": "character"}}
    utts = {"train": corpus.load_corpus("synthetic_char", "", ["train:12"]),
            "dev": corpus.load_corpus("synthetic_char", "", ["dev:4"])}
    trees = write_file_corpus(str(tmp_path), utts)
    want = list(tload(TConfig.from_dict({"data": d}).data, num_workers=0)[0].epoch(0))
    for kind in ("wav", "flac"):
        d2 = {**d, "corpus": {**d["corpus"], "name": "librispeech", "path": trees[kind], "train_split": ["train"],
                              "dev_split": ["dev"]}}
        got = list(tload(TConfig.from_dict({"data": d2}).data, num_workers=0)[0].epoch(0))
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            for k in ("wav", "wav_len", "text", "text_len"):
                np.testing.assert_array_equal(getattr(g, k), getattr(w, k), err_msg=f"{kind} {k}")
