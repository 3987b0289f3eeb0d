"""The default architecture and the character vocabulary give, for seeds 1-3
and both configurations, what the harness gave before a configuration could
name its own (``golden.json``, recorded then): the leaves, the drawn weights,
the program's parameter trees, the traffic's transcripts, waves, token ids
and first batch, the model FLOPs of a fixed batch, the readers' values on a
fixed run, and the reference's numbers on two short utterances. Everything
is compared exactly, on one CPU thread."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from asr_bench import cells, shapes, spec, traffic, vocab, weights, work
from asr_bench.cells import Run
from asr_bench.reference import decode as ref_decode
from asr_bench.reference import model as M
from asr_bench.reference import search as ref_search
from asr_bench.reference import train as ref_train
from asr_bench.tests import tiny

SEEDS = (1, 2, 3)
CONFIGS = ("flagship", "asr960h")
with open(os.path.join(os.path.dirname(__file__), "golden.json")) as f:
    GOLDEN = json.load(f)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sha(arrays):
    h = hashlib.sha256()
    for a in arrays:
        a = a.detach().cpu().contiguous().numpy() if isinstance(a, torch.Tensor) else np.ascontiguousarray(a)
        h.update(str(a.dtype).encode() + str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def flat_tree(t, path=""):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in flat_tree(t[k], f"{path}/{k}")]
    if isinstance(t, list):
        return [x for i, v in enumerate(t) for x in flat_tree(v, f"{path}/{i}")]
    return [[path, t]]


def fixed_batch(b, n, l, wav_len, text_len):
    uids = tuple(f"u{i}" if w else "" for i, w in enumerate(wav_len))
    return {"b": b, "n": n, "l": l, "wav_len": wav_len, "text_len": text_len, "uids": uids,
            "audio_s": sum(wav_len) / 16000}


BATCH = fixed_batch(4, 489200, 520, [489200, 300000, 120000, 0], [520, 300, 130, 0])


def fake_run(kind, recipe):
    run = Run(kind, recipe, wall_s=2.0, wait_s=0.1)
    run.batches = [BATCH, fixed_batch(2, 130800, 240, [130800, 100000], [200, 150])]
    run.slice_batches = list(run.batches)
    kern = {}
    for i, op in enumerate(("decoder_scan", "lstm_seq", "att_step", "ctc_prefix")):
        for j, name in enumerate(spec.kernel_names(op)):
            kern[f"void {name}<float>(Args)"] = 0.01 * (i + 1) + 0.001 * j
    run.trace = {"busy_s": 0.75, "window_s": 1.0, "kernels": kern}
    return run


def setup(cname):
    conf = spec.config(spec.benchmark(), cname)
    assert "architecture" not in conf and "vocabulary" not in conf
    return conf, spec.architecture(conf), vocab.of(conf)


@pytest.mark.parametrize("cname", CONFIGS)
def test_leaves_trees_and_drawn_weights_are_the_parents(cname):
    conf, arch, voc = setup(cname)
    g, r = GOLDEN[cname], conf["recipe"]
    assert arch is M and voc.size == g["vocab"]
    fd = r["data"]["audio"]["feat_dim"]
    leaves = arch.leaves(r["model"], fd, voc.size)
    lm = weights.lm_names(r["lm"], voc.size)
    assert [[n, list(s), law, sc] for n, s, law, sc in leaves] == g["leaves"]
    assert [[n, list(s), law, sc] for n, s, law, sc in lm] == g["lm_leaves"]
    names = {n: n for n, *_ in leaves + lm}
    assert flat_tree(arch.port_tree(names, r["model"])) == g["port_tree"]
    assert flat_tree(weights.port_lm_tree(names, r["lm"]["n_layers"])) == g["lm_tree"]
    for s in SEEDS:
        assert sha(weights.draw(leaves, s, "cpu").values()) == g["weights"][str(s)]["asr"]
        assert sha(weights.draw(leaves + lm, s, "cpu").values()) == g["weights"][str(s)]["asr_lm"]


@pytest.mark.parametrize("cname", CONFIGS)
def test_the_traffic_and_its_first_batch_are_the_parents(cname):
    from e2e_asr_tpu_torch.config import Config

    conf, _, voc = setup(cname)
    bench, r = spec.benchmark(), conf["recipe"]
    cells_of = [w for w in bench["workloads"] if w["config"] == cname]
    assert sorted(w["traffic"] for w in cells_of) == sorted(GOLDEN[cname]["traffic"])
    for w in cells_of:
        mix = spec.load_mix(w["traffic"])
        cfg = Config.from_dict(dict(r, decode=dict(r["decode"], **mix.get("decode", {}))))
        bs = cfg.data.corpus.batch_size if mix["kind"] == "train" else cfg.decode.batch_size
        for s in SEEDS:
            want = GOLDEN[cname]["traffic"][w["traffic"]][str(s)]
            utts = traffic.make(mix, s, cfg.data.audio.sample_rate, voc)
            by_uid = {u.uid: u for u in utts}
            loader = cells._loader(cfg, utts, voc, bs, mix["kind"] == "train", s, 0)
            first = cells._one(loader, 0)
            got = {
                "utts": hashlib.sha256(json.dumps([[u.uid, u.text, u.n_samples] for u in utts]).encode()).hexdigest(),
                "waves8": sha([u.load() for u in utts[:8]]),
                "ids": hashlib.sha256(json.dumps([voc.ids(u.text) for u in utts]).encode()).hexdigest(),
                "first_uids": list(first.uids), "first_text": sha([first.text]),
                "first_ref_ids": sha([np.asarray(voc.ids(by_uid[u].text), np.int64) for u in first.uids if u]),
                "starts": {str(k): list(v) for k, v in cells.bucket_starts(loader, cfg, bs).items()}}
            assert got == want, (w["traffic"], s)


@pytest.mark.parametrize("cname", CONFIGS)
def test_flops_and_readers_on_a_fixed_batch_are_the_parents(cname):
    conf, arch, voc = setup(cname)
    g, r = GOLDEN[cname], conf["recipe"]
    fd, v = r["data"]["audio"]["feat_dim"], voc.size
    fl = shapes.feat_lens(r, BATCH)
    flops = {"train": work.train_step_flops(arch, r["model"], fd, v, fl, BATCH["text_len"])}
    metrics = {}
    for mname in ("decode.lm", "decode.nolm"):
        mix = spec.load_mix(mname)
        rr = dict(r, decode=dict(r["decode"], **mix.get("decode", {})))
        d = rr["decode"]
        real = [i for i, u in enumerate(BATCH["uids"]) if u]
        flops[mname] = work.decode_flops(arch, rr["model"], rr["lm"], fd, v, d["beam_size"], shapes.k_cand(rr, v),
                                         d["lm_weight"] > 0, d["ctc_weight"] > 0, [fl[i] for i in real],
                                         shapes.active_steps(rr, BATCH))
        flops["k_cand." + mname] = shapes.k_cand(rr, v)
        ctx = {"run": fake_run("decode", rr), "recipe": rr, "arch": arch, "vocab": v, "mix": mix,
               "kernel_names": spec.kernel_names}
        for m in ("decode_mfu", "att_step_roofline.decode", "ctc_prefix_roofline.decode"):
            metrics[f"{m}@{mname}"] = spec.metric_reader(m)(ctx)
    ctx = {"run": fake_run("train", r), "recipe": r, "arch": arch, "vocab": v, "mix": {},
           "kernel_names": spec.kernel_names}
    for m in ("train_mfu", "decoder_scan_roofline.train", "lstm_seq_roofline.train"):
        metrics[m] = spec.metric_reader(m)(ctx)
    assert flops == g["flops"]
    assert metrics == g["metrics"]


def reference(conf, seed):
    """The reference's numbers on two short utterances of the tiny mix at
    the configuration's widths: one Adadelta step, a search and a rescoring."""
    recipe, arch, voc = conf["recipe"], spec.architecture(conf), vocab.of(conf)
    fd = recipe["data"]["audio"]["feat_dim"]
    w0 = weights.draw(arch.leaves(recipe["model"], fd, voc.size) + weights.lm_names(recipe["lm"], voc.size), seed,
                      "cpu")
    utts = traffic.make(tiny.mix("train"), seed, 16000)[:2]
    n = max(u.n_samples for u in utts)
    wav = torch.from_numpy(traffic.waves_i16({u.uid: u for u in utts}, [u.uid for u in utts], n))
    ids = [voc.ids(u.text) for u in utts]
    text = torch.zeros((2, max(len(x) for x in ids)), dtype=torch.long)
    for i, x in enumerate(ids):
        text[i, :len(x)] = torch.tensor(x)
    wav_len = torch.tensor([u.n_samples for u in utts])
    bt = ref_train.RefBatch(wav, wav_len, text, torch.tensor([len(x) for x in ids]), 12345, 0.7)
    tr = ref_train.adadelta_steps(arch, w0, recipe, [bt], M.Precision("fp32"))
    dcfg = dict(recipe["decode"], beam_size=4)
    found = ref_search.search(arch, w0, recipe, wav, wav_len, dcfg, 12, M.Precision("fp32"))
    res = ref_decode.rescore(arch, w0, recipe, wav, wav_len, found["tokens"], found["lengths"], dcfg,
                             M.Precision("fp32"))
    return {"loss": tr["loss"], "grad_norm": tr["grad_norm"], "change": tr["change"],
            "search": {"tokens": found["tokens"].tolist(), "lengths": found["lengths"].tolist(),
                       "scores": found["scores"].tolist()},
            "rescore": res["score"].tolist()}


@pytest.mark.parametrize("cname", CONFIGS + ("tiny",))
def test_the_references_numbers_are_the_parents(cname):
    if cname == "tiny":
        conf, seed, want = tiny.config(), 2, GOLDEN["tiny"]
    else:
        conf, seed, want = setup(cname)[0], 1, GOLDEN[cname]["reference"]
    assert reference(conf, seed) == want
