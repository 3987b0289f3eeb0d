"""The two kinds of cell: training through the program's train-step graphs,
and beam-search decoding through its beam graphs, each fed by the program's
bucketed loader and ``DevicePrefetcher``.

``run_train`` / ``run_decode`` take the configuration's recipe, the traffic
mix, the seed, the window's seconds, whether to profile a slice after the
window, and the device (``cuda``; the tests pass ``cpu``, where the program
runs its plain versions eagerly). Each returns a ``Run``: the window's
counts, the slice's trace, the device's peak memory, and the compared
numbers from the plain reference (``asr_bench/reference``), which runs after
the window, once the program's state is freed.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from asr_bench import shapes, traffic, weights
from asr_bench.shapes import RESERVED, VOCAB
from asr_bench.trace import profiled, sampled, span

CHECK_BATCHES = 3  # a decode run's batches checked: the longest and two drawn from the seed
PREFIX_STEPS = 24  # the steps of the reference's search that a decode run's hypotheses are held to

@dataclass
class Run:
    kind: str
    recipe: dict
    setup_s: float = 0.0
    wall_s: float = 0.0
    wait_s: float = 0.0
    audio_s: float = 0.0
    batches: List[dict] = field(default_factory=list)  # the window's batch shapes
    latencies_s: List[float] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    trace: Optional[dict] = None
    slice_batches: List[dict] = field(default_factory=list)
    memory_peak: int = 0
    numbers: Dict[str, float] = field(default_factory=dict)
    problems: List[str] = field(default_factory=list)
    checked: Dict[str, int] = field(default_factory=dict)
    control: Dict[str, Dict[str, float]] = field(default_factory=dict)  # the controls' numbers (control.py)
    detail: Dict[str, object] = field(default_factory=dict)  # control.py's look behind the numbers


def note(t_start: float, what: str) -> None:
    """A line on standard error: seconds since the run began, and what."""
    print(f"asr_bench: {time.time() - t_start:7.2f} s {what}", file=sys.stderr, flush=True)


def step_seed(seed: int, step: int) -> int:
    return (seed * 1_000_003 + step) % (1 << 63)


def text_ids(text: str) -> List[int]:
    """The benchmark's own tokenisation: <eos>-terminated character ids."""
    return [len(RESERVED) + traffic.ALPHABET.index(ch) for ch in text] + [1]


def _loader(cfg, utts, batch_size, shuffle, seed, threads):
    from e2e_asr_tpu_torch.data import text as text_mod
    from e2e_asr_tpu_torch.data.dataset import BucketedLoader

    c, a = cfg.data.corpus, cfg.data.audio
    win, shift = int(a.sample_rate * a.frame_length / 1000), int(a.sample_rate * a.frame_shift / 1000)
    tok = text_mod.CharacterTextEncoder(RESERVED + traffic.ALPHABET)
    return BucketedLoader(utts, tok, batch_size, c.buckets, c.token_buckets, win, shift,
                          half_batch_len=c.half_batch_len, wire_dtype=c.wire_dtype, shuffle=shuffle,
                          ascending=False, seed=seed % (1 << 31), num_workers=threads, cache_bytes=c.cache_bytes)


def bucket_starts(loader, cfg, batch_size: int) -> Dict[int, tuple]:
    """{bucket: (index of its first batch in an ascending epoch, its batches)}
    from the loader's utterances a bucket and the recipe's batch sizes (a
    bucket past ``half_batch_len`` frames takes half); checked against the
    loader's batch count."""
    c = cfg.data.corpus
    out, at = {}, 0
    for bi, count in enumerate(loader.bucket_counts()):
        bs = max(1, batch_size // 2) if c.buckets[bi] > c.half_batch_len else batch_size
        nb = math.ceil(count / bs)
        if nb:
            out[bi] = (at, nb)
        at += nb
    if at != len(loader):
        raise RuntimeError(f"the loader has {len(loader)} batches, the recipe's sizes give {at}")
    return out


def _one(loader, index: int):
    it = loader.epoch(0, ascending=True, skip_first=index)
    try:
        return next(it)
    finally:
        it.close()


def _shape(batch, sr: int) -> dict:
    real = [i for i, u in enumerate(batch.uids) if u]
    return {"b": int(len(batch.uids)), "n": int(batch.n_samples or batch.wav.shape[1]),
            "l": int(batch.text.shape[1]), "wav_len": batch.wav_len.tolist(), "text_len": batch.text_len.tolist(),
            "audio_s": float(batch.wav_len[real].sum()) / sr, "uids": tuple(batch.uids)}


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# --------------------------------------------------------------- training
def run_train(recipe: dict, mix: dict, seed: int, seconds: float, trace: bool, device: str, t_start: float,
              control: bool = False) -> Run:
    from e2e_asr_tpu_torch import cuda_build
    from e2e_asr_tpu_torch.config import Config
    from e2e_asr_tpu_torch.data.prefetch import DevicePrefetcher, to_device
    from e2e_asr_tpu_torch.device import resolve_device
    from e2e_asr_tpu_torch.training.step import Trainer, param_leaves
    from e2e_asr_tpu_torch.training.step_graph import TrainGraphs

    from asr_bench.reference import model as ref_model
    from asr_bench.reference import train as ref_train

    cfg = Config.from_dict(recipe)
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        cuda_build.build_all()
    note(t_start, "kernels loaded")
    sr = cfg.data.audio.sample_rate
    run = Run("train", recipe)
    utts = traffic.make(mix, seed, sr)
    by_uid = {u.uid: u for u in utts}
    loader = _loader(cfg, utts, cfg.data.corpus.batch_size, True, seed, mix["loader_threads"])
    corpus = None
    if cfg.data.corpus.device_cache == "on":
        flat, _ = loader.flat_corpus()
        corpus = torch.from_numpy(flat).to(dev)
    note(t_start, f"traffic made: {len(utts)} utterances, {len(loader)} batches an epoch")
    vocab = VOCAB
    leaves = weights.asr_names(recipe["model"], cfg.data.audio.feat_dim, vocab)
    flat_w = weights.draw(leaves, seed, dev)
    n_layers = len(cfg.model.encoder.dim)
    params = weights.port_tree(flat_w, n_layers)
    names = param_leaves(weights.port_tree({k: k for k in flat_w}, n_layers))
    del flat_w
    trainer = Trainer(cfg)
    state = trainer.init_state(params)
    graphs = TrainGraphs() if cuda else None

    starts = bucket_starts(loader, cfg, cfg.data.corpus.batch_size)
    top, main_b = max(starts), max(starts, key=lambda b: starts[b][1])
    warm = [starts[b][0] for b in sorted(starts)]  # a batch of each bucket: its eager step, then its capture
    first = starts[top][0] + 1  # the compared steps: the largest bucket's, then two of the commonest's
    rest = [starts[main_b][0] + j for j in range(starts[main_b][1])]
    check = [first] + [k for k in rest if k not in warm and k != first][:2]
    if starts[top][1] < 2 or len(check) < 3:
        raise RuntimeError("the traffic's buckets hold too few batches for the compared steps")

    def feed():
        for k in warm + check:
            yield _one(loader, k)
        yield from loader.forever(start_epoch=1)

    def put(batch):
        keys = ("wav_len", "text", "text_len") + (("wav",) if batch.wav is not None else ("wav_off",))
        out = {k: to_device(getattr(batch, k), dev) for k in keys}
        if batch.wav is None:
            out["corpus"], out["n_samples"] = corpus, batch.n_samples
        return out

    keys = trainer.scalar_keys()
    i_loss, i_skip = keys.index("loss"), keys.index("step_skipped")
    step = 0
    first_loss, first_batches = [], []
    eg1 = p3 = None

    def gen():
        g = torch.Generator(device=dev)
        g.manual_seed(step_seed(seed, step))
        return g

    def tensors(st):
        """The state's tensors: the parameters, then every optimizer tensor."""
        return param_leaves(st.params) + [t for k in sorted(st.opt_state)
                                          for t in (st.opt_state[k] if isinstance(st.opt_state[k], list)
                                                    else [st.opt_state[k]])]

    start = [t.detach().clone() for t in tensors(state)]
    prefetch = DevicePrefetcher(feed(), put, depth=2, device=dev)
    try:
        for _ in warm:  # set-up: every bucket shape's first step, then its capture
            batch, dbatch = next(prefetch)
            trainer.train_step(state, dbatch, gen(), graphs=graphs)
            step += 1
        with torch.no_grad():  # back to the seed's state, in place: the graphs hold these tensors
            for t, t0 in zip(tensors(state), start):
                t.copy_(t0)
        del start
        state.step = step = 0
        for i in range(len(check)):  # the compared steps: replays of the window's graphs, from the seed's state
            batch, dbatch = next(prefetch)
            m = trainer.train_step(state, dbatch, gen(), graphs=graphs)
            step += 1
            if cuda:
                torch.cuda.synchronize()
            first_loss.append(float(m["scalars"][i_loss]))
            first_batches.append((_shape(batch, sr), ref_train.tf_rate(recipe["hparas"], step - 1),
                                  step_seed(seed, step - 1)))
            if i == 0:
                eg1 = [t.detach().clone() for t in state.opt_state["e_g"]]
        p3 = [p.detach().clone() for p in param_leaves(state.params)]
        if cuda:
            torch.cuda.synchronize()
        run.setup_s = time.time() - t_start
        note(t_start, f"set-up done: {len(warm)} bucket shapes captured, {len(check)} compared steps replayed")

        log_step = cfg.hparas.log_step
        ring = torch.empty((log_step, len(keys)), dtype=torch.float32, device=dev)

        def window(until: float, rec: List[dict]):
            nonlocal step
            n = 0
            t0 = time.perf_counter()
            wait = 0.0
            while time.perf_counter() - t0 < until:
                t1 = time.perf_counter()
                with span("input_wait"):
                    batch, dbatch = next(prefetch)
                wait += time.perf_counter() - t1
                with span("train_step"):
                    m = trainer.train_step(state, dbatch, gen(), graphs=graphs)
                    ring[n].copy_(m["scalars"])
                step += 1
                n += 1
                rec.append(_shape(batch, sr))
                if n == log_step:
                    with span("ring_read"):
                        run.failed += sum(r[i_skip] > 0 for r in ring.tolist())
                    n = 0
            with span("ring_read"):  # the window ends on a read of the device
                run.failed += sum(r[i_skip] > 0 for r in ring[:n].tolist())
            return time.perf_counter() - t0, wait

        run.wall_s, run.wait_s = window(seconds, run.batches)
        run.audio_s = sum(b["audio_s"] for b in run.batches)
        run.attempted = len(run.batches)
        if trace and cuda:
            out: dict = {}
            steps = mix["trace_steps"]
            with profiled(out):
                for _ in range(steps):
                    with span("input_wait"):
                        batch, dbatch = next(prefetch)
                    with span("train_step"):
                        m = trainer.train_step(state, dbatch, gen(), graphs=graphs)
                    step += 1
                    run.slice_batches.append(_shape(batch, sr))
            run.trace = out
    finally:
        prefetch.close()
    run.memory_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    note(t_start, f"window closed: {run.attempted} steps in {run.wall_s:.3f} s")
    del state, trainer, graphs, params, corpus, prefetch
    _free()

    # the reference: the first three steps from the same weights and batches
    w0 = weights.draw(leaves, seed, dev)
    batches = []
    for shp, tf, sd in first_batches:
        wav = torch.from_numpy(traffic.waves_i16(by_uid, shp["uids"], shp["n"])).to(dev)
        text = np.zeros((shp["b"], shp["l"]), np.int64)
        for r, uid in enumerate(shp["uids"]):
            if uid:
                ids = text_ids(by_uid[uid].text)[: shp["l"]]
                text[r, : len(ids)] = ids
        wav_len = [min(by_uid[u].n_samples, shp["n"]) if u else 0 for u in shp["uids"]]
        text_len = [min(len(by_uid[u].text) + 1, shp["l"]) if u else 0 for u in shp["uids"]]
        batches.append(ref_train.RefBatch(wav, torch.tensor(wav_len, device=dev), torch.from_numpy(text).to(dev),
                                          torch.tensor(text_len, device=dev), sd, tf))
    ref = ref_train.adadelta_steps(w0, recipe, batches, ref_model.Precision("fp32"))
    rho = 0.9  # Adadelta's: e_g after one step is (1 - rho) g^2 of the clipped gradient g
    port = {"loss": first_loss,
            "grad_norm": {n: math.sqrt(max(float(t.double().sum()), 0.0) / (1 - rho)) for n, t in zip(names, eg1)},
            "change": {n: float((p - w0[n]).double().norm()) for n, p in zip(names, p3)}}
    run.numbers = compare_train(port, ref)
    run.detail = {"program": look(port, ref)}
    if control:  # the controls of step 2 and 3 of the check (asr_bench/control.py)
        fp8 = ref_train.adadelta_steps(w0, recipe, batches, ref_model.Precision("fp8"))
        run.detail["fp8"] = look(fp8, ref)
        run.control = {
            "fp8": compare_train(fp8, ref),
            "half_batch": compare_train(ref_train.adadelta_steps(w0, recipe, [half(bt) for bt in batches],
                                                                 ref_model.Precision("fp32")), ref),
            "state_unchanged": compare_train(dict(port, change={n: 0.0 for n in names}), ref)}
    note(t_start, "reference done")
    return run


def half(bt):
    """A batch with its second half of rows left out (the loss's mean over the rest)."""
    k = max(1, bt.wav.shape[0] // 2)
    return bt._replace(wav=bt.wav[:k], wav_len=bt.wav_len[:k], text=bt.text[:k], text_len=bt.text_len[:k])


def _leaf_gaps(port: dict, ref: dict, key: str, names) -> Dict[str, float]:
    med = float(np.median([ref[key][n] for n in names]))
    return {n: abs(port[key][n] - ref[key][n]) / max(ref[key][n], med) for n in names}


def _moved(ref: dict):
    """The leaves whose first reference gradient is at least a thousandth of
    the median leaf's: the others move by round-off alone."""
    g = ref["grad_norm"]
    med = float(np.median(list(g.values())))
    return sorted(n for n in g if g[n] >= 1e-3 * med)


def compare_train(port: dict, ref: dict) -> Dict[str, float]:
    """The compared numbers of a training cell, each by the worst leaf: the
    gap of the first step's clipped-gradient norms (every leaf) and of the
    three steps' change norms (the leaves that move, ``_moved``), each over
    the larger of the reference leaf's norm and the median leaf's."""
    return {"grad_norm_gap": max(_leaf_gaps(port, ref, "grad_norm", sorted(ref["grad_norm"])).values()),
            "param_change_gap": max(_leaf_gaps(port, ref, "change", _moved(ref)).values())}


def look(port: dict, ref: dict, n: int = 3) -> Dict[str, object]:
    """Behind the numbers: the worst leaves of each and the losses' gap."""
    out: Dict[str, object] = {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(port["loss"], ref["loss"]))}
    for key, names in (("grad_norm", sorted(ref["grad_norm"])), ("change", _moved(ref))):
        gaps = _leaf_gaps(port, ref, key, names)
        out[key] = [[k, gaps[k]] for k in sorted(gaps, key=lambda k: -gaps[k])[:n]]
    return out


# --------------------------------------------------------------- decoding
def run_decode(recipe: dict, mix: dict, seed: int, seconds: float, trace: bool, device: str, t_start: float,
               control: bool = False) -> Run:
    from e2e_asr_tpu_torch import cuda_build
    from e2e_asr_tpu_torch.bin import test_asr
    from e2e_asr_tpu_torch.config import Config
    from e2e_asr_tpu_torch.data.prefetch import DevicePrefetcher
    from e2e_asr_tpu_torch.decode.beam_graph import BeamGraphs
    from e2e_asr_tpu_torch.device import resolve_device

    recipe = dict(recipe, decode=dict(recipe["decode"], **mix.get("decode", {})))
    cfg = Config.from_dict(recipe)
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        cuda_build.build_all()
    note(t_start, "kernels loaded")
    sr = cfg.data.audio.sample_rate
    run = Run("decode", recipe)
    utts = traffic.make(mix, seed, sr)
    by_uid = {u.uid: u for u in utts}
    bs = cfg.decode.batch_size
    loader = _loader(cfg, utts, bs, False, seed, mix["loader_threads"])
    vocab = VOCAB
    use_lm = cfg.decode.lm_weight > 0
    leaves = weights.asr_names(recipe["model"], cfg.data.audio.feat_dim, vocab)
    lm_leaves = weights.lm_names(recipe["lm"], vocab) if use_lm else []
    flat_w = weights.draw(leaves + lm_leaves, seed, dev)
    solver = test_asr.Solver.__new__(test_asr.Solver)  # its decode path, with the benchmark's weights
    solver.config, solver.device = cfg, dev
    solver.params = weights.port_tree(flat_w, len(cfg.model.encoder.dim))
    solver.lm_params = weights.port_lm_tree(flat_w, cfg.lm.n_layers) if use_lm else None
    solver.lm_cfg = cfg.lm if use_lm else None
    solver.beam_graphs = BeamGraphs()
    del flat_w

    starts = bucket_starts(loader, cfg, bs)
    warm = [starts[b][0] for b in sorted(starts)]

    def feed():
        for k in warm:
            yield _one(loader, k)
        e = 0
        while True:
            yield from loader.epoch(e)
            e += 1

    kept: List[tuple] = []

    def decode(batch, wav, wav_len, rec):
        res = solver.decode_batch(wav, wav_len)
        with span("readback"):
            out = (res.tokens.cpu().numpy().astype(np.int16), res.lengths.cpu().numpy(), res.scores.cpu().numpy())
        rec.append(_shape(batch, sr))
        return out

    prefetch = DevicePrefetcher(feed(), lambda b: solver.put(b.wav, b.wav_len), depth=2, device=dev)
    try:
        for _ in warm:  # set-up: one batch of each bucket shape, its beam step captured
            batch, (wav, wav_len) = next(prefetch)
            decode(batch, wav, wav_len, [])
        run.setup_s = time.time() - t_start
        note(t_start, f"set-up done: {len(warm)} bucket shapes captured")

        def window(until: float, rec: List[dict], lat: List[float], keep: bool):
            t0 = time.perf_counter()
            wait = 0.0
            while time.perf_counter() - t0 < until:
                t1 = time.perf_counter()
                with span("input_wait"):
                    batch, (wav, wav_len) = next(prefetch)
                t2 = time.perf_counter()
                wait += t2 - t1
                with span("decode"):
                    out = decode(batch, wav, wav_len, rec)
                lat.append(time.perf_counter() - t2)
                if keep:
                    kept.append(out)
            return time.perf_counter() - t0, wait

        run.wall_s, run.wait_s = window(seconds, run.batches, run.latencies_s, True)
        run.audio_s = sum(b["audio_s"] for b in run.batches)
        run.attempted = len(run.batches)
        if trace and cuda:  # one batch of every trace_every, across the eval order's buckets
            out: dict = {}
            every, count = mix["trace_every"], mix["trace_batches"]
            with sampled(out, every, count) as prof:
                for i in range(every * count):
                    rec = run.slice_batches if i % every == every - 1 else []
                    with span("unit"):
                        with span("input_wait"):
                            batch, (wav, wav_len) = next(prefetch)
                        with span("decode"):
                            decode(batch, wav, wav_len, rec)
                    prof.step()
            run.trace = out
    finally:
        prefetch.close()
    run.memory_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    note(t_start, f"window closed: {run.attempted} batches in {run.wall_s:.3f} s")
    del solver, prefetch
    _free()

    # the reference: a sample of the window's batches, the longest among them,
    # rescored, and the first steps of their search made again
    from asr_bench.reference import decode as ref_decode
    from asr_bench.reference import model as ref_model
    from asr_bench.reference import search as ref_search

    w0 = weights.draw(leaves + lm_leaves, seed, dev)
    rng = np.random.default_rng([seed, 0xDEC])
    longest = int(np.argmax([b["n"] * 1e6 + b["audio_s"] for b in run.batches]))
    others = [i for i in range(len(run.batches)) if i != longest]
    pick = [longest] + sorted(rng.choice(others, min(len(others), CHECK_BATCHES - 1), replace=False).tolist())
    dcfg = recipe["decode"]
    fp32, tf32 = ref_model.Precision("fp32"), ref_model.Precision("tf32")
    gaps: Dict[str, List[float]] = {"program": [], "tf32": [], "token_altered": []}  # every hypothesis's |score gap|
    miss: Dict[str, List[int]] = {"program": [0, 0], "tf32": [0, 0], "skip_best": [0, 0]}  # [missed, considered]
    n_hyp = n_tok = n_utt = 0
    for i in pick:
        shp = run.batches[i]
        toks, lens, scores = kept[i]
        rows = [r for r, u in enumerate(shp["uids"]) if u]
        uids = [shp["uids"][r] for r in rows]
        wav = torch.from_numpy(traffic.waves_i16(by_uid, uids, shp["n"])).to(dev)
        wav_len = torch.tensor([min(by_uid[u].n_samples, shp["n"]) for u in uids], device=dev)
        t = torch.from_numpy(toks[rows].astype(np.int64)).to(dev)
        ln = torch.from_numpy(lens[rows]).to(dev)
        sc = torch.from_numpy(scores[rows]).double().to(dev)
        ref = ref_decode.rescore(w0, recipe, wav, wav_len, t, ln, dcfg, fp32)
        ms = shapes.max_step(recipe, shp["n"])
        if t.shape[2] != ms:
            run.problems.append(f"a batch of {shp['n']} samples searched {t.shape[2]} steps, not {ms}")
        bad = ref_decode.check(t, ln, sc, ref, vocab, ms)
        if bad:
            run.problems.append(bad)
        gaps["program"] += (sc - ref["score"].double()).abs().flatten().tolist()
        live = ref_search.search(w0, recipe, wav, wav_len, dcfg, ms, fp32, stop=PREFIX_STEPS)["live"]
        miss["program"] = [a + b for a, b in zip(miss["program"], ref_decode.prefix_miss(t, ln, live))]
        if control:
            tf = ref_decode.rescore(w0, recipe, wav, wav_len, t, ln, dcfg, tf32)
            gaps["tf32"] += (tf["score"] - ref["score"]).double().abs().flatten().tolist()
            for name, pr, skip in (("tf32", tf32, False), ("skip_best", fp32, True)):
                found = ref_search.search(w0, recipe, wav, wav_len, dcfg, ms, pr, skip_best=skip)
                got = ref_decode.prefix_miss(found["tokens"], found["lengths"], live)
                miss[name] = [a + b for a, b in zip(miss[name], got)]
            alt = t.clone()
            alt[0, 0, 0] = (alt[0, 0, 0] + 1 - 3) % (vocab - 3) + 3  # another character where the first is produced
            wrong = ref_decode.rescore(w0, recipe, wav, wav_len, alt, ln, dcfg, fp32)
            gaps["token_altered"] += (sc - wrong["score"].double()).abs().flatten().tolist()
        n_hyp += t.shape[0] * t.shape[1]
        n_tok += int(ln.sum())
        n_utt += len(uids)

    def numbers(g: List[float], m: List[int]) -> Dict[str, float]:
        out = {"score_gap": max(g), "score_gap_mean": float(np.mean(g))} if g else {}
        if m[1]:
            out["prefix_miss"] = m[0] / m[1]
        return out

    # score_gap: the widest gap of a returned score, against a single wrong
    # answer; score_gap_mean: the mean gap, against a model computed less
    # precisely; prefix_miss: the share of returned hypotheses whose first
    # PREFIX_STEPS tokens the reference's own search did not keep, against a
    # search that prunes or keeps the wrong hypotheses
    run.numbers = numbers(gaps["program"], miss["program"])
    if control:
        run.control = {"tf32": numbers(gaps["tf32"], miss["tf32"]),
                       "token_altered": numbers(gaps["token_altered"], [0, 0]),
                       "skip_best": numbers([], miss["skip_best"])}
    run.checked = {"batches": len(pick), "hypotheses": n_hyp, "tokens": n_tok, "utterances": n_utt,
                   "prefixes": miss["program"][1]}
    note(t_start, "reference done")
    return run
