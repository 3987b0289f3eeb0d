"""The port's input path against the JAX package's (``tests/test_input_pipeline.py``
is the JAX side's own): the int16 wave cache, batches filled by threads,
the device-resident corpus (``flat_corpus``, offsets batches,
``resolve_wav``) and the prefetcher, on the CPU. Batches, buffers and
offsets must be bitwise equal to the JAX loader's; ``resolve_wav`` bitwise
equal to the JAX function; a train step from an offsets batch bitwise equal
to one from the streaming batch."""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2e_asr_tpu.config import Config as JConfig
from e2e_asr_tpu.data import corpus as jcorpus
from e2e_asr_tpu.data.dataset import BucketedLoader as JLoader
from e2e_asr_tpu.data.dataset import build_tokenizer as jbuild_tokenizer
from e2e_asr_tpu.training.step import resolve_wav as jresolve_wav
from e2e_asr_tpu_torch.config import Config as TConfig
from e2e_asr_tpu_torch.data import corpus as tcorpus
from e2e_asr_tpu_torch.data.dataset import BucketedLoader as TLoader
from e2e_asr_tpu_torch.data.dataset import build_tokenizer as tbuild_tokenizer
from e2e_asr_tpu_torch.data.prefetch import DevicePrefetcher, to_device
from e2e_asr_tpu_torch.models import asr as tasr
from e2e_asr_tpu_torch.training.step import Trainer, param_leaves, resolve_wav
from tests.torch_parity import small_config

torch.set_num_threads(1)
DATA = {"text": {"mode": "character"}}
LADDER = dict(buckets_frames=[100, 208, 416], token_buckets=[24, 32, 48], win=400, shift=160)


def _loaders(n=24, workers=0, wire="int16", name="synthetic", batch_size=4, cache_bytes=2 << 30,
             shuffle=False):
    """(JAX loader, port loader) over the same manifest and ladder."""
    jutts = jcorpus.load_corpus(name, "", [f"train:{n}"])
    tutts = tcorpus.load_corpus(name, "", [f"train:{n}"])
    jtok = jbuild_tokenizer(JConfig.from_dict({"data": DATA}).data, jutts)
    ttok = tbuild_tokenizer(TConfig.from_dict({"data": DATA}).data, tutts)
    common = dict(LADDER, wire_dtype=wire, num_workers=workers, cache_bytes=cache_bytes, shuffle=shuffle)
    return (JLoader(jutts, jtok, batch_size, **common),
            TLoader(tutts, ttok, batch_size, **common))


def _counted(loader):
    """Wraps every utterance's ``load`` with a call count; returns the counts."""
    counts = {}
    for u, _, _ in loader._items:
        def load(f=u.load, uid=u.uid):
            counts[uid] = counts.get(uid, 0) + 1
            return f()
        u.load = load
    return counts


def _assert_batches_equal(tb, jb):
    assert tb.uids == jb.uids
    assert tb.n_samples == jb.n_samples
    for k in ("wav", "wav_off", "wav_len", "text", "text_len"):
        t, j = getattr(tb, k), getattr(jb, k)
        assert (t is None) == (j is None), k
        if t is not None:
            assert t.dtype == j.dtype, k
            np.testing.assert_array_equal(t, j, err_msg=k)


@pytest.mark.parametrize("workers", [0, 2, 4])
def test_cache_loads_each_utterance_once(workers):
    """Two epochs (shuffled, so in other orders) load each utterance once;
    the batches equal the JAX loader's in both."""
    jl, tl = _loaders(workers=workers, shuffle=True)
    counts = _counted(tl)
    for e in (0, 1):
        for tb, jb in zip(tl.epoch(e), jl.epoch(e), strict=True):
            _assert_batches_equal(tb, jb)
    assert sorted(counts) == sorted(u.uid for u, _, _ in tl._items)
    assert set(counts.values()) == {1}
    assert tl._cache_used == sum(x.nbytes for x in tl._wav_cache.values()) == tl.total_wav_bytes


@pytest.mark.parametrize("workers", [0, 2])
def test_cache_stops_at_cache_bytes(workers):
    """A cap below the corpus: the cache holds what fits and stops; the rest
    is loaded again each epoch, and the batches do not change."""
    jl, tl = _loaders(workers=workers, shuffle=True)
    cap = tl.total_wav_bytes // 3
    jl, tl = _loaders(workers=workers, shuffle=True, cache_bytes=cap)
    counts = _counted(tl)
    for e in (0, 1):
        for tb, jb in zip(tl.epoch(e), jl.epoch(e), strict=True):
            _assert_batches_equal(tb, jb)
    cached = {tl._items[i][0].uid for i in tl._wav_cache}
    assert 0 < tl._cache_used <= cap
    assert tl._cache_used == sum(x.nbytes for x in tl._wav_cache.values())
    assert 0 < len(cached) < tl.num_utts
    for uid, c in counts.items():
        assert c == (1 if uid in cached else 2), uid


def test_cache_under_many_threads_keeps_its_count():
    """More loader threads than cores and a short switch interval: the
    cache's byte count stays the sum of what it holds, within its cap, and
    the batches stay the serial loader's, in order."""
    import sys

    _, serial = _loaders(n=48, shuffle=True)
    cap = serial.total_wav_bytes // 2
    _, tl = _loaders(n=48, workers=16, shuffle=True, cache_bytes=cap)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.time()
        for e in (0, 1):
            for tb, sb in zip(tl.epoch(e), serial.epoch(e), strict=True):
                _assert_batches_equal(tb, sb)
        assert time.time() - t0 < 120
    finally:
        sys.setswitchinterval(interval)
    assert 0 < tl._cache_used <= cap
    assert tl._cache_used == sum(x.nbytes for x in tl._wav_cache.values())


def test_cache_off_loads_every_epoch():
    _, tl = _loaders(cache_bytes=0)
    counts = _counted(tl)
    for e in (0, 1):
        list(tl.epoch(e))
    assert set(counts.values()) == {2} and tl._cache_used == 0


@pytest.mark.parametrize("name", ["synthetic", "synthetic_char"])
def test_flat_corpus_matches_jax(name):
    """The flat buffer (tail padded by the largest bucket) and the offsets,
    bitwise; both loaders switch to offsets batches and drop their caches."""
    jl, tl = _loaders(name=name)
    list(tl.epoch(0))
    assert tl._wav_cache
    jflat, joffs = jl.flat_corpus()
    tflat, toffs = tl.flat_corpus()
    assert tflat.dtype == jflat.dtype == np.int16 and toffs.dtype == joffs.dtype == np.int32
    np.testing.assert_array_equal(tflat, jflat)
    np.testing.assert_array_equal(toffs, joffs)
    assert tl.emit_offsets and not tl._wav_cache and tl._cache_used == 0
    assert tflat.shape[0] == tl.total_wav_bytes // 2 + max(tl.buckets_samples)


def test_total_wav_bytes_and_fits_match_jax():
    jl, tl = _loaders()
    assert tl.total_wav_bytes == jl.total_wav_bytes > 0
    assert tl.flat_corpus_fits == jl.flat_corpus_fits is True
    # past int32 sample offsets: neither fits, and the port's flat_corpus raises
    for ld in (jl, tl):
        ld.buckets_samples = [1 << 31]
    assert tl.flat_corpus_fits == jl.flat_corpus_fits is False
    with pytest.raises(ValueError, match="int32"):
        tl.flat_corpus()


@pytest.mark.parametrize("workers", [0, 2])
def test_offsets_batches_match_jax(workers):
    """Offsets batches over two shuffled epochs and a curriculum epoch, as
    the JAX loader gives them; each row gathered from the buffer is the
    streaming batch's row."""
    jl, tl = _loaders(workers=workers, shuffle=True)
    stream = list(tl.epoch(0))
    jflat, _ = jl.flat_corpus()
    tflat, _ = tl.flat_corpus()
    for e, asc in ((0, False), (1, False), (0, True)):
        for tb, jb in zip(tl.epoch(e, ascending=asc), jl.epoch(e, ascending=asc), strict=True):
            assert tb.wav is None
            _assert_batches_equal(tb, jb)
    for sb, ob in zip(stream, tl.epoch(0), strict=True):
        for j in range(len(ob.uids)):
            n = int(ob.wav_len[j])
            assert n == int(sb.wav_len[j])
            np.testing.assert_array_equal(tflat[ob.wav_off[j]: ob.wav_off[j] + n], sb.wav[j, :n])


def test_flat_corpus_disk_copy_is_shared_with_jax(tmp_path, monkeypatch):
    """``E2E_CORPUS_CACHE``: the JAX loader's file is the port's (same
    content address), read back without loading a wave."""
    monkeypatch.setenv("E2E_CORPUS_CACHE", str(tmp_path))
    jl, tl = _loaders()
    jflat, _ = jl.flat_corpus()
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 1
    counts = _counted(tl)
    tflat, toffs = tl.flat_corpus()
    np.testing.assert_array_equal(tflat, jflat)
    assert sorted(p.name for p in tmp_path.iterdir()) == files
    assert sum(counts.values()) == 1  # the address's one wave, no fill
    # and the other way round: the port writes, JAX reads
    monkeypatch.setenv("E2E_CORPUS_CACHE", str(tmp_path / "port"))
    jl, tl = _loaders(n=12)
    tflat, _ = tl.flat_corpus()
    jflat, _ = jl.flat_corpus()
    np.testing.assert_array_equal(jflat, tflat)
    assert len(list((tmp_path / "port").iterdir())) == 1


def _offsets_rows(tl, tflat, toffs):
    """(wav_off, wav_len, n) rows that reach the buffer's edges: the last
    utterance (at the tail), a padding row (wav_len 0, offset 0), the
    first, and one offset past len - n (the clamp)."""
    n = max(tl.buckets_samples)
    last = int(np.argmax(toffs))
    lens = [it[0].n_samples for it in tl._items]
    off = np.asarray([toffs[last], 0, toffs[0], tflat.shape[0] - n // 2], np.int32)
    wav_len = np.asarray([min(lens[last], n), 0, min(lens[0], n), 7], np.int32)
    return off, wav_len, n


@pytest.mark.parametrize("n_div", [1, 2, 3])
def test_resolve_wav_matches_jax(n_div):
    """``resolve_wav`` against the JAX function on the same buffer and rows,
    at three row lengths: bitwise, zeros past wav_len included."""
    _, tl = _loaders()
    tflat, toffs = tl.flat_corpus()
    off, wav_len, n = _offsets_rows(tl, tflat, toffs)
    n = n // n_div
    wav_len = np.minimum(wav_len, n)
    want, wl = jresolve_wav({"wav_off": jnp.asarray(off), "wav_len": jnp.asarray(wav_len),
                             "corpus": jnp.asarray(tflat)}, n_samples=n)
    got, gl = resolve_wav({"wav_off": torch.from_numpy(off), "wav_len": torch.from_numpy(wav_len),
                           "corpus": torch.from_numpy(tflat)}, n_samples=n)
    assert got.dtype == torch.int16 and got.shape == (4, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert not got[1].any()  # the padding row
    # the batch's own n_samples stands in for the argument
    got2, _ = resolve_wav({"wav_off": torch.from_numpy(off), "wav_len": torch.from_numpy(wav_len),
                           "corpus": torch.from_numpy(tflat), "n_samples": n})
    assert torch.equal(got2, got)


def test_resolve_wav_passes_a_streaming_batch_through():
    wav, wl = torch.zeros(2, 5, dtype=torch.int16), torch.tensor([5, 3])
    got, gl = resolve_wav({"wav": wav, "wav_len": wl, "text": None})
    assert got is wav and gl is wl
    with pytest.raises(ValueError, match="n_samples"):
        resolve_wav({"wav_off": torch.zeros(2, dtype=torch.int32), "wav_len": wl,
                     "corpus": torch.zeros(10, dtype=torch.int16)})


def test_train_step_stream_vs_offsets():
    """One port train step on the CPU from the streaming batch and from the
    same batch as offsets into the flat corpus: the same loss, gradient
    norm and parameters, bitwise."""
    d = small_config()
    d["data"] = {"corpus": {"name": "synthetic"}, "audio": {"feat_dim": 40, "use_pallas": True},
                 "text": {"mode": "character"}}
    d["hparas"] = {"optimizer": "Adam", "lr": 1e-3}
    cfg = TConfig.from_dict(d)
    _, tl = _loaders(n=8, batch_size=4)
    sb = next(tl.epoch(0))
    flat, _ = tl.flat_corpus()
    ob = next(tl.epoch(0))
    assert ob.wav is None and ob.uids == sb.uids
    batches = {
        "stream": {k: torch.from_numpy(getattr(sb, k)) for k in ("wav", "wav_len", "text", "text_len")},
        "offsets": {**{k: torch.from_numpy(getattr(ob, k)) for k in ("wav_off", "wav_len", "text", "text_len")},
                    "corpus": torch.from_numpy(flat), "n_samples": ob.n_samples},
    }
    out = {}
    for name, batch in batches.items():
        params, _ = tasr.asr_init(0, 40, tl.tokenizer.vocab_size, cfg.model, torch.device("cpu"))
        trainer = Trainer(cfg)
        state = trainer.init_state(params)
        gen = torch.Generator()
        gen.manual_seed(0)
        m = trainer.train_step(state, batch, gen)
        ev = trainer.eval_step(state.params, batch)
        out[name] = (float(m["loss"]), float(m["grad_norm"]), float(ev["loss"]),
                     [p.detach().clone() for p in param_leaves(state.params)])
    (ls, gs, es, ps), (lo, go, eo, po) = out["stream"], out["offsets"]
    assert np.isfinite(ls) and (ls, gs, es) == (lo, go, eo)
    assert all(torch.equal(a, b) for a, b in zip(ps, po))


# ------------------------------------------------------------------ prefetch
def test_prefetcher_order_and_close():
    pf = DevicePrefetcher(iter(range(20)), lambda x: x * 10, depth=3)
    got = [next(pf) for _ in range(5)]
    assert got == [(i, i * 10) for i in range(5)]
    pf.close()  # early close must not hang or error
    assert not pf._th.is_alive()


def test_prefetcher_exhaustion():
    pf = DevicePrefetcher(iter([1, 2]), lambda x: x, depth=2)
    assert list(pf) == [(1, 1), (2, 2)]
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()


@pytest.mark.parametrize("where", ["put_fn", "source"])
def test_prefetcher_raises_the_workers_error(where):
    def bad_put(x):
        if x == 2:
            raise ValueError("boom")
        return x

    def bad_source():
        yield 1
        raise ValueError("boom")

    if where == "put_fn":
        pf = DevicePrefetcher(iter([1, 2, 3]), bad_put, depth=2)
    else:
        pf = DevicePrefetcher(bad_source(), lambda x: x, depth=2)
    assert next(pf) == (1, 1)
    with pytest.raises(ValueError, match="boom"):
        for _ in pf:
            pass
    pf.close()


def test_prefetcher_raises_the_error_with_a_full_queue():
    """The thread fails while the queue is full (the consumer is busy): the
    queued batches come first, then the error; the thread ends."""
    def put(x):
        if x == 2:
            raise RuntimeError("copy failed")
        return x

    pf = DevicePrefetcher(iter(range(10)), put, depth=2)
    deadline = time.time() + 10
    while pf._error is None and time.time() < deadline:
        time.sleep(0.01)
    assert isinstance(pf._error, RuntimeError) and pf._q.full()
    assert [next(pf), next(pf)] == [(0, 0), (1, 1)]
    with pytest.raises(RuntimeError, match="copy failed"):
        next(pf)
    pf._th.join(timeout=10)
    assert not pf._th.is_alive()
    pf.close()


def test_prefetcher_close_leaves_no_live_thread():
    """Over a threaded loader's endless stream, stopped mid-epoch: close()
    ends the prefetch thread and the loader's worker threads."""
    _, tl = _loaders(n=24, workers=2, shuffle=True)
    before = set(threading.enumerate())
    pf = DevicePrefetcher(tl.forever(), lambda b: to_device(b.wav, torch.device("cpu")), depth=2)
    for _ in range(3):
        hb, wav = next(pf)
        np.testing.assert_array_equal(wav.numpy(), hb.wav)
    pf.close()
    deadline = time.time() + 10
    while set(threading.enumerate()) - before and time.time() < deadline:
        time.sleep(0.01)
    assert not set(threading.enumerate()) - before


def test_prefetcher_batches_equal_the_loaders():
    """The prefetched stream of a threaded loader, as ``bin/train_asr.py``
    builds it, equals the serial loader's, host and device sides."""
    _, serial = _loaders(n=24, workers=0, shuffle=True)
    _, threaded = _loaders(n=24, workers=4, shuffle=True)
    want = serial.forever(skip_steps=3)
    pf = DevicePrefetcher(threaded.forever(skip_steps=3), lambda b: {
        k: to_device(getattr(b, k), torch.device("cpu")) for k in ("wav", "wav_len")}, depth=2)
    try:
        for _ in range(2 * len(serial) + 1):
            hb, db = next(pf)
            wb = next(want)
            _assert_batches_equal(hb, wb)
            np.testing.assert_array_equal(db["wav"].numpy(), wb.wav)
    finally:
        pf.close()


def test_to_device_on_the_cpu_shares_the_array():
    x = np.arange(6, dtype=np.int16).reshape(2, 3)
    t = to_device(x, torch.device("cpu"))
    assert t.dtype == torch.int16 and np.shares_memory(t.numpy(), x)


# ------------------------------------------------ the loader's sizing half
def _sized(batch_size, n=40, **kw):
    """(JAX loader, port loader) over one manifest with the sizing options
    ``kw`` (half_batch_len, process_index / count)."""
    jutts = jcorpus.load_corpus("synthetic", "", [f"train:{n}"])
    tutts = tcorpus.load_corpus("synthetic", "", [f"train:{n}"])
    jtok = jbuild_tokenizer(JConfig.from_dict({"data": DATA}).data, jutts)
    ttok = tbuild_tokenizer(TConfig.from_dict({"data": DATA}).data, tutts)
    common = dict(LADDER, num_workers=0, **kw)
    return JLoader(jutts, jtok, batch_size, **common), TLoader(tutts, ttok, batch_size, **common)


def _assert_same_partition(tl, jl):
    assert tl._batches == jl._batches
    assert tl._pad_bs == jl._pad_bs
    assert len(tl) == len(jl) and tl.batch_shapes() == jl.batch_shapes()


@pytest.mark.parametrize("batch_size,kw", [
    (4, {}),
    (3, {}),
    ([2, 5, 3], {}),
    ([2, 5, 3], {"process_count": 3, "process_index": 2}),
    ([3, 6, 4], {"half_batch_len": 200}),  # the 208 and 416 buckets take half
    (3, {"process_count": 2, "process_index": 1}),
    ([5, 3, 7], {"process_count": 2, "process_index": 0}),
])
def test_rebatch_partition_matches_jax(batch_size, kw):
    """One batch size or one a bucket, the half-batch rule and the pad rounded up to a multiple of process_count: the batches, the
    pad sizes and the shapes are the JAX loader's; ``rebatch`` on a built
    loader gives the partition a loader built with that size has."""
    jl, tl = _sized(batch_size, **kw)
    _assert_same_partition(tl, jl)
    jl2, tl2 = _sized(7, **kw)
    for ld in (jl2, tl2):
        ld.rebatch(batch_size)
    _assert_same_partition(tl2, jl)
    _assert_same_partition(tl2, jl2)
    if kw.get("process_count", 1) > 1:
        assert all(b % kw["process_count"] == 0 for b in tl._pad_bs.values())


def test_rebatch_takes_one_size_a_bucket():
    """Each bucket's chunks take its own size, only its last one shorter;
    every utterance is in one batch."""
    jl, tl = _sized([2, 5, 3], n=40)
    counts = tl.bucket_counts()
    for bi, n in enumerate(counts):
        sizes = [len(c) for b, c in tl._batches if b == bi]
        assert sum(sizes) == n
        if not n:
            continue
        assert all(k == [2, 5, 3][bi] for k in sizes[:-1]) and 0 < sizes[-1] <= [2, 5, 3][bi]
    assert sorted(i for _, c in tl._batches for i in c) == list(range(tl.num_utts))
    with pytest.raises(ValueError, match="batch sizes for 3 buckets"):
        tl.rebatch([2, 5])


@pytest.mark.parametrize("n", [24, 40])
def test_bucket_counts_match_jax(n):
    jl, tl = _sized(4, n=n)
    assert tl.bucket_counts() == jl.bucket_counts()
    assert sum(tl.bucket_counts()) == tl.num_utts == n - tl.skipped


@pytest.mark.parametrize("route,workers,index,count", [
    ("cache", 0, 0, 1), ("cache", 2, 0, 1), ("cache", 0, 1, 2), ("offsets", 0, 0, 1), ("offsets", 2, 1, 2),
])
def test_fill_factor_after_an_epoch_matches_jax(route, workers, index, count):
    """Real samples over the slots' samples of this process's rows over an
    epoch, on the wave cache's route and the device corpus's offsets, as
    the JAX loader counts them; epoch() starts the count anew."""
    jl, tl = _sized(3, process_index=index, process_count=count)
    for ld in (jl, tl):
        ld.num_workers = workers
        if route == "offsets":
            ld.flat_corpus()
    assert tl.fill_factor == jl.fill_factor == 0.0
    tb, jb = list(tl.epoch(1)), list(jl.epoch(1))
    want = sum(int(b.wav_len.sum()) for b in tb) / sum(b.wav_len.shape[0] * b.n_samples for b in tb)
    assert tl.fill_factor == jl.fill_factor == pytest.approx(want, rel=1e-12)
    assert 0.0 < tl.fill_factor < 1.0
    assert (tl.fill_num, tl.fill_den) == (jl.fill_num, jl.fill_den)
    # a new epoch counts from 0: the batches materialised since it began
    # (two without threads; with them, those filled ahead too)
    den = tl.fill_den
    it = tl.epoch(2)
    first = [next(it), next(it)]
    it.close()
    two = sum(b.wav_len.shape[0] * b.n_samples for b in first)
    assert tl.fill_den == two if workers == 0 else two <= tl.fill_den <= den


def test_fill_factor_counts_the_native_pack_batch_route(tmp_path):
    """A wav-file corpus, whose batches one native pack_batch fills: the
    fill factor of an epoch is the JAX loader's."""
    from e2e_asr_tpu.data.dataset import load_dataset as jload
    from e2e_asr_tpu_torch.data.dataset import load_dataset as tload
    from e2e_asr_tpu_torch import native
    from tests.test_torch_native import _libri_data, _wav_tree

    _wav_tree(tmp_path)
    d = _libri_data(tmp_path, buckets=[208, 416, 816], token_buckets=[32, 48, 64])
    calls = []
    real = native.pack_batch
    native.pack_batch = lambda paths, n, *a: calls.append(len(paths)) or real(paths, n, *a)
    try:
        tl = tload(TConfig.from_dict({"data": d}).data, num_workers=0)[0]
        list(tl.epoch(0))
    finally:
        native.pack_batch = real
    jl = jload(JConfig.from_dict({"data": d}).data, num_workers=0)[0]
    list(jl.epoch(0))
    assert calls and tl.fill_factor == jl.fill_factor and 0.0 < tl.fill_factor < 1.0
