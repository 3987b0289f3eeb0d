"""Host-side dataset assembly: manifests -> fixed-shape bucketed batches.

A trimmed copy of ``e2e_asr_tpu/data/dataset.py`` (the port imports nothing
of the JAX package). It keeps the static bucket ladder (every batch padded
to its bucket's (samples, tokens) shape), the HALF_BATCHSIZE_AUDIO_LEN
rule, ``batch_shapes()``, the training schedule (batch order shuffled per
epoch with ``RandomState(seed + epoch)``, a length-ascending curriculum
epoch, ``forever(skip_steps)`` to replay a resumed run's data),
``load_dataset`` / ``load_eval_datasets``, and ``TextLoader``, the LM's
text batches.

The input path's throughput half is the JAX loader's too: an int16 wave
cache (``cache_bytes``), batches filled by ``num_workers`` threads in
order, and the device-resident corpus (``flat_corpus()``: every wave in
one int16 buffer, after which batches carry sample offsets into it and the
step gathers the waves on the device, ``training/step.py``
``resolve_wav``). ``data/prefetch.py`` copies batches to the device ahead
of the step.

Data parallelism (``parallel/dist.py``): with ``process_count`` > 1 both
loaders keep the global schedule (every process walks, buckets and
shuffles the whole manifest alike, so that step k's batch has one shape on
every process), round each bucket's batch up to a multiple of
``process_count``, and process ``process_index`` materialises only its
contiguous block of rows: the other blocks' waves are never read.
``batch_shapes()`` reports local rows. ``BucketedLoader.epoch(shard=(i,
n))`` instead takes every n-th batch from the i-th, chosen before any is
materialised (the sharded decode).

Sizing: ``rebatch(batch_size)`` re-partitions the batches for one batch
size or one a bucket (the constructor calls it), ``bucket_counts()``
gives the utterances a bucket, and ``fill_factor`` the share of the materialised slots' samples
that is audio since the last ``epoch()`` began, on every route (the wave
cache, ``pack_batch``, the device corpus's offsets).

Waves reach a streaming batch by one of two routes, the JAX loader's
routing: when every row of the process's block is backed by a wav file,
one native ``pack_batch`` call (``native.py``: C++ threads decode and pad
the rows, no GIL) fills the block, passed through int16 as the cache route
passes every wave, so that the batch is bitwise the cache route's; else
each row comes from the int16 wave cache. A file that cannot be decoded
raises on either route: neither gives way to the other.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from e2e_asr_tpu_torch import native
from e2e_asr_tpu_torch.config import DataConfig
from e2e_asr_tpu_torch.data import corpus as corpus_mod
from e2e_asr_tpu_torch.data import text as text_mod


def quantize_i16(x: np.ndarray) -> np.ndarray:
    """float32 [-1,1) waveform -> int16 PCM (wire/cache format)."""
    return np.clip(x * 32768.0, -32768, 32767).astype(np.int16)


@dataclass
class Batch:
    """Fixed-shape host batch (all numpy).

    Two forms: streaming (``wav`` filled, int16 PCM or float32) or offsets
    (``wav`` None, ``wav_off`` filled: each row's sample offset into the
    device-resident flat corpus, ``n_samples`` the bucket's length; the
    step gathers the waves on the device)."""

    wav: Optional[np.ndarray]  # [B, N_bucket] int16 or float32, or None (offsets)
    wav_len: np.ndarray  # [B] i32
    text: np.ndarray  # [B, L_bucket] i32 (includes <eos>, 0-padded)
    text_len: np.ndarray  # [B] i32 (includes <eos>)
    uids: Tuple[str, ...]
    wav_off: Optional[np.ndarray] = None  # [B] i32 (offsets form)
    n_samples: int = 0  # bucket length in samples (offsets form)


def frames_to_samples(frames: int, win: int, shift: int) -> int:
    return (frames - 1) * shift + win


class BucketedLoader:
    """Bucketing batcher over a manifest, with an int16 wave cache, batches
    filled by ``num_workers`` threads (0: on the calling thread), an
    optional device-resident corpus (``flat_corpus``) and process
    ``process_index``'s row block of each batch of ``process_count``."""

    def __init__(
        self,
        utts: List[corpus_mod.Utterance],
        tokenizer: text_mod.TextEncoder,
        batch_size: int,
        buckets_frames: Sequence[int],
        token_buckets: Sequence[int],
        win: int,
        shift: int,
        half_batch_len: int = 800,
        wire_dtype: str = "int16",
        shuffle: bool = False,
        ascending: bool = False,
        seed: int = 0,
        num_workers: int = 2,
        cache_bytes: int = 2 << 30,
        process_index: int = 0,
        process_count: int = 1,
    ):
        if len(buckets_frames) != len(token_buckets):
            raise ValueError("buckets and token_buckets must have the same length")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} outside process_count {process_count}")
        self.process_index = process_index
        self.process_count = process_count
        self.tokenizer = tokenizer
        self.buckets_samples = [frames_to_samples(f, win, shift) for f in buckets_frames]
        self.buckets_frames = list(buckets_frames)
        self.token_buckets = list(token_buckets)
        self.wire_dtype = wire_dtype
        self.shuffle = shuffle
        self.ascending = ascending
        self.seed = seed
        self.num_workers = num_workers
        self.emit_offsets = False  # set by flat_corpus()
        self._flat_offsets: Optional[np.ndarray] = None
        # int16 waves by item index, up to cache_bytes: an utterance is
        # loaded (decoded or synthesised) once, not once an epoch
        self._wav_cache: Dict[int, np.ndarray] = {}
        self._cache_used = 0
        self._cache_cap = cache_bytes
        self._cache_lock = threading.Lock()
        self._items = []
        skipped = 0
        for u in utts:
            ids = tokenizer.encode(u.text)
            bi = self._bucket_index(u.n_samples, len(ids))
            if bi is None:
                skipped += 1
                continue
            self._items.append((u, ids, bi))
        self.skipped = skipped
        self._items.sort(key=lambda it: it[0].n_samples)
        self._half_batch_len = half_batch_len
        self.rebatch(batch_size)
        # pad counters: real samples against the slots' samples of the
        # batches materialised since the last epoch() began (fill_factor)
        self._fill_lock = threading.Lock()
        self.fill_num = 0
        self.fill_den = 0

    def rebatch(self, batch_size) -> None:
        """(Re)compute the batch partition for new batch sizes without
        re-tokenising the manifest. ``batch_size``: one int for every bucket,
        or a list with one per bucket. A bucket longer than
        ``half_batch_len`` frames takes half its size (HALF_BATCHSIZE_AUDIO_LEN). Every
        batch of a bucket is padded to the bucket's largest, rounded up to a
        multiple of ``process_count`` (alike on every process: the manifest
        is not sharded)."""
        per_bucket: Dict[int, List[int]] = {}
        for idx, (_, _, bi) in enumerate(self._items):
            per_bucket.setdefault(bi, []).append(idx)
        if isinstance(batch_size, (list, tuple)):
            if len(batch_size) != len(self.buckets_frames):
                raise ValueError(f"{len(batch_size)} batch sizes for {len(self.buckets_frames)} buckets")
            bs_per_bucket = [int(x) for x in batch_size]
        else:
            bs_per_bucket = [int(batch_size)] * len(self.buckets_frames)
        self._batches: List[Tuple[int, List[int]]] = []
        for bi, idxs in sorted(per_bucket.items()):
            bs = bs_per_bucket[bi]
            if self.buckets_frames[bi] > self._half_batch_len:
                bs = max(1, bs // 2)  # ref: HALF_BATCHSIZE_AUDIO_LEN
            for s in range(0, len(idxs), bs):
                self._batches.append((bi, idxs[s : s + bs]))
        self._pad_bs: Dict[int, int] = {}
        for bi, chunk in self._batches:
            self._pad_bs[bi] = max(self._pad_bs.get(bi, 0), len(chunk))
        p = self.process_count
        for bi in self._pad_bs:
            self._pad_bs[bi] = ((self._pad_bs[bi] + p - 1) // p) * p

    def _bucket_index(self, n_samples: int, n_tokens: int) -> Optional[int]:
        for i, (bs, tb) in enumerate(zip(self.buckets_samples, self.token_buckets)):
            if n_samples <= bs and n_tokens <= tb:
                return i
        return None

    def __len__(self) -> int:
        return len(self._batches)

    @property
    def num_utts(self) -> int:
        return len(self._items)

    def bucket_counts(self) -> List[int]:
        """Utterances assigned to each bucket (a batch size that does not
        divide a bucket's count pads its last chunk with empty rows)."""
        out = [0] * len(self.buckets_frames)
        for _, _, bi in self._items:
            out[bi] += 1
        return out

    @property
    def fill_factor(self) -> float:
        """Real samples over the slots' samples of the batches materialised
        since the last ``epoch()`` began (this process's rows): the share of
        a batch that is audio, not padding."""
        with self._fill_lock:
            return self.fill_num / max(self.fill_den, 1)

    def batch_shapes(self) -> List[Tuple[int, int, int]]:
        """Distinct (local rows, n_samples, l_tokens) batch shapes this loader emits."""
        return sorted(
            {
                (self._pad_bs[bi] // self.process_count, self.buckets_samples[bi], self.token_buckets[bi])
                for bi, _ in self._batches
            }
        )

    def _cached_wav_i16(self, idx: int) -> np.ndarray:
        """Item ``idx``'s whole wave as int16, loaded once while the cache
        has room (float32 waves pass through int16, as in the JAX loader)."""
        x = self._wav_cache.get(idx)
        if x is None:
            x = quantize_i16(self._items[idx][0].load())
            with self._cache_lock:
                if idx not in self._wav_cache and self._cache_used + x.nbytes <= self._cache_cap:
                    self._wav_cache[idx] = x
                    self._cache_used += x.nbytes
        return x

    def _materialize(self, bi: int, idxs: List[int]) -> Batch:
        n_bucket = self.buckets_samples[bi]
        l_bucket = self.token_buckets[bi]
        b = self._pad_bs[bi]
        if self.process_count > 1:
            # this process's contiguous row block of the global batch
            b //= self.process_count
            idxs = idxs[self.process_index * b : (self.process_index + 1) * b]
        wav = wav_off = None
        wav_len = np.zeros((b,), np.int32)
        if self.emit_offsets:
            # the waves live on the device already: ship offsets
            wav_off = np.zeros((b,), np.int32)
            for j, idx in enumerate(idxs):
                wav_off[j] = self._flat_offsets[idx]
                wav_len[j] = min(self._items[idx][0].n_samples, n_bucket)
        else:
            dt = np.int16 if self.wire_dtype == "int16" else np.float32
            wav = np.zeros((b, n_bucket), dt)
            utts = [self._items[idx][0] for idx in idxs]
            if utts and all(u.wav_path for u in utts):
                packed, lens = native.pack_batch([u.wav_path for u in utts], n_bucket)
                packed = quantize_i16(packed)
                wav[: len(utts)] = packed if dt == np.int16 else packed.astype(np.float32) / 32768.0
                wav_len[: len(utts)] = lens
            else:
                for j, idx in enumerate(idxs):
                    x = self._cached_wav_i16(idx)
                    n = min(len(x), n_bucket)
                    wav[j, :n] = x[:n] if dt == np.int16 else x[:n].astype(np.float32) / 32768.0
                    wav_len[j] = n
        txt = np.zeros((b, l_bucket), np.int32)
        txt_len = np.zeros((b,), np.int32)
        uids = []
        for j, idx in enumerate(idxs):
            u, ids, _ = self._items[idx]
            txt[j, : len(ids)] = ids[:l_bucket]
            txt_len[j] = min(len(ids), l_bucket)
            uids.append(u.uid)
        # batch padding rows keep wav_len=0/text_len=0 => fully masked
        uids += [""] * (b - len(idxs))
        with self._fill_lock:
            self.fill_num += int(wav_len.sum())
            self.fill_den += b * n_bucket
        return Batch(wav, wav_len, txt, txt_len, tuple(uids), wav_off, n_bucket)

    # ------------------------------------------------- device-resident corpus
    @property
    def total_wav_bytes(self) -> int:
        """int16 bytes of every utterance: the device memory of flat_corpus()."""
        return sum(it[0].n_samples * 2 for it in self._items)

    @property
    def flat_corpus_fits(self) -> bool:
        """True iff the flat corpus (+ tail pad) is addressable with int32
        sample offsets; check it before choosing the device corpus."""
        total = sum(it[0].n_samples for it in self._items) + max(self.buckets_samples)
        return total < (1 << 31)

    def _corpus_cache_path(self, total: int) -> Optional[str]:
        """``$E2E_CORPUS_CACHE/flat_<sig>.npy`` (None without the variable):
        the flat buffer on disk, addressed by the manifest (uids, lengths,
        the total) and the first utterance's int16 wave, as the JAX loader
        addresses it, so that both packages share one file."""
        cache_dir = os.environ.get("E2E_CORPUS_CACHE", "")
        if not cache_dir:
            return None
        sig = hashlib.sha1()
        for it in self._items:
            sig.update(it[0].uid.encode())
            sig.update(str(it[0].n_samples).encode())
        sig.update(str(total).encode())
        if self._items:
            # uids and lengths alone do not tell codings of one synthetic
            # manifest apart (char vs formant): fold in one wave
            sig.update(quantize_i16(self._items[0][0].load()).tobytes())
        return os.path.join(cache_dir, f"flat_{sig.hexdigest()[:16]}.npy")

    def flat_corpus(self) -> Tuple[np.ndarray, np.ndarray]:
        """Every wave in one int16 buffer, (flat [total] int16, offsets
        [num_utts] int32), the tail padded by the largest bucket so that a
        bucket-long slice from any offset stays inside it. Switches the
        loader to offsets batches and clears the per-utterance cache, which
        the buffer supersedes."""
        if not self.flat_corpus_fits:
            raise ValueError("corpus too large for int32 sample offsets (check flat_corpus_fits)")
        lens = np.asarray([it[0].n_samples for it in self._items], np.int64)
        total = int(lens.sum()) + max(self.buckets_samples)
        offs = np.zeros(len(lens), np.int64)
        if len(lens) > 1:
            np.cumsum(lens[:-1], out=offs[1:])
        cache_path = self._corpus_cache_path(total)
        flat = None
        if cache_path and os.path.isfile(cache_path):
            flat = np.load(cache_path)
            if flat.shape != (total,) or flat.dtype != np.int16:
                flat = None
        if flat is None:
            flat = np.zeros(total, np.int16)

            def fill(idx):
                x = self._cached_wav_i16(idx)
                n = min(len(x), int(lens[idx]))
                flat[int(offs[idx]) : int(offs[idx]) + n] = x[:n]

            with ThreadPoolExecutor(max_workers=max(self.num_workers, 4)) as ex:
                list(ex.map(fill, range(len(self._items))))
            if cache_path:
                os.makedirs(os.path.dirname(cache_path), exist_ok=True)
                tmp = cache_path + f".tmp{os.getpid()}.npy"
                np.save(tmp, flat)
                os.replace(tmp, cache_path)
        self._flat_offsets = offs.astype(np.int32)
        self.emit_offsets = True
        with self._cache_lock:
            self._wav_cache.clear()
            self._cache_used = 0
        return flat, self._flat_offsets

    def epoch(
        self, epoch_idx: int = 0, ascending: Optional[bool] = None, skip_first: int = 0,
        shard: Tuple[int, int] = (0, 1),
    ) -> Iterator[Batch]:
        """One epoch of batches: duration-ascending, or shuffled per epoch;
        ``skip_first`` batches are skipped without being materialised;
        ``shard`` (i, n) keeps batches i, i + n, i + 2n, ... of what is left,
        chosen before any is materialised. With ``num_workers`` > 0 that many
        threads fill batches ahead, up to ``num_workers + 2`` in flight,
        yielded in order."""
        order = list(range(len(self._batches)))
        asc = self.ascending if ascending is None else ascending
        if not asc and self.shuffle:
            np.random.RandomState(self.seed + epoch_idx).shuffle(order)
        order = order[skip_first:][shard[0]::shard[1]]
        with self._fill_lock:
            self.fill_num = self.fill_den = 0
        if self.num_workers <= 0:
            for oi in order:
                yield self._materialize(*self._batches[oi])
            return
        depth = self.num_workers + 2
        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            it = iter(order)
            futs = deque(ex.submit(self._materialize, *self._batches[oi])
                         for oi in itertools.islice(it, depth))
            try:
                while futs:
                    f = futs.popleft()
                    for oi in itertools.islice(it, 1):
                        futs.append(ex.submit(self._materialize, *self._batches[oi]))
                    yield f.result()
            finally:
                # a consumer that stops early: do not fill what it will not read
                for f in futs:
                    f.cancel()

    def forever(
        self, start_epoch: int = 0, curriculum_epochs: int = 0, skip_steps: int = 0
    ) -> Iterator[Batch]:
        """Endless step-based iteration; ``skip_steps`` fast-forwards past the
        batches a resumed run already consumed."""
        n = max(len(self._batches), 1)
        e = start_epoch + skip_steps // n
        skip = skip_steps % n
        while True:
            yield from self.epoch(e, ascending=(e < curriculum_epochs), skip_first=skip)
            skip = 0
            e += 1


class TextLoader:
    """LM batches in fixed-shape token buckets (the JAX ``TextLoader``).

    Each utterance's ids (with <eos>) go to the first bucket that holds
    them (longer ones are dropped); within a bucket, sorted by length, runs
    of ``batch_size`` make the batches. Every batch of a bucket is padded to
    the bucket's largest batch, rounded up to a multiple of
    ``process_count``, and process ``process_index`` takes its block of
    rows, so that every process sees the same number of batches of the
    same shapes. ``epoch(e)`` shuffles the batch order with
    ``RandomState(seed + e)`` when ``shuffle``."""

    def __init__(
        self,
        utts: List[corpus_mod.Utterance],
        tokenizer: text_mod.TextEncoder,
        batch_size: int,
        token_buckets: Sequence[int] = (32, 64, 128, 256, 512),
        shuffle: bool = True,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.process_index = process_index
        self.process_count = process_count
        self.token_buckets = list(token_buckets)
        items: List[Tuple[List[int], int]] = []
        for u in utts:
            ids = tokenizer.encode(u.text)
            for i, tb in enumerate(self.token_buckets):
                if len(ids) <= tb:
                    items.append((ids, i))
                    break
        items.sort(key=lambda it: len(it[0]))
        per_bucket: Dict[int, List[List[int]]] = {}
        for ids, bi in items:
            per_bucket.setdefault(bi, []).append(ids)
        self._batches: List[Tuple[int, List[List[int]]]] = []
        for bi, seqs in sorted(per_bucket.items()):
            for s in range(0, len(seqs), batch_size):
                self._batches.append((bi, seqs[s : s + batch_size]))
        self.shuffle = shuffle
        self.seed = seed
        self.batch_size = batch_size
        self._pad_bs: Dict[int, int] = {}
        for bi, seqs in self._batches:
            self._pad_bs[bi] = max(self._pad_bs.get(bi, 0), len(seqs))
        for bi in self._pad_bs:
            self._pad_bs[bi] = ((self._pad_bs[bi] + process_count - 1) // process_count) * process_count

    def __len__(self) -> int:
        return len(self._batches)

    def epoch(self, epoch_idx: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """{"text": [B, L] int32 (0-padded), "text_len": [B] int32} per batch."""
        order = list(range(len(self._batches)))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch_idx).shuffle(order)
        for oi in order:
            bi, seqs = self._batches[oi]
            b = self._pad_bs[bi]
            if self.process_count > 1:
                rpp = b // self.process_count
                seqs = seqs[self.process_index * rpp : (self.process_index + 1) * rpp]
                b = rpp
            length = self.token_buckets[bi]
            txt = np.zeros((b, length), np.int32)
            txt_len = np.zeros((b,), np.int32)
            for j, ids in enumerate(seqs):
                txt[j, : len(ids)] = ids[:length]
                txt_len[j] = min(len(ids), length)
            yield {"text": txt, "text_len": txt_len}

    def forever(self) -> Iterator[Dict[str, np.ndarray]]:
        e = 0
        while True:
            yield from self.epoch(e)
            e += 1


def build_tokenizer(cfg: DataConfig, utts: List[corpus_mod.Utterance]) -> text_mod.TextEncoder:
    """Load tokenizer from vocab_file, or derive one from the corpus."""
    mode, vocab = cfg.text.mode, cfg.text.vocab_file
    if vocab:
        return text_mod.load_text_encoder(mode, vocab)
    texts = [u.text for u in utts]
    if mode == "character":
        return text_mod.CharacterTextEncoder.from_corpus(texts)
    if mode == "word":
        return text_mod.WordTextEncoder.from_corpus(texts)
    if mode == "subword":
        return text_mod.SubwordTextEncoder.train(texts, vocab_size=500)
    if mode == "bert":
        return text_mod.BertTextEncoder.from_corpus(texts)
    raise ValueError(f"unknown text mode {mode}")


def load_dataset(cfg: DataConfig, ascending: bool = False, num_workers: Optional[int] = None,
                 process_index: int = 0, process_count: int = 1):
    """(train loader, dev loader, feat_dim, vocab size, tokenizer, msg). The
    train loader shuffles its batches per epoch unless ``ascending``;
    ``num_workers`` None takes ``data.corpus.num_workers``; both loaders
    give process ``process_index`` its row block of every batch of
    ``process_count``."""
    c = cfg.corpus
    win = int(cfg.audio.sample_rate * cfg.audio.frame_length / 1000)
    shift = int(cfg.audio.sample_rate * cfg.audio.frame_shift / 1000)
    tr_utts = corpus_mod.load_corpus(c.name, c.path, c.train_split)
    dv_utts = corpus_mod.load_corpus(c.name, c.path, c.dev_split)
    tokenizer = build_tokenizer(cfg, tr_utts)
    common = dict(
        buckets_frames=c.buckets, token_buckets=c.token_buckets, win=win, shift=shift,
        half_batch_len=c.half_batch_len, wire_dtype=c.wire_dtype, cache_bytes=c.cache_bytes,
        num_workers=c.num_workers if num_workers is None else num_workers,
        process_index=process_index, process_count=process_count,
    )
    tr = BucketedLoader(tr_utts, tokenizer, c.batch_size, shuffle=not ascending,
                        ascending=ascending, **common)
    dv = BucketedLoader(dv_utts, tokenizer, c.batch_size, **common)
    msg = (
        f"corpus {c.name}: {tr.num_utts} train / {dv.num_utts} dev utts "
        f"({tr.skipped}+{dv.skipped} over-bucket skipped), "
        f"{len(tr)}/{len(dv)} batches, vocab={tokenizer.vocab_size} ({cfg.text.mode})"
    )
    return tr, dv, cfg.audio.output_dim, tokenizer.vocab_size, tokenizer, msg


def load_eval_datasets(cfg: DataConfig, batch_size: Optional[int] = None,
                       num_workers: Optional[int] = None):
    """Evaluation loaders for BOTH held-out splits (dev_split, test_split).

    The tokenizer is derived from the train split (same derivation as
    training) unless data.text.vocab_file pins it; ``num_workers`` None
    takes ``data.corpus.num_workers``. Returns
    ({split_name: loader}, feat_dim, vocab, tokenizer, msg).
    """
    c = cfg.corpus
    win = int(cfg.audio.sample_rate * cfg.audio.frame_length / 1000)
    shift = int(cfg.audio.sample_rate * cfg.audio.frame_shift / 1000)
    tokenizer = build_tokenizer(cfg, corpus_mod.load_corpus(c.name, c.path, c.train_split))
    bs = c.batch_size if batch_size is None else batch_size
    nw = c.num_workers if num_workers is None else num_workers
    loaders: Dict[str, BucketedLoader] = {}
    parts = []
    for split_name, splits in (("dev", c.dev_split), ("test", c.test_split)):
        if not splits:
            continue
        utts = corpus_mod.load_corpus(c.name, c.path, splits)
        ld = BucketedLoader(
            utts, tokenizer, bs,
            buckets_frames=c.buckets, token_buckets=c.token_buckets,
            win=win, shift=shift, half_batch_len=c.half_batch_len,
            wire_dtype=c.wire_dtype, num_workers=nw, cache_bytes=c.cache_bytes,
        )
        loaders[split_name] = ld
        parts.append(f"{split_name}={ld.num_utts} utts/{len(ld)} batches")
    msg = (
        f"corpus {c.name} eval: {', '.join(parts)}, B={bs}, "
        f"vocab={tokenizer.vocab_size} ({cfg.text.mode})"
    )
    return loaders, cfg.audio.output_dim, tokenizer.vocab_size, tokenizer, msg
