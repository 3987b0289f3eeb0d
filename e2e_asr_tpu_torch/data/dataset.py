"""Host-side dataset assembly: manifests -> fixed-shape bucketed batches.

A trimmed copy of ``e2e_asr_tpu/data/dataset.py`` (the port imports nothing
of the JAX package). It keeps the static bucket ladder (every batch padded
to its bucket's (samples, tokens) shape), the HALF_BATCHSIZE_AUDIO_LEN
rule, ``batch_shapes()``, the training schedule (batch order shuffled per
epoch with ``RandomState(seed + epoch)``, a length-ascending curriculum
epoch, ``forever(skip_steps)`` to replay a resumed run's data) and
``load_dataset`` / ``load_eval_datasets``, and ``TextLoader``, the LM's
text batches. Batches are materialised on the calling thread. The
device-resident corpus, the prefetch threads and the audio loader's
multi-process row blocks of the JAX package are not ported yet (ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from e2e_asr_tpu_torch.config import DataConfig
from e2e_asr_tpu_torch.data import corpus as corpus_mod
from e2e_asr_tpu_torch.data import text as text_mod


def quantize_i16(x: np.ndarray) -> np.ndarray:
    """float32 [-1,1) waveform -> int16 PCM (wire/cache format)."""
    return np.clip(x * 32768.0, -32768, 32767).astype(np.int16)


@dataclass
class Batch:
    """Fixed-shape host batch (all numpy)."""

    wav: np.ndarray  # [B, N_bucket] int16 or float32
    wav_len: np.ndarray  # [B] i32
    text: np.ndarray  # [B, L_bucket] i32 (includes <eos>, 0-padded)
    text_len: np.ndarray  # [B] i32 (includes <eos>)
    uids: Tuple[str, ...]


def frames_to_samples(frames: int, win: int, shift: int) -> int:
    return (frames - 1) * shift + win


class BucketedLoader:
    """Bucketing batcher over a manifest."""

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
    ):
        if len(buckets_frames) != len(token_buckets):
            raise ValueError("buckets and token_buckets must have the same length")
        self.tokenizer = tokenizer
        self.buckets_samples = [frames_to_samples(f, win, shift) for f in buckets_frames]
        self.buckets_frames = list(buckets_frames)
        self.token_buckets = list(token_buckets)
        self.wire_dtype = wire_dtype
        self.shuffle = shuffle
        self.ascending = ascending
        self.seed = seed
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

        per_bucket: Dict[int, List[int]] = {}
        for idx, (_, _, bi) in enumerate(self._items):
            per_bucket.setdefault(bi, []).append(idx)
        self._batches: List[Tuple[int, List[int]]] = []
        for bi, idxs in sorted(per_bucket.items()):
            bs = int(batch_size)
            if self.buckets_frames[bi] > half_batch_len:
                bs = max(1, bs // 2)  # ref: HALF_BATCHSIZE_AUDIO_LEN
            for s in range(0, len(idxs), bs):
                self._batches.append((bi, idxs[s : s + bs]))
        # deterministic per-bucket pad size: every batch of a bucket has B rows
        self._pad_bs: Dict[int, int] = {}
        for bi, chunk in self._batches:
            self._pad_bs[bi] = max(self._pad_bs.get(bi, 0), len(chunk))

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

    def batch_shapes(self) -> List[Tuple[int, int, int]]:
        """Distinct (rows, n_samples, l_tokens) batch shapes this loader emits."""
        return sorted(
            {
                (self._pad_bs[bi], self.buckets_samples[bi], self.token_buckets[bi])
                for bi, _ in self._batches
            }
        )

    def _materialize(self, bi: int, idxs: List[int]) -> Batch:
        n_bucket = self.buckets_samples[bi]
        l_bucket = self.token_buckets[bi]
        b = self._pad_bs[bi]
        dt = np.int16 if self.wire_dtype == "int16" else np.float32
        wav = np.zeros((b, n_bucket), dt)
        wav_len = np.zeros((b,), np.int32)
        txt = np.zeros((b, l_bucket), np.int32)
        txt_len = np.zeros((b,), np.int32)
        uids = []
        for j, idx in enumerate(idxs):
            u, ids, _ = self._items[idx]
            x = u.load()
            n = min(len(x), n_bucket)
            # float32 waves pass through int16 too, as the JAX loader's cache does
            q = quantize_i16(x[:n])
            wav[j, :n] = q if dt == np.int16 else q.astype(np.float32) / 32768.0
            wav_len[j] = n
            txt[j, : len(ids)] = ids[:l_bucket]
            txt_len[j] = min(len(ids), l_bucket)
            uids.append(u.uid)
        # batch padding rows keep wav_len=0/text_len=0 => fully masked
        uids += [""] * (b - len(idxs))
        return Batch(wav, wav_len, txt, txt_len, tuple(uids))

    def epoch(
        self, epoch_idx: int = 0, ascending: Optional[bool] = None, skip_first: int = 0
    ) -> Iterator[Batch]:
        """One epoch of batches: duration-ascending, or shuffled per epoch;
        ``skip_first`` batches are skipped without being materialised."""
        order = list(range(len(self._batches)))
        asc = self.ascending if ascending is None else ascending
        if not asc and self.shuffle:
            np.random.RandomState(self.seed + epoch_idx).shuffle(order)
        for oi in order[skip_first:]:
            bi, idxs = self._batches[oi]
            yield self._materialize(bi, idxs)

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


def load_dataset(cfg: DataConfig, ascending: bool = False):
    """(train loader, dev loader, feat_dim, vocab size, tokenizer, msg). The
    train loader shuffles its batches per epoch unless ``ascending``."""
    c = cfg.corpus
    win = int(cfg.audio.sample_rate * cfg.audio.frame_length / 1000)
    shift = int(cfg.audio.sample_rate * cfg.audio.frame_shift / 1000)
    tr_utts = corpus_mod.load_corpus(c.name, c.path, c.train_split)
    dv_utts = corpus_mod.load_corpus(c.name, c.path, c.dev_split)
    tokenizer = build_tokenizer(cfg, tr_utts)
    common = dict(
        buckets_frames=c.buckets, token_buckets=c.token_buckets, win=win, shift=shift,
        half_batch_len=c.half_batch_len, wire_dtype=c.wire_dtype,
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


def load_eval_datasets(cfg: DataConfig, batch_size: Optional[int] = None):
    """Evaluation loaders for BOTH held-out splits (dev_split, test_split).

    The tokenizer is derived from the train split (same derivation as
    training) unless data.text.vocab_file pins it. Returns
    ({split_name: loader}, feat_dim, vocab, tokenizer, msg).
    """
    c = cfg.corpus
    win = int(cfg.audio.sample_rate * cfg.audio.frame_length / 1000)
    shift = int(cfg.audio.sample_rate * cfg.audio.frame_shift / 1000)
    tokenizer = build_tokenizer(cfg, corpus_mod.load_corpus(c.name, c.path, c.train_split))
    bs = c.batch_size if batch_size is None else batch_size
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
            wire_dtype=c.wire_dtype,
        )
        loaders[split_name] = ld
        parts.append(f"{split_name}={ld.num_utts} utts/{len(ld)} batches")
    msg = (
        f"corpus {c.name} eval: {', '.join(parts)}, B={bs}, "
        f"vocab={tokenizer.vocab_size} ({cfg.text.mode})"
    )
    return loaders, cfg.audio.output_dim, tokenizer.vocab_size, tokenizer, msg
