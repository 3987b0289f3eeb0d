"""Typed experiment configuration.

Mirrors the reference's two-tier config design (argparse run flags + YAML
experiment files with ``data:/hparas:/model:/decode:/src:`` sections — ref:
config/libri/asr_example.yaml, main.py:~argparse) so that reference recipes
translate 1:1, but every section is a validated dataclass instead of a raw
dict: typos fail loudly at load time, not at step 10k.
"""

from __future__ import annotations

import dataclasses
import pathlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

import yaml


def _build(cls, d: Optional[Dict[str, Any]], ctx: str):
    """Construct dataclass `cls` from dict `d`, erroring on unknown keys."""
    if d is None:
        d = {}
    if not isinstance(d, dict):
        raise TypeError(f"config section '{ctx}' must be a mapping, got {type(d)}")
    names = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(d) - set(names)
    if unknown:
        raise ValueError(f"unknown config key(s) {sorted(unknown)} in section '{ctx}'")
    kwargs = {}
    for k, v in d.items():
        f = names[k]
        sub = _SUBSECTION.get((cls, k))
        kwargs[k] = _build(sub, v, f"{ctx}.{k}") if sub is not None else v
    return cls(**kwargs)


@dataclass
class CorpusConfig:
    """ref: config data.corpus — corpus/librispeech.py adapter selection."""

    name: str = "librispeech"
    path: str = ""
    train_split: List[str] = field(default_factory=lambda: ["train-clean-100"])
    dev_split: List[str] = field(default_factory=lambda: ["dev-clean"])
    test_split: List[str] = field(default_factory=lambda: ["test-clean"])
    bucketing: bool = True
    batch_size: int = 16
    # fixed-shape length buckets (frames, pre-pyramid). XLA needs static
    # shapes: one executable per bucket instead of the reference's
    # dynamic padding (src/data.py:~collect_audio_batch).
    buckets: List[int] = field(default_factory=lambda: [208, 416, 816, 1632, 3056])
    # max target-token buckets paired by duration; 0 = derive from data
    token_buckets: List[int] = field(default_factory=lambda: [64, 128, 256, 400, 520])
    # reference halves over-long batches (HALF_BATCHSIZE_AUDIO_LEN≈800)
    half_batch_len: int = 800
    # threads that fill batches ahead of the step (bin/train_asr.py and
    # bin/test_asr.py take main.py's --njobs instead); 0 = on the calling
    # thread. Honoured by the port's loader (data/dataset.py epoch).
    num_workers: int = 4
    # The input path's knobs (no reference equivalent: the reference
    # streams float32 tensors through DataLoader workers):
    # wire_dtype: samples cross host->device as int16 PCM (2x fewer bytes,
    # quantization error 3e-5 << feature noise floor) or float32.
    wire_dtype: str = "int16"  # int16 | float32
    # device_cache: keep the ENTIRE training corpus resident in device
    # memory as one flat int16 buffer; each step then copies only [B]
    # offsets and gathers the waves on the device. 'auto' = on when the
    # corpus fits device_cache_bytes. Honoured by the port's
    # bin/train_asr.py (the dev and eval sets stream).
    device_cache: str = "auto"  # auto | on | off
    # Honoured by the port: the 'auto' limit above.
    device_cache_bytes: int = 4 << 30
    # host-side decoded-waveform cache cap (bytes; int16 entries). Honoured
    # by the port's loader (data/dataset.py _cached_wav_i16).
    cache_bytes: int = 2 << 30


@dataclass
class AudioConfig:
    """ref: src/audio.py create_transform kwargs."""

    feat_type: str = "fbank"  # fbank | mfcc | raw
    feat_dim: int = 80
    sample_rate: int = 16000
    frame_length: float = 25.0  # ms
    frame_shift: float = 10.0  # ms
    preemphasis: float = 0.97
    window: str = "povey"  # povey | hamming | hanning
    num_ceps: int = 13  # for mfcc
    low_freq: float = 20.0
    high_freq: float = 0.0  # 0 => nyquist
    apply_cmvn: bool = True
    delta_order: int = 0  # 0..2
    delta_window_size: int = 2
    dither: float = 0.0
    use_pallas: bool = True  # fused Pallas frontend kernel vs pure-XLA oracle

    @property
    def output_dim(self) -> int:
        base = self.num_ceps if self.feat_type == "mfcc" else self.feat_dim
        return base * (self.delta_order + 1)


@dataclass
class TextConfig:
    """ref: src/text.py load_text_encoder."""

    mode: str = "character"  # character | word | subword | bert
    vocab_file: str = ""


@dataclass
class DataConfig:
    corpus: CorpusConfig = field(default_factory=CorpusConfig)
    audio: AudioConfig = field(default_factory=AudioConfig)
    text: TextConfig = field(default_factory=TextConfig)


@dataclass
class HparasConfig:
    """ref: config hparas section — bin/train_asr.py schedules."""

    valid_step: int = 5000
    max_step: int = 100001
    tf_start: float = 1.0
    tf_end: float = 1.0
    tf_step: int = 500000
    optimizer: str = "Adadelta"  # Adadelta | Adam | SGD
    lr: float = 1.0
    eps: float = 1.0e-8
    lr_scheduler: str = "fixed"  # fixed | warmup
    warmup_step: int = 4000
    curriculum: int = 0  # steps of length-ascending batches
    grad_clip: float = 5.0
    seed: int = 0
    # CTC-infeasible utterance policy (label longer than the CTC lattice
    # allows). 'skip' = reference parity: CTCLoss(zero_infinity=False) makes
    # the loss inf -> NaN-skip drops the whole step (ref: bin/train_asr.py:~75,
    # src/solver.py:~backward). 'mask' = drop only the infeasible utterances
    # from the batch mean and train on the rest (TPU-native alternative;
    # useful with static buckets where one outlier would stall a step).
    ctc_infeasible: str = "skip"  # skip | mask
    # TPU-native additions
    dtype: str = "bfloat16"  # compute dtype; params stay f32
    ckpt_step: int = 5000
    log_step: int = 100


@dataclass
class EncoderConfig:
    """ref: src/module.py Encoder — per-layer list config surface."""

    prenet: str = "vgg"  # vgg | vgg2l | cnn | ''
    module: str = "LSTM"  # LSTM | GRU
    bidirection: bool = True
    dim: List[int] = field(default_factory=lambda: [512, 512, 512, 512])
    dropout: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0, 0.0])
    layer_norm: List[bool] = field(default_factory=lambda: [False] * 4)
    proj: List[bool] = field(default_factory=lambda: [True] * 4)
    sample_rate: List[int] = field(default_factory=lambda: [1, 1, 1, 1])
    sample_style: str = "drop"  # drop | concat
    # the stack's output projection: Linear(last layer's width -> out_proj)
    # + tanh over the top layer, re-masked (ESPnet's RNN.l_last, its
    # eprojs); 0 = none. No counterpart in the JAX package
    out_proj: int = 0
    # which kernel pair runs a BiLSTM layer (ops/rnn.py bidir): 'pallas' the
    # fused-projection pair, 'pallas_xw' the lstm_seq pair over projections
    # computed outside, 'auto' an alias of 'pallas_xw' (the faster of the two
    # on the H100 at every input width measured; ops/rnn.py). The JAX
    # package takes the same values through E2E_RNN_IMPL
    rnn_impl: str = "auto"


@dataclass
class AttentionConfig:
    """ref: src/module.py ScaleDotAttention / LocationAwareAttention."""

    mode: str = "location"  # dot | location
    dim: int = 300
    num_head: int = 1
    v_proj: bool = False
    temperature: float = 0.5
    loc_kernel_size: int = 100
    loc_kernel_num: int = 10


@dataclass
class DecoderConfig:
    """ref: src/asr.py Decoder."""

    module: str = "LSTM"  # LSTM | GRU
    dim: int = 512
    layer: int = 1
    dropout: float = 0.0
    # the layer whose previous h is the attention query: 'top' (the JAX
    # package's) or 'first' (ESPnet's z_list[0]); one layer reads the same
    query_layer: str = "top"
    # the speller scan of the training / validation forward (models/asr.py):
    # 'scan' the Python loop over the steps, 'pallas' the fused scan
    # (ops/decoder_cuda.py; raises outside its envelope), 'auto' the fused
    # scan for CUDA tensors inside the envelope and the loop otherwise
    fused_scan: str = "auto"


@dataclass
class EmbRegConfig:
    """ref: src/plugin.py EmbeddingRegularizer (flag-gated plugin)."""

    enable: bool = False
    src: str = ""  # pretrained embedding table (.npy [vocab, dim])
    dim: int = 0
    weight: float = 0.0
    fuse: float = 0.0  # fused-decoding mixing weight (0 = off)
    temperature: float = 1.0
    freeze: bool = True
    distance: str = "CosEmb"


@dataclass
class SpecAugmentConfig:
    enable: bool = False
    freq_mask_num: int = 2
    freq_mask_width: int = 27
    time_mask_num: int = 2
    time_mask_width: int = 100
    time_mask_ratio: float = 1.0


@dataclass
class ModelConfig:
    ctc_weight: float = 0.0
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    emb_reg: EmbRegConfig = field(default_factory=EmbRegConfig)
    specaugment: SpecAugmentConfig = field(default_factory=SpecAugmentConfig)


@dataclass
class DecodeConfig:
    """ref: config decode section — src/decode.py BeamDecoder kwargs."""

    beam_size: int = 8
    min_len_ratio: float = 0.0
    max_len_ratio: float = 1.0
    ctc_weight: float = 0.0
    lm_weight: float = 0.0
    lm_path: str = ""
    lm_config: str = ""
    # TPU-native: decode is batched; ref asserts batch==1 (src/decode.py)
    batch_size: int = 8
    ctc_beam_ratio: float = 1.5  # ref: CTC_BEAM_RATIO const in src/decode.py


@dataclass
class LMConfig:
    """ref: src/lm.py RNNLM + lm yaml."""

    emb_tying: bool = False
    emb_dim: int = 512
    module: str = "LSTM"
    dim: int = 512
    n_layers: int = 2
    dropout: float = 0.2
    batch_size: int = 32


@dataclass
class SrcConfig:
    """ref: decode yaml src section — pointer to train ckpt + its config."""

    ckpt: str = ""
    config: str = ""


@dataclass
class ParallelConfig:
    """Data parallelism over processes (``parallel/dist.py``, ``main
    --multihost``): ``dp`` ranks on the data axis (-1: the world size; any
    other value than the world size raises), ``mp`` the model axis, which
    must be 1 (``dist.check_config``)."""

    dp: int = -1  # -1 => every rank on the data axis
    mp: int = 1  # model axis: 1 (no model parallelism)


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    hparas: HparasConfig = field(default_factory=HparasConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    lm: LMConfig = field(default_factory=LMConfig)
    src: SrcConfig = field(default_factory=SrcConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        return _build(Config, d, "config")

    @staticmethod
    def load(path: Union[str, pathlib.Path]) -> "Config":
        with open(path) as f:
            return Config.from_dict(yaml.safe_load(f) or {})

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def save(self, path: Union[str, pathlib.Path]) -> None:
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)


# nested-section registry for _build
_SUBSECTION = {
    (Config, "data"): DataConfig,
    (Config, "hparas"): HparasConfig,
    (Config, "model"): ModelConfig,
    (Config, "decode"): DecodeConfig,
    (Config, "lm"): LMConfig,
    (Config, "src"): SrcConfig,
    (Config, "parallel"): ParallelConfig,
    (DataConfig, "corpus"): CorpusConfig,
    (DataConfig, "audio"): AudioConfig,
    (DataConfig, "text"): TextConfig,
    (ModelConfig, "encoder"): EncoderConfig,
    (ModelConfig, "attention"): AttentionConfig,
    (ModelConfig, "decoder"): DecoderConfig,
    (ModelConfig, "emb_reg"): EmbRegConfig,
    (ModelConfig, "specaugment"): SpecAugmentConfig,
}
