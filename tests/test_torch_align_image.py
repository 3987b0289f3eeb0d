"""Validation's attention-alignment image (``align_image.py``,
``bin/train_asr.py`` ``dev_epoch`` / ``validate``) on the CPU.

- ``align_to_image`` is the JAX package's colour map
  (``e2e_asr_tpu/utils/misc.py``), bit for bit; ``write_png`` / ``read_png``
  round-trip an image, and its bytes decode as a PNG with zlib alone.
- ``validate`` writes ``att_align_<step>.png`` beside ``scalars.jsonl``, a
  line there names it, and the file holds ``align_to_image`` of the first
  dev batch's first valid utterance's greedy alignment, which matches the
  JAX greedy decode's on the same weights and features (rtol 1e-4, atol
  1e-5).
"""

import json
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from e2e_asr_tpu.decode import greedy as jgreedy
from e2e_asr_tpu.utils.misc import align_to_image as jalign_to_image
from e2e_asr_tpu_torch import convert
from e2e_asr_tpu_torch.align_image import align_to_image, png_bytes, read_png, write_png
from e2e_asr_tpu_torch.decode import greedy as tgreedy
from e2e_asr_tpu_torch.ops.frontend import compute_features
from tests.test_torch_eval_graph import _solver

torch.set_num_threads(1)


def test_align_to_image_is_the_jax_colour_map_and_the_png_round_trips(tmp_path):
    rng = np.random.RandomState(0)
    a = rng.rand(7, 11).astype(np.float32)
    img = align_to_image(a)
    np.testing.assert_array_equal(img, jalign_to_image(a))
    assert img.shape == (7, 11, 3) and img.dtype == np.uint8
    path = str(tmp_path / "a.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)
    data = png_bytes(img)
    w, h = struct.unpack(">II", data[16:24])
    assert (w, h) == (11, 7) and data[12:16] == b"IHDR" and data[-8:-4] == b"IEND"
    n = struct.unpack(">I", data[33:37])[0]
    raw = zlib.decompress(data[41:41 + n])
    assert len(raw) == 7 * (1 + 11 * 3)


def test_validate_writes_the_first_valid_utterance_alignment(tmp_path):
    solver = _solver(tmp_path, "align", dev_utts=6)
    from e2e_asr_tpu.config import Config as JConfig
    from e2e_asr_tpu.models import asr as jasr
    from e2e_asr_tpu_torch.bin.train_asr import DEV_STEP_RATIO

    d = solver.config.to_dict()
    for section, key in (("encoder", "rnn_impl"), ("encoder", "out_proj"), ("decoder", "query_layer")):
        d["model"][section].pop(key)  # the port's keys alone
    jc = JConfig.from_dict(d)
    jp, _ = jasr.asr_init(jax.random.PRNGKey(3), solver.feat_dim, solver.vocab_size, jc.model)
    solver.state = solver.trainer.init_state(convert.params_from_jax(jax.device_get(jp)))
    solver.step = 7
    solver.validate()
    lines = [json.loads(x) for x in open(os.path.join(solver.logdir, "scalars.jsonl"))]
    names = [x["value"] for x in lines if x["tag"] == "att_align"]
    assert names == ["att_align_00000007.png"]
    img = read_png(os.path.join(solver.logdir, names[0]))

    batch = next(iter(solver.dv_set.epoch()))
    max_step = int(batch.text.shape[1] * DEV_STEP_RATIO)
    feat, feat_len = compute_features(torch.from_numpy(batch.wav), torch.from_numpy(batch.wav_len),
                                      solver.config.data.audio)
    _, align = tgreedy.greedy_decode(solver.state.params, solver.config.model, feat, feat_len, max_step)
    i = int(np.argmax(batch.text_len > 0))
    np.testing.assert_array_equal(img, align_to_image(align[i, :, 0, :].numpy()))
    assert img.shape == (max_step, align.shape[-1], 3)
    _, jalign = jgreedy.greedy_decode(jp, jc.model, jnp.asarray(feat.numpy()), jnp.asarray(feat_len.numpy()),
                                      max_step)
    np.testing.assert_allclose(align.numpy(), np.asarray(jalign), rtol=1e-4, atol=1e-5)
