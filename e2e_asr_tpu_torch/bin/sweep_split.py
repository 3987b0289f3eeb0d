"""Where a step of the LSTM backward sweep goes, by ablation, on the card.

    python -m e2e_asr_tpu_torch.bin.sweep_split [--out PATH]

Builds variants of csrc/lstm_bidir_bwd.cu with one part of the step compiled
out (their gradients are wrong; only their times count) into
``_build/sweep_split/`` and times each variant's sweep launch (CUDA events,
10 launches) at the flagship's layer (T=204, B=16, H=320) and the
convergence recipe's first layer (T=816, B=32, H=256), both directions:

- ``full``: the kernel as built for the port;
- ``no_grid``: no grid barrier a step;
- ``no_stage``: no copy of the step's dgates into shared memory;
- ``no_product``: no tensor-core product (dgates Wh^T);
- ``elementwise``: none of the three: the gate gradients, their stores,
  the next step's loads and the reduction.

The time a part's removal saves, a step, splits the step (the parts overlap
in part, so the savings need not add up to the whole). Needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

from e2e_asr_tpu_torch import cuda_build
from e2e_asr_tpu_torch.ops import rnn_cuda

# the define that compiles a part out: (its first line in the source, a
# block whole or one statement)
CUTS = {
    "NO_GRID": ("    grid.sync();  // every block's dgates of step k are in dg\n", "statement"),
    "NO_STAGE": ("    for (int i = tid; i < nb * (G / 4); i += SW_NT) {\n", "block"),
    "NO_PRODUCT": ("    for (int c0 = warp; c0 < G / 16; c0 += 2 * SW_NW) {\n", "block"),
}
VARIANTS = {"full": (), "no_grid": ("NO_GRID",), "no_stage": ("NO_STAGE",), "no_product": ("NO_PRODUCT",),
            "elementwise": ("NO_GRID", "NO_STAGE", "NO_PRODUCT")}
SHAPES = ((204, 16, 320), (816, 32, 256))


def _block_end(src: str, start: int) -> int:
    """Index just past the brace that closes the block opened on the line at ``start``."""
    depth = 0
    i = src.index("{", start)
    while True:
        if src[i] == "{":
            depth += 1
        elif src[i] == "}":
            depth -= 1
            if depth == 0:
                return src.index("\n", i) + 1
        i += 1


def ablated_source() -> str:
    """The sweep's source with each cut wrapped in ``#ifndef <define>``."""
    with open(os.path.join(cuda_build.CSRC_DIR, "lstm_bidir_bwd.cu")) as f:
        src = f.read()
    for define, (marker, kind) in CUTS.items():
        if src.count(marker) != 1:
            raise RuntimeError(f"sweep_split: the source no longer has one {define} marker")
        start = src.index(marker)
        end = start + len(marker) if kind == "statement" else _block_end(src, start)
        src = src[:start] + f"#ifndef {define}\n" + src[start:end] + "#endif\n" + src[end:]
    return src


def build(out_dir: str) -> dict:
    """One library a variant, compiled in parallel; {variant: path}."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "sweep.cu"), "w") as f:
        f.write(ablated_source())
    with open(os.path.join(cuda_build.CSRC_DIR, "tf32_mma.cuh")) as f, \
            open(os.path.join(out_dir, "tf32_mma.cuh"), "w") as g:
        g.write(f.read())
    procs, paths = {}, {}
    for name, defines in VARIANTS.items():
        paths[name] = os.path.join(out_dir, f"{name}.so")
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *[f"-D{d}" for d in defines], "-o", paths[name],
               os.path.join(out_dir, "sweep.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for name, proc in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"sweep variant {name} failed to build:\n{log}")
    return paths


def time_variant(path: str, t: int, b: int, h: int, iters: int = 10) -> float:
    """ms a sweep launch of the variant at (T, B, H), two directions, every
    row valid."""
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    r = 2 * b
    mask = torch.ones((t, r), device=dev)
    wh = torch.randn((2, h, 4 * h), generator=gen, device=dev) / h ** 0.5
    c = torch.randn((t, r, h), generator=gen, device=dev)
    acts = torch.rand((t, r, 4 * h), generator=gen, device=dev)
    dy = torch.randn((t, r, h), generator=gen, device=dev)
    dg = torch.empty((t, r, 4 * h), device=dev)
    nt, w_smem, smem, _ = rnn_cuda.sweep_grid(t, b, 2, h, dev)
    lib = ctypes.CDLL(path)
    fn = lib.e2e_lstm_bwd_sweep
    fn.restype = ctypes.c_int

    def run():
        args = [ctypes.c_void_p(x.data_ptr()) for x in (mask, wh, c, acts, dy, dg)]
        args += [ctypes.c_int(v) for v in (t, b, 2, h, 1, nt, w_smem, smem)]
        args.append(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        err = fn(*args)
        if err:
            raise RuntimeError(f"sweep variant launch failed: error {err}")

    run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="JSON result (default: _build/sweep_split.json)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_split: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    paths = build(os.path.join(cuda_build.BUILD_DIR, "sweep_split"))
    result = {"card": card, "shapes": {}}
    for t, b, h in SHAPES:
        ms = {name: time_variant(path, t, b, h) for name, path in paths.items()}
        us = {name: v / t * 1e3 for name, v in ms.items()}
        split = {
            "grid barrier": us["full"] - us["no_grid"],
            "dgates staging": us["full"] - us["no_stage"],
            "product": us["full"] - us["no_product"],
            "gate gradients, stores, next loads, reduction": us["elementwise"],
        }
        grid = dict(zip(("row_tiles", "wh_in_smem", "smem", "blocks"),
                        rnn_cuda.sweep_grid(t, b, 2, h, torch.device("cuda", torch.cuda.current_device()))))
        result["shapes"][f"T{t}_B{b}_H{h}"] = {"ms": ms, "us_per_step": us, "split_us": split, "grid": grid}
        print(f"{card}: sweep T={t} B={b} H={h} grid {grid}: "
              + "; ".join(f"{n} {v:.3f} ms ({us[n]:.2f} us/step)" for n, v in ms.items()), flush=True)
        print("  split (us a step): " + "; ".join(f"{k} {v:.2f}" for k, v in split.items()), flush=True)
    out = args.out or os.path.join(cuda_build.BUILD_DIR, "sweep_split.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
