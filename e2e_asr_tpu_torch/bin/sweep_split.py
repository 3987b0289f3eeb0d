"""Where a step of the LSTM sweeps goes, by ablation, on the card.

    python -m e2e_asr_tpu_torch.bin.sweep_split [--sweep forward|backward]
        [--dtype recipe|float32|bfloat16] [--out PATH]

Builds variants of each sweep's source with one part of the step compiled
out (their outputs are wrong; only their times count) into
``_build/sweep_split/`` and times each variant's sweep launch (CUDA events,
10 launches) at the flagship's layer (T=204, B=16, H=320) and the
convergence recipe's first layer (T=816, B=32, H=256), both directions;
both sweeps unless ``--sweep`` names one; in the storage type ``--dtype``
names (recipe: the flagship recipe's ``hparas.dtype``, bfloat16), acts
float32 (the lstm_seq route's).

The backward sweep (csrc/lstm_bidir_bwd.cu):

- ``full``: the kernel as built for the port;
- ``no_grid``: no grid barrier a step;
- ``no_stage``: no copy of the step's dgates into shared memory;
- ``no_product``: no tensor-core product (dgates Wh^T);
- ``elementwise``: none of the three: the gate gradients, their stores,
  the next step's loads and the reduction.

The forward sweep (csrc/lstm_bidir.cu):

- ``full``: the kernel as built for the port;
- ``no_product``: no tensor-core product (h Wh);
- ``no_publish``: no publication of h_t (its stores to L2, the staging of
  the next step's h and the grid barrier a step);
- ``no_cell``: no cell update and no stores of ys, c and acts;
- ``rest``: none of the three: the loop, the next step's xw and mask loads
  and the block barrier.

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

# per sweep: its source, and the define that compiles a part out with the
# parts it cuts (their first lines in the source, a block whole or the
# lines alone)
SWEEPS = {
    "backward": ("lstm_bidir_bwd", {
        "NO_GRID": [("    grid.sync();  // every block's dgates of step k are in dg\n", "statement")],
        "NO_STAGE": [("      for (int i = tid; i < nb * (pw / 4); i += SW_NT) {\n", "block")],
        "NO_PRODUCT": [("      for (int c0 = (STAGED ? p0 / 16 : 0) + warp; c0 < cend; c0 += 2 * SW_NW) {\n", "block")],
    }, {"full": (), "no_grid": ("NO_GRID",), "no_stage": ("NO_STAGE",), "no_product": ("NO_PRODUCT",),
        "elementwise": ("NO_GRID", "NO_STAGE", "NO_PRODUCT")}),
    "forward": ("lstm_bidir", {
        "NO_PRODUCT": [("    for (int cc = kh; cc < KC; cc += FW_KSPLIT) {\n", "block")],
        "NO_PUBLISH": [
            ("    if (k > 0) {  // h_{k-1} of the group's rows from L2\n", "block"),
            ("#pragma unroll\n    for (int i = 0; i < NT; ++i) {  // publish h_k\n", "block"),
            ("    grid.sync();  // h_k is in hbuf; hs and red are free again\n", "statement"),
        ],
        "NO_CELL": [("#pragma unroll\n    for (int i = 0; i < NT; ++i) {  // cell update and stores\n", "block")],
    }, {"full": (), "no_product": ("NO_PRODUCT",), "no_publish": ("NO_PUBLISH",), "no_cell": ("NO_CELL",),
        "rest": ("NO_PRODUCT", "NO_PUBLISH", "NO_CELL")}),
}
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


def ablated_source(sweep: str) -> str:
    """The sweep's source with each cut wrapped in ``#ifndef <define>``."""
    name, cuts, _ = SWEEPS[sweep]
    with open(os.path.join(cuda_build.CSRC_DIR, f"{name}.cu")) as f:
        src = f.read()
    for define, parts in cuts.items():
        for marker, kind in parts:
            if src.count(marker) != 1:
                raise RuntimeError(f"sweep_split: {name}.cu no longer has one {define} marker")
            start = src.index(marker)
            end = start + len(marker) if kind == "statement" else _block_end(src, start)
            src = src[:start] + f"#ifndef {define}\n" + src[start:end] + "#endif\n" + src[end:]
    return src


def build(out_dir: str, sweeps=tuple(SWEEPS)) -> dict:
    """One library a (sweep, variant), compiled in parallel; {sweep: {variant: path}}."""
    os.makedirs(out_dir, exist_ok=True)
    for header in ("bf16.cuh", "tf32_mma.cuh", "gemm_tf32.cuh"):
        with open(os.path.join(cuda_build.CSRC_DIR, header)) as f, open(os.path.join(out_dir, header), "w") as g:
            g.write(f.read())
    procs, paths = {}, {}
    for sweep in sweeps:
        variants = SWEEPS[sweep][2]
        src = os.path.join(out_dir, f"{sweep}.cu")
        with open(src, "w") as f:
            f.write(ablated_source(sweep))
        paths[sweep] = {}
        for name, defines in variants.items():
            paths[sweep][name] = os.path.join(out_dir, f"{sweep}_{name}.so")
            cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *[f"-D{d}" for d in defines], "-o",
                   paths[sweep][name], src]
            procs[(sweep, name)] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for (sweep, name), proc in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"{sweep} sweep variant {name} failed to build:\n{log}")
    return paths


def _inputs(t: int, b: int, h: int, dev: torch.device, dtype: torch.dtype = torch.float32) -> dict:
    """Both sweeps' inputs at (T, B, H), two directions, every row valid;
    wh, c, dy, xw and ys in ``dtype``, the rest float32."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    r = 2 * b
    x = dict(
        mask=torch.ones((t, r), device=dev),
        wh=torch.randn((2, h, 4 * h), generator=gen, device=dev) / h ** 0.5,
        c=torch.randn((t, r, h), generator=gen, device=dev),
        acts=torch.rand((t, r, 4 * h), generator=gen, device=dev),
        dy=torch.randn((t, r, h), generator=gen, device=dev),
        dg=torch.empty((t, r, 4 * h), device=dev),
        xw=torch.randn((t, r, 4 * h), generator=gen, device=dev),
        ys=torch.empty((t, r, h), device=dev),
        hbuf=torch.empty((2, r, h), device=dev),
    )
    for k in ("wh", "c", "dy", "xw", "ys"):
        x[k] = x[k].to(dtype)
    x["dgs"] = torch.empty((t, r, 4 * h), dtype=dtype, device=dev)
    return x


def _launcher(sweep: str, path: str, t: int, b: int, h: int, x: dict, dev: torch.device):
    """A function that launches the variant's sweep once (raises on error)."""
    lib = ctypes.CDLL(path)
    dt = x["wh"].dtype
    codes = (cuda_build.dtype_code(dt, "sweep_split"), 0)  # storage type; acts float32
    if sweep == "backward":
        fn = lib.e2e_lstm_bwd_sweep
        ptrs = (x["mask"], x["wh"], x["c"], x["acts"], x["dy"], x["dg"], x["dgs"])
        nt, w_smem, smem, _, piece = rnn_cuda.sweep_grid(t, b, 2, h, dev, dt)
        ints = (t, b, 2, h, 1, nt, w_smem, smem, piece, *codes)
    else:
        fn = lib.e2e_lstm_fwd_sweep
        ptrs = (x["xw"], x["mask"], x["wh"], x["ys"], x["c"], x["acts"], x["hbuf"])
        ints = (t, b, 2, h, 1, 1, *rnn_cuda.fwd_plan(b, 2, h, dev, dt)[:3], *codes)
    fn.restype = ctypes.c_int

    def run():
        args = [ctypes.c_void_p(v.data_ptr()) for v in ptrs] + [ctypes.c_int(v) for v in ints]
        args.append(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        err = fn(*args)
        if err:
            raise RuntimeError(f"{sweep} sweep variant launch failed: error {err}")

    return run


def time_variant(sweep: str, path: str, t: int, b: int, h: int, iters: int = 10,
                 dtype: torch.dtype = torch.float32) -> float:
    """ms a sweep launch of the variant at (T, B, H), two directions, every
    row valid (the forward in its training variant), in storage type ``dtype``."""
    dev = torch.device("cuda", torch.cuda.current_device())
    run = _launcher(sweep, path, t, b, h, _inputs(t, b, h, dev, dtype), dev)
    run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _split(sweep: str, us: dict) -> dict:
    if sweep == "backward":
        return {
            "grid barrier": us["full"] - us["no_grid"],
            "dgates staging": us["full"] - us["no_stage"],
            "product": us["full"] - us["no_product"],
            "gate gradients, stores, next loads, reduction": us["elementwise"],
        }
    return {
        "product": us["full"] - us["no_product"],
        "publication (h stores, staging, grid barrier)": us["full"] - us["no_publish"],
        "cell update and stores": us["full"] - us["no_cell"],
        "rest (loop, next xw and mask loads, block barrier)": us["rest"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", choices=sorted(SWEEPS), default=None, help="time one sweep only (default: both)")
    ap.add_argument("--dtype", default="recipe", choices=("recipe", "float32", "bfloat16"),
                    help="storage type of the sweeps (recipe: the flagship recipe's hparas.dtype)")
    ap.add_argument("--out", default="", help="JSON result (default: _build/sweep_split.json)")
    args = ap.parse_args(argv)
    from e2e_asr_tpu_torch.bin.profile_decode import FLAGSHIP
    from e2e_asr_tpu_torch.config import Config

    name = Config.load(FLAGSHIP).hparas.dtype if args.dtype == "recipe" else args.dtype
    dtype = torch.bfloat16 if name == "bfloat16" else torch.float32
    if not torch.cuda.is_available():
        raise SystemExit("sweep_split: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sweeps = (args.sweep,) if args.sweep else tuple(SWEEPS)
    paths = build(os.path.join(cuda_build.BUILD_DIR, "sweep_split"), sweeps)
    dev = torch.device("cuda", torch.cuda.current_device())
    result = {"card": card, "dtype": name, "shapes": {}, "forward": {}}
    for sweep in sweeps:
        for t, b, h in SHAPES:
            ms = {v: time_variant(sweep, path, t, b, h, dtype=dtype) for v, path in paths[sweep].items()}
            us = {name: v / t * 1e3 for name, v in ms.items()}
            split = _split(sweep, us)
            if sweep == "backward":
                plan = dict(zip(("row_tiles", "wh_in_smem", "smem", "blocks", "piece"),
                                rnn_cuda.sweep_grid(t, b, 2, h, dev, dtype)))
            else:
                plan = dict(zip(("row_tiles", "wh_in_smem", "smem", "blocks"),
                                rnn_cuda.fwd_plan(b, 2, h, dev, dtype)))
            entry = {"ms": ms, "us_per_step": us, "split_us": split, "grid" if sweep == "backward" else "plan": plan}
            (result["shapes"] if sweep == "backward" else result["forward"])[f"T{t}_B{b}_H{h}"] = entry
            print(f"{card}: {sweep} sweep ({name}) T={t} B={b} H={h} plan {plan}: "
                  + "; ".join(f"{n} {v:.3f} ms ({us[n]:.2f} us/step)" for n, v in ms.items()), flush=True)
            print("  split (us a step): " + "; ".join(f"{k} {v:.2f}" for k, v in split.items()), flush=True)
    out = args.out or os.path.join(cuda_build.BUILD_DIR, "sweep_split.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
