"""Bidirectional LSTM layer kernels (csrc/lstm_bidir.cu, csrc/lstm_bidir_bwd.cu)
beside their plain PyTorch versions, and the autograd function that joins
the training forward to the backward.

Replaces the TPU kernel ``e2e_asr_tpu/ops/rnn_pallas.py`` ``lstm_seq_fused``
(forward and backward, its ``custom_vjp``). All versions take x [T, B, D]
(shared by both directions), mask [T, B] f32, wx [2, D, 4H], wh [2, H, 4H],
b [2, 4H]; ys [T, 2B, H] has rows [0, B) for the forward direction in
original time and rows [B, 2B) for the backward direction in kernel time
(flip over T to get original time). Carries freeze where mask = 0, outputs
are zeroed there, and the initial state is zero. Masks are contiguous
prefix runs per utterance (the backward reads h_prev from ys, which equals
the h carry wherever a step is valid under that contract). The layer takes
H a multiple of 8 up to 1024. The forward is two kernels in a row: the
input projection (the tensor-core GEMM, rows written in kernel time) and
the recurrence's sweep (``fwd_plan``: Wh resident in shared memory, the
product h Wh on the tensor cores). The backward is two kernels in a row
too: the reverse sweep (one cooperative grid, ``sweep_grid``) and the
tensor-core products (``split_k`` picks their split over K). chip_smoke.py
times each part apart.

The second half of the module is ``lstm_seq``: the same recurrence over
projections computed outside the kernel (the TPU kernel
``rnn_pallas.lstm_seq``), by the same sweeps.

Storage types. Every function takes float32 or bfloat16 activations and
weights (one type a call, ``mask`` always float32); each kernel has a
variant of each. At bfloat16 the rounding points are the TPU kernels': the
gates, cell and gate gradients are computed in float32 from the widened
inputs; h and c are carried rounded to bfloat16 (h' from the unrounded c');
ys, c and dxw / dx / the weight gradients are stored in bfloat16; the dh and
dc carries stay float32; dWh is summed from the float32 gate gradients, dx,
dWx and db from the gate gradients rounded to bfloat16 (the fused TPU
kernel's dgate scratch); the fused layer's dx is its two directions' products
rounded each, summed in float32 and rounded, and its db the sums of blocks of
DB_STEPS steps of original time (the TPU kernel's time blocks), each rounded,
summed in float32 and rounded. The gate activations are
float32 for ``lstm_seq`` (its TPU backward rebuilds the gates in float32 from
xw and h, and tanh of the unrounded c, here rebuilt from acts and the
rounded c_prev) and bfloat16 for the fused layer (its TPU forward stores
them so, and its backward reads tanh of the rounded c). No wrapper casts: a
tensor of another type raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from e2e_asr_tpu_torch import cuda_build
from e2e_asr_tpu_torch.cuda_build import dtype_code


def _kernel_time_inputs(x, mask, wx, b):
    """xw [T, 2B, 4H] (projections + bias, summed in float32 and stored in
    x's type) and m [T, 2B] bool, both rows in kernel time (the backward
    direction's time flipped)."""
    proj = lambda d: (x.float() @ wx[d].float() + b[d].float()).to(x.dtype)
    xw_f = proj(0)
    xw_b = torch.flip(proj(1), dims=[0])
    xw = torch.cat([xw_f, xw_b], dim=1)
    m = torch.cat([mask, torch.flip(mask, dims=[0])], dim=1) > 0
    return xw, m


def lstm_seq_fwd_plain(
    xw: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor, acts_dtype: torch.dtype = torch.float32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``lstm_seq``: the recurrence over precomputed
    projections xw [T, R, 4H] as a loop over T; R = Dirs * B rows, direction
    d owning rows [dB, (d+1)B) and wh[d]; mask [T, R]. Returns ys, the c
    carry after each step c [T, R, H] (both in xw's type) and the gate
    activations acts [T, R, 4H] (i, f, g, o) in ``acts_dtype``."""
    t, r, _ = xw.shape
    dirs, h_dim, _ = wh.shape
    bsz = r // dirs
    dt = xw.dtype
    m = mask > 0
    whf = wh.float()
    h = xw.new_zeros((r, h_dim))
    c = xw.new_zeros((r, h_dim))
    ys = xw.new_empty((t, r, h_dim))
    cs = xw.new_empty((t, r, h_dim))
    acts = xw.new_empty((t, r, 4 * h_dim), dtype=acts_dtype)
    for k in range(t):
        gates = xw[k].float() + torch.bmm(h.float().view(dirs, bsz, h_dim), whf).view(r, -1)
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg), torch.sigmoid(go)
        c2 = f * c.float() + i * g
        h2 = o * torch.tanh(c2)
        mk = m[k][:, None]
        h = torch.where(mk, h2.to(dt), h)
        c = torch.where(mk, c2.to(dt), c)
        ys[k] = torch.where(mk, h2, 0.0)
        cs[k] = c
        acts[k] = torch.cat([i, f, g, o], dim=-1)
    return ys, cs, acts


def lstm_bidir_fwd_train_plain(
    x: torch.Tensor, mask: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the input projections, then the recurrence as a loop
    over T. Returns ys, the c carry after each step c [T, 2B, H] and the
    gate activations acts [T, 2B, 4H] (i, f, g, o), all in x's type."""
    return lstm_seq_fwd_plain(*_kernel_time_inputs(x, mask, wx, b), wh, acts_dtype=x.dtype)


def lstm_bidir_fwd_plain(
    x: torch.Tensor, mask: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Plain version of the inference kernel: ys only."""
    return lstm_bidir_fwd_train_plain(x, mask, wx, wh, b)[0]


def _check_layer(x, mask, wx, wh, name, b=None):
    """Checks the layer's inputs (the bias where given): mask float32, the
    rest in x's type; returns T, B, D, H."""
    dtype_code(x.dtype, name)
    cuda_build.check_cuda(mask, f"{name} mask")
    for a, an in ((x, "x"), (wx, "wx"), (wh, "wh"), (b, "b")):
        if a is not None:
            cuda_build.check_cuda(a, f"{name} {an}", x.dtype)
    t, bsz, d = x.shape
    h_dim = wh.shape[1]
    if wx.shape != (2, d, 4 * h_dim) or wh.shape != (2, h_dim, 4 * h_dim) or (
        b is not None and b.shape != (2, 4 * h_dim)
    ):
        raise ValueError(f"{name}: bad weight shapes {wx.shape} {wh.shape} "
                         f"{None if b is None else b.shape}")
    if mask.shape != (t, bsz):
        raise ValueError(f"{name}: mask {tuple(mask.shape)} != {(t, bsz)}")
    if h_dim % 8 != 0 or h_dim > 1024:
        raise ValueError(f"{name}: hidden dim {h_dim} is not a multiple of 8 up to 1024")
    return t, bsz, d, h_dim


_fwd_plans: dict = {}


def fwd_plan(b: int, dirs: int, h_dim: int, dev: torch.device, dtype: torch.dtype = torch.float32,
             acts_dtype: torch.dtype = torch.float32) -> Tuple[int, int, int, int]:
    """(n8 tiles of rows a block, Wh resident in shared memory (1; 0: read
    from L2), shared memory bytes a block, blocks) of the forward sweep's
    cooperative grid for storage type ``dtype`` (Wh held in it), from the
    kernel's own plan (csrc ``e2e_lstm_fwd_plan``: the first that is
    resident at once). Raises where no grid can be resident. Card only."""
    key = (b, dirs, h_dim, str(dev), dtype, acts_dtype)
    if key not in _fwd_plans:
        out = torch.zeros(4, dtype=torch.int32)
        cuda_build.launch("lstm_bidir", "e2e_lstm_fwd_plan", b, dirs, h_dim, dtype_code(dtype, "fwd_plan"),
                          dtype_code(acts_dtype, "fwd_plan"), out)
        plan = tuple(out.tolist())
        if plan[0] < 0:
            raise ValueError(f"lstm forward sweep: no resident grid for B={b}, H={h_dim}, "
                             f"{dirs} direction(s)")
        _fwd_plans[key] = plan
    return _fwd_plans[key]


def _fwd_sweep(xw, mask, wh, ys, cs, acts, t, b, dirs, h_dim, row_mask, train):
    """The forward sweep kernel over xw [T, dirs B, 4H] (kernel time): ys,
    and with ``train`` c and acts (else any tensor for both: unwritten)."""
    plan = fwd_plan(b, dirs, h_dim, xw.device, xw.dtype, acts.dtype)
    hbuf = torch.empty((2, dirs * b, h_dim), dtype=torch.float32, device=xw.device)  # h between steps
    cuda_build.launch("lstm_bidir", "e2e_lstm_fwd_sweep", xw, mask, wh, ys, cs, acts, hbuf, t, b, dirs,
                      h_dim, row_mask, int(train), *plan[:3], dtype_code(xw.dtype, "lstm forward sweep"),
                      dtype_code(acts.dtype, "lstm forward sweep"))


def _projection(x, wx, b, xw):
    """xw [T, 2B, 4H] = x wx[d] + b[d] in kernel time (the backward
    direction flipped): the tensor-core GEMM kernel."""
    t, bsz, d = x.shape
    cuda_build.launch("lstm_bidir", "e2e_lstm_bidir_projection", x, wx, b, xw, t, bsz, d, wx.shape[2] // 4,
                      dtype_code(x.dtype, "lstm projection"))


def _bidir_fwd(x, mask, wx, wh, b, name, train):
    """The fused layer's forward on the card: (ys, c, acts), c and acts
    unwritten (ys itself) unless ``train``."""
    x, mask, wx, wh, b = (a.contiguous() for a in (x, mask, wx, wh, b))
    t, bsz, d, h_dim = _check_layer(x, mask, wx, wh, name, b)
    dev = x.device
    xw = torch.empty((t, 2 * bsz, 4 * h_dim), dtype=x.dtype, device=dev)
    ys = torch.empty((t, 2 * bsz, h_dim), dtype=x.dtype, device=dev)
    cs = torch.empty_like(ys) if train else ys
    acts = torch.empty_like(xw) if train else ys
    _projection(x, wx, b, xw)
    _fwd_sweep(xw, mask, wh, ys, cs, acts, t, bsz, 2, h_dim, 0, train)
    return ys, cs, acts


def lstm_bidir_fwd(
    x: torch.Tensor, mask: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Inference forward: plain version on CPU tensors; the CUDA kernels (the
    projection, then the sweep) on CUDA tensors."""
    if cuda_build.use_plain(x):
        return lstm_bidir_fwd_plain(x, mask, wx, wh, b)
    ys = _bidir_fwd(x, mask, wx, wh, b, "lstm_bidir_fwd", False)[0]
    cuda_build.count_launch(lstm_bidir_fwd, x.dtype)
    return ys


lstm_bidir_fwd.launches = 0
lstm_bidir_fwd.launches_bf16 = 0


def lstm_bidir_fwd_train(
    x: torch.Tensor, mask: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training forward (ys, c, acts): plain version on CPU tensors; the
    kernels' training variant on CUDA tensors."""
    if cuda_build.use_plain(x):
        return lstm_bidir_fwd_train_plain(x, mask, wx, wh, b)
    out = _bidir_fwd(x, mask, wx, wh, b, "lstm_bidir_fwd_train", True)
    cuda_build.count_launch(lstm_bidir_fwd_train, x.dtype)
    return out


lstm_bidir_fwd_train.launches = 0
lstm_bidir_fwd_train.launches_bf16 = 0


def _sweep_plain(mask, wh, c, acts, dy):
    """The reverse sweep over rows in kernel time (mask [T, R]): the gate
    gradients dg [T, R, 4H] in float32. Where c is stored in a narrower type
    than acts (lstm_seq at bfloat16), tanh is taken of c' = f c_prev + i g
    rebuilt in float32, as the TPU kernel rebuilds it; else of c itself."""
    t, r, h_dim = c.shape
    dirs = wh.shape[0]
    bsz = r // dirs
    remat = c.element_size() < acts.element_size()
    c, acts, dy = c.float(), acts.float(), dy.float()
    wh_t = wh.float().transpose(1, 2)
    m = (mask > 0).to(c.dtype)[..., None]
    dh = c.new_zeros((r, h_dim))
    dc = c.new_zeros((r, h_dim))
    dg = c.new_empty((t, r, 4 * h_dim))
    zeros = c.new_zeros((r, h_dim))
    for k in range(t - 1, -1, -1):
        i, f, g, o = acts[k].chunk(4, dim=-1)
        c_prev = c[k - 1] if k > 0 else zeros
        tc = torch.tanh(f * c_prev + i * g if remat else c[k])
        dh2 = m[k] * (dy[k] + dh)
        dc2 = m[k] * dc + dh2 * o * (1.0 - tc * tc)
        dgates = torch.cat([
            dc2 * g * i * (1.0 - i),
            dc2 * c_prev * f * (1.0 - f),
            dc2 * i * (1.0 - g * g),
            dh2 * tc * o * (1.0 - o),
        ], dim=-1)
        dg[k] = dgates
        dh = (1.0 - m[k]) * dh + torch.bmm(dgates.view(dirs, bsz, -1), wh_t).view(r, -1)
        dc = (1.0 - m[k]) * dc + dc2 * f
    return dg


def _dwh_plain(ys, dg, dirs):
    """dWh [Dirs, H, 4H] = h_prev^T dg per direction (h_prev = ys shifted),
    in float32."""
    t, r, h_dim = ys.shape
    bsz = r // dirs
    ys = ys.float()
    h_prev = torch.cat([ys.new_zeros((1, r, h_dim)), ys[:-1]], dim=0)
    return torch.stack([
        h_prev[:, d * bsz:(d + 1) * bsz].reshape(t * bsz, -1).T
        @ dg[:, d * bsz:(d + 1) * bsz].reshape(t * bsz, -1)
        for d in range(dirs)
    ])


DB_STEPS = 8  # steps of original time whose gate gradients the fused TPU kernel sums into db at once


def lstm_bidir_bwd_plain(x, mask, wx, wh, ys, c, acts, dy):
    """Plain version of the backward: the explicit reverse sweep (not
    autograd) giving the gate gradients, then the products. Returns dx
    [T, B, D], dwx [2, D, 4H], dwh [2, H, 4H], db [2, 4H], in x's type."""
    t, bsz, _ = x.shape
    dt = x.dtype
    dg = _sweep_plain(torch.cat([mask, torch.flip(mask, dims=[0])], dim=1), wh, c, acts, dy)
    dgs = dg.to(dt).float()  # the gate gradients as stored for dx, dWx and db
    dg_f = dgs[:, :bsz]
    dg_b = torch.flip(dgs[:, bsz:], dims=[0])  # original time
    wxf = wx.float()
    dx = ((dg_f @ wxf[0].T).to(dt).float() + (dg_b @ wxf[1].T).to(dt).float()).to(dt)
    x2 = x.float().reshape(t * bsz, -1)
    dwx = torch.stack([x2.T @ dg_f.reshape(t * bsz, -1), x2.T @ dg_b.reshape(t * bsz, -1)]).to(dt)
    dwh = _dwh_plain(ys, dg, 2).to(dt)
    if dt == torch.float32:
        db = dgs.reshape(t, 2, bsz, -1).sum(dim=(0, 2))
    else:  # the TPU kernel's sum: each block of DB_STEPS steps rounded, then summed
        dgo = torch.stack([dg_f, dg_b], dim=1)  # [T, 2, B, 4H], original time
        nblk = -(-t // DB_STEPS)
        dgo = torch.cat([dgo, dgo.new_zeros((nblk * DB_STEPS - t, *dgo.shape[1:]))])
        db = dgo.reshape(nblk, DB_STEPS, 2, bsz, -1).sum(dim=(1, 3)).to(dt).float().sum(dim=0).to(dt)
    return dx, dwx, dwh, db


GEMM_TILE = (128, 64, 32)  # (M, N, K) of a block's tile in csrc/gemm_tf32.cuh


def split_k(m: int, n: int, k: int, problems: int, sms: int) -> Tuple[int, int]:
    """(splits, k-tiles a split) of a product of ``problems`` M x N outputs
    over K on the GEMM of csrc/gemm_tf32.cuh: split K while the tiles
    fill fewer than two blocks an SM, keeping at least 8 k-tiles (256 of K)
    a split; every split non-empty. The partials are summed in split order."""
    bm, bn, bk = GEMM_TILE
    ktiles = -(-k // bk)
    tiles = -(-m // bm) * -(-n // bn) * problems
    splits = max(1, min(-(-2 * sms // tiles), ktiles // 8))
    chunk = -(-ktiles // splits) if ktiles else 0
    return (-(-ktiles // chunk) if chunk else 1), chunk


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


_sweep_grids: dict = {}


def sweep_grid(t: int, b: int, dirs: int, h_dim: int, dev: torch.device,
               dtype: torch.dtype = torch.float32,
               acts_dtype: torch.dtype = torch.float32) -> Tuple[int, int, int, int, int]:
    """(n8 tiles of rows a block, Wh resident in shared memory (1; 0: read
    from L2), shared memory bytes a block, blocks, columns of a step's dgates
    staged at once (4H: all, unstaged)) of the backward sweep's
    cooperative grid for storage type ``dtype`` (Wh held in it), from the
    kernel's own plan (csrc ``e2e_lstm_bwd_sweep_plan``: the first that is
    resident at once). Raises where no grid can be resident. Card only."""
    key = (t, b, dirs, h_dim, str(dev), dtype, acts_dtype)
    if key not in _sweep_grids:
        out = torch.zeros(5, dtype=torch.int32)
        cuda_build.launch("lstm_bidir_bwd", "e2e_lstm_bwd_sweep_plan", t, b, dirs, h_dim,
                          dtype_code(dtype, "sweep_grid"), dtype_code(acts_dtype, "sweep_grid"), out)
        plan = tuple(out.tolist())
        if plan[0] < 0:
            raise ValueError(f"lstm backward sweep: no resident grid for B={b}, H={h_dim}, "
                             f"{dirs} direction(s)")
        _sweep_grids[key] = plan
    return _sweep_grids[key]


def _sweep(mask, wh, c, acts, dy, dg, dgs, t, b, dirs, h_dim, row_mask):
    """The reverse sweep kernel: the gate gradients dg [T, dirs B, 4H]
    (float32) from the residuals, and at bfloat16 also dgs, the same rounded
    to bfloat16 (at float32 dgs is dg: unwritten)."""
    nt, w_smem, smem, _, piece = sweep_grid(t, b, dirs, h_dim, dg.device, c.dtype, acts.dtype)
    cuda_build.launch("lstm_bidir_bwd", "e2e_lstm_bwd_sweep", mask, wh, c, acts, dy, dg, dgs, t, b, dirs,
                      h_dim, row_mask, nt, w_smem, smem, piece, dtype_code(c.dtype, "lstm backward sweep"),
                      dtype_code(acts.dtype, "lstm backward sweep"))


def _workspace(dev, *shapes) -> torch.Tensor:
    """Room for the split partials of the products one launch runs, each
    given as (problems, splits, M, N): the largest that splits (one element
    where none does)."""
    n = max([p * s * (m + 1) * g for p, s, m, g in shapes if s > 1] or [1])
    return torch.empty((n,), dtype=torch.float32, device=dev)


def _bidir_products(x, wx, ys, dg, dgs, dx, dwx, dwh, db):
    """dx, dWx, db and dWh of the fused-projection layer from dg (dWh) and
    dgs (the rest): the tensor-core GEMM kernel (three launches, plus the
    split sums; at bfloat16 dx is its two directions' products summed by
    the split sum, each rounded first)."""
    t, bsz, d = x.shape
    h_dim = ys.shape[2]
    sms = _sms(x.device)
    sx, cx = split_k(d, 4 * h_dim, t * bsz, 2, sms)
    sh, ch = split_k(h_dim, 4 * h_dim, (t - 1) * bsz, 2, sms)
    shapes = [(2, sx, d, 4 * h_dim), (2, sh, h_dim, 4 * h_dim)]
    if x.dtype == torch.bfloat16:  # dx's two directions; db's block sums (2 x nblk rows of 4H)
        shapes += [(1, 2, t * bsz, d), (1, 2, -(-t // DB_STEPS) - 1, 4 * h_dim)]
    ws = _workspace(x.device, *shapes)
    cuda_build.launch("lstm_bidir_bwd", "e2e_lstm_bidir_bwd_products", x, wx, ys, dg, dgs, dx, dwx, dwh,
                      db, ws, t, bsz, d, h_dim, sx, cx, sh, ch, dtype_code(x.dtype, "lstm products"))


def lstm_bidir_bwd(x, mask, wx, wh, ys, c, acts, dy):
    """Backward: plain version on CPU tensors; the CUDA kernels (the sweep,
    then the products) on CUDA tensors."""
    if cuda_build.use_plain(x):
        return lstm_bidir_bwd_plain(x, mask, wx, wh, ys, c, acts, dy)
    x, mask, wx, wh, ys, c, acts, dy = (a.contiguous() for a in (x, mask, wx, wh, ys, c, acts, dy))
    t, bsz, d, h_dim = _check_layer(x, mask, wx, wh, "lstm_bidir_bwd")
    for a, an, shape in ((ys, "ys", (t, 2 * bsz, h_dim)), (c, "c", (t, 2 * bsz, h_dim)),
                         (acts, "acts", (t, 2 * bsz, 4 * h_dim)), (dy, "dy", (t, 2 * bsz, h_dim))):
        cuda_build.check_cuda(a, f"lstm_bidir_bwd {an}", x.dtype)
        if a.shape != shape:
            raise ValueError(f"lstm_bidir_bwd: {an} {tuple(a.shape)} != {shape}")
    dev, dt = x.device, x.dtype
    dg = torch.empty((t, 2 * bsz, 4 * h_dim), dtype=torch.float32, device=dev)
    dgs = torch.empty_like(dg, dtype=dt) if dt != torch.float32 else dg
    dx = torch.empty((t, bsz, d), dtype=dt, device=dev)
    dwx = torch.empty((2, d, 4 * h_dim), dtype=dt, device=dev)
    dwh = torch.empty((2, h_dim, 4 * h_dim), dtype=dt, device=dev)
    db = torch.empty((2, 4 * h_dim), dtype=dt, device=dev)
    _sweep(mask, wh, c, acts, dy, dg, dgs, t, bsz, 2, h_dim, 0)
    _bidir_products(x, wx, ys, dg, dgs, dx, dwx, dwh, db)
    cuda_build.count_launch(lstm_bidir_bwd, x.dtype)
    return dx, dwx, dwh, db


lstm_bidir_bwd.launches = 0
lstm_bidir_bwd.launches_bf16 = 0


class LSTMBidirFn(torch.autograd.Function):
    """ys = the layer's forward, with the backward above (the counterpart of
    ``lstm_seq_fused.defvjp``). The mask gets no gradient."""

    @staticmethod
    def forward(ctx, x, mask, wx, wh, b):
        ys, c, acts = lstm_bidir_fwd_train(x, mask, wx, wh, b)
        ctx.save_for_backward(x, mask, wx, wh, ys, c, acts)
        return ys

    @staticmethod
    def backward(ctx, dy):
        x, mask, wx, wh, ys, c, acts = ctx.saved_tensors
        dx, dwx, dwh, db = lstm_bidir_bwd(x, mask, wx, wh, ys, c, acts, dy.contiguous())
        return dx, None, dwx, dwh, db


def lstm_bidir_train(x, mask, wx, wh, b) -> torch.Tensor:
    """Differentiable ys through the training forward and the backward."""
    return LSTMBidirFn.apply(x, mask, wx, wh, b)


# ------------------------------------------------------------------ lstm_seq
# The recurrence over precomputed projections: replaces the TPU kernel
# ``rnn_pallas.lstm_seq`` (forward and backward, its ``custom_vjp``) with the
# two sweeps above (mask per row in kernel time). xw [T, R, 4H] (= x @ Wx + b,
# rows in kernel time), mask [T, R] (a contiguous prefix or suffix run per row),
# wh [Dirs, H, 4H], R = Dirs * B. The training forward stores the gate
# activations, so the backward takes acts and not xw (the TPU kernel rebuilds
# the gates from xw_t + h_{t-1} Wh instead).


def _check_seq(xw, mask, wh, name, xw_dtype=None):
    """Checks wh (the storage type), xw (``xw_dtype``, default the storage
    type: the backward passes acts, float32) and mask (float32); returns T,
    R, directions, H."""
    dtype_code(wh.dtype, name)
    cuda_build.check_cuda(mask, f"{name} mask")
    cuda_build.check_cuda(wh, f"{name} wh", wh.dtype)
    cuda_build.check_cuda(xw, f"{name} {'xw' if xw_dtype is None else 'acts'}", xw_dtype or wh.dtype)
    t, r, g = xw.shape
    dirs, h_dim, _ = wh.shape
    if wh.shape != (dirs, h_dim, 4 * h_dim) or g != 4 * h_dim or r % dirs != 0:
        raise ValueError(f"{name}: xw {tuple(xw.shape)} does not fit wh {tuple(wh.shape)}")
    if mask.shape != (t, r):
        raise ValueError(f"{name}: mask {tuple(mask.shape)} != {(t, r)}")
    if h_dim % 8 != 0 or h_dim > 1024:
        raise ValueError(f"{name}: hidden dim {h_dim} is not a multiple of 8 up to 1024")
    if dirs > 2:
        raise ValueError(f"{name}: {dirs} directions (the kernel takes 1 or 2)")
    return t, r, dirs, h_dim


def lstm_seq_fwd(xw: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor, train: bool = False):
    """ys [T, R, H]; with ``train`` (ys, c, acts): ys and c in xw's type,
    acts float32. Plain version on CPU tensors; the CUDA sweep on CUDA
    tensors."""
    if cuda_build.use_plain(xw):
        out = lstm_seq_fwd_plain(xw, mask, wh)
        return out if train else out[0]
    xw, mask, wh = (a.contiguous() for a in (xw, mask, wh))
    t, r, dirs, h_dim = _check_seq(xw, mask, wh, "lstm_seq_fwd")
    ys = torch.empty((t, r, h_dim), dtype=xw.dtype, device=xw.device)
    # the inference variant writes neither c nor acts: any pointer will do
    cs = torch.empty_like(ys) if train else ys
    acts = torch.empty_like(xw, dtype=torch.float32) if train else torch.empty(0, device=xw.device)
    _fwd_sweep(xw, mask, wh, ys, cs, acts, t, r // dirs, dirs, h_dim, 1, train)
    cuda_build.count_launch(lstm_seq_fwd, xw.dtype)
    return (ys, cs, acts) if train else ys


lstm_seq_fwd.launches = 0
lstm_seq_fwd.launches_bf16 = 0


def lstm_seq_bwd_plain(mask, wh, ys, c, acts, dy):
    """Plain version of the backward: the explicit reverse sweep, then dWh
    from its float32 gate gradients. Returns dxw [T, R, 4H] and dwh
    [Dirs, H, 4H], in ys's type."""
    dg = _sweep_plain(mask, wh, c, acts, dy)
    return dg.to(ys.dtype), _dwh_plain(ys, dg, wh.shape[0]).to(ys.dtype)


def _seq_products(ys, dg, dwh):
    """dWh of lstm_seq from the float32 gate gradients: the tensor-core GEMM
    kernel."""
    t, r, h_dim = ys.shape
    dirs = dwh.shape[0]
    bsz = r // dirs
    sh, ch = split_k(h_dim, 4 * h_dim, (t - 1) * bsz, dirs, _sms(ys.device))
    ws = _workspace(ys.device, (dirs, sh, h_dim, 4 * h_dim))
    cuda_build.launch("lstm_bidir_bwd", "e2e_lstm_seq_bwd_products", ys, dg, dwh, ws, t, bsz, dirs,
                      h_dim, sh, ch, dtype_code(ys.dtype, "lstm_seq products"))


def lstm_seq_bwd(mask, wh, ys, c, acts, dy):
    """Backward: plain version on CPU tensors; the CUDA kernels (the sweep,
    then dWh's product) on CUDA tensors. acts float32, the rest in ys's
    type."""
    if cuda_build.use_plain(ys):
        return lstm_seq_bwd_plain(mask, wh, ys, c, acts, dy)
    mask, wh, ys, c, acts, dy = (a.contiguous() for a in (mask, wh, ys, c, acts, dy))
    dt = ys.dtype
    t, r, dirs, h_dim = _check_seq(acts, mask, wh, "lstm_seq_bwd", torch.float32)
    for a, an in ((ys, "ys"), (c, "c"), (dy, "dy")):
        cuda_build.check_cuda(a, f"lstm_seq_bwd {an}", dt)
        if a.shape != (t, r, h_dim):
            raise ValueError(f"lstm_seq_bwd: {an} {tuple(a.shape)} != {(t, r, h_dim)}")
    dg = torch.empty_like(acts)  # float32: dxw itself at float32
    dxw = torch.empty_like(acts, dtype=dt) if dt != torch.float32 else dg
    dwh = torch.empty_like(wh)
    _sweep(mask, wh, c, acts, dy, dg, dxw, t, r // dirs, dirs, h_dim, 1)
    _seq_products(ys, dg, dwh)
    cuda_build.count_launch(lstm_seq_bwd, ys.dtype)
    return dxw, dwh


lstm_seq_bwd.launches = 0
lstm_seq_bwd.launches_bf16 = 0


class LSTMSeqFn(torch.autograd.Function):
    """ys = lstm_seq's forward with the backward above (the counterpart of
    ``rnn_pallas.lstm_seq.defvjp``). The mask gets no gradient."""

    @staticmethod
    def forward(ctx, xw, mask, wh):
        ys, c, acts = lstm_seq_fwd(xw, mask, wh, train=True)
        ctx.save_for_backward(mask, wh, ys, c, acts)
        return ys

    @staticmethod
    def backward(ctx, dy):
        dxw, dwh = lstm_seq_bwd(*ctx.saved_tensors, dy.contiguous())
        return dxw, None, dwh


def lstm_seq(xw: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """ys [T, R, H]: through the training forward and the backward when
    autograd records, else the inference forward."""
    if torch.is_grad_enabled() and (xw.requires_grad or wh.requires_grad):
        return LSTMSeqFn.apply(xw, mask, wh)
    return lstm_seq_fwd(xw, mask, wh)
