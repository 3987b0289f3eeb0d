// Backward of the bidirectional masked LSTM layer (csrc/lstm_bidir.cu).
//
// Replaces the backward of the TPU kernel e2e_asr_tpu/ops/rnn_pallas.py
// lstm_seq_fused (_fused_bwd_call / _fused_bwd_kernel). Same contract: x
// [T, B, D] is shared by both directions; rows [0, B) of ys, c_out, acts and
// dy are the forward direction in original time, rows [B, 2B) the backward
// direction in kernel time (kernel step k is original time T-1-k); masks
// are contiguous prefix runs per utterance and the initial state is zero.
// One reverse sweep per row gives, with m the step's mask,
//   dh2 = m (dy + dh),  dc2 = m dc + dh2 o (1 - tanh^2 c),
//   dgates = [dc2 g i(1-i), dc2 c_prev f(1-f), dc2 i (1-g^2), dh2 tanh(c) o(1-o)],
//   dh <- (1-m) dh + dgates Wh^T,  dc <- (1-m) dc + dc2 f,
// with c_prev the c carry of the step before (zero at kernel time 0); the
// gate gradients go to dg [T, 2B, 4H] (kernel time). Then, as the TPU
// kernel's block-batched products:
//   dx  = dg_fwd Wx0^T + dg_bwd Wx1^T  (backward rows mapped back to
//         original time; x feeds both directions, so dx is their sum),
//   dWx = x^T dg,  dWh = h_prev^T dg (h_prev = ys of the step before, which
//   is the h carry wherever the step is valid), db = sum of dg over rows.
// The mask gets no gradient.
//
// The same sweep and products also replace the backward of the TPU kernel
// rnn_pallas.py lstm_seq (_lstm_seq_bwd_call / _bwd_kernel) for R = Dirs * B
// rows already in kernel time with a per-row mask [T, R]: the gate
// gradients ARE dxw [T, R, 4H], and dWh[d] = h_prev^T dxw over direction d's
// rows. The TPU kernel rebuilds the gates from xw_t + h_{t-1} Wh; here the
// forward stores the activations, so the sweep reads acts and never xw.
// The TPU kernels accumulate dWh (and dWx) inside the kernel body; here they
// are this file's own tensor-core products.
//
// What bounds it on the H100. The sweep: latency. Every step needs the last
// step's dh = dgates Wh^T over all 4H gate columns of every row; a design
// that streams Wh from L2 on every step (a row a cluster of 8 blocks, each
// with its H/8 rows of Wh: 205 KB a block a step at H = 320) is bound by L2
// bandwidth instead. The products: ~48 GFLOP a flagship layer (D = 1280),
// bound by the tensor cores' TF32 rate (three products a tile).
//
// Design, the sweep: one persistent cooperative grid, a block for each
// (direction, 16 hidden units, group of 8 nt rows); its 16 rows of Wh stay
// in shared memory for the whole launch (read from L2 where they do not
// fit), so no weight crosses L2 after the first step. A step: each block
// forms the gate gradients of its (unit, row) pairs and writes them to dg;
// one grid barrier; each block copies its rows' dgates of the step into
// shared memory (16-byte cp.async) while the next step's inputs load, and
// forms dgates Wh^T for its units on the tensor cores (m16n8k8, three TF32
// products a tile: float32 accuracy; six accumulators and two chunks a
// round keep the mma chains short), the 4H columns split over the warps,
// whose partial tiles are summed in a fixed order. The plan (rows a block,
// weights resident or not) comes from e2e_lstm_bwd_sweep_plan: the grid must
// be resident, or the launch fails and the wrapper raises. (A barrier among
// each group's blocks alone, per-block step counts that the group polls,
// measured slower than the grid barrier.) Where a step's dgates of a block's
// rows do not fit beside the rest (4H = 4096 at H = 1024 takes 128 KB for 8
// rows), the plan stages them in pieces of whole rounds of the product's
// columns (a round: the 256 columns that the warps take at once), each
// loaded, then multiplied, in column order: every warp adds its products
// in the order it adds them unstaged, so the sums are the same bits. The
// plan tries the unstaged layouts first, so a shape that fits them keeps
// its grid, and names the piece it chose.
// Design, the products: the tensor-core GEMM of csrc/gemm_tf32.cuh (shared
// with the forward's input projection; 128 x 64 x 32 tiles, three TF32
// products a tile) whose operands are rows addressed through (time, batch)
// maps, so the kernel-time backward rows and the h_prev shift need no
// copies.
// dx is one product over K = 2 x 4H (the two directions as two K segments);
// dWx and dWh run both directions in one launch, split over K where the
// tiles alone would not fill the card (the split picked by the wrapper),
// the partials summed in a fixed order by a second kernel: no atomics, so
// every output repeats bitwise. db is folded into dWx: the blocks of its
// first row of tiles also sum the columns of the dg tiles they load.
//
// Storage types (csrc/bf16.cuh): the sweep is a template on the storage type
// S (wh, c_out, dy, and the rounded gate gradients) and the type A of acts.
// The bf16 variants round where the TPU kernels round at bfloat16: dh and dc
// carried in float32; the gate gradients written in float32 (dg: dh's
// product and dWh read them) and rounded to bf16 (dgs: lstm_seq's dxw, and
// the fused layer's dx, dWx and db read them); tanh of c' rebuilt in float32
// as f c_prev + i g from float32 acts and the rounded c_prev where acts are
// wider than S (lstm_seq: its TPU kernel rebuilds the gates), else of the
// stored c; every product's output rounded once; the fused layer's dx as
// its two directions' products, each rounded, summed and rounded; its db as
// the sums of blocks of DB_STEPS steps of original time, each rounded,
// summed and rounded (the fused TPU kernel's time blocks).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "gemm_tf32.cuh"
#include "tf32_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int SMEM_MAX = 232448 - 1024;  // a block's shared memory on the H100, less a margin

// ----------------------------------------------------------------- sweep
constexpr int SW_NT = 256;  // threads a block
constexpr int SW_NW = SW_NT / 32;
constexpr int SW_US = 16;   // hidden units a block (one m16 tile)
constexpr int SW_ROUND = 2 * SW_NW * 16;  // columns of dgates the warps take in one round of the product

__host__ __device__ inline int sw_stride(int G) { return G + 16; }  // 16-byte loads free of conflicts

constexpr int DB_STEPS = 8;  // steps of original time a block of the fused layer's db sums

// the resident Wh rows' share of shared memory, in floats (none where w_smem
// is 0: read from L2; es: bytes an element of Wh)
__host__ __device__ inline int sw_wh_floats(int G, int w_smem, int es) {
  return w_smem ? SW_US * sw_stride(G) * es / 4 : 0;
}

// columns of dgates a piece stages when a step's are staged in ``pieces``
// pieces: all G in one, else whole rounds
__host__ __device__ inline int sw_piece(int G, int pieces) {
  return pieces == 1 ? G : cdiv(cdiv(G, pieces), SW_ROUND) * SW_ROUND;
}

// bytes of shared memory: the resident Wh rows, a piece of the step's
// dgates of the block's rows (kp columns), the warps' partial tiles
__host__ __device__ inline int sw_smem_bytes(int G, int nt, int w_smem, int es, int kp) {
  return 4 * (sw_wh_floats(G, w_smem, es) + 8 * nt * sw_stride(kp) + SW_NW * nt * SW_US * 8);
}

// pointers of the storage types S (wh, c_out, dy, dgs) and A (acts)
struct SweepArgs {
  const float* mask;
  const void *wh, *c_out, *acts, *dy;
  float* dg;
  void* dgs;
  int T, B, H, dirs, row_mask;
  int nt, nrg, slices, w_smem, kp;  // kp: columns of dgates a piece (sw_piece)
};

// one (unit, row) pair's inputs of a step
struct PairIn {
  float m, ig, fg, gg, og, c, cp, dy;
};

template <typename S, typename A>
__device__ __forceinline__ PairIn load_pair(const SweepArgs& a, int k, int r, int row, int u,
                                            int dir) {
  const int R = a.dirs * a.B, H = a.H, G = 4 * a.H;
  const long base = (long)k * R + r;
  const int t = dir == 0 ? k : a.T - 1 - k;
  PairIn p;
  p.m = (a.row_mask ? a.mask[base] : a.mask[(long)t * a.B + row]) > 0.0f ? 1.0f : 0.0f;
  const A* ac = static_cast<const A*>(a.acts) + base * G + u;
  const S* c = static_cast<const S*>(a.c_out);
  p.ig = ldf(ac);
  p.fg = ldf(ac + H);
  p.gg = ldf(ac + 2 * H);
  p.og = ldf(ac + 3 * H);
  p.c = ldf(c + base * H + u);
  p.cp = k > 0 ? ldf(c + (base - R) * H + u) : 0.0f;
  p.dy = ldf(static_cast<const S*>(a.dy) + base * H + u);
  return p;
}

// NT n8 tiles of rows a block; STAGED: a step's dgates in pieces of a.kp
// columns (else in one, the unstaged build's own code); storage type S,
// acts in A
template <int NT, bool STAGED, typename S, typename A>
__global__ void __launch_bounds__(SW_NT, 1) lstm_bwd_sweep_kernel(SweepArgs a) {
  constexpr bool REMAT_C = sizeof(S) < sizeof(A);  // tanh of c' rebuilt from acts and c_prev
  constexpr int SW_PPT = (SW_US * 8 * NT + SW_NT - 1) / SW_NT;  // (unit, row) pairs a thread
  cg::grid_group grid = cg::this_grid();
  const int T = a.T, B = a.B, H = a.H, G = 4 * H, R = a.dirs * B;
  const int slice = blockIdx.x % a.slices;
  const int rg = (blockIdx.x / a.slices) % a.nrg;
  const int dir = blockIdx.x / (a.slices * a.nrg);
  const int u0 = slice * SW_US, nu = min(SW_US, H - u0);
  const int b0 = rg * 8 * NT, nb = min(8 * NT, B - b0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int LS = sw_stride(G), KP = STAGED ? a.kp : G, LP = sw_stride(KP);

  extern __shared__ __align__(16) float smem[];
  S* whs = reinterpret_cast<S*>(smem);                       // [16][LS] (w_smem)
  float* dgs = smem + sw_wh_floats(G, a.w_smem, sizeof(S));  // [8 NT][LP]: a piece of columns
  float* red = dgs + 8 * NT * LP;                            // [warps][NT][16][8]
  const S* whd = static_cast<const S*>(a.wh) + (long)dir * H * G;

  // the block's rows of Wh (rows past H zero), and zero rows past B
  if (a.w_smem) {
    for (int i = tid; i < SW_US * (G / 4); i += SW_NT) {
      const int ul = i / (G / 4), c4 = (i % (G / 4)) * 4;
      if (ul < nu) copy4(whs + ul * LS + c4, whd + (long)(u0 + ul) * G + c4);
      else zero4(whs + ul * LS + c4);
    }
  }
  for (int i = tid; i < (8 * NT - nb) * (KP / 4); i += SW_NT) {
    const int rl = nb + i / (KP / 4), c4 = (i % (KP / 4)) * 4;
    *reinterpret_cast<float4*>(dgs + rl * LP + c4) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const S* wrow0 = a.w_smem ? whs + g * LS : whd + (long)(u0 + g) * G;
  const S* wrow1 = a.w_smem ? whs + (g + 8) * LS : whd + (long)(u0 + g + 8) * G;
  const bool ok0 = a.w_smem || g < nu, ok1 = a.w_smem || g + 8 < nu;

  // the (unit, row) pairs this thread owns: p = tid + SW_NT i, unit p % 16,
  // row p / 16 of the block's group
  const int npairs = SW_US * 8 * NT;
  float dh[SW_PPT], dc[SW_PPT], mk[SW_PPT];
  PairIn in[SW_PPT];
#pragma unroll
  for (int i = 0; i < SW_PPT; ++i) {
    dh[i] = dc[i] = mk[i] = 0.0f;
    const int p = tid + SW_NT * i, ul = p % SW_US, rl = p / SW_US;
    if (p < npairs && ul < nu && rl < nb) {
      in[i] = load_pair<S, A>(a, T - 1, dir * B + b0 + rl, b0 + rl, u0 + ul, dir);
    }
  }
  __syncthreads();

  for (int k = T - 1; k >= 0; --k) {
#pragma unroll
    for (int i = 0; i < SW_PPT; ++i) {
      const int p = tid + SW_NT * i, ul = p % SW_US, rl = p / SW_US;
      if (!(p < npairs && ul < nu && rl < nb)) continue;
      const PairIn& x = in[i];
      // rebuilt as the plain version's float32 products and sum, unfused
      const float tc = tanhf(REMAT_C ? __fadd_rn(__fmul_rn(x.fg, x.cp), __fmul_rn(x.ig, x.gg)) : x.c);
      const float dh2 = x.m * (x.dy + dh[i]);
      const float dc2 = x.m * dc[i] + dh2 * x.og * (1.0f - tc * tc);
      const long off = ((long)k * R + dir * B + b0 + rl) * G + u0 + ul;
      const float dgv[4] = {dc2 * x.gg * x.ig * (1.0f - x.ig), dc2 * x.cp * x.fg * (1.0f - x.fg),
                            dc2 * x.ig * (1.0f - x.gg * x.gg), dh2 * tc * x.og * (1.0f - x.og)};
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) {
        a.dg[off + gi * H] = dgv[gi];
        if constexpr (sizeof(S) == 2) stf(static_cast<S*>(a.dgs) + off + gi * H, dgv[gi]);
      }
      dc[i] = (1.0f - x.m) * dc[i] + dc2 * x.fg;
      mk[i] = x.m;
    }
    if (k == 0) break;
    grid.sync();  // every block's dgates of step k are in dg

    const float* dgk = a.dg + ((long)k * R + dir * B + b0) * G;
    float acc[NT][6][4];
    for (int p0 = 0; p0 < G; p0 += KP) {
      const int pw = STAGED ? min(KP, G - p0) : G;
      if (STAGED && p0 > 0) __syncthreads();  // every warp is done with the last piece
      // the block's rows of this piece of dgates of step k into shared memory,
      // and (with the first piece) the next step's inputs, in flight together
      for (int i = tid; i < nb * (pw / 4); i += SW_NT) {
        const int rl = i / (pw / 4), c4 = (i % (pw / 4)) * 4;
        cp_async16(dgs + rl * LP + c4, dgk + (long)rl * G + p0 + c4);
      }
      if (!STAGED || p0 == 0) {
#pragma unroll
        for (int i = 0; i < SW_PPT; ++i) {
          const int p = tid + SW_NT * i, ul = p % SW_US, rl = p / SW_US;
          if (p < npairs && ul < nu && rl < nb) {
            in[i] = load_pair<S, A>(a, k - 1, dir * B + b0 + rl, b0 + rl, u0 + ul, dir);
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();

      // dgates Wh^T for the block's units: [16 units x 4H] x [4H x 8 NT
      // rows], warp w taking the 16-column chunks w, w + 8, ...; within a
      // chunk the k index is permuted (lane q holds columns 4q .. 4q+3) so
      // that each operand is one 16-byte load. Six accumulators (two k
      // halves x three TF32 products) keep the mma chains short.
      if (!STAGED || p0 == 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 6; ++e) acc[j][e][0] = acc[j][e][1] = acc[j][e][2] = acc[j][e][3] = 0.0f;
      }
      const int cend = STAGED ? (p0 + pw) / 16 : G / 16;
      for (int c0 = (STAGED ? p0 / 16 : 0) + warp; c0 < cend; c0 += 2 * SW_NW) {
        // two chunks a round, all their operands loaded before the first mma
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 wv[2][2], bv[2][NT];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int c = c0 + r * SW_NW;
          const bool live = c < cend;
          const int col = 16 * c + 4 * q;
          wv[r][0] = live && ok0 ? ld4(wrow0 + col) : z;
          wv[r][1] = live && ok1 ? ld4(wrow1 + col) : z;
#pragma unroll
          for (int j = 0; j < NT; ++j)
            bv[r][j] = live ? *reinterpret_cast<const float4*>(dgs + (j * 8 + g) * LP + col - (STAGED ? p0 : 0)) : z;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t ah[2][4], al[2][4];
          const float afr[2][4] = {{wv[r][0].x, wv[r][1].x, wv[r][0].y, wv[r][1].y},
                                   {wv[r][0].z, wv[r][1].z, wv[r][0].w, wv[r][1].w}};
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
            for (int e = 0; e < 4; ++e) tf32_split(afr[h2][e], ah[h2][e], al[h2][e]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            uint32_t bh[2][2], bl[2][2];
            const float bfr[2][2] = {{bv[r][j].x, bv[r][j].y}, {bv[r][j].z, bv[r][j].w}};
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
              for (int e = 0; e < 2; ++e) tf32_split(bfr[h2][e], bh[h2][e], bl[h2][e]);
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              mma_tf32(acc[j][3 * h2], al[h2], bh[h2]);
              mma_tf32(acc[j][3 * h2 + 1], ah[h2], bl[h2]);
              mma_tf32(acc[j][3 * h2 + 2], ah[h2], bh[h2]);
            }
          }
        }
      }
      if (!STAGED) break;  // one pass over all G columns
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = ((acc[j][0][e] + acc[j][1][e]) + acc[j][2][e]) +
               ((acc[j][3][e] + acc[j][4][e]) + acc[j][5][e]);
      }
      float* rp = red + ((warp * NT + j) * SW_US) * 8;
      rp[g * 8 + 2 * q] = v[0];
      rp[g * 8 + 2 * q + 1] = v[1];
      rp[(g + 8) * 8 + 2 * q] = v[2];
      rp[(g + 8) * 8 + 2 * q + 1] = v[3];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < SW_PPT; ++i) {
      const int p = tid + SW_NT * i, ul = p % SW_US, rl = p / SW_US;
      if (!(p < npairs && ul < nu && rl < nb)) continue;
      float sum = 0.0f;
      for (int w = 0; w < SW_NW; ++w) sum += red[((w * NT + rl / 8) * SW_US + ul) * 8 + rl % 8];
      dh[i] = (1.0f - mk[i]) * dh[i] + sum;
    }
  }
}

int elem_bytes(int dt) { return dt ? 2 : 4; }

// dWh[d] = h_prev^T dg over kernel steps k >= 1 and direction d's rows:
// h_prev = ys[k-1] (T = 1 gives a product over no rows: zeros); ys and dwh
// of storage type dt, dg float
int dwh_products(const void* ys, const float* dg, void* dwh, float* ws, int T, int B, int dirs,
                 int H, int splits, int kchunk, int dt, cudaStream_t stream) {
  const long long G = 4LL * H, R = (long long)dirs * B;
  GemmArgs ga{};
  for (int d = 0; d < dirs; ++d) {
    ga.pr[d].a[0] = {ys, row_map((long long)d * B * H, B, R * H, H)};
    ga.pr[d].b[0] = {dg, row_map((R + (long long)d * B) * G, B, R * G, G)};
    ga.pr[d].c = static_cast<char*>(dwh) + (long long)d * H * G * elem_bytes(dt);
    ga.pr[d].crow = plain_rows(G);
  }
  ga.c16 = dt;
  ga.ws = ws;
  ga.M = H;
  ga.N = (int)G;
  ga.K = (T - 1) * B;
  ga.seg_len = ga.K > 0 ? ga.K : 1;
  ga.splits = splits;
  ga.kchunk = kchunk;
  return gemm(ga, dirs, false, false, aligned16(ys) && aligned16(dg), false, dt, false, stream);
}

template <bool STAGED, typename S, typename A>
const void* sweep_kernel_of(int nt) {
  return nt == 1 ? (const void*)lstm_bwd_sweep_kernel<1, STAGED, S, A>
         : nt == 2 ? (const void*)lstm_bwd_sweep_kernel<2, STAGED, S, A>
                   : (const void*)lstm_bwd_sweep_kernel<4, STAGED, S, A>;
}

template <typename S, typename A>
const void* sweep_kernel_of(int nt, bool staged) {
  return staged ? sweep_kernel_of<true, S, A>(nt) : sweep_kernel_of<false, S, A>(nt);
}

// the variant of storage type dt (0 float, 1 bf16) and acts type adt, its
// dgates staged in pieces or not
const void* sweep_kernel(int nt, int dt, int adt, bool staged) {
  return !dt ? sweep_kernel_of<float, float>(nt, staged)
         : adt ? sweep_kernel_of<bf16, bf16>(nt, staged) : sweep_kernel_of<bf16, float>(nt, staged);
}

// the fused layer's db at bf16, two kernels: db_blocks_kernel writes, for
// each block of DB_STEPS steps of original time (blockIdx.z) and direction
// d (blockIdx.y), the sum of d's rounded gate gradients dgs (kernel time)
// over the block's steps and rows, rounded to bf16, into part [2][nblk][G]
// (a thread a column); db_sum_kernel sums those in block order and rounds
__global__ void db_blocks_kernel(const bf16* dgs, float* part, int T, int B, int G) {
  const int d = blockIdx.y, R = 2 * B, blk = blockIdx.z, nblk = gridDim.z;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= G) return;
  float s = 0.0f;
  for (int t = blk * DB_STEPS; t < min(T, (blk + 1) * DB_STEPS); ++t) {
    const int k = d == 0 ? t : T - 1 - t;  // kernel step of original time t
    for (int b = 0; b < B; ++b) s += ldf(dgs + ((long)k * R + d * B + b) * G + n);
  }
  part[((long)d * nblk + blk) * G + n] = rnd<bf16>(s);
}

__global__ void db_sum_kernel(const float* part, bf16* db, int nblk, int G) {
  const int d = blockIdx.y, n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= G) return;
  float tot = 0.0f;
  for (int blk = 0; blk < nblk; ++blk) tot += part[((long)d * nblk + blk) * G + n];
  stf(db + (long)d * G + n, tot);
}

int sweep_plan(int T, int B, int dirs, int H, int dt, int adt, int* out) {
  (void)T;
  const int G = 4 * H;
  int dev = 0, nsm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  out[0] = -1;
  const int slices = cdiv(H, SW_US);
  // the unstaged layouts first (a step's dgates in one piece), then pieces
  for (int staged = 0; staged <= 1; ++staged) {
    for (int w_smem = 1; w_smem >= 0; --w_smem) {
      for (int nt = 1; nt <= 4; nt *= 2) {
        for (int pieces = staged ? 2 : 1; pieces <= (staged ? 16 : 1); pieces *= 2) {
          const int kp = sw_piece(G, pieces);
          if (staged && kp >= G) continue;
          const int smem = sw_smem_bytes(G, nt, w_smem, elem_bytes(dt), kp);
          if (smem > SMEM_MAX) continue;
          const void* kern = sweep_kernel(nt, dt, adt, staged);
          e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
          if (e != cudaSuccess) return (int)e;
          int per_sm = 0;
          e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, SW_NT, smem);
          if (e != cudaSuccess) return (int)e;
          const int nb = dirs * slices * cdiv(B, 8 * nt);
          if (nb <= per_sm * nsm) {
            out[0] = nt;
            out[1] = w_smem;
            out[2] = smem;
            out[3] = nb;
            out[4] = kp;
            return 0;
          }
        }
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" const char* e2e_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The sweep's grid: out = [n8 tiles of rows a block (-1: no grid can be
// resident), Wh resident in shared memory (1; 0: read from L2), shared
// memory bytes a block, blocks, columns of dgates a piece (4H: unstaged)].
// The first of (w_smem = 1, 0) x (nt = 1, 2, 4) whose grid is resident at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), for storage type dt
// (0 float, 1 bf16) and acts type adt; where none is, the first of them
// with the step's dgates staged in 2, 4, 8 or 16 pieces.
extern "C" int e2e_lstm_bwd_sweep_plan(int T, int B, int dirs, int H, int dt, int adt, int* out,
                                       void* stream) {
  (void)stream;
  if (H % 8 != 0 || H > 1024 || dirs < 1 || dirs > 2 || B < 1 || dt < 0 || dt > 1 || adt < 0 || adt > 1)
    return (int)cudaErrorInvalidValue;
  return sweep_plan(T, B, dirs, H, dt, adt, out);
}

// The reverse sweep over all rows (dirs * B) -> dg [T, dirs * B, 4H]. mask
// [T, B] in original time (row_mask 0, the fused-projection layer) or
// [T, dirs * B] in kernel time (row_mask 1), wh [dirs, H, 4H], c_out / dy
// [T, dirs * B, H], acts [T, dirs * B, 4H]; nt, w_smem, smem and kp (the
// piece of dgates staged at once) from the plan; wh, c_out, dy
// and dgs of storage type dt (0 float, 1 bf16: dgs the gate gradients
// rounded, unwritten at float), acts of adt. One cooperative
// launch (a grid barrier a step): it fails where the grid cannot be
// resident.
extern "C" int e2e_lstm_bwd_sweep(const float* mask, const void* wh, const void* c_out,
                                  const void* acts, const void* dy, float* dg, void* dgs, int T, int B,
                                  int dirs, int H, int row_mask, int nt, int w_smem, int smem, int kp,
                                  int dt, int adt, void* stream) {
  if (H % 8 != 0 || H > 1024 || dirs < 1 || dirs > 2 || B < 1 || T < 1 ||
      (nt != 1 && nt != 2 && nt != 4) || w_smem < 0 || w_smem > 1 || dt < 0 || dt > 1 || adt < 0 ||
      adt > 1 || (!dt && adt) || (kp != 4 * H && (kp < SW_ROUND || kp % SW_ROUND != 0 || kp > 4 * H)) ||
      smem != sw_smem_bytes(4 * H, nt, w_smem, elem_bytes(dt), kp) || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const void* kern = sweep_kernel(nt, dt, adt, kp < 4 * H);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  SweepArgs a{mask, wh, c_out, acts, dy, dg, dgs, T, B, H, dirs, row_mask,
              nt, cdiv(B, 8 * nt), cdiv(H, SW_US), w_smem, kp};
  void* params[] = {&a};
  const int nb = dirs * a.slices * a.nrg;
  return (int)cudaLaunchCooperativeKernel(kern, dim3(nb), dim3(SW_NT), params, (size_t)smem,
                                          (cudaStream_t)stream);
}

// The fused-projection layer's products from the gate gradients (kernel
// time): dg [T, 2B, 4H] float for dWh, dgs (dg itself at float) for dx,
// dWx and db; x [T, B, D], wx [2, D, 4H], ys [T, 2B, H] -> dx [T, B, D], dwx
// [2, D, 4H], dwh [2, H, 4H], db [2, 4H]; all but dg, ws of storage type dt
// (0 float, 1 bf16). ws: split partials, at least 2 x max(sx x (D + 1), sh x
// (H + 1)) x 4H floats where a split count is above 1, and at bf16 also 2 x
// (T B + 1) x D (dx's two directions) and 2 x ceil(T / DB_STEPS) x 4H (db's
// block sums); sx / sh and cx / ch: the splits and k-tiles a split of dWx
// and dWh.
extern "C" int e2e_lstm_bidir_bwd_products(const void* x, const void* wx, const void* ys,
                                           const float* dg, const void* dgs, void* dx, void* dwx,
                                           void* dwh, void* db, float* ws, int T, int B, int D, int H,
                                           int sx, int cx, int sh, int ch, int dt, void* stream_) {
  if (H % 8 != 0 || H > 1024 || D < 1 || B < 1 || T < 1 || sx < 1 || sh < 1 || dt < 0 || dt > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  const long long G = 4LL * H, R = 2LL * B;
  const int TB = T * B, es = elem_bytes(dt);
  const void* dgp = dt ? dgs : static_cast<const void*>(dg);
  const char* wxc = static_cast<const char*>(wx);
  // dx rows (t, b) in original time: dg_fwd at kernel time t, row b; dg_bwd
  // at kernel time T-1-t, row B+b; B(k, n) = wx[dir][n][k]. At bf16 the two
  // directions (the two K segments) are two splits, each product rounded
  // before their sum.
  GemmArgs ga{};
  ga.pr[0].a[0] = {dgp, row_map(0, B, R * G, G)};
  ga.pr[0].a[1] = {dgp, row_map(((long long)(T - 1) * R + B) * G, B, -R * G, G)};
  ga.pr[0].b[0] = {wxc, plain_rows(G)};
  ga.pr[0].b[1] = {wxc + (long long)D * G * es, plain_rows(G)};
  ga.pr[0].c = dx;
  ga.pr[0].crow = plain_rows(D);
  ga.ws = ws;
  ga.M = TB;
  ga.N = D;
  ga.K = (int)(2 * G);
  ga.seg_len = (int)G;
  ga.splits = dt ? 2 : 1;
  ga.kchunk = dt ? (int)(G / GK) : cdiv(ga.K, GK);
  ga.c16 = dt;
  ga.round_parts = dt;
  int err = gemm(ga, 1, true, true, aligned16(dgp) && aligned16(wx), false, dt, dt, stream);
  if (err) return err;

  // dWx[d] = x^T dg_d over rows (k, b); direction 1's kernel step k reads x
  // at original time T-1-k; db[d] = the columns of dg_d summed (at bf16 by
  // db_blocks_kernel instead)
  GemmArgs gx{};
  gx.pr[0].a[0] = {x, plain_rows(D)};
  gx.pr[1].a[0] = {x, row_map((long long)(T - 1) * B * D, B, -(long long)B * D, D)};
  for (int d = 0; d < 2; ++d) {
    gx.pr[d].b[0] = {dgp, row_map((long long)d * B * G, B, R * G, G)};
    gx.pr[d].c = static_cast<char*>(dwx) + (long long)d * D * G * es;
    gx.pr[d].crow = plain_rows(G);
    gx.pr[d].ones = dt ? nullptr : static_cast<float*>(db) + (long long)d * G;
  }
  gx.ws = ws;
  gx.M = D;
  gx.N = (int)G;
  gx.K = TB;
  gx.seg_len = TB;
  gx.splits = sx;
  gx.kchunk = cx;
  gx.c16 = dt;
  err = gemm(gx, 2, false, false, D % (16 / es) == 0 && aligned16(x) && aligned16(dgp), false, dt, dt, stream);
  if (err) return err;
  if (dt) {  // ws is free again: dWx's split sums have run
    const int nblk = cdiv(T, DB_STEPS);
    db_blocks_kernel<<<dim3(cdiv((int)G, 128), 2, nblk), 128, 0, stream>>>(static_cast<const bf16*>(dgs), ws,
                                                                            T, B, (int)G);
    db_sum_kernel<<<dim3(cdiv((int)G, 128), 2), 128, 0, stream>>>(ws, static_cast<bf16*>(db), nblk, (int)G);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return dwh_products(ys, dg, dwh, ws, T, B, 2, H, sh, ch, dt, stream);
}

// lstm_seq's product: dwh [dirs, H, 4H] = h_prev^T dg per direction, from
// ys [T, R, H] and the float gate gradients dg [T, R, 4H] (kernel time);
// ys and dwh of storage type dt; ws as above with sh x (H+1).
extern "C" int e2e_lstm_seq_bwd_products(const void* ys, const float* dg, void* dwh, float* ws,
                                         int T, int B, int dirs, int H, int sh, int ch, int dt,
                                         void* stream) {
  if (H % 8 != 0 || H > 1024 || dirs < 1 || dirs > 2 || B < 1 || T < 1 || sh < 1 || dt < 0 || dt > 1)
    return (int)cudaErrorInvalidValue;
  return dwh_products(ys, dg, dwh, ws, T, B, dirs, H, sh, ch, dt, (cudaStream_t)stream);
}
