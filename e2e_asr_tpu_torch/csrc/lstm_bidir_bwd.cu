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
// What bounds it on the H100: the sweep is a recurrence like the forward
// (every step needs the last step's dh, i.e. dgates Wh^T over all 4H gate
// columns), latency-bound at 2B = 32 rows; the products are ~48 GFLOP per
// flagship layer (D = 1280), bound by f32 FMA throughput on the CUDA cores.
// Design: the sweep mirrors the forward. Each row (one direction of one
// utterance) runs on a cluster of CL = 8 blocks; block q owns H/8 hidden
// units, computes their 4 gate gradients per step, writes them to dg and
// to every block of the cluster through distributed shared memory
// (double-buffered), and after one cluster barrier per step forms dh for
// its units from the row's whole dgates vector and its H/8 rows of Wh (KS
// lanes per unit, reduced by warp shuffles). The dh and dc carries stay in
// registers of each unit's owner lane. The products run in a tiled f32
// GEMM (64x64 tiles, shared-memory staging, 4x4 outputs a thread; no tensor
// cores yet) whose operands are addressed through (time, batch) index maps,
// so the kernel-time backward rows and the h_prev shift need no copies.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CL = 8;  // blocks per cluster: a row's hidden units split CL ways
constexpr int KS = 8;  // lanes per hidden unit in dgates Wh^T

__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(1024)
lstm_bwd_sweep_kernel(const float* __restrict__ mask, const float* __restrict__ wh,
                      const float* __restrict__ c_out, const float* __restrict__ acts,
                      const float* __restrict__ dy, float* __restrict__ dg, int T, int B,
                      int H) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / CL;
  const int dir = cid / B;
  const int row = cid % B;
  const int r = dir * B + row;  // row of ys / c_out / acts / dy / dg
  const int G = 4 * H;
  const int Hc = H / CL;
  const int tid = threadIdx.x;
  const int ul = tid / KS;
  const int split = tid % KS;
  const bool active = ul < Hc;
  const bool owner = active && split == 0;
  const int u = rank * Hc + (active ? ul : 0);
  const float* whu = wh + ((long)dir * H + u) * G;  // row u of Wh[dir]

  extern __shared__ float dg_s[];  // [2][G]: the row's dgates, double-buffered
  float dh = 0.0f;
  float dc = 0.0f;
  cluster.sync();  // every block of the cluster runs before any remote write

  for (int k = T - 1; k >= 0; --k) {
    const int t = dir == 0 ? k : T - 1 - k;
    const float m = mask[(long)t * B + row] > 0.0f ? 1.0f : 0.0f;
    float* buf = dg_s + (k & 1) * G;
    if (owner) {
      const long base = (long)k * 2 * B + r;
      const float* a = acts + base * G;
      const float ig = a[u];
      const float fg = a[H + u];
      const float gg = a[2 * H + u];
      const float og = a[3 * H + u];
      const float tc = tanhf(c_out[base * H + u]);
      const float cp = k > 0 ? c_out[(base - 2 * B) * H + u] : 0.0f;
      const float dh2 = m * (dy[base * H + u] + dh);
      const float dc2 = m * dc + dh2 * og * (1.0f - tc * tc);
      const float d0 = dc2 * gg * ig * (1.0f - ig);
      const float d1 = dc2 * cp * fg * (1.0f - fg);
      const float d2 = dc2 * ig * (1.0f - gg * gg);
      const float d3 = dh2 * tc * og * (1.0f - og);
      float* dgo = dg + base * G;
      dgo[u] = d0;
      dgo[H + u] = d1;
      dgo[2 * H + u] = d2;
      dgo[3 * H + u] = d3;
#pragma unroll
      for (int q = 0; q < CL; ++q) {
        float* rb = cluster.map_shared_rank(buf, q);
        rb[u] = d0;
        rb[H + u] = d1;
        rb[2 * H + u] = d2;
        rb[3 * H + u] = d3;
      }
      dc = (1.0f - m) * dc + dc2 * fg;
    }
    cluster.sync();  // the row's dgates are in every block
    float s = 0.0f;
    if (active) {
#pragma unroll 8
      for (int j = split; j < G; j += KS) s = fmaf(buf[j], __ldg(whu + j), s);
    }
#pragma unroll
    for (int o = KS / 2; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o, KS);
    if (owner) dh = (1.0f - m) * dh + s;
  }
}

// Index map of one GEMM index i: offset (i / div) * hi + (i % div) * lo.
struct IMap {
  long div, hi, lo;
  __device__ __forceinline__ long operator()(long i) const {
    return div == 1 ? i * hi : (i / div) * hi + (i % div) * lo;
  }
};

constexpr int BM = 64, BN = 64, BK = 16;

// C(m, n) (+)= sum_k A(m, k) B(k, n), every operand addressed through index
// maps (A: am(m) + ak(k), B: bk(k) + bn(n), C: cm(m) + cn(n)). A_KF / B_KF
// say whether k is the operand's contiguous index, which picks the thread
// layout of the tile loads.
template <bool A_KF, bool B_KF>
__global__ void __launch_bounds__(256)
gemm_map_kernel(const float* __restrict__ A, const float* __restrict__ Bm, float* __restrict__ C,
                int M, int N, int K, IMap am, IMap ak, IMap bk, IMap bn, IMap cm, IMap cn,
                int accumulate) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + 256 * q;
      const int kk = A_KF ? e % BK : e / BM;
      const int mm = A_KF ? e / BK : e % BM;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? A[am(gm) + ak(gk)] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + 256 * q;
      const int kk = B_KF ? e % BK : e / BN;
      const int nn = B_KF ? e / BK : e % BN;
      const int gn = n0 + nn, gk = k0 + kk;
      Bs[kk][nn] = (gn < N && gk < K) ? Bm[bk(gk) + bn(gn)] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      float* c = C + cm(gm) + cn(gn);
      *c = accumulate ? *c + acc[i][j] : acc[i][j];
    }
  }
}

// db[dir, n] = sum over the rows (k, b) of dg[k, dir*B + b, n]
__global__ void bias_grad_kernel(const float* __restrict__ dg, float* __restrict__ db, int T,
                                 int B, int G) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int dir = blockIdx.y;
  if (n >= G) return;
  float s = 0.0f;
  for (int k = 0; k < T; ++k) {
    const float* p = dg + ((long)k * 2 * B + (long)dir * B) * G + n;
    for (int b = 0; b < B; ++b) s += p[(long)b * G];
  }
  db[(long)dir * G + n] = s;
}

constexpr IMap plain(long stride) { return IMap{1, stride, 0}; }

template <bool A_KF, bool B_KF>
int gemm(const float* A, const float* Bm, float* C, int M, int N, int K, IMap am, IMap ak,
         IMap bk, IMap bn, IMap cm, IMap cn, int accumulate, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_map_kernel<A_KF, B_KF><<<grid, 256, 0, stream>>>(A, Bm, C, M, N, K, am, ak, bk, bn, cm,
                                                         cn, accumulate);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* e2e_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [T, B, D], mask [T, B], wx [2, D, 4H], wh [2, H, 4H], ys / c_out [T, 2B, H],
// acts [T, 2B, 4H], dy [T, 2B, H] -> dx [T, B, D], dwx [2, D, 4H],
// dwh [2, H, 4H], db [2, 4H]; dg [T, 2B, 4H] is scratch (the gate
// gradients, kernel time). All f32, contiguous. H is a multiple of 8 and at
// most 1024.
extern "C" int e2e_lstm_bidir_bwd(const float* x, const float* mask, const float* wx,
                                  const float* wh, const float* ys, const float* c_out,
                                  const float* acts, const float* dy, float* dg, float* dx,
                                  float* dwx, float* dwh, float* db, int T, int B, int D, int H,
                                  void* stream_) {
  if (H % CL != 0 || H > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  const long G = 4L * H;
  const long R = 2L * B;  // rows of a time step in the kernel-time tensors
  const size_t smem = sizeof(float) * 2 * G;
  cudaError_t e = cudaFuncSetAttribute(lstm_bwd_sweep_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = ((H / CL * KS + 31) / 32) * 32;
  lstm_bwd_sweep_kernel<<<2 * B * CL, threads, smem, stream>>>(mask, wh, c_out, acts, dy, dg, T,
                                                               B, H);
  int err = (int)cudaGetLastError();
  if (err) return err;

  const long TB = (long)T * B;
  // rows (t, b) of dx in original time; the backward direction's dgates of
  // original time t sit at kernel time T-1-t, row B+b
  const IMap rows_x{B, (long)B * D, D};
  const IMap dg_fwd_rows{B, R * G, G};
  const IMap dg_bwd_rows{B, -R * G, G};
  const float* dg_bwd_t0 = dg + ((long)(T - 1) * R + B) * G;
  // dx = dg_fwd Wx0^T + dg_bwd Wx1^T: B(k = j, n) = wx[dir][n][j]
  err = gemm<true, true>(dg, wx, dx, (int)TB, D, (int)G, dg_fwd_rows, plain(1), plain(1),
                         plain(G), rows_x, plain(1), 0, stream);
  if (err) return err;
  err = gemm<true, true>(dg_bwd_t0, wx + (long)D * G, dx, (int)TB, D, (int)G, dg_bwd_rows,
                         plain(1), plain(1), plain(G), rows_x, plain(1), 1, stream);
  if (err) return err;

  // dWx[0] = x^T dg_fwd over rows (t, b)
  const IMap krows_dg{B, R * G, G};
  err = gemm<false, false>(x, dg, dwx, D, (int)G, (int)TB, plain(1), rows_x, krows_dg, plain(1),
                           plain(G), plain(1), 0, stream);
  if (err) return err;
  // dWx[1] = x^T dg_bwd: kernel step k reads x at original time T-1-k
  const IMap krows_x_rev{B, -(long)B * D, D};
  err = gemm<false, false>(x + (long)(T - 1) * B * D, dg + (long)B * G, dwx + (long)D * G, D,
                           (int)G, (int)TB, plain(1), krows_x_rev, krows_dg, plain(1), plain(G),
                           plain(1), 0, stream);
  if (err) return err;

  // dWh[dir] = h_prev^T dg over kernel steps k >= 1: h_prev = ys[k-1]
  const long TB1 = (long)(T - 1) * B;
  const IMap krows_h{B, R * H, H};
  for (int d = 0; d < 2; ++d) {
    err = gemm<false, false>(ys + (long)d * B * H, dg + (R + (long)d * B) * G,
                             dwh + (long)d * H * G, H, (int)G, (int)TB1, plain(1), krows_h,
                             krows_dg, plain(1), plain(G), plain(1), 0, stream);
    if (err) return err;
  }

  bias_grad_kernel<<<dim3((unsigned)((G + 255) / 256), 2), 256, 0, stream>>>(dg, db, T, B, (int)G);
  return (int)cudaGetLastError();
}
