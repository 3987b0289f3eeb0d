// Bidirectional masked LSTM layer, forward, with x @ Wx inside.
//
// Replaces the forward of the TPU kernel e2e_asr_tpu/ops/rnn_pallas.py
// lstm_seq_fused (_fused_fwd_call / _fused_fwd_kernel). Same contract:
// x [T, B, D] is shared by both directions; rows [0, B) run forward in
// original time, rows [B, 2B) run the backward direction in kernel time
// (kernel step k reads original time T-1-k); gates = x_t @ Wx + h @ Wh + b
// in i,f,g,o order; zero initial state; where mask = 0 the h/c carries
// freeze and the output row is zero. Output ys [T, 2B, H]. The inference
// variant writes nothing else; the training variant (TRAIN) also writes,
// per step, the residuals the TPU forward streams out for its backward
// (rnn_pallas.py _fused_fwd_kernel c_ref / acts_ref): the frozen c carry
// c_out [T, 2B, H] and the gate activations acts [T, 2B, 4H] (i, f, g, o),
// read by csrc/lstm_bidir_bwd.cu.
//
// What bounds it on the H100: the recurrence. Every step must finish
// h_{t-1} @ Wh before the next starts, and 2B rows (32 at decode B=16)
// give little parallel work per step: (D + H) * 4H FMAs per row. On one SM
// per row a step takes tens of microseconds (the direction's Wh, 1.6 MB at
// H=320, streams from L2 through one SM), far from the card's FLOP and HBM
// bounds.
// Design: each row (one direction of one utterance; no grid-wide sync
// needed) has its hidden units split over a thread-block cluster of CL
// blocks: block q owns units [q*H/CL, (q+1)*H/CL) and their four gate
// columns, so each block streams 1/CL of Wh and Wx per step. Each block computes its gate columns' partial
// products (KS threads per column split the reduction), updates c for its
// units in registers, and writes its slice of h_t into every block of the
// cluster through distributed shared memory; one cluster barrier per step
// publishes h_t (h is double-buffered, so no second barrier is needed).
// The input projection is done for TS steps at once from a shared-memory
// tile of x, so each Wx element read from L2 feeds TS FMAs. Tensor-core
// products are later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CL = 8;  // blocks per cluster: a row's hidden units split CL ways
constexpr int TS = 8;  // time steps per input-projection tile
constexpr int KS = 2;  // threads per gate column (reduction split)

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

// launch bounds: H up to 1024 gives up to 1024 threads, so at most 64 registers
template <bool TRAIN>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(1024)
lstm_bidir_fwd_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                      const float* __restrict__ wx, const float* __restrict__ wh,
                      const float* __restrict__ bias, float* __restrict__ ys,
                      float* __restrict__ c_out, float* __restrict__ acts,
                      int T, int B, int D, int H) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / CL;
  const int dir = cid / B;
  const int row = cid % B;
  const int G = 4 * H;
  const int Hc = H / CL;   // hidden units owned by this block
  const int NC = 4 * Hc;   // gate columns owned by this block
  const int u0 = rank * Hc;

  extern __shared__ float smem[];
  float* x_s = smem;               // [TS][D]
  float* h_s = x_s + TS * D;       // [2][H], double-buffered h
  float* xw_s = h_s + 2 * H;       // [TS][NC] projections + bias
  float* part = xw_s + TS * NC;    // [KS][TS][NC] split partial sums

  const int tid = threadIdx.x;
  const bool active = tid < KS * NC;
  const int col = tid % NC;
  const int split = tid / NC;
  const int gcol = (col / Hc) * H + u0 + col % Hc;  // gate column in [0, 4H)
  const float* wxd = wx + (long)dir * D * G + gcol;
  const float* whd = wh + (long)dir * H * G + gcol;
  const float* bd = bias + (long)dir * G;

  // cell owner: thread tid < Hc updates unit u0 + tid
  const bool owner = tid < Hc;
  const int ou = owner ? tid : 0;
  float c = 0.0f;

  for (int i = tid; i < 2 * H; i += blockDim.x) h_s[i] = 0.0f;
  cluster.sync();  // every block's h buffers are zero before any remote write

  for (int k0 = 0; k0 < T; k0 += TS) {
    const int nsteps = min(TS, T - k0);
    __syncthreads();
    for (int idx = tid; idx < TS * D; idx += blockDim.x) {
      const int s = idx / D;
      const int d = idx % D;
      float v = 0.0f;
      if (s < nsteps) {
        const int k = k0 + s;
        const int t = dir == 0 ? k : T - 1 - k;
        v = x[((long)t * B + row) * D + d];
      }
      x_s[idx] = v;
    }
    __syncthreads();

    // input projection of this tile: split partials over d, then reduce
    if (active) {
      float acc[TS];
#pragma unroll
      for (int s = 0; s < TS; ++s) acc[s] = 0.0f;
#pragma unroll 4
      for (int d = split; d < D; d += KS) {
        const float w = __ldg(wxd + (long)d * G);
#pragma unroll
        for (int s = 0; s < TS; ++s) acc[s] = fmaf(x_s[s * D + d], w, acc[s]);
      }
#pragma unroll
      for (int s = 0; s < TS; ++s) part[(split * TS + s) * NC + col] = acc[s];
    }
    __syncthreads();
    for (int idx = tid; idx < TS * NC; idx += blockDim.x) {
      const int cc = idx % NC;
      float v = bd[(cc / Hc) * H + u0 + cc % Hc];
#pragma unroll
      for (int sp = 0; sp < KS; ++sp) v += part[sp * TS * NC + idx];
      xw_s[idx] = v;
    }
    __syncthreads();

    for (int s = 0; s < nsteps; ++s) {
      const int k = k0 + s;
      const int t = dir == 0 ? k : T - 1 - k;
      const float* hc = h_s + (k & 1) * H;
      float* hn = h_s + ((k + 1) & 1) * H;
      if (active) {
        float gs = 0.0f;
#pragma unroll 8
        for (int kk = split; kk < H; kk += KS) gs = fmaf(hc[kk], __ldg(whd + (long)kk * G), gs);
        part[split * NC + col] = gs;
      }
      __syncthreads();
      if (owner) {
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int cc = g * Hc + ou;
          float v = xw_s[s * NC + cc];
#pragma unroll
          for (int sp = 0; sp < KS; ++sp) v += part[sp * NC + cc];
          pre[g] = v;
        }
        const float ig = sigmoidf_(pre[0]);
        const float fg = sigmoidf_(pre[1]);
        const float gg = tanhf(pre[2]);
        const float og = sigmoidf_(pre[3]);
        const float c2 = fg * c + ig * gg;
        const float h2 = og * tanhf(c2);
        const bool m = mask[(long)t * B + row] > 0.0f;
        const int hi = u0 + ou;
        const float hv = m ? h2 : hc[hi];
        if (m) c = c2;
        const long r = (long)k * 2 * B + dir * B + row;
        ys[r * H + hi] = m ? h2 : 0.0f;
        if (TRAIN) {
          c_out[r * H + hi] = c;
          float* a = acts + r * G + hi;
          a[0] = ig;
          a[H] = fg;
          a[2 * H] = gg;
          a[3 * H] = og;
        }
#pragma unroll
        for (int q = 0; q < CL; ++q) *cluster.map_shared_rank(hn + hi, q) = hv;
      }
      cluster.sync();  // h_t is in every block; h_{t-1} and part are free again
    }
  }
}

template <bool TRAIN>
int launch(const float* x, const float* mask, const float* wx, const float* wh, const float* b,
           float* ys, float* c_out, float* acts, int T, int B, int D, int H,
           cudaStream_t stream) {
  const int nc = 4 * (H / CL);
  const size_t smem = sizeof(float) * ((size_t)TS * D + 2 * (size_t)H + (size_t)TS * nc +
                                       (size_t)KS * TS * nc);
  cudaError_t e = cudaFuncSetAttribute(lstm_bidir_fwd_kernel<TRAIN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = ((KS * nc + 31) / 32) * 32;  // KS * nc >= H / CL cell owners
  lstm_bidir_fwd_kernel<TRAIN><<<2 * B * CL, threads, smem, stream>>>(x, mask, wx, wh, b, ys,
                                                                     c_out, acts, T, B, D, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* e2e_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [T, B, D], mask [T, B], wx [2, D, 4H], wh [2, H, 4H], b [2, 4H]
// -> ys [T, 2B, H]; all f32, contiguous. H is a multiple of 8 and at most
// 1024.
extern "C" int e2e_lstm_bidir_fwd(const float* x, const float* mask, const float* wx,
                                  const float* wh, const float* b, float* ys, int T, int B,
                                  int D, int H, void* stream) {
  if (H % CL != 0 || KS * 4 * (H / CL) > 1024) return (int)cudaErrorInvalidValue;
  return launch<false>(x, mask, wx, wh, b, ys, nullptr, nullptr, T, B, D, H,
                       (cudaStream_t)stream);
}

// The training variant: as above, plus c_out [T, 2B, H] (the c carry after
// each step, frozen where mask = 0) and acts [T, 2B, 4H] (the gate
// activations of each step), both in the layout of ys.
extern "C" int e2e_lstm_bidir_fwd_train(const float* x, const float* mask, const float* wx,
                                        const float* wh, const float* b, float* ys, float* c_out,
                                        float* acts, int T, int B, int D, int H, void* stream) {
  if (H % CL != 0 || KS * 4 * (H / CL) > 1024) return (int)cudaErrorInvalidValue;
  return launch<true>(x, mask, wx, wh, b, ys, c_out, acts, T, B, D, H, (cudaStream_t)stream);
}
