// Masked LSTM layer, forward: the recurrence over precomputed input
// projections, and the fused layer's input projection.
//
// Replaces the forward of two TPU kernels of e2e_asr_tpu/ops/rnn_pallas.py:
// - lstm_seq (_lstm_seq_fwd_call / _fwd_kernel): xw [T, R, 4H] = x Wx + b
//   computed by the caller for R = Dirs * B rows already in kernel time
//   (direction d owns rows [dB, (d+1)B) and wh[d]), mask [T, R] per row;
// - lstm_seq_fused (_fused_fwd_call / _fused_fwd_kernel): x [T, B, D] shared
//   by both directions, mask [T, B] in original time; rows [0, B) run forward
//   in original time, rows [B, 2B) the backward direction in kernel time
//   (kernel step k reads original time T-1-k). The TPU kernel computes x Wx
//   + b in its own body; here this file's projection writes it for the whole
//   sequence into an xw scratch [T, 2B, 4H] in kernel time (the backward
//   direction flipped by the output row map), and the same sweep runs over it.
// Same contract for both: gates = xw_t + h Wh in i,f,g,o order, zero initial
// state; where mask = 0 the h and c carries freeze and the output row is
// zero. Output ys [T, R, H]; the training variant also writes, per step, the
// residuals read by csrc/lstm_bidir_bwd.cu: the c carry c_out [T, R, H] and
// the gate activations acts [T, R, 4H] (i, f, g, o), in the layout of ys.
//
// What bounds it on the H100. The sweep: latency. Every step needs all of
// h_{t-1} before h_{t-1} Wh, and R rows (32 in the flagship, 64 in the
// convergence recipe) give little work a step: 8 H^2 flops a row. A design
// that reads Wh from L2 on every step (each row a cluster of 8 blocks, each
// block its 4H/8 gate columns: 205 KB a block a step at H = 320) is bound by
// L2 bandwidth instead. The projection: the tensor cores' TF32 rate (~21
// GFLOP at the flagship's first layer, three products a tile).
//
// Design, the sweep: one persistent cooperative grid, a block for each
// (direction, 16 hidden units, group of 8 NT rows). The block's 64 gate
// columns of Wh (its units' i, f, g, o) stay in shared memory for the whole
// launch, stored in the mma's fragment order (read from L2 where they do not
// fit). A step: the product h_{t-1} [rows x H] Wh [H x 64] on the tensor
// cores (mma m16n8k8, one m16 tile a gate, rows as N, three TF32 products a
// tile: float32 accuracy), each warp taking one gate and every other
// 16-wide K chunk, its partial tiles summed in a fixed order; the cell
// update of the block's (unit, row) pairs with c and h kept in registers and
// the step's xw and mask loaded during the last step's barrier; the stores
// of ys (c_out and acts); h_t published through a global double buffer (L2),
// one grid barrier a step, and the next step's rows of h staged into shared
// memory with cp.async. The plan (rows a block, weights resident or not)
// comes from e2e_lstm_fwd_plan: the grid must be resident,
// or the plan has none and the wrapper raises. (One cluster of up to 16
// blocks per (direction, row group), h pushed through distributed shared
// memory with a cluster barrier a step, measured no faster: PERF.md.)
//
// Design, the projection: the GEMM of csrc/gemm_tf32.cuh, both directions in
// one launch, x's rows read through a plain map, the bias added and the rows
// placed in kernel time by the epilogue's row map, each k8 step's products
// summed apart (STEP_SUMS: K = D is up to 1280 here).
//
// Storage types (csrc/bf16.cuh): each kernel is a template on its storage
// type S (float or bf16: xw, x, the weights, ys, c_out) and on the type A of
// acts; the bf16 variants round where the TPU kernels round at bfloat16:
// the gates and the cell in float32 from the widened inputs, h and c carried
// rounded to bf16 (h_t from the unrounded c_t, ys the masked unrounded h_t
// rounded), acts float32 for lstm_seq (its TPU backward rebuilds the gates in
// float32) and bf16 for the fused layer (its TPU kernel stores them so), and
// the fused layer's projection x Wx + b summed in float32 and rounded once.
// Wh is resident in S (half the shared memory in bf16); h and Wh both hold
// bf16 values there, so one TF32 product a tile is exact and the other two
// of the float32 build are left out.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "gemm_tf32.cuh"
#include "tf32_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int SMEM_MAX = 232448 - 1024;  // a block's shared memory on the H100, less a margin
constexpr int FW_US = 16;                // hidden units a block (one m16 tile a gate)
constexpr int FW_KSPLIT = 2;             // warps a gate, each taking every other K chunk
constexpr int FW_NT = 32 * 4 * FW_KSPLIT;  // threads a block

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

__host__ __device__ inline int fw_kp(int H) { return cdiv(H, 16) * 16; }  // K in whole 16-wide chunks
__host__ __device__ inline int fw_ldh(int H) { return fw_kp(H) | 16; }    // 16-byte h loads conflict-free

// the resident Wh columns' share of shared memory, in floats (none where
// w_smem is 0; es: bytes an element of Wh)
__host__ __device__ inline int fw_wh_floats(int H, int w_smem, int es) { return w_smem ? 64 * fw_kp(H) * es / 4 : 0; }

// bytes of shared memory: the resident Wh columns, h of the block's rows (float), the
// warps' partial tiles
__host__ __device__ inline int fw_smem_bytes(int H, int nt, int w_smem, int es) {
  return 4 * (fw_wh_floats(H, w_smem, es) + 8 * nt * fw_ldh(H) + 4 * FW_KSPLIT * nt * 128);
}

// pointers of the storage types S (xw, wh, ys, c_out) and A (acts)
struct FwdArgs {
  const void *xw;
  const float* mask;
  const void* wh;
  void *ys, *c_out, *acts;
  float* hbuf;
  int T, B, H, dirs, row_mask, train;
  int slices, nrg, w_smem;
};

// four consecutive rows k0 .. k0+3 of Wh column col (zero where col < 0 or
// k0 >= H; H is a multiple of 8, k0 of 4)
template <typename S>
__device__ __forceinline__ float4 wh_col4(const S* whd, int G, int H, int col, int k0) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col >= 0 && k0 < H) {
    const S* p = whd + (long)k0 * G + col;
    v = make_float4(ldgf(p), ldgf(p + G), ldgf(p + 2 * G), ldgf(p + 3 * G));
  }
  return v;
}

// the step's inputs of the thread's (unit, row) pairs: pair p = tid + FW_NT i
// owns unit p % 16 and row p / 16 of the block's group
template <int NT, typename S>
__device__ __forceinline__ void load_step(const FwdArgs& a, int k, int dir, int u0, int nu, int b0,
                                          int nb, int tid, float (&xv)[NT][4], float (&mk)[NT]) {
  const int R = a.dirs * a.B, G = 4 * a.H;
  const int t = dir == 0 ? k : a.T - 1 - k;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int p = tid + FW_NT * i, ul = p % FW_US, rl = p / FW_US;
    if (ul < nu && rl < nb) {
      const int r = dir * a.B + b0 + rl;
      const S* x = static_cast<const S*>(a.xw) + ((long)k * R + r) * G + u0 + ul;
      xv[i][0] = ldf(x);
      xv[i][1] = ldf(x + a.H);
      xv[i][2] = ldf(x + 2 * a.H);
      xv[i][3] = ldf(x + 3 * a.H);
      mk[i] = a.row_mask ? a.mask[(long)k * R + r] : a.mask[(long)t * a.B + b0 + rl];
    }
  }
}

// NT n8 tiles of rows a block; storage type S, acts in A
template <int NT, typename S, typename A>
__global__ void __launch_bounds__(FW_NT, 1) lstm_fwd_sweep_kernel(FwdArgs a) {
  constexpr bool EXACT = sizeof(S) == 2;  // Wh and h hold bf16 values: one TF32 product is exact
  constexpr int NA = NT >= 4 ? 1 : 2;  // accumulator sets a tile (the two mma steps of a chunk)
  cg::grid_group grid = cg::this_grid();
  const int T = a.T, B = a.B, H = a.H, G = 4 * H, R = a.dirs * B;
  const int KC = fw_kp(H) / 16, LDH = fw_ldh(H);
  const int slice = blockIdx.x % a.slices;
  const int rg = (blockIdx.x / a.slices) % a.nrg;
  const int dir = blockIdx.x / (a.slices * a.nrg);
  const int u0 = slice * FW_US, nu = min(FW_US, H - u0);
  const int b0 = rg * 8 * NT, nb = min(8 * NT, B - b0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int gate = warp % 4, kh = warp / 4;  // the warp's gate (m16 tile) and K chunks kh, kh + FW_KSPLIT, ...

  extern __shared__ __align__(16) float smem[];
  S* whs = reinterpret_cast<S*>(smem);                        // [KC][4][2][32][4] (w_smem)
  float* hs = smem + fw_wh_floats(H, a.w_smem, sizeof(S));    // [8 NT][LDH]
  float* red = hs + 8 * NT * LDH;                             // [warps][NT][16][8]
  const S* whd = static_cast<const S*>(a.wh) + (long)dir * H * G;

  // the block's columns of Wh (column m: gate m / 16, unit u0 + m % 16; none
  // past nu) in fragment order: chunk c, gate j, half hf, lane (g, q) holds
  // rows 16c + 4q .. +3 of column 16j + 8hf + g
  if (a.w_smem) {
    const int kp = fw_kp(H);
    for (int i = tid; i < kp * 64; i += FW_NT) {
      const int k = i / 64, m = i % 64, ul = m % 16;
      const float v = k < H && ul < nu ? ldf(whd + (long)k * G + (m / 16) * H + u0 + ul) : 0.0f;
      const int kk = k % 16;
      stf(whs + ((((k / 16) * 4 + m / 16) * 2 + ul / 8) * 32 + (ul % 8) * 4 + kk / 4) * 4 + kk % 4, v);
    }
  }
  for (int i = tid; i < 8 * NT * LDH; i += FW_NT) hs[i] = 0.0f;  // h_{-1} = 0, padding 0
  const int col0 = g < nu ? gate * H + u0 + g : -1;           // the warp's columns of A (w_smem = 0)
  const int col1 = g + 8 < nu ? gate * H + u0 + g + 8 : -1;

  float c[NT], hcar[NT], xv[NT][4], mk[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) c[i] = hcar[i] = 0.0f;
  load_step<NT, S>(a, 0, dir, u0, nu, b0, nb, tid, xv, mk);
  __syncthreads();

  for (int k = 0; k < T; ++k) {
    if (k > 0) {  // h_{k-1} of the group's rows from L2
      const float* src = a.hbuf + ((long)(k & 1) * R + dir * B + b0) * H;
      for (int i = tid; i < nb * (H / 4); i += FW_NT) {
        const int rl = i / (H / 4), c4 = (i % (H / 4)) * 4;
        cp_async16(hs + rl * LDH + c4, src + (long)rl * H + c4);
      }
      cp_async_wait_all();
      __syncthreads();
    }

    // h_{k-1} Wh for the block's columns: the warp's gate over its chunks
    float acc[NT][3 * NA][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 3 * NA; ++e) acc[n][e][0] = acc[n][e][1] = acc[n][e][2] = acc[n][e][3] = 0.0f;
    for (int cc = kh; cc < KC; cc += FW_KSPLIT) {
      float4 w0, w1;
      if (a.w_smem) {
        const S* wp = whs + ((cc * 4 + gate) * 2 * 32 + lane) * 4;
        w0 = ld4(wp);
        w1 = ld4(wp + 128);
      } else {
        w0 = wh_col4(whd, G, H, col0, 16 * cc + 4 * q);
        w1 = wh_col4(whd, G, H, col1, 16 * cc + 4 * q);
      }
      // the chunk's two mma steps: k index t of step s is row 16cc + 4t + s
      // of Wh in a's column (and of h in b's row), so that each operand is
      // one 16-byte load
      uint32_t ah[2][4], al[2][4];
      const float afr[2][4] = {{w0.x, w1.x, w0.y, w1.y}, {w0.z, w1.z, w0.w, w1.w}};
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) tf32_split(afr[s][e], ah[s][e], al[s][e]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + (n * 8 + g) * LDH + 16 * cc + 4 * q);
        const float bfr[2][2] = {{hv.x, hv.y}, {hv.z, hv.w}};
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          uint32_t bh[2], bl[2];
          tf32_split(bfr[s][0], bh[0], bl[0]);
          tf32_split(bfr[s][1], bh[1], bl[1]);
          if constexpr (!EXACT) {
            mma_tf32(acc[n][3 * (s % NA)], al[s], bh);
            mma_tf32(acc[n][3 * (s % NA) + 1], ah[s], bl);
          }
          mma_tf32(acc[n][3 * (s % NA) + 2], ah[s], bh);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = (acc[n][0][e] + acc[n][1][e]) + acc[n][2][e];
        if constexpr (NA == 2) v[e] += (acc[n][3][e] + acc[n][4][e]) + acc[n][5][e];
      }
      float* rp = red + (warp * NT + n) * 128;
      rp[g * 8 + 2 * q] = v[0];
      rp[g * 8 + 2 * q + 1] = v[1];
      rp[(g + 8) * 8 + 2 * q] = v[2];
      rp[(g + 8) * 8 + 2 * q + 1] = v[3];
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < NT; ++i) {  // cell update and stores
      const int p = tid + FW_NT * i, ul = p % FW_US, rl = p / FW_US;
      if (!(ul < nu && rl < nb)) continue;
      float pre[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = 0.0f;
#pragma unroll
        for (int s = 0; s < FW_KSPLIT; ++s) v += red[((s * 4 + j) * NT + rl / 8) * 128 + ul * 8 + rl % 8];
        pre[j] = xv[i][j] + v;
      }
      const float ig = sigmoidf_(pre[0]);
      const float fg = sigmoidf_(pre[1]);
      const float gg = tanhf(pre[2]);
      const float og = sigmoidf_(pre[3]);
      const float c2 = fg * c[i] + ig * gg;
      const float h2 = og * tanhf(c2);
      const bool m = mk[i] > 0.0f;
      if (m) {
        c[i] = rnd<S>(c2);
        hcar[i] = rnd<S>(h2);
      }
      const long r = (long)k * R + dir * B + b0 + rl;
      const int u = u0 + ul;
      stf(static_cast<S*>(a.ys) + r * H + u, m ? h2 : 0.0f);
      if (a.train) {
        stf(static_cast<S*>(a.c_out) + r * H + u, c[i]);
        A* ac = static_cast<A*>(a.acts) + r * G + u;
        stf(ac, ig);
        stf(ac + H, fg);
        stf(ac + 2 * H, gg);
        stf(ac + 3 * H, og);
      }
    }
    if (k + 1 == T) break;
#pragma unroll
    for (int i = 0; i < NT; ++i) {  // publish h_k
      const int p = tid + FW_NT * i, ul = p % FW_US, rl = p / FW_US;
      if (ul < nu && rl < nb)
        a.hbuf[((long)((k + 1) & 1) * R + dir * B + b0 + rl) * H + u0 + ul] = hcar[i];
    }
    load_step<NT, S>(a, k + 1, dir, u0, nu, b0, nb, tid, xv, mk);
    grid.sync();  // h_k is in hbuf; hs and red are free again
  }
}

template <typename S, typename A>
const void* sweep_kernel_of(int nt) {
  return nt == 1 ? (const void*)lstm_fwd_sweep_kernel<1, S, A>
         : nt == 2 ? (const void*)lstm_fwd_sweep_kernel<2, S, A>
                   : (const void*)lstm_fwd_sweep_kernel<4, S, A>;
}

// the variant of storage type dt (0 float, 1 bf16) and acts type adt; a
// float variant keeps float acts
const void* sweep_kernel(int nt, int dt, int adt) {
  return !dt ? sweep_kernel_of<float, float>(nt)
         : adt ? sweep_kernel_of<bf16, bf16>(nt) : sweep_kernel_of<bf16, float>(nt);
}

int elem_bytes(int dt) { return dt ? 2 : 4; }

// out = [n8 tiles of rows a block (-1: no grid can be resident), Wh
// resident in shared memory (1; 0: read from L2), shared memory bytes a
// block, blocks]: the first of (w_smem = 1, 0) x (nt = 1, 2, 4) whose grid
// is resident at once
int fwd_plan(int B, int dirs, int H, int dt, int adt, int* out) {
  int dev = 0, nsm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  out[0] = -1;
  for (int w_smem = 1; w_smem >= 0; --w_smem) {
    for (int nt = 1; nt <= 4; nt *= 2) {
      const int smem = fw_smem_bytes(H, nt, w_smem, elem_bytes(dt));
      if (smem > SMEM_MAX) continue;
      const void* kern = sweep_kernel(nt, dt, adt);
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      int per_sm = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, FW_NT, smem);
      if (e != cudaSuccess) return (int)e;
      const int nb = dirs * cdiv(H, FW_US) * cdiv(B, 8 * nt);
      if (nb <= per_sm * nsm) {
        out[0] = nt;
        out[1] = w_smem;
        out[2] = smem;
        out[3] = nb;
        return 0;
      }
    }
  }
  return 0;
}

bool fwd_shape_ok(int B, int dirs, int H) {
  return H % 8 == 0 && H >= 8 && H <= 1024 && dirs >= 1 && dirs <= 2 && B >= 1;
}

}  // namespace

extern "C" const char* e2e_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The sweep's plan for R = dirs * B rows of H units, storage type dt (0
// float, 1 bf16) and acts type adt: out as fwd_plan above (out[0] = -1
// where no grid can be resident).
extern "C" int e2e_lstm_fwd_plan(int B, int dirs, int H, int dt, int adt, int* out, void* stream) {
  (void)stream;
  if (!fwd_shape_ok(B, dirs, H) || dt < 0 || dt > 1 || adt < 0 || adt > 1) return (int)cudaErrorInvalidValue;
  return fwd_plan(B, dirs, H, dt, adt, out);
}

// The recurrence over xw [T, dirs B, 4H] (rows in kernel time) -> ys
// [T, dirs B, H]; with train != 0 also c_out [T, dirs B, H] and acts
// [T, dirs B, 4H]. mask [T, B] in original time (row_mask 0, the fused
// layer: dirs = 2) or [T, dirs B] in kernel time (row_mask 1); wh
// [dirs, H, 4H]; hbuf [2, dirs B, H] scratch; nt, w_smem and smem from the
// plan; xw, wh, ys and c_out of storage type dt (0 float, 1 bf16), acts of
// adt, mask and hbuf float. One cooperative launch (a grid barrier a step):
// it fails where the grid cannot be resident.
extern "C" int e2e_lstm_fwd_sweep(const void* xw, const float* mask, const void* wh, void* ys,
                                  void* c_out, void* acts, float* hbuf, int T, int B, int dirs, int H,
                                  int row_mask, int train, int nt, int w_smem, int smem, int dt, int adt,
                                  void* stream) {
  if (!fwd_shape_ok(B, dirs, H) || T < 1 || (nt != 1 && nt != 2 && nt != 4) || w_smem < 0 || w_smem > 1 ||
      dt < 0 || dt > 1 || adt < 0 || adt > 1 || (!dt && adt) ||
      smem != fw_smem_bytes(H, nt, w_smem, elem_bytes(dt)) || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const void* kern = sweep_kernel(nt, dt, adt);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  FwdArgs a{xw, mask, wh, ys, c_out, acts, hbuf, T, B, H, dirs, row_mask, train,
            cdiv(H, FW_US), cdiv(B, 8 * nt), w_smem};
  void* params[] = {&a};
  const int nb = dirs * a.nrg * a.slices;
  return (int)cudaLaunchCooperativeKernel(kern, dim3(nb), dim3(FW_NT), params, (size_t)smem,
                                          (cudaStream_t)stream);
}

// The fused layer's input projection: x [T, B, D], wx [2, D, 4H], b [2, 4H]
// -> xw [T, 2B, 4H] = x wx[d] + b[d] for direction d's rows [dB, (d+1)B),
// in kernel time (direction 1 flipped over T); all of storage type dt (0
// float, 1 bf16: summed in float32, rounded once).
extern "C" int e2e_lstm_bidir_projection(const void* x, const void* wx, const void* b, void* xw,
                                         int T, int B, int D, int H, int dt, void* stream) {
  if (H % 8 != 0 || H > 1024 || D < 1 || B < 1 || T < 1 || dt < 0 || dt > 1) return (int)cudaErrorInvalidValue;
  const long long G = 4LL * H, R = 2LL * B;
  const int es = elem_bytes(dt);
  const char* wxc = static_cast<const char*>(wx);
  const char* bc = static_cast<const char*>(b);
  GemmArgs ga{};
  for (int d = 0; d < 2; ++d) {
    ga.pr[d].a[0] = {x, plain_rows(D)};
    ga.pr[d].b[0] = {wxc + (long long)d * D * G * es, plain_rows(G)};
    ga.pr[d].c = xw;
    ga.pr[d].bias = bc + (long long)d * G * es;
  }
  ga.c16 = dt;
  // row (t, b) of x: kernel time t for direction 0, T-1-t for direction 1
  ga.pr[0].crow = row_map(0, B, R * G, G);
  ga.pr[1].crow = row_map(((long long)(T - 1) * R + B) * G, B, -R * G, G);
  ga.ws = nullptr;
  ga.M = T * B;
  ga.N = (int)G;
  ga.K = D;
  ga.seg_len = D;
  ga.splits = 1;
  ga.kchunk = cdiv(D, GK);
  return gemm(ga, 2, true, false, D % (16 / es) == 0 && aligned16(x) && aligned16(wx), true, dt, dt,
              (cudaStream_t)stream);
}
