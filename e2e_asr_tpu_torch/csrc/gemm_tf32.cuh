// The float32-accurate tensor-core GEMM shared by the LSTM sources
// (csrc/lstm_bidir.cu: the fused layer's input projection;
// csrc/lstm_bidir_bwd.cu: dx, dWx with db, dWh). A source that includes
// this header includes tf32_mma.cuh itself too, so that cuda_build.py hashes
// both into its library's name.
//
// One kernel: 128 x 64 x 32 tiles, 8 warps of 32 x 32, a three-stage
// 16-byte cp.async pipeline, three TF32 products a tile (mma m16n8k8). The
// operands are rows addressed through (time, batch) maps, so kernel-time
// rows, flipped directions and shifted steps need no copies; each map's
// division by B is a multiply-high resolved on the host. K may be split over
// blocks, the partials summed in split order by a second kernel: no atomics,
// so every output repeats bitwise. With STEP_SUMS each k8 step's three
// products are summed from zero by the tensor core and added to the float32
// accumulator by the CUDA cores: the tensor core's own accumulation is
// biased, an error that grows with K (at K = 1280 the projection was ~5e-5
// off a float64 product that way, 2.7e-6 with the sums of each step, where
// cuBLAS in float32 is 6.9e-6 off). Optional in the epilogue (unsplit
// products only): a row map of C and a bias added to every row; the column
// sums of B (the bias gradient) for k-outer B.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

constexpr int GM = 128, GN = 64, GK = 32, G_NT = 256, G_ST = 3;
constexpr int LDO_A = GM + 8, LDO_B = GN + 8;  // k-outer tiles [GK][...]: fragment loads conflict-free
constexpr int LDI = GK + 4;                    // k-inner tiles [...][GK]
constexpr int G_A = GM * LDI > GK * LDO_A ? GM * LDI : GK * LDO_A;  // A's part of a stage
constexpr int G_B = GN * LDI > GK * LDO_B ? GN * LDI : GK * LDO_B;
constexpr int G_STAGE = G_A + G_B;
constexpr int G_SMEM = sizeof(float) * (G_ST * G_STAGE + 4 * GN);

// offset of row i: base + (i / div) st + (i % div) sb, for 0 <= i < 2^31;
// the division is a multiply-high and a shift (mul, shr from the host)
struct RowMap {
  long long base, st, sb;
  unsigned div, mul, shr;
  __device__ __forceinline__ long long operator()(int i) const {
    const unsigned q = div == 1 ? (unsigned)i : __umulhi((unsigned)i, mul) >> shr;
    return base + (long long)q * st + (long long)((unsigned)i - q * div) * sb;
  }
};

RowMap row_map(long long base, int div, long long st, long long sb) {
  RowMap m{base, st, sb, (unsigned)div, 0u, 0u};
  if (div > 1) {
    unsigned l = 0;
    while ((1u << l) < (unsigned)div) ++l;  // ceil(log2 div)
    const unsigned p = 31 + l;
    m.mul = (unsigned)(((1ull << p) + (unsigned)div - 1) / (unsigned)div);
    m.shr = p - 32;
  }
  return m;
}

RowMap plain_rows(long long stride) { return row_map(0, 1, stride, 0); }

struct Operand {
  const float* p;
  RowMap rows;
};

struct GemmProblem {
  Operand a[2], b[2];  // per K segment
  float* c;            // C(m, n) at c + crow(m) + n
  RowMap crow;
  const float* bias;   // [N] added to every row of C, or null
  float* ones;         // the columns of B summed over K (the bias gradient), or null
};

// C = A B over K = nseg x seg_len. AKIN: A(m, k) at a.p + a.rows(m) + k
// (k contiguous), else at a.p + a.rows(k) + m; BKIN: B(k, n) at
// b.p + b.rows(n) + k, else at b.p + b.rows(k) + n.
struct GemmArgs {
  GemmProblem pr[2];
  float* ws;  // split partials [problem][split][M + 1][N]
  int M, N, K, seg_len, splits, kchunk;
};

template <bool AKIN, bool BKIN, bool V4>
__device__ __forceinline__ void load_tile(const GemmArgs& ga, const GemmProblem& pr, float* st,
                                          int m0, int n0, int k0, int kend, int tid) {
  const int seg = k0 / ga.seg_len;
  const int kl0 = k0 - seg * ga.seg_len;  // k within the segment
  const Operand& A = pr.a[seg];
  const Operand& Bo = pr.b[seg];
  float* As = st;
  float* Bs = st + G_A;
  constexpr int W = V4 ? 4 : 1;
  // A: AKIN [GM rows m][GK k], else [GK rows k][GM m]; B likewise
  constexpr int A_ROWS = AKIN ? GM : GK, A_COLS = AKIN ? GK : GM;
  constexpr int B_ROWS = BKIN ? GN : GK, B_COLS = BKIN ? GK : GN;
#pragma unroll
  for (int i = tid; i < A_ROWS * A_COLS / W; i += G_NT) {
    const int r = i / (A_COLS / W), cc = (i % (A_COLS / W)) * W;
    int n_ok;
    long long off = 0;
    if (AKIN) {
      const int gm = m0 + r, k = k0 + cc;
      n_ok = gm < ga.M ? min(max(kend - k, 0), W) : 0;
      if (n_ok) off = A.rows(gm) + kl0 + cc;
    } else {
      const int k = k0 + r, gm = m0 + cc;
      n_ok = k < kend ? min(max(ga.M - gm, 0), W) : 0;
      if (n_ok) off = A.rows(kl0 + r) + gm;
    }
    float* dst = As + r * (AKIN ? LDI : LDO_A) + cc;
    if (V4) cp_async16_zfill(dst, A.p + off, 4 * n_ok);
    else cp_async4_zfill(dst, A.p + off, 4 * n_ok);
  }
#pragma unroll
  for (int i = tid; i < B_ROWS * B_COLS / W; i += G_NT) {
    const int r = i / (B_COLS / W), cc = (i % (B_COLS / W)) * W;
    int n_ok;
    long long off = 0;
    if (BKIN) {
      const int gn = n0 + r, k = k0 + cc;
      n_ok = gn < ga.N ? min(max(kend - k, 0), W) : 0;
      if (n_ok) off = Bo.rows(gn) + kl0 + cc;
    } else {
      const int k = k0 + r, gn = n0 + cc;
      n_ok = k < kend ? min(max(ga.N - gn, 0), W) : 0;
      if (n_ok) off = Bo.rows(kl0 + r) + gn;
    }
    float* dst = Bs + r * (BKIN ? LDI : LDO_B) + cc;
    if (V4) cp_async16_zfill(dst, Bo.p + off, 4 * n_ok);
    else cp_async4_zfill(dst, Bo.p + off, 4 * n_ok);
  }
}

template <bool AKIN, bool BKIN, bool V4, bool STEP_SUMS>
__global__ void __launch_bounds__(G_NT) gemm_tf32_kernel(GemmArgs ga) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int wm = warp % 4, wn = warp / 4;
  const int n0 = blockIdx.x * GN, m0 = blockIdx.y * GM;
  const int prob = blockIdx.z / ga.splits, split = blockIdx.z % ga.splits;
  const GemmProblem& pr = ga.pr[prob];
  const int ktiles = cdiv(ga.K, GK);
  const int kt0 = split * ga.kchunk, kt1 = min(ktiles, kt0 + ga.kchunk);
  const int kend = ga.K;
  const bool sums = !BKIN && pr.ones != nullptr && blockIdx.y == 0;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
  float colsum = 0.0f;

#pragma unroll
  for (int s = 0; s < G_ST - 1; ++s) {
    if (kt0 + s < kt1)
      load_tile<AKIN, BKIN, V4>(ga, pr, smem + s * G_STAGE, m0, n0, (kt0 + s) * GK, kend, tid);
    cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    cp_async_wait<G_ST - 2>();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    const int nk = kt + G_ST - 1;
    if (nk < kt1)
      load_tile<AKIN, BKIN, V4>(ga, pr, smem + ((nk - kt0) % G_ST) * G_STAGE, m0, n0, nk * GK, kend, tid);
    cp_async_commit();
    const float* As = smem + ((kt - kt0) % G_ST) * G_STAGE;
    const float* Bs = As + G_A;
#pragma unroll
    for (int kq = 0; kq < GK / 8; ++kq) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int rm = wm * 32 + mi * 16 + g, kc = kq * 8 + q;
        const float v[4] = {
            AKIN ? As[rm * LDI + kc] : As[kc * LDO_A + rm],
            AKIN ? As[(rm + 8) * LDI + kc] : As[kc * LDO_A + rm + 8],
            AKIN ? As[rm * LDI + kc + 4] : As[(kc + 4) * LDO_A + rm],
            AKIN ? As[(rm + 8) * LDI + kc + 4] : As[(kc + 4) * LDO_A + rm + 8]};
#pragma unroll
        for (int e = 0; e < 4; ++e) tf32_split(v[e], ah[mi][e], al[mi][e]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int cn = wn * 32 + ni * 8 + g, kc = kq * 8 + q;
        const float v[2] = {BKIN ? Bs[cn * LDI + kc] : Bs[kc * LDO_B + cn],
                            BKIN ? Bs[cn * LDI + kc + 4] : Bs[(kc + 4) * LDO_B + cn]};
#pragma unroll
        for (int e = 0; e < 2; ++e) tf32_split(v[e], bh[ni][e], bl[ni][e]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if constexpr (STEP_SUMS) {
            float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_tf32(part, al[mi], bh[ni]);
            mma_tf32(part, ah[mi], bl[ni]);
            mma_tf32(part, ah[mi], bh[ni]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[e];
          } else {
            mma_tf32(acc[mi][ni], al[mi], bh[ni]);
            mma_tf32(acc[mi][ni], ah[mi], bl[ni]);
            mma_tf32(acc[mi][ni], ah[mi], bh[ni]);
          }
        }
    }
    if (sums) {
      // thread: column tid % 64 over the tile's rows 8 (tid / 64) .. + 7
      const int col = tid % GN, r0 = (tid / GN) * 8;
#pragma unroll
      for (int r = 0; r < 8; ++r) colsum += Bs[(r0 + r) * LDO_B + col];
    }
  }
  cp_async_wait_all();

  const bool split_out = ga.splits > 1;
  float* out = split_out ? ga.ws + (long)(prob * ga.splits + split) * (ga.M + 1) * ga.N : pr.c;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 32 + mi * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn * 32 + ni * 8 + 2 * q + (e & 1);
        if (row < ga.M && col < ga.N) {
          if (split_out) out[(long)row * ga.N + col] = acc[mi][ni][e];
          else out[pr.crow(row) + col] = pr.bias ? acc[mi][ni][e] + pr.bias[col] : acc[mi][ni][e];
        }
      }
  if (sums) {
    float* part = smem + G_ST * G_STAGE;  // [4][GN]
    __syncthreads();
    part[(tid / GN) * GN + tid % GN] = colsum;
    __syncthreads();
    if (tid < GN && n0 + tid < ga.N) {
      const float s = ((part[tid] + part[GN + tid]) + part[2 * GN + tid]) + part[3 * GN + tid];
      float* ones = split_out ? out + (long)ga.M * ga.N : pr.ones;
      ones[n0 + tid] = s;
    }
  }
}

// C (and the column sums) = the splits' partials summed in split order
// (C's rows plain: split products take no row map and no bias)
__global__ void split_sum_kernel(GemmArgs ga) {
  const int prob = blockIdx.y;
  const GemmProblem& pr = ga.pr[prob];
  const long mn = (long)ga.M * ga.N;
  const long n_out = mn + (pr.ones != nullptr ? ga.N : 0);
  const float* ws = ga.ws + (long)prob * ga.splits * (ga.M + 1) * ga.N;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n_out; i += (long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int sp = 0; sp < ga.splits; ++sp) s += ws[(long)sp * (ga.M + 1) * ga.N + i];
    if (i < mn) pr.c[i] = s;
    else pr.ones[i - mn] = s;
  }
}

// nprob problems (blockIdx.z), each split ga.splits ways over K; akin /
// bkin as in GemmArgs, v4: 16-byte loads of both operands (every row
// offset a multiple of 4 floats, pointers 16-byte aligned), step_sums as
// STEP_SUMS above. A split product needs plain C rows and no bias. The
// (akin, bkin, step_sums) built: (1, 1, 0) and (0, 0, 0), the backward's
// products; (1, 0, 1), the forward's projection.
int gemm(GemmArgs& ga, int nprob, bool akin, bool bkin, bool v4, bool step_sums, cudaStream_t stream) {
  for (int p = 0; p < nprob; ++p)
    if (ga.splits > 1 && (ga.pr[p].bias != nullptr || ga.pr[p].crow.div != 1 || ga.pr[p].crow.base != 0 ||
                          ga.pr[p].crow.st != ga.N))
      return (int)cudaErrorInvalidValue;
  const dim3 grid(cdiv(ga.N, GN), cdiv(ga.M, GM), nprob * ga.splits);
  const size_t smem = G_SMEM;
  cudaError_t e;
#define LAUNCH(AK, BK, VV, SS)                                                                     \
  e = cudaFuncSetAttribute(gemm_tf32_kernel<AK, BK, VV, SS>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                           (int)smem);                                                                  \
  if (e != cudaSuccess) return (int)e;                                                                  \
  gemm_tf32_kernel<AK, BK, VV, SS><<<grid, G_NT, smem, stream>>>(ga);
  if (akin && bkin && !step_sums) {
    if (v4) { LAUNCH(true, true, true, false) } else { LAUNCH(true, true, false, false) }
  } else if (akin && !bkin && step_sums) {
    if (v4) { LAUNCH(true, false, true, true) } else { LAUNCH(true, false, false, true) }
  } else if (!akin && !bkin && !step_sums) {
    if (v4) { LAUNCH(false, false, true, false) } else { LAUNCH(false, false, false, false) }
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
  e = cudaGetLastError();
  if (e != cudaSuccess || ga.splits == 1) return (int)e;
  const long n_out = (long)(ga.M + 1) * ga.N;
  const int blocks = (int)((n_out + 255) / 256 < 1024 ? (n_out + 255) / 256 : 1024);
  split_sum_kernel<<<dim3(blocks, nprob), 256, 0, stream>>>(ga);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
