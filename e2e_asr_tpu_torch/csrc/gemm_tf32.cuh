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
//
// Storage types: each operand is float or bf16 (a template parameter), held
// in shared memory in its own type (16-byte cp.async copies: 4 floats or 8
// bf16) and widened at the fragment load, so a bf16 operand gives exact TF32
// products; C, the bias and the column sums are float or bf16 (c16), summed
// in float32 and rounded once at the store. A split product of bf16 C may
// also round each split's partial to bf16 before the sum (round_parts: two
// products each rounded, then their sum rounded, as the fused LSTM TPU
// kernel forms dx).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "tf32_mma.cuh"

namespace {

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

constexpr int GM = 128, GN = 64, GK = 32, G_NT = 256, G_ST = 3;
constexpr int LDO_A = GM + 8, LDO_B = GN + 8;  // k-outer tiles [GK][...]: fragment loads conflict-free
// k-inner tiles [...][GK + 16 bytes]: rows on 16 bytes, fragment loads conflict-free
template <typename T>
__host__ __device__ constexpr int g_ldi() { return GK + 16 / (int)sizeof(T); }
// A's and B's parts of a stage, in elements
template <typename T>
__host__ __device__ constexpr int g_a() { return GM * g_ldi<T>() > GK * LDO_A ? GM * g_ldi<T>() : GK * LDO_A; }
template <typename T>
__host__ __device__ constexpr int g_b() { return GN * g_ldi<T>() > GK * LDO_B ? GN * g_ldi<T>() : GK * LDO_B; }
template <typename TA, typename TB>
__host__ __device__ constexpr int g_stage_bytes() { return g_a<TA>() * (int)sizeof(TA) + g_b<TB>() * (int)sizeof(TB); }
template <typename TA, typename TB>
__host__ __device__ constexpr int g_smem() { return G_ST * g_stage_bytes<TA, TB>() + (int)sizeof(float) * 4 * GN; }

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
  const void* p;  // float or bf16, as the kernel's template says
  RowMap rows;
};

struct GemmProblem {
  Operand a[2], b[2];  // per K segment
  void* c;             // C(m, n) at c + crow(m) + n
  RowMap crow;
  const void* bias;    // [N] added to every row of C, or null
  void* ones;          // the columns of B summed over K (the bias gradient), or null
};

// C = A B over K = nseg x seg_len. AKIN: A(m, k) at a.p + a.rows(m) + k
// (k contiguous), else at a.p + a.rows(k) + m; BKIN: B(k, n) at
// b.p + b.rows(n) + k, else at b.p + b.rows(k) + n.
struct GemmArgs {
  GemmProblem pr[2];
  float* ws;  // split partials [problem][split][M + 1][N]
  int M, N, K, seg_len, splits, kchunk;
  int c16;          // C, the bias and the column sums in bf16 (else float)
  int round_parts;  // a split product's partials rounded to bf16 before their sum
};

// one element global -> shared, or a zero where n_ok = 0 (4-byte cp.async for
// float; a plain load and store for bf16, whose 2 bytes cp.async cannot copy)
__device__ __forceinline__ void copy1_zfill(float* dst, const float* src, int n_ok) {
  cp_async4_zfill(dst, src, 4 * n_ok);
}
__device__ __forceinline__ void copy1_zfill(bf16* dst, const bf16* src, int n_ok) {
  *reinterpret_cast<unsigned short*>(dst) = n_ok ? *reinterpret_cast<const unsigned short*>(src) : 0;
}

template <bool AKIN, bool BKIN, bool V4, typename TA, typename TB>
__device__ __forceinline__ void load_tile(const GemmArgs& ga, const GemmProblem& pr, char* st,
                                          int m0, int n0, int k0, int kend, int tid) {
  const int seg = k0 / ga.seg_len;
  const int kl0 = k0 - seg * ga.seg_len;  // k within the segment
  const Operand& A = pr.a[seg];
  const Operand& Bo = pr.b[seg];
  const TA* Ap = static_cast<const TA*>(A.p);
  const TB* Bp = static_cast<const TB*>(Bo.p);
  TA* As = reinterpret_cast<TA*>(st);
  TB* Bs = reinterpret_cast<TB*>(st + g_a<TA>() * sizeof(TA));
  constexpr int LDIA = g_ldi<TA>(), LDIB = g_ldi<TB>();
  constexpr int WA = V4 ? 16 / (int)sizeof(TA) : 1, WB = V4 ? 16 / (int)sizeof(TB) : 1;
  // A: AKIN [GM rows m][GK k], else [GK rows k][GM m]; B likewise
  constexpr int A_ROWS = AKIN ? GM : GK, A_COLS = AKIN ? GK : GM;
  constexpr int B_ROWS = BKIN ? GN : GK, B_COLS = BKIN ? GK : GN;
#pragma unroll
  for (int i = tid; i < A_ROWS * A_COLS / WA; i += G_NT) {
    const int r = i / (A_COLS / WA), cc = (i % (A_COLS / WA)) * WA;
    int n_ok;
    long long off = 0;
    if (AKIN) {
      const int gm = m0 + r, k = k0 + cc;
      n_ok = gm < ga.M ? min(max(kend - k, 0), WA) : 0;
      if (n_ok) off = A.rows(gm) + kl0 + cc;
    } else {
      const int k = k0 + r, gm = m0 + cc;
      n_ok = k < kend ? min(max(ga.M - gm, 0), WA) : 0;
      if (n_ok) off = A.rows(kl0 + r) + gm;
    }
    TA* dst = As + r * (AKIN ? LDIA : LDO_A) + cc;
    if (V4) cp_async16_zfill(dst, Ap + off, (int)sizeof(TA) * n_ok);
    else copy1_zfill(dst, Ap + off, n_ok);
  }
#pragma unroll
  for (int i = tid; i < B_ROWS * B_COLS / WB; i += G_NT) {
    const int r = i / (B_COLS / WB), cc = (i % (B_COLS / WB)) * WB;
    int n_ok;
    long long off = 0;
    if (BKIN) {
      const int gn = n0 + r, k = k0 + cc;
      n_ok = gn < ga.N ? min(max(kend - k, 0), WB) : 0;
      if (n_ok) off = Bo.rows(gn) + kl0 + cc;
    } else {
      const int k = k0 + r, gn = n0 + cc;
      n_ok = k < kend ? min(max(ga.N - gn, 0), WB) : 0;
      if (n_ok) off = Bo.rows(kl0 + r) + gn;
    }
    TB* dst = Bs + r * (BKIN ? LDIB : LDO_B) + cc;
    if (V4) cp_async16_zfill(dst, Bp + off, (int)sizeof(TB) * n_ok);
    else copy1_zfill(dst, Bp + off, n_ok);
  }
}

template <bool AKIN, bool BKIN, bool V4, bool STEP_SUMS, typename TA, typename TB>
__global__ void __launch_bounds__(G_NT) gemm_tf32_kernel(GemmArgs ga) {
  constexpr int STAGE = g_stage_bytes<TA, TB>();
  extern __shared__ __align__(16) char gsm[];
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
      load_tile<AKIN, BKIN, V4, TA, TB>(ga, pr, gsm + s * STAGE, m0, n0, (kt0 + s) * GK, kend, tid);
    cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    cp_async_wait<G_ST - 2>();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    const int nk = kt + G_ST - 1;
    if (nk < kt1)
      load_tile<AKIN, BKIN, V4, TA, TB>(ga, pr, gsm + ((nk - kt0) % G_ST) * STAGE, m0, n0, nk * GK, kend, tid);
    cp_async_commit();
    const char* st = gsm + ((kt - kt0) % G_ST) * STAGE;
    const TA* As = reinterpret_cast<const TA*>(st);
    const TB* Bs = reinterpret_cast<const TB*>(st + g_a<TA>() * sizeof(TA));
    constexpr int LDI = g_ldi<TA>(), LDIB = g_ldi<TB>();
#pragma unroll
    for (int kq = 0; kq < GK / 8; ++kq) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int rm = wm * 32 + mi * 16 + g, kc = kq * 8 + q;
        const float v[4] = {
            ldf(AKIN ? As + rm * LDI + kc : As + kc * LDO_A + rm),
            ldf(AKIN ? As + (rm + 8) * LDI + kc : As + kc * LDO_A + rm + 8),
            ldf(AKIN ? As + rm * LDI + kc + 4 : As + (kc + 4) * LDO_A + rm),
            ldf(AKIN ? As + (rm + 8) * LDI + kc + 4 : As + (kc + 4) * LDO_A + rm + 8)};
#pragma unroll
        for (int e = 0; e < 4; ++e) tf32_split(v[e], ah[mi][e], al[mi][e]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int cn = wn * 32 + ni * 8 + g, kc = kq * 8 + q;
        const float v[2] = {ldf(BKIN ? Bs + cn * LDIB + kc : Bs + kc * LDO_B + cn),
                            ldf(BKIN ? Bs + cn * LDIB + kc + 4 : Bs + (kc + 4) * LDO_B + cn)};
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
      for (int r = 0; r < 8; ++r) colsum += ldf(Bs + (r0 + r) * LDO_B + col);
    }
  }
  cp_async_wait_all();

  const bool split_out = ga.splits > 1;
  float* ws = ga.ws + (long)(prob * ga.splits + split) * (ga.M + 1) * ga.N;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 32 + mi * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn * 32 + ni * 8 + 2 * q + (e & 1);
        if (row < ga.M && col < ga.N) {
          if (split_out) {
            ws[(long)row * ga.N + col] = acc[mi][ni][e];
          } else if (ga.c16) {
            const float v = pr.bias ? acc[mi][ni][e] + ldf(static_cast<const bf16*>(pr.bias) + col) : acc[mi][ni][e];
            stf(static_cast<bf16*>(pr.c) + pr.crow(row) + col, v);
          } else {
            const float* bias = static_cast<const float*>(pr.bias);
            static_cast<float*>(pr.c)[pr.crow(row) + col] = bias ? acc[mi][ni][e] + bias[col] : acc[mi][ni][e];
          }
        }
      }
  if (sums) {
    float* part = reinterpret_cast<float*>(gsm + G_ST * STAGE);  // [4][GN]
    __syncthreads();
    part[(tid / GN) * GN + tid % GN] = colsum;
    __syncthreads();
    if (tid < GN && n0 + tid < ga.N) {
      const float s = ((part[tid] + part[GN + tid]) + part[2 * GN + tid]) + part[3 * GN + tid];
      if (split_out) ws[(long)ga.M * ga.N + n0 + tid] = s;
      else if (ga.c16) stf(static_cast<bf16*>(pr.ones) + n0 + tid, s);
      else static_cast<float*>(pr.ones)[n0 + tid] = s;
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
    for (int sp = 0; sp < ga.splits; ++sp) {
      const float v = ws[(long)sp * (ga.M + 1) * ga.N + i];
      s += ga.round_parts ? rnd<bf16>(v) : v;
    }
    void* dst = i < mn ? pr.c : pr.ones;
    const long at = i < mn ? i : i - mn;
    if (ga.c16) stf(static_cast<bf16*>(dst) + at, s);
    else static_cast<float*>(dst)[at] = s;
  }
}

// nprob problems (blockIdx.z), each split ga.splits ways over K; akin /
// bkin as in GemmArgs, v4: 16-byte loads of both operands (every row
// offset a multiple of 16 bytes, pointers 16-byte aligned), step_sums as
// STEP_SUMS above; a16 / b16: operand A / B in bf16. A split product needs
// plain C rows and no bias. The (akin, bkin, step_sums) built: (1, 1, 0) and
// (0, 0, 0), the backward's products; (1, 0, 1), the forward's projection;
// each with both operands float or both bf16, and (0, 0, 0) also with A bf16
// and B float (dWh of bf16 h_prev and float32 gate gradients).
int gemm(GemmArgs& ga, int nprob, bool akin, bool bkin, bool v4, bool step_sums, bool a16, bool b16,
         cudaStream_t stream) {
  for (int p = 0; p < nprob; ++p)
    if (ga.splits > 1 && (ga.pr[p].bias != nullptr || ga.pr[p].crow.div != 1 || ga.pr[p].crow.base != 0 ||
                          ga.pr[p].crow.st != ga.N))
      return (int)cudaErrorInvalidValue;
  const dim3 grid(cdiv(ga.N, GN), cdiv(ga.M, GM), nprob * ga.splits);
  cudaError_t e;
#define LAUNCH(AK, BK, VV, SS, TA, TB)                                                              \
  {                                                                                                 \
    const int smem = g_smem<TA, TB>();                                                              \
    e = cudaFuncSetAttribute(gemm_tf32_kernel<AK, BK, VV, SS, TA, TB>,                              \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);                    \
    if (e != cudaSuccess) return (int)e;                                                            \
    gemm_tf32_kernel<AK, BK, VV, SS, TA, TB><<<grid, G_NT, smem, stream>>>(ga);                     \
  }
#define LAUNCH_V(AK, BK, SS, TA, TB) \
  { if (v4) LAUNCH(AK, BK, true, SS, TA, TB) else LAUNCH(AK, BK, false, SS, TA, TB) }
  if (a16 != b16 && !(a16 && !akin && !bkin && !step_sums)) return (int)cudaErrorInvalidValue;
  if (akin && bkin && !step_sums) {
    if (a16) LAUNCH_V(true, true, false, bf16, bf16) else LAUNCH_V(true, true, false, float, float)
  } else if (akin && !bkin && step_sums) {
    if (a16) LAUNCH_V(true, false, true, bf16, bf16) else LAUNCH_V(true, false, true, float, float)
  } else if (!akin && !bkin && !step_sums) {
    if (a16 && b16) LAUNCH_V(false, false, false, bf16, bf16)
    else if (a16) LAUNCH_V(false, false, false, bf16, float)
    else LAUNCH_V(false, false, false, float, float)
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH_V
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
