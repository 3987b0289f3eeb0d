// CTC prefix scores of every beam candidate, and the eos score, in one launch.
//
// Replaces the TPU kernel e2e_asr_tpu/decode/ctc_prefix_pallas.py
// prefix_recursion (_kernel) together with the stream building around it
// (e2e_asr_tpu/decode/ctc_prefix.py prefix_scores: the candidate emissions,
// phi(t-1), the masks) and eos_score. For utterance b, beam w, candidate k
// (column n = (b, w, k)), c = cand[b, w, k], L = clamp(enc_len[b], 0, T),
// in log space with NEG = -1e30:
//   phi(-1)    = 0 if prefix_is_empty else NEG
//   phi(t-1)   = lse(r_g[b, w, t-1, 1], c == last_tok[b, w] ? NEG : r_g[b, w, t-1, 0])
//   r_n(t)     = lse(r_n(t-1), phi(t-1)) + ctc_lp[b, t, c]
//   r_b(t)     = lse(r_b(t-1), r_n(t-1)) + ctc_lp[b, t, 0]
//   psi        = lse(psi, phi(t-1) + ctc_lp[b, t, c])
// for t < L, frozen from L on, starting from r_n = r_b = psi = NEG; r_h[b,
// w, k, t] = (r_n(t), r_b(t)); psi_eos[b, w] = lse(r_g[b, w, max(L-1, 0), 0],
// r_g[b, w, max(L-1, 0), 1]); lse(a, b) = m + log(exp(a-m) + exp(b-m)) if m =
// max(a, b) > NEG/2, else NEG (decode/ctc_prefix_cuda.py lse). The recursion
// is the serial one of prefix_scores_scan, not the TPU kernel's blockwise
// log-depth form, which cancels catastrophically when its inputs hold NEG.
// Precision: every log-sum-exp is computed as the plain version computes
// it, with the accurate expf and logf, so that the kernel's outputs are
// bitwise equal to the plain version's. The approximate intrinsics
// (__expf/__logf, or ex2/lg2.approx in log2 units) take about half the
// time, but their rounding turned one of 16 top hypotheses of the flagship
// decode against the plain decode (PERF.md; bin/profile_decode.py
// --decode-phases times the __expf/__logf build beside this one).
//
// What bounds it on the H100: latency. Per column the recursion is a chain
// of T dependent log-sum-exps (an accurate expf and logf each, a few dozen
// dependent instructions); the function's traffic (ctc_lp and the parents'
// r_g in, r_h out: ~11 MB at the flagship decode shapes) takes ~3 us of
// HBM time. The parent composition built four
// [T, B W K] streams in ~24 device ops, then the recursion read them back
// (one thread a column, 48 blocks at the flagship), and eos_score took 14
// more ops.
// Design: a block per (utterance, run of CPB columns of that utterance), so
// that B * nbu blocks cover the card (128 at the flagship: 48 columns, two
// beams, a block), with three roles. Recursion warps, one thread a column,
// run the serial recursion CH steps at a time unrolled: each lane loads its
// own candidate's emissions from ctc_lp (never the whole vocabulary row;
// the lanes of a warp read one row a step, a few sectors) a whole chunk
// ahead into registers, so that only the log-sum-exps are on the chain.
// Stager warps compute, a group of CH steps a warp, phi(t-1) of each beam
// of the block in both forms (candidate equal to the beam's last token or
// not) from the parents' r_g, and the blank's emissions, into shared
// memory, and publish each group by a flag the recursion waits on.
// Writer warps, each paired with a recursion warp by named barriers, take
// the (r_n, r_b) it stages for CH steps (two buffers) and write them out as
// 128-byte runs of the [K, T, 2] layout, one column a store instruction
// (coalesced), so that no store sits in the recursion's issue stream. No
// atomics, no cross-block communication: repeats are bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1.0e30f;
constexpr int NT = 256;  // threads a block
constexpr int RWMAX = 3;  // warps a block that run the recursion (as many more write their output)
constexpr int CH = 16;   // steps a warp stages before writing its columns' runs (2 CH = 32 floats)
constexpr int SST = 33;  // row stride of a warp's stage: conflict-free writes and reads
constexpr size_t SMEM_MAX = 227 * 1024;

// Timing build (nvcc -DPREFIX_PHASES): thread 0 of block 0 adds the global
// timer's advance (ns) over the staging of each tile (after the block's
// barrier) and over its own recursion, and writes both to g_prefix_ts at
// the end; the normal build compiles the marks away.
constexpr int PREFIX_SLOTS = 4;
#ifdef PREFIX_PHASES
__device__ unsigned long long g_prefix_ts[PREFIX_SLOTS];
#define MARK(i)                                                       \
  do {                                                                \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                        \
      unsigned long long now_;                                        \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now_));       \
      ph_ns[i] += now_ - ph_last;                                     \
      ph_last = now_;                                                 \
    }                                                                 \
  } while (0)
#else
#define MARK(i) \
  do {          \
  } while (0)
#endif

// log(exp(a) + exp(b)) as the plain version computes it (decode/
// ctc_prefix_cuda.py lse: one of its two exps is exp(0) = 1), accurate expf
// and logf: m + log(1 + exp(n - m)), floored at NEG where m = max(a, b) <=
// NEG / 2
__device__ __forceinline__ float lse(float a, float b) {
  const float m = fmaxf(a, b), n = fminf(a, b);
  const float out = m + logf(1.0f + expf(n - m));
  return m > NEG / 2 ? out : NEG;
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// beams a run of CPB columns can touch, at most
__host__ __device__ inline int beams_of(int CPB, int K) { return cdiv(CPB - 1, K) + 1; }

// shared memory of a block, in floats: lpb [TT], phi [nbb][TT][2], stage
// [recursion warps][2][32][SST], a flag a group of CH steps (ints)
__host__ __device__ inline size_t smem_floats(int TT, int CPB, int K) {
  return (size_t)TT * (1 + 2 * beams_of(CPB, K)) + (size_t)cdiv(CPB, 32) * 2 * 32 * SST + cdiv(TT, CH);
}

// named barriers between recursion warp r and its writer warp (64 threads):
// buffer u of the pair is full / empty (ids 1-12); barrier 0 is
// __syncthreads'
__device__ __forceinline__ int bar_full(int r, int u) { return 1 + 4 * r + u; }
__device__ __forceinline__ int bar_empty(int r, int u) { return 3 + 4 * r + u; }
__device__ __forceinline__ void bar_sync(int id) { asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory"); }
__device__ __forceinline__ void bar_arrive(int id) { asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory"); }


struct Args {
  const float* ctc_lp;     // [B, T, V]
  const int* enc_len;      // [B]
  const float* r_g;        // [B, W, T, 2]
  const int64_t* last_tok; // [B, W]
  const int64_t* cand;     // [B, W, K]
  float* psi;              // [B, W, K]
  float* r_h;              // [B, W, K, T, 2]
  float* psi_eos;          // [B, W]
  int B, T, V, W, K, empty, CPB, nbu, TT;
};

// one step of a column's recursion: p = phi(t-1), c and lb the
// candidate's and the blank's emissions at t
__device__ __forceinline__ void step(float& rn, float& rb, float& psi, float p, float c, float lb) {
  const float rn_t = lse(rn, p) + c;
  const float rb_t = lse(rb, rn) + lb;
  psi = lse(psi, p + c);
  rn = rn_t;
  rb = rb_t;
}

__global__ void __launch_bounds__(NT, 1) prefix_scores_kernel(const Args a) {
  extern __shared__ float smem[];
  const int T = a.T, V = a.V, W = a.W, K = a.K, CPB = a.CPB, TT = a.TT;
  const int b = blockIdx.x / a.nbu, j = blockIdx.x % a.nbu;
  const int c0 = j * CPB, ncol = max(0, min(CPB, W * K - c0));
  if (ncol == 0) return;
  const int wa = c0 / K, nbb = (c0 + ncol - 1) / K - wa + 1;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int L = min(max(a.enc_len[b], 0), T);
  const float init = a.empty ? 0.0f : NEG;
#ifdef PREFIX_PHASES
  unsigned long long ph_ns[PREFIX_SLOTS] = {}, ph_last = 0;
  if (blockIdx.x == 0 && tid == 0) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ph_last));
#endif

  const int nbm = beams_of(CPB, K);
  float* lpb = smem;                            // [TT] blank emissions
  float* phi = lpb + TT;                        // [nbb][TT][2] phi(t-1): (no match, match)
  float* stage = phi + (size_t)TT * 2 * nbm;    // [recursion warps][2][32][SST]
  volatile int* ready = (volatile int*)(stage + (size_t)cdiv(CPB, 32) * 2 * 32 * SST);  // [groups]: staged

  // roles: warps [0, R) run the recursion of their columns, warp R + r
  // writes out what recursion warp r stages, warps [2 R, NT / 32) compute
  // phi(t-1) and the blank's emissions of the tile's groups of CH steps, a
  // group a warp at once, each published by its own flag
  const int R = cdiv(ncol, 32), nstg = NT / 32 - 2 * R;
  const bool rec = wid < R, writer = !rec && wid < 2 * R, stager = wid >= 2 * R;
  const int pr = rec ? wid : wid - R;
  float* st = stage + (size_t)pr * 2 * 32 * SST;
  const float* lp_b = a.ctc_lp + (long)b * T * V;
  float* rh_warp = a.r_h + ((long)b * W * K + c0 + pr * 32) * T * 2;  // column j's run: + j T 2
  const int wcols = min(32, ncol - pr * 32);  // columns of the pair
  const float* rg_b = a.r_g + ((long)b * W + wa) * T * 2;  // the block's first beam's r_g
  int kc = 0;  // chunks staged (recursion warp) or written (writer warp) so far

  // the column of this thread (recursion threads: tid < ncol, whole warps run)
  const bool mine = tid < ncol;
  const int col = c0 + min(tid, ncol - 1);
  const int wl = col / K - wa;
  const long n = (long)b * W * K + col;
  int match = 0, cidv = 0;
  if (rec) {
    match = a.cand[n] == a.last_tok[(long)b * W + col / K] ? 1 : 0;
    cidv = (int)min(max(a.cand[n], (int64_t)0), (int64_t)(V - 1));
  }
  if (stager && tid - 2 * R * 32 < nbb) {  // the eos score of each beam whose first column is this block's
    const int w = wa + tid - 2 * R * 32;
    if (w * K >= c0) {
      const float2 r = *reinterpret_cast<const float2*>(a.r_g + (((long)b * W + w) * T + max(L - 1, 0)) * 2);
      a.psi_eos[(long)b * W + w] = lse(r.x, r.y);
    }
  }

  float rn = NEG, rb = NEG, psi = NEG;
  for (int t0 = 0; t0 < T; t0 += TT) {
    const int nt = min(TT, T - t0), nv = max(0, min(nt, L - t0));  // steps of the tile, valid ones
    const int ng = cdiv(nt, CH);
    __syncthreads();  // the previous tile is consumed
    for (int g = tid; g < ng; g += NT) ready[g] = 0;
    __syncthreads();
    if (t0 == 0) MARK(0);  // set-up

    if (stager) {
      for (int g = wid - 2 * R; g < ng; g += nstg) {
        const int s0 = g * CH, s1 = min(nv, s0 + CH);
        for (int x = lane; x < nbb * max(0, s1 - s0); x += 32) {  // phi(t-1) of each beam, in both forms
          const int w = x / (s1 - s0), tl = s0 + x % (s1 - s0), t = t0 + tl;
          float p0 = init, p1 = init;
          if (t > 0) {
            const float2 r = __ldg(reinterpret_cast<const float2*>(rg_b + ((long)w * T + t - 1) * 2));
            p0 = lse(r.y, r.x);
            p1 = lse(r.y, NEG);
          }
          phi[((size_t)w * TT + tl) * 2] = p0;
          phi[((size_t)w * TT + tl) * 2 + 1] = p1;
        }
        if (lane < s1 - s0) lpb[s0 + lane] = __ldg(lp_b + (long)(t0 + s0 + lane) * V);
        __syncwarp();
        if (lane == 0) {
          __threadfence_block();
          ready[g] = 1;  // the group is staged
        }
      }
    } else if (rec) {
      // the lane's candidate emissions, straight from L2 (a warp's lanes read
      // one row of ctc_lp a step), one chunk ahead in registers
      const float* lc = lp_b + (long)t0 * V + cidv;
      const float* ph = phi + (size_t)wl * TT * 2 + match;
      float cn_[CH];
#pragma unroll
      for (int s2 = 0; s2 < CH; ++s2) cn_[s2] = s2 < nv ? __ldg(lc + (long)s2 * V) : 0.0f;
      for (int c = 0, g = 0; c < nt; c += CH, ++g, ++kc) {  // chunk = group g (TT is a multiple of CH, or T)
        const int cn = min(CH, nt - c), cv = max(0, min(cn, nv - c)), u = kc & 1;
        float cc[CH];
#pragma unroll
        for (int s2 = 0; s2 < CH; ++s2) {
          cc[s2] = cn_[s2];
          cn_[s2] = c + CH + s2 < nv ? __ldg(lc + (long)(c + CH + s2) * V) : 0.0f;  // the next chunk's
        }
        float* sb = st + (size_t)u * 32 * SST + lane * SST;
        while (ready[g] == 0) __nanosleep(20);
        __threadfence_block();
        if (kc >= 2) bar_sync(bar_empty(pr, u));  // the writer is done with this buffer
        if (cv == CH) {  // a whole valid chunk: its inputs in registers first, then the chain
          float pv[CH], lbv[CH], on[CH], ob[CH];
#pragma unroll
          for (int s2 = 0; s2 < CH; ++s2) {
            pv[s2] = ph[(c + s2) * 2];
            lbv[s2] = lpb[c + s2];
          }
#pragma unroll
          for (int s2 = 0; s2 < CH; ++s2) {
            step(rn, rb, psi, pv[s2], cc[s2], lbv[s2]);
            on[s2] = rn;
            ob[s2] = rb;
          }
#pragma unroll
          for (int s2 = 0; s2 < CH; ++s2) {
            sb[2 * s2] = on[s2];
            sb[2 * s2 + 1] = ob[s2];
          }
        } else {
#pragma unroll
          for (int s2 = 0; s2 < CH; ++s2) {
            if (s2 < cv) step(rn, rb, psi, ph[(c + s2) * 2], cc[s2], lpb[c + s2]);
            if (s2 < cn) {
              sb[2 * s2] = rn;
              sb[2 * s2 + 1] = rb;
            }
          }
        }
        bar_arrive(bar_full(pr, u));
      }
    } else if (writer) {
      // the pair's runs of steps [t0 + c, t0 + c + cn), 128 bytes a column
      for (int c = 0; c < nt; c += CH, ++kc) {
        const int cn = min(CH, nt - c), u = kc & 1;
        const float* sb = st + (size_t)u * 32 * SST;
        bar_sync(bar_full(pr, u));
        if (lane < 2 * cn)
#pragma unroll 4
          for (int jc = 0; jc < wcols; ++jc) rh_warp[(long)jc * T * 2 + 2 * (t0 + c) + lane] = sb[jc * SST + lane];
        bar_arrive(bar_empty(pr, u));
      }
    }
  }
  if (mine) a.psi[n] = psi;
  MARK(1);  // the tiles: staging, overlapped with thread 0's recursion
#ifdef PREFIX_PHASES
  if (blockIdx.x == 0 && tid == 0)
    for (int i = 0; i < PREFIX_SLOTS; ++i) g_prefix_ts[i] = ph_ns[i];
#endif
}

}  // namespace

extern "C" const char* e2e_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch plan (host only): out[0] = steps a tile (TT), out[1] = bytes of
// shared memory a block, for runs of CPB columns at T steps.
extern "C" int e2e_prefix_scores_plan(int T, int CPB, int K, int* out, void* stream) {
  (void)stream;
  if (T < 1 || CPB < 1 || CPB > 32 * RWMAX || K < 1) return (int)cudaErrorInvalidValue;
  int tt = T;  // all steps in one tile, else the most multiples of CH that fit
  if (sizeof(float) * smem_floats(tt, CPB, K) > SMEM_MAX) {
    tt = CH;
    while (sizeof(float) * smem_floats(tt + CH, CPB, K) <= SMEM_MAX) tt += CH;
  }
  out[0] = tt;
  out[1] = (int)(sizeof(float) * smem_floats(tt, CPB, K));
  return 0;
}

// ctc_lp [B, T, V] f32, enc_len [B] i32, r_g [B, W, T, 2] f32, last_tok [B, W]
// i64, cand [B, W, K] i64, prefix_is_empty -> psi [B, W, K], r_h [B, W, K, T,
// 2], psi_eos [B, W] f32; all contiguous. nbu blocks an utterance, each of CPB
// (<= 32 RWMAX) columns, tiles of TT steps (e2e_prefix_scores_plan).
extern "C" int e2e_prefix_scores(const float* ctc_lp, const int* enc_len, const float* r_g,
                                 const int64_t* last_tok, const int64_t* cand, float* psi, float* r_h,
                                 float* psi_eos, int B, int T, int V, int W, int K, int prefix_is_empty,
                                 int CPB, int nbu, int TT, void* stream) {
  if (B < 1 || T < 1 || V < 1 || W < 1 || K < 1 || CPB < 1 || CPB > 32 * RWMAX || nbu < 1 || TT < 1 ||
      (TT < T && TT % CH != 0) || (long)CPB * nbu < (long)W * K)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(TT, CPB, K);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(prefix_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const Args a{ctc_lp, enc_len, r_g, last_tok, cand, psi, r_h, psi_eos, B, T, V, W, K,
               prefix_is_empty ? 1 : 0, CPB, nbu, TT};
  prefix_scores_kernel<<<B * nbu, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// out [PREFIX_SLOTS] u64: the timing build's ns of staging and of the
// recursion in block 0 of the last launch (cudaErrorNotSupported in the
// normal build)
extern "C" int e2e_prefix_phase_times(unsigned long long* out, int n, void* stream) {
#ifdef PREFIX_PHASES
  if (n > PREFIX_SLOTS) n = PREFIX_SLOTS;
  return (int)cudaMemcpyFromSymbolAsync(out, g_prefix_ts, sizeof(unsigned long long) * n, 0,
                                        cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
#else
  (void)out;
  (void)n;
  (void)stream;
  return (int)cudaErrorNotSupported;
#endif
}
