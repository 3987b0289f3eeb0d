// CTC loss and its gradient in one launch: the alpha/beta lattice over the
// 2L+1 blank-interleaved label states, and the lattice occupations routed
// back to the vocabulary.
//
// Replaces the TPU kernel e2e_asr_tpu/ops/ctc_pallas.py ctc_loss_pallas
// (_kernel / _ctc_pallas_raw, with its custom_vjp's routing _bwd). Same
// contract: blank 0; log_probs [B, T, V] are log-softmax outputs; lattice
// state s < S = 2L+1 carries label ext[s] = labels[(s-1)/2] at odd s and
// blank at even s; alpha rows past input_len are NEG; a row's beta stays
// beta_init until t passes input_len-1; label_len = 0 rows take the blank
// path only; the s-2 skip is forbidden between repeated labels and into
// blanks; NEG = -1e30 with the m > NEG/2 guard in every log-sum-exp;
// input_len is clamped to [0, T]. Outputs nll [B] (1e30 where no path
// exists; the wrapper turns > 1e29 into +inf) and the gradient of nll with
// respect to log_probs for a unit upstream gradient,
//   G[b, t, v] = -sum over s with ext[s] = v of exp(alpha + beta - logZ),
// zero past input_len and on rows with no alignment. The caller's backward
// is G times its upstream gradient. gamma = alpha + beta - logZ never
// leaves the kernel; the TPU kernel's emission tensor [B, T, S] is never
// built (the recursion reads log_probs rows staged in shared memory).
//
// What bounds it on the H100: the recursion's latency. Every step of alpha
// (and of beta) needs the step before, and one utterance's lattice is a few
// hundred states, so a step is one short vector op plus a barrier; the
// bytes (log_probs in, G out: ~0.8 MB at the flagship shapes) take a few
// microseconds. Running alpha and then beta would make the chain 2T steps;
// a global gather on a step's chain, a gamma [B, T, S] output and a routing
// by atomics would each add to it.
// Design: one block per utterance, split into two halves of NH threads,
// each with its own named barrier (bar.sync 1 / 2, NH): alpha runs forward
// in one half while beta runs backward in the other, so the serial chain is
// T steps, not 2T. Each half writes its rows to its own scratch (Wa, Wb
// [B, T, S], L2-resident, never read by the caller) and reads nothing back
// during the recursion, so no load sits on a step's chain. logZ comes from
// alpha's last row; after one block barrier a combine pass routes
// exp(Wa + Wb - logZ) to the vocabulary without atomics, in a fixed order:
// a warp a time step, its row's occupations in shared memory, the blank
// column summing the even states (and any odd state whose label is 0) in
// lane order, each label summing its odd states along a chain of equal
// labels in label order. So G repeats bitwise. The recursion touches the
// states up to 2 label_len only (the rest carry no occupation).
// Emissions: the utterance's log_probs rows are copied into shared memory
// before the recursion (16-byte cp.async where V is a multiple of 4); where
// T V exceeds the budget, each half streams tiles of TR rows through two
// buffers, the next tile in flight while it works on the current one.
// Labels and lengths are read as int32 or int64; a label outside [0, V) or
// a label length outside [0, L] stops the kernel with a device-side assert
// (no host synchronisation in the wrapper).

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr float NEG = -1.0e30f;
constexpr int SMEM_MAX = 232448 - 1024;  // a block's shared memory on the H100, less a margin

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float ms = fmaxf(m, NEG);
  const float out = ms + logf(expf(a - ms) + expf(b - ms) + expf(c - ms));
  return m > NEG / 2 ? out : NEG;
}

__device__ __forceinline__ float lse2(float a, float b) {
  const float m = fmaxf(a, b);
  const float ms = fmaxf(m, NEG);
  const float out = ms + logf(expf(a - ms) + expf(b - ms));
  return m > NEG / 2 ? out : NEG;
}

__device__ __forceinline__ long long load_index(const void* p, long i, int is64) {
  return is64 ? static_cast<const long long*>(p)[i] : static_cast<const int*>(p)[i];
}

__device__ __forceinline__ void half_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// float offsets into the dynamic shared memory (each a multiple of 4 floats)
struct Layout {
  int lat;    // [4][S + 2]: alpha, alpha', beta, beta'
  int ext;    // [S + 2] int
  int skip;   // [S + 2] int: the s-2 -> s skip is legal
  int vhead;  // [V] int: first label position j with labels[j] = v, or -1
  int next;   // [L] int: next position with the same label, or -1
  int em;     // emissions: [T][V] (resident) or [2 halves][2][TR][V]; then
              // the combine's rows [warps][S]
  int total;
};

__host__ __device__ inline Layout layout(int S, int V, int L, int em_floats) {
  Layout ly;
  ly.lat = 0;
  ly.ext = ly.lat + round4(4 * (S + 2));
  ly.skip = ly.ext + round4(S + 2);
  ly.vhead = ly.skip + round4(S + 2);
  ly.next = ly.vhead + round4(V);
  ly.em = ly.next + round4(L > 0 ? L : 1);
  ly.total = ly.em + em_floats;
  return ly;
}

// rows [r0, r0 + n) of the utterance's log_probs into dst, by the nt threads
// numbered i; committed as one cp.async group
__device__ __forceinline__ void stage_rows(float* dst, const float* lpb, int r0, int n, int V,
                                           bool vec4, int i, int nt) {
  const float* src = lpb + (long)r0 * V;
  const long cnt = (long)n * V;
  if (vec4) {
    for (long e = 4L * i; e < cnt; e += 4L * nt) cp_async16(dst + e, src + e);
  } else {
    for (long e = i; e < cnt; e += nt) cp_async4(dst + e, src + e);
  }
  cp_async_commit();
}

// The emission rows one half walks: all T rows resident (shared by both
// halves, tr = 0), or tiles of tr rows through the half's two buffers,
// walked upwards (alpha) or downwards (beta)
struct Emissions {
  float* base;  // resident rows, or this half's two buffers
  const float* lpb;
  int tr, T, V, tile, i, nt;
  bool vec4, up;

  // tiled: start copying the tile that holds row r (the half's first row)
  __device__ __forceinline__ void start(int r) {
    if (tr == 0) return;
    const int k = r / tr;
    stage_rows(base + (long)(k & 1) * tr * V, lpb, k * tr, min(tr, T - k * tr), V, vec4, i, nt);
  }

  // row r of log_probs, in shared memory; at a tile boundary every thread
  // of the half must call it (it waits for the tile and starts the next)
  __device__ __forceinline__ const float* row(int r, int bar_id) {
    if (tr == 0) return base + (long)r * V;
    const int k = r / tr;
    if (k != tile) {
      cp_async_wait_all();
      half_sync(bar_id, nt);  // tile k has landed for every thread of the half,
      tile = k;               // and every thread is done with tile k -/+ 1
      const int nk = up ? k + 1 : k - 1;
      if (nk >= 0 && nk * tr < T) {
        stage_rows(base + (long)(nk & 1) * tr * V, lpb, nk * tr, min(tr, T - nk * tr), V, vec4,
                   i, nt);
      }
    }
    return base + (long)(k & 1) * tr * V + (long)(r - k * tr) * V;
  }
};

__global__ void __launch_bounds__(1024)
ctc_loss_kernel(const float* __restrict__ lp, const void* labels, const void* input_len,
                const void* label_len, int lab64, int in64, int len64, float* __restrict__ nll,
                float* __restrict__ grad, float* __restrict__ work, int T, int V, int L, int S,
                int tr, int vec4) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int NH = blockDim.x / 2;
  const int half = tid / NH;  // 0: alpha, 1: beta
  const int ht = tid - half * NH;
  const int bar_id = 1 + half;

  // ---- the range check: never a loss from labels that index log_probs or
  // the lattice out of bounds
  const long long lablen64 = load_index(label_len, b, len64);
  for (int j = tid; j < L; j += blockDim.x) {
    const long long v = load_index(labels, (long)b * L + j, lab64);
    assert(v >= 0 && v < V && "ctc_loss: a label outside [0, V)");
  }
  assert(lablen64 >= 0 && lablen64 <= L && "ctc_loss: a label length outside [0, L]");
  const int lablen = (int)lablen64;
  const long long in_raw = load_index(input_len, b, in64);
  const int n = (int)(in_raw < 0 ? 0 : in_raw > T ? T : in_raw);
  const int end = 2 * lablen;
  const int Sb = end + 1;  // the states that can carry an occupation
  const float* lpb = lp + (long)b * T * V;
  float* gb = grad + (long)b * T * V;

  extern __shared__ __align__(16) float smem[];
  const Layout ly = layout(S, V, L, 0);
  int* ext = reinterpret_cast<int*>(smem + ly.ext);
  int* skip = reinterpret_cast<int*>(smem + ly.skip);
  int* vhead = reinterpret_cast<int*>(smem + ly.vhead);
  int* nxt = reinterpret_cast<int*>(smem + ly.next);
  __shared__ float log_z;

  // emissions: the whole utterance now, or each half's first tile
  Emissions ems{smem + ly.em, lpb, tr, T, V, -1, ht, NH, vec4 != 0, half == 0};
  if (tr == 0) {
    stage_rows(ems.base, lpb, 0, T, V, ems.vec4, tid, blockDim.x);
  } else {
    ems.base += (long)half * 2 * tr * V;
    ems.start(half == 0 ? 0 : max(n - 1, 0));
  }

  for (int s = tid; s < S + 2; s += blockDim.x) {
    ext[s] = (s & 1) && s < S ? (int)load_index(labels, (long)b * L + (s - 1) / 2, lab64) : 0;
  }
  for (int v = tid; v < V; v += blockDim.x) vhead[v] = -1;
  __syncthreads();
  for (int s = tid; s < S + 2; s += blockDim.x) {
    skip[s] = s >= 2 && s < S && ext[s] != 0 && ext[s] != ext[s - 2];
  }
  // chains of equal labels over the positions j < label_len, in order
  for (int j = tid; j < lablen; j += blockDim.x) {
    const int v = ext[2 * j + 1];
    int first = 1, nj = -1;
    for (int o = 0; o < lablen; ++o) {
      if (ext[2 * o + 1] != v) continue;
      if (o < j) first = 0;
      if (o > j && nj < 0) nj = o;
    }
    nxt[j] = nj;
    if (first) vhead[v] = j;
  }
  if (tr == 0) cp_async_wait_all();
  __syncthreads();

  // alpha in one half, beta in the other, at the same time: each writes its
  // rows [0, n) to its own scratch (Wa, Wb) and reads nothing back
  float* cur = smem + ly.lat + half * 2 * (S + 2);
  float* nxt_row = cur + (S + 2);
  float* wa = work + (long)b * T * S;
  float* wbeta = work + ((long)gridDim.x + b) * T * S;

  if (half == 0) {
    // ---- alpha: row 0 (logZ reads it where n = 0), then rows 1 .. n-1
    const float* e0 = ems.row(0, bar_id);
    for (int s = ht; s < Sb; s += NH) {
      const bool first = s == 0 || (s == 1 && lablen > 0);
      cur[s] = first ? e0[ext[s]] : NEG;
      if (n > 0) wa[s] = cur[s];
    }
    half_sync(bar_id, NH);
    for (int t = 1; t < n; ++t) {
      const float* et = ems.row(t, bar_id);
      float* wt = wa + (long)t * S;
      for (int s = ht; s < Sb; s += NH) {
        const float a1 = s >= 1 ? cur[s - 1] : NEG;
        const float a2 = skip[s] ? cur[s - 2] : NEG;
        const float v = lse3(cur[s], a1, a2) + et[ext[s]];
        nxt_row[s] = v;
        wt[s] = v;
      }
      half_sync(bar_id, NH);
      float* tmp = cur;
      cur = nxt_row;
      nxt_row = tmp;
    }
    if (ht == 0) {
      const float pe = cur[end];
      const float pp = lablen > 0 ? cur[end - 1] : NEG;
      log_z = lse2(pe, pp);
      nll[b] = -log_z;
    }
  } else {
    // ---- beta: row n-1 is beta_init, then rows n-2 .. 0
    for (int s = ht; s < Sb; s += NH) {
      cur[s] = (s == end || (s == end - 1 && lablen > 0)) ? 0.0f : NEG;
      if (n > 0) wbeta[(long)(n - 1) * S + s] = cur[s];
    }
    half_sync(bar_id, NH);
    for (int t = n - 2; t >= 0; --t) {
      const float* et = ems.row(t + 1, bar_id);
      float* wt = wbeta + (long)t * S;
      for (int s = ht; s < Sb; s += NH) {
        const float b0 = cur[s] + et[ext[s]];
        const float b1 = s + 1 < Sb ? cur[s + 1] + et[ext[s + 1]] : NEG;
        const float b2 = s + 2 < Sb && skip[s + 2] ? cur[s + 2] + et[ext[s + 2]] : NEG;
        const float v = lse3(b0, b1, b2);
        nxt_row[s] = v;
        wt[s] = v;
      }
      half_sync(bar_id, NH);
      float* tmp = cur;
      cur = nxt_row;
      nxt_row = tmp;
    }
  }
  cp_async_wait_all();  // a tile started but never walked
  __syncthreads();

  // ---- combine: G rows, a warp a time step (the occupations of its row
  // in the warp's own shared buffer, over the emission region); zero past n
  // and where no alignment exists
  const float lz = log_z;
  const bool ok = -lz <= 1.0e29f;
  const int lane = tid & 31;
  const int nw = blockDim.x / 32;
  float* occ = smem + ly.em + (tid / 32) * round4(S);
  for (int t = tid / 32; t < T; t += nw) {
    float* gt = gb + (long)t * V;
    if (!ok || t >= n) {
      for (int v = lane; v < V; v += 32) gt[v] = 0.0f;
      continue;
    }
    const float* at = wa + (long)t * S;
    const float* bt = wbeta + (long)t * S;
    float blank = 0.0f;
    for (int s = lane; s < Sb; s += 32) {
      const float e = expf((__ldcg(at + s) + __ldcg(bt + s)) - lz);
      occ[s] = e;
      if (!(s & 1)) blank += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) blank += __shfl_xor_sync(0xffffffffu, blank, o);
    __syncwarp();
    for (int v = lane; v < V; v += 32) {
      float acc = v == 0 ? blank : 0.0f;
      for (int j = vhead[v]; j >= 0; j = nxt[j]) acc += occ[2 * j + 1];
      gt[v] = 0.0f - acc;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" const char* e2e_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out[0] = threads a block, out[1] = rows a tile (0: every row resident),
// out[2] = dynamic shared memory bytes a block; -1 in out[2] where even one
// row a tile does not fit
extern "C" int e2e_ctc_loss_plan(int T, int V, int L, int* out, void* stream) {
  (void)stream;
  const int S = 2 * L + 1;
  const int nh = S < 32 ? 32 : S > 512 ? 512 : (S + 31) / 32 * 32;
  out[0] = 2 * nh;
  const long fixed = layout(S, V, L, 0).total;
  const long comb = (long)(2 * nh / 32) * round4(S);  // the combine's rows, over the emissions
  const long resident = (long)T * V;
  if (4L * (fixed + (resident > comb ? resident : comb)) <= SMEM_MAX) {
    out[1] = 0;
    out[2] = (int)(4L * (fixed + (resident > comb ? resident : comb)));
    return 0;
  }
  const long tr = (SMEM_MAX / 4 - fixed) / (4L * V);  // 2 halves x 2 buffers
  if (tr < 1 || 4L * (fixed + comb) > SMEM_MAX) {
    out[1] = 0;
    out[2] = -1;
    return 0;
  }
  out[1] = (int)(tr < T ? tr : T);
  const long em = 4L * out[1] * V;
  out[2] = (int)(4L * (fixed + (em > comb ? em : comb)));
  return 0;
}

// log_probs [B, T, V] f32; labels [B, L], input_len [B], label_len [B] of
// int32 or int64 (lab64 / in64 / len64 = 1 for int64) -> nll [B] f32,
// grad [B, T, V] f32; work [2, B, T, S] f32 scratch (alpha rows, beta
// rows), S = 2L+1. threads, tr and
// smem from e2e_ctc_loss_plan.
extern "C" int e2e_ctc_loss(const float* lp, const void* labels, const void* input_len,
                            const void* label_len, int lab64, int in64, int len64, float* nll,
                            float* grad, float* work, int B, int T, int V, int L, int threads,
                            int tr, int smem, void* stream) {
  const int S = 2 * L + 1;
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  if (smem < 0 || smem > SMEM_MAX || threads < 64 || threads > 1024 || threads % 64 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(ctc_loss_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return (int)e;
  const int vec4 = V % 4 == 0 && reinterpret_cast<uintptr_t>(lp) % 16 == 0;
  ctc_loss_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      lp, labels, input_len, label_len, lab64, in64, len64, nll, grad, work, T, V, L, S, tr, vec4);
  return (int)cudaGetLastError();
}
