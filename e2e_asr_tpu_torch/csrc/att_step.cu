// One location-aware attention step for W beams per utterance (decode).
//
// Replaces the TPU kernel e2e_asr_tpu/ops/att_step_pallas.py
// att_step_beam_loc (_kernel). What it computes is the same, for every
// (utterance b, beam w):
//   f[s, kk]  = sum_p prev_att[s + p - (P-1)/2] * taps[kk, p]   (SAME conv)
//   e[s]      = sum_d locv[d] * tanh(k[b, s, d] + q[d] + (f[s] @ wlp)[d] + locb[d])
//   align     = softmax(where(s < enc_len, e, -1e9) / temp), zero past enc_len
//   ctx       = align @ v[b]
// with locb = loc_b + loc_conv.b @ wlp folded by the caller. Unlike the TPU
// kernel it reads the 2K+1 conv taps directly instead of a [K, S, S]
// Toeplitz bank (23 MB of f32 per step at S = 764).
//
// What bounds it on the H100: issue, not bytes. Per utterance the function
// reads k [S, Dk] and v [S, E] once (0.77 MB at S = 204, Dk = 300, E = 640),
// but every beam evaluates W x frames x Dk accurate tanhf (12.8 M a call at
// the flagship decode shapes, ~15 instructions and two special-function ops
// each) beside f @ wlp, and a conv of W x frames x K x P multiply-adds
// (~87 M). The first design (a block per (utterance, beam)) spent 140 of its
// ~180 us in the energies (block 0, timing build): one warp a frame over Dk
// with the K = 10 products f @ wlp as scalar FMAs, and every beam re-reading
// k and v. A cluster of blocks per utterance then read k and v once an
// utterance, but the longest utterance's cluster set the time.
// Design: one cooperative grid of G blocks, every SM's resident blocks (one
// an SM at the flagship). The utterances' valid frames are laid end to end;
// each utterance is cut into 1 + floor((G - B') L / F) units of equal frames
// (B' utterances with frames, F frames in all), a unit a block, so that the
// blocks' work is about even whatever the lengths and no block spans two
// utterances. Each block takes its unit for all W beams at once:
//   - staging, all with cp.async and waited for once: the taps (then
//     transposed, 4 filters a 16-byte load), wlp, locv, q + locb of all
//     beams and each beam's window of prev_att around the unit; v's rows
//     prefetched into L2; the unit's k rows in tiles of TF frames;
//   - conv: a thread an item (4 filters, beam, 4 frames) over all taps, the
//     4 frames' window slid through registers, 16 FMAs a tap; a warp's
//     items share their filters, so the taps' loads are broadcasts;
//   - energies: rows (beam, frame) of the tile in 16-row tiles; f @ wlp on
//     the tensor cores (mma m16n8k8, three TF32 products for float32
//     accuracy) for NB n-tiles at once, then locv . tanhf(k + q + fW) on the
//     CUDA cores in the lanes' registers (accurate tanhf: tanh.approx errs
//     by ~5e-4); the (row tile, Dk chunk) units dealt over the warps, the
//     chunks' partial sums added in a fixed order;
//   - each beam's local max and sum of the exps, and the partial context
//     exps [W, frames] @ v [frames, E] on the tensor cores (three TF32
//     products, v in tiles through shared memory), to a scratch slot of the
//     unit;
//   - one grid barrier; then each block scales its exps by the statistics
//     of its utterance's units into align, and the warps sum the units'
//     partial contexts, scaled, in unit order into ctx.
// A launch takes at most G utterances, and fewer where their units' frames
// would not fit in shared memory (e2e_att_step_plan); the wrapper launches
// the kernel for groups of utterances in turn where B is larger (one launch
// at the flagship decode shapes).
// No atomics, every sum in a fixed order: repeats are bitwise. The wrapper
// allocates the scratch (its size from the shapes alone) and launches on
// PyTorch's stream with no host synchronisation.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;  // threads a block
constexpr int NW = NT / 32;
constexpr int TF = 48;     // frames of k a tile
constexpr int KSMAX = 2;   // k-steps of f @ wlp (K <= 16)
constexpr int NPW = 8;     // n-tiles of the context a warp holds at once
constexpr int NCHMAX = 8;  // chunks of Dk the energies' units split into, at most
constexpr int NB = 4;      // n-tiles of the energies a warp takes at once
constexpr float LOWEST = -3.402823466e38f;  // -FLT_MAX
constexpr size_t SMEM_MAX = 227 * 1024;

// Timing build (nvcc -DATT_PHASES): thread 0 of block 0 adds the global
// timer's advance (ns) over each phase, after a __syncthreads that closes
// it for the block, into its own counters and writes them to g_att_ts at
// the end; the normal build compiles the marks away.
constexpr int ATT_SLOTS = 16;
#ifdef ATT_PHASES
__device__ unsigned long long g_att_ts[ATT_SLOTS];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PHASE(i)                                        \
  do {                                                  \
    __syncthreads();                                    \
    if (blockIdx.x == 0 && threadIdx.x == 0) {          \
      const unsigned long long now_ = global_ns();      \
      ph_ns[i] += now_ - ph_last;                       \
      ph_last = now_;                                   \
    }                                                   \
  } while (0)
#else
#define PHASE(i) \
  do {           \
  } while (0)
#endif
// the phases (ops/att_step_cuda.py PHASES)
enum { PH_STAGE, PH_CONV, PH_ENERGY, PH_SOFTMAX, PH_CONTEXT, PH_BAR, PH_ALIGN, PH_REDUCE, PH_N };

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// row strides: k tile [TF][KS] and wlp [K][WLS] with stride = 8 mod 32 (a
// quarter warp's fragment and pair loads free of bank conflicts); f [rows]
// [KPS] with KPS = 4 mod 8 (the A fragments' eight rows on distinct banks)
__host__ __device__ inline int stride8(int n) { return n <= 8 ? 8 : cdiv(n - 8, 32) * 32 + 8; }
__host__ __device__ inline int kps_of(int K) { return cdiv(K + 4, 8) * 8 - 4; }

// a region of n floats at offset o, o moved past it to the next 16 bytes
// (cp.async and float4 loads need 16-byte aligned shared memory)
__host__ __device__ inline size_t take(size_t& o, size_t n) {
  const size_t at = o;
  o = (o + n + 3) / 4 * 4;
  return at;
}

struct Layout {
  size_t tt, wl, lv, lb, qb, aw, en, scl, offs, kb, fs, ep, vt, total;
  int SbM, AW, KP4, KS, WLS, KPS, QS, VS;
};

// frames a unit (a block's share of one utterance) holds, at most: with B
// utterances on G blocks each gets 1 + floor((G - B) L / F) units (F the
// valid frames of all), so a unit's share is under F / (G - B) <= B S / (G - B)
__host__ __device__ inline int unit_frames(int B, int S, int G) {
  return G > B ? min(S, cdiv(B * S, G - B)) : S;
}

// shared-memory layout, in floats: per launch shapes only
__host__ __device__ inline Layout att_layout(int B, int W, int S, int Dk, int E, int K, int P, int G) {
  Layout l;
  l.SbM = unit_frames(B, S, G);
  // a beam's window of prev_att around a segment; an odd stride, so that the
  // conv's lanes (beam, 4-frame group) fall on all 32 banks
  l.AW = cdiv(l.SbM + P + 3, 4) * 4 + 1;
  l.KP4 = cdiv(K, 4) * 4;
  l.KS = stride8(Dk);
  l.WLS = stride8(Dk);
  l.KPS = kps_of(K);
  l.QS = cdiv(Dk, 8) * 8;
  l.VS = stride8(E);
  const int rows = W * TF;
  size_t o = 0;
  l.tt = take(o, (size_t)P * l.KP4);         // taps [P][KP4]
  l.wl = take(o, (size_t)K * l.WLS);         // wlp [K][WLS]
  l.lv = take(o, (size_t)cdiv(Dk, 8) * 8);   // locv (zeros past Dk)
  l.lb = take(o, (size_t)Dk);                // locb
  l.qb = take(o, (size_t)W * l.QS);          // q + locb of a segment's utterance [W][QS]
  l.aw = take(o, (size_t)W * l.AW);          // prev_att windows of a unit [W][AW]
  l.en = take(o, (size_t)W * l.SbM);         // a unit's energies, then exps [W][SbM]
  l.scl = take(o, (size_t)W);                // scale of a unit's exps [W]
  l.offs = take(o, 2 * (size_t)B + 2);       // the utterances' lengths' prefix sums, their first units (ints)
  // the union: k tile, f and the energies' partial sums; then a v tile
  const size_t u0 = o;
  l.kb = take(o, (size_t)TF * l.KS);         // k tile [TF][KS]
  const size_t f0 = o;
  l.fs = take(o, (size_t)rows * l.KPS);      // f [W TF][KPS]
  l.ep = take(o, (size_t)NCHMAX * rows);     // partial energies [NCH][W TF]
  const size_t ts = f0 + (size_t)K * P;      // staging: the taps [K][P] as they come, at fs
  o = o > ts ? o : ts;
  l.vt = u0;                                 // v tile [TF][VS]
  const size_t u1 = u0 + (size_t)TF * l.VS;
  l.total = o > u1 ? o : u1;
  return l;
}

struct Args {
  const float *q, *prev_att, *k, *v;
  const int* enc_len;
  const float *taps, *wlp, *locv, *locb;
  float *align, *ctx;
  float *stats, *part;  // scratch: a unit's (max, sum) [G + B][W][2] and partial context [G + B][W][E]
  int B, W, S, Dk, E, K, P;
  float inv_temp;
};

__global__ void __launch_bounds__(NT, 1) att_step_kernel(const Args a) {
  cg::grid_group grid = cg::this_grid();
  const int B = a.B, W = a.W, S = a.S, Dk = a.Dk, E = a.E, K = a.K, P = a.P;
  const int G = (int)gridDim.x, j = (int)blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g8 = lane >> 2, tig = lane & 3;
  const int half = (P - 1) / 2;
  extern __shared__ float smem[];
  const Layout ly = att_layout(B, W, S, Dk, E, K, P, G);
  const int AW = ly.AW, KP4 = ly.KP4, KS = ly.KS, WLS = ly.WLS, KPS = ly.KPS, QS = ly.QS, SbM = ly.SbM;
  const int VS = ly.VS;
  float* tt = smem + ly.tt;
  float* wl = smem + ly.wl;
  float* lv = smem + ly.lv;
  float* lb = smem + ly.lb;
  float* qb = smem + ly.qb;
  float* aw = smem + ly.aw;
  float* en = smem + ly.en;
  float* scl = smem + ly.scl;
  int* offs = (int*)(smem + ly.offs);
  float* kb = smem + ly.kb;
  float* fs = smem + ly.fs;
  float* ep = smem + ly.ep;
  float* vt = smem + ly.vt;
#ifdef ATT_PHASES
  unsigned long long ph_ns[PH_N] = {}, ph_last = 0;
  if (blockIdx.x == 0 && tid == 0) ph_last = global_ns();
#endif

  // rows [f0, f0 + n) of width `width` from src into dst (row stride ds),
  // in the background (16-byte copies where the rows allow them); the
  // caller commits
  auto load_rows = [&](float* dst, int ds, const float* src, int width, int f0, int n) {
    if (width % 4 == 0 && ds % 4 == 0 && ((uintptr_t)src & 15) == 0) {
      const int n4 = width / 4;
      for (int x = tid; x < n * n4; x += NT) {
        const int r = x / n4, c = (x % n4) * 4;
        cp_async16(dst + r * ds + c, src + (long)(f0 + r) * width + c);
      }
    } else {
      for (int x = tid; x < n * width; x += NT) {
        const int r = x / width, c = x % width;
        cp_async4(dst + r * ds + c, src + (long)(f0 + r) * width + c);
      }
    }
  };

  // ---- staging, all in the background and waited for once: the constants,
  // then (once the lengths are read) this block's unit, its utterance's q
  // and prev_att window and its first k tile. The utterances' valid frames
  // are laid end to end and each utterance cut into units, 1 + floor((G -
  // B') L / F) of them (B' utterances with frames, F frames in all), a unit
  // a block; zeros in every pad column the energies read
  float* tsc = fs;  // the taps as they come, [K][P]
  load_rows(wl, WLS, a.wlp, Dk, 0, K);
  for (int i = tid; i < K * P; i += NT) cp_async4(tsc + i, a.taps + i);
  for (int i = tid; i < Dk; i += NT) {
    cp_async4(lv + i, a.locv + i);
    cp_async4(lb + i, a.locb + i);
  }
  for (int u = tid; u < B; u += NT) offs[B + 1 + u] = min(max(a.enc_len[u], 0), S);
  __syncthreads();
  if (tid == 0) {  // offs[u]: frames before utterance u; offs[B + 1 + u]: its first unit
    int o = 0, ne = 0;
    for (int u = 0; u < B; ++u) {
      offs[u] = o;
      const int L = offs[B + 1 + u];
      o += L;
      ne += L > 0 ? 1 : 0;
    }
    offs[B] = o;
    const int spare = max(0, G - ne);
    int n = 0;
    for (int u = 0; u < B; ++u) {
      offs[B + 1 + u] = n;
      const int L = offs[u + 1] - offs[u];
      n += L > 0 ? 1 + (int)((long)spare * L / max(o, 1)) : 0;
    }
    offs[2 * B + 1] = n;
  }
  __syncthreads();
  const int* ufirst = offs + B + 1;  // ufirst[u]: utterance u's first unit; ufirst[B]: the units
  const int nunits = ufirst[B];
  // unit x: utterance b, its frames [s0, s0 + nv)
  auto unit = [&](int x, int& b, int& s0, int& nv) {
    b = 0;
    while (ufirst[b + 1] <= x) ++b;
    const int n = ufirst[b + 1] - ufirst[b], L = offs[b + 1] - offs[b], sb = cdiv(L, n);
    s0 = (x - ufirst[b]) * sb;
    nv = max(0, min(sb, L - s0));
  };
  int b = 0, s0 = 0, nv = 0;  // this block's unit (B <= G: at most one a block)
  if (j < nunits) unit(j, b, s0, nv);
  const long bw0 = (long)b * W;
  const float* kg = a.k + ((long)b * S + s0) * Dk;
  const float* vg = a.v + ((long)b * S + s0) * E;
  if (nv > 0) {
    load_rows(qb, QS, a.q + bw0 * Dk, Dk, 0, W);
    for (int i = tid; i < W * AW; i += NT) {  // window x holds prev_att at frame s0 - half + x, 0 outside [0, S)
      const int w = i / AW, x = s0 - half + i % AW;
      const bool in = x >= 0 && x < S;
      cp_async4_zfill(aw + i, a.prev_att + (bw0 + w) * S + (in ? x : 0), in ? 4 : 0);
    }
  }
  cp_async_commit();
  if (nv > 0) load_rows(kb, KS, kg, Dk, 0, min(nv, TF));
  cp_async_commit();
  for (long x = (long)tid * 32; x < (long)nv * E; x += (long)NT * 32)  // v's rows into L2
    asm volatile("prefetch.global.L2 [%0];" ::"l"(vg + x));
  {
    const int pad = QS - Dk;  // qb, lv and each k row past Dk
    for (int i = tid; i < W * pad; i += NT) qb[(i / pad) * QS + Dk + i % pad] = 0.0f;
    for (int i = tid; i < pad; i += NT) lv[Dk + i] = 0.0f;
    for (int i = tid; i < TF * pad; i += NT) kb[(i / pad) * KS + Dk + i % pad] = 0.0f;
    for (int i = tid; i < K * (WLS - Dk); i += NT) wl[(i / (WLS - Dk)) * WLS + Dk + i % (WLS - Dk)] = 0.0f;
  }
  cp_async_wait<1>();  // all but the k tile
  __syncthreads();
  for (int i = tid; i < P * KP4; i += NT) {  // taps transposed: 4 filters a 16-byte load
    const int pp = i / KP4, kk = i % KP4;
    tt[i] = kk < K ? tsc[kk * P + pp] : 0.0f;
  }
  for (int i = tid; i < W * Dk; i += NT) qb[(i / Dk) * QS + i % Dk] += lb[i % Dk];  // q + locb
  __syncthreads();
  PHASE(PH_STAGE);

  // ---- this block's unit: energies, local softmax statistics and the
  // partial context with the local exps, both to the scratch (slot j)
  if (nv > 0) {
    const long seg = j;
    for (int f0 = 0; f0 < nv; f0 += TF) {
      const int nt = min(TF, nv - f0), rows = W * nt;
      // ---- conv: a thread an item (4 filters, beam, 4 frames) over all
      // taps; the items of a warp share their filters, so that the taps'
      // 16-byte loads are broadcasts, and step through the taps together
      {
        const int ng = cdiv(nt, 4), nk = cdiv(K, 4), items = W * ng * nk;
        for (int item = tid; item < items; item += NT) {
          const int kg4 = item / (W * ng), r = item % (W * ng), w = r / ng, fg = r % ng;
          const float* win = aw + w * AW + f0 + 4 * fg;  // win[p + i] = prev_att at frame s0 + f0 + 4 fg + i, tap p
          const float* tk = tt + 4 * kg4;
          float acc[4][4] = {};
          float w0 = win[0], w1 = win[1], w2 = win[2];
#pragma unroll 4
          for (int p = 0; p < P; ++p) {
            const float w3 = win[p + 3];
            const float4 tv = *reinterpret_cast<const float4*>(tk + p * KP4);
            const float wv[4] = {w0, w1, w2, w3}, tp[4] = {tv.x, tv.y, tv.z, tv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(wv[i], tp[c], acc[i][c]);
            w0 = w1;
            w1 = w2;
            w2 = w3;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // all KP4 columns: zeros past K
            const int sl = 4 * fg + i;
            if (sl < nt) *reinterpret_cast<float4*>(fs + (w * nt + sl) * KPS + 4 * kg4) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          }
        }
      }
      cp_async_wait_all();  // the tile's k rows
      __syncthreads();
      PHASE(PH_CONV);
      // ---- energies: units (16-row tile, chunk of Dk's n-tiles), NB n-tiles
      // of a unit at once: fW = f @ wlp on the tensor cores for all of them
      // (K <= 16: at most two k-steps, accumulated in the tensor core), then
      // their tanh terms on the CUDA cores
      {
        const int mt = cdiv(rows, 16), ntd = cdiv(Dk, 8);
        int nch = 1;  // chunks: the fewest rounds x NB-batches a warp
        for (int c = 2; c <= NCHMAX; ++c)
          if ((long)cdiv(mt * c, NW) * cdiv(cdiv(ntd, c), NB) < (long)cdiv(mt * nch, NW) * cdiv(cdiv(ntd, nch), NB))
            nch = c;
        const int cn = cdiv(ntd, nch);
        // B rows of the lane (k = 8 s + tig and + 4), clamped into [0, K): the
        // A columns past K are zero, so any finite row does
        int wo[KSMAX][2];
#pragma unroll
        for (int s2 = 0; s2 < KSMAX; ++s2) {
          wo[s2][0] = min(8 * s2 + tig, K - 1) * WLS + g8;
          wo[s2][1] = min(8 * s2 + tig + 4, K - 1) * WLS + g8;
        }
        for (int u = wid; u < mt * nch; u += NW) {
          const int mi = u / nch, ci = u % nch;
          const int ra = mi * 16 + g8, rb = ra + 8;
          const bool va = ra < rows, vb = rb < rows;
          const int wa = va ? ra / nt : 0, sa = va ? ra % nt : 0, wb = vb ? rb / nt : 0, sb = vb ? rb % nt : 0;
          uint32_t ah[KSMAX][4], al[KSMAX][4];
#pragma unroll
          for (int s2 = 0; s2 < KSMAX; ++s2) {
            const int c0 = 8 * s2 + tig, c1 = c0 + 4;
            const float av[4] = {va && c0 < KP4 ? fs[ra * KPS + c0] : 0.0f, vb && c0 < KP4 ? fs[rb * KPS + c0] : 0.0f,
                                 va && c1 < KP4 ? fs[ra * KPS + c1] : 0.0f, vb && c1 < KP4 ? fs[rb * KPS + c1] : 0.0f};
#pragma unroll
            for (int i = 0; i < 4; ++i) tf32_split(av[i], ah[s2][i], al[s2][i]);
          }
          const float* ka = kb + sa * KS + 2 * tig;
          const float* kbr = kb + sb * KS + 2 * tig;
          const float* qa = qb + wa * QS + 2 * tig;
          const float* qbr = qb + wb * QS + 2 * tig;
          const float* lw = lv + 2 * tig;
          float r0 = 0.0f, r1 = 0.0f;
          const int n_beg = ci * cn, n_end = min(ntd, n_beg + cn);
          for (int nc = n_beg; nc < n_end; nc += NB) {
            float fw[NB][4];
#pragma unroll
            for (int j = 0; j < NB; ++j) {
              const int n0 = min(nc + j, n_end - 1) * 8;  // (a batch's tail repeats the last n-tile, unused)
#pragma unroll
              for (int i = 0; i < 4; ++i) fw[j][i] = 0.0f;
#pragma unroll
              for (int s2 = 0; s2 < KSMAX; ++s2) {  // both k-steps always (A is zero past K): no branch
                uint32_t bh[2], bl[2];                // between the n-tiles' products
                tf32_split(wl[wo[s2][0] + n0], bh[0], bl[0]);
                tf32_split(wl[wo[s2][1] + n0], bh[1], bl[1]);
                mma_tf32(fw[j], al[s2], bh);  // three TF32 products: lo hi + hi lo + hi hi
                mma_tf32(fw[j], ah[s2], bl);
                mma_tf32(fw[j], ah[s2], bh);
              }
            }
#pragma unroll
            for (int j = 0; j < NB; ++j) {
              if (nc + j < n_end) {
                const int d = (nc + j) * 8;  // the lane's columns d + 2 tig, + 1 (zeros past Dk)
                const float2 kx = *reinterpret_cast<const float2*>(ka + d), ky = *reinterpret_cast<const float2*>(kbr + d);
                const float2 qx = *reinterpret_cast<const float2*>(qa + d), qy = *reinterpret_cast<const float2*>(qbr + d);
                const float2 l2 = *reinterpret_cast<const float2*>(lw + d);
                r0 = fmaf(l2.x, tanhf(kx.x + qx.x + fw[j][0]), r0);
                r0 = fmaf(l2.y, tanhf(kx.y + qx.y + fw[j][1]), r0);
                r1 = fmaf(l2.x, tanhf(ky.x + qy.x + fw[j][2]), r1);
                r1 = fmaf(l2.y, tanhf(ky.y + qy.y + fw[j][3]), r1);
              }
            }
          }
          r0 += __shfl_xor_sync(0xffffffffu, r0, 1);
          r0 += __shfl_xor_sync(0xffffffffu, r0, 2);
          r1 += __shfl_xor_sync(0xffffffffu, r1, 1);
          r1 += __shfl_xor_sync(0xffffffffu, r1, 2);
          if (tig == 0) {
            if (va) ep[ci * W * TF + ra] = r0;
            if (vb) ep[ci * W * TF + rb] = r1;
          }
        }
        __syncthreads();
        for (int r = tid; r < rows; r += NT) {
          float e = 0.0f;
          for (int c = 0; c < nch; ++c) e += ep[c * W * TF + r];
          en[(r / nt) * SbM + f0 + r % nt] = e * a.inv_temp;
        }
      }
      __syncthreads();  // the k tile, f and the partial sums are consumed
      if (f0 + TF < nv) load_rows(kb, KS, kg, Dk, f0 + TF, min(TF, nv - f0 - TF));
      cp_async_commit();
      PHASE(PH_ENERGY);
    }
    // v's first tile into the union, behind the softmax
    load_rows(vt, VS, vg, E, 0, min(nv, TF));
    cp_async_commit();

    // ---- local softmax statistics, a warp a beam, to the scratch
    for (int w = wid; w < W; w += NW) {
      float* e_w = en + w * SbM;
      float m = LOWEST;
      for (int sl = lane; sl < nv; sl += 32) m = fmaxf(m, e_w[sl]);
      m = warp_max(m);
      float l = 0.0f;
      for (int sl = lane; sl < nv; sl += 32) {
        const float ex = expf(e_w[sl] - m);
        e_w[sl] = ex;
        l += ex;
      }
      l = warp_sum(l);
      if (lane == 0) {
        a.stats[(seg * W + w) * 2] = m;
        a.stats[(seg * W + w) * 2 + 1] = l;
      }
    }
    PHASE(PH_SOFTMAX);

    // ---- partial context exps [W, nv] @ v [nv, E] on the tensor cores, v in
    // tiles of TF frames through shared memory: rows = beams (16-beam
    // tiles), columns = E's n-tiles dealt over the warps (NPW each), k =
    // frames; to the scratch
    {
      const int nte = cdiv(E, 8);
      for (int m0 = 0; m0 < W; m0 += 16) {
        const int wa = m0 + g8, wb = wa + 8;
        for (int nb = 0; nb < nte; nb += NW * NPW) {
          float acc[NPW][4] = {};
          for (int f0 = 0; f0 < nv; f0 += TF) {
            const int nt = min(TF, nv - f0);
            if (m0 > 0 || nb > 0 || f0 > 0) load_rows(vt, VS, vg, E, f0, nt);  // (the first is in flight)
            cp_async_commit();
            cp_async_wait_all();
            __syncthreads();
            for (int s2 = 0; s2 < cdiv(nt, 8); ++s2) {
              const int fa = 8 * s2 + tig, fb = fa + 4;  // frames of the tile
              const float av[4] = {wa < W && fa < nt ? en[wa * SbM + f0 + fa] : 0.0f,
                                   wb < W && fa < nt ? en[wb * SbM + f0 + fa] : 0.0f,
                                   wa < W && fb < nt ? en[wa * SbM + f0 + fb] : 0.0f,
                                   wb < W && fb < nt ? en[wb * SbM + f0 + fb] : 0.0f};
              uint32_t ahf[4], alf[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) tf32_split(av[i], ahf[i], alf[i]);
#pragma unroll
              for (int jj = 0; jj < NPW; ++jj) {
                const int nj = nb + wid + jj * NW, e = nj * 8 + g8;
                if (nj < nte) {
                  const float b0 = fa < nt && e < E ? vt[fa * VS + e] : 0.0f;
                  const float b1 = fb < nt && e < E ? vt[fb * VS + e] : 0.0f;
                  uint32_t bh[2], bl[2];
                  tf32_split(b0, bh[0], bl[0]);
                  tf32_split(b1, bh[1], bl[1]);
                  mma_tf32(acc[jj], alf, bh);
                  mma_tf32(acc[jj], ahf, bl);
                  mma_tf32(acc[jj], ahf, bh);
                }
              }
            }
            __syncthreads();  // the tile is consumed
          }
          float* pg = a.part + seg * W * E;
#pragma unroll
          for (int jj = 0; jj < NPW; ++jj) {
            const int nj = nb + wid + jj * NW, e = nj * 8 + 2 * tig;
            if (nj >= nte) continue;
            if (wa < W) {
              if (e < E) pg[wa * E + e] = acc[jj][0];
              if (e + 1 < E) pg[wa * E + e + 1] = acc[jj][1];
            }
            if (wb < W) {
              if (e < E) pg[wb * E + e] = acc[jj][2];
              if (e + 1 < E) pg[wb * E + e + 1] = acc[jj][3];
            }
          }
        }
      }
    }
    PHASE(PH_CONTEXT);
  } else if (j < nunits) {  // a unit past its utterance's frames: no mass, no context
    for (int w = tid; w < W; w += NT) {
      a.stats[((long)j * W + w) * 2] = LOWEST;
      a.stats[((long)j * W + w) * 2 + 1] = 0.0f;
    }
    for (int i = tid; i < W * E; i += NT) a.part[(long)j * W * E + i] = 0.0f;
  }

  grid.sync();  // every unit's statistics and partial context are in the scratch
  PHASE(PH_BAR);

  // ---- align of this block's unit: the statistics of the utterance's
  // units (in order) scale the local exps; zeros past enc_len, written by
  // the utterance's last unit (an utterance with no frames: block u % G)
  if (j < nunits) {
    const int x = j;
    const int jf = ufirst[b], jl = ufirst[b + 1] - 1;
    for (int w = wid; w < W; w += NW) {  // a warp a beam, a lane a unit of the utterance
      float gm = LOWEST, z = 0.0f;
      for (int k0 = jf; k0 <= jl; k0 += 32) {
        const float2 st = k0 + lane <= jl ? __ldcg(reinterpret_cast<const float2*>(a.stats) + (long)(k0 + lane) * W + w)
                                          : make_float2(LOWEST, 0.0f);
        const float m = warp_max(st.x), g2 = fmaxf(gm, m);
        z = z * expf(gm - g2) + warp_sum(st.y * expf(st.x - g2));
        gm = g2;
      }
      if (lane == 0) {
        const float mx = __ldcg(a.stats + ((long)x * W + w) * 2);
        scl[w] = z > 0.0f ? expf(mx - gm) / z : 0.0f;
      }
    }
    __syncthreads();
    for (int i = tid; i < W * nv; i += NT) {
      const int w = i / nv, sl = i % nv;
      a.align[((long)b * W + w) * S + s0 + sl] = en[w * SbM + sl] * scl[w];
    }
    if (x == jl) {
      const int L = offs[b + 1] - offs[b];
      for (int i = tid; i < W * (S - L); i += NT) a.align[((long)b * W + i / (S - L)) * S + L + i % (S - L)] = 0.0f;
    }
    __syncthreads();
  }
  for (int u = j; u < B; u += G)
    if (offs[u + 1] == offs[u]) {
      for (int i = tid; i < W * S; i += NT) a.align[(long)u * W * S + i] = 0.0f;
      for (int i = tid; i < W * E; i += NT) a.ctx[(long)u * W * E + i] = 0.0f;
    }
  PHASE(PH_ALIGN);

  // ---- the context, a warp an item (utterance, beam, 128 columns of E, 4 a
  // lane): the units' partials scaled by their statistics, summed in order;
  // the statistics read once (a lane a unit), the partials of CU units at once
  constexpr int EC = 128, CU = 8;
  const int nec = cdiv(E, EC);
  for (long item = (long)j * NW + wid; item < (long)B * W * nec; item += (long)G * NW) {
    const int u = (int)(item / ((long)W * nec)), w = (int)((item / nec) % W), e0 = (int)(item % nec) * EC;
    const int jf = ufirst[u], n = ufirst[u + 1] - jf;
    if (n == 0) continue;
    float acc[EC / 32] = {};
    for (int k0 = 0; k0 < n; k0 += 32) {  // (one pass unless an utterance has over 32 units)
      const float2 st = k0 + lane < n ? __ldcg(reinterpret_cast<const float2*>(a.stats) + (long)(jf + k0 + lane) * W + w)
                                      : make_float2(LOWEST, 0.0f);
      float gm = LOWEST, z = 0.0f;  // over all the utterance's units
      for (int k2 = 0; k2 < n; k2 += 32) {
        const float2 s2 = k2 == k0 ? st
                                   : (k2 + lane < n ? __ldcg(reinterpret_cast<const float2*>(a.stats) + (long)(jf + k2 + lane) * W + w)
                                                    : make_float2(LOWEST, 0.0f));
        const float g2 = fmaxf(gm, warp_max(s2.x));
        z = z * expf(gm - g2) + warp_sum(s2.y * expf(s2.x - g2));
        gm = g2;
      }
      const float sc = k0 + lane < n && z > 0.0f ? expf(st.x - gm) / z : 0.0f;  // lane k: unit k0 + k's scale
      const int nk = min(32, n - k0);
      for (int k1 = 0; k1 < nk; k1 += CU) {
        float pv[CU][EC / 32];
#pragma unroll
        for (int c = 0; c < CU; ++c)
#pragma unroll
          for (int q = 0; q < EC / 32; ++q) {
            const int e = e0 + q * 32 + lane;
            pv[c][q] = k1 + c < nk && e < E ? __ldcg(a.part + ((long)(jf + k0 + k1 + c) * W + w) * E + e) : 0.0f;
          }
#pragma unroll
        for (int c = 0; c < CU; ++c) {
          const float scc = __shfl_sync(0xffffffffu, sc, (k1 + c) & 31);
#pragma unroll
          for (int q = 0; q < EC / 32; ++q) acc[q] = fmaf(scc, pv[c][q], acc[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < EC / 32; ++q) {
      const int e = e0 + q * 32 + lane;
      if (e < E) a.ctx[((long)u * W + w) * E + e] = acc[q];
    }
  }
  PHASE(PH_REDUCE);
#ifdef ATT_PHASES
  if (blockIdx.x == 0 && tid == 0)
    for (int i = 0; i < PH_N; ++i) g_att_ts[i] = ph_ns[i];
#endif
}

cudaError_t launch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* at, int grid, size_t smem,
                          cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  at[0].id = cudaLaunchAttributeCooperative;
  at[0].val.cooperative = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaFuncSetAttribute(att_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" const char* e2e_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch plan (host; asks the card once): out[0] = G, the blocks of the
// grid (every SM's resident blocks: one a SM at the flagship), out[1] =
// shared-memory bytes a block, out[2] = floats of scratch a launch needs,
// out[3] = Bg, the utterances a launch. A launch takes at most G utterances
// (a unit a block needs an utterance a block at least), and its units'
// frames, so its shared memory, grow with its utterances; where all B do not
// fit, the wrapper launches the kernel for groups of Bg utterances in turn,
// B split evenly into the fewest groups that fit. out[0] = 0 where not even
// one utterance fits.
extern "C" int e2e_att_step_plan(int B, int W, int S, int Dk, int E, int K, int P, int* out, void* stream) {
  (void)stream;
  out[0] = out[1] = out[2] = out[3] = 0;
  if (B < 1 || W < 1 || S < 1 || Dk < 1 || E < 1 || K < 1 || K > 8 * KSMAX || P < 1 || P % 2 != 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0, G = 0, bg = B;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  for (; bg >= 1; --bg) {  // the most utterances a launch whose layout fits
    const size_t smem = sizeof(float) * att_layout(bg, W, S, Dk, E, K, P, sms).total;
    if (smem > SMEM_MAX) continue;
    e = cudaFuncSetAttribute(att_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, att_step_kernel, NT, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) continue;
    G = sms * per_sm;  // (a smaller share a block: the layout for sms blocks fits)
    if (bg <= G) break;
    bg = G + 1;  // the next try: G utterances
  }
  if (bg < 1) return 0;
  bg = cdiv(B, cdiv(B, bg));  // the groups evened out (each fits: the layout grows with the utterances)
  out[0] = G;
  out[1] = (int)(sizeof(float) * att_layout(bg, W, S, Dk, E, K, P, G).total);
  out[2] = (G + bg) * W * (E + 2);  // a slot a unit: at most max(G, Bg) units
  out[3] = bg;
  return 0;
}

// q [B, W, Dk], prev_att [B, W, S], k [B, S, Dk], v [B, S, E], enc_len [B] int32,
// taps [K, P], wlp [K, Dk], locv [Dk], locb [Dk] -> align [B, W, S], ctx [B, W, E];
// scratch [(G + B) W (E + 2)] floats; a cooperative grid of G blocks, all
// resident, B <= G (e2e_att_step_plan).
extern "C" int e2e_att_step_beam_loc(const float* q, const float* prev_att, const float* k, const float* v,
                                     const int* enc_len, const float* taps, const float* wlp,
                                     const float* locv, const float* locb, float* align, float* ctx,
                                     float* scratch, int B, int W, int S, int Dk, int E, int K, int P,
                                     float inv_temp, int G, void* stream) {
  if (B < 1 || W < 1 || S < 1 || Dk < 1 || E < 1 || K < 1 || K > 8 * KSMAX || P % 2 != 1 || G < B)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * att_layout(B, W, S, Dk, E, K, P, G).total;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute at[1];
  cudaError_t e = launch_config(cfg, at, G, smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  const Args a{q, prev_att, k, v, enc_len, taps, wlp, locv, locb, align, ctx, scratch,
               scratch + (size_t)(G + B) * W * 2, B, W, S, Dk, E, K, P, inv_temp};
  return (int)cudaLaunchKernelEx(&cfg, att_step_kernel, a);
}

// out [ATT_SLOTS] u64: the timing build's ns per phase of block 0 in the
// last launch (cudaErrorNotSupported in the normal build)
extern "C" int e2e_att_step_phase_times(unsigned long long* out, int n, void* stream) {
#ifdef ATT_PHASES
  if (n > ATT_SLOTS) n = ATT_SLOTS;
  return (int)cudaMemcpyFromSymbolAsync(out, g_att_ts, sizeof(unsigned long long) * n, 0,
                                        cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
#else
  (void)out;
  (void)n;
  (void)stream;
  return (int)cudaErrorNotSupported;
#endif
}
