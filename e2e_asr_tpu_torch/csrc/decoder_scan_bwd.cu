// The fused speller scan, backward: one reverse sweep over the L steps, or
// over the first n (``steps``, the forward's count: the cotangents past them
// are zero in training, so are the carries they leave), the streams of the
// steps after them written as zeros.
//
// Replaces the backward of the TPU kernel e2e_asr_tpu/ops/decoder_pallas.py
// decoder_scan_fused (_bwd_call / _bwd_kernel). Given the forward's stored
// sequences (align, c, gate activations, q, ctx; csrc/decoder_scan.cu) and
// the cotangents of logits, align and hidden, it carries (dh, dc, d_align)
// from step t to t-1 and, per step t and utterance b,
//   dh      = dlogits Wout^T + dhidden + dh_carry
//   dc      = dc_carry + dh o (1 - tanh^2 c)
//   dgates  = [dc g i(1-i), dc c_prev f(1-f), dc i (1-g^2), dh tanh(c) o(1-o)]
//   dctx    = dgates Wx[Emb:]^T,  dh_lstm = dgates Wh^T
//   dalign  = v dctx + dalign_up + dalign_carry
//   denergy = align (dalign - <dalign, align>) / temp
//   e       = tanh(k + q + f Wlp + locb)   (rebuilt; f from the alignment of
//             step t-1, the uniform one at t = 0)
//   de      = denergy locv (1 - e^2)
//   dq = sum_s de,  dk += de,  dWlp += f^T de,  dlocv += sum_s e denergy,
//   dfpre   = de Wlp^T                      (the location features' cotangent)
//   dalign_carry = transposed conv of dfpre with the taps
//   dh_carry = dh_lstm + dq Wq^T,  dc_carry = dc f
// and streams out dgates [L, B, 4H], dq [L, B, Dk], dfpre [L, B, S, K]; dk
// [B, S, Dk] is accumulated on chip over the L steps and written once; dWlp
// and dlocv leave as one partial per block, summed by the caller in a fixed
// order (no atomics, so the result does not change from run to run). All
// other gradients are contractions over L*B outside the kernel. Unlike the
// TPU kernel the gate product is not rebuilt (the forward stores the
// activations), there is no Toeplitz bank and no one-hot product.
//
// What bounds it on the H100: latency, as the forward: L dependent steps of
// dependent phases; per step and utterance ~3 M FMAs, and a few tens of MB
// in and out over the whole sweep. Split into phases (the timing build), the
// first design (one 8-block cluster per utterance) spent 60% of a step in
// two passes that each rebuilt the tanh energies (one warp per frame, then
// one thread per attention unit walking the frames), an eighth streaming its
// rows of Wx and Wh from L2, and ran B = 16 utterances in two waves (at most
// 15 such clusters are resident). As in the forward, the row stage then
// waited on its inputs (every block pulls all utterances' dgates, 82 KB a
// step at the flagship), now loaded 16 bytes at a time, as are v and the
// k prefetch. With one cluster an utterance, a batch of 8 left 56 of the
// 120 resident blocks idle in the attention stage, three quarters of a
// step: its frames are now dealt over every resident block.
// Design: a persistent grid of G co-resident clusters of CL blocks
// (cooperative launch; CL from the wrapper's own plan for this kernel),
// three grid barriers a step:
//   gate stage  each block, side by side on two halves of its warps: the
//               carry of the step (dalign_carry of its frames, the
//               transposed conv over 4-frame register windows of the dfpre
//               frames around them, which the last grid barrier published,
//               and its share of <dalign_up + carry, align> to global
//               memory); dh, dc and dgates of its hidden units for every
//               utterance (dq Wq^T and dlogits Wout^T from the units' rows,
//               dq the sum of the utterance's parts in a fixed order);
//   grid barrier
//   row stage   each block: its rows of Wx[Emb:] (a slice of the context
//               columns) and of Wh (its units), resident in shared memory
//               once per launch, times the dgates of every utterance as
//               [16 utterances, 4H] x [4H, 8 rows] tiles on the tensor cores
//               (three TF32 products a tile, 16-byte loads of 16-column
//               chunks): dctx to global memory, dh_lstm kept for the next
//               gate stage;
//   grid barrier
//   attention   each block, the frames the deal gives it: the softmax term
//               (the shares of all the utterance's blocks, read in a fixed
//               order), the conv over 4-frame register windows, the tanh
//               energies rebuilt ONCE into shared memory (f Wlp on the
//               tensor cores, a warp walking the units of one 16-frame tile,
//               k prefetched with cp.async), dq, dlocv and dk += de in one
//               walk over the frames, dWlp += f^T de and dfpre = de Wlp^T as
//               tensor-core tiles, dfpre to global memory; the cluster
//               barrier (arrived at once dq's partials are written, waited on
//               after dfpre); the cluster's part of dq (its blocks' partials
//               summed, each block a slice) to global memory;
//   grid barrier.
// The deal (every block computes it at entry from the lengths, ranked on
// the card): where B >= G, slot i of cluster c holds one utterance (ranked
// by length, dealt in a snake order), NS = ceil(B / G) slots; where B < G,
// one slot, and each utterance takes consecutive clusters, the longer more
// (as many as the fewest frames a block of the longest allows), so every
// resident block holds frames. An utterance's valid frames are split evenly
// over its blocks; an utterance of m clusters has m parts of dq, summed in
// order by the next gate stage, where one block an utterance streams the sum
// out (the whole grid, after the last step).
// dk of a block's frames (first slot), its frames of k and v and the rows
// stay in shared memory where they fit (e2e_decoder_scan_bwd_plan decides,
// in order: the energies, the rows, dk, k, v) and are read from L2 or a
// global scratch otherwise; S is bounded only by the per-frame buffers
// (about 7,600 frames at the flagship widths on one cluster of 8 an
// utterance), and every per-frame buffer by the frames a block.
//
// Storage types (csrc/bf16.cuh): the kernel is a template on the storage
// type S (float or bf16) of k, v, the weights, the stored alignment and c,
// and the cotangents of logits, alignment and hidden; acts, q, ctx and
// every output stay float32 (the caller rounds the per-step streams where
// the TPU kernel stores them in bf16). The bf16 variant widens at the loads,
// keeps its carries (dh, dc, d_align) in float32, rebuilds the uniform
// initial alignment rounded to bf16 and holds its residents (the rows, k, v)
// in bf16; it does not prefetch k into the energies' buffer (bf16 k there
// would be overwritten by the float energies before all of it is read).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "tf32_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CLMAX = 8; // blocks per cluster, at most (the portable cluster size)
constexpr int NSPL = 4;   // threads a conv sum is split over, at most
constexpr int APAD = 4;  // zeros on each side of a stored alignment or dfpre (the convs' 4-frame windows)
constexpr int NTPF = 8;  // energy tiles whose k a lane loads at once
constexpr int NT = 512;  // threads per block
constexpr int NW = NT / 32;
constexpr int UCH = 4;   // hidden units a lane accumulates at once in the gate stage
constexpr int KPF = 5;   // 16-column chunks of row-stage inputs a warp loads at once
constexpr size_t SMEM_MAX = 227 * 1024;

// Timing build (nvcc -DSCAN_PHASES): block 0 writes the global timer (ns)
// at each phase boundary of each step (after a __syncthreads, so a mark
// closes the phase for the whole block) into g_phase_ts[step][mark]; the
// normal build compiles the marks away. e2e_decoder_scan_phase_times copies
// the buffer out.
constexpr int PH_STEPS = 512;  // steps recorded
constexpr int PH_SLOTS = 16;   // marks per step
#ifdef SCAN_PHASES
__device__ unsigned long long g_phase_ts[PH_STEPS * PH_SLOTS];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PHASE(t, i)                                                                   \
  do {                                                                                \
    __syncthreads();                                                                  \
    if (blockIdx.x == 0 && threadIdx.x == 0 && (t) < PH_STEPS) {                      \
      g_phase_ts[(t) * PH_SLOTS + (i)] = global_ns();                                 \
    }                                                                                 \
  } while (0)
#else
#define PHASE(t, i) \
  do {              \
  } while (0)
#endif

// tanh(x) = 1 - 2 / (exp(2x) + 1) through the special-function unit:
// absolute error below ~1e-6, a fraction of tanhf's instructions
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.0f - __fdividef(2.0f, __expf(2.0f * x) + 1.0f);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// sum over the block; red has NW slots; every thread gets the result
// the cluster barrier in two halves: arrive (releasing this block's writes
// before it), wait (acquiring every block's)
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

// a group of N threads of the block on named barrier BAR (0: the whole
// block, __syncthreads)
template <int N, int BAR>
struct Grp {
  static constexpr int n = N, nw = N / 32, bar = BAR;
};

template <typename G>
__device__ __forceinline__ void group_sync(G) {
  if constexpr (G::bar == 0) __syncthreads();
  else asm volatile("bar.sync %0, %1;\n" ::"n"(G::bar), "n"(G::n) : "memory");
}

// sum over group G's warps [w0, w0 + G::nw); red has NW slots; every thread
// of the group gets the result
template <typename G>
__device__ float group_sum(float x, float* red, int w0, G grp) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  x = warp_sum(x);
  group_sync(grp);
  if (lane == 0) red[wid] = x;
  group_sync(grp);
  return warp_sum(lane < G::nw ? red[w0 + lane] : 0.0f);
}

__device__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  x = warp_sum(x);
  __syncthreads();
  if (lane == 0) red[wid] = x;
  __syncthreads();
  return warp_sum(lane < NW ? red[lane] : 0.0f);
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// threads a conv sum of a block with Sl frames is split over: NSPL, fewer
// where the (4 frames, filter) items alone fill the block
__host__ __device__ inline int conv_parts(int Sl, int K) {
  const int n = NT / (cdiv(Sl, 4) * K);
  return n < 1 ? 1 : n < NSPL ? n : NSPL;
}

// row strides of the energies' operands: f [frames][KPS] (filters padded to
// a multiple of 8 with zeros) and Wlp [K][WLS]; both keep a warp's fragment
// loads free of bank conflicts
__host__ __device__ inline int kps_of(int K) { return cdiv(K, 8) * 8 + 4; }
__host__ __device__ inline int wls_of(int Dk) { return cdiv(Dk, 32) * 32 + 8; }

// row stride of the resident rows of Wx[Emb:] and Wh: 4H + 16 (4H is a
// multiple of 32; a quarter warp's 16-byte loads free of bank conflicts)
__host__ __device__ inline int row_stride(int H) { return 4 * H + 16; }

// items [i0, i0 + n) of block j when n_all items are split over nb blocks
// (the first n_all % nb blocks own one more)
__host__ __device__ inline void split_range(int n_all, int nb, int j, int& i0, int& n) {
  const int base = n_all / nb, rem = n_all % nb;
  n = base + (j < rem ? 1 : 0);
  i0 = j * base + (j < rem ? j : rem);
}

// utterances ranked by length, longest first (ties: lower index first)
__device__ void rank_utterances(const int* enc_len, int B, int S, int* ord) {
  for (int b = threadIdx.x; b < B; b += NT) {
    const int lb = min(max(enc_len[b], 0), S);
    int r = 0;
    for (int o = 0; o < B; ++o) {
      const int lo = min(max(enc_len[o], 0), S);
      r += (lo > lb || (lo == lb && o < b)) ? 1 : 0;
    }
    ord[r] = b;
  }
}

// utterance slots a cluster: one where B < G
__host__ __device__ inline int slots_of(int B, int G) { return cdiv(B, G); }

// frames a block holds at most: where B < G every utterance gets at least
// G / B clusters (the deal gives no utterance more frames a block than that
// even split of S would), else one cluster a slot
__host__ __device__ inline int frames_bound(int B, int S, int G, int CL) {
  const int m = G / B;
  return cdiv(S, (m > 1 ? m : 1) * CL);
}

// frames of the window around a block's Sl frames that its convs read:
// [s0 - half - APAD, s0 + ceil4(Sl) + half + APAD)
__host__ __device__ inline int window_of(int Sl, int P) { return cdiv(Sl, 4) * 4 + P - 1 + 2 * APAD; }

// row stride of a part of dq in global memory (16-byte rows)
__host__ __device__ inline int dk4_of(int Dk) { return cdiv(Dk, 4) * 4; }

__device__ __forceinline__ int warp_sum_i(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The deal, the same in every block (ops/decoder_cuda.py bwd_deal is its
// plain version): part x = c NS + i is slot i of cluster c; pu[x] its
// utterance (-1: none), pp[x] its index among the utterance's parts; u0[b],
// um[b] the first part of utterance b and their count (an utterance's parts
// are consecutive). B >= G: slot i of cluster c takes rank i G + c (i
// even) or i G + G-1-c (i odd), a part each. B < G: the ranks in order take
// consecutive clusters, each max(1, ceil(len / (M CL))) of them for the
// least M (frames a block) at which all fit in G, and the clusters left
// over one each from rank 0 on (every round of them).
__device__ void deal(const int* ulen, const int* ord, int B, int S, int G, int CL, int* pu, int* pp, int* u0,
                     int* um) {
  const int NS = slots_of(B, G), tid = threadIdx.x, lane = tid & 31;
  for (int x = tid; x < G * NS; x += NT) pu[x] = -1;
  __syncthreads();
  if (B >= G) {
    for (int r = tid; r < B; r += NT) {
      const int i = r / G, pos = r % G, c = (i & 1) ? G - 1 - pos : pos, x = c * NS + i, b = ord[r];
      pu[x] = b;
      pp[x] = 0;
      u0[b] = x;
      um[b] = 1;
    }
  } else if (tid < 32) {
    int lo = 1, hi = max(cdiv(S, CL), 1);  // at hi every utterance needs one cluster: B < G fit
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      int need = 0;
      for (int r = lane; r < B; r += 32) need += max(1, cdiv(ulen[ord[r]], mid * CL));
      if (warp_sum_i(need) <= G) hi = mid;
      else lo = mid + 1;
    }
    if (lane == 0) {
      int used = 0;
      for (int r = 0; r < B; ++r) used += max(1, cdiv(ulen[ord[r]], lo * CL));
      const int left = G - used;
      int c = 0;
      for (int r = 0; r < B; ++r) {
        const int b = ord[r];
        const int m = max(1, cdiv(ulen[b], lo * CL)) + left / B + (r < left % B ? 1 : 0);
        u0[b] = c;
        um[b] = m;
        for (int q = 0; q < m; ++q) {
          pu[c + q] = b;
          pp[c + q] = q;
        }
        c += m;
      }
    }
  }
  __syncthreads();
}

// a block's share of slot i: utterance b (-1: none), its part, the block's
// index q of the utterance's nbu = um[b] CL blocks, its frames [s0, s0 + nv)
struct Seg {
  int b, len, part, first, nbu, q, s0, nv;
};

__device__ __forceinline__ Seg segment(const int* ulen, const int* pu, const int* pp, const int* u0,
                                       const int* um, int c, int rank, int NS, int CL, int i) {
  Seg g;
  g.part = c * NS + i;
  g.b = pu[g.part];
  if (g.b < 0) return g;
  g.len = ulen[g.b];
  g.first = u0[g.b];
  g.nbu = um[g.b] * CL;
  g.q = pp[g.part] * CL + rank;
  split_range(g.len, g.nbu, g.q, g.s0, g.nv);
  return g;
}

template <typename ST>
struct BwdArgs {
  const ST *k, *v;
  const int* enc_len;
  const ST *taps, *wq, *wlp, *locv, *locb, *wx, *wh, *wout;
  const ST *align, *cseq;
  const float *acts, *qs, *ctxs;
  const ST *dlogits, *dalign, *dhidden;
  float *dgates, *dq, *dfpre, *dk, *dwlp_part, *dlocv_part;
  float* dctxg;    // scratch [B, E]: dctx of the step
  float* xch;      // scratch [G NS][Dk4] the parts of dq, then [2][G NS CL] the blocks' shares of <dalign, align>
  float* scratch;  // [G CL][Sl Dk]: es of the blocks that keep it out of shared memory
  int B, S, Dk, E, K, P, H, Emb, V, L;
  float inv_temp;
  // the steps run, n = min(max(*steps, 0), L) (null: L), read once at entry;
  // rows n .. L-1 of dgates, dq and dfpre are written as zeros
  const int* steps;
  int G, CL;  // clusters, blocks per cluster
  // residents in shared memory: the energies, the block's rows of Wx[Emb:]
  // and Wh, and the first slot's dk slice and frames of k and of v
  int es_smem, wr_smem, dk_smem, k_smem, v_smem;
};

// the block's row r (of [Wx[Emb + er0 .. + ner]; Wh[u0 ..]]) at column k
// from global memory, where the rows are not resident
template <typename S>
__device__ __forceinline__ float row_weight(const BwdArgs<S>& a, int r, int k, int ner, int er0, int u0) {
  return r < ner ? ldgf(a.wx + (long)(a.Emb + er0 + r) * 4 * a.H + k)
                 : ldgf(a.wh + (long)(u0 + r - ner) * 4 * a.H + k);
}

// floats of shared memory that n elements of es bytes take (a float each at
// es = 4)
__host__ __device__ inline size_t sfl(size_t n, int es) { return (n * es + 3) / 4; }

struct BwdLayout {
  size_t wr, dks, ks, vs, es, dfw, attw, attt, base, den, fs, dctx, dqp, qb, lv, wl, dwl, datt, dhl, dcc, gdot,
      red, ints, tp, cpart, tpart, total;
};

// shared-memory layout of the backward kernel, in floats; es: bytes an
// element of the residents the storage type holds (rows, k, v). The dfpre
// window of the gate stage and the row stage's partial tiles lie in the
// energies' buffer where that is resident and large enough (the energies
// live in the attention stage only)
__host__ __device__ inline BwdLayout bwd_layout(int B, int S, int Dk, int E, int K, int P, int H, int G, int CL,
                                                 int esres, int wr, int dkres, int kres, int vres, int es) {
  const int nb = G * CL, numax = cdiv(H, nb), nrmax = cdiv(E, nb) + numax;
  const int NS = slots_of(B, G), Sl = frames_bound(B, S, G, CL), WW = window_of(Sl, P);
  const int Sl4 = cdiv(Sl, 4) * 4, Sl16 = cdiv(Sl, 16) * 16, Dk8 = cdiv(Dk, 8) * 8;
  const bool alias = esres && (size_t)Sl * Dk >= (size_t)WW * K, talias = esres && Sl * Dk >= 4 * 32 * 8;
  BwdLayout l;
  size_t o = 0;
  l.wr = o;   o += wr ? sfl((size_t)nrmax * row_stride(H), es) : 0;
  l.dctx = o; o += E;  // on 16 bytes: row_stride is a multiple of 16 floats
  l.dks = o;  o += dkres ? (size_t)Sl * Dk : 0;
  l.ks = o;   o += kres ? sfl((size_t)Sl * Dk, es) : 0;
  l.vs = o;   o += vres ? sfl((size_t)Sl * E, es) : 0;
  l.es = o;   o += esres ? (size_t)Sl * Dk : 0;
  l.dfw = alias ? l.es : o;
  o += alias ? 0 : (size_t)WW * K;
  l.attw = o; o += WW;
  l.attt = o; o += Sl;
  l.base = o; o += Sl;
  l.den = o;  o += Sl;
  l.fs = o;   o += (size_t)Sl16 * kps_of(K);
  l.dqp = o;  o += (size_t)NS * dk4_of(Dk);
  l.qb = o;   o += Dk8;
  l.lv = o;   o += Dk8;
  l.wl = o;   o += (size_t)K * wls_of(Dk);
  l.dwl = o;  o += (size_t)K * Dk;
  l.datt = o; o += (size_t)NS * Sl;
  l.dhl = o;  o += (size_t)B * numax;
  l.dcc = o;  o += (size_t)B * numax;
  l.gdot = o; o += (size_t)B * numax;
  l.red = o;  o += NW;
  l.ints = o; o += 4 * (size_t)B + 2 * (size_t)G * NS;  // ord, ulen, u0, um; pu, pp
  l.tp = o;   o += (size_t)K * P;
  l.cpart = o; o += (size_t)conv_parts(Sl, K) * Sl4 * K;
  l.tpart = talias ? l.es : o;
  o += talias ? 0 : 4 * 32 * 8;
  l.total = o;
  return l;
}

template <typename S_>
__global__ void __launch_bounds__(NT) decoder_scan_bwd_kernel(const BwdArgs<S_> a) {
  cg::cluster_group cluster = cg::this_cluster();
  cg::grid_group grid = cg::this_grid();
  const int rank = (int)cluster.block_rank();
  const int B = a.B, S = a.S, Dk = a.Dk, E = a.E, K = a.K, P = a.P, H = a.H, Emb = a.Emb,
            V = a.V, L = a.L, G = a.G, CL = a.CL;
  const int NS = slots_of(B, G), NP = G * NS;  // slots a cluster, parts of the grid
  const int c = blockIdx.x / CL;
  const int j = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int half = (P - 1) / 2;
  const int G4 = 4 * H;
  const int nb = G * CL, numax = cdiv(H, nb);
  const int n = a.steps ? min(max(*a.steps, 0), L) : L;  // every block the same, before any barrier
  int u0, nu, er0, ner;
  split_range(H, nb, j, u0, nu);    // hidden units of this block
  split_range(E, nb, j, er0, ner);  // context columns (rows of Wx[Emb:]) of this block
  const int nr = ner + nu;          // row r < ner: Wx[Emb + er0 + r], else Wh[u0 + r - ner]
  const int Sl = frames_bound(B, S, G, CL), WW = window_of(Sl, P), Dk4 = dk4_of(Dk);
  const int Dkc = cdiv(Dk4, CL), d0 = rank * Dkc, ndk = max(0, min(Dkc, Dk4 - d0));  // own slice of dq's parts

  extern __shared__ float smem[];
  const BwdLayout ly = bwd_layout(B, S, Dk, E, K, P, H, G, CL, a.es_smem, a.wr_smem, a.dk_smem, a.k_smem,
                                  a.v_smem, sizeof(S_));
  const int Sl4 = cdiv(Sl, 4) * 4, Dk8 = cdiv(Dk, 8) * 8;
  const int nsp = conv_parts(Sl, K);
  const int KPS = kps_of(K), WLS = wls_of(Dk);
  const int WRS = row_stride(H);
  float* dqg = a.xch;                                    // [NP][Dk4] the parts of dq of the step
  float* p2g = a.xch + (long)NP * Dk4;                   // [2][NP][CL] the blocks' shares, by the step's parity
  float* own = a.scratch + (long)j * Sl * Dk;            // this block's scratch
  S_* wr = reinterpret_cast<S_*>(smem + ly.wr);  // [nr][WRS] rows of Wx[Emb:] and Wh (row_stride)
  float* dks = smem + ly.dks;    // [Sl][Dk]  dk of slot 0's own frames
  S_* ks = reinterpret_cast<S_*>(smem + ly.ks);  // [Sl][Dk]  slot 0's own frames of k
  S_* vs = reinterpret_cast<S_*>(smem + ly.vs);  // [Sl][E]   and of v
  float* es = a.es_smem ? smem + ly.es : own;  // [Sl][Dk]  the rebuilt tanh energies
  float* dfw = smem + ly.dfw;    // [WW][K]   dfpre of step t+1 around the own frames, zero outside [0, len)
  float* attw = smem + ly.attw;  // [WW]      alignment of step t-1 around the own frames, zero outside [0, len)
  float* attt = smem + ly.attt;  // [Sl]      alignment of step t, own frames
  float* base = smem + ly.base;  // [Sl]      dalign_up + dalign_carry
  float* den = smem + ly.den;    // [Sl]      denergy
  float* fs = smem + ly.fs;      // [Sl16][KPS] location features (zeros past nv and K)
  float* dctx = smem + ly.dctx;  // [E]
  float* dqp = smem + ly.dqp;    // [NS][Dk4] dq over the own frames, each slot
  float* qb = smem + ly.qb;      // [Dk8]     q + locb (zeros past Dk)
  float* lv = smem + ly.lv;      // [Dk8]     locv (zeros past Dk)
  float* wl = smem + ly.wl;      // [K][WLS]  Wlp (zeros past Dk)
  float* dwl = smem + ly.dwl;    // [K][Dk]   dWlp partial of this block
  float* datt = smem + ly.datt;  // [NS][Sl]  dalign_carry, own frames
  float* dhl = smem + ly.dhl;    // [B][numax] dh_lstm of the own units
  float* dcc = smem + ly.dcc;    // [B][numax] dc carry of the own units
  float* gdot = smem + ly.gdot;  // [B][numax] dlogits Wout^T + dq Wq^T of the own units
  float* red = smem + ly.red;    // [NW]
  int* ord = (int*)(smem + ly.ints);  // [B] utterances by rank
  int* ulen = ord + B;                // [B] lengths, clamped to [0, S]
  int* ufirst = ulen + B;             // [B] first part of each utterance
  int* uparts = ufirst + B;           // [B] and their count
  int* pu = uparts + B;               // [NP] utterance of each part
  int* pp = pu + NP;                  // [NP] its index among the utterance's parts
  float* tp = smem + ly.tp;          // [K][P]    conv taps
  float* cpart = smem + ly.cpart;    // [nsp][Sl4][K] parts of the conv sums
  float* tpart = smem + ly.tpart;    // [4][32][8] four warps' partial tiles
  auto seg = [&](int i) { return segment(ulen, pu, pp, ufirst, uparts, c, rank, NS, CL, i); };
  // the block's share of <dalign_up + carry, align> at step t, slot i, by
  // thread ct of group grp (warps [cw0, cw0 + grp.nw))
  auto share = [&](const Seg& g, int i, int t, int ct, auto grp, int cw0) {
    const long row = (long)t * B + g.b;
    float p2 = 0.0f;
    for (int sl = ct; sl < g.nv; sl += grp.n)
      p2 = fmaf(ldf(a.dalign + row * S + g.s0 + sl) + datt[i * Sl + sl], ldf(a.align + row * S + g.s0 + sl), p2);
    p2 = group_sum(p2, red, cw0, grp);
    if (ct == 0) p2g[(long)(t & 1) * NP * CL + (long)g.part * CL + rank] = p2;
  };

  // ---- once per launch
  for (int i = tid; i < K * Dk; i += NT) dwl[i] = 0.0f;
  for (int i = tid; i < K * WLS; i += NT) wl[i] = i % WLS < Dk ? ldf(a.wlp + (i / WLS) * Dk + i % WLS) : 0.0f;
  for (int i = tid; i < Dk8; i += NT) {
    lv[i] = i < Dk ? ldf(a.locv + i) : 0.0f;
    qb[i] = 0.0f;
  }
  for (int i = tid; i < K * P; i += NT) tp[i] = ldf(a.taps + i);
  for (int i = tid; i < B * numax; i += NT) {
    dhl[i] = 0.0f;
    dcc[i] = 0.0f;
  }
  if (a.wr_smem) {
    for (int i = tid; i < nr * G4; i += NT) {
      const int r = i / G4, col = i % G4;
      wr[r * WRS + col] = r < ner ? a.wx[(long)(Emb + er0 + r) * G4 + col] : a.wh[(long)(u0 + r - ner) * G4 + col];
    }
  }
  rank_utterances(a.enc_len, B, S, ord);
  for (int b = tid; b < B; b += NT) ulen[b] = min(max(a.enc_len[b], 0), S);
  __syncthreads();
  deal(ulen, ord, B, S, G, CL, pu, pp, ufirst, uparts);
  int last = -1;  // the cluster's last slot with an utterance
  for (int i = 0; i < NS; ++i)
    if (pu[c * NS + i] >= 0) last = i;
  for (int i = 0; i < NS; ++i) {
    const Seg g = seg(i);
    if (g.b < 0) continue;
    for (int x = tid; x < Sl; x += NT) datt[i * Sl + x] = 0.0f;
    float* dkg = a.dk + (long)g.b * S * Dk;
    int o, cnt;  // frames past the length: zero, split over the utterance's blocks
    split_range(S - g.len, g.nbu, g.q, o, cnt);
    for (long x = (long)(g.len + o) * Dk + tid; x < (long)(g.len + o + cnt) * Dk; x += NT) dkg[x] = 0.0f;
    if (i == 0 && a.dk_smem) {
      for (int x = tid; x < Sl * Dk; x += NT) dks[x] = 0.0f;
    } else {
      for (int x = tid; x < g.nv * Dk; x += NT) dkg[(long)g.s0 * Dk + x] = 0.0f;
    }
    if (i == 0) {
      if (a.k_smem)
        for (int x = tid; x < g.nv * Dk; x += NT) ks[x] = a.k[((long)g.b * S + g.s0) * Dk + x];
      if (a.v_smem)
        for (int x = tid; x < g.nv * E; x += NT) vs[x] = a.v[((long)g.b * S + g.s0) * E + x];
    }
    __syncthreads();
    // the share of the last step run (no carry yet), published by its grid barriers
    if (n > 0) share(g, i, n - 1, tid, Grp<NT, 0>{}, 0);
  }
  float dloc = 0.0f;  // dlocv of attention unit tid
  __syncthreads();

  for (int t = n - 1; t >= 0; --t) {
    PHASE(t, 0);
    // The carry and the gate stage of step t share no data: they run side
    // by side, the gates on warps [0, NW/2) and the carry on the rest, each
    // group on its own named barrier.
    // ---- the carry of step t (t < n - 1): dalign_carry[jf] = sum_kk sum_p
    // dfpre[jf + half - p, kk] taps[kk, p] of step t+1's dfpre (streamed
    // out before the last grid barrier), threads over (4 own frames, filter,
    // part of the taps), the 4 frames' dfpre values slid through registers;
    // then the block's share of <dalign_up + carry, align> of step t
    auto carry = [&](int ct, auto grp, int cw0) {  // thread ct of group grp, warps [cw0, cw0 + grp.nw)
      constexpr int cn = decltype(grp)::n, cnw = decltype(grp)::nw;
      for (int i = 0; i < NS && t + 1 < n; ++i) {
        const Seg g = seg(i);
        if (g.b < 0) continue;
        const int wb = g.s0 - half - APAD;  // frame of dfw's row 0
        const float* src = a.dfpre + (((long)(t + 1) * B + g.b) * S + wb) * K;
        for (int x0 = ct; x0 < WW * K; x0 += 8 * cn) {  // a thread's loads in flight, 8 at a time
          float y[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int x = x0 + u * cn, f = wb + x / K;
            y[u] = x < WW * K && f >= 0 && f < g.len ? __ldcg(src + x) : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (x0 + u * cn < WW * K) dfw[x0 + u * cn] = y[u];
        }
        group_sync(grp);
        for (int x = ct; x < nsp * cdiv(g.nv, 4) * K; x += cn) {
          const int part = x % nsp, pr = x / nsp, kk = pr % K, sl = 4 * (pr / K), jf = g.s0 + sl;
          const int p0 = max(0, jf + half - g.len + 1), p1 = min(P, jf + half + 4), pc = cdiv(p1 - p0, nsp);
          const int pa = p0 + part * pc, pb = min(p1, pa + pc);
          const float* tk = tp + kk * P;
          const float* dcol = dfw + (sl + 2 * half + APAD) * K + kk;  // dcol[(j - p) K] = dfpre at frame jf + j + half - p
          float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
          if (pa < pb) {
            float x0 = dcol[-pa * K], x1 = dcol[(1 - pa) * K], x2 = dcol[(2 - pa) * K],
                  x3 = dcol[(3 - pa) * K];
#pragma unroll 4
            for (int p = pa; p < pb; ++p) {
              const float tv = tk[p];
              c0 = fmaf(x0, tv, c0);
              c1 = fmaf(x1, tv, c1);
              c2 = fmaf(x2, tv, c2);
              c3 = fmaf(x3, tv, c3);
              x3 = x2;
              x2 = x1;
              x1 = x0;
              x0 = dcol[(-p - 1) * K];
            }
          }
          float* cp = cpart + (part * Sl4 + sl) * K + kk;
          cp[0] = c0;
          cp[K] = c1;
          cp[2 * K] = c2;
          cp[3 * K] = c3;
        }
        group_sync(grp);
        for (int sl = wid - cw0; sl < Sl; sl += cnw) {  // one warp a frame: the sum over filters and parts
          float acc = 0.0f;
          if (sl < g.nv)
            for (int y = lane; y < nsp * K; y += 32) acc += cpart[((y / K) * Sl4 + sl) * K + y % K];
          acc = warp_sum(acc);
          if (lane == 0) datt[i * Sl + sl] = acc;
        }
        group_sync(grp);
        share(g, i, t, ct, grp, cw0);
      }
    };
    // ---- gate stage: dh, dc, dgates of the own units, every utterance.
    // First dlogits Wout^T + dq Wq^T of the units, one warp per utterance,
    // UCH units at once (dq of step t+1: its parts summed in order, 16-byte
    // loads, all in flight); then one thread per (utterance, unit), whose
    // stored activations, c and dhidden are loaded first, in the background,
    // for a thread's first (utterance, unit)
    auto gate = [&](int gt, auto grp) {  // thread gt of group grp, warps [0, grp.nw)
      constexpr int gn = decltype(grp)::n, gnw = decltype(grp)::nw;
      const bool wq4 = Dk % 4 == 0 && ((uintptr_t)a.wq & (4 * sizeof(S_) - 1)) == 0;
      float pf[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (nu > 0 && gt < B * nu) {
        const int u = u0 + gt % nu;
        const long row = (long)t * B + gt / nu;
#pragma unroll
        for (int g = 0; g < 4; ++g) pf[g] = a.acts[row * G4 + g * H + u];
        pf[4] = ldf(a.cseq + row * H + u);
        pf[5] = t > 0 ? ldf(a.cseq + (row - B) * H + u) : 0.0f;
        pf[6] = ldf(a.dhidden + row * H + u);
      }
      for (int b = wid; b < B && nu > 0; b += gnw) {
        const long row = (long)t * B + b;
        float4 xs[NT / 128];  // dq of step t+1 at columns 4 lane + 128 r .. + 3 (zeros past Dk)
#pragma unroll
        for (int r = 0; r < NT / 128; ++r) xs[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (t + 1 < n) {
          const float* pb = dqg + (long)ufirst[b] * Dk4 + 4 * lane;
          const int m = uparts[b];
          for (int q0 = 0; q0 < m; q0 += 4) {  // four parts' loads in flight
            float4 y[4][NT / 128];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
#pragma unroll
              for (int r = 0; r < NT / 128; ++r)
                y[u][r] = q0 + u < m && 4 * lane + 128 * r < Dk4
                              ? __ldcg(reinterpret_cast<const float4*>(pb + (long)(q0 + u) * Dk4 + 128 * r))
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (q0 + u >= m) break;
#pragma unroll
              for (int r = 0; r < NT / 128; ++r) {
                xs[r].x += y[u][r].x;
                xs[r].y += y[u][r].y;
                xs[r].z += y[u][r].z;
                xs[r].w += y[u][r].w;
              }
            }
          }
          if (j == b % min(nb, H)) {  // one block with units streams dq of step t+1 out
            float* out = a.dq + ((long)(t + 1) * B + b) * Dk;
#pragma unroll
            for (int r = 0; r < NT / 128; ++r) {
              const int d = 4 * lane + 128 * r;
              const float xv[4] = {xs[r].x, xs[r].y, xs[r].z, xs[r].w};
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (d + e < Dk) out[d + e] = xv[e];
            }
          }
        }
        for (int j0 = 0; j0 < nu; j0 += UCH) {
          float acc[UCH];
#pragma unroll
          for (int q = 0; q < UCH; ++q) acc[q] = 0.0f;
          for (int vv = lane; vv < V; vv += 32) {
            const float x = ldf(a.dlogits + row * V + vv);
#pragma unroll
            for (int q = 0; q < UCH; ++q)
              if (j0 + q < nu) acc[q] = fmaf(x, ldgf(a.wout + (long)(u0 + j0 + q) * V + vv), acc[q]);
          }
          if (t + 1 < n) {
#pragma unroll
            for (int r = 0; r < NT / 128; ++r) {
              const int d = 4 * lane + 128 * r;
              if (d >= Dk) break;
              const float4 x = xs[r];
#pragma unroll
              for (int q = 0; q < UCH; ++q) {
                if (j0 + q < nu) {
                  const S_* wrow = a.wq + (long)(u0 + j0 + q) * Dk + d;
                  const float4 w = wq4 ? ld4g(wrow)
                                       : make_float4(ldgf(wrow), d + 1 < Dk ? ldgf(wrow + 1) : 0.0f,
                                                     d + 2 < Dk ? ldgf(wrow + 2) : 0.0f,
                                                     d + 3 < Dk ? ldgf(wrow + 3) : 0.0f);
                  acc[q] = fmaf(x.x, w.x, acc[q]);
                  acc[q] = fmaf(x.y, w.y, acc[q]);
                  acc[q] = fmaf(x.z, w.z, acc[q]);
                  acc[q] = fmaf(x.w, w.w, acc[q]);
                }
              }
            }
          }
#pragma unroll
          for (int q = 0; q < UCH; ++q) {
            const float tot = warp_sum(acc[q]);
            if (lane == 0 && j0 + q < nu) gdot[b * numax + j0 + q] = tot;
          }
        }
      }
      group_sync(grp);
      for (int x = gt; x < B * nu; x += gn) {
        const int b = x / nu, jj = x % nu, u = u0 + jj;
        const long row = (long)t * B + b;
        float v[7];
        if (x == gt) {
#pragma unroll
          for (int g = 0; g < 7; ++g) v[g] = pf[g];
        } else {
#pragma unroll
          for (int g = 0; g < 4; ++g) v[g] = a.acts[row * G4 + g * H + u];
          v[4] = ldf(a.cseq + row * H + u);
          v[5] = t > 0 ? ldf(a.cseq + (row - B) * H + u) : 0.0f;
          v[6] = ldf(a.dhidden + row * H + u);
        }
        const float ig = v[0], fg = v[1], gg = v[2], og = v[3];
        const float tc = tanhf(v[4]);
        const float cp = v[5];
        const float dh = gdot[b * numax + jj] + v[6] + dhl[b * numax + jj];
        const float dc = dcc[b * numax + jj] + dh * og * (1.0f - tc * tc);
        float* dg = a.dgates + row * G4 + u;
        dg[0] = dc * gg * ig * (1.0f - ig);
        dg[H] = dc * cp * fg * (1.0f - fg);
        dg[2 * H] = dc * ig * (1.0f - gg * gg);
        dg[3 * H] = dh * tc * og * (1.0f - og);
        dcc[b * numax + jj] = dc * fg;
      }
    };
    if (wid < NW / 2) gate(tid, Grp<NT / 2, 1>{});
    else carry(tid - NT / 2, Grp<NT / 2, 2>{}, NW / 2);
    __syncthreads();
    PHASE(t, 1);  // the carry and the gates, side by side
    PHASE(t, 2);  // gate stage
    grid.sync();  // the dgates of every utterance and the shares of step t are in global memory
    PHASE(t, 3);  // grid barrier 1

    // ---- row stage: dctx of the own context columns, dh_lstm of the own
    // units: [16 utterances, 4H] x [4H, 8 rows] tiles on the tensor cores
    // (three TF32 products a tile), the k-steps dealt over the warps, the
    // partial tiles summed in a fixed order, four warps a round
    for (int ub = 0; ub < B && nr > 0; ub += 16) {
      const int nch = G4 / 16, g8 = lane >> 2, tig = lane & 3;  // 4H: a multiple of 32
      const float* ga = a.dgates + ((long)t * B + ub + g8) * G4;
      const float* gb = ga + 8L * G4;
      const bool oka = ub + g8 < B, okb = ub + g8 + 8 < B;
      for (int n0 = 0; n0 < nr; n0 += 16) {
        const int r0 = n0 + g8, r1 = r0 + 8;  // the lane's rows of the two tiles
        const bool okr0 = r0 < nr, okr1 = r1 < nr;
        float d[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) d[q] = 0.0f;
        for (int kc = wid; kc < nch; kc += NW * KPF) {
          // chunk kc + NW u: dgates columns 16 (kc + NW u) + 4 tig .. + 3 of
          // utterances g8 and g8 + 8 (one 16-byte load each, all in flight)
          float4 aa[KPF], ab[KPF];
#pragma unroll
          for (int u = 0; u < KPF; ++u) {
            const int kx = 16 * (kc + NW * u) + 4 * tig;
            const bool ok = kc + NW * u < nch;
            aa[u] = ok && oka ? __ldcg(reinterpret_cast<const float4*>(ga + kx)) : make_float4(0, 0, 0, 0);
            ab[u] = ok && okb ? __ldcg(reinterpret_cast<const float4*>(gb + kx)) : make_float4(0, 0, 0, 0);
          }
#pragma unroll
          for (int u = 0; u < KPF; ++u) {
            if (kc + NW * u >= nch) break;
            const int kx = 16 * (kc + NW * u) + 4 * tig;
            float w0[4], w1[4];  // columns kx .. + 3 of the lane's two rows
            if (a.wr_smem) {
              const float4 x = okr0 ? ld4(wr + r0 * WRS + kx) : make_float4(0, 0, 0, 0);
              const float4 y = okr1 ? ld4(wr + r1 * WRS + kx) : make_float4(0, 0, 0, 0);
              w0[0] = x.x; w0[1] = x.y; w0[2] = x.z; w0[3] = x.w;
              w1[0] = y.x; w1[1] = y.y; w1[2] = y.z; w1[3] = y.w;
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                w0[e] = okr0 ? row_weight(a, r0, kx + e, ner, er0, u0) : 0.0f;
                w1[e] = okr1 ? row_weight(a, r1, kx + e, ner, er0, u0) : 0.0f;
              }
            }
            const float xa[4] = {aa[u].x, aa[u].y, aa[u].z, aa[u].w};
            const float xb[4] = {ab[u].x, ab[u].y, ab[u].z, ab[u].w};
            // k-step j of the chunk: its k = tig and tig + 4 are the columns
            // kx + 2 j and kx + 2 j + 1 (a permutation of the 16)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float av[4] = {xa[2 * j], xb[2 * j], xa[2 * j + 1], xb[2 * j + 1]};
              const float b0[2] = {w0[2 * j], w0[2 * j + 1]}, b1[2] = {w1[2 * j], w1[2 * j + 1]};
              mma_3xtf32(d, av, b0);
              mma_3xtf32(d + 4, av, b1);
            }
          }
        }
        for (int rd = 0; rd < NW / 4; ++rd) {
          if (wid / 4 == rd) {
            float* slot = tpart + ((wid % 4) * 32 + lane) * 8;
#pragma unroll
            for (int q = 0; q < 8; ++q) slot[q] = (rd == 0 ? 0.0f : slot[q]) + d[q];
          }
          __syncthreads();
        }
        for (int x = tid; x < 16 * 16; x += NT) {
          const int bl = x / 16, cl = x % 16, b = ub + bl, r = n0 + cl;
          if (b >= B || r >= nr) continue;
          const int ln = 4 * (bl % 8) + (cl % 8) / 2, q = 4 * (cl / 8) + 2 * (bl / 8) + cl % 2;
          float v = 0.0f;
#pragma unroll
          for (int w4 = 0; w4 < 4; ++w4) v += tpart[(w4 * 32 + ln) * 8 + q];
          if (r < ner) a.dctxg[(long)b * E + er0 + r] = v;
          else dhl[b * numax + r - ner] = v;
        }
        __syncthreads();
      }
    }
    PHASE(t, 4);  // row stage
    grid.sync();  // dctx of every utterance is in global memory
    PHASE(t, 5);  // grid barrier 2

    // ---- attention part, each slot
    for (int i = 0; i < NS; ++i) {
      const Seg g = seg(i);
      if (g.b < 0) continue;
      const int b = g.b, len = g.len, s0 = g.s0, nv = g.nv;
      const long row = (long)t * B + b;
      const float uni = rnd<S_>(len > 0 ? 1.0f / (float)len : 0.0f);
      // k of the own frames into es in the background, where k is not resident
      const bool kres = i == 0 && a.k_smem, kpref = !kres && a.es_smem && sizeof(S_) == 4;
      if (kpref) {
        const float* kg = reinterpret_cast<const float*>(a.k) + ((long)b * S + s0) * Dk;
        const int n4 = ((uintptr_t)kg & 15) == 0 && ((uintptr_t)es & 15) == 0 ? nv * Dk / 4 : 0;
        for (int x = tid; x < n4; x += NT) cp_async16(es + 4 * x, kg + 4 * x);
        for (int x = 4 * n4 + tid; x < nv * Dk; x += NT) cp_async4(es + x, kg + x);
      }
      // the shares of all the utterance's blocks of <dalign_up + carry,
      // align> (written before the last two grid barriers), summed in a fixed
      // order by every warp; the first in flight with the step's other loads
      const float* sh = p2g + (long)(t & 1) * NP * CL + (long)g.first * CL;
      float shx = lane < g.nbu ? __ldcg(sh + lane) : 0.0f;
      const int wb = s0 - half - APAD;  // frame of attw[0]
      float sdot = 0.0f;
      for (int x = tid; x < max(max(WW, Dk), E); x += NT) {  // every load of index x at once, then the stores
        const int f = wb + x;
        const bool okw = x < WW && f >= 0 && f < len, okt = x < nv, okq = x < Dk, oke = x < E;
        const float w = okw ? (t > 0 ? ldf(a.align + (row - B) * S + f) : uni) : 0.0f;
        const float at = okt ? ldf(a.align + row * S + s0 + x) : 0.0f;
        const float du = okt ? ldf(a.dalign + row * S + s0 + x) : 0.0f;
        const float qv = okq ? a.qs[row * Dk + x] : 0.0f, lb = okq ? ldf(a.locb + x) : 0.0f;
        const float dce = oke ? __ldcg(a.dctxg + (long)b * E + x) : 0.0f, ce = oke ? a.ctxs[row * E + x] : 0.0f;
        if (x < WW) attw[x] = w;
        if (okt) {
          attt[x] = at;
          base[x] = du + datt[i * Sl + x];
        }
        if (okq) qb[x] = qv + lb;
        if (oke) dctx[x] = dce;
        sdot = fmaf(dce, ce, sdot);
      }
      for (int q = lane + 32; q < g.nbu; q += 32) shx += __ldcg(sh + q);
      sdot = block_sum(sdot, red) + warp_sum(shx);  // block_sum's barriers publish the stores
      // the softmax term, two own frames a warp
      const bool vres = i == 0 && a.v_smem;
      const bool v4 = E % 4 == 0 && ((uintptr_t)(vres ? vs : a.v) & (4 * sizeof(S_) - 1)) == 0;
      for (int sl = wid; sl < nv; sl += 2 * NW) {
        const int sl2 = sl + NW;
        const bool two = sl2 < nv;
        const S_* vr1 = vres ? vs + (long)sl * E : a.v + ((long)b * S + s0 + sl) * E;
        const S_* vr2 = vres ? vs + (long)sl2 * E : a.v + ((long)b * S + s0 + sl2) * E;
        float acc1 = 0.0f, acc2 = 0.0f;
        if (v4) {  // 16-byte loads of v and dctx
#pragma unroll 5
          for (int e = 4 * lane; e < E; e += 128) {
            const float4 cc = *reinterpret_cast<const float4*>(dctx + e);
            const float4 x = ld4(vr1 + e);
            const float4 y = two ? ld4(vr2 + e) : make_float4(0, 0, 0, 0);
            acc1 = fmaf(cc.x, x.x, acc1);
            acc1 = fmaf(cc.y, x.y, acc1);
            acc1 = fmaf(cc.z, x.z, acc1);
            acc1 = fmaf(cc.w, x.w, acc1);
            acc2 = fmaf(cc.x, y.x, acc2);
            acc2 = fmaf(cc.y, y.y, acc2);
            acc2 = fmaf(cc.z, y.z, acc2);
            acc2 = fmaf(cc.w, y.w, acc2);
          }
        } else {
#pragma unroll 8
          for (int e = lane; e < E; e += 32) {
            const float x = dctx[e];
            acc1 = fmaf(x, ldf(vr1 + e), acc1);
            if (two) acc2 = fmaf(x, ldf(vr2 + e), acc2);
          }
        }
        acc1 = warp_sum(acc1);
        acc2 = warp_sum(acc2);
        if (lane == 0) {
          den[sl] = attt[sl] * (acc1 + base[sl] - sdot) * a.inv_temp;
          if (two) den[sl2] = attt[sl2] * (acc2 + base[sl2] - sdot) * a.inv_temp;
        }
      }
      PHASE(t, 6);  // loads and the softmax term
      // location features of step t-1's alignment: threads over (4 frames,
      // filter, part of the taps), the 4 frames' alignment values slid
      // through registers (attw is zero outside [0, len))
      for (int x = tid; x < nsp * cdiv(nv, 4) * K; x += NT) {
        const int part = x % nsp, pr = x / nsp, kk = pr % K, sl = 4 * (pr / K), s = s0 + sl;
        const int p0 = max(0, half - s - 3), p1 = min(P, len + half - s), pc = cdiv(p1 - p0, nsp);
        const int pa = p0 + part * pc, pb = min(p1, pa + pc);
        const float* tk = tp + kk * P;
        const float* w = attw + sl + APAD;  // w[p + j] = alignment at frame s + j + p - half
        float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
        if (pa < pb) {
          float w0 = w[pa], w1 = w[pa + 1], w2 = w[pa + 2];
#pragma unroll 4
          for (int p = pa; p < pb; ++p) {
            const float w3 = w[p + 3], tv = tk[p];
            c0 = fmaf(w0, tv, c0);
            c1 = fmaf(w1, tv, c1);
            c2 = fmaf(w2, tv, c2);
            c3 = fmaf(w3, tv, c3);
            w0 = w1;
            w1 = w2;
            w2 = w3;
          }
        }
        float* cp = cpart + (part * Sl4 + sl) * K + kk;
        cp[0] = c0;
        cp[K] = c1;
        cp[2 * K] = c2;
        cp[3 * K] = c3;
      }
      cp_async_wait_all();
      __syncthreads();
      const int mt = cdiv(nv, 16);  // 16-frame tiles of the energies
      for (int x = tid; x < mt * 16 * KPS; x += NT) {
        const int sl = x / KPS, kk = x % KPS;
        float acc = 0.0f;
        if (sl < nv && kk < K)
          for (int part = 0; part < nsp; ++part) acc += cpart[(part * Sl4 + sl) * K + kk];
        fs[x] = acc;
      }
      __syncthreads();
      PHASE(t, 7);  // conv
      // the tanh energies, rebuilt once: fW = f Wlp on the tensor cores
      // ([16 frames, K] x [K, 8 units] tiles), then e = tanh(k + q + fW) for
      // each (frame, unit) of a tile in its lanes' registers; es = e. A warp
      // keeps one frame tile and walks its units, k of NTPF tiles loaded at
      // once
      const int g8 = lane >> 2, tig = lane & 3;
      {
        const int nt = cdiv(Dk, 8);
        const int wpm = max(1, NW / max(mt, 1)), mg = NW / wpm;  // warps a frame tile, tiles at once
        const S_* kp = kres ? ks : kpref ? reinterpret_cast<const S_*>(es) : a.k + ((long)b * S + s0) * Dk;
        const bool k2 = Dk % 2 == 0 && ((uintptr_t)kp & (2 * sizeof(S_) - 1)) == 0;
        for (int mi = wid / wpm; wid < mg * wpm && mi < mt; mi += mg) {
          const int ra = mi * 16 + g8, rb = ra + 8;
          const bool va = ra < nv, vb = rb < nv;
          const float* fa = fs + ra * KPS;
          const float* fb = fs + rb * KPS;
          for (int nc0 = wid % wpm; nc0 < nt; nc0 += NTPF * wpm) {
            float kv[NTPF][4];
#pragma unroll
            for (int u = 0; u < NTPF; ++u) {
              const int d = (nc0 + u * wpm) * 8 + 2 * tig;
              if (k2) {  // d even, Dk even: the pair in one 8-byte load
                const float2 x = va && d < Dk ? ld2(kp + ra * Dk + d) : make_float2(0.0f, 0.0f);
                const float2 y = vb && d < Dk ? ld2(kp + rb * Dk + d) : make_float2(0.0f, 0.0f);
                kv[u][0] = x.x;
                kv[u][1] = x.y;
                kv[u][2] = y.x;
                kv[u][3] = y.y;
              } else {
                kv[u][0] = va && d < Dk ? ldf(kp + ra * Dk + d) : 0.0f;
                kv[u][1] = va && d + 1 < Dk ? ldf(kp + ra * Dk + d + 1) : 0.0f;
                kv[u][2] = vb && d < Dk ? ldf(kp + rb * Dk + d) : 0.0f;
                kv[u][3] = vb && d + 1 < Dk ? ldf(kp + rb * Dk + d + 1) : 0.0f;
              }
            }
#pragma unroll
            for (int u = 0; u < NTPF; ++u) {
              const int n0 = (nc0 + u * wpm) * 8;
              if (n0 >= Dk) break;
              const int d = n0 + 2 * tig;
              float dacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              for (int k0 = 0; k0 < K; k0 += 8) {
                const int ka = k0 + tig, kb = ka + 4;
                const float av[4] = {fa[ka], fb[ka], fa[kb], fb[kb]};
                const float bv[2] = {ka < K ? wl[ka * WLS + n0 + g8] : 0.0f,
                                     kb < K ? wl[kb * WLS + n0 + g8] : 0.0f};
                mma_3xtf32(dacc, av, bv);
              }
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int sl = e < 2 ? ra : rb, dd = d + (e & 1);
                if ((e < 2 ? va : vb) && dd < Dk) {
                  const int x = sl * Dk + dd;
                  const float ev = tanh_fast(kv[u][e] + qb[dd] + dacc[e]);
                  es[x] = ev;

                }
              }
            }
          }
        }
      }
      __syncthreads();
      PHASE(t, 8);  // energies
      // dq, dlocv and dk += de over the own frames: one thread per attention
      // unit, 16 frames' dk loaded at once (from L2 where dk is not
      // resident); es turns from e into de in place
      float* dkg = i == 0 && a.dk_smem ? dks : a.dk + ((long)b * S + s0) * Dk;
      for (int d = tid; d < Dk; d += NT) {
        const float lvd = lv[d];
        float dqa = 0.0f, dl = 0.0f;
        for (int sl0 = 0; sl0 < nv; sl0 += 16) {
          float dkv[16];
#pragma unroll
          for (int u = 0; u < 16; ++u) dkv[u] = sl0 + u < nv ? dkg[(sl0 + u) * Dk + d] : 0.0f;
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            const int sl = sl0 + u;
            if (sl >= nv) break;
            const float e = es[sl * Dk + d], g = den[sl];
            const float de = g * lvd * (1.0f - e * e);
            es[sl * Dk + d] = de;
            dkg[sl * Dk + d] = dkv[u] + de;
            dqa += de;
            dl = fmaf(e, g, dl);
          }
        }
        dqp[i * Dk4 + d] = dqa;
        dloc += dl;
      }
      __syncthreads();
      if (i == last) cluster_arrive();  // the partials of every slot are written: the cluster may read them
      PHASE(t, 9);  // reductions over the frames
      // dWlp += f^T de ([16 filters, frames] x [frames, 8 units] tiles) and
      // dfpre = de Wlp^T ([16 frames, Dk] x [Dk, 8 filters] tiles) on the
      // tensor cores, one tile a warp
      {
        const int mtw = cdiv(K, 16), ntw = cdiv(Dk, 8), mtf = cdiv(nv, 16), ntf = cdiv(K, 8);
        for (int item = wid; item < mtw * ntw + mtf * ntf; item += NW) {
          float dacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          float av[4], bv[2];
          if (item < mtw * ntw) {
            const int m0 = (item / ntw) * 16, n0 = (item % ntw) * 8;  // filters x units
            const int ra = m0 + g8, rb = ra + 8, cn = n0 + g8;
            for (int k0 = 0; k0 < nv; k0 += 8) {  // over the own frames
              const int ka = k0 + tig, kb = ka + 4;
              av[0] = ra < K && ka < nv ? fs[ka * KPS + ra] : 0.0f;
              av[1] = rb < K && ka < nv ? fs[ka * KPS + rb] : 0.0f;
              av[2] = ra < K && kb < nv ? fs[kb * KPS + ra] : 0.0f;
              av[3] = rb < K && kb < nv ? fs[kb * KPS + rb] : 0.0f;
              bv[0] = ka < nv && cn < Dk ? es[ka * Dk + cn] : 0.0f;
              bv[1] = kb < nv && cn < Dk ? es[kb * Dk + cn] : 0.0f;
              mma_3xtf32(dacc, av, bv);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kk = e < 2 ? ra : rb, d = n0 + 2 * tig + (e & 1);
              if (kk < K && d < Dk) dwl[kk * Dk + d] += dacc[e];
            }
          } else {
            const int it2 = item - mtw * ntw;
            const int m0 = (it2 / ntf) * 16, n0 = (it2 % ntf) * 8;  // frames x filters
            const int ra = m0 + g8, rb = ra + 8, cn = n0 + g8;
            float dacc2[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // odd k-steps: two chains of mma
            for (int k0 = 0; k0 < Dk; k0 += 16) {  // over the attention units
#pragma unroll
              for (int h2 = 0; h2 < 2; ++h2) {
                const int ka = k0 + 8 * h2 + tig, kb = ka + 4;
                av[0] = ra < nv && ka < Dk ? es[ra * Dk + ka] : 0.0f;
                av[1] = rb < nv && ka < Dk ? es[rb * Dk + ka] : 0.0f;
                av[2] = ra < nv && kb < Dk ? es[ra * Dk + kb] : 0.0f;
                av[3] = rb < nv && kb < Dk ? es[rb * Dk + kb] : 0.0f;
                bv[0] = ka < Dk && cn < K ? wl[cn * WLS + ka] : 0.0f;
                bv[1] = kb < Dk && cn < K ? wl[cn * WLS + kb] : 0.0f;
                if (h2 == 0) mma_3xtf32(dacc, av, bv);
                else mma_3xtf32(dacc2, av, bv);
              }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) dacc[e] += dacc2[e];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int sl = e < 2 ? ra : rb, kk = n0 + 2 * tig + (e & 1);
              if (sl < nv && kk < K) a.dfpre[(row * S + s0 + sl) * K + kk] = dacc[e];
            }
          }
        }
      }
      {  // frames past the length: zero, split over the utterance's blocks
        int o, cnt;
        split_range(S - len, g.nbu, g.q, o, cnt);
        for (long x = (long)(len + o) * K + tid; x < (long)(len + o + cnt) * K; x += NT)
          a.dfpre[row * S * K + x] = 0.0f;
      }
      PHASE(t, 10);  // dfpre
    }
    if (last < 0) cluster_arrive();
    cluster_wait();  // every block's dq partials of each slot are readable
    PHASE(t, 11);    // cluster barrier
    // the cluster's part of dq of each slot: the blocks' partials summed in
    // order, each block a slice (zeros past Dk)
    for (int i = 0; i < NS; ++i) {
      const int part = c * NS + i;
      if (pu[part] < 0) continue;
      for (int d = d0 + tid; d < d0 + ndk; d += NT) {
        float pv[CLMAX];  // the blocks' partials, all loads in flight
#pragma unroll
        for (int q = 0; q < CLMAX; ++q) pv[q] = q < CL && d < Dk ? *cluster.map_shared_rank(dqp + i * Dk4 + d, q) : 0.0f;
        float acc = 0.0f;
#pragma unroll
        for (int q = 0; q < CLMAX; ++q) acc += pv[q];
        dqg[(long)part * Dk4 + d] = acc;
      }
    }
    PHASE(t, 12);  // dq's parts
    grid.sync();   // the parts of dq and dfpre of every utterance are in global memory
    PHASE(t, 13);  // grid barrier 3
  }

  // dq of step 0 of every utterance, the sum of its parts in order (as the
  // gate stage sums and streams out those of the later steps), over the grid
  for (long x = (long)j * NT + tid; x < (long)B * Dk && n > 0; x += (long)gridDim.x * NT) {
    const int b = (int)(x / Dk);
    const float* pb = dqg + (long)ufirst[b] * Dk4 + x % Dk;
    float acc = 0.0f;
    for (int q = 0; q < uparts[b]; ++q) acc += __ldcg(pb + (long)q * Dk4);
    a.dq[x] = acc;
  }
  for (int i = 0; i < NS; ++i) {
    const Seg g = seg(i);
    if (g.b < 0 || i != 0 || !a.dk_smem) continue;
    float* out = a.dk + ((long)g.b * S + g.s0) * Dk;
    for (int x = tid; x < g.nv * Dk; x += NT) out[x] = dks[x];
  }
  for (int d = tid; d < Dk; d += NT) a.dlocv_part[(long)j * Dk + d] = dloc;
  for (int i = tid; i < K * Dk; i += NT) a.dwlp_part[(long)j * K * Dk + i] = dwl[i];
  // ---- rows n .. L-1 of the streams: zeros, over the whole grid
  const long r0 = (long)n * B, rows = (long)(L - n) * B;
  const long gt = (long)j * NT + tid, gs = (long)gridDim.x * NT;
  for (long x = gt; x < rows * G4; x += gs) a.dgates[r0 * G4 + x] = 0.0f;
  for (long x = gt; x < rows * Dk; x += gs) a.dq[r0 * Dk + x] = 0.0f;
  for (long x = gt; x < rows * S * K; x += gs) a.dfpre[r0 * S * K + x] = 0.0f;
}

// the kernel of storage type dt (0 float, 1 bf16)
const void* bwd_kernel(int dt) {
  return dt ? (const void*)decoder_scan_bwd_kernel<bf16> : (const void*)decoder_scan_bwd_kernel<float>;
}

// a cooperative launch of G clusters with smem bytes of shared memory a block
cudaError_t launch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* at, int G, int CL,
                          size_t smem, int dt, cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3(G * CL);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = CL;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  return cudaFuncSetAttribute(bwd_kernel(dt), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" const char* e2e_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out[0] = the clusters of cl blocks of the backward kernel of storage type
// dt (0 float, 1 bf16) that can be resident at once with smem bytes of
// dynamic shared memory a block
extern "C" int e2e_decoder_scan_bwd_clusters(int cl, int smem, int dt, int* out, void* stream) {
  if (cl < 1 || cl > CLMAX || dt < 0 || dt > 1) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute at[2];
  cudaError_t e = launch_config(cfg, at, 1, cl, (size_t)smem, dt, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  cfg.numAttrs = 1;  // the query takes the cluster shape
  return (int)cudaOccupancyMaxActiveClusters(out, bwd_kernel(dt), &cfg);
}

// The backward kernel's shared memory on G clusters of CL blocks (host
// only): out[0] = bytes a block, or -1 where the working buffers alone
// exceed SMEM_MAX; out[1..5] = the flags es_smem, wr_smem, dk_smem, k_smem,
// v_smem of e2e_decoder_scan_bwd, each resident taken in that order while
// the block's total stays within SMEM_MAX; out[6] = the floats of scratch a
// block needs (0 when es is resident); out[7] = the frames a block holds at
// most; dt: the storage type (0 float, 1 bf16), in which the residents are
// held.
extern "C" int e2e_decoder_scan_bwd_plan(int B, int S, int Dk, int E, int K, int P, int H, int G,
                                         int CL, int dt, int* out, void* stream) {
  (void)stream;
  if (B < 1 || S < 1 || G < 1 || CL < 1 || CL > CLMAX || dt < 0 || dt > 1) return (int)cudaErrorInvalidValue;
  const int es = dt ? 2 : 4;
  int f[5] = {0, 0, 0, 0, 0};  // es, wr, dk, k, v
  auto bytes = [&]() {
    return sizeof(float) * bwd_layout(B, S, Dk, E, K, P, H, G, CL, f[0], f[1], f[2], f[3], f[4], es).total;
  };
  out[0] = -1;
  if (bytes() > SMEM_MAX) return 0;
  for (int i = 0; i < 5; ++i) {
    f[i] = 1;
    if (bytes() > SMEM_MAX) f[i] = 0;
    out[1 + i] = f[i];
  }
  out[0] = (int)bytes();
  out[6] = f[0] ? 0 : frames_bound(B, S, G, CL) * Dk;
  out[7] = frames_bound(B, S, G, CL);
  return 0;
}

// out [PH_STEPS * PH_SLOTS] u64: the timing build's phase marks of the last
// launch (cudaErrorNotSupported in the normal build)
extern "C" int e2e_decoder_scan_phase_times(unsigned long long* out, int n, void* stream) {
#ifdef SCAN_PHASES
  if (n > PH_STEPS * PH_SLOTS) n = PH_STEPS * PH_SLOTS;
  return (int)cudaMemcpyFromSymbolAsync(out, g_phase_ts, sizeof(unsigned long long) * n, 0,
                                        cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
#else
  (void)out;
  (void)n;
  (void)stream;
  return (int)cudaErrorNotSupported;
#endif
}

// k [B, S, Dk], v [B, S, E], enc_len [B] i32, taps [K, P], wq [H, Dk], wlp [K, Dk],
// locv [Dk], locb [Dk], wx [Emb + E, 4H], wh [H, 4H], wout [H, V]; the forward's
// align [L, B, S], cseq [L, B, H], acts [L, B, 4H], qs [L, B, Dk], ctxs [L, B, E];
// cotangents dlogits [L, B, V], dalign [L, B, S], dhidden [L, B, H]; steps
// [1] i32 (the steps run from the last back, clamped to [0, L]; null: L)
// -> dgates [L, B, 4H], dq [L, B, Dk], dfpre [L, B, S, K] (zero on rows past
// the steps run), dk [B, S, Dk],
// dwlp_part [G CL, K, Dk], dlocv_part [G CL, Dk]; scratch dctxg [B, E], xch
// [G NS (ceil4(Dk) + 2 CL)] (NS = ceil(B / G)) and scratch [G CL, Sl Dk] (Sl:
// the plan's frames a block). The inputs of storage type dt (0 float, 1
// bf16) but acts, qs and ctxs; those and every output float, all
// contiguous. H a multiple of 8 up to 512, Dk up to 512, P odd. G clusters
// of CL blocks (all resident: the cooperative launch fails otherwise); the
// flags say what lives in shared memory.
extern "C" int e2e_decoder_scan_bwd(
    const void* k, const void* v, const int* enc_len, const void* taps, const void* wq,
    const void* wlp, const void* locv, const void* locb, const void* wx, const void* wh,
    const void* wout, const void* align, const void* cseq, const float* acts, const float* qs,
    const float* ctxs, const void* dlogits, const void* dalign, const void* dhidden,
    float* dgates, float* dq, float* dfpre, float* dk, float* dwlp_part, float* dlocv_part,
    float* dctxg, float* xch, float* scratch, int B, int S, int Dk, int E, int K, int P, int H, int Emb,
    int V, int L, float inv_temp, const int* steps, int G, int CL, int es_smem, int wr_smem, int dk_smem,
    int k_smem, int v_smem, int dt, void* stream) {
  if (H % 8 != 0 || H > 512 || Dk > NT || P % 2 != 1 || B < 1 || S < 1 || L < 1 || V < 1 || G < 1 ||
      CL < 1 || CL > CLMAX || dt < 0 || dt > 1)
    return (int)cudaErrorInvalidValue;
  const BwdLayout ly = bwd_layout(B, S, Dk, E, K, P, H, G, CL, es_smem, wr_smem, dk_smem, k_smem, v_smem,
                                  dt ? 2 : 4);
  const size_t smem = sizeof(float) * ly.total;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute at[2];
  cudaError_t e = launch_config(cfg, at, G, CL, smem, dt, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  auto run = [&](auto zero) -> cudaError_t {
    using T = decltype(zero);
    using C = const T*;
    BwdArgs<T> a{(C)k, (C)v, enc_len, (C)taps, (C)wq, (C)wlp, (C)locv, (C)locb, (C)wx, (C)wh, (C)wout,
                 (C)align, (C)cseq, acts, qs, ctxs, (C)dlogits, (C)dalign, (C)dhidden, dgates, dq, dfpre,
                 dk, dwlp_part, dlocv_part, dctxg, xch, scratch,
                 B, S, Dk, E, K, P, H, Emb, V, L, inv_temp, steps, G, CL, es_smem, wr_smem,
                 dk_smem, k_smem, v_smem};
    return cudaLaunchKernelEx(&cfg, decoder_scan_bwd_kernel<T>, a);
  };
  return (int)(dt ? run(bf16{}) : run(0.0f));
}
