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
// k prefetch.
// Design: a persistent grid of G co-resident clusters of CL blocks
// (cooperative launch, CL and G picked by the wrapper as for the forward),
// three grid barriers a step:
//   gate stage  each block: dh, dc and dgates of its hidden units for every
//               utterance (dq Wq^T and dlogits Wout^T from the units' rows);
//   grid barrier
//   row stage   each block: its rows of Wx[Emb:] (a slice of the context
//               columns) and of Wh (its units), resident in shared memory
//               once per launch, times the dgates of every utterance as
//               [16 utterances, 4H] x [4H, 8 rows] tiles on the tensor cores
//               (three TF32 products a tile, 16-byte loads of 16-column
//               chunks): dctx to global memory, dh_lstm kept for the next
//               gate stage;
//   grid barrier
//   attention   each cluster, each of its utterances (ranked by length and
//               dealt in a snake order, valid frames split evenly over the
//               blocks): the softmax term (the blocks' shares of
//               <dalign, align>, published by the grid barriers), the conv
//               over 4-frame register windows, the tanh energies rebuilt
//               ONCE into shared memory (f Wlp on the tensor cores, a warp
//               walking the units of one 16-frame tile, k prefetched with
//               cp.async; dk added there), dq and dlocv as sums over the
//               frames, dWlp += f^T de and dfpre = de Wlp^T as tensor-core
//               tiles; cluster barrier; dq (own slice) and dfpre of all
//               frames pulled from the blocks, the transposed conv over
//               4-frame register windows;
//   grid barrier.
// dk of a block's frames (first slot), its frames of k and v stay in shared
// memory where they fit (e2e_decoder_scan_bwd_plan decides, in order: the
// energies and dfpre buffers, the rows, dk, k, v) and are read from L2 or
// a global scratch otherwise; S is bounded only by the per-frame buffers (about
// 6,800 frames at the flagship widths on 8-block clusters).
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

// slot i of cluster c: rank i G + c (i even) or i G + G-1-c (i odd)
__device__ __forceinline__ int slot_utterance(const int* ord, int B, int G, int c, int i) {
  const int idx = i * G + ((i & 1) ? G - 1 - c : c);
  return idx < B ? ord[idx] : -1;
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
  float* scratch;  // [G CL][Sl Dk + S K]: es and dfa of the blocks that keep them out of shared memory
  int B, S, Dk, E, K, P, H, Emb, V, L;
  float inv_temp;
  // the steps run, n = min(max(*steps, 0), L) (null: L), read once at entry;
  // rows n .. L-1 of dgates, dq and dfpre are written as zeros
  const int* steps;
  int G, CL, NS;  // clusters, blocks per cluster, utterance slots per cluster
  // residents in shared memory: the block's rows of Wx[Emb:] and Wh, and the
  // first slot's dk slice and frames of k and of v
  int es_smem, dfa_smem, wr_smem, dk_smem, k_smem, v_smem;
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
  size_t wr, dks, ks, vs, es, attp, attt, base, den, dnx, fs, dfo, dfa, dctx, ctx, dqp, qb, lv, wl, dwl,
      datt, p2s, dhl, dcc, gdot, red, ord, tp, cpart, tpart, total;
};

// shared-memory layout of the backward kernel, in floats; es: bytes an
// element of the residents the storage type holds (rows, k, v)
__host__ __device__ inline BwdLayout bwd_layout(int B, int S, int Dk, int E, int K, int P, int H,
                                                 int G, int CL, int NS, int esres, int dfares,
                                                 int wr, int dkres, int kres, int vres, int es) {
  const int nb = G * CL, numax = cdiv(H, nb), nrmax = cdiv(E, nb) + numax;
  const int Sl = cdiv(S, CL);
  const int Sl4 = cdiv(Sl, 4) * 4, Sl16 = cdiv(Sl, 16) * 16, Dk8 = cdiv(Dk, 8) * 8;
  BwdLayout l;
  size_t o = 0;
  l.wr = o;   o += wr ? sfl((size_t)nrmax * row_stride(H), es) : 0;
  l.dctx = o; o += E;  // on 16 bytes: row_stride is a multiple of 16 floats
  l.dks = o;  o += dkres ? (size_t)Sl * Dk : 0;
  l.ks = o;   o += kres ? sfl((size_t)Sl * Dk, es) : 0;
  l.vs = o;   o += vres ? sfl((size_t)Sl * E, es) : 0;
  l.es = o;   o += esres ? (size_t)Sl * Dk : 0;
  l.attp = o; o += S + 2 * APAD;
  l.attt = o; o += Sl;
  l.base = o; o += Sl;
  l.den = o;  o += Sl;
  l.dnx = o;  o += Sl;
  l.fs = o;   o += (size_t)Sl16 * kps_of(K);
  l.dfo = o;  o += (size_t)Sl * K;
  l.dfa = o;  o += dfares ? (size_t)(S + 2 * APAD) * K : 0;
  l.ctx = o;  o += E;
  l.dqp = o;  o += Dk;
  l.qb = o;   o += Dk8;
  l.lv = o;   o += Dk8;
  l.wl = o;   o += (size_t)K * wls_of(Dk);
  l.dwl = o;  o += (size_t)K * Dk;
  l.datt = o; o += (size_t)NS * Sl;
  l.p2s = o;  o += NS;
  l.dhl = o;  o += (size_t)B * numax;
  l.dcc = o;  o += (size_t)B * numax;
  l.gdot = o; o += (size_t)B * numax;
  l.red = o;  o += NW;
  l.ord = o;  o += B;
  l.tp = o;   o += (size_t)K * P;
  l.cpart = o; o += (size_t)conv_parts(Sl, K) * Sl4 * K;
  l.tpart = o; o += 4 * 32 * 8;
  l.total = o;
  return l;
}

template <typename S_>
__global__ void __launch_bounds__(NT) decoder_scan_bwd_kernel(const BwdArgs<S_> a) {
  cg::cluster_group cluster = cg::this_cluster();
  cg::grid_group grid = cg::this_grid();
  const int rank = (int)cluster.block_rank();
  const int B = a.B, S = a.S, Dk = a.Dk, E = a.E, K = a.K, P = a.P, H = a.H, Emb = a.Emb,
            V = a.V, L = a.L, G = a.G, CL = a.CL, NS = a.NS;
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
  const int Sl = cdiv(S, CL);
  const int Dkc = cdiv(Dk, CL), d0 = rank * Dkc, ndk = max(0, min(Dkc, Dk - d0));

  extern __shared__ float smem[];
  const BwdLayout ly = bwd_layout(B, S, Dk, E, K, P, H, G, CL, NS, a.es_smem, a.dfa_smem, a.wr_smem,
                                  a.dk_smem, a.k_smem, a.v_smem, sizeof(S_));
  const int Sl4 = cdiv(Sl, 4) * 4, Dk8 = cdiv(Dk, 8) * 8;
  const int nsp = conv_parts(Sl, K);
  const int SA = S + 2 * APAD, KPS = kps_of(K), WLS = wls_of(Dk);
  const int WRS = row_stride(H);
  float* own = a.scratch + (long)j * ((long)Sl * Dk + (long)SA * K);  // this block's scratch
  S_* wr = reinterpret_cast<S_*>(smem + ly.wr);  // [nr][WRS] rows of Wx[Emb:] and Wh (row_stride)
  float* dks = smem + ly.dks;    // [Sl][Dk]  dk of slot 0's own frames
  S_* ks = reinterpret_cast<S_*>(smem + ly.ks);  // [Sl][Dk]  slot 0's own frames of k
  S_* vs = reinterpret_cast<S_*>(smem + ly.vs);  // [Sl][E]   and of v
  float* es = a.es_smem ? smem + ly.es : own;  // [Sl][Dk]  the rebuilt tanh energies
  float* attp = smem + ly.attp + APAD;  // [S] alignment of step t-1, APAD zeros on each side
  float* attt = smem + ly.attt;  // [Sl]      alignment of step t, own frames
  float* base = smem + ly.base;  // [Sl]      dalign_up + dalign_carry
  float* den = smem + ly.den;    // [Sl]      denergy
  float* dnx = smem + ly.dnx;    // [Sl]      dalign_up of step t-1, own frames
  float* fs = smem + ly.fs;      // [Sl16][KPS] location features (zeros past nv and K)
  float* dfo = smem + ly.dfo;    // [Sl][K]   dfpre of the own frames
  // [S][K] dfpre of all frames, zero outside [0, len) with APAD zero rows on each side
  float* dfa = (a.dfa_smem ? smem + ly.dfa : own + (long)Sl * Dk) + APAD * K;
  float* dctx = smem + ly.dctx;  // [E]
  float* ctx = smem + ly.ctx;    // [E]
  float* dqp = smem + ly.dqp;    // [Dk]      dq over the own frames
  float* qb = smem + ly.qb;      // [Dk8]     q + locb (zeros past Dk)
  float* lv = smem + ly.lv;      // [Dk8]     locv (zeros past Dk)
  float* wl = smem + ly.wl;      // [K][WLS]  Wlp (zeros past Dk)
  float* dwl = smem + ly.dwl;    // [K][Dk]   dWlp partial of this block
  float* datt = smem + ly.datt;  // [NS][Sl]  dalign_carry, own frames
  float* p2s = smem + ly.p2s;    // [NS]      own share of <dalign_up + carry, align>
  float* dhl = smem + ly.dhl;    // [B][numax] dh_lstm of the own units
  float* dcc = smem + ly.dcc;    // [B][numax] dc carry of the own units
  float* gdot = smem + ly.gdot;  // [B][numax] dlogits Wout^T + dq Wq^T of the own units
  float* red = smem + ly.red;    // [NW]
  int* ord = (int*)(smem + ly.ord);  // [B]
  float* tp = smem + ly.tp;          // [K][P]    conv taps
  float* cpart = smem + ly.cpart;    // [nsp][Sl4][K] parts of the conv sums
  float* tpart = smem + ly.tpart;    // [4][32][8] four warps' partial tiles

  // ---- once per launch
  for (int i = tid; i < K * Dk; i += NT) dwl[i] = 0.0f;
  for (int i = tid; i < K * WLS; i += NT) wl[i] = i % WLS < Dk ? ldf(a.wlp + (i / WLS) * Dk + i % WLS) : 0.0f;
  for (int i = tid; i < Dk8; i += NT) {
    lv[i] = i < Dk ? ldf(a.locv + i) : 0.0f;
    qb[i] = 0.0f;
  }
  for (int i = tid; i < APAD; i += NT) {
    attp[-APAD + i] = 0.0f;
    attp[S + i] = 0.0f;
  }
  for (int i = tid; i < APAD * K; i += NT) dfa[-APAD * K + i] = 0.0f;
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
  __syncthreads();
  for (int i = 0; i < NS; ++i) {
    const int b = slot_utterance(ord, B, G, c, i);
    if (b < 0) continue;
    const int len = min(max(a.enc_len[b], 0), S);
    const int Sb = cdiv(max(len, 1), CL), s0 = rank * Sb, nv = max(0, min(Sb, len - s0));
    for (int x = tid; x < Sl; x += NT) datt[i * Sl + x] = 0.0f;
    float* dkg = a.dk + (long)b * S * Dk;
    // frames past the length: zero, split statically over the blocks
    for (long x = (long)max(len, rank * Sl) * Dk + tid; x < (long)min(S, (rank + 1) * Sl) * Dk; x += NT)
      dkg[x] = 0.0f;
    if (i == 0 && a.dk_smem) {
      for (int x = tid; x < Sl * Dk; x += NT) dks[x] = 0.0f;
    } else {
      for (int x = tid; x < nv * Dk; x += NT) dkg[(long)s0 * Dk + x] = 0.0f;
    }
    if (i == 0) {
      if (a.k_smem)
        for (int x = tid; x < nv * Dk; x += NT) ks[x] = a.k[((long)b * S + s0) * Dk + x];
      if (a.v_smem)
        for (int x = tid; x < nv * E; x += NT) vs[x] = a.v[((long)b * S + s0) * E + x];
    }
    // the own share of <dalign_up, align> of the last step run (no carry yet)
    const long row = (long)(n - 1) * B + b;
    float p2 = 0.0f;
    for (int sl = tid; sl < nv && n > 0; sl += NT)
      p2 = fmaf(ldf(a.dalign + row * S + s0 + sl), ldf(a.align + row * S + s0 + sl), p2);
    p2 = block_sum(p2, red);
    if (tid == 0) p2s[i] = p2;
  }
  float dloc = 0.0f;  // dlocv of attention unit tid
  __syncthreads();
  cluster.sync();

  for (int t = n - 1; t >= 0; --t) {
    PHASE(t, 0);
    // ---- gate stage: dh, dc, dgates of the own units, every utterance.
    // First dlogits Wout^T + dq Wq^T of the units, one warp per utterance,
    // UCH units at once; then one thread per (utterance, unit), whose
    // stored activations, c and dhidden are loaded first, in the background,
    // for a thread's first (utterance, unit)
    const bool dq4 = Dk % 4 == 0 && ((uintptr_t)a.dq & 15) == 0 && ((uintptr_t)a.wq & (4 * sizeof(S_) - 1)) == 0;
    float pf[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (nu > 0 && tid < B * nu) {
      const int u = u0 + tid % nu;
      const long row = (long)t * B + tid / nu;
#pragma unroll
      for (int g = 0; g < 4; ++g) pf[g] = a.acts[row * G4 + g * H + u];
      pf[4] = ldf(a.cseq + row * H + u);
      pf[5] = t > 0 ? ldf(a.cseq + (row - B) * H + u) : 0.0f;
      pf[6] = ldf(a.dhidden + row * H + u);
    }
    for (int b = wid; b < B && nu > 0; b += NW) {
      const long row = (long)t * B + b;
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
        if (t + 1 < n && dq4) {  // rows of dq and Wq on 16 bytes: 16-byte loads, dq's all in flight
          float4 xs[NT / 128];
#pragma unroll
          for (int r = 0; r < NT / 128; ++r) {
            const int d = 4 * lane + 128 * r;
            xs[r] = d < Dk ? __ldcg(reinterpret_cast<const float4*>(a.dq + (row + B) * Dk + d))
                           : make_float4(0, 0, 0, 0);
          }
#pragma unroll
          for (int r = 0; r < NT / 128; ++r) {
            const int d = 4 * lane + 128 * r;
            if (d >= Dk) break;
            const float4 x = xs[r];
#pragma unroll
            for (int q = 0; q < UCH; ++q) {
              if (j0 + q < nu) {
                const float4 w = ld4g(a.wq + (long)(u0 + j0 + q) * Dk + d);
                acc[q] = fmaf(x.x, w.x, acc[q]);
                acc[q] = fmaf(x.y, w.y, acc[q]);
                acc[q] = fmaf(x.z, w.z, acc[q]);
                acc[q] = fmaf(x.w, w.w, acc[q]);
              }
            }
          }
        } else if (t + 1 < n) {
#pragma unroll 4
          for (int d = lane; d < Dk; d += 32) {
            const float x = __ldcg(a.dq + (row + B) * Dk + d);
#pragma unroll
            for (int q = 0; q < UCH; ++q)
              if (j0 + q < nu) acc[q] = fmaf(x, ldgf(a.wq + (long)(u0 + j0 + q) * Dk + d), acc[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < UCH; ++q) {
          const float tot = warp_sum(acc[q]);
          if (lane == 0 && j0 + q < nu) gdot[b * numax + j0 + q] = tot;
        }
      }
    }
    __syncthreads();
    for (int x = tid; x < B * nu; x += NT) {
      const int b = x / nu, jj = x % nu, u = u0 + jj;
      const long row = (long)t * B + b;
      float v[7];
      if (x == tid) {
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
    PHASE(t, 1);  // gate stage
    grid.sync();  // the dgates of every utterance are in global memory
    PHASE(t, 2);  // grid barrier 1

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
    PHASE(t, 3);  // row stage
    grid.sync();  // dctx of every utterance is in global memory
    PHASE(t, 4);  // grid barrier 2

    // ---- attention part, each slot
    for (int i = 0; i < NS; ++i) {
      const int b = slot_utterance(ord, B, G, c, i);
      if (b < 0) continue;
      const long row = (long)t * B + b;
      const int len = min(max(a.enc_len[b], 0), S);
      const int Sb = cdiv(max(len, 1), CL), s0 = rank * Sb, nv = max(0, min(Sb, len - s0));
      const float uni = rnd<S_>(len > 0 ? 1.0f / (float)len : 0.0f);
      // k of the own frames into es in the background, where k is not resident
      const bool kres = i == 0 && a.k_smem, kpref = !kres && a.es_smem && sizeof(S_) == 4;
      if (kpref) {
        const float* kg = reinterpret_cast<const float*>(a.k) + ((long)b * S + s0) * Dk;
        const int n4 = ((uintptr_t)kg & 15) == 0 && ((uintptr_t)es & 15) == 0 ? nv * Dk / 4 : 0;
        for (int x = tid; x < n4; x += NT) cp_async16(es + 4 * x, kg + 4 * x);
        for (int x = 4 * n4 + tid; x < nv * Dk; x += NT) cp_async4(es + x, kg + x);
      }
      for (int s = tid; s < S; s += NT) attp[s] = t > 0 ? ldf(a.align + (row - B) * S + s) : (s < len ? uni : 0.0f);
      for (int sl = tid; sl < nv; sl += NT) {
        attt[sl] = ldf(a.align + row * S + s0 + sl);
        base[sl] = ldf(a.dalign + row * S + s0 + sl) + datt[i * Sl + sl];
        dnx[sl] = t > 0 ? ldf(a.dalign + (row - B) * S + s0 + sl) : 0.0f;
      }
      for (int d = tid; d < Dk; d += NT) qb[d] = a.qs[row * Dk + d] + ldf(a.locb + d);
      float sdot = 0.0f;
      for (int e = tid; e < E; e += NT) {
        const float dce = __ldcg(a.dctxg + (long)b * E + e), ce = a.ctxs[row * E + e];
        dctx[e] = dce;
        ctx[e] = ce;
        sdot = fmaf(dce, ce, sdot);
      }
      sdot = block_sum(sdot, red);  // its barriers publish the loads
      // every block's share p2s (written before the last grid barrier, and
      // rewritten only after the cluster barrier below) is readable
      __syncthreads();
      if (tid < CL) red[NW - CLMAX + tid] = *cluster.map_shared_rank(p2s + i, tid);
      __syncthreads();
      for (int q = 0; q < CL; ++q) sdot += red[NW - CLMAX + q];
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
            const float4 c = *reinterpret_cast<const float4*>(dctx + e);
            const float4 x = ld4(vr1 + e);
            const float4 y = two ? ld4(vr2 + e) : make_float4(0, 0, 0, 0);
            acc1 = fmaf(c.x, x.x, acc1);
            acc1 = fmaf(c.y, x.y, acc1);
            acc1 = fmaf(c.z, x.z, acc1);
            acc1 = fmaf(c.w, x.w, acc1);
            acc2 = fmaf(c.x, y.x, acc2);
            acc2 = fmaf(c.y, y.y, acc2);
            acc2 = fmaf(c.z, y.z, acc2);
            acc2 = fmaf(c.w, y.w, acc2);
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
      PHASE(t, 5);  // loads and the softmax term
      // location features of step t-1's alignment: threads over (4 frames,
      // filter, part of the taps), the 4 frames' alignment values slid
      // through registers (attp is zero outside [0, len), APAD zeros around)
      for (int x = tid; x < nsp * cdiv(nv, 4) * K; x += NT) {
        const int part = x % nsp, pr = x / nsp, kk = pr % K, sl = 4 * (pr / K), s = s0 + sl;
        const int p0 = max(0, half - s - 3), p1 = min(P, len + half - s), pc = cdiv(p1 - p0, nsp);
        const int pa = p0 + part * pc, pb = min(p1, pa + pc);
        const float* tk = tp + kk * P;
        const float* w = attp + s - half;  // w[p + j] = alignment at frame s + j + p - half
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
      PHASE(t, 6);  // conv
      // the tanh energies, rebuilt once: fW = f Wlp on the tensor cores
      // ([16 frames, K] x [K, 8 units] tiles), then e = tanh(k + q + fW) for
      // each (frame, unit) of a tile in its lanes' registers; es = e, dk +=
      // de. A warp keeps one frame tile and walks its units, k of NTPF tiles
      // loaded at once
      const bool dkres = i == 0 && a.dk_smem;
      float* dkg = a.dk + ((long)b * S + s0) * Dk;
      const int g8 = lane >> 2, tig = lane & 3;
      {
        const int nt = cdiv(Dk, 8);
        const int wpm = max(1, NW / max(mt, 1)), mg = NW / wpm;  // warps a frame tile, tiles at once
        const S_* kp = kres ? ks : kpref ? reinterpret_cast<const S_*>(es) : a.k + ((long)b * S + s0) * Dk;
        const bool k2 = Dk % 2 == 0 && ((uintptr_t)kp & (2 * sizeof(S_) - 1)) == 0;
        float* dkp = dkres ? dks : dkg;
        for (int mi = wid / wpm; wid < mg * wpm && mi < mt; mi += mg) {
          const int ra = mi * 16 + g8, rb = ra + 8;
          const bool va = ra < nv, vb = rb < nv;
          const float* fa = fs + ra * KPS;
          const float* fb = fs + rb * KPS;
          const float dna = va ? den[ra] : 0.0f, dnb = vb ? den[rb] : 0.0f;
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
                  dkp[x] += (e < 2 ? dna : dnb) * lv[dd] * (1.0f - ev * ev);
                }
              }
            }
          }
        }
      }
      __syncthreads();
      PHASE(t, 7);  // energies
      // dq and dlocv over the own frames: one thread per attention unit; es
      // turns from e into de in place
      for (int d = tid; d < Dk; d += NT) {
        const float lvd = lv[d];
        float dqa = 0.0f, dl = 0.0f;
#pragma unroll 4
        for (int sl = 0; sl < nv; ++sl) {
          const float e = es[sl * Dk + d], g = den[sl];
          const float de = g * lvd * (1.0f - e * e);
          es[sl * Dk + d] = de;
          dqa += de;
          dl = fmaf(e, g, dl);
        }
        dqp[d] = dqa;
        dloc += dl;
      }
      __syncthreads();
      PHASE(t, 8);  // reductions over the frames
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
              if (sl < nv && kk < K) {
                dfo[sl * K + kk] = dacc[e];
                a.dfpre[(row * S + s0 + sl) * K + kk] = dacc[e];
              }
            }
          }
        }
      }
      // frames past the length: zero, split statically over the blocks
      for (int x = max(len, rank * Sl) * K + tid; x < min(S, (rank + 1) * Sl) * K; x += NT)
        a.dfpre[row * S * K + x] = 0.0f;
      PHASE(t, 9);  // dfpre
      cluster.sync();  // dq partials and dfpre of all frames are readable
      PHASE(t, 10);  // cluster barrier
      for (int d = d0 + tid; d < d0 + ndk; d += NT) {
        float pv[CLMAX];  // the blocks' partials, all loads in flight
#pragma unroll
        for (int q = 0; q < CLMAX; ++q) pv[q] = q < CL ? *cluster.map_shared_rank(dqp + d, q) : 0.0f;
        float acc = 0.0f;
#pragma unroll
        for (int q = 0; q < CLMAX; ++q) acc += pv[q];
        a.dq[row * Dk + d] = acc;
      }
      for (int x = tid; x < len * K; x += NT) {
        const int s = x / K, q = s / Sb;
        dfa[x] = *cluster.map_shared_rank(dfo + (s - q * Sb) * K + x % K, q);
      }
      for (int x = tid; x < APAD * K; x += NT) dfa[len * K + x] = 0.0f;
      __syncthreads();
      // dalign_carry[jf] = sum_kk sum_p dfpre[jf + half - p, kk] taps[kk, p]:
      // threads over (4 own frames, filter, part of the taps), the 4 frames'
      // dfpre values slid through registers
      for (int x = tid; x < nsp * cdiv(nv, 4) * K; x += NT) {
        const int part = x % nsp, pr = x / nsp, kk = pr % K, sl = 4 * (pr / K), jf = s0 + sl;
        const int p0 = max(0, jf + half - len + 1), p1 = min(P, jf + half + 4), pc = cdiv(p1 - p0, nsp);
        const int pa = p0 + part * pc, pb = min(p1, pa + pc);
        const float* tk = tp + kk * P;
        const float* dcol = dfa + (jf + half) * K + kk;  // dcol[(j - p) K] = dfpre at frame jf + j + half - p
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
      __syncthreads();
      for (int sl = wid; sl < Sl; sl += NW) {  // one warp a frame: the sum over filters and parts
        float acc = 0.0f;
        if (sl < nv)
          for (int y = lane; y < nsp * K; y += 32) acc += cpart[((y / K) * Sl4 + sl) * K + y % K];
        acc = warp_sum(acc);
        if (lane == 0) datt[i * Sl + sl] = acc;
      }
      __syncthreads();
      // the own share of <dalign_up + carry, align> of step t-1
      if (t > 0) {
        float p2 = 0.0f;
        for (int sl = tid; sl < nv; sl += NT) {
          p2 = fmaf(dnx[sl] + datt[i * Sl + sl], attp[s0 + sl], p2);
        }
        p2 = block_sum(p2, red);
        if (tid == 0) p2s[i] = p2;
      }
      PHASE(t, 11);  // pulls, transposed conv
    }
    grid.sync();  // dq of every utterance is in global memory
    PHASE(t, 12);  // grid barrier 3
  }

  for (int i = 0; i < NS; ++i) {
    const int b = slot_utterance(ord, B, G, c, i);
    if (b < 0 || i != 0 || !a.dk_smem) continue;
    const int len = min(max(a.enc_len[b], 0), S);
    const int Sb = cdiv(max(len, 1), CL), s0 = rank * Sb, nv = max(0, min(Sb, len - s0));
    float* out = a.dk + ((long)b * S + s0) * Dk;
    for (int x = tid; x < nv * Dk; x += NT) out[x] = dks[x];
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
// exceed SMEM_MAX; out[1..6] = the flags es_smem, dfa_smem, wr_smem,
// dk_smem, k_smem, v_smem of e2e_decoder_scan_bwd, each resident taken in
// that order while the block's total stays within SMEM_MAX; out[7] = the
// floats of scratch a block needs (0 when es and dfa are both resident);
// dt: the storage type (0 float, 1 bf16), in which the residents are held.
extern "C" int e2e_decoder_scan_bwd_plan(int B, int S, int Dk, int E, int K, int P, int H, int G,
                                         int CL, int dt, int* out, void* stream) {
  (void)stream;
  if (B < 1 || S < 1 || G < 1 || CL < 1 || CL > CLMAX || dt < 0 || dt > 1) return (int)cudaErrorInvalidValue;
  const int NS = cdiv(B, G), es = dt ? 2 : 4;
  int f[6] = {0, 0, 0, 0, 0, 0};  // es, dfa, wr, dk, k, v
  auto bytes = [&]() {
    return sizeof(float) * bwd_layout(B, S, Dk, E, K, P, H, G, CL, NS, f[0], f[1], f[2], f[3], f[4], f[5], es).total;
  };
  out[0] = -1;
  if (bytes() > SMEM_MAX) return 0;
  for (int i = 0; i < 6; ++i) {
    f[i] = 1;
    if (bytes() > SMEM_MAX) f[i] = 0;
    out[1 + i] = f[i];
  }
  out[0] = (int)bytes();
  out[7] = f[0] && f[1] ? 0 : cdiv(S, CL) * Dk + (S + 2 * APAD) * K;
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
// dwlp_part [G CL, K, Dk], dlocv_part [G CL, Dk]; scratch dctxg [B, E] and
// scratch [G CL, ceil(S / CL) Dk + S K]. The inputs of storage type dt (0
// float, 1 bf16) but acts, qs and ctxs; those and every output float, all
// contiguous. H a multiple of 8 up to 512, Dk up to 512, P odd. G clusters
// of CL blocks (all resident: the cooperative launch fails otherwise); the
// flags say what lives in shared memory.
extern "C" int e2e_decoder_scan_bwd(
    const void* k, const void* v, const int* enc_len, const void* taps, const void* wq,
    const void* wlp, const void* locv, const void* locb, const void* wx, const void* wh,
    const void* wout, const void* align, const void* cseq, const float* acts, const float* qs,
    const float* ctxs, const void* dlogits, const void* dalign, const void* dhidden,
    float* dgates, float* dq, float* dfpre, float* dk, float* dwlp_part, float* dlocv_part,
    float* dctxg, float* scratch, int B, int S, int Dk, int E, int K, int P, int H, int Emb, int V,
    int L, float inv_temp, const int* steps, int G, int CL, int es_smem, int dfa_smem, int wr_smem,
    int dk_smem, int k_smem, int v_smem, int dt, void* stream) {
  if (H % 8 != 0 || H > 512 || Dk > NT || P % 2 != 1 || B < 1 || S < 1 || L < 1 || V < 1 || G < 1 ||
      CL < 1 || CL > CLMAX || dt < 0 || dt > 1)
    return (int)cudaErrorInvalidValue;
  const int NS = cdiv(B, G);
  const BwdLayout ly = bwd_layout(B, S, Dk, E, K, P, H, G, CL, NS, es_smem, dfa_smem, wr_smem, dk_smem,
                                  k_smem, v_smem, dt ? 2 : 4);
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
                 dk, dwlp_part, dlocv_part, dctxg, scratch,
                 B, S, Dk, E, K, P, H, Emb, V, L, inv_temp, steps, G, CL, NS, es_smem, dfa_smem, wr_smem,
                 dk_smem, k_smem, v_smem};
    return cudaLaunchKernelEx(&cfg, decoder_scan_bwd_kernel<T>, a);
  };
  return (int)(dt ? run(bf16{}) : run(0.0f));
}
