// The fused speller scan, forward: all L teacher-forced / scheduled-sampling
// decoder steps of a batch in one launch, or its first n (``steps``, read
// from device memory: a training step's longest label, past which the loss
// reads nothing), the outputs of the steps after them written as zeros.
//
// Replaces the forward of the TPU kernel e2e_asr_tpu/ops/decoder_pallas.py
// decoder_scan_fused (_fwd_call / _fwd_kernel). Per step t and utterance b:
//   token  = teacher[t, b] where use_teacher[t], else the prediction fed back
//            from step t-1 (<sos> = 0 at t = 0)
//   q      = h Wq + bq
//   f[s]   = sum_p align_prev[s + p - (P-1)/2] taps[:, p]        (SAME conv)
//   energy = locv . tanh(k[b, s] + q + f[s] Wlp + locb), masked past enc_len
//   align  = softmax(energy / temp), exactly 0 past enc_len
//   ctx    = align @ v[b]
//   gates  = [embed[token], ctx] Wx + h Wh + bl  (i, f, g, o) -> c', h'
//   logits = h' Wout + bout; prediction = argmax(logits [+ Gumbel noise])
// from h = c = 0 and the uniform alignment over the valid frames. It writes
// logits, align, hidden and, for the backward, c, the token fed, the gate
// activations, q and ctx of every step. Unlike the TPU kernel it reads the
// conv taps directly (no [K, S, S] Toeplitz bank), gathers the embedding
// row's product by token id (no one-hot product) and pads nothing.
//
// What bounds it on the H100: latency. L dependent steps, each a chain of
// dependent phases; one step of one utterance is ~2.3 M FMAs, and the
// scan's inputs and outputs are a few tens of MB, so neither the FLOP nor
// the HBM bound is near. Split into phases (the timing build below), the
// first design (one 8-block cluster per utterance) spent half of each step
// streaming the cell's weights (Wx, Wh: 6.5 MB at the flagship) from L2 once
// per utterance, and ran B = 16 utterances in two waves: at most 15 such
// clusters are resident on a 132-SM H100. With the weights resident, what
// the gate product waits for is its inputs: every block pulls all
// utterances' [ctx, h] from L2 after a grid barrier (61 KB a step at the
// flagship), which 4-byte loads moved slowly (bound by the requests a block
// keeps in flight), so they are loaded 16 bytes at a time.
// Design: a persistent grid of G co-resident clusters of CL blocks
// (cooperative launch; the wrapper picks CL and G from
// cudaOccupancyMaxActiveClusters, e.g. 17 clusters of 6 for B = 16).
//   - The cell's weights are split by hidden unit over all G CL blocks, a
//     unit's four gate columns in one block, and copied into shared memory
//     once per launch; each step's gate product is [16 utterances, E + H] x
//     [E + H, 8 columns] tiles on the tensor cores (mma m16n8k8, three TF32
//     products a tile for float32 accuracy) over chunks of 16 input
//     features, a lane's four inputs and weights of a chunk each one 16-byte
//     load (the k index permuted within the chunk to match), its inputs (ctx
//     of step t, h of step t-1) read from L2, all utterances at once. The
//     embedding row's part is a gather from ew = embed Wx[:Emb] + bl, which
//     each block computes for its own columns before the first step.
//   - A cluster walks one or more utterances (slots) for the attention part;
//     utterances are ranked by length and dealt to clusters in a snake order
//     so that a cluster with two gets two short ones, and an utterance's
//     valid frames are split evenly over the cluster's blocks.
//   - Per step: phase A (each slot: q pulled from the blocks' slices, the
//     token, the location conv over 4-frame windows held in registers, f
//     Wlp on the tensor cores and the tanh energies, a warp walking the
//     units of one 16-frame tile, a local softmax and an unnormalised
//     partial context); cluster barrier; phase B (each slot: the blocks'
//     partials pulled through distributed shared memory; each block writes
//     its slice of the context to global memory); grid barrier; the gate
//     product and cell update of the block's units for every utterance;
//     grid barrier; phase C (each slot: h' read back, this block's
//     vocabulary slice of the logits and its local argmax, its slice of the
//     next q); cluster barrier. Partials are pulled, not pushed.
// A block's frames of k and v (first slot), its Wq columns and Wout columns
// stay in shared memory where they fit (e2e_decoder_scan_fwd_plan decides,
// in order: gate weights, v, Wq, Wout, k) and are read from L2 otherwise;
// S is bounded only by the per-frame buffers (about 6,000 frames at the
// flagship widths on 8-block clusters). No atomics: every sum has a fixed order.
//
// Storage types (csrc/bf16.cuh): the kernel is a template on the storage
// type S (float or bf16) of k, v, the weights and the outputs logits, align,
// hidden and c; acts, q, ctx and the scratch stay float. The bf16 variant
// rounds where the TPU kernel rounds at bfloat16: all arithmetic in float32
// from the widened inputs; h, c and the alignment carried rounded to bf16
// (so are the stored ones, and the uniform initial alignment); h' and the
// logits from the unrounded c' and h' (h' kept in the hf scratch for phase
// C), the next q from the rounded h'; the context from the unrounded
// alignment; the location features in float32. Its residents (gate weights,
// Wq, Wout, k, v) are held in bf16, half the shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "tf32_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CLMAX = 8;  // blocks per cluster, at most (the portable cluster size)
constexpr int NSPL = 4;   // threads a conv sum is split over, at most
constexpr int APAD = 4;   // zeros on each side of a stored alignment (the conv's 4-frame windows)
constexpr int KPF = 4;    // 16-column chunks of gate-product inputs a warp loads at once
constexpr int NTPF = 8;   // energy tiles whose k a lane loads at once
constexpr int NT = 512;   // threads per block
constexpr int NW = NT / 32;
constexpr float LOWEST = -3.402823466e38f;  // -FLT_MAX
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

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// reduce over the block; red has NW slots; every thread gets the result
template <bool IS_MAX>
__device__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  x = IS_MAX ? warp_max(x) : warp_sum(x);
  __syncthreads();
  if (lane == 0) red[wid] = x;
  __syncthreads();
  float y = lane < NW ? red[lane] : (IS_MAX ? LOWEST : 0.0f);
  return IS_MAX ? warp_max(y) : warp_sum(y);
}

// Philox-4x32-10: first word of the block of counter (c0, c1, c2, 0)
__device__ __forceinline__ uint32_t philox(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t k0,
                                           uint32_t k1) {
  uint32_t c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// Gumbel noise of (seed, step, utterance, vocabulary column): a pure function
// of its key, shared by the scan and by the buffer-filling kernel. The
// utterance is the row of the global batch (row0 + the local row under data
// parallelism), so that a rank's rows draw what a world of one draws for them
__device__ __forceinline__ float gumbel(uint32_t seed_lo, uint32_t seed_hi, int t, int b, int col) {
  const uint32_t bits = philox((uint32_t)t, (uint32_t)b, (uint32_t)col, seed_lo, seed_hi);
  const float u = (float)(bits >> 8) * (1.0f / 16777216.0f) + 1e-12f;
  return -logf(-logf(u));
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

// hidden units [u0, u0 + nu) of block j of nb (the first H % nb blocks own one more)
__host__ __device__ inline void unit_range(int H, int nb, int j, int& u0, int& nu) {
  const int base = H / nb, rem = H % nb;
  nu = base + (j < rem ? 1 : 0);
  u0 = j * base + (j < rem ? j : rem);
}

// utterances ranked by length, longest first (ties: lower index first), into
// ord[B]; slot i of cluster c takes rank i G + c (i even) or i G + G-1-c (odd)
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

__device__ __forceinline__ int slot_utterance(const int* ord, int B, int G, int c, int i) {
  const int idx = i * G + ((i & 1) ? G - 1 - c : c);
  return idx < B ? ord[idx] : -1;
}

template <typename ST>
struct FwdArgs {
  const ST *k, *v;
  const int* enc_len;
  const ST *taps, *wq, *bq, *wlp, *locv, *locb, *embed, *wx, *wh, *bl, *wout, *bout;
  const int *teacher, *use_teacher;
  ST *logits, *align, *hidden, *cseq;
  int* tokens;
  float *acts, *qs, *ctxs;
  float* ew;  // scratch [V, 4H]: embed Wx[:Emb] + bl, each block its own columns
  float* hf;  // scratch [B, H]: h' of the step unrounded (bf16; hidden itself at float)
  int B, S, Dk, E, K, P, H, Emb, V, L;
  float inv_temp;
  int sample;
  int row0;  // the global batch's row of utterance 0 (the Gumbel noise's key)
  const long long* seed;  // [1] in device memory, read at each step (null without sampling)
  // the steps run, n = min(max(*steps, 0), L) (null: L), read once at entry;
  // rows n .. L-1 of every output are written as zeros
  const int* steps;
  // a tracer's device counter [bank, count a bank] (null: none): n is added
  // to the count of the bank it holds, once a launch
  long long* steps_run;
  int G, CL, NS;  // clusters, blocks per cluster, utterance slots per cluster
  // residents in shared memory: gate weights, Wq columns, Wout columns, and
  // the first slot's frames of k and of v
  int w_smem, wq_smem, wo_smem, k_smem, v_smem;
};

// row r of the gate product's input [ctx, h] of (step, utterance) ``row``:
// ctx of this step, then h of the step before (written by other blocks in
// this launch, so read through L2)
template <typename S>
__device__ __forceinline__ float gate_input(const FwdArgs<S>& a, long row, int r) {
  return r < a.E ? __ldcg(a.ctxs + row * a.E + r) : ldcgf(a.hidden + (row - a.B) * a.H + r - a.E);
}

// the block's gate weight (column cc, row r of [Wx[Emb:]; Wh]) from global
// memory, where the weights are not resident; column cc is gate cc / nu of
// unit u0 + cc % nu
template <typename S>
__device__ __forceinline__ float gate_weight(const FwdArgs<S>& a, int cc, int r, int nu, int u0) {
  const int gcol = (cc / nu) * a.H + u0 + cc % nu;
  return r < a.E ? ldgf(a.wx + (long)(a.Emb + r) * 4 * a.H + gcol)
                 : ldgf(a.wh + (long)(r - a.E) * 4 * a.H + gcol);
}

// floats of shared memory that n elements of es bytes take (a float each at
// es = 4)
__host__ __device__ inline size_t sfl(size_t n, int es) { return (n * es + 3) / 4; }

// resident gate weights: [4 numax][WST], column cc of the block at row cc,
// its E + H rows padded with zeros to WST = a multiple of 32, + 16 (a
// quarter warp's 16-byte loads free of bank conflicts)
__host__ __device__ inline int gate_stride(int E, int H) { return cdiv(E + H, 32) * 32 + 16; }

struct FwdLayout {
  size_t wt, wqs, wos, ks, vs, att, ctxp, en, stat, qsl, amx, aix, qb, lv, wl, fs, hs, lg, gpart, gsum,
      cst, red, sc, ord, tp, cpart, opart, epart, total;
};

// shared-memory layout of the forward kernel, in floats; es: bytes an
// element of the residents (the storage type)
__host__ __device__ inline FwdLayout fwd_layout(int B, int S, int Dk, int E, int K, int P, int H,
                                                 int V, int G, int CL, int NS, int w, int wq,
                                                 int wo, int kres, int vres, int es) {
  const int nb = G * CL, numax = cdiv(H, nb), ncmax = 4 * numax;
  const int Sl = cdiv(S, CL), Dkc = cdiv(Dk, CL), Vc = cdiv(V, CL);
  const int Sl4 = cdiv(Sl, 4) * 4, Sl16 = cdiv(Sl, 16) * 16, Dk8 = cdiv(Dk, 8) * 8;
  FwdLayout l;
  size_t o = 0;
  l.wt = o;   o += w ? sfl((size_t)ncmax * gate_stride(E, H), es) : 0;
  l.wqs = o;  o += wq ? sfl((size_t)Dkc * H, es) : 0;
  l.wos = o;  o += wo ? sfl((size_t)Vc * H, es) : 0;
  l.ks = o;   o += kres ? sfl((size_t)Sl * Dk, es) : 0;
  l.vs = o;   o += vres ? sfl((size_t)Sl * E, es) : 0;
  l.att = o;  o += (size_t)NS * (S + 2 * APAD);
  l.ctxp = o; o += (size_t)NS * E;
  l.en = o;   o += (size_t)NS * Sl;
  l.stat = o; o += 2 * (size_t)NS;
  l.qsl = o;  o += (size_t)NS * Dkc;
  l.amx = o;  o += NS;
  l.aix = o;  o += NS;
  l.qb = o;   o += Dk8;
  l.lv = o;   o += Dk8;
  l.wl = o;   o += (size_t)K * wls_of(Dk);
  l.fs = o;   o += (size_t)Sl16 * kps_of(K);
  l.hs = o;   o += H;
  l.lg = o;   o += Vc;
  l.gpart = o; o += 4 * 32 * 8;
  l.gsum = o; o += (size_t)B * ncmax;
  l.cst = o;  o += (size_t)B * numax;
  l.red = o;  o += NW;
  l.sc = o;   o += 3 * CLMAX;
  l.ord = o;  o += B;
  l.tp = o;   o += (size_t)K * P;
  l.cpart = o; o += (size_t)conv_parts(Sl, K) * Sl4 * K;
  l.opart = o; o += (size_t)(NT > Vc + Dkc ? NT : Vc + Dkc);
  l.epart = o; o += (size_t)NW * cdiv(Sl, 16) * 16;
  l.total = o;
  return l;
}

template <typename S_>
__global__ void __launch_bounds__(NT) decoder_scan_fwd_kernel(const FwdArgs<S_> a) {
  cg::cluster_group cluster = cg::this_cluster();
  cg::grid_group grid = cg::this_grid();
  const int rank = (int)cluster.block_rank();
  const int B = a.B, S = a.S, Dk = a.Dk, E = a.E, K = a.K, P = a.P, H = a.H, Emb = a.Emb,
            V = a.V, L = a.L, G = a.G, CL = a.CL, NS = a.NS;
  const int c = blockIdx.x / CL;  // cluster index
  const int j = blockIdx.x;       // block index in the grid
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int half = (P - 1) / 2;
  const int G4 = 4 * H, X = E + H;
  const int nb = G * CL, numax = cdiv(H, nb), ncmax = 4 * numax;
  int u0, nu;
  unit_range(H, nb, j, u0, nu);
  const int nc = 4 * nu;  // gate columns of this block: column cc is gate cc / nu of unit u0 + cc % nu
  const int Sl = cdiv(S, CL);  // frame capacity per block, and the static split of the outputs
  const int Dkc = cdiv(Dk, CL), d0 = rank * Dkc, ndk = max(0, min(Dkc, Dk - d0));
  const int Vc = cdiv(V, CL), v0 = rank * Vc, nvc = max(0, min(Vc, V - v0));
  const int Ec = cdiv(E, CL), e0 = rank * Ec, ne = max(0, min(Ec, E - e0));
  const int n = a.steps ? min(max(*a.steps, 0), L) : L;  // every block the same, before any barrier
  if (a.steps_run && j == 0 && tid == 0) a.steps_run[1 + (a.steps_run[0] != 0)] += n;

  extern __shared__ float smem[];
  const FwdLayout ly = fwd_layout(B, S, Dk, E, K, P, H, V, G, CL, NS, a.w_smem, a.wq_smem,
                                  a.wo_smem, a.k_smem, a.v_smem, sizeof(S_));
  S_* wt = reinterpret_cast<S_*>(smem + ly.wt);    // [ncmax][WST] gate weights, column-major (gate_stride)
  S_* wqs = reinterpret_cast<S_*>(smem + ly.wqs);  // [H][Dkc]     own columns of Wq
  S_* wos = reinterpret_cast<S_*>(smem + ly.wos);  // [H][Vc]      own columns of Wout
  S_* ks = reinterpret_cast<S_*>(smem + ly.ks);    // [Sl][Dk]     slot 0's own frames of k
  S_* vs = reinterpret_cast<S_*>(smem + ly.vs);    // [Sl][E]      and of v
  float* att = smem + ly.att;    // [NS][S + 2 APAD] alignment of the last step, zeros around it
  float* ctxp = smem + ly.ctxp;  // [NS][E]        unnormalised partial context
  float* en = smem + ly.en;      // [NS][Sl]       exp(energy - local max)
  float* stat = smem + ly.stat;  // [NS][2]        local max, sum
  float* qsl = smem + ly.qsl;    // [NS][Dkc]      own slice of q = h Wq + bq
  float* amx = smem + ly.amx;    // [NS]           local best score
  int* aix = (int*)(smem + ly.aix);  // [NS]       and its column
  float* qb = smem + ly.qb;      // [Dk8]          q + locb (zeros past Dk)
  float* lv = smem + ly.lv;      // [Dk8]          locv (zeros past Dk)
  float* wl = smem + ly.wl;      // [K][WLS]       Wlp (zeros past Dk)
  float* fs = smem + ly.fs;      // [Sl16][KPS]    location features (zeros past nv and K)
  float* hs = smem + ly.hs;      // [H]            h' of the slot's utterance
  float* lg = smem + ly.lg;      // [Vc]           scores of the own columns
  float* gpart = smem + ly.gpart;  // [4][32][8]   four warps' partial tiles
  float* gsum = smem + ly.gsum;    // [B][ncmax]   gate sums of every utterance
  float* cst = smem + ly.cst;    // [B][numax]     c of the own units
  float* red = smem + ly.red;    // [NW]
  float* sc = smem + ly.sc;      // [3][CLMAX]     partial maxima, sums, scales
  int* ord = (int*)(smem + ly.ord);  // [B]
  float* tp = smem + ly.tp;          // [K][P]         conv taps
  float* cpart = smem + ly.cpart;    // [nsp][Sl4][K] parts of the conv sums
  float* opart = smem + ly.opart;    // [NT]           partial sums of phase C
  float* epart = smem + ly.epart;    // [NW][Sl16]     the warps' partial energies
  const int Sl4 = cdiv(Sl, 4) * 4, Sl16 = cdiv(Sl, 16) * 16, Dk8 = cdiv(Dk, 8) * 8;
  const int nsp = conv_parts(Sl, K);
  const int SA = S + 2 * APAD, KPS = kps_of(K), WLS = wls_of(Dk);

  // ---- once per launch: residents, the embedding table's own columns
  for (int i = tid; i < K * WLS; i += NT) wl[i] = i % WLS < Dk ? ldf(a.wlp + (i / WLS) * Dk + i % WLS) : 0.0f;
  for (int i = tid; i < Dk8; i += NT) {
    lv[i] = i < Dk ? ldf(a.locv + i) : 0.0f;
    qb[i] = 0.0f;
  }
  for (int i = tid; i < K * P; i += NT) tp[i] = ldf(a.taps + i);
  for (int i = tid; i < B * numax; i += NT) cst[i] = 0.0f;
  const int WST = gate_stride(E, H);
  if (a.w_smem) {
    for (int i = tid; i < nc * WST; i += NT) {
      const int cc = i / WST, r = i % WST;
      const int gcol = (cc / nu) * H + u0 + cc % nu;
      stf(wt + i, r >= X ? 0.0f : r < E ? ldf(a.wx + (long)(Emb + r) * G4 + gcol) : ldf(a.wh + (long)(r - E) * G4 + gcol));
    }
  }
  if (a.wq_smem)
    for (int i = tid; i < ndk * H; i += NT) wqs[(i / ndk) * Dkc + i % ndk] = a.wq[(long)(i / ndk) * Dk + d0 + i % ndk];
  if (a.wo_smem)
    for (int i = tid; i < nvc * H; i += NT) wos[(i / nvc) * Vc + i % nvc] = a.wout[(long)(i / nvc) * V + v0 + i % nvc];
  for (int pr = wid; pr < V * nc; pr += NW) {  // ew[v, col] = bl[col] + embed[v] . Wx[:Emb, col]
    const int vv = pr / nc, cc = pr % nc;
    const int gcol = (cc / nu) * H + u0 + cc % nu;
    float acc = 0.0f;
    for (int m = lane; m < Emb; m += 32)
      acc = fmaf(ldf(a.embed + (long)vv * Emb + m), ldgf(a.wx + (long)m * G4 + gcol), acc);
    acc = warp_sum(acc);
    if (lane == 0) a.ew[(long)vv * G4 + gcol] = acc + ldf(a.bl + gcol);
  }
  rank_utterances(a.enc_len, B, S, ord);
  __syncthreads();
  for (int i = 0; i < NS; ++i) {
    const int b = slot_utterance(ord, B, G, c, i);
    if (b < 0) continue;
    const int len = min(max(a.enc_len[b], 0), S);
    const float uni = rnd<S_>(len > 0 ? 1.0f / (float)len : 0.0f);
    for (int x = tid; x < SA; x += NT) att[i * SA + x] = x >= APAD && x - APAD < len ? uni : 0.0f;
    for (int dl = tid; dl < ndk; dl += NT) qsl[i * Dkc + dl] = ldf(a.bq + d0 + dl);  // h = 0
    if (i == 0) {
      const int Sb = cdiv(max(len, 1), CL), s0 = rank * Sb, nv = max(0, min(Sb, len - s0));
      if (a.k_smem)
        for (int x = tid; x < nv * Dk; x += NT) ks[x] = a.k[((long)b * S + s0) * Dk + x];
      if (a.v_smem)
        for (int x = tid; x < nv * E; x += NT) vs[x] = a.v[((long)b * S + s0) * E + x];
    }
  }
  cluster.sync();  // every block's slices are set before any remote read

  for (int t = 0; t < n; ++t) {
    PHASE(t, 0);
    // ---- phase A, each slot: q, token, conv, energies, local softmax, partial context
    for (int i = 0; i < NS; ++i) {
      const int b = slot_utterance(ord, B, G, c, i);
      if (b < 0) continue;
      const long row = (long)t * B + b;
      const int len = min(max(a.enc_len[b], 0), S);
      const int Sb = cdiv(max(len, 1), CL), s0 = rank * Sb, nv = max(0, min(Sb, len - s0));
      const float* ap = att + i * SA + APAD;  // ap[s], zero for s in [-APAD, 0) and [len, S + APAD)
      for (int d = tid; d < Dk; d += NT) {
        const int q = d / Dkc;
        const float qv = *cluster.map_shared_rank(qsl + i * Dkc + d - q * Dkc, q);
        if (rank == 0) a.qs[row * Dk + d] = qv;
        qb[d] = qv + ldf(a.locb + d);
      }
      const bool fed = !a.use_teacher[t] && t > 0;
      if (fed && tid < CL) {  // the blocks' local argmaxes
        red[tid] = *cluster.map_shared_rank(amx + i, tid);
        red[CLMAX + tid] = __int_as_float(*cluster.map_shared_rank(aix + i, tid));
      }
      __syncthreads();
      if (tid == 0) {
        int tok;
        if (a.use_teacher[t]) {
          tok = a.teacher[row];
        } else if (t == 0) {
          tok = 0;
        } else {
          float best = red[0];
          tok = __float_as_int(red[CLMAX]);
          for (int q = 1; q < CL; ++q) {
            if (red[q] > best) {  // ties keep the lowest column
              best = red[q];
              tok = __float_as_int(red[CLMAX + q]);
            }
          }
        }
        tok = min(max(tok, 0), V - 1);
        if (rank == 0) a.tokens[row] = tok;
      }
      PHASE(t, 1);  // q pull and token
      // location features: threads over (4 frames, filter, part of the
      // taps), the 4 frames' alignment values slid through registers (the
      // stored alignment is zero outside [0, len), with APAD zeros around it)
      for (int x = tid; x < nsp * cdiv(nv, 4) * K; x += NT) {
        const int part = x % nsp, pr = x / nsp, kk = pr % K, sl = 4 * (pr / K), s = s0 + sl;
        const int p0 = max(0, half - s - 3), p1 = min(P, len + half - s), pc = cdiv(p1 - p0, nsp);
        const int pa = p0 + part * pc, pb = min(p1, pa + pc);
        const float* tk = tp + kk * P;
        const float* w = ap + s - half;  // w[p + j] = alignment at frame s + j + p - half
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
      PHASE(t, 2);  // conv
      // energies: fW = f Wlp on the tensor cores ([16 frames, K] x [K, 8
      // units] tiles), then locv . tanh(k + q + fW) for each (frame, unit) of
      // a tile in its lanes' registers. A warp keeps one frame tile and walks
      // its units, k of NTPF tiles loaded at once; its rows' sums go over the
      // tile's lanes, then in a fixed order over the warps
      {
        const int nt = cdiv(Dk, 8), g8 = lane >> 2, tig = lane & 3;
        const int wpm = max(1, NW / max(mt, 1)), mg = NW / wpm;  // warps a frame tile, tiles at once
        const S_* kp = i == 0 && a.k_smem ? ks : a.k + ((long)b * S + s0) * Dk;
        const bool k2 = Dk % 2 == 0 && ((uintptr_t)kp & (2 * sizeof(S_) - 1)) == 0;
        for (int x = tid; x < NW * Sl16; x += NT) epart[x] = 0.0f;
        __syncthreads();
        for (int mi = wid / wpm; wid < mg * wpm && mi < mt; mi += mg) {
          const int ra = mi * 16 + g8, rb = ra + 8;
          const bool va = ra < nv, vb = rb < nv;
          const float* fa = fs + ra * KPS;
          const float* fb = fs + rb * KPS;
          float r0 = 0.0f, r1 = 0.0f;  // rows ra and rb
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
              const float q0 = qb[d], q1 = qb[d + 1], l0 = lv[d], l1 = lv[d + 1];
              r0 = fmaf(l0, tanh_fast(kv[u][0] + q0 + dacc[0]), r0);
              r0 = fmaf(l1, tanh_fast(kv[u][1] + q1 + dacc[1]), r0);
              r1 = fmaf(l0, tanh_fast(kv[u][2] + q0 + dacc[2]), r1);
              r1 = fmaf(l1, tanh_fast(kv[u][3] + q1 + dacc[3]), r1);
            }
          }
          r0 += __shfl_xor_sync(0xffffffffu, r0, 1);
          r0 += __shfl_xor_sync(0xffffffffu, r0, 2);
          r1 += __shfl_xor_sync(0xffffffffu, r1, 1);
          r1 += __shfl_xor_sync(0xffffffffu, r1, 2);
          if (tig == 0) {
            epart[wid * Sl16 + ra] = r0;
            epart[wid * Sl16 + rb] = r1;
          }
        }
        __syncthreads();
        for (int sl = tid; sl < nv; sl += NT) {
          float acc = 0.0f;
          for (int w = 0; w < NW; ++w) acc += epart[w * Sl16 + sl];
          en[i * Sl + sl] = acc * a.inv_temp;
        }
      }
      __syncthreads();
      PHASE(t, 3);  // energies
      float m_b = LOWEST;
      for (int sl = tid; sl < nv; sl += NT) m_b = fmaxf(m_b, en[i * Sl + sl]);
      m_b = block_reduce<true>(m_b, red);
      float l_b = 0.0f;
      for (int sl = tid; sl < nv; sl += NT) {
        const float ex = expf(en[i * Sl + sl] - m_b);
        en[i * Sl + sl] = ex;
        l_b += ex;
      }
      l_b = block_reduce<false>(l_b, red);  // its barriers publish en
      if (tid == 0) {
        stat[2 * i] = m_b;
        stat[2 * i + 1] = l_b;
      }
      PHASE(t, 4);  // softmax
      const bool vres = i == 0 && a.v_smem;
      const S_* vb = vres ? vs : a.v + ((long)b * S + s0) * E;
      for (int e = tid; e < E; e += NT) {
        float acc = 0.0f;
#pragma unroll 8
        for (int sl = 0; sl < nv; ++sl) acc = fmaf(en[i * Sl + sl], ldf(vb + (long)sl * E + e), acc);
        ctxp[i * E + e] = acc;
      }
      PHASE(t, 5);  // context partial
    }
    cluster.sync();  // every block's partials are readable
    PHASE(t, 6);  // cluster barrier 1

    // ---- phase B, each slot: alignment and this block's slice of the context
    for (int i = 0; i < NS; ++i) {
      const int b = slot_utterance(ord, B, G, c, i);
      if (b < 0) continue;
      const long row = (long)t * B + b;
      const int len = min(max(a.enc_len[b], 0), S);
      const int Sb = cdiv(max(len, 1), CL);
      if (tid < CL) {
        sc[tid] = *cluster.map_shared_rank(stat + 2 * i, tid);
        sc[CLMAX + tid] = *cluster.map_shared_rank(stat + 2 * i + 1, tid);
      }
      __syncthreads();
      float gm = LOWEST;
      for (int q = 0; q < CL; ++q) gm = fmaxf(gm, sc[q]);
      float z = 0.0f;
      for (int q = 0; q < CL; ++q) z = fmaf(sc[CLMAX + q], expf(sc[q] - gm), z);
      const float inv = z > 0.0f ? 1.0f / z : 0.0f;
      float* scl = sc + 2 * CLMAX;  // the blocks' scales, normalised
      __syncthreads();
      if (tid < CL) scl[tid] = expf(sc[tid] - gm) * inv;
      __syncthreads();
      for (int s = tid; s < S; s += NT) {
        float al = 0.0f;
        if (s < len) {
          const int q = s / Sb;
          al = *cluster.map_shared_rank(en + i * Sl + s - q * Sb, q) * scl[q];
        }
        att[i * SA + APAD + s] = rnd<S_>(al);
        if (s / Sl == rank) stf(a.align + row * S + s, al);
      }
      for (int e = e0 + tid; e < e0 + ne; e += NT) {
        float pv[CLMAX];  // the blocks' partials, all loads in flight
#pragma unroll
        for (int q = 0; q < CLMAX; ++q) pv[q] = q < CL ? *cluster.map_shared_rank(ctxp + i * E + e, q) : 0.0f;
        float acc = 0.0f;
#pragma unroll
        for (int q = 0; q < CLMAX; ++q)
          if (q < CL) acc = fmaf(pv[q], scl[q], acc);
        a.ctxs[row * E + e] = acc;
      }
      __syncthreads();
    }
    PHASE(t, 7);  // combine
    grid.sync();  // ctx and the token of every utterance are in global memory
    PHASE(t, 8);  // grid barrier 1

    // ---- gate product and cell update of the own units, all utterances:
    // [16 utterances, E + H] x [E + H, 8 columns] tiles on the tensor cores
    // (mma m16n8k8, three TF32 products per tile for float32 accuracy), the
    // k-steps dealt over the warps; the warps' partial tiles summed in a
    // fixed order through shared memory, four warps a round. The cell
    // update's row of ew (by the token fed) is loaded first, in the
    // background, for a thread's first (utterance, unit)
    const int ncu = nu > 0 ? B * nu : 0;
    float ewp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (tid < ncu) {
      const float* ewr = a.ew + (long)__ldcg(a.tokens + (long)t * B + tid / nu) * G4 + u0 + tid % nu;
#pragma unroll
      for (int g = 0; g < 4; ++g) ewp[g] = ewr[g * H];
    }
    for (int ub = 0; ub < B && nu > 0; ub += 16) {
      const int rows = t > 0 ? X : E;  // h = 0 before the first step
      const int nch = cdiv(rows, 16), g8 = lane >> 2, tig = lane & 3;
      const long ra = (long)t * B + ub + g8, rb = ra + 8;
      const bool oka = ub + g8 < B, okb = ub + g8 + 8 < B;
      const float* ca = a.ctxs + ra * E;
      const float* cb = a.ctxs + rb * E;
      const S_* ha = a.hidden + (ra - B) * H - E;  // ha[r] = h of row r >= E
      const S_* hb = a.hidden + (rb - B) * H - E;
      const bool vec = E % 4 == 0;  // rows of ctx and h start on 16 bytes
      for (int n0 = 0; n0 < nc; n0 += 16) {
        const int c0 = n0 + g8, c1 = c0 + 8;  // the lane's columns of the two tiles
        const bool okc0 = c0 < nc, okc1 = c1 < nc;
        float d[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) d[q] = 0.0f;
        for (int kc = wid; kc < nch; kc += NW * KPF) {
          // chunk kc + NW u: input columns 16 (kc + NW u) + 4 tig .. + 3 of
          // rows g8 and g8 + 8 (one 16-byte load each, all in flight)
          float aa[KPF][4], ab[KPF][4];
#pragma unroll
          for (int u = 0; u < KPF; ++u) {
            const int k0 = 16 * (kc + NW * u), kx = k0 + 4 * tig;
            if (vec && k0 + 16 <= E) {
              const float4 x = oka ? __ldcg(reinterpret_cast<const float4*>(ca + kx)) : make_float4(0, 0, 0, 0);
              const float4 y = okb ? __ldcg(reinterpret_cast<const float4*>(cb + kx)) : make_float4(0, 0, 0, 0);
              aa[u][0] = x.x; aa[u][1] = x.y; aa[u][2] = x.z; aa[u][3] = x.w;
              ab[u][0] = y.x; ab[u][1] = y.y; ab[u][2] = y.z; ab[u][3] = y.w;
            } else if (vec && k0 >= E && k0 + 16 <= rows) {
              const float4 x = oka ? ld4cg(ha + kx) : make_float4(0, 0, 0, 0);
              const float4 y = okb ? ld4cg(hb + kx) : make_float4(0, 0, 0, 0);
              aa[u][0] = x.x; aa[u][1] = x.y; aa[u][2] = x.z; aa[u][3] = x.w;
              ab[u][0] = y.x; ab[u][1] = y.y; ab[u][2] = y.z; ab[u][3] = y.w;
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                aa[u][e] = oka && kx + e < rows ? gate_input(a, ra, kx + e) : 0.0f;
                ab[u][e] = okb && kx + e < rows ? gate_input(a, rb, kx + e) : 0.0f;
              }
            }
          }
#pragma unroll
          for (int u = 0; u < KPF; ++u) {
            const int k0 = 16 * (kc + NW * u), kx = k0 + 4 * tig;
            if (k0 >= rows) break;
            float w0[4], w1[4];  // rows kx .. + 3 of the lane's two columns
            if (a.w_smem) {
              const float4 x = okc0 ? ld4(wt + c0 * WST + kx) : make_float4(0, 0, 0, 0);
              const float4 y = okc1 ? ld4(wt + c1 * WST + kx) : make_float4(0, 0, 0, 0);
              w0[0] = x.x; w0[1] = x.y; w0[2] = x.z; w0[3] = x.w;
              w1[0] = y.x; w1[1] = y.y; w1[2] = y.z; w1[3] = y.w;
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                w0[e] = okc0 && kx + e < rows ? gate_weight(a, c0, kx + e, nu, u0) : 0.0f;
                w1[e] = okc1 && kx + e < rows ? gate_weight(a, c1, kx + e, nu, u0) : 0.0f;
              }
            }
            // k-step j of the chunk: its k = tig and tig + 4 are the input
            // columns kx + 2 j and kx + 2 j + 1 (a permutation of the 16)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float av[4] = {aa[u][2 * j], ab[u][2 * j], aa[u][2 * j + 1], ab[u][2 * j + 1]};
              const float b0[2] = {w0[2 * j], w0[2 * j + 1]}, b1[2] = {w1[2 * j], w1[2 * j + 1]};
              mma_3xtf32(d, av, b0);
              mma_3xtf32(d + 4, av, b1);
            }
          }
        }
        for (int r = 0; r < NW / 4; ++r) {
          if (wid / 4 == r) {
            float* slot = gpart + ((wid % 4) * 32 + lane) * 8;
#pragma unroll
            for (int q = 0; q < 8; ++q) slot[q] = (r == 0 ? 0.0f : slot[q]) + d[q];
          }
          __syncthreads();
        }
        // tile entry (utterance ub + bl, column n0 + cl): lane 4 (bl % 8) + (cl % 8) / 2, value
        // 4 (cl / 8) + 2 (bl / 8) + cl % 2
        for (int x = tid; x < 16 * 16; x += NT) {
          const int bl = x / 16, cl = x % 16;
          const int ln = 4 * (bl % 8) + (cl % 8) / 2, q = 4 * (cl / 8) + 2 * (bl / 8) + cl % 2;
          float v = 0.0f;
#pragma unroll
          for (int w4 = 0; w4 < 4; ++w4) v += gpart[(w4 * 32 + ln) * 8 + q];
          if (n0 + cl < nc && ub + bl < B) gsum[(ub + bl) * ncmax + n0 + cl] = v;
        }
        __syncthreads();
      }
    }
    PHASE(t, 9);  // gate product
    // cell update: one thread per (utterance, unit)
    for (int x = tid; x < ncu; x += NT) {
      const int b = x / nu, jj = x % nu, u = u0 + jj;
      const long row = (long)t * B + b;
      float ewv[4];
      if (x == tid) {
#pragma unroll
        for (int g = 0; g < 4; ++g) ewv[g] = ewp[g];
      } else {
        const float* ewr = a.ew + (long)__ldcg(a.tokens + row) * G4 + u;
#pragma unroll
        for (int g = 0; g < 4; ++g) ewv[g] = ewr[g * H];
      }
      const float* gs = gsum + b * ncmax;
      const float ig = sigmoidf_(gs[jj] + ewv[0]), fg = sigmoidf_(gs[nu + jj] + ewv[1]),
                  gg = tanhf(gs[2 * nu + jj] + ewv[2]), og = sigmoidf_(gs[3 * nu + jj] + ewv[3]);
      const float cn = fg * cst[b * numax + jj] + ig * gg;
      const float hn = og * tanhf(cn);
      cst[b * numax + jj] = rnd<S_>(cn);
      stf(a.hidden + row * H + u, hn);
      if constexpr (sizeof(S_) == 2) a.hf[(long)b * H + u] = hn;
      stf(a.cseq + row * H + u, cn);
      float* ac = a.acts + row * G4 + u;
      ac[0] = ig;
      ac[H] = fg;
      ac[2 * H] = gg;
      ac[3 * H] = og;
    }
    PHASE(t, 10);  // cell update
    grid.sync();  // h' of every utterance is in global memory
    PHASE(t, 11);  // grid barrier 2

    // ---- phase C, each slot: logits of the own vocabulary slice, local
    // argmax, own slice of the next q
    const bool feed = t + 1 < n && !a.use_teacher[t + 1];
    // the sampling seed, split as the host split it before it moved to device memory
    const unsigned long long sd = a.sample ? (unsigned long long)*a.seed : 0ull;
    const uint32_t seed_lo = (uint32_t)(sd & 0x7FFFFFFFull), seed_hi = (uint32_t)((sd >> 31) & 0x7FFFFFFFull);
    const int no = nvc + ndk, xsplit = max(1, min(H, NT / max(no, 1))), xchunk = cdiv(H, xsplit);
    for (int i = 0; i < NS; ++i) {
      const int b = slot_utterance(ord, B, G, c, i);
      if (b < 0) continue;
      const long row = (long)t * B + b;
      for (int x = tid; x < H; x += NT)
        hs[x] = sizeof(S_) == 2 ? __ldcg(a.hf + (long)b * H + x) : ldcgf(a.hidden + row * H + x);
      __syncthreads();
      // outputs o < nvc: own logits; then the own slice of q. Threads over
      // (output, chunk of h'), neighbours on neighbouring columns
      for (int x2 = tid; x2 < no * xsplit; x2 += NT) {
        const int o = x2 % no, xs = x2 / no, xa = xs * xchunk, xb = min(H, xa + xchunk);
        float acc = 0.0f;
        if (o < nvc) {
          if (a.wo_smem) {
            for (int x = xa; x < xb; ++x) acc = fmaf(hs[x], ldf(wos + x * Vc + o), acc);
          } else {
#pragma unroll 12
            for (int x = xa; x < xb; ++x) acc = fmaf(hs[x], ldgf(a.wout + (long)x * V + v0 + o), acc);
          }
        } else {
          // q from h' as stored (rounded in bf16)
          const int dl = o - nvc;
          if (a.wq_smem) {
            for (int x = xa; x < xb; ++x) acc = fmaf(rnd<S_>(hs[x]), ldf(wqs + x * Dkc + dl), acc);
          } else {
#pragma unroll 12
            for (int x = xa; x < xb; ++x) acc = fmaf(rnd<S_>(hs[x]), ldgf(a.wq + (long)x * Dk + d0 + dl), acc);
          }
        }
        opart[x2] = acc;
      }
      __syncthreads();
      for (int o = tid; o < no; o += NT) {
        float acc = 0.0f;
        for (int xs = 0; xs < xsplit; ++xs) acc += opart[xs * no + o];
        if (o < nvc) {
          const int col = v0 + o;
          const float lgt = acc + ldf(a.bout + col);
          stf(a.logits + row * V + col, lgt);
          lg[o] = a.sample ? lgt + gumbel(seed_lo, seed_hi, t, a.row0 + b, col) : lgt;
        } else {
          qsl[i * Dkc + o - nvc] = acc + ldf(a.bq + d0 + o - nvc);
        }
      }
      __syncthreads();
      if (feed && wid == 0) {
        float best = LOWEST;
        int bi = 0;
        for (int c0 = lane; c0 < nvc; c0 += 32) {
          if (lg[c0] > best) {
            best = lg[c0];
            bi = c0;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, best, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          if (ob > best || (ob == best && oi < bi)) {
            best = ob;
            bi = oi;
          }
        }
        if (lane == 0) {
          amx[i] = best;
          aix[i] = v0 + bi;
        }
      }
      __syncthreads();
    }
    PHASE(t, 12);  // logits, argmax and q slice
    cluster.sync();  // q slices and the local argmaxes are readable
    PHASE(t, 13);  // cluster barrier 2
  }

  // ---- rows n .. L-1 of every output: zeros, over the whole grid
  const long r0 = (long)n * B, rows = (long)(L - n) * B;
  const long gt = (long)j * NT + tid, gs = (long)gridDim.x * NT;
  for (long x = gt; x < rows * V; x += gs) stf(a.logits + r0 * V + x, 0.0f);
  for (long x = gt; x < rows * S; x += gs) stf(a.align + r0 * S + x, 0.0f);
  for (long x = gt; x < rows * H; x += gs) {
    stf(a.hidden + r0 * H + x, 0.0f);
    stf(a.cseq + r0 * H + x, 0.0f);
  }
  for (long x = gt; x < rows * G4; x += gs) a.acts[r0 * G4 + x] = 0.0f;
  for (long x = gt; x < rows * Dk; x += gs) a.qs[r0 * Dk + x] = 0.0f;
  for (long x = gt; x < rows * E; x += gs) a.ctxs[r0 * E + x] = 0.0f;
  for (long x = gt; x < rows; x += gs) a.tokens[r0 + x] = 0;
}

__global__ void gumbel_noise_kernel(float* out, int L, int B, int V, int row0, uint32_t seed_lo,
                                    uint32_t seed_hi) {
  const long n = (long)L * B * V;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const int col = (int)(i % V);
    const long r = i / V;
    out[i] = gumbel(seed_lo, seed_hi, (int)(r / B), row0 + (int)(r % B), col);
  }
}

// the kernel of storage type dt (0 float, 1 bf16)
const void* fwd_kernel(int dt) {
  return dt ? (const void*)decoder_scan_fwd_kernel<bf16> : (const void*)decoder_scan_fwd_kernel<float>;
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
  return cudaFuncSetAttribute(fwd_kernel(dt), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" const char* e2e_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out[0] = the clusters of cl blocks of the forward kernel of storage type
// dt (0 float, 1 bf16) that can be resident at once with smem bytes of
// dynamic shared memory a block
extern "C" int e2e_decoder_scan_fwd_clusters(int cl, int smem, int dt, int* out, void* stream) {
  if (cl < 1 || cl > CLMAX || dt < 0 || dt > 1) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute at[2];
  cudaError_t e = launch_config(cfg, at, 1, cl, (size_t)smem, dt, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  cfg.numAttrs = 1;  // the query takes the cluster shape
  return (int)cudaOccupancyMaxActiveClusters(out, fwd_kernel(dt), &cfg);
}

// The forward kernel's shared memory on G clusters of CL blocks (host only):
// out[0] = bytes a block, or -1 where the working buffers alone exceed
// SMEM_MAX; out[1..5] = the flags w_smem, v_smem, wq_smem, wo_smem, k_smem
// of e2e_decoder_scan_fwd, each resident taken in that order while the
// block's total stays within SMEM_MAX; dt: the storage type (0 float, 1
// bf16), in which the residents are held.
extern "C" int e2e_decoder_scan_fwd_plan(int B, int S, int Dk, int E, int K, int P, int H, int V,
                                         int G, int CL, int dt, int* out, void* stream) {
  (void)stream;
  if (B < 1 || S < 1 || G < 1 || CL < 1 || CL > CLMAX || dt < 0 || dt > 1) return (int)cudaErrorInvalidValue;
  const int NS = cdiv(B, G), es = dt ? 2 : 4;
  int f[5] = {0, 0, 0, 0, 0};  // w, v, wq, wo, k
  auto bytes = [&]() {
    return sizeof(float) * fwd_layout(B, S, Dk, E, K, P, H, V, G, CL, NS, f[0], f[2], f[3], f[4], f[1], es).total;
  };
  out[0] = -1;
  if (bytes() > SMEM_MAX) return 0;
  for (int i = 0; i < 5; ++i) {
    f[i] = 1;
    if (bytes() > SMEM_MAX) f[i] = 0;
    out[1 + i] = f[i];
  }
  out[0] = (int)bytes();
  return 0;
}

// k [B, S, Dk], v [B, S, E], enc_len [B] i32, taps [K, P], wq [H, Dk], bq [Dk],
// wlp [K, Dk], locv [Dk], locb [Dk], embed [V, Emb], wx [Emb + E, 4H],
// wh [H, 4H], bl [4H], wout [H, V], bout [V], teacher [L, B] i32,
// use_teacher [L] i32, seed [1] i64 (read where sample; may be null otherwise),
// row0 the global batch's row of utterance 0 (the Gumbel noise's key),
// steps [1] i32 (the steps run, clamped to [0, L]; null: L), steps_run [3]
// i64 (a tracer's counter: [0] the bank, [1 + bank] += the steps run; may be
// null)
// -> logits [L, B, V], align [L, B, S], hidden [L, B, H],
// cseq [L, B, H], tokens [L, B] i32, acts [L, B, 4H], qs [L, B, Dk],
// ctxs [L, B, E], zero on rows past the steps run; ew [V, 4H] and hf [B, H]
// scratch (hf unused at float).
// k, v, the weights, logits, align, hidden and cseq of storage type dt (0
// float, 1 bf16), the rest float but the ids, all contiguous. H a multiple
// of 8 up to 512, Dk up to 512, P odd. G clusters of CL blocks (all
// resident: the cooperative launch fails otherwise), ceil(B / G) utterance
// slots each; the flags say what lives in shared memory.
extern "C" int e2e_decoder_scan_fwd(
    const void* k, const void* v, const int* enc_len, const void* taps, const void* wq,
    const void* bq, const void* wlp, const void* locv, const void* locb, const void* embed,
    const void* wx, const void* wh, const void* bl, const void* wout, const void* bout,
    const int* teacher, const int* use_teacher, void* logits, void* align, void* hidden,
    void* cseq, int* tokens, float* acts, float* qs, float* ctxs, float* ew, float* hf, int B, int S,
    int Dk, int E, int K, int P, int H, int Emb, int V, int L, float inv_temp, int sample, int row0,
    const long long* seed, const int* steps, long long* steps_run, int G, int CL, int w_smem, int wq_smem,
    int wo_smem, int k_smem, int v_smem, int dt, void* stream) {
  if (H % 8 != 0 || H > 512 || Dk > NT || P % 2 != 1 || B < 1 || S < 1 || L < 1 || V < 1 || G < 1 ||
      CL < 1 || CL > CLMAX || dt < 0 || dt > 1 || (sample && !seed) || row0 < 0)
    return (int)cudaErrorInvalidValue;
  const int NS = cdiv(B, G);
  const FwdLayout ly = fwd_layout(B, S, Dk, E, K, P, H, V, G, CL, NS, w_smem, wq_smem, wo_smem,
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
    using O = T*;
    FwdArgs<T> a{(C)k, (C)v, enc_len, (C)taps, (C)wq, (C)bq, (C)wlp, (C)locv, (C)locb, (C)embed, (C)wx,
                 (C)wh, (C)bl, (C)wout, (C)bout, teacher, use_teacher, (O)logits, (O)align, (O)hidden,
                 (O)cseq, tokens, acts, qs, ctxs, ew, hf,
                 B, S, Dk, E, K, P, H, Emb, V, L, inv_temp, sample, row0,
                 (const long long*)seed, steps, steps_run, G, CL, NS, w_smem, wq_smem, wo_smem, k_smem, v_smem};
    return cudaLaunchKernelEx(&cfg, decoder_scan_fwd_kernel<T>, a);
  };
  return (int)(dt ? run(bf16{}) : run(0.0f));
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

// out [L, B, V]: the Gumbel noise the scan adds under (seed_lo, seed_hi) to
// global rows row0 .. row0 + B - 1
extern "C" int e2e_decoder_scan_noise(float* out, int L, int B, int V, int row0, int seed_lo, int seed_hi,
                                      void* stream) {
  const long n = (long)L * B * V;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  gumbel_noise_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, L, B, V, row0, (uint32_t)seed_lo,
                                                                 (uint32_t)seed_hi);
  return (int)cudaGetLastError();
}
