// Raw audio -> log-mel spectrogram, one kernel: a real FFT per frame in
// shared memory, in float64 from the samples to the power.
//
// Replaces the TPU kernel e2e_asr_tpu/ops/frontend_pallas.py log_mel_pallas
// (_kernel, fused_bases). It computes the same function: frames of `win`
// samples every `shift` samples (snip-edges framing, samples past N read as
// zero); per frame the mean removed, pre-emphasis (y0 = (1 - p) x0,
// yi = xi - p x(i-1)), the window, zero padding to n_fft, the real DFT,
// power re^2 + im^2, the mel bank and log(max(mel, 1.1921e-7)).
//
// What bounds it on the H100: bytes, by the count of the work: the TPU kernel
// folds DC removal and pre-emphasis into dense windowed DFT bases because its
// matrix unit makes a dense product cheap; on the CUDA cores that is 2 win F
// FMAs a frame (~411 kFLOP at 25 ms / 512 points). A real FFT does the same
// in ~12 kFLOP and each bin feeds at most two mel filters (~1 kFLOP), so the
// least time is that of the wave in and the features out. What limits this
// kernel in practice is shared memory: every FFT pass, the split and the mel
// sums go through it (PERF.md), so the design keeps the accesses few
// and conflict-free.
//
// Why float64: pre-emphasis leaves 1e-3 of the power at the lowest bins, and
// speech-like waves have quiet bands besides. A float32 frame, once
// pre-emphasised, carries rounding noise at 6e-8 of its whole energy in
// every bin, and each FFT pass adds as much: at those bins that is ~1e-3 of
// their power, ~1e-3 in log units (measured against a float64 reference,
// PERF.md). The folded bases of the plain version apply the attenuation to
// the raw samples and err less. In float64 the transform's rounding is gone;
// what is left is the float32 power's and the mel sums' (~1e-6). The H100
// issues float64 at half the float32 rate, and the kernel is bound by its
// shared-memory traffic, which float64 doubles.
//
// Design: a persistent grid of two blocks an SM walks tiles of 16
// consecutive frames of one utterance (8 where n_fft > 512). A block stages a
// tile's span ((tf - 1) shift + win samples) into shared memory with 16-byte
// cp.async copies, so the frames' ~2.5x overlap never reaches device memory
// twice; the next tile's span lands while the block sums the mel filters,
// and the other block of the SM computes while one waits. A group of 16
// lanes (two frames a warp; 32 lanes where n_fft > 512) transforms one
// frame: the mean is a reduction over the group; pre-emphasis and window are
// applied as the first pass reads the samples in pairs (the sample before a
// pair comes by a shuffle); the n_fft-point real FFT is an NC = n_fft /
// 2-point complex FFT of the even/odd-packed frame (Stockham passes of radix
// 16, the last of what is left; each lane holds its NC / 16 points in
// registers between a pass's loads and stores in the frame's shared buffer),
// then the split step gives float32 power for bins 0..NC into the same
// buffer. The tile's mel sums follow: a warp takes two (four) filters of
// about equal length at a time for all the tile's frames, a lane a (filter,
// frame), each filter summed over its own bins in increasing order with
// fmaf, then the accurate logf; the tile's outputs, contiguous rows of out,
// are stored coalesced. The window and the roots of unity are float64 tables
// from the host, the mel ranges and the filter groups float32 / int tables;
// a block builds each pass's twiddles from the roots, and copies the rest,
// into shared memory once. The plan (lanes a frame, the passes' radices,
// warps, filters a group) is this file's alone: e2e_log_mel_plan tells the
// host what it needs of it to build the filter groups.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 16 bytes global -> shared in the background, of which the first `bytes`
// (0 to 16) come from src and the rest are zero
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src, int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most n of the thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr float LOG_FLOOR = 1.1921e-7f;
constexpr int SMEM_MAX = 232448;  // a block's shared memory on the H100

using cplx = double2;

__device__ __forceinline__ cplx cadd(cplx a, cplx b) { return make_double2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ cplx csub(cplx a, cplx b) { return make_double2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ cplx cmul(cplx a, cplx b) {
  return make_double2(fma(a.x, b.x, -a.y * b.y), fma(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ cplx mul_mi(cplx a) { return make_double2(a.y, -a.x); }  // -i a

// In registers, natural order in and out: v_k <- sum_n v_n e^{-2 pi i n k / R}
template <int R>
__device__ __forceinline__ void dft(cplx* v);

template <>
__device__ __forceinline__ void dft<2>(cplx* v) {
  const cplx a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

template <>
__device__ __forceinline__ void dft<4>(cplx* v) {
  const cplx t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
  const cplx t2 = cadd(v[1], v[3]), t3 = mul_mi(csub(v[1], v[3]));
  v[0] = cadd(t0, t2);
  v[2] = csub(t0, t2);
  v[1] = cadd(t1, t3);
  v[3] = csub(t1, t3);
}

// a e^{-2 pi i e / 16}
template <int E>
__device__ __forceinline__ cplx w16(cplx a) {
  constexpr double c = 0.70710678118654752440, c1 = 0.92387953251128675613, s1 = 0.38268343236508977173;
  if constexpr (E == 2) return make_double2(c * (a.x + a.y), c * (a.y - a.x));
  else if constexpr (E == 4) return mul_mi(a);
  else if constexpr (E == 6) return make_double2(c * (a.y - a.x), -c * (a.x + a.y));
  else {
    constexpr double wr = E == 1 ? c1 : E == 3 ? s1 : -c1, wi = E == 1 ? -s1 : E == 3 ? -c1 : s1;  // 1, 3, 9
    return make_double2(fma(a.x, wr, -a.y * wi), fma(a.x, wi, a.y * wr));
  }
}

// 8 = 2 x 4 and 16 = 4 x 4: DFTs of the R / Q interleaved subsequences,
// twiddled, then Q-point DFTs across them
template <>
__device__ __forceinline__ void dft<8>(cplx* v) {
  cplx e[4] = {v[0], v[2], v[4], v[6]}, o[4] = {v[1], v[3], v[5], v[7]};
  dft<4>(e);
  dft<4>(o);
  o[1] = w16<2>(o[1]);
  o[2] = w16<4>(o[2]);
  o[3] = w16<6>(o[3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = cadd(e[k], o[k]);
    v[k + 4] = csub(e[k], o[k]);
  }
}

template <>
__device__ __forceinline__ void dft<16>(cplx* v) {
  cplx a[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int m = 0; m < 4; ++m) a[r][m] = v[r + 4 * m];
    dft<4>(a[r]);
  }
  cplx b[4][4] = {{a[0][0], a[1][0], a[2][0], a[3][0]},
                  {a[0][1], w16<1>(a[1][1]), w16<2>(a[2][1]), w16<3>(a[3][1])},
                  {a[0][2], w16<2>(a[1][2]), w16<4>(a[2][2]), w16<6>(a[3][2])},
                  {a[0][3], w16<3>(a[1][3]), w16<6>(a[2][3]), w16<9>(a[3][3])}};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    dft<4>(b[k]);
#pragma unroll
    for (int q = 0; q < 4; ++q) v[k + 4 * q] = b[k][q];
  }
}

// Lanes a frame: 16 (two frames a warp) up to NC = 256, else 32.
__host__ __device__ constexpr int lanes_of(int nc) { return nc <= 256 ? 16 : 32; }

// Frames a tile: a frame a lane group.
__host__ __device__ constexpr int frames_of(int nc) { return WARPS * (32 / lanes_of(nc)); }

// The radix of the Stockham pass that follows sub-transforms of length ns:
// 16 (or the nc / lanes points a lane holds, if fewer) while it divides what
// is left, then what is left.
__host__ __device__ constexpr int radix_of(int nc, int ns) {
  const int e = nc / lanes_of(nc), rm = e < 16 ? e : 16;
  return ns * rm <= nc ? rm : nc / ns;
}

// A frame's FFT buffer holds one pad point after every R1 (the first pass's
// radix), so that the first pass's stride-R1 stores, and every pass's loads
// and stores, fall on distinct banks within a quarter-warp.
__host__ __device__ constexpr int pad(int nc, int i) { return i + i / radix_of(nc, 1); }

// Where the pass after sub-transforms of length ns starts in the pass
// twiddle table ([R - 1][ns] entries a pass with ns > 1); ns = nc: its size.
__host__ __device__ constexpr int tw_offset(int nc, int ns) {
  int off = 0;
  for (int n = 1; n < ns; n *= radix_of(nc, n))
    if (n > 1) off += (radix_of(nc, n) - 1) * n;
  return off;
}

// Twiddle, butterfly and store of lane l's NB = NC / (P R) butterflies
// (butterfly b is sub-transform j = l + P b): Stockham's autosort order, so
// the last pass leaves the NC points in natural order. The pass's twiddles
// e^{-2 pi i r k / (NS R)} sit at [r - 1][k]: the lanes read consecutive k.
template <int NC, int R, int NS>
__device__ __forceinline__ void butterflies(cplx (*v)[R], cplx* buf, const cplx* tw, int l) {
  constexpr int P = lanes_of(NC), NB = NC / (P * R), TW = tw_offset(NC, NS);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int j = l + P * b, k = j % NS;
    if constexpr (NS > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[b][r] = cmul(v[b][r], tw[TW + (r - 1) * NS + k]);
    }
    dft<R>(v[b]);
    const int d = (j / NS) * (NS * R) + k;
#pragma unroll
    for (int r = 0; r < R; ++r) buf[pad(NC, d + r * NS)] = v[b][r];
  }
  __syncwarp();
}

// The passes after the first, in place in the frame's buffer.
template <int NC, int NS>
__device__ __forceinline__ void fft_passes(cplx* buf, const cplx* tw, int l) {
  if constexpr (NS < NC) {
    constexpr int P = lanes_of(NC), R = radix_of(NC, NS), NB = NC / (P * R);
    cplx v[NB][R];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int r = 0; r < R; ++r) v[b][r] = buf[pad(NC, l + P * b + r * (NC / R))];
    __syncwarp();
    butterflies<NC, R, NS>(v, buf, tw, l);
    fft_passes<NC, NS * R>(buf, tw, l);
  }
}

// Offsets (in floats) of a block's shared memory: the span, the tables, an
// FFT buffer for each frame of the tile (its float32 power row, once the
// transform is read, at row_offset floats into it), then the tile's log-mel
// rows. A frame's first pass reads up to n_fft - win samples past the span,
// and up to n_fft - win window entries past the window, into the tables
// that follow: inside the block's memory, and never used.
struct Layout {
  int tw, sw, win, mw, rng, grp, buf, ot, total;
};

__host__ __device__ inline Layout layout(int nc, int span_cap, int win, int n_w, int m, int grp, int tf) {
  Layout l;
  l.tw = span_cap;                          // span_cap is a multiple of 4: a 16-byte aligned span
  l.sw = l.tw + 4 * tw_offset(nc, nc);      // pass twiddles, double2
  l.win = l.sw + 4 * (nc / 2 + 1);          // [nc / 2 + 1] double2 split twiddles
  l.mw = (l.win + 2 * win + 3) & ~3;        // [win] double window; then 16-byte aligned
  l.rng = l.mw + n_w;                       // [n_w] mel weights, a filter's from a multiple of 4
  l.grp = l.rng + 3 * m;                    // [m][3] int mel ranges
  l.buf = (l.grp + grp + 3) & ~3;           // [groups][32 / tf] int filter groups; then 16-byte aligned
  l.ot = l.buf + 4 * pad(nc, nc) * tf;      // [tf][pad(nc, nc)] double2
  l.total = l.ot + tf * m;                  // [tf][m] log-mel
  return l;
}

struct Args {
  const float* wav;
  const double* window;
  const double2* roots;
  const float* mel_w;
  const int* mel_rng;
  const int* mel_grp;
  float* out;
  int N, T, win, shift, M, n_w, groups;
  double pre;
  int tf, tiles_per_utt, n_tiles, span_cap;
};

struct Tables {
  const cplx* tw;
  const cplx* sw;
  const double* wt;
  const float* mw;
  const int* rng;
  const int* grp;
};

// A tile's span (from its first sample, rounded down to 16 bytes) into dst;
// samples past the utterance's end are zeros.
__device__ __forceinline__ void stage(const Args& a, int tile, float* dst) {
  const int b = tile / a.tiles_per_utt, t0 = (tile - b * a.tiles_per_utt) * a.tf;
  const long row = (long)b * a.N, g0 = row + (long)t0 * a.shift, ga = g0 & ~3L, end = row + a.N;
  const int chunks = (int)((g0 - ga) + (long)(a.tf - 1) * a.shift + a.win + 3) >> 2;
  for (int c = threadIdx.x; c < chunks; c += THREADS) {
    const long gi = ga + 4L * c, valid = end - gi;
    const int bytes = valid >= 4 ? 16 : (valid > 0 ? 4 * (int)valid : 0);
    cp_async16_zfill(dst + 4 * c, a.wav + (bytes ? gi : 0), bytes);
  }
}

// One frame x[0, win) of the staged span -> its float32 power row pw[0, NC],
// then three zeros, by the P lanes of its group (lane l of them, group mask
// gm).
template <int NC>
__device__ __forceinline__ void frame(const Args& a, const Tables& t, const float* x, cplx* buf, float* pw,
                                      int l, unsigned gm) {
  constexpr int P = lanes_of(NC);
  const int win = a.win;
  // Lane l's points of the packed frame are i = l + P q (q = r NB + b),
  // point i the pair (x[2i], x[2i + 1]); where the frame starts at an even
  // float the pair is one 8-byte load (served a half-warp at a time: the two
  // frames of a warp do not meet on a bank). Past win the samples are read
  // and never used.
  constexpr int R = radix_of(NC, 1), NB = NC / (P * R), E = NB * R;
  const bool pairs = ((reinterpret_cast<uintptr_t>(x) >> 2) & 1) == 0;
  float2 xs[E];
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const int s0 = 2 * (l + P * q);
    xs[q] = pairs ? *reinterpret_cast<const float2*>(x + s0) : make_float2(x[s0], x[s0 + 1]);
  }
  double s = 0.0;
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const int s0 = 2 * (l + P * q);
    s += (s0 < win ? (double)xs[q].x : 0.0) + (s0 + 1 < win ? (double)xs[q].y : 0.0);
  }
#pragma unroll
  for (int m = P / 2; m; m >>= 1) s += __shfl_xor_sync(gm, s, m);  // the same sum in the P lanes
  const double mean = s / (double)win;

  // first pass: y, the frame with its mean removed, pre-emphasised and
  // windowed, zero from win. The sample before a point's pair is the last of
  // the point before: lane l - 1's (lane P - 1's of q - 1 for lane 0), by a
  // shuffle.
  cplx v[NB][R];
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const int s0 = 2 * (l + P * q);
    const float xm = __shfl_sync(gm, l == P - 1 ? (q > 0 ? xs[q - 1].y : 0.0f) : xs[q].y, (l + P - 1) % P, P);
    const double2 w = *reinterpret_cast<const double2*>(t.wt + s0);
    const double d0 = (double)xs[q].x - mean, dm = s0 > 0 ? (double)xm - mean : d0;
    v[q % NB][q / NB] = make_double2(s0 < win ? w.x * fma(-a.pre, dm, d0) : 0.0,
                                     s0 + 1 < win ? w.y * fma(-a.pre, d0, (double)xs[q].y - mean) : 0.0);
  }
  butterflies<NC, R, 1>(v, buf, t.tw, l);
  fft_passes<NC, R>(buf, t.tw, l);

  // split: Z = FFT(packed) -> X[k] = Ye + W^k Yo and X[NC - k] = conj(Ye - W^k Yo),
  // Ye = (Z[k] + conj Z[NC - k]) / 2, Yo = (Z[k] - conj Z[NC - k]) / 2i, W = e^{-2 pi i / n_fft};
  // X[NC / 2] = conj Z[NC / 2]. Every lane reads before any writes the power
  // row over the buffer.
  constexpr int KP = NC / (2 * P);
  float hi2[KP], lo2[KP];
#pragma unroll
  for (int i = 0; i < KP; ++i) {
    const int k = l + P * i;
    const cplx p = buf[pad(NC, k)], q = buf[pad(NC, (NC - k) & (NC - 1))];
    const cplx ye = make_double2(0.5 * (p.x + q.x), 0.5 * (p.y - q.y));
    const cplx yo = make_double2(0.5 * (p.y + q.y), 0.5 * (q.x - p.x));
    const cplx w = cmul(t.sw[k], yo);
    const cplx hi = cadd(ye, w), lo = csub(ye, w);
    hi2[i] = (float)fma(hi.x, hi.x, hi.y * hi.y);
    lo2[i] = (float)fma(lo.x, lo.x, lo.y * lo.y);
  }
  const cplx z = buf[pad(NC, NC / 2)];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < KP; ++i) {
    pw[l + P * i] = hi2[i];
    pw[NC - l - P * i] = lo2[i];
  }
  if (l == 0) pw[NC / 2] = (float)fma(z.x, z.x, z.y * z.y);
  // what the mel sums read past the row (a filter's weights padded to 4)
  if (l >= 1 && l <= 3) pw[NC + l] = 0.0f;
}

// Where frame f's power row starts in its buffer (floats): the two frames of
// a warp 16 banks apart, so that their stores do not meet; rows of frames
// 0..15 on 16 distinct banks for the mel sums (the buffers are 0 mod 32 banks).
template <int NC>
__device__ __forceinline__ int row_offset(int f) {
  return lanes_of(NC) == 16 ? (f >> 1) + 16 * (f & 1) : f;
}

// The tile's mel filters and logs, [nvalid][M] -> ot. A warp takes a group
// of G = 32 / tf filters of about equal length at a time for all tf frames
// (lane = filter g of the group, frame f), so no lane waits on a longer
// loop; the host deals the groups to the warps (row i * WARPS + warp of the
// table: the warp's group of round i). Each filter is summed over its bins
// in increasing order with fmaf.
template <int NC>
__device__ __forceinline__ void mel_tile(const Args& a, const Tables& t, const float* bufs, float* ot, int nvalid,
                                         int warp, int lane) {
  const int g_size = 32 / a.tf, f = lane % a.tf, g = lane / a.tf;
  for (int q = warp; q < a.groups; q += WARPS) {
    const int m = t.grp[q * g_size + g];
    if (m < 0 || f >= nvalid) continue;
    const int st = t.rng[3 * m], len = t.rng[3 * m + 1], off = t.rng[3 * m + 2];
    const float* p = bufs + f * (4 * pad(NC, NC)) + row_offset<NC>(f) + st;
    const float4* w4 = reinterpret_cast<const float4*>(t.mw + off);
    float acc = 0.0f;
    // four bins a step: the host pads a filter's weights with zeros to a
    // multiple of 4, and the frame pads its row with zeros
    for (int j = 0; j < len; j += 4) {
      const float4 w = w4[j >> 2];
      acc = fmaf(p[j], w.x, acc);
      acc = fmaf(p[j + 1], w.y, acc);
      acc = fmaf(p[j + 2], w.z, acc);
      acc = fmaf(p[j + 3], w.w, acc);
    }
    ot[f * a.M + m] = logf(fmaxf(acc, LOG_FLOOR));
  }
}

// Up to n_fft 512, two blocks an SM (the shared memory of two fits at
// n_fft 512).
template <int NC>
__global__ void __launch_bounds__(THREADS, NC <= 256 ? 2 : 1) log_mel_fft(Args a) {
  constexpr int P = lanes_of(NC);
  extern __shared__ __align__(16) float smem[];
  const Layout l = layout(NC, a.span_cap, a.win, a.n_w, a.M, a.groups * (32 / a.tf), a.tf);
  cplx* tw = reinterpret_cast<cplx*>(smem + l.tw);
  cplx* sw = reinterpret_cast<cplx*>(smem + l.sw);
  double* wt = reinterpret_cast<double*>(smem + l.win);
  float* mw = smem + l.mw;
  int* rng = reinterpret_cast<int*>(smem + l.rng);
  int* grp = reinterpret_cast<int*>(smem + l.grp);
  float* ot = smem + l.ot;
  const Tables t{tw, sw, wt, mw, rng, grp};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = warp * (32 / P) + lane / P;  // this lane group's frame of each tile
  cplx* buf = reinterpret_cast<cplx*>(smem + l.buf) + f * pad(NC, NC);
  const unsigned gm = P == 32 ? 0xffffffffu : 0xffffu << (lane & 16);  // this lane group

  if ((int)blockIdx.x < a.n_tiles) stage(a, blockIdx.x, smem);  // the first span lands while the tables load
  cp_async_commit();
  // each pass's twiddles e^{-2 pi i r k / (ns R)} at [r - 1][k], from the
  // roots e^{-2 pi i j / (2 NC)}; the split's are the first NC / 2 + 1 roots
  for (int ns = 1; ns < NC; ns *= radix_of(NC, ns)) {
    if (ns == 1) continue;
    const int r_ = radix_of(NC, ns), off = tw_offset(NC, ns), step = 2 * NC / (ns * r_);
    for (int i = threadIdx.x; i < (r_ - 1) * ns; i += THREADS) {
      const int r = i / ns + 1, k = i - (r - 1) * ns;
      tw[off + i] = a.roots[r * k * step];
    }
  }
  for (int i = threadIdx.x; i <= NC / 2; i += THREADS) sw[i] = a.roots[i];
  for (int i = threadIdx.x; i < a.win; i += THREADS) wt[i] = a.window[i];
  for (int i = threadIdx.x; i < a.n_w; i += THREADS) mw[i] = a.mel_w[i];
  for (int i = threadIdx.x; i < 3 * a.M; i += THREADS) rng[i] = a.mel_rng[i];
  for (int i = threadIdx.x; i < a.groups * (32 / a.tf); i += THREADS) grp[i] = a.mel_grp[i];

  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    cp_async_wait<0>();
    __syncthreads();  // the tile's span has landed (and the tile before is stored)
    const int b = tile / a.tiles_per_utt, t0 = (tile - b * a.tiles_per_utt) * a.tf;
    const int nvalid = a.T - t0 < a.tf ? a.T - t0 : a.tf;
    // every lane group transforms its frame, past nvalid too (staged zeros,
    // never read), so that no lane leaves the warp's shuffles and syncs
    const float* span = smem + (int)(((long)b * a.N + (long)t0 * a.shift) & 3);
    frame<NC>(a, t, span + f * a.shift, buf, reinterpret_cast<float*>(buf) + row_offset<NC>(f), lane % P, gm);
    __syncthreads();  // every power row is in; the span is free for the next tile's, which lands meanwhile
    if (tile + (int)gridDim.x < a.n_tiles) stage(a, tile + gridDim.x, smem);
    cp_async_commit();
    mel_tile<NC>(a, t, smem + l.buf, ot, nvalid, warp, lane);
    __syncthreads();
    float* o = a.out + ((long)b * a.T + t0) * a.M;  // the tile's frames are contiguous rows of out
    for (int i = threadIdx.x; i < nvalid * a.M; i += THREADS) o[i] = ot[i];
  }
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  if (!count[dev]) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

template <int NC>
int launch(Args a, int B, int group_size, cudaStream_t stream) {
  a.tf = frames_of(NC);
  // the host's filter groups must follow this plan: G filters a group, a
  // group a warp a round (e2e_log_mel_plan)
  if (group_size != 32 / a.tf || a.groups % WARPS) return (int)cudaErrorInvalidValue;
  a.span_cap = (((a.tf - 1) * a.shift + a.win + 3) + 3) & ~3;
  const size_t bytes =
      sizeof(float) * (size_t)layout(NC, a.span_cap, a.win, a.n_w, a.M, a.groups * group_size, a.tf).total;
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(log_mel_fft<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, log_mel_fft<NC>, THREADS, bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  a.tiles_per_utt = (a.T + a.tf - 1) / a.tf;
  a.n_tiles = B * a.tiles_per_utt;
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const int grid = a.n_tiles < per_sm * sms ? a.n_tiles : per_sm * sms;
  log_mel_fft<NC><<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* e2e_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// What the host needs of the kernel's plan at n_fft (256, 512, 1024 or
// 2048) to build its filter groups: out[0] filters a group (32 / frames a
// tile), out[1] warps a block.
extern "C" int e2e_log_mel_plan(int n_fft, int* out) {
  if (n_fft != 256 && n_fft != 512 && n_fft != 1024 && n_fft != 2048) return (int)cudaErrorInvalidValue;
  out[0] = 32 / frames_of(n_fft / 2);
  out[1] = WARPS;
  return 0;
}

// wav [B, N] f32 (16-byte aligned), window [win] f64, roots [n_fft] complex
// f64 as double pairs (e^{-2 pi i j / n_fft}), mel_w [n_w] f32, mel_rng
// [M][3] int (first bin, bins, offset into mel_w), mel_grp [groups]
// [group_size] int (filters of about equal length, -1 for none; row
// i * warps + w: warp w's group of round i; e2e_log_mel_plan gives
// group_size and warps) -> out [B, T, M] f32; all contiguous. n_fft is 256,
// 512, 1024 or 2048.
extern "C" int e2e_log_mel(const float* wav, const double* window, const double* roots, const float* mel_w,
                           const int* mel_rng, const int* mel_grp, float* out, int B, int N, int T, int win,
                           int shift, int n_fft, int M, int n_w, int groups, int group_size, double pre,
                           void* stream) {
  Args a{wav, window, reinterpret_cast<const double2*>(roots), mel_w, mel_rng, mel_grp, out,
         N, T, win, shift, M, n_w, groups, pre, 0, 0, 0, 0};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (n_fft) {
    case 256: return launch<128>(a, B, group_size, s);
    case 512: return launch<256>(a, B, group_size, s);
    case 1024: return launch<512>(a, B, group_size, s);
    case 2048: return launch<1024>(a, B, group_size, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
