// CTC alpha/beta lattice over the 2L+1 blank-interleaved label states.
//
// Replaces the TPU kernel e2e_asr_tpu/ops/ctc_pallas.py ctc_loss_pallas
// (_kernel / _ctc_pallas_raw). Same contract: blank 0; log_probs [B, T, V]
// are log-softmax outputs; lattice state s < S = 2L+1 carries label
// ext[s] = labels[(s-1)/2] at odd s and blank at even s; alpha rows past
// input_len are NEG; a row's beta stays beta_init until t passes
// input_len-1; label_len = 0 rows take the blank path only; the s-2 skip is
// forbidden between repeated labels and into blanks; NEG = -1e30 with the
// m > NEG/2 guard in every log-sum-exp. Outputs nll [B] (1e30 where no path
// exists; the wrapper turns > 1e29 into +inf) and gamma [B, T, S] =
// alpha + beta - logZ, from which d nll / d lp_ext = -exp(gamma) follows.
// Unlike the TPU kernel, it gathers the lattice emissions from log_probs
// itself (lp[b, t, ext[s]]), so no [B, T, S] emission tensor is built; the
// gradient's route back to the vocabulary stays in PyTorch (scatter_add_).
//
// What bounds it on the H100: the recursion. Each of the T steps depends on
// the last, and one utterance's lattice is at most a few hundred states, so
// a step is one short vector op plus a block barrier: latency, not bytes
// (the gamma rows it writes are ~5 MB at the flagship shapes) or FLOPs.
// Design: one block per utterance (B blocks), lattice states across
// threads; alpha and beta are double-buffered in shared memory, so each
// time step costs one __syncthreads. Rows past input_len are written
// without recursion (the lattice is frozen there), so the work follows this
// batch's lengths. The emissions of a step are gathered from L1/L2 (a row
// of log_probs is V floats).

#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1.0e30f;

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

__global__ void __launch_bounds__(1024)
ctc_lattice_kernel(const float* __restrict__ lp, const int* __restrict__ labels,
                   const int* __restrict__ input_len, const int* __restrict__ label_len,
                   float* __restrict__ nll, float* __restrict__ gamma, int T, int V, int L,
                   int S) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int inlen = input_len[b];
  const int lablen = label_len[b];
  const int end = 2 * lablen;
  const float* lpb = lp + (long)b * T * V;
  float* gb = gamma + (long)b * T * S;

  extern __shared__ float smem[];
  float* buf = smem;                           // [2][S + 2]: alpha, then beta
  int* ext = reinterpret_cast<int*>(buf + 2 * (S + 2));  // [S]
  int* skip = ext + S;                          // [S + 2], skip[s]: s-2 -> s legal
  __shared__ float log_z;

  for (int s = tid; s < S; s += nt) {
    ext[s] = (s & 1) ? labels[(long)b * L + (s - 1) / 2] : 0;
  }
  __syncthreads();
  for (int s = tid; s < S + 2; s += nt) {
    skip[s] = s >= 2 && s < S && ext[s] != 0 && ext[s] != ext[s - 2];
  }

  // ---- forward: alpha rows into gamma
  float* cur = buf;
  float* nxt = buf + (S + 2);
  for (int s = tid; s < S; s += nt) {
    const bool start = s == 0 || (s == 1 && lablen > 0);
    const float a0 = start ? lpb[ext[s]] : NEG;
    cur[s] = a0;
    gb[s] = inlen > 0 ? a0 : NEG;
  }
  __syncthreads();
  for (int t = 1; t < inlen && t < T; ++t) {
    const float* lpt = lpb + (long)t * V;
    float* gt = gb + (long)t * S;
    for (int s = tid; s < S; s += nt) {
      const float a1 = s >= 1 ? cur[s - 1] : NEG;
      const float a2 = skip[s] ? cur[s - 2] : NEG;
      const float v = lse3(cur[s], a1, a2) + lpt[ext[s]];
      nxt[s] = v;
      gt[s] = v;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // frozen rows: alpha is NEG there
  for (int t = max(inlen, 1); t < T; ++t) {
    for (int s = tid; s < S; s += nt) gb[(long)t * S + s] = NEG;
  }

  // ---- logZ from alpha at t = input_len-1, s in {2L, 2L-1}
  if (tid == 0) {
    const float pe = cur[end];
    const float pp = lablen > 0 ? cur[end - 1] : NEG;
    log_z = lse2(pe, pp);
    nll[b] = -log_z;
  }
  __syncthreads();
  const float lz = log_z;

  // ---- backward: beta rows; gamma = alpha + beta - logZ for t <= inlen-1
  float* bc = nxt;  // the buffer alpha no longer needs
  float* bn = cur;
  for (int s = tid; s < S + 2; s += nt) {
    bc[s] = (s < S && (s == end || (s == end - 1 && lablen > 0))) ? 0.0f : NEG;
  }
  __syncthreads();
  if (inlen >= 1 && inlen <= T) {
    float* gt = gb + (long)(inlen - 1) * S;
    for (int s = tid; s < S; s += nt) gt[s] = gt[s] + bc[s] - lz;
  }
  for (int t = min(inlen, T) - 2; t >= 0; --t) {
    const float* lpt1 = lpb + (long)(t + 1) * V;
    float* gt = gb + (long)t * S;
    for (int s = tid; s < S; s += nt) {
      const float b0 = bc[s] + lpt1[ext[s]];
      const float b1 = s + 1 < S ? bc[s + 1] + lpt1[ext[s + 1]] : NEG;
      const float b2 = skip[s + 2] ? bc[s + 2] + lpt1[ext[s + 2]] : NEG;
      const float v = lse3(b0, b1, b2);
      bn[s] = v;
      gt[s] = gt[s] + v - lz;
    }
    __syncthreads();
    float* tmp = bc;
    bc = bn;
    bn = tmp;
  }
}

}  // namespace

extern "C" const char* e2e_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// log_probs [B, T, V] f32, labels [B, L] i32, input_len [B] i32,
// label_len [B] i32 -> nll [B] f32, gamma [B, T, S] f32 with S = 2L+1.
extern "C" int e2e_ctc_lattice(const float* lp, const int* labels, const int* input_len,
                               const int* label_len, float* nll, float* gamma, int B, int T,
                               int V, int L, void* stream) {
  const int S = 2 * L + 1;
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * 2 * (size_t)(S + 2) + sizeof(int) * (2 * (size_t)S + 2);
  cudaError_t e = cudaFuncSetAttribute(ctc_lattice_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = min(1024, ((S + 31) / 32) * 32);
  ctc_lattice_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(lp, labels, input_len, label_len,
                                                                  nll, gamma, T, V, L, S);
  return (int)cudaGetLastError();
}
