// Device stage marks: the time between marks on a stream, summed by the
// section each mark opens, from inside a replayed CUDA graph.
//
// A graph's replay issues its kernels from one cudaGraphLaunch, so a host
// range cannot split it into stages. A mark is a kernel node of one thread
// captured between two stages: it reads %globaltimer (ns), charges the time
// since the previous mark to the section that mark opened, and opens its
// own. Stream order makes the interval the device time of the kernels
// between the two marks, the gaps between them included.
//
// state (int64 [4]):
//   [0] the open section; -1 none (the next interval is dropped: the host
//       writes it after a capture); -2 a step's end (the next mark charges
//       the interval to its `gap` argument: the time between steps or
//       between batches)
//   [1] %globaltimer at the previous mark
//   [2] the bank, 0 untraced or 1 traced (written by the host when a
//       profiler starts or stops)
//   [3] the bank at the previous mark: an interval across a change of bank
//       is dropped
// totals (int64 [2 banks][2][n_sections]): [bank][0][s] nanoseconds,
// [bank][1][s] intervals.
//
// Cost: one single-thread launch, a few loads and stores in L2: about the
// launch gap of a graph's kernel node. Nothing reads the timer's absolute
// value, only differences.

#include <cuda_runtime.h>

namespace {

constexpr long long kNone = -1;
constexpr long long kEnd = -2;

__global__ void trace_mark_kernel(long long* state, long long* totals, int section, int gap, int n_sections) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long open = state[0];
  const long long bank = state[2];
  if (open != kNone && state[3] == bank && (bank == 0 || bank == 1)) {
    const long long s = open == kEnd ? gap : open;
    if (s >= 0 && s < n_sections) {
      long long* t = totals + bank * 2 * n_sections;
      t[s] += static_cast<long long>(now) - state[1];
      t[n_sections + s] += 1;
    }
  }
  state[0] = section;
  state[1] = static_cast<long long>(now);
  state[3] = bank;
}

}  // namespace

extern "C" const char* e2e_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Loads the kernel (lazy module loading would load it at its first launch,
// which for a mark is inside a capture); called before any capture.
extern "C" int e2e_trace_mark_prepare() {
  cudaFuncAttributes attr;
  return static_cast<int>(cudaFuncGetAttributes(&attr, trace_mark_kernel));
}

extern "C" int e2e_trace_mark(long long* state, long long* totals, int section, int gap, int n_sections,
                              void* stream) {
  trace_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(state, totals, section, gap, n_sections);
  return static_cast<int>(cudaGetLastError());
}
