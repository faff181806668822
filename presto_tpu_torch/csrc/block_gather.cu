// block_gather: the rows of a word matrix at ascending indices, byte for
// byte.
//
//   out[i, :] = src[sidx[i], :]
//   src [n, w] 32-bit words row-major, sidx [m] int32 ascending and in
//   [0, n), out [m, w].
//
// Replaces the Pallas TPU kernel presto_tpu/exec/gather.py
// _blocked_gather_call.  That kernel pulled one aligned window of a
// static size W through VMEM per grid step, because a Pallas grid step has
// one static block shape, and the reference ran it only when EVERY block's
// indices fit their window (one all-or-nothing check, else the plain
// gather for the whole launch).  Here each thread block decides alone.
//
// What bounds it: device-memory bytes.  The function must read the m
// indices, write the m x w output words, and read each needed source row
// once; it does no arithmetic worth counting.  The design:
//   - one thread block per `ib` consecutive sorted indices; the block reads
//     its first and last index, so its rows lie in [lo, hi];
//   - if those span rows fit the block's shared memory (`smem_rows`), the
//     block copies the source rows [lo, hi] into shared memory as one
//     contiguous run of span * w words, neighbouring threads on
//     neighbouring words (each needed row read once, sequentially), and
//     then writes its ib x w output words from shared memory;
//   - otherwise (skewed or sparse indices) it reads each word straight
//     from device memory;
//   - either way neighbouring threads write neighbouring output words, so
//     the stores are coalesced.  The choice is uniform over the block and
//     needs no host sync; both branches give the same bytes.
//
// Left for later: 16-byte vector loads, TMA bulk copies and a ring of
// spans; the integer division by w per word.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void block_gather_kernel(const unsigned* __restrict__ src,
                                    const int* __restrict__ sidx,
                                    long long m, int w, int ib,
                                    int smem_rows,
                                    unsigned* __restrict__ out,
                                    int* __restrict__ staged_blocks) {
  extern __shared__ unsigned rows[];
  const long long i0 = (long long)blockIdx.x * ib;
  const int count = (int)min((long long)ib, m - i0);
  const int* idx = sidx + i0;
  unsigned* dst = out + i0 * w;
  const int lo = idx[0];
  const long long span = (long long)idx[count - 1] - lo + 1;
  const int total = count * w;
  if (span <= smem_rows) {
    const unsigned* window = src + (long long)lo * w;
    const int words = (int)span * w;
    for (int c = threadIdx.x; c < words; c += blockDim.x) rows[c] = window[c];
    __syncthreads();
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int r = t / w;
      dst[t] = rows[(idx[r] - lo) * w + (t - r * w)];
    }
    if (staged_blocks != nullptr && threadIdx.x == 0) {
      atomicAdd(staged_blocks, 1);
    }
  } else {
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int r = t / w;
      dst[t] = src[(long long)idx[r] * w + (t - r * w)];
    }
  }
}

}  // namespace

// Launches the kernel on `stream`; returns the CUDA error code (0 on
// success).  The caller guarantees m >= 1, w >= 1 and n >= 1, allocates
// out [m, w], and passes staged_blocks as a zeroed device int or null.
extern "C" int block_gather_u32(const unsigned* src, const int* sidx,
                                long long m, int w, int ib, int smem_rows,
                                unsigned* out, int* staged_blocks,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(unsigned) * (size_t)smem_rows * (size_t)w;
  cudaError_t err = cudaFuncSetAttribute(
      block_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (m + ib - 1) / ib;
  block_gather_kernel<<<(unsigned)blocks, kThreads, smem, s>>>(
      src, sidx, m, w, ib, smem_rows, out, staged_blocks);
  return (int)cudaGetLastError();
}

extern "C" const char* presto_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
