// fused_group_sums: k segmented sums that share one group-id vector, in
// one pass over the rows, accumulated in f64.
//
//   out[j, g] = sum over i with gid[i] == g of vals[j, i]
//   vals [k, n] f64 row-major (dead rows already zeroed), gid [n] int32
//   in [0, G) (a row with a gid outside it is skipped), out [k, G] f64.
//
// Replaces the Pallas TPU kernel presto_tpu/exec/kernels.py
// fused_group_sums.  It keeps the contract of that kernel's interpreter
// path (one f64 table for the whole input), not the TPU path's per-block
// f32 one-hot matmuls, which existed only because Mosaic has no 64-bit
// types.
//
// What bounds it: HBM bytes.  The function must read vals and gid once
// (k*n*8 + n*4 bytes; 744.1 MB for TPC-H Q1 at SF1, k=15, n=6,000,601)
// and does one add per value, far below the card's f64 rate.  The design
// answers that with one pass and on-chip accumulators:
//   - blocks grid-stride over the rows; neighbouring threads read
//     neighbouring rows, so every load of a vals row is coalesced;
//   - each block keeps a k x gtile f64 table in shared memory and adds
//     into it with shared-memory atomics, so the sums never touch device
//     memory until the block is done;
//   - each block writes its table to partials[block, k, G]; a second
//     launch sums the partials over blocks in block order.
//   - when k*G*8 bytes exceed the shared-memory budget, blockIdx.y tiles
//     the groups: each y-slice keeps only the groups [g0, g0 + gtile),
//     reads gid in full and vals only for its own rows.
//
// Known hazards, left for a later change:
//   - at Q1's G = 4 every thread adds into the same 60 shared addresses,
//     so the shared atomics serialize; warp-private sub-tables would be
//     the first refinement;
//   - the shared atomics commit in hardware order, so a block's partial
//     sum (and with it the last bits of the result) is not fixed from run
//     to run; only the merge over blocks is;
//   - no vectorised 16-byte loads and no TMA ring yet.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void fgs_block_partials(const double* __restrict__ vals,
                                   const int* __restrict__ gid,
                                   long long n, int k, int G, int gtile,
                                   double* __restrict__ partials) {
  extern __shared__ double table[];  // [k, gw]
  const int g0 = blockIdx.y * gtile;
  const int gw = min(gtile, G - g0);
  for (int c = threadIdx.x; c < k * gw; c += blockDim.x) table[c] = 0.0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int g = gid[i] - g0;
    if ((unsigned)g < (unsigned)gw) {
      for (int j = 0; j < k; ++j) {
        atomicAdd(&table[j * gw + g], vals[(long long)j * n + i]);
      }
    }
  }
  __syncthreads();
  double* out = partials + (long long)blockIdx.x * k * G;
  for (int c = threadIdx.x; c < k * gw; c += blockDim.x) {
    const int j = c / gw;
    const int g = c - j * gw;
    out[(long long)j * G + g0 + g] = table[c];
  }
}

// out[c] = sum over b of partials[b, c], in block order
__global__ void fgs_merge(const double* __restrict__ partials, int blocks,
                          int kG, double* __restrict__ out) {
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < kG;
       c += gridDim.x * blockDim.x) {
    double s = 0.0;
    for (int b = 0; b < blocks; ++b) s += partials[(long long)b * kG + c];
    out[c] = s;
  }
}

}  // namespace

// Launches both kernels on `stream`; returns the CUDA error code (0 on
// success).  partials holds blocks * k * G doubles, allocated by the
// caller.  n == 0 launches only the merge, which writes zeros.
extern "C" int fused_group_sums_f64(const double* vals, const int* gid,
                                    long long n, int k, int G, int blocks,
                                    int gtile, double* partials, double* out,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0 && blocks > 0) {
    const size_t smem = sizeof(double) * (size_t)k * (size_t)gtile;
    cudaError_t err = cudaFuncSetAttribute(
        fgs_block_partials, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(blocks, (G + gtile - 1) / gtile);
    fgs_block_partials<<<grid, kThreads, smem, s>>>(vals, gid, n, k, G,
                                                    gtile, partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  } else {
    blocks = 0;
  }
  const int kG = k * G;
  const int merge_blocks = (kG + kThreads - 1) / kThreads;
  fgs_merge<<<merge_blocks, kThreads, 0, s>>>(partials, blocks, kG, out);
  return (int)cudaGetLastError();
}

extern "C" const char* presto_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
