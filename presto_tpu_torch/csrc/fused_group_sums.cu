// fused_group_sums: k segmented sums that share one group-id vector, in
// one pass over the rows, accumulated in f64.
//
//   out[j, g] = sum over i with gid[i] == g of vals[j, i]
//   vals [k, n] row-major (dead rows already zeroed), gid [n] int32
//   in [0, G) (a row with a gid outside it is skipped), out [k, G] f64.
//
// Two entry points share every kernel, templated on the value type:
// fused_group_sums_f64 reads f64 rows, fused_group_sums_f32in f32 rows
// (the float32_compute session property stacks its rows so).  The f32
// one reads each value as it is stored and widens it in registers; the
// sums are the f64 sums of the f32 values either way.
//
// Replaces the Pallas TPU kernel presto_tpu/exec/kernels.py
// fused_group_sums.  It keeps the contract of that kernel's interpreter
// path (one f64 table for the whole input), not the TPU path's per-block
// f32 one-hot matmuls, which existed only because Mosaic has no 64-bit
// types.
//
// What bounds it: HBM bytes.  The function must read vals and gid once
// (k*n*8 + n*4 bytes; 744.1 MB for TPC-H Q1 at SF1, k=15, n=6,000,601)
// and does one add per value, far below the card's f64 rate.  Two paths,
// chosen on the host from the shape alone
// (exec/kernels.py::fused_group_sums_launch_shape):
//
//   registers (G <= 16; TPC-H Q1 has G = 4): no atomics.
//     - each thread keeps acc[kc][GM] in registers (GM = G rounded up to
//       a power of two, kc <= 8, kc * GM <= 32) and adds each value into
//       the slot of its gid with predicated adds; it reads a row's gid
//       once for all kc values;
//     - blockIdx.y cuts the k rows into slices of kc rows, so a slice
//       reads gid (4 B a row) and only its own rows of vals; Q1's 15 rows
//       take two slices (8 and 7 rows), which read gid twice: 24 MB more
//       than the 744.1 MB bound, for half the registers of one slice;
//     - a thread issues all kc loads of a step before it adds, so each
//       step waits for memory once;
//     - vals rows are read as 16-byte vectors of E = 16 / sizeof(T)
//       values (2 doubles, 4 floats).  A row need not start on a 16-byte
//       boundary (f64 rows with n odd, f32 rows with n % 4 != 0), so each
//       row's vectors start at element h (0 <= h < E, from the row's
//       address): every row has V = (n - E + 1) / E vectors, a thread
//       loads gid[i .. i+2E-2] and vector (i+h .. i+h+E-1) of every row,
//       i = E * p.  The elements no vector covers (the h before a row's
//       first vector, the tail) are added by thread 0 of the slice's
//       block 0;
//     - the sum has one fixed order: each thread's rows in grid-stride
//       order, a warp-shuffle tree, the warps of a block in index order,
//       then fgs_merge over blocks in index order.  The launch plan
//       depends on the shape, the element size and the SM count only, and
//       each row's vector offset on its address, so the result is
//       bit-identical from run to run, on any gid distribution, for the
//       same card and the same 16-byte alignment of the vals buffer (a
//       view that starts a few elements further sums the same values in
//       another order).
//   shared_table (16 < G): one f64 table a block, in shared memory.
//     - blockIdx.y cuts the k rows into slices whose kc x G table fits
//       64 KB, so a slice reads gid and only its own rows of vals: there
//       is no tiling over groups that re-reads the input;
//     - the grid fills every SM (blocks per SM from the shared memory a
//       block takes); the [blocks, k, G] partials are summed by fgs_merge.
//
// The launch plan (threads a block aside) is the host's: kc, the slices,
// the blocks and the shared-memory bytes come from it.  This file holds
// only the compile-time bounds a plan must fit (kThreads, and the most
// rows a register slice can hold at each group count), and
// fused_group_sums_bounds reports them so that a caller can check.
//
// Hazards that remain:
//   - the shared_table path adds with shared-memory atomics, which commit
//     in hardware order: the last bits of its sums may vary from run to
//     run (the merge over blocks is ordered);
//   - a table row is 8 * G bytes: G above 29,056 does not fit one block's
//     shared memory, and the wrapper refuses it (the executor's gate stops
//     at G = 4,096);
//   - the launch plan assumes an H100's 228 KB of shared memory per SM.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int GM>
__device__ __forceinline__ void add_to_group(double (&acc)[GM], int g,
                                             double v) {
#pragma unroll
  for (int c = 0; c < GM; ++c) {
    if (g == c) acc[c] += v;
  }
}

// 16 bytes of values: E elements, read with one streaming load
template <typename T>
struct Vec16;

template <>
struct Vec16<double> {
  static constexpr int E = 2;
  double2 v;
  __device__ __forceinline__ void load(const double* p) {
    v = __ldcs(reinterpret_cast<const double2*>(p));
  }
  __device__ __forceinline__ double at(int e) const {
    return e == 0 ? v.x : v.y;
  }
};

template <>
struct Vec16<float> {
  static constexpr int E = 4;
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    v = __ldcs(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ double at(int e) const {
    // widened in registers: the f32 value exactly as an f64
    return static_cast<double>(e == 0 ? v.x : e == 1 ? v.y
                                            : e == 2 ? v.z : v.w);
  }
};

// the element offset (0 <= h < E) at which row r's 16-byte vectors start
template <typename T>
__device__ __forceinline__ int vec_start(const T* r) {
  const unsigned lo = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(r) & 15u);
  return static_cast<int>(((16u - lo) & 15u) / sizeof(T));
}

template <typename T, int GM, int KC>
__global__ void __launch_bounds__(kThreads)
    fgs_register_partials(const T* __restrict__ vals,
                          const int* __restrict__ gid, long long n, int k,
                          int G, int kc, double* __restrict__ partials) {
  constexpr int E = Vec16<T>::E;
  const int j0 = blockIdx.y * kc;
  const int kw = min(kc, k - j0);
  double acc[KC][GM];
#pragma unroll
  for (int j = 0; j < KC; ++j) {
#pragma unroll
    for (int c = 0; c < GM; ++c) acc[j][c] = 0.0;
  }
  // every row has `vecs` aligned vectors: row j covers
  // [h_j, E * vecs + h_j), which ends at or before n for any h_j < E
  const long long vecs = n >= E ? (n - E + 1) / E : 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
#pragma unroll 1
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < vecs; p += stride) {
    const long long i = (long long)E * p;
    int g[2 * E - 1];
#pragma unroll
    for (int e = 0; e < 2 * E - 1; ++e) g[e] = __ldg(gid + i + e);
    // all loads first, then the adds: a load and its adds in one guarded
    // block would wait for memory once per row
    Vec16<T> v[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      if (j < kw) {
        const T* r = vals + (long long)(j0 + j) * n;
        v[j].load(r + i + vec_start(r));
      }
    }
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      if (j < kw) {
        const int h = vec_start(vals + (long long)(j0 + j) * n);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          int ge = g[e];
#pragma unroll
          for (int s = 1; s < E; ++s) {
            if (h == s) ge = g[e + s];
          }
          add_to_group<GM>(acc[j], ge, v[j].at(e));
        }
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    // the elements no vector covers: the h before a row's first vector,
    // and the tail
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      if (j < kw) {
        const T* r = vals + (long long)(j0 + j) * n;
        const long long h = vecs ? vec_start(r) : 0;
        for (long long i = 0; i < h; ++i) {
          add_to_group<GM>(acc[j], gid[i], static_cast<double>(r[i]));
        }
        for (long long i = (long long)E * vecs + h; i < n; ++i) {
          add_to_group<GM>(acc[j], gid[i], static_cast<double>(r[i]));
        }
      }
    }
  }
  __shared__ double warp_sums[kWarps][KC * GM];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < KC; ++j) {
#pragma unroll
    for (int c = 0; c < GM; ++c) {
      double s = acc[j][c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_down_sync(0xffffffffu, s, off);
      }
      if (lane == 0) warp_sums[warp][j * GM + c] = s;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kw * G; t += blockDim.x) {
    const int j = t / G;
    const int g = t - j * G;
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w][j * GM + g];
    partials[((long long)blockIdx.x * k + j0 + j) * G + g] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fgs_table_partials(const T* __restrict__ vals,
                       const int* __restrict__ gid, long long n, int k,
                       int G, int kc, double* __restrict__ partials) {
  extern __shared__ double table[];  // [kw, G]
  const int j0 = blockIdx.y * kc;
  const int kw = min(kc, k - j0);
  const int span = kw * G;
  for (int c = threadIdx.x; c < span; c += blockDim.x) table[c] = 0.0;
  __syncthreads();
  const T* rows = vals + (long long)j0 * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int g = __ldg(gid + i);
    const bool live = (unsigned)g < (unsigned)G;
#pragma unroll 4
    for (int j = 0; j < kw; ++j) {
      // loaded whatever gid says, so the loads need not wait for it
      const double v =
          static_cast<double>(__ldcs(rows + (long long)j * n + i));
      if (live) atomicAdd(&table[j * G + g], v);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < span; c += blockDim.x) {
    const int j = c / G;
    const int g = c - j * G;
    partials[((long long)blockIdx.x * k + j0 + j) * G + g] = table[c];
  }
}

// out[c] = sum over b of partials[b, c], one thread an output, adding
// b = 0, 1, 2, ... in order
__global__ void fgs_merge(const double* __restrict__ partials, int blocks,
                          int kG, double* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= kG) return;
  double s = 0.0;
#pragma unroll 8
  for (int b = 0; b < blocks; ++b) s += partials[(long long)b * kG + c];
  out[c] = s;
}

// KC: the most value rows a slice holds, the template bound of acc[KC][GM]
template <typename T, int GM, int KC>
cudaError_t launch_registers(const T* vals, const int* gid, long long n,
                             int k, int G, int kc, int slices, int blocks,
                             double* partials, cudaStream_t s) {
  if (G > GM || kc < 1 || kc > KC || (long long)kc * slices < k) {
    return cudaErrorInvalidValue;
  }
  dim3 grid(blocks, slices);
  fgs_register_partials<T, GM, KC>
      <<<grid, kThreads, 0, s>>>(vals, gid, n, k, G, kc, partials);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_table(const T* vals, const int* gid, long long n, int k,
                         int G, int kc, int slices, int blocks,
                         int smem_bytes, double* partials, cudaStream_t s) {
  if (kc < 1 || (long long)kc * slices < k ||
      (long long)smem_bytes < (long long)sizeof(double) * kc * G) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      fgs_table_partials<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(blocks, slices);
  fgs_table_partials<T><<<grid, kThreads, smem_bytes, s>>>(
      vals, gid, n, k, G, kc, partials);
  return cudaGetLastError();
}

// the register path's template bounds: {group slots, most rows a slice}
constexpr int kRegisterBounds[][2] = {{1, 8}, {2, 8}, {4, 8}, {8, 4},
                                      {16, 2}};

template <typename T>
cudaError_t launch_registers_at(int group_slots, const T* vals,
                                const int* gid, long long n, int k, int G,
                                int kc, int slices, int blocks,
                                double* partials, cudaStream_t s) {
  switch (group_slots) {
    case 1:
      return launch_registers<T, 1, kRegisterBounds[0][1]>(
          vals, gid, n, k, G, kc, slices, blocks, partials, s);
    case 2:
      return launch_registers<T, 2, kRegisterBounds[1][1]>(
          vals, gid, n, k, G, kc, slices, blocks, partials, s);
    case 4:
      return launch_registers<T, 4, kRegisterBounds[2][1]>(
          vals, gid, n, k, G, kc, slices, blocks, partials, s);
    case 8:
      return launch_registers<T, 8, kRegisterBounds[3][1]>(
          vals, gid, n, k, G, kc, slices, blocks, partials, s);
    case 16:
      return launch_registers<T, 16, kRegisterBounds[4][1]>(
          vals, gid, n, k, G, kc, slices, blocks, partials, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int fused_group_sums_launch(const T* vals, const int* gid, long long n,
                            int k, int G, int path, int group_slots, int kc,
                            int slices, int blocks, int smem_bytes,
                            double* partials, double* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0 && blocks > 0) {
    cudaError_t err = cudaErrorInvalidValue;
    if (path == 0) {
      err = launch_registers_at<T>(group_slots, vals, gid, n, k, G, kc,
                                   slices, blocks, partials, s);
    } else if (path == 1) {
      err = launch_table<T>(vals, gid, n, k, G, kc, slices, blocks,
                            smem_bytes, partials, s);
    }
    if (err != cudaSuccess) return (int)err;
  } else {
    blocks = 0;
  }
  const int kG = k * G;
  fgs_merge<<<(kG + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partials, blocks, kG, out);
  return (int)cudaGetLastError();
}

}  // namespace

// The compile-time bounds a launch plan must fit: threads a block, and
// the most value rows a register-path slice holds at group_slots
// accumulators a row (0 where no kernel has that many slots).
extern "C" void fused_group_sums_bounds(int group_slots, int* threads,
                                        int* max_slice_rows) {
  *threads = kThreads;
  *max_slice_rows = 0;
  for (const auto& b : kRegisterBounds) {
    if (b[0] == group_slots) *max_slice_rows = b[1];
  }
}

// Launches the partials kernel of `path` (0: registers, with group_slots
// accumulators a row; 1: shared_table, with smem_bytes of shared memory a
// block) on a (blocks, slices) grid of kc value rows a slice, then the
// merge, on `stream`; returns the CUDA error code (0 on success).
// partials holds blocks * k * G doubles, allocated by the caller.
// blocks == 0 (n == 0) launches only the merge, which writes zeros.
extern "C" int fused_group_sums_f64(const double* vals, const int* gid,
                                    long long n, int k, int G, int path,
                                    int group_slots, int kc, int slices,
                                    int blocks, int smem_bytes,
                                    double* partials, double* out,
                                    void* stream) {
  return fused_group_sums_launch<double>(vals, gid, n, k, G, path,
                                         group_slots, kc, slices, blocks,
                                         smem_bytes, partials, out, stream);
}

// The same over f32 rows: each value read as stored, widened to f64 in
// registers, summed and merged in f64 (out and partials stay f64).
extern "C" int fused_group_sums_f32in(const float* vals, const int* gid,
                                      long long n, int k, int G, int path,
                                      int group_slots, int kc, int slices,
                                      int blocks, int smem_bytes,
                                      double* partials, double* out,
                                      void* stream) {
  return fused_group_sums_launch<float>(vals, gid, n, k, G, path,
                                        group_slots, kc, slices, blocks,
                                        smem_bytes, partials, out, stream);
}

extern "C" const char* presto_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
