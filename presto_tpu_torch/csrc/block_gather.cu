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
// gather for the whole launch).  Here each tile decides alone, on the
// device, with no host sync.
//
// What bounds it: device-memory bytes.  The function must read the m
// indices, write the m x w output words, and read each needed source row
// once; it does no arithmetic worth counting.  The heaviest gathers are
// bound by their stores (TPC-H Q5 at SF1 writes 432 MB from a 720 KB
// source that sits in L2).  The design:
//   - persistent blocks: the grid (the host's launch plan,
//     exec/gather.py::block_gather_launch_shape) fills the card at the
//     plan's residency, and each block walks tiles of kTile consecutive
//     sorted indices, blockIdx.x, blockIdx.x + gridDim.x, ...;
//   - indices read once: each thread loads its kTile / kThreads indices
//     of the tile after next into registers (coalesced), parks them in
//     shared memory one tile later, so their latency hides behind a
//     tile's stores; three index buffers make one __syncthreads a tile
//     enough;
//   - dense tiles go through a ring of two stages: when the rows a tile
//     spans fit a stage, one thread issues one TMA bulk copy of the
//     span's bytes (cp.async.bulk, completion on the stage's mbarrier),
//     widened to 16-byte boundaries and clamped at the end of src (the
//     wrapper refuses a source that does not start on one); the words of
//     the clamped tail are read with plain loads.  Tile t+1's copy is in
//     flight while tile t is written;
//   - 16-byte stores: a tile's output is one contiguous run of count * w
//     words that starts on a 16-byte boundary (kTile is a multiple of 4,
//     and the wrapper allocates out), so each thread writes 4 words a
//     store; only the last tile's odd tail takes 4-byte stores.  A
//     vector is read from the stage as 4 / V loads of V words, V the
//     widest of 4, 2, 1 that divides w (every V-word piece of a row then
//     sits on a 4 V-byte boundary of the stage);
//   - no division per word: a thread maps its first word to (row, column)
//     once, then steps by a constant (rows, columns) pair the host
//     computes;
//   - sparse tiles (the span does not fit a stage; the plan gives no
//     ring at all when the indices fall a 32-byte sector or more apart,
//     since a span's copy would move more than the sectors its rows
//     touch) read each row with V-word loads, four loads in flight a
//     thread, and store at the same width;
//   - the choice between the two is uniform over the block, computed from
//     the tile's first and last index by every thread alike.  Both give
//     the same bytes.
//
// The launch plan (tile size, stage bytes, blocks, shared-memory bytes,
// vector width) is the host's; block_gather_bounds reports the
// compile-time bounds it must fit, and block_gather_u32 refuses a plan
// outside them.  The plan assumes an H100's 228 KB of shared memory an
// SM, and __launch_bounds__ caps the residency at kMinBlocksPerSm.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // sorted indices a tile
constexpr int kIdxPerThread = kTile / kThreads;
constexpr int kIdxBuffers = 3;
constexpr int kStages = 2;
constexpr int kMinBlocksPerSm = 4;     // __launch_bounds__: <= 64 registers
constexpr int kMaxSmemBytes = 232448;  // 227 KB, an H100 block's most
constexpr int kUnroll = 4;             // sparse rows in flight a thread
constexpr int kBarrierBytes = 16;      // two 8-byte mbarriers
constexpr int kMaxDevices = 64;
static_assert(kTile % kThreads == 0 && kTile % 4 == 0,
              "whole indices a thread; tile outputs start 16-byte aligned");

// the plan's shared-memory bytes: the ring, the index buffers, the
// barriers
__host__ __device__ constexpr long long smem_for(long long stage_bytes) {
  return kStages * stage_bytes + kIdxBuffers * kTile * 4LL + kBarrierBytes;
}

// A tile's TMA copy: the byte offset into src where it starts, its bytes
// (0: nothing to copy) and the byte offset of row lo's first word in the
// stage.  exec/gather.py::copy_window is the same arithmetic, tested on
// the CPU, and chip_smoke.py holds its count of staged tiles against
// this kernel's.
struct Window {
  long long start;
  long long bytes;
  long long first;
};

__device__ __forceinline__ Window copy_window(long long lo, long long hi,
                                              int w, long long n) {
  const long long fb = lo * w * 4;
  const long long start = fb & ~15LL;
  long long end = ((hi + 1) * w * 4 + 15) & ~15LL;
  const long long last = (n * w * 4) & ~15LL;
  if (end > last) end = last;
  Window win;
  win.start = start;
  win.bytes = end > start ? end - start : 0;
  win.first = fb - start;
  return win;
}

__device__ __forceinline__ bool staged(const Window& win, int stage_bytes) {
  return win.bytes > 0 && win.bytes <= stage_bytes;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one thread: copy a tile's window into its stage, completion on bar
__device__ __forceinline__ void issue_copy(const int* src, const Window& win,
                                           int* stage, uint32_t bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :
               : "r"(bar), "r"((uint32_t)win.bytes)
               : "memory");
  const char* from = reinterpret_cast<const char*>(src) + win.start;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :
      : "r"(smem_addr(stage)), "l"(from), "r"((uint32_t)win.bytes),
        "r"(bar)
      : "memory");
}

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = int;
};
template <>
struct Vec<2> {
  using T = int2;
};
template <>
struct Vec<4> {
  using T = int4;
};

// The per-kernel constants the host computes: how far a thread's
// (row, column) moves between its dense 4-word vectors (4 * kThreads
// words) and between its sparse V-word units (kThreads units).
struct Steps {
  int dense_rows, dense_cols;
  int sparse_rows, sparse_units;
};

template <int V>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
    block_gather_kernel(const int* __restrict__ src,
                        const int* __restrict__ sidx, long long n,
                        long long m, int w, int stage_bytes,
                        long long tiles, Steps steps,
                        int* __restrict__ out,
                        int* __restrict__ staged_tiles) {
  using VT = typename Vec<V>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  auto ring = [&](int s) {
    return reinterpret_cast<int*>(smem + s * stage_bytes);
  };
  int* ibuf = reinterpret_cast<int*>(smem + kStages * stage_bytes);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(ibuf + kIdxBuffers * kTile);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :
                   : "r"(smem_addr(bars + s))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  int pre[kIdxPerThread];
  auto fetch = [&](long long t) {
    const long long i0 = t * kTile;
#pragma unroll
    for (int j = 0; j < kIdxPerThread; ++j) {
      const long long i = i0 + tid + j * kThreads;
      pre[j] = i < m ? __ldg(sidx + i) : 0;
    }
  };
  auto park = [&](int b) {
#pragma unroll
    for (int j = 0; j < kIdxPerThread; ++j) {
      ibuf[b * kTile + tid + j * kThreads] = pre[j];
    }
  };
  auto tile_count = [&](long long t) {
    return (int)min((long long)kTile, m - t * kTile);
  };
  auto window_of = [&](const int* idx, int count) {
    return copy_window(idx[0], idx[count - 1], w, n);
  };

  // a thread's first dense vector (word 4 tid) and sparse unit (tid)
  const int units_per_row = w / V;
  const int r0 = (4 * tid) / w, c0 = (4 * tid) % w;
  const int u_r0 = tid / units_per_row, u_j0 = tid % units_per_row;

  long long t = blockIdx.x;
  if (t >= tiles) return;
  fetch(t);
  park(0);
  if (t + gridDim.x < tiles) fetch(t + gridDim.x);
  __syncthreads();  // tile 0's indices and the barriers are ready
  if (tid == 0) {
    const Window win = window_of(ibuf, tile_count(t));
    if (staged(win, stage_bytes)) {
      issue_copy(src, win, ring(0), smem_addr(bars));
    }
  }
  uint32_t phases = 0;

  for (int k = 0; t < tiles; ++k, t += gridDim.x) {
    const int s = k & 1;
    const int b = k % kIdxBuffers;
    const int bn = (k + 1) % kIdxBuffers;
    const long long tn = t + gridDim.x;
    if (tn < tiles) {
      park(bn);  // tile k+1's indices, loaded one tile ago
      if (tn + gridDim.x < tiles) fetch(tn + gridDim.x);
    }
    // tile k+1's indices are parked; every thread is done with tile k-1,
    // so its stage and index buffer are free
    __syncthreads();
    if (tid == 0 && tn < tiles) {
      const Window win = window_of(ibuf + bn * kTile, tile_count(tn));
      if (staged(win, stage_bytes)) {
        issue_copy(src, win, ring(s ^ 1), smem_addr(bars + (s ^ 1)));
      }
    }

    const int* idx = ibuf + b * kTile;
    const int count = tile_count(t);
    const long long i0 = t * kTile;
    int* dst = out + i0 * w;
    const int total = count * w;
    const Window win = window_of(idx, count);
    if (staged(win, stage_bytes)) {
      mbar_wait(smem_addr(bars + s), (phases >> s) & 1u);
      phases ^= 1u << s;
      const int* rows = ring(s);
      const int lo = idx[0];
      const unsigned words = (unsigned)(win.bytes >> 2);
      const int first = (int)(win.first >> 2);
      auto word = [&](int row, int base, int c) {
        const int o = base + c;
        return (unsigned)o < words ? rows[o]
                                   : __ldg(src + (long long)row * w + c);
      };
      const int nv = total >> 2;
      int4* dst4 = reinterpret_cast<int4*>(dst);
      int r = r0, c = c0;
      for (int v = tid; v < nv; v += kThreads) {
        int rr = r, cc = c;
        int row = idx[rr];
        int base = (row - lo) * w + first;
        // the vector's 4 words as 4 / V pieces of V words, each within
        // one row and on a 4V-byte boundary of the stage
        alignas(16) int vals[4];
#pragma unroll
        for (int p = 0; p < 4 / V; ++p) {
          const int o = base + cc;
          if (o + V <= (int)words) {
            *reinterpret_cast<VT*>(vals + p * V) =
                *reinterpret_cast<const VT*>(rows + o);
          } else {  // a tail the clamp left outside the copy
#pragma unroll
            for (int q = 0; q < V; ++q) {
              vals[p * V + q] = word(row, base, cc + q);
            }
          }
          cc += V;
          if (p < 4 / V - 1 && cc == w) {
            cc = 0;
            row = idx[++rr];
            base = (row - lo) * w + first;
          }
        }
        dst4[v] = *reinterpret_cast<const int4*>(vals);
        r += steps.dense_rows;
        c += steps.dense_cols;
        if (c >= w) {
          c -= w;
          ++r;
        }
      }
      if (tid < (total & 3)) {  // the last tile's odd tail
        const int q = (nv << 2) + tid;
        const int rr = q / w, cc = q - rr * w;
        const int row = idx[rr];
        dst[q] = word(row, (row - lo) * w + first, cc);
      }
      if (staged_tiles != nullptr && tid == 0) atomicAdd(staged_tiles, 1);
    } else {
      const int units = count * units_per_row;
      int r = u_r0, j = u_j0;
      for (int u0 = tid; u0 < units; u0 += kUnroll * kThreads) {
        VT v[kUnroll];
        int at[kUnroll];
#pragma unroll
        for (int e = 0; e < kUnroll; ++e) {
          at[e] = r * w + j * V;  // output word within the tile
          if (u0 + e * kThreads < units) {
            v[e] = __ldg(reinterpret_cast<const VT*>(
                src + (long long)idx[r] * w + j * V));
          }
          r += steps.sparse_rows;
          j += steps.sparse_units;
          if (j >= units_per_row) {
            j -= units_per_row;
            ++r;
          }
        }
#pragma unroll
        for (int e = 0; e < kUnroll; ++e) {
          if (u0 + e * kThreads < units) {
            *reinterpret_cast<VT*>(dst + at[e]) = v[e];
          }
        }
      }
    }
  }
}

// Lets the kernel take up to a block's most shared memory on `device`:
// once per device and width, since the attribute is a cap (a launch
// still reserves only its own bytes) and setting it costs host time at
// every launch.
template <int V>
cudaError_t allow_smem(int device) {
  static bool done[kMaxDevices] = {};
  if (device < kMaxDevices && done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      block_gather_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmemBytes);
  if (err == cudaSuccess && device < kMaxDevices) done[device] = true;
  return err;
}

template <int V>
int launch(const int* src, const int* sidx, long long n, long long m, int w,
           int stage_bytes, int blocks, int smem_bytes, int* out,
           int* staged_tiles, int device, cudaStream_t s) {
  const cudaError_t err = allow_smem<V>(device);
  if (err != cudaSuccess) return (int)err;
  const int units_per_row = w / V;
  Steps steps;
  steps.dense_rows = (4 * kThreads) / w;
  steps.dense_cols = (4 * kThreads) % w;
  steps.sparse_rows = kThreads / units_per_row;
  steps.sparse_units = kThreads % units_per_row;
  const long long tiles = (m + kTile - 1) / kTile;
  block_gather_kernel<V><<<blocks, kThreads, smem_bytes, s>>>(
      src, sidx, n, m, w, stage_bytes, tiles, steps, out, staged_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// The compile-time bounds a launch plan must fit: threads a block,
// indices a tile, ring stages, the residency the register bound allows
// (__launch_bounds__), and a block's most shared-memory bytes.
extern "C" void block_gather_bounds(int* threads, int* tile, int* stages,
                                    int* blocks_per_sm, int* max_smem) {
  *threads = kThreads;
  *tile = kTile;
  *stages = kStages;
  *blocks_per_sm = kMinBlocksPerSm;
  *max_smem = kMaxSmemBytes;
}

// Launches the kernel on `stream` of `device` with the host's plan (the
// runtime's current device is set for the launch and put back); returns
// the CUDA error code (0 on success), or -1 when the plan does not fit the
// compile-time bounds or src or out does not start on a 16-byte boundary
// (nothing launched).  The caller guarantees m >= 1, w >= 1 and n >= 1,
// and passes staged_tiles as a zeroed device int or null.
extern "C" int block_gather_u32(const int* src, const int* sidx,
                                long long n, long long m, int w, int tile,
                                int stage_bytes, int stages, int vec_words,
                                int blocks, int smem_bytes, int* out,
                                int* staged_tiles, int device,
                                void* stream) {
  const long long tiles = (m + kTile - 1) / kTile;
  const bool fits =
      tile == kTile && stages == kStages && stage_bytes >= 0 &&
      stage_bytes % 16 == 0 && smem_bytes == smem_for(stage_bytes) &&
      smem_bytes <= kMaxSmemBytes && blocks >= 1 && blocks <= tiles &&
      (vec_words == 1 || vec_words == 2 || vec_words == 4) &&
      w % vec_words == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (!fits) return -1;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (vec_words) {
    case 4:
      rc = launch<4>(src, sidx, n, m, w, stage_bytes, blocks, smem_bytes,
                     out, staged_tiles, device, s);
      break;
    case 2:
      rc = launch<2>(src, sidx, n, m, w, stage_bytes, blocks, smem_bytes,
                     out, staged_tiles, device, s);
      break;
    default:
      rc = launch<1>(src, sidx, n, m, w, stage_bytes, blocks, smem_bytes,
                     out, staged_tiles, device, s);
  }
  if (current != device) cudaSetDevice(current);
  return rc;
}

extern "C" const char* presto_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
