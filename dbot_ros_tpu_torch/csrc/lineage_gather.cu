// Particle-lineage gather on the pixel-major occlusion map, for Hopper
// (sm_90a). Plain C interface, loaded with ctypes
// (dbot_ros_tpu_torch/ops/build.py, wrapper in ops/kernels.py).
//
// Replaces the Pallas kernel `lineage_gather_pallas` (dbot_ros_tpu/ops/
// raycast_pallas.py:430): after resampling, every pixel row of the
// (n_rows, p_pad) map is re-indexed along the particle axis,
//   out[n, c] = q[n, idx[c]]        for every row n and column c,
// out of place (the old map is read while the new one is written).
// The TPU kernel routed 128-lane groups through one-hot matrices on its
// matrix unit and only worked when each group drew from at most two
// source groups. None of that is carried over: this kernel is exact for
// any idx, sorted or not, for 2-byte (bfloat16) and 4-byte (float32)
// elements, which it moves as raw bits.
//
// What bounds it on the card: memory bandwidth. The map is read once and
// written once (2 x 4800 x 10112 x 2 B = 194 MB at the 10k-particle
// operating point); there is no arithmetic.
//
// Design. Parents of systematic resampling are non-decreasing, so the
// sources of a tile of consecutive output columns lie in one contiguous
// window [min idx, max idx] of the row, usually about as wide as the
// tile. One block takes one column tile (kThreads x 16 bytes of output
// per row) of kRows consecutive rows:
//   1. each thread loads the indices of its 16 output bytes once, and
//      the block reduces their minimum and maximum (so unsorted idx is
//      handled, not assumed away);
//   2. where the window fits the staging buffer (kWinVecs 16-byte
//      vectors per row), the window of all kRows rows is copied to
//      shared memory with coalesced 16-byte loads from an aligned start
//      (the window begins at an arbitrary element, so the start is
//      rounded down to a 16-byte boundary and the pick is shifted), and
//      each thread picks its elements from shared memory;
//   3. where it does not fit (scattered parents), the same kernel reads
//      the elements straight from global memory;
//   4. each thread writes its 16 bytes with one vector store, neighbouring
//      threads on neighbouring addresses.
// Indices are clamped into [0, p_pad) in the kernel, so a bad index can
// not read outside the map. The wrapper checks that rows are multiples of
// 16 bytes and the pointers 16-byte aligned.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 8;                  // rows staged per block
constexpr int kWinVecs = 2 * kThreads;    // 16-byte vectors per staged row

template <typename T>
__global__ void __launch_bounds__(kThreads)
lineage_gather_kernel(const T* __restrict__ q, const int* __restrict__ idx,
                      T* __restrict__ out, int n_rows, int p_pad,
                      int col_tiles) {
  constexpr int kVec = 16 / sizeof(T);    // elements per 16-byte vector
  constexpr int kTile = kThreads * kVec;  // output columns per block
  __shared__ uint4 win[kRows][kWinVecs];
  __shared__ int red_lo[kThreads / 32];
  __shared__ int red_hi[kThreads / 32];

  const int col_tile = blockIdx.x % col_tiles;
  const int row_tile = blockIdx.x / col_tiles;
  const int c0 = col_tile * kTile + threadIdx.x * kVec;
  const bool active = c0 < p_pad;         // p_pad is a multiple of kVec

  int src[kVec];
  int lo = INT_MAX;
  int hi = 0;
  if (active) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int s = min(max(idx[c0 + k], 0), p_pad - 1);
      src[k] = s;
      lo = min(lo, s);
      hi = max(hi, s);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if ((threadIdx.x & 31) == 0) {
    red_lo[threadIdx.x >> 5] = lo;
    red_hi[threadIdx.x >> 5] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    lo = min(lo, red_lo[w]);
    hi = max(hi, red_hi[w]);
  }
  // thread 0 of every block is active, so lo <= hi < p_pad here
  const int lo_a = lo / kVec * kVec;      // 16-byte aligned window start
  const int n_vec = (hi - lo_a) / kVec + 1;

  const int r0 = row_tile * kRows;
  const int rows = min(kRows, n_rows - r0);
  const size_t stride = static_cast<size_t>(p_pad);

  if (n_vec <= kWinVecs) {
    for (int r = 0; r < rows; ++r) {
      const uint4* from = reinterpret_cast<const uint4*>(
          q + (r0 + r) * stride + lo_a);
      for (int v = threadIdx.x; v < n_vec; v += kThreads) {
        win[r][v] = from[v];
      }
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          const T* w = reinterpret_cast<const T*>(win[r]);
          alignas(16) T vals[kVec];
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            vals[k] = w[src[k] - lo_a];
          }
          *reinterpret_cast<uint4*>(out + (r0 + r) * stride + c0) =
              *reinterpret_cast<const uint4*>(vals);
        }
      }
    }
  } else if (active) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        const T* row = q + (r0 + r) * stride;
        alignas(16) T vals[kVec];
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          vals[k] = __ldg(row + src[k]);
        }
        *reinterpret_cast<uint4*>(out + (r0 + r) * stride + c0) =
            *reinterpret_cast<const uint4*>(vals);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* idx, void* out, int n_rows, int p_pad,
           void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kTile = kThreads * kVec;
  if (n_rows <= 0 || p_pad <= 0 || p_pad % kVec != 0) {
    return cudaErrorInvalidValue;
  }
  const int col_tiles = (p_pad + kTile - 1) / kTile;
  const long long row_tiles = (n_rows + kRows - 1) / kRows;
  const long long blocks = row_tiles * col_tiles;
  if (blocks > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  lineage_gather_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const int*>(idx),
      static_cast<T*>(out), n_rows, p_pad, col_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Both return cudaGetLastError() after the launch (0 = success).
// q, out: (n_rows, p_pad) row-major, distinct buffers; idx: (p_pad,) int32.
int dbot_lineage_gather_b16(const void* q, const void* idx, void* out,
                            int n_rows, int p_pad, void* stream) {
  return launch<uint16_t>(q, idx, out, n_rows, p_pad, stream);
}

int dbot_lineage_gather_b32(const void* q, const void* idx, void* out,
                            int n_rows, int p_pad, void* stream) {
  return launch<uint32_t>(q, idx, out, n_rows, p_pad, stream);
}

}  // extern "C"
