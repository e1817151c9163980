// Pixel-row gather and scatter on the pixel-major occlusion map, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes
// (dbot_ros_tpu_torch/ops/build.py, wrappers in ops/kernels.py).
//
// Replace the Pallas kernels `gather_pixel_rows` (dbot_ros_tpu/ops/
// raycast_pallas.py:584) and `scatter_pixel_rows` (:508). On the port's
// (n_pad, p_pad) row-major map a pixel's particles are one contiguous
// row, so both are indexed row copies:
//   gather:  out[j, :] = q[sel[j], :]     (duplicate sel entries allowed)
//   scatter: q[sel[j], :] = vals[j, :]    in place; sel entries must be
//            distinct (the compaction ladder's ranks), unselected rows
//            are untouched.
//
// What bounds them on the card: memory bandwidth, 2 · rows · row_bytes
// per call (448 rows of 20 kB at the 10k-particle operating point, about
// 18 MB moved). The design: one block per selected row, each thread
// moving 16-byte vectors, neighbouring threads on neighbouring
// addresses; the row index is read once per block. The wrapper checks
// that row_bytes is a multiple of 16 and the pointers 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_rows_kernel(const uint4* __restrict__ q,
                                   const int* __restrict__ sel,
                                   uint4* __restrict__ out,
                                   long long vec_per_row) {
  const long long src = sel[blockIdx.x];
  const uint4* from = q + src * vec_per_row;
  uint4* to = out + static_cast<long long>(blockIdx.x) * vec_per_row;
  for (long long i = threadIdx.x; i < vec_per_row; i += blockDim.x) {
    to[i] = from[i];
  }
}

__global__ void scatter_rows_kernel(uint4* __restrict__ q,
                                    const uint4* __restrict__ vals,
                                    const int* __restrict__ sel,
                                    long long vec_per_row) {
  const long long dst = sel[blockIdx.x];
  const uint4* from = vals + static_cast<long long>(blockIdx.x) * vec_per_row;
  uint4* to = q + dst * vec_per_row;
  for (long long i = threadIdx.x; i < vec_per_row; i += blockDim.x) {
    to[i] = from[i];
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success).
int dbot_gather_pixel_rows(const void* q, const void* sel, void* out,
                           int n_sel, long long row_bytes, void* stream) {
  if (n_sel <= 0 || row_bytes <= 0 || row_bytes % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  gather_rows_kernel<<<n_sel, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(q), static_cast<const int*>(sel),
      static_cast<uint4*>(out), row_bytes / 16);
  return cudaGetLastError();
}

int dbot_scatter_pixel_rows(void* q, const void* vals, const void* sel,
                            int n_sel, long long row_bytes, void* stream) {
  if (n_sel <= 0 || row_bytes <= 0 || row_bytes % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  scatter_rows_kernel<<<n_sel, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(q), static_cast<const uint4*>(vals),
      static_cast<const int*>(sel), row_bytes / 16);
  return cudaGetLastError();
}

}  // extern "C"
