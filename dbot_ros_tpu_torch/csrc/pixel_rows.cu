// Pixel-row gather and scatter on the pixel-major occlusion map, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes
// (dbot_ros_tpu_torch/ops/build.py, wrappers in ops/kernels.py).
//
// Replace the Pallas kernels `gather_pixel_rows` (dbot_ros_tpu/ops/
// raycast_pallas.py:584) and `scatter_pixel_rows` (:508). On the port's
// (n_pad, p_pad) row-major map a pixel's particles are one contiguous
// row, so both are indexed row copies:
//   gather:  out[j, :] = q[clamp(sel[j], 0, n_rows - 1), :]
//            (duplicate sel entries allowed)
//   scatter: q[sel[j], :] = vals[j, :]    in place; sel entries must be
//            distinct (the compaction ladder's ranks), unselected rows
//            are untouched.
//
// What bounds them on the card: memory bandwidth, 2 · rows · row_bytes
// per call, and nothing else: there is no arithmetic. At the 10k-particle
// operating point a row is 20,224 bytes; the tight ladder level moves
// 448 rows (18.1 MB, 5.4 µs at 3.35 TB/s), the second level 2,432 rows
// (98.4 MB, 29 µs). On the main path the map's rows are cold (the
// lineage gather streams the whole map through the L2 between two
// frames), and at 18 MB a call is mostly latency: the index has to
// arrive before its row can be asked for, and the card only nears its
// rate if every SM has its whole share of the reads in flight at once.
// A device copy of as many contiguous rows, which follows no index, is
// the yardstick (PERF.md §6).
//
// Gather, the design on the path (`gather_rows_registers`): one block per
// selected row reads its index once (clamped into [0, n_rows), so a bad
// index never reads outside the map); each of its 512 threads issues
// its three 16-byte loads (a pass of 1,536 vectors, 24 KB: the whole
// 20 KB row at the operating point) before its first store, neighbouring
// threads on neighbouring addresses. At 448 rows the blocks sit 3 or 4
// to an SM, all resident, so the whole copy is in flight at once, and it
// runs as fast as a device copy of as many contiguous rows, warm and
// cold. The first version (the same grid with 256 threads, each moving
// its 16-byte vectors in a load-then-store loop) kept one load in flight
// per thread; a one-pass grid of 256-thread blocks over the vectors of
// all rows (an index and a division per vector) was slower warm.
//
// Gather, the bulk-copy design (`gather_rows_bulk`), this slice's
// attempt, kept and timed beside it by chip_smoke.py but not on the path:
// it was slower cold at the tight level than the first version and the
// register engine, and no faster than the register engine at the
// second (PERF.md §6). Work items are (row, chunk) pairs: a row cut into
// chunks_per_row chunks of chunk_bytes (the last one shorter), all
// multiples of 16 bytes, dealt in turn to a persistent grid of one-warp
// blocks (two per SM). Lane 0 issues every copy: a cp.async.bulk global
// → shared copy of the item's chunk into a ring slot in dynamic shared
// memory, completion counted in bytes on the slot's mbarrier; once the
// slot is full, a cp.async.bulk shared → global copy of the slot to the
// output row, one bulk group each. A slot is reloaded kLag items after
// its store was issued, when cp.async.bulk.wait_group.read kLag says the
// store has read it. The warp reads the source rows of 32 items at once
// (one clamped index per lane), the first ones while lane 0 sets up the
// barriers. No register touches the data; what it costs is the hop
// through shared memory and one thread issuing a block's copies in turn.
// The wrapper picks the engine and the work split (ops/kernels.py,
// `gather_rows_plan`).
//
// Scatter: one block per selected row, each thread moving 16-byte
// vectors, neighbouring threads on neighbouring addresses; the row index
// is read once per block. Cold it takes little more than a device copy
// of the same bytes and about half of `index_copy_`'s time (PERF.md §6),
// so it keeps the first design.
//
// The wrappers check that row_bytes is a multiple of 16 and the pointers
// 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // scatter
constexpr int kRegThreads = 512;       // gather, register engine: a row
constexpr int kRegUnroll = 3;          // 16-byte loads in flight a thread
constexpr int kMaxSlots = 32;          // bulk engine: ring slots, at most
constexpr int kMaxRingBytes = 112 * 1024;  // bulk engine: shared memory
constexpr int kLag = 4;                // bulk engine: stores in flight
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// global -> shared; dst, src and bytes are multiples of 16. Completion is
// counted in bytes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared -> global, as one bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n"
      :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}

// bytes of the chunk at byte `off` of a row (the last one is shorter)
__device__ __forceinline__ uint32_t item_bytes(long long off, int chunk_bytes,
                                               long long row_bytes) {
  const long long left = row_bytes - off;
  return static_cast<uint32_t>(left < chunk_bytes ? left : chunk_bytes);
}

__global__ void __launch_bounds__(32)
gather_rows_bulk(const unsigned char* __restrict__ q,
                   const int* __restrict__ sel,
                   unsigned char* __restrict__ out, int n_rows,
                   long long row_bytes, int chunk_bytes, int chunks_per_row,
                   long long n_items, int n_slots) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kMaxSlots];
  const int lane = threadIdx.x;
  const long long stride = gridDim.x;
  const long long first = blockIdx.x;
  if (first >= n_items) return;
  const long long mine = (n_items - first + stride - 1) / stride;
  const int used = mine < n_slots ? static_cast<int>(mine) : n_slots;
  // lane l holds the clamped source row of this block's item batch + l
  auto source_row = [&](long long batch) {
    const long long kk = batch + lane;
    if (kk >= mine) return 0;
    const long long j = (first + kk * stride) / chunks_per_row;
    return min(max(__ldg(sel + j), 0), n_rows - 1);
  };
  // the first indices are on their way while the barriers are set up
  long long batch = 0;
  int src_row = source_row(0);
  if (lane == 0) {
    for (int s = 0; s < used; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  auto load = [&](long long k) {   // warp-uniform; k = 0, 1, 2, ...
    if (k - batch >= 32) {
      batch = k;
      src_row = source_row(batch);
    }
    const int r = __shfl_sync(0xffffffffu, src_row, static_cast<int>(k - batch));
    if (lane == 0) {
      const long long i = first + k * stride;
      const long long off =
          static_cast<long long>(i % chunks_per_row) * chunk_bytes;
      const uint32_t bytes = item_bytes(off, chunk_bytes, row_bytes);
      const int slot = static_cast<int>(k % n_slots);
      mbar_expect_tx(&full[slot], bytes);
      bulk_load(ring + static_cast<size_t>(slot) * chunk_bytes,
                q + r * row_bytes + off, bytes, &full[slot]);
    }
  };

  for (int k = 0; k < used; ++k) load(k);
  for (long long k = 0; k < mine; ++k) {
    const int slot = static_cast<int>(k % n_slots);
    mbar_wait(&full[slot], static_cast<uint32_t>((k / n_slots) & 1));
    if (lane == 0) {
      // the load's bytes, seen through the barrier, before the store
      // reads them
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const long long i = first + k * stride;
      const long long j = i / chunks_per_row;
      const long long off =
          static_cast<long long>(i - j * chunks_per_row) * chunk_bytes;
      bulk_store(out + j * row_bytes + off,
                 ring + static_cast<size_t>(slot) * chunk_bytes,
                 item_bytes(off, chunk_bytes, row_bytes));
    }
    // the slot whose store went out kLag items ago takes the item n_slots
    // after it (n_slots > kLag, so it is loaded before it is waited for)
    const long long back = k - kLag;
    if (back >= 0 && back + n_slots < mine) {
      if (lane == 0) {
        asm volatile("cp.async.bulk.wait_group.read %0;\n"
                     :: "n"(kLag) : "memory");
      }
      __syncwarp();
      load(back + n_slots);
    }
  }
  // the ring must outlive the stores' reads (their writes complete with
  // the kernel)
  if (lane == 0) {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

__global__ void __launch_bounds__(kRegThreads)
gather_rows_registers(const uint4* __restrict__ q,
                      const int* __restrict__ sel, uint4* __restrict__ out,
                      int n_rows, long long vec_per_row) {
  const long long r = min(max(__ldg(sel + blockIdx.x), 0), n_rows - 1);
  const uint4* from = q + r * vec_per_row;
  uint4* to = out + static_cast<long long>(blockIdx.x) * vec_per_row;
  for (long long base = threadIdx.x; base < vec_per_row;
       base += kRegThreads * kRegUnroll) {
    uint4 v[kRegUnroll];
#pragma unroll
    for (int u = 0; u < kRegUnroll; ++u) {
      const long long i = base + u * kRegThreads;
      if (i < vec_per_row) v[u] = __ldg(from + i);
    }
#pragma unroll
    for (int u = 0; u < kRegUnroll; ++u) {
      const long long i = base + u * kRegThreads;
      if (i < vec_per_row) to[i] = v[u];
    }
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

// Returns cudaGetLastError() after the launch (0 = success). q is
// (n_rows, row_bytes) and out (n_sel, row_bytes), row-major; the plan
// (engine, chunk_bytes, n_slots, grid) comes from the wrapper.
int dbot_gather_pixel_rows(const void* q, const void* sel, void* out,
                           int n_sel, int n_rows, long long row_bytes,
                           int bulk, int chunk_bytes, int n_slots, int grid,
                           void* stream) {
  if (n_sel <= 0 || n_rows <= 0 || row_bytes <= 0 || row_bytes % 16 != 0 ||
      grid <= 0) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bulk) {
    if (grid != n_sel) return cudaErrorInvalidValue;  // a block per row
    gather_rows_registers<<<n_sel, kRegThreads, 0, s>>>(
        static_cast<const uint4*>(q), static_cast<const int*>(sel),
        static_cast<uint4*>(out), n_rows, row_bytes / 16);
    return cudaGetLastError();
  }
  if (chunk_bytes <= 0 || chunk_bytes % 16 != 0 || chunk_bytes > row_bytes ||
      n_slots <= kLag || n_slots > kMaxSlots ||
      static_cast<long long>(n_slots) * chunk_bytes > kMaxRingBytes) {
    return cudaErrorInvalidValue;
  }
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(gather_rows_bulk,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxRingBytes);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const int chunks_per_row =
      static_cast<int>((row_bytes + chunk_bytes - 1) / chunk_bytes);
  gather_rows_bulk<<<grid, 32, static_cast<size_t>(n_slots) * chunk_bytes,
                       s>>>(
      static_cast<const unsigned char*>(q), static_cast<const int*>(sel),
      static_cast<unsigned char*>(out), n_rows, row_bytes, chunk_bytes,
      chunks_per_row, static_cast<long long>(n_sel) * chunks_per_row,
      n_slots);
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
