// Particle-lineage gather on the pixel-major occlusion map, for Hopper
// (sm_90a). Plain C interface, loaded with ctypes
// (dbot_ros_tpu_torch/ops/build.py, wrapper in ops/kernels.py).
//
// Replaces the Pallas kernel `lineage_gather_pallas` (dbot_ros_tpu/ops/
// raycast_pallas.py:430): after resampling, every pixel row of the
// (n_rows, p_in) map is re-indexed along the particle axis,
//   out[n, c] = q[n, clamp(idx[c], 0, p_in - 1)]   for every row n and
//                                                   column c < p_out,
// out of place (the old map is read while the new one is written). The
// source and the output may differ in width: the distributed exchanges
// (dbot_ros_tpu_torch/parallel/dist_filter.py) gather C surplus columns
// out of a p_pad(L)-column map, and a p_pad(L)-column map out of a
// concatenation of received blocks. On one card p_in == p_out.
// The TPU kernel routed 128-lane groups through one-hot matrices on its
// matrix unit and only worked when each group drew from at most two
// source groups. None of that is carried over: this kernel is exact for
// any idx, sorted or not, for 2-byte (bfloat16) and 4-byte (float32)
// elements, which it moves as raw bits.
//
// What bounds it on the card: memory bandwidth. The map is written once
// and the columns idx names are read once (at most 2 x 4800 x 10112 x
// 2 B = 194 MB at the 10k-particle operating point); there is no
// arithmetic. Memory moves 32-byte sectors, so the parents of a real
// step (some 1400 distinct columns spread over the row) touch nearly
// every sector: in practice the whole map is read, and the yardstick is
// a plain device copy of the map. What held the first version (one small
// block per 8 rows x 1024 columns, each loading its indices, reducing
// their window, staging and picking strictly in turn) below half the
// write rate was its structure: nothing in flight while a block waited,
// the index work repeated for every row tile, and a tile whose window
// was too wide (the identity padding columns beside real parents)
// reading 2 bytes at a time from global memory.
//
// Design. idx is the same for every row, so all index work is done once
// per block, and the rows then stream through a ring in shared memory:
//   1. A block owns a column tile (up to kThreads x kVpt 16-byte output
//      vectors, the whole row at 10k particles in bfloat16) and every
//      B-th row (B blocks per column tile); the grid holds about two
//      blocks per SM, all resident at once (persistent over rows), and
//      together they sweep the map as one moving band.
//   2. Once per block: each thread loads and clamps the indices of its
//      output vectors and the block reduces their minimum and maximum (so
//      unsorted idx is handled, not assumed away). The source window from
//      the 16-byte boundary below the minimum is cut into 512-byte
//      chunks; the threads mark the chunks some index names, and one
//      warp turns the marks into runs of consecutive needed chunks and
//      the place of every chunk in a compacted staged row. Chunks nobody
//      names are never read: one parent for all reads one chunk a row,
//      and the identity padding columns behind the real particles are a
//      run of their own, however far from the parents they lie. Each
//      thread rewrites its indices as offsets into the staged row and
//      keeps them in registers for all rows.
//   3. One warp only copies: per row, one bulk copy (cp.async.bulk,
//      completion counted in bytes by an mbarrier) per run brings the
//      needed bytes into a ring slot; a stage of the ring holds as many
//      rows as fit, and up to four stages are in flight. The other
//      fifteen warps wait on a stage's "full" barrier, pick their
//      elements from shared memory and write their 16-byte vectors
//      (neighbouring threads on neighbouring addresses, streaming
//      stores), then arrive on the stage's "empty" barrier, on which the
//      copying warp waits before it refills the stage. No block-wide
//      barrier in the loop: loads, picks and stores of different rows
//      overlap.
//   4. A tile whose window spans more than kMaxChunks chunks, or needs
//      more bytes per row than half the ring, reads its elements straight
//      from global memory (scattered parents at a very large p_pad).
// Indices are clamped into [0, p_in) in the kernel, so a bad index can
// not read outside the map. The window, chunk marks and bulk copies work
// in source coordinates (row stride and clamp p_in); the column tiles and
// stores in output coordinates (p_out). The wrapper checks that rows of
// both widths are multiples of 16 bytes and the pointers 16-byte aligned.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 480;        // threads that pick and store
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = kThreads + 32;  // and one warp that only copies
constexpr int kVpt = 3;             // 16-byte output vectors per thread
constexpr int kChunkBytes = 512;    // granule of the needed-bytes map
constexpr int kMaxChunks = 256;     // widest window that can be staged
constexpr int kMaxRuns = kMaxChunks / 2;
constexpr int kMaxStages = 4;
constexpr int kMaxSlots = 32;       // rows in flight per block, at most
constexpr int kRingBytes = 96 * 1024;  // two blocks per SM

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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
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

// One contiguous copy global -> shared; src, dst and bytes are multiples
// of 16. Completion is counted in bytes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kBlock, 2)
lineage_gather_kernel(const T* __restrict__ q, const int* __restrict__ idx,
                      T* __restrict__ out, int n_rows, int p_in,
                      int p_out, int col_tiles, int vecs_per_tile) {
  constexpr int kVec = 16 / sizeof(T);    // elements per 16-byte vector
  constexpr int kChunkElems = kChunkBytes / sizeof(T);
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kMaxStages];   // bytes have landed
  __shared__ __align__(8) uint64_t empty[kMaxStages];  // warps have read
  __shared__ unsigned char need[kMaxChunks];
  __shared__ int chunk_base[kMaxChunks];  // element offset in a staged row
  __shared__ int run_src[kMaxRuns];       // byte offset from the window
  __shared__ int run_dst[kMaxRuns];       // byte offset in a staged row
  __shared__ int run_len[kMaxRuns];       // bytes
  __shared__ int red_lo[kWarps];
  __shared__ int red_hi[kWarps];
  __shared__ int s_runs;
  __shared__ int s_need_bytes;

  const int tid = threadIdx.x;
  const bool picker = tid < kThreads;     // the last warp only copies
  const int col_tile = blockIdx.x % col_tiles;
  const int row_block = blockIdx.x / col_tiles;
  const int n_vecs = p_out / kVec;        // p_out is a multiple of kVec
  const int v0 = col_tile * vecs_per_tile;
  const int v_end = min(v0 + vecs_per_tile, n_vecs);
  // Rows are dealt to the blocks in turn (this one takes row_block,
  // row_block + row_blocks, ...), so that at any time the blocks read and
  // write one moving band of the map, as a plain copy does, and not
  // row_blocks distant streams.
  const int row_blocks = gridDim.x / col_tiles;
  const int my_rows = (n_rows - row_block + row_blocks - 1) / row_blocks;
  const size_t stride_in = static_cast<size_t>(p_in);
  const size_t stride_out = static_cast<size_t>(p_out);
  if (v0 >= v_end || my_rows <= 0) return;  // block-uniform

  // --- once per block: indices, their window, the needed chunks
  int src[kVpt][kVec];
  bool active[kVpt];
  int lo = INT_MAX;
  int hi = 0;
#pragma unroll
  for (int i = 0; i < kVpt; ++i) {
    const int v = v0 + tid + i * kThreads;
    active[i] = picker && v < v_end;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int s =
          active[i] ? min(max(idx[v * kVec + k], 0), p_in - 1) : 0;
      src[i][k] = s;
      if (active[i]) {
        lo = min(lo, s);
        hi = max(hi, s);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (picker && (tid & 31) == 0) {
    red_lo[tid >> 5] = lo;
    red_hi[tid >> 5] = hi;
  }
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < kMaxChunks) need[tid] = 0;    // kThreads >= kMaxChunks
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    lo = min(lo, red_lo[w]);
    hi = max(hi, red_hi[w]);
  }
  // thread 0 of every block is active, so lo <= hi < p_in here
  const int lo_a = lo / kVec * kVec;      // 16-byte aligned window start
  const int span_chunks = (hi - lo_a) / kChunkElems + 1;
  bool staged = span_chunks <= kMaxChunks;

  if (staged) {
#pragma unroll
    for (int i = 0; i < kVpt; ++i) {
      if (active[i]) {
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          need[(src[i][k] - lo_a) / kChunkElems] = 1;
        }
      }
    }
    __syncthreads();
    if (tid < 32) {
      // warp 0 turns the marks into the plan, 32 chunks a round. Every
      // needed chunk is kChunkBytes long except the one cut by the row's
      // end, which is the last, so a chunk's place in the staged row is
      // the count of needed chunks before it; a run starts at a needed
      // chunk whose predecessor is not needed, and ends where the next
      // run starts (the staged row has no gaps).
      const int window_bytes = (p_in - lo_a) * static_cast<int>(sizeof(T));
      const unsigned below = (1u << tid) - 1u;
      int chunks_before = 0;
      int runs = 0;
      bool prev_needed = false;
      for (int c0 = 0; c0 < span_chunks; c0 += 32) {
        const int c = c0 + tid;
        const bool needed = c < span_chunks && need[c] != 0;
        const unsigned mask = __ballot_sync(0xffffffffu, needed);
        const int off = (chunks_before + __popc(mask & below)) * kChunkBytes;
        const bool starts =
            needed && !(tid == 0 ? prev_needed : ((mask >> (tid - 1)) & 1u));
        const unsigned start_mask = __ballot_sync(0xffffffffu, starts);
        if (needed) chunk_base[c] = off / static_cast<int>(sizeof(T));
        if (starts) {
          const int run = runs + __popc(start_mask & below);
          run_src[run] = c * kChunkBytes;
          run_dst[run] = off;
        }
        chunks_before += __popc(mask);
        runs += __popc(start_mask);
        prev_needed = (mask >> 31) & 1u;
      }
      const int last = (window_bytes - 1) / kChunkBytes;  // cut by the row
      const bool last_needed = last < span_chunks && need[last] != 0;
      const int total = chunks_before * kChunkBytes
                        - (last_needed
                               ? (last + 1) * kChunkBytes - window_bytes
                               : 0);
      __syncwarp();
      for (int run = tid; run < runs; run += 32) {
        run_len[run] =
            (run + 1 < runs ? run_dst[run + 1] : total) - run_dst[run];
      }
      if (tid == 0) {
        s_runs = runs;
        s_need_bytes = total;
      }
    }
    __syncthreads();
  }
  const int need_bytes = staged ? s_need_bytes : 0;
  const int n_slots = staged ? min(kMaxSlots, kRingBytes / need_bytes) : 0;
  staged = n_slots >= 2;

  if (staged) {
    const int n_runs = s_runs;
    const int n_stages = min(kMaxStages, n_slots);
    const int rows_per_stage = n_slots / n_stages;
    const int stage_bytes = rows_per_stage * need_bytes;
    // indices -> element offsets in the compacted staged row
#pragma unroll
    for (int i = 0; i < kVpt; ++i) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int rel = src[i][k] - lo_a;
        const int c = rel / kChunkElems;
        src[i][k] = active[i] ? chunk_base[c] + (rel - c * kChunkElems) : 0;
      }
    }
    const int n_groups = (my_rows + rows_per_stage - 1) / rows_per_stage;
    const unsigned char* window =
        reinterpret_cast<const unsigned char*>(q + lo_a);
    const size_t row_bytes = stride_in * sizeof(T);

    if (!picker) {
      // the copying warp: fills stage (group % n_stages) with the rows of
      // `group` as soon as every picking warp has read what it held
      const int lane = tid - kThreads;
      for (int group = 0; group < n_groups; ++group) {
        const int stage = group % n_stages;
        const int use = group / n_stages;
        if (use > 0) {
          mbar_wait(&empty[stage], (use - 1) & 1);
          // order the pickers' reads before the copy engine's writes
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
        const int l0 = group * rows_per_stage;
        const int cnt = min(rows_per_stage, my_rows - l0);
        if (lane == 0) {
          mbar_expect_tx(&full[stage],
                         static_cast<uint32_t>(cnt * need_bytes));
        }
        __syncwarp();
        unsigned char* dst = ring + static_cast<size_t>(stage) * stage_bytes;
        for (int i = lane; i < cnt * n_runs; i += 32) {
          const int rr = i / n_runs;
          const int run = i - rr * n_runs;
          bulk_load(dst + rr * need_bytes + run_dst[run],
                    window + (row_block + (l0 + rr) * row_blocks) * row_bytes
                        + run_src[run],
                    static_cast<uint32_t>(run_len[run]), &full[stage]);
        }
      }
    } else {
      for (int group = 0; group < n_groups; ++group) {
        const int stage = group % n_stages;
        mbar_wait(&full[stage], (group / n_stages) & 1);
        const int l0 = group * rows_per_stage;
        const int cnt = min(rows_per_stage, my_rows - l0);
        const unsigned char* base =
            ring + static_cast<size_t>(stage) * stage_bytes;
        for (int rr = 0; rr < cnt; ++rr) {
          const T* w = reinterpret_cast<const T*>(base + rr * need_bytes);
          T* out_row =
              out + (row_block + (l0 + rr) * row_blocks) * stride_out;
#pragma unroll
          for (int i = 0; i < kVpt; ++i) {
            if (active[i]) {
              alignas(16) T vals[kVec];
#pragma unroll
              for (int k = 0; k < kVec; ++k) {
                vals[k] = w[src[i][k]];
              }
              const int v = v0 + tid + i * kThreads;
              // written once and not read again here: streaming store
              __stcs(reinterpret_cast<uint4*>(out_row + v * kVec),
                     *reinterpret_cast<const uint4*>(vals));
            }
          }
        }
        __syncwarp();  // every lane has read the stage
        if ((tid & 31) == 0) mbar_arrive(&empty[stage]);
      }
    }
  } else if (picker) {
    for (int l = 0; l < my_rows; ++l) {
      const size_t r = row_block + l * row_blocks;
      const T* row = q + r * stride_in;
      T* out_row = out + r * stride_out;
#pragma unroll
      for (int i = 0; i < kVpt; ++i) {
        if (active[i]) {
          alignas(16) T vals[kVec];
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            vals[k] = __ldg(row + src[i][k]);
          }
          const int v = v0 + tid + i * kThreads;
          *reinterpret_cast<uint4*>(out_row + v * kVec) =
              *reinterpret_cast<const uint4*>(vals);
        }
      }
    }
  }
}

constexpr int kMaxDevices = 64;


template <typename T>
int launch(const void* q, const void* idx, void* out, int n_rows, int p_in,
           int p_out, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (n_rows <= 0 || p_in <= 0 || p_in % kVec != 0 || p_out <= 0 ||
      p_out % kVec != 0) {
    return cudaErrorInvalidValue;
  }
  // per device, once: its SM count, and leave for the ring's size
  static int sm_count[kMaxDevices] = {};  // one table per element size
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        lineage_gather_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kRingBytes);
    if (err != cudaSuccess) return err;
    if (count <= 0) return cudaErrorInvalidDevice;
    sm_count[dev] = count;
  }
  const int sms = sm_count[dev];
  // column tiles of equal width, as few as the threads' registers allow;
  // row ranges so that about two blocks per SM share the rows
  const int n_vecs = p_out / kVec;
  const int col_tiles = (n_vecs + kThreads * kVpt - 1) / (kThreads * kVpt);
  const int vecs_per_tile = (n_vecs + col_tiles - 1) / col_tiles;
  const int row_blocks_wanted =
      std::min(n_rows, std::max(1, (2 * sms + col_tiles - 1) / col_tiles));
  // no more blocks than give every block the same number of rows (or one
  // fewer)
  const int rows_per_block =
      (n_rows + row_blocks_wanted - 1) / row_blocks_wanted;
  const long long row_blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  const long long blocks = row_blocks * col_tiles;
  if (blocks > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  lineage_gather_kernel<T><<<static_cast<unsigned>(blocks), kBlock,
                             kRingBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const int*>(idx),
      static_cast<T*>(out), n_rows, p_in, p_out, col_tiles, vecs_per_tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Both return cudaGetLastError() after the launch (0 = success).
// q: (n_rows, p_in), out: (n_rows, p_out), row-major, distinct buffers;
// idx: (p_out,) int32.
int dbot_lineage_gather_b16(const void* q, const void* idx, void* out,
                            int n_rows, int p_in, int p_out, void* stream) {
  return launch<uint16_t>(q, idx, out, n_rows, p_in, p_out, stream);
}

int dbot_lineage_gather_b32(const void* q, const void* idx, void* out,
                            int n_rows, int p_in, int p_out, void* stream) {
  return launch<uint32_t>(q, idx, out, n_rows, p_in, p_out, stream);
}

}  // extern "C"
