// Fused candidate raycast + beam likelihood + occlusion posterior, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes
// (dbot_ros_tpu_torch/ops/build.py, wrapper in ops/kernels.py).
//
// Replaces the Pallas kernel `_fused_kernel` (dbot_ros_tpu/ops/
// raycast_pallas.py:192), launched by `fused_loglik_packed` (:640).
//
// For each pixel j and particle p: Möller–Trumbore against the K
// candidate triangles cand[j, :] (barycentric slack, min depth), the
// closed-form lazy aging of the occlusion prior by ages[j] + dt, the
// visible / occluded / background beam densities with NaN point masses
// (truncation normalizer taken as 1), the occlusion posterior stored in
// the map's dtype, and sum_j log p(z_j) per particle.
//
// Layouts (all row-major, contiguous):
//   slabs  (T, 10, p_pad) f32   transformed constants per triangle:
//                               g_u(3) | g_v(3) | g_det(3) | t_num
//   occ    (n, p_pad) bf16|f32  pixel-major occlusion map (one pixel's
//                               particles are contiguous)
//   z (n) f32 with NaN, cand (n, K) i32, rays (n, 3) f32, ages (n) f32,
//   params (16) f32 (make_params_vec), occ_out like occ,
//   partial (n_groups, p_pad) f32 scratch, loglik (p_pad) f32.
//
// What bounds it on the card. By the bytes it has to move (the slabs the
// candidates name once, the map rows in and out) it is a memory kernel,
// but two other walls stand before that one. Written naively, every
// (pixel, particle) re-reads 10 floats per candidate out of L2 although
// neighbouring pixels name the same few triangles, and every
// (pixel, particle) executes some 400 operations (six IEEE divisions,
// three expf, one logf, none fast-math) although most of them either
// depend on the pixel alone or are thrown away by the selects on the
// rows where no particle is on the silhouette (the compaction ladder
// pads its selection with such rows: 368 of 448 at the tight level).
// What is left after the design below is the IEEE arithmetic of the
// pixels that are on the silhouette: the SMs' operation rate, not memory.
// The design removes work without changing any result:
//   * one thread per particle, a block owns 128 particles and every
//     n_groups-th sub-run of kSubRun consecutive pixels, so that the
//     active pixels (which come first in the selection) spread over the
//     blocks while neighbours stay together; the grid is as many blocks
//     as the card holds at once;
//   * a candidate's 10 constants stay in registers, one slot per
//     candidate, as long as following pixels name the same triangle (any
//     slot is searched, the ids are block-uniform); a repeated id within
//     one pixel is intersected once (the minimum is the same);
//   * a slab whose g_det is zero for the whole warp cannot be hit
//     (det is 0 or NaN, never > 1e-12), so the warp skips it: that is the
//     degenerate triangle every off-silhouette pixel names;
//   * the terms that depend on the pixel only (validity flags, the aged
//     chain factor, the occluded body's numerator, the background
//     density and its log, whether the pixel names its predecessor's
//     candidates) are computed once per pixel by one thread, with the
//     same operations in the same order, into shared memory;
//   * where a warp vote finds no lane on the silhouette the beam block is
//     skipped: log p = log(background), posterior = aged prior, exactly
//     what the selects would have kept; the division, the visible body
//     and the occluded body are likewise computed only where a vote (or
//     the pixel's validity) says some lane keeps them; a whole sub-run
//     of pixels that name their predecessor's candidates, none of which
//     the warp can hit, takes a short path of a dozen operations each;
//   * the loop is pipelined by hand: the map values of the next sub-run
//     and the slabs of the next pixel are requested before the current
//     pixel's arithmetic, so their latency hides behind it;
//   * the per-particle sum stays in a register over the block's pixels in
//     a fixed order; the n_groups partial rows are added by a second
//     kernel in a fixed order (no atomics): the result is the same from
//     run to run. That kernel is launched while the first still runs
//     (programmatic dependent launch) and waits for it on the card.
// Built without --use_fast_math: the NaN tests z == z and the exact
// division t = t_num / det must survive. Built with -fmad=false so that
// the arithmetic rounds op by op as the plain PyTorch version does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <algorithm>

namespace {

constexpr float kSqrt2Pi = 2.5066282746310002f;
constexpr float kTiny = 1e-30f;
constexpr float kDetEps = 1e-12f;
constexpr float kNear = 1e-4f;
constexpr float kBig = 1e30f;

constexpr int kThreads = 128;   // particles per block
constexpr int kBatch = 128;     // pixels whose terms are staged at a time
constexpr int kSubRun = 4;      // consecutive pixels dealt to one block
static_assert(kSubRun == 4, "the fast path reads a sub-run as one int4");
constexpr int kMaxCached = 4;   // candidates per pixel kept in registers
constexpr unsigned kFullMask = 0xffffffffu;

// Blocks of one SM at a time: eight (at most 64 registers a thread) while
// the cached constants leave room, four with three or four candidates in
// registers. The grid is sized to fill the card once at this occupancy.
constexpr int blocks_per_sm(int cached) { return cached <= 2 ? 8 : 4; }

constexpr int kZReal = 1;
constexpr int kZValid = 2;
constexpr int kLivePixel = 4;
constexpr int kSameIds = 8;  // the candidates of the block's previous pixel

__device__ __forceinline__ float occ_value(float v) { return v; }
__device__ __forceinline__ float occ_value(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_occ(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_occ(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);  // round to nearest even, as JAX's astype
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// What one pixel contributes to every particle, computed once per pixel.
struct PixelTerms {
  int row[kBatch];        // pixel index j
  int flags[kBatch];      // kZReal | kZValid | kLivePixel
  float dx[kBatch], dy[kBatch], dz[kBatch];
  float zz[kBatch];       // z, or 1 where z is NaN
  float geff[kBatch];     // sign(g) exp(log|g| (age + dt))
  float occ_num[kBatch];  // lam exp(-lam (zz - min_z))
  float w_occ[kBatch];    // tail_weight * (valid ? 1/range : 0)
  float log_bg[kBatch];   // log max(background density, tiny)
  int cand[kBatch * kMaxCached];
};

// Depth along the ray to one triangle's plane, kBig where the ray misses
// it; the division is computed only if some lane of the warp hits.
__device__ __forceinline__ float hit_depth(const float (&s)[10], float dx,
                                           float dy, float dz, float slack) {
  const float u = s[0] * dx + s[1] * dy + s[2] * dz;
  const float v = s[3] * dx + s[4] * dy + s[5] * dz;
  const float det = s[6] * dx + s[7] * dy + s[8] * dz;
  const float tn = s[9];
  const float sgn = sign_of(det);
  const float adet = fabsf(det);
  const float sa = slack * adet;
  const bool valid = (adet > kDetEps) && (sgn * u >= -sa)
                     && (sgn * v >= -sa) && (sgn * (u + v) <= adet + sa)
                     && (sgn * tn > kNear * adet);
  float tk = kBig;
  if (__any_sync(kFullMask, valid)) {
    tk = valid ? tn / det : kBig;
  }
  return tk;
}

// Requests triangle `tid`'s constants of particle `p`.
__device__ __forceinline__ void load_slab(const float* __restrict__ slabs,
                                          int tid, size_t stride, int p,
                                          float (&s)[10]) {
  const float* src = slabs + static_cast<size_t>(tid) * 10 * stride + p;
#pragma unroll
  for (int c = 0; c < 10; ++c) {
    s[c] = src[c * stride];
  }
}

// Whether no lane of the warp can hit this triangle: g_det is zero for
// all of them, so det is 0 or NaN and never exceeds kDetEps.
__device__ __forceinline__ bool cannot_be_hit(const float (&s)[10]) {
  return __all_sync(kFullMask,
                    s[6] == 0.0f && s[7] == 0.0f && s[8] == 0.0f);
}

// Requests the map values of the sub-run of pixels that starts at batch
// entry e0, for particle p.
template <typename OccT>
__device__ __forceinline__ void fetch_occ(const OccT* __restrict__ occ,
                                          const PixelTerms& px, int e0,
                                          size_t stride, int p,
                                          OccT (&dst)[kSubRun]) {
#pragma unroll
  for (int r = 0; r < kSubRun; ++r) {
    if (px.flags[e0 + r] & kLivePixel) {
      dst[r] = occ[static_cast<size_t>(px.row[e0 + r]) * stride + p];
    }
  }
}

// Brings the constants of batch entry e's candidates into the register
// slots, slot k for candidate k (nothing to do where the pixel names the
// previous pixel's candidates): kept where the slot already holds the
// triangle, moved from a later slot that does, else requested from
// memory (`fresh`: whether the warp can hit it is looked at on first
// use, so that nothing waits for the load here). A candidate that repeats
// an earlier one of the same pixel needs no slot. Ids are block-uniform,
// so no branch diverges.
template <int KC>
__device__ __forceinline__ void resolve_slots(
    const float* __restrict__ slabs, const PixelTerms& px, int e,
    size_t stride, int p, float (&slot)[KC][10], int (&slot_id)[KC],
    bool (&slot_dead)[KC], bool (&slot_fresh)[KC]) {
  const int flags = px.flags[e];
  if (!(flags & kLivePixel) || (flags & kSameIds)) return;
  int ids[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    ids[k] = px.cand[e * KC + k];
  }
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const int tid = ids[k];
    bool repeated = false;
#pragma unroll
    for (int m = 0; m < k; ++m) {
      repeated = repeated || (ids[m] == tid);
    }
    if (repeated || slot_id[k] == tid) continue;
    bool found = false;
#pragma unroll
    for (int m = k + 1; m < KC; ++m) {
      if (!found && slot_id[m] == tid) {
#pragma unroll
        for (int c = 0; c < 10; ++c) {
          const float tmp = slot[k][c];
          slot[k][c] = slot[m][c];
          slot[m][c] = tmp;
        }
        const bool dead_k = slot_dead[k];
        const bool fresh_k = slot_fresh[k];
        slot_id[m] = slot_id[k];
        slot_dead[k] = slot_dead[m];
        slot_fresh[k] = slot_fresh[m];
        slot_dead[m] = dead_k;
        slot_fresh[m] = fresh_k;
        found = true;
      }
    }
    if (!found) {
      load_slab(slabs, tid, stride, p, slot[k]);
      slot_fresh[k] = true;
    }
    slot_id[k] = tid;
  }
}

// KC > 0: K == KC candidates, their constants cached in registers.
// KC == 0: any K, constants loaded for every (pixel, candidate).
template <typename OccT, int KC>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(KC))
fused_loglik_kernel(const float* __restrict__ slabs,
                    const OccT* __restrict__ occ,
                    const float* __restrict__ z, const int* __restrict__ cand,
                    const float* __restrict__ rays,
                    const float* __restrict__ ages,
                    const float* __restrict__ params,
                    OccT* __restrict__ occ_out, float* __restrict__ partial,
                    int n, int K, int p_pad) {
  __shared__ __align__(16) PixelTerms px;
  constexpr int kSlots = KC > 0 ? KC : 1;
  // the summing kernel may be scheduled as this one's blocks leave; it
  // waits for the whole grid before it reads
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int p_raw = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p_raw < p_pad;
  const int p = live ? p_raw : p_pad - 1;  // idle lanes still vote
  const int g = blockIdx.y;
  const int n_groups = gridDim.y;

  const float msig = params[0];
  const float sfac = params[1];
  const float wt = params[2];
  const float minz = params[3];
  const float maxz = params[4];
  const float lam = params[5];
  const float p_inv_occ = params[6];
  const float p_inv_vis = params[7];
  const float p_inv_bg = params[8];
  const float occ_pi = params[9];
  const float inv_range = params[11];
  const float occ_lg = params[12];
  const float occ_dtf = params[13];
  const float occ_sgn = params[14];
  const float slack = params[15];

  // this block's pixels: sub-runs g, g + n_groups, g + 2 n_groups, ...
  const int n_sub = (n + kSubRun - 1) / kSubRun;
  const int my_sub = g < n_sub ? (n_sub - g + n_groups - 1) / n_groups : 0;
  const int n_local = my_sub * kSubRun;

  const size_t stride = static_cast<size_t>(p_pad);
  float slot[kSlots][10];
  int slot_id[kSlots];
  bool slot_dead[kSlots];   // no lane of the warp can hit the triangle
  bool slot_fresh[kSlots];  // requested, slot_dead not looked at yet
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    slot_id[k] = -1;
    slot_dead[k] = false;
    slot_fresh[k] = false;
  }

  bool all_dead = false;  // the warp could hit none of the last candidates
  float acc = 0.0f;
  for (int i0 = 0; i0 < n_local; i0 += kBatch) {
    __syncthreads();  // the previous batch has been consumed
    {
      const int e = threadIdx.x;  // kBatch == kThreads: one pixel each
      const int i = i0 + e;
      const int j = ((i / kSubRun) * n_groups + g) * kSubRun + i % kSubRun;
      int flags = 0;
      if (i < n_local && j < n) {
        const float zj = z[j];
        const bool z_real = (zj == zj);
        const bool z_valid = z_real && (zj >= minz) && (zj <= maxz);
        const float zz = z_real ? zj : 1.0f;
        flags = kLivePixel | (z_real ? kZReal : 0) | (z_valid ? kZValid : 0);
        px.row[e] = j;
        px.dx[e] = rays[3 * j + 0];
        px.dy[e] = rays[3 * j + 1];
        px.dz[e] = rays[3 * j + 2];
        px.zz[e] = zz;
        px.geff[e] = occ_sgn * expf(occ_lg * (ages[j] + occ_dtf));
        px.occ_num[e] = lam * expf(-lam * (zz - minz));
        px.w_occ[e] = wt * (z_valid ? inv_range : 0.0f);
        const float lik_bg =
            z_real ? (z_valid ? inv_range : 0.0f) * (1.0f - p_inv_bg)
                   : p_inv_bg;
        px.log_bg[e] = logf(fmaxf(lik_bg, kTiny));
        if constexpr (KC > 0) {
          // the block's previous pixel (none at the head of a batch)
          const int jp = (((i - 1) / kSubRun) * n_groups + g) * kSubRun
                         + (i - 1) % kSubRun;
          bool same = e > 0;
#pragma unroll
          for (int k = 0; k < kSlots; ++k) {
            const int id = cand[j * kSlots + k];
            px.cand[e * kSlots + k] = id;
            same = same && (id == cand[(e > 0 ? jp : j) * kSlots + k]);
          }
          flags |= same ? kSameIds : 0;
        }
      }
      px.flags[e] = flags;
    }
    __syncthreads();

    // Software pipeline over the batch: the map values of the next
    // sub-run and the slabs of the next pixel are requested before the
    // current pixel's arithmetic, which hides their latency.
    const int batch = min(kBatch, n_local - i0);  // a multiple of kSubRun
    OccT occ_cur[kSubRun];
    OccT occ_nxt[kSubRun];
    fetch_occ(occ, px, 0, stride, p, occ_nxt);
    if constexpr (KC > 0) {
      resolve_slots<KC>(slabs, px, 0, stride, p, slot, slot_id, slot_dead,
                        slot_fresh);
    }
    for (int e0 = 0; e0 < batch; e0 += kSubRun) {
#pragma unroll
      for (int r = 0; r < kSubRun; ++r) {
        occ_cur[r] = occ_nxt[r];
      }
      if (e0 + kSubRun < batch) {
        fetch_occ(occ, px, e0 + kSubRun, stride, p, occ_nxt);
      }
      if constexpr (KC > 0) {
        // Fast path: all four pixels name the candidates of the pixel
        // before them, none of which this warp can hit. Then log p is
        // the background's and the posterior the aged prior, as below.
        const int4 f4 = *reinterpret_cast<const int4*>(&px.flags[e0]);
        if ((f4.x & f4.y & f4.z & f4.w & kSameIds) && all_dead) {
          const float4 geff4 =
              *reinterpret_cast<const float4*>(&px.geff[e0]);
          const float4 lbg4 =
              *reinterpret_cast<const float4*>(&px.log_bg[e0]);
          const float geff_r[kSubRun] = {geff4.x, geff4.y, geff4.z, geff4.w};
          const float lbg_r[kSubRun] = {lbg4.x, lbg4.y, lbg4.z, lbg4.w};
          // live pixels of one sub-run are consecutive rows
          OccT* dst = occ_out + static_cast<size_t>(px.row[e0]) * stride + p;
#pragma unroll
          for (int r = 0; r < kSubRun; ++r) {
            const float occ_v = occ_value(occ_cur[r]);
            const float q = clip01(occ_pi + geff_r[r] * (occ_v - occ_pi));
            if (live) store_occ(dst + r * stride, q);
            acc += lbg_r[r];
          }
          if (e0 + kSubRun < batch) {
            resolve_slots<KC>(slabs, px, e0 + kSubRun, stride, p, slot,
                              slot_id, slot_dead, slot_fresh);
          }
          continue;
        }
      }
#pragma unroll
      for (int r = 0; r < kSubRun; ++r) {
        const int e = e0 + r;
        const int flags = px.flags[e];
        const bool pixel = flags & kLivePixel;  // false past the last one
        const int j = px.row[e];

        // --- intersect the K candidates, min depth over candidates
        float t = kBig;
        if constexpr (KC > 0) {
          // nothing to intersect where the pixel names the previous
          // pixel's candidates and the warp could hit none of those
          if (pixel && !((flags & kSameIds) && all_dead)) {
            const float dx = px.dx[e];
            const float dy = px.dy[e];
            const float dz = px.dz[e];
            int ids[kSlots];
#pragma unroll
            for (int k = 0; k < kSlots; ++k) {
              ids[k] = px.cand[e * kSlots + k];
            }
            all_dead = true;
#pragma unroll
            for (int k = 0; k < kSlots; ++k) {
              bool repeated = false;  // the same triangle, the same depth
#pragma unroll
              for (int m = 0; m < k; ++m) {
                repeated = repeated || (ids[m] == ids[k]);
              }
              if (repeated) continue;
              if (slot_fresh[k]) {
                slot_dead[k] = cannot_be_hit(slot[k]);
                slot_fresh[k] = false;
              }
              if (slot_dead[k]) continue;
              all_dead = false;
              t = fminf(t, hit_depth(slot[k], dx, dy, dz, slack));
            }
          }
          if (e + 1 < batch) {
            resolve_slots<KC>(slabs, px, e + 1, stride, p, slot, slot_id,
                              slot_dead, slot_fresh);
          }
        } else if (pixel) {
          const float dx = px.dx[e];
          const float dy = px.dy[e];
          const float dz = px.dz[e];
          for (int k = 0; k < K; ++k) {
            load_slab(slabs, cand[j * K + k], stride, p, slot[0]);
            if (cannot_be_hit(slot[0])) continue;
            t = fminf(t, hit_depth(slot[0], dx, dy, dz, slack));
          }
        }
        if (!pixel) continue;
        const bool on_sil = t < kBig * 0.5f;

        // --- occlusion prior, lazily aged by ages[j] + dt in closed form
        const size_t o = static_cast<size_t>(j) * p_pad + p;
        const float occ_v = occ_value(occ_cur[r]);
        const float q = clip01(occ_pi + px.geff[e] * (occ_v - occ_pi));

        float post = q;
        float log_pz = px.log_bg[e];
        if (__any_sync(kFullMask, on_sil)) {
          // --- beam densities (truncation normalizer taken as 1)
          const bool z_real = flags & kZReal;
          const bool z_valid = flags & kZValid;
          const float zz = px.zz[e];
          const float d = on_sil ? t : 1.0f;
          float lik_vis = p_inv_vis;
          if (z_valid) {
            const float sig = msig + sfac * d * d;
            const float zn = (zz - d) / sig;
            const float body_vis = expf(-0.5f * zn * zn) / (sig * kSqrt2Pi);
            lik_vis = ((1.0f - wt) * body_vis + wt * inv_range)
                      * (1.0f - p_inv_vis);
          }
          const float d_eff = fminf(fmaxf(d, minz), maxz);
          const bool in_front = z_valid && (zz <= d_eff);
          float body_occ = 0.0f;
          if (__any_sync(kFullMask, in_front)) {
            const float span = fmaxf(d_eff - minz, 1e-6f);
            const float norm_occ = fmaxf(1.0f - expf(-lam * span), 1e-6f);
            body_occ = in_front ? px.occ_num[e] / norm_occ : 0.0f;
          }
          const float lik_occ =
              z_real ? ((1.0f - wt) * body_occ + px.w_occ[e])
                           * (1.0f - p_inv_occ)
                     : p_inv_occ;
          const float p_on = (1.0f - q) * lik_vis + q * lik_occ;
          const float post_on = clip01(q * lik_occ / fmaxf(p_on, kTiny));
          post = on_sil ? post_on : q;
          log_pz = on_sil ? logf(fmaxf(p_on, kTiny)) : log_pz;
        }
        if (live) store_occ(occ_out + o, post);
        acc += log_pz;
      }
    }
  }
  if (live) partial[static_cast<size_t>(g) * p_pad + p_raw] = acc;
}

__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ loglik, int n_groups,
                                    int p_pad) {
  // launched while the main kernel still runs (programmatic dependent
  // launch): wait here until all of its blocks are done and their partial
  // sums visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= p_pad) return;
  float s = 0.0f;
  for (int c = 0; c < n_groups; ++c) {
    s += partial[static_cast<size_t>(c) * p_pad + p];
  }
  loglik[p] = s;
}

template <typename OccT>
int launch(const float* slabs, const OccT* occ, const float* z,
           const int* cand, const float* rays, const float* ages,
           const float* params, OccT* occ_out, float* partial, float* loglik,
           int n, int K, int p_pad, int n_groups, cudaStream_t stream) {
  if (n <= 0 || p_pad <= 0 || K <= 0 || n_groups <= 0
      || n_groups > 65535) {
    return cudaErrorInvalidValue;
  }
  const int p_tiles = (p_pad + kThreads - 1) / kThreads;
  const dim3 grid(p_tiles, n_groups);
#define DBOT_FUSED_LAUNCH(KC)                                              \
  fused_loglik_kernel<OccT, KC><<<grid, kThreads, 0, stream>>>(            \
      slabs, occ, z, cand, rays, ages, params, occ_out, partial, n, K, p_pad)
  switch (K) {
    case 1: DBOT_FUSED_LAUNCH(1); break;
    case 2: DBOT_FUSED_LAUNCH(2); break;
    case 3: DBOT_FUSED_LAUNCH(3); break;
    case 4: DBOT_FUSED_LAUNCH(4); break;
    default: DBOT_FUSED_LAUNCH(0); break;
  }
#undef DBOT_FUSED_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the second kernel's launch overlaps the first one's run
  cudaLaunchAttribute overlap;
  overlap.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p_tiles);
  config.blockDim = dim3(kThreads);
  config.stream = stream;
  config.attrs = &overlap;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, sum_partials_kernel,
                           static_cast<const float*>(partial), loglik,
                           n_groups, p_pad);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// How many partial rows (pixel groups) the kernel wants for n pixels of K
// candidates and p_pad particles: as many blocks as the card holds at
// once and no more, at least one sub-run of pixels each. A function of
// the shapes and the card only, so the summation order is fixed. Returns
// 0 if the card cannot be asked.
int dbot_fused_loglik_groups(int n, int K, int p_pad) {
  static int sm_count = 0;
  if (sm_count == 0) {
    int dev = 0;
    int count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                  dev) != cudaSuccess
        || count <= 0) {
      return 0;
    }
    sm_count = count;
  }
  if (n <= 0 || K <= 0 || p_pad <= 0) return 0;
  const int resident = sm_count * blocks_per_sm(K <= kMaxCached ? K : 0);
  const int p_tiles = (p_pad + kThreads - 1) / kThreads;
  const int n_sub = (n + kSubRun - 1) / kSubRun;
  const int want = std::max(1, resident / p_tiles);
  return std::max(1, std::min({want, n_sub, 65535}));
}

// Both return cudaGetLastError() after the launches (0 = success).
// partial: (n_groups, p_pad) f32, n_groups from dbot_fused_loglik_groups.
int dbot_fused_loglik_bf16(const void* slabs, const void* occ, const void* z,
                           const void* cand, const void* rays,
                           const void* ages, const void* params,
                           void* occ_out, void* partial, void* loglik, int n,
                           int K, int p_pad, int n_groups, void* stream) {
  return launch<__nv_bfloat16>(
      static_cast<const float*>(slabs),
      static_cast<const __nv_bfloat16*>(occ), static_cast<const float*>(z),
      static_cast<const int*>(cand), static_cast<const float*>(rays),
      static_cast<const float*>(ages), static_cast<const float*>(params),
      static_cast<__nv_bfloat16*>(occ_out), static_cast<float*>(partial),
      static_cast<float*>(loglik), n, K, p_pad, n_groups,
      static_cast<cudaStream_t>(stream));
}

int dbot_fused_loglik_f32(const void* slabs, const void* occ, const void* z,
                          const void* cand, const void* rays,
                          const void* ages, const void* params, void* occ_out,
                          void* partial, void* loglik, int n, int K,
                          int p_pad, int n_groups, void* stream) {
  return launch<float>(
      static_cast<const float*>(slabs), static_cast<const float*>(occ),
      static_cast<const float*>(z), static_cast<const int*>(cand),
      static_cast<const float*>(rays), static_cast<const float*>(ages),
      static_cast<const float*>(params), static_cast<float*>(occ_out),
      static_cast<float*>(partial), static_cast<float*>(loglik), n, K, p_pad,
      n_groups, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
