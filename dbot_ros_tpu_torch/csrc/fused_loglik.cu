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
//   partial (n_chunks, p_pad) f32 scratch, loglik (p_pad) f32.
//
// What bounds it on the card: memory. Each (pixel, particle, candidate)
// reads 10 f32 slab constants (40 B) for ~40 flops, so at the tight
// compaction level (n = 448, K = 2, P = 10k) one frame reads up to
// 448·2·40·10,112 B ≈ 362 MB of slabs (about 118 MB of them distinct),
// against 2·448·20 kB of occlusion traffic. The design:
//   * one thread per particle, so the 10 constants of a triangle are
//     read coalesced across a warp (the slab's particle axis is minor);
//   * blockIdx.y walks a chunk of pixels; every thread of a block reads
//     the same cand/z/ray/age words (broadcast loads), and pixels whose
//     candidates repeat hit the slabs in L2;
//   * the per-particle sum stays in a register over the chunk; chunk
//     partials go to `partial`, and a second kernel sums them in a fixed
//     order — the TPU summed in a sequential grid, which a GPU does not
//     have, and a fixed order keeps the result deterministic (no atomics).
// Built without --use_fast_math: the NaN tests z == z and the exact
// division t = t_num / det must survive. Built with -fmad=false so that
// the arithmetic rounds op by op as the plain PyTorch version does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float kSqrt2Pi = 2.5066282746310002f;
constexpr float kTiny = 1e-30f;
constexpr float kDetEps = 1e-12f;
constexpr float kNear = 1e-4f;
constexpr float kBig = 1e30f;

__device__ __forceinline__ float load_occ(const float* p) { return *p; }
__device__ __forceinline__ float load_occ(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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

template <typename OccT>
__global__ void fused_loglik_kernel(
    const float* __restrict__ slabs, const OccT* __restrict__ occ,
    const float* __restrict__ z, const int* __restrict__ cand,
    const float* __restrict__ rays, const float* __restrict__ ages,
    const float* __restrict__ params, OccT* __restrict__ occ_out,
    float* __restrict__ partial, int n, int K, int p_pad, int chunk) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= p_pad) return;
  const int c = blockIdx.y;
  const int j0 = c * chunk;
  const int j1 = min(n, j0 + chunk);

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

  const size_t slab_stride = static_cast<size_t>(p_pad);
  float acc = 0.0f;
  for (int j = j0; j < j1; ++j) {
    const float dx = rays[3 * j + 0];
    const float dy = rays[3 * j + 1];
    const float dz = rays[3 * j + 2];
    const float zj = z[j];
    const bool z_real = (zj == zj);
    const bool z_valid = z_real && (zj >= minz) && (zj <= maxz);
    const float zz = z_real ? zj : 1.0f;

    // --- intersect the K candidates, min depth over candidates
    float t = kBig;
    for (int k = 0; k < K; ++k) {
      const int tid = cand[j * K + k];
      const float* s = slabs + static_cast<size_t>(tid) * 10 * slab_stride + p;
      const float u = s[0] * dx + s[slab_stride] * dy
                      + s[2 * slab_stride] * dz;
      const float v = s[3 * slab_stride] * dx + s[4 * slab_stride] * dy
                      + s[5 * slab_stride] * dz;
      const float det = s[6 * slab_stride] * dx + s[7 * slab_stride] * dy
                        + s[8 * slab_stride] * dz;
      const float tn = s[9 * slab_stride];
      const float sgn = sign_of(det);
      const float adet = fabsf(det);
      const float sa = slack * adet;
      const bool valid = (adet > kDetEps) && (sgn * u >= -sa)
                         && (sgn * v >= -sa) && (sgn * (u + v) <= adet + sa)
                         && (sgn * tn > kNear * adet);
      const float tk = valid ? tn / det : kBig;
      t = fminf(t, tk);
    }
    const bool on_sil = t < kBig * 0.5f;
    const float d = on_sil ? t : 1.0f;

    // --- occlusion prior, lazily aged by ages[j] + dt in closed form
    const size_t o = static_cast<size_t>(j) * p_pad + p;
    const float occ_v = load_occ(occ + o);
    const float geff = occ_sgn * expf(occ_lg * (ages[j] + occ_dtf));
    const float q = clip01(occ_pi + geff * (occ_v - occ_pi));

    // --- beam densities (truncation normalizer taken as 1)
    const float sig = msig + sfac * d * d;
    const float zn = (zz - d) / sig;
    const float body_vis = expf(-0.5f * zn * zn) / (sig * kSqrt2Pi);
    const float lik_vis =
        z_valid
            ? ((1.0f - wt) * body_vis + wt * inv_range) * (1.0f - p_inv_vis)
            : p_inv_vis;

    const float d_eff = fminf(fmaxf(d, minz), maxz);
    const float span = fmaxf(d_eff - minz, 1e-6f);
    const float norm_occ = fmaxf(1.0f - expf(-lam * span), 1e-6f);
    const float body_occ = lam * expf(-lam * (zz - minz)) / norm_occ;
    const bool in_front = z_valid && (zz <= d_eff);
    const float lik_occ =
        z_real ? ((1.0f - wt) * (in_front ? body_occ : 0.0f)
                  + wt * (z_valid ? inv_range : 0.0f)) * (1.0f - p_inv_occ)
               : p_inv_occ;
    const float lik_bg =
        z_real ? (z_valid ? inv_range : 0.0f) * (1.0f - p_inv_bg) : p_inv_bg;

    const float p_on = (1.0f - q) * lik_vis + q * lik_occ;
    const float p_z = fmaxf(on_sil ? p_on : lik_bg, kTiny);
    float post = q * lik_occ / fmaxf(p_on, kTiny);
    post = on_sil ? clip01(post) : q;
    store_occ(occ_out + o, post);

    acc += logf(p_z);
  }
  partial[static_cast<size_t>(c) * p_pad + p] = acc;
}

__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ loglik, int n_chunks,
                                    int p_pad) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= p_pad) return;
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    s += partial[static_cast<size_t>(c) * p_pad + p];
  }
  loglik[p] = s;
}

template <typename OccT>
int launch(const float* slabs, const OccT* occ, const float* z,
           const int* cand, const float* rays, const float* ages,
           const float* params, OccT* occ_out, float* partial, float* loglik,
           int n, int K, int p_pad, int chunk, cudaStream_t stream) {
  constexpr int kThreads = 128;
  if (n <= 0 || p_pad <= 0 || chunk <= 0) return cudaErrorInvalidValue;
  const int n_chunks = (n + chunk - 1) / chunk;
  dim3 grid((p_pad + kThreads - 1) / kThreads, n_chunks);
  fused_loglik_kernel<OccT><<<grid, kThreads, 0, stream>>>(
      slabs, occ, z, cand, rays, ages, params, occ_out, partial, n, K, p_pad,
      chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<(p_pad + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(partial, loglik, n_chunks, p_pad);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launches (0 = success).
int dbot_fused_loglik_bf16(const void* slabs, const void* occ, const void* z,
                           const void* cand, const void* rays,
                           const void* ages, const void* params,
                           void* occ_out, void* partial, void* loglik, int n,
                           int K, int p_pad, int chunk, void* stream) {
  return launch<__nv_bfloat16>(
      static_cast<const float*>(slabs),
      static_cast<const __nv_bfloat16*>(occ), static_cast<const float*>(z),
      static_cast<const int*>(cand), static_cast<const float*>(rays),
      static_cast<const float*>(ages), static_cast<const float*>(params),
      static_cast<__nv_bfloat16*>(occ_out), static_cast<float*>(partial),
      static_cast<float*>(loglik), n, K, p_pad, chunk,
      static_cast<cudaStream_t>(stream));
}

int dbot_fused_loglik_f32(const void* slabs, const void* occ, const void* z,
                          const void* cand, const void* rays,
                          const void* ages, const void* params, void* occ_out,
                          void* partial, void* loglik, int n, int K,
                          int p_pad, int chunk, void* stream) {
  return launch<float>(
      static_cast<const float*>(slabs), static_cast<const float*>(occ),
      static_cast<const float*>(z), static_cast<const int*>(cand),
      static_cast<const float*>(rays), static_cast<const float*>(ages),
      static_cast<const float*>(params), static_cast<float*>(occ_out),
      static_cast<float*>(partial), static_cast<float*>(loglik), n, K, p_pad,
      chunk, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
