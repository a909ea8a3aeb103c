// Hand-written CUDA (sm_90a): the tracker's SDF term around the decoder, in
// two launches.
//
// No Pallas source: the JAX package leaves this arithmetic to XLA
// (nerf_fusion_tpu/system/tracker.py _sdf_Hg with map.py get_sdf).  In the
// port it replaces about 77 PyTorch kernels a GN evaluation (two point
// transforms, the voxel lookup with an int64 copy of the whole indexer, the
// latent gather, the concatenation, the chain to world coordinates, the cross
// products, the robust weight and three reductions done as matrix products),
// so that an SDF-plus-rgb evaluation is five hand-written launches:
// sdf_rows, decoder_forward_grad, sdf_hg, photometric_hg, gn_step.
//
// sdf_rows, one thread a point of the GN prefix:
//   p_delta = dR p + dt, p_world = R_last p_delta + t_last   (dR, dt read by
//   pointer from the GN state, where gn_step writes them)
//   xyz_norm = (p_world - bound_min) * (1 / voxel_size), grid = ceil - 1
//   the bounds test, the clamped linear id, the int32 indexer read in place,
//   the slot clamp and the obs_count gate; with the point's mask: use (u8)
//   x = [latent row (29), rel (3)], the decoder's (N, 32) input; p_delta
// Each operation rounds as PyTorch's CUDA kernels do, in their order: the
// point transforms as cuBLAS's f32 product (an FMA chain in k order, then
// the translation added), the division by the voxel size as a product with
// the f32 reciprocal the wrapper passes (PyTorch divides by a Python scalar
// so), no contraction elsewhere (__fmul_rn / __fadd_rn).  So the voxel and
// the mask of a point are the plain composition's, and a point on a voxel
// face takes the same voxel.  Each warp writes its 32 rows of x together,
// lane j holding column j, so the 29 latent floats of a row are one
// coalesced read and the row one 128-byte store.
//
// sdf_hg, one thread a row (grid-stride over at most one block per SM):
//   r = sdf / std, d = (1 / std) grad (1 / voxel_size)
//   La = R_last^T d, Lb = p_delta x La, J = [La, Lb]
//   w = robust(r) use      (huber, tukey or none, by id as photometric_hg)
// then the 21 upper entries of sum w J J^T, the 6 of sum w r J, sum w r^2
// and the count, reduced as photometric.cu does: registers, warp shuffles,
// one partial a block, and the last block by ticket sums the partials in a
// fixed order and writes H (full), g and the energy times 1 / max(count, 1)
// and the count.  Deterministic, f32, no TF32.  A masked row still adds
// 0 * its products, as the plain version's masked sums do (a NaN row
// poisons both alike).
//
// What bounds them: the launch.  sdf_rows moves 8192 x (12 in, 116 latent,
// 4 indexer, 4 count, 4 + 1 mask, 128 + 12 + 1 out) = 2.3 MB, under 1 us at
// 3.35 TB/s; sdf_hg reads 8192 x 33 bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIn = 32;     // the decoder's input row: latent, rel
constexpr int kSlots = 29;  // H upper 21, g 6, energy, count
constexpr int kPad = 32;    // floats per block partial

struct RowsArgs {
  const float* pts;        // (n, 3)
  const uint8_t* mask;     // (n,)
  const float* dR;         // (3, 3) the GN state's delta pose
  const float* dt;         // (3,)
  const float* last_R;     // (3, 3)
  const float* last_t;     // (3,)
  const float* bound_min;  // (3,)
  float inv_voxel;         // f32 1 / voxel_size
  int nx, ny, nz;
  const int* indexer;      // (nx ny nz,) slot or -1
  const float* obs_count;  // (capacity,)
  const float* latents;    // (capacity, latent)
  int capacity, latent;
  float count_th;
  int n;
  float* x;                // (n, 32)
  float* p_delta;          // (n, 3)
  uint8_t* use;            // (n,) mask & valid
};

// out[c] = sum_k R[c][k] p[k] + t[c]: cuBLAS's FMA chain in k order, then
// the translation's own add.
__device__ __forceinline__ void transform(const float* R, const float* t, const float* p,
                                          float* out) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = __fmul_rn(p[0], R[c * 3]);
    acc = __fmaf_rn(p[1], R[c * 3 + 1], acc);
    acc = __fmaf_rn(p[2], R[c * 3 + 2], acc);
    out[c] = __fadd_rn(acc, t[c]);
  }
}

__global__ void __launch_bounds__(kThreads) sdf_rows_kernel(const RowsArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < a.n;
  float R[9], dR[9], t[3], dt[3], bmin[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    dR[k] = __ldg(a.dR + k);
    R[k] = __ldg(a.last_R + k);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dt[k] = __ldg(a.dt + k);
    t[k] = __ldg(a.last_t + k);
    bmin[k] = __ldg(a.bound_min + k);
  }
  float p[3] = {0.f, 0.f, 0.f};
  if (live) {
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = __ldg(a.pts + 3 * i + k);
  }
  float pd[3], pw[3];
  transform(dR, dt, p, pd);
  transform(R, t, pd, pw);
  const int n3[3] = {a.nx, a.ny, a.nz};
  long long grid[3], gc[3];
  float rel[3];
  bool inb = true;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float xn = __fmul_rn(__fsub_rn(pw[c], bmin[c]), a.inv_voxel);
    grid[c] = static_cast<long long>(ceilf(xn)) - 1;
    inb = inb && grid[c] >= 0 && grid[c] < n3[c];
    gc[c] = grid[c] < 0 ? 0 : (grid[c] > n3[c] - 1 ? n3[c] - 1 : grid[c]);
    rel[c] = __fsub_rn(__fsub_rn(xn, static_cast<float>(grid[c])), 0.5f);
  }
  int slot = 0;
  bool use = false;
  if (live) {
    const long long gid = (gc[0] * a.ny + gc[1]) * a.nz + gc[2];
    const int s = __ldg(a.indexer + gid);
    slot = s < 0 ? 0 : (s > a.capacity - 1 ? a.capacity - 1 : s);
    use = inb && s >= 0 && __ldg(a.obs_count + slot) > a.count_th && __ldg(a.mask + i) != 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) a.p_delta[3 * i + k] = pd[k];
    a.use[i] = use ? 1 : 0;
  }
  // the warp's 32 rows of x, one row a step, lane j writing column j
  const int lane = threadIdx.x & 31;
  const int base = i - lane;
#pragma unroll 4
  for (int r = 0; r < 32; ++r) {
    const int s = __shfl_sync(0xffffffffu, slot, r);
    const float r0 = __shfl_sync(0xffffffffu, rel[0], r);
    const float r1 = __shfl_sync(0xffffffffu, rel[1], r);
    const float r2 = __shfl_sync(0xffffffffu, rel[2], r);
    if (base + r >= a.n) break;
    float v;
    if (lane < a.latent)
      v = __ldg(a.latents + (size_t)s * a.latent + lane);
    else
      v = lane == a.latent ? r0 : (lane == a.latent + 1 ? r1 : r2);
    a.x[(size_t)(base + r) * kIn + lane] = v;
  }
}

struct HgArgs {
  const float2* out;       // (n, 2) [sdf, std]
  const float* grad;       // (n, 3) d sdf / d rel
  const float* p_delta;    // (n, 3)
  const uint8_t* use;      // (n,)
  const float* last_R;     // (3, 3)
  float inv_voxel;
  int robust;              // 0 none, 1 huber, 2 tukey
  float robust_k, inv_k;   // k and the f32 1 / k
  int n;
  float* partials;         // (gridDim.x, kPad)
  unsigned int* ticket;    // 0 between launches
  float* result;           // (44,) H 36, g 6, energy, count
};

// photometric.robust_weight as PyTorch's CUDA kernels evaluate it: k / |r|
// as the reciprocal times k, r / k as r times the reciprocal of k.
__device__ __forceinline__ float robust_weight(float r, int kind, float k, float inv_k) {
  const float ar = fabsf(r);
  if (kind == 1) return ar > k ? __fmul_rn(__frcp_rn(fmaxf(ar, 1e-12f)), k) : 1.f;
  if (kind == 2) {
    const float q = __fmul_rn(r, inv_k);
    const float s = __fsub_rn(1.f, __fmul_rn(q, q));
    return ar <= k ? __fmul_rn(s, s) : 0.f;
  }
  return 1.f;
}

__global__ void __launch_bounds__(kThreads) sdf_hg_kernel(const HgArgs a) {
  __shared__ float red[kWarps][kPad];
  __shared__ bool last;
  float R[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = __ldg(a.last_R + k);
  float acc[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) acc[k] = 0.f;

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < a.n; i += gridDim.x * kThreads) {
    const float2 o = __ldg(a.out + i);
    const float r = __fdiv_rn(o.x, o.y);
    const float inv_std = __fdiv_rn(1.f, o.y);
    float d[3], q[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      d[k] = __fmul_rn(__fmul_rn(inv_std, __ldg(a.grad + 3 * i + k)), a.inv_voxel);
      q[k] = __ldg(a.p_delta + 3 * i + k);
    }
    float J[6];
#pragma unroll
    for (int c = 0; c < 3; ++c) {   // R_last^T d
      float s = __fmul_rn(R[c], d[0]);
      s = __fmaf_rn(R[3 + c], d[1], s);
      J[c] = __fmaf_rn(R[6 + c], d[2], s);
    }
    J[3] = q[1] * J[2] - q[2] * J[1];
    J[4] = q[2] * J[0] - q[0] * J[2];
    J[5] = q[0] * J[1] - q[1] * J[0];
    const float m = __ldg(a.use + i) ? 1.f : 0.f;
    const float w = robust_weight(r, a.robust, a.robust_k, a.inv_k) * m;
    const float wr = w * r;
    int s = 0;
#pragma unroll
    for (int u = 0; u < 6; ++u) {
      const float jw = J[u] * w;
#pragma unroll
      for (int v = u; v < 6; ++v) acc[s++] += jw * J[v];
    }
#pragma unroll
    for (int u = 0; u < 6; ++u) acc[21 + u] += J[u] * wr;
    acc[27] += r * wr;
    acc[28] += m;
  }

  // One partial per block: shuffles, then the warps' sums in order.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    float x = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) red[warp][k] = x;
  }
  __syncthreads();
  if (warp == 0) {
    float x = 0.f;
    if (lane < kSlots) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) x += red[w][lane];
    }
    a.partials[blockIdx.x * kPad + lane] = x;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // The last block: warp w sums the partials of blocks w, w + 8, ... in
  // order, then warp 0 sums the eight in order.
  __threadfence();
  float x = 0.f;
  for (int b = warp; b < gridDim.x; b += kWarps) x += __ldcg(a.partials + b * kPad + lane);
  red[warp][lane] = x;
  __syncthreads();
  if (warp != 0) return;
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tot += red[w][lane];
  const float count = __shfl_sync(0xffffffffu, tot, 28);
  const float scale = __frcp_rn(fmaxf(count, 1.f));   // 1 / max(count, 1)
  if (lane < 21) {
    int r = 0, c = lane;
    while (c >= 6 - r) {
      c -= 6 - r;
      ++r;
    }
    c += r;
    a.result[r * 6 + c] = tot * scale;
    a.result[c * 6 + r] = tot * scale;
  } else if (lane < 28) {
    a.result[36 + lane - 21] = tot * scale;  // g, then the energy
  } else if (lane == 28) {
    a.result[43] = count;
  }
  if (lane == 0) *a.ticket = 0u;
}

int sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, count = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    cached = count;
  }
  *sms = cached;
  return 0;
}

}  // namespace

extern "C" {

// pts (n, 3) f32, mask (n,) u8; dR (3, 3), dt (3,) the delta pose (the GN
// state's); last_R (3, 3), last_t (3,), bound_min (3,) f32; inv_voxel the f32
// reciprocal of the voxel size; the map's indexer (nx ny nz,) i32,
// obs_count (capacity,) f32 and latents (capacity, latent) f32, latent + 3
// = 32 -> x (n, 32), p_delta (n, 3) f32, use (n,) u8.
int sdf_rows(const float* pts, const uint8_t* mask, const float* dR, const float* dt,
             const float* last_R, const float* last_t, const float* bound_min, float inv_voxel, int nx, int ny,
             int nz, const int* indexer, const float* obs_count, const float* latents,
             int capacity, int latent, float count_th, int n, float* x, float* p_delta,
             uint8_t* use, void* stream) {
  if (n < 0 || nx <= 0 || ny <= 0 || nz <= 0 || capacity <= 0 || latent + 3 != kIn)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  RowsArgs a = {pts, mask, dR, dt, last_R, last_t, bound_min, inv_voxel, nx, ny, nz,
                indexer, obs_count, latents, capacity, latent, count_th, n, x, p_delta,
                use};
  sdf_rows_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out (n, 2), grad (n, 3), p_delta (n, 3) f32 and use (n,) u8 of the rows;
// last_R (3, 3) f32; robust 0 none, 1 huber, 2 tukey at robust_k (inv_k
// its f32 reciprocal); partials (max_blocks, 32) f32 and ticket (a zero
// uint32) the wrapper's workspace -> result (44,) = [H (6, 6), g (6),
// energy, count].
int sdf_hg(const float* out, const float* grad, const float* p_delta, const uint8_t* use,
           const float* last_R, float inv_voxel, int robust, float robust_k, float inv_k,
           int n, float* partials, int max_blocks, unsigned int* ticket, float* result,
           void* stream) {
  if (n < 0 || max_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int e = sm_count(&sms);
  if (e != 0) return e;
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > sms) blocks = sms;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;  // no row still writes the zeros
  HgArgs a = {reinterpret_cast<const float2*>(out), grad, p_delta, use, last_R, inv_voxel,
              robust, robust_k, inv_k, n, partials, ticket, result};
  sdf_hg_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
