// Hand-written CUDA (sm_90a): the tracker's photometric term in one launch.
//
// Replaces, where the tracker runs it, the Pallas row gather of the JAX
// package's gather probe, tools/gather_exp3.py:88 pallas_gather (call :90),
// which pinned the previous frame on chip and gathered where its values were
// used, together with the work around that gather:
//   nerf_fusion_tpu/ops/imgproc.py:524 rgb_odometry (dense: the stride grid
//   of the current level) and :477 rgb_odometry_sparse (sparse: a selected
//   pixel set), reduced to normal equations as system/tracker.py:175 _rgb_Hg.
// One launch per evaluation does the warp, the gather from the packed
// previous frame, the validity tests, the residual, the Jacobian, the robust
// weight and the reduction to H (6 x 6), g (6), the energy and the valid
// count, where the plain version takes about 120 PyTorch kernels, and forms
// the warp's K R K^-1 and K t itself (three products the tracker launched
// before it).
//
// What bounds it on an H100: neither bytes nor operations.  At 640x480,
// stride 2, it reads 1.2 MB of the current planes and at most the 2.4 MB
// source (in the 50 MB L2), about 1 us at 3.35 TB/s; a launch, the grid-wide
// reduction and the last block's final sum cost more.  The design keeps those
// to one launch with no memset and no second pass.
//
// Exactness.  The valid mask and the warp indices equal the plain version's
// pixel for pixel: a pixel that crosses the round, in-bounds or depth test
// changes the Gauss-Newton early exit's path.  So the warp and the tests
// round every operation as PyTorch's elementwise kernels do, in their order
// (imgproc.py rgb_odometry / rgb_odometry_sparse): __fmul_rn / __fadd_rn /
// __fdiv_rn keep nvcc from contracting a*b+c into an FMA, rintf rounds half
// to even as torch.round does, and the thresholds arrive rounded to f32 as
// PyTorch rounds a Python scalar.  Each thread forms K R K^-1 and K t from
// the pose (R, t) and the level's K and K^-1, all read by pointer (R, t the
// GN state's delta pose, so a captured graph reads the pose that gn_step
// wrote), as the plain version's cuBLAS products round them: for each entry
// an FMA chain in k order, K R first.  Given K R K^-1 and K t themselves,
// the wrapper passes K = K^-1 = I, for which the chains are exact.  A pixel
// whose rounded warp falls outside the image is invalid; inside it, the
// plain version's NaN-to-0 and clamp leave the warp as it is, so the kernel
// gathers only in-bounds pixels and uses the warp unclamped.  The Jacobian,
// the weights and the sums may contract.
//
// Reduction, deterministic in one launch: each thread sums the 21 upper
// entries of H, the 6 of g, the energy and the count over its pixels
// (grid-stride over a grid of at most one block per SM, a function of the
// pixel count and the card only); warp shuffles, then shared memory, give
// one partial per block; the last block to take a ticket (atomic, after a
// __threadfence) sums the partials in a fixed order, scales them and writes
// H (full, symmetric), g, the energy and the count, and resets the ticket.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 29;  // H upper 21, g 6, energy, count
constexpr int kPad = 32;    // floats per block partial
constexpr int kOut = 44;    // H 36, g 6, energy, count

struct Args {
  const float2* prev;  // (H*W, 2) [intensity, depth] of the previous frame
  int W, H;
  // dense: the current level's planes (H, W), taken on the stride grid of
  // gw x gh pixels; sparse: the selection's (n,) vectors
  const float* inten;
  const float* depth;
  const float* gx;
  const float* gy;
  const float* u;          // sparse only
  const float* v;          // sparse only
  const uint8_t* valid;    // sparse only
  int n, gw, stride;
  const float* R;          // (3, 3) the relative pose's rotation
  const float* t;          // (3,) and translation
  const float* K;          // (3, 3) the level's intrinsics
  const float* Kinv;       // (3, 3) their inverse
  float fx, fy, cx, cy, min_grad, max_dd, robust_k;
  const float* rgb_weight;  // () f32 on the device: the tracker's state machine sets it
  int robust;              // 0 none, 1 huber, 2 tukey
  float* partials;         // (gridDim.x, kPad)
  unsigned int* ticket;    // 0 between launches
  float* out;              // (kOut,)
};

__device__ __forceinline__ float robust_weight(float f, int kind, float k) {
  const float af = fabsf(f);
  if (kind == 1) return af > k ? k / fmaxf(af, 1e-12f) : 1.f;
  if (kind == 2) {
    const float r = f / k;
    const float s = 1.f - r * r;
    return af <= k ? s * s : 0.f;
  }
  return 1.f;
}

// d1 (k0 u + k1 v + k2) + c in PyTorch's order, each operation rounded.
__device__ __forceinline__ float warp_row(float d1, float k0, float k1, float k2,
                                          float c, float u, float v) {
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(k0, u), __fmul_rn(k1, v)), k2);
  return __fadd_rn(__fmul_rn(d1, s), c);
}

// C = A B, A (3, 3), B (3, cols) row-major (cols 1: a vector): cuBLAS's f32
// product, an FMA chain over k in order for each entry.
__device__ __forceinline__ void product3(const float* A, const float* B, int cols, float* C) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < cols; ++c) {
      float acc = __fmul_rn(A[r * 3], B[c]);
      acc = __fmaf_rn(A[r * 3 + 1], B[cols + c], acc);
      C[r * cols + c] = __fmaf_rn(A[r * 3 + 2], B[2 * cols + c], acc);
    }
  }
}

template <bool SPARSE>
__global__ void __launch_bounds__(kThreads) photometric_kernel(const Args a) {
  __shared__ float red[kWarps][kPad];
  __shared__ bool last;
  float K[9], Kinv[9], R[9], t[3], KR[9], k[9], kt[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    K[i] = __ldg(a.K + i);
    Kinv[i] = __ldg(a.Kinv + i);
    R[i] = __ldg(a.R + i);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = __ldg(a.t + i);
  product3(K, R, 3, KR);
  product3(KR, Kinv, 3, k);   // K R K^-1
  product3(K, t, 1, kt);      // K t

  float acc[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) acc[i] = 0.f;

  for (int p = blockIdx.x * kThreads + threadIdx.x; p < a.n; p += gridDim.x * kThreads) {
    float u, v, i1, d1, gx, gy;
    bool ok;
    if (SPARSE) {
      u = __ldg(a.u + p);
      v = __ldg(a.v + p);
      i1 = __ldg(a.inten + p);
      d1 = __ldg(a.depth + p);
      gx = __ldg(a.gx + p);
      gy = __ldg(a.gy + p);
      ok = __ldg(a.valid + p) != 0;
    } else {
      const int y = p / a.gw;
      const int x = p - y * a.gw;
      const int Y = y * a.stride, X = x * a.stride;
      const size_t q = (size_t)Y * a.W + X;
      i1 = __ldg(a.inten + q);
      d1 = __ldg(a.depth + q);
      gx = __ldg(a.gx + q);
      gy = __ldg(a.gy + q);
      const float grad2 = __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
      const bool base = isfinite(grad2) && grad2 >= a.min_grad && isfinite(d1);
      if (a.stride > 1) {
        // imgproc.py: zero the planes outside the keep mask, then d1 > 0
        if (!(base && isfinite(i1))) i1 = d1 = gx = gy = 0.f;
        ok = d1 > 0.f;
      } else {
        ok = base;
      }
      u = (float)X;
      v = (float)Y;
    }
    if (!ok) continue;
    const float wz = warp_row(d1, k[6], k[7], k[8], kt[2], u, v);
    const float u0 = rintf(__fdiv_rn(warp_row(d1, k[0], k[1], k[2], kt[0], u, v), wz));
    const float v0 = rintf(__fdiv_rn(warp_row(d1, k[3], k[4], k[5], kt[1], u, v), wz));
    if (!(u0 >= 0.f && u0 < (float)a.W && v0 >= 0.f && v0 < (float)a.H)) continue;
    const float2 got = __ldg(a.prev + ((int)v0 * a.W + (int)u0));
    const float i0 = got.x, d0 = got.y;
    if (!(isfinite(d0) && d0 > 0.f && fabsf(__fsub_rn(wz, d0)) <= a.max_dd)) continue;
    const float f = __fsub_rn(i1, i0);

    // The warp Jacobian (imgproc._warp_jacobian), negated as _rgb_Hg does.
    const float Gx = d0 * (u0 - a.cx) / a.fx;
    const float Gy = d0 * (v0 - a.cy) / a.fy;
    const float Gz = fmaxf(d0, 1e-6f);
    const float p0 = gx * a.fx / Gz;
    const float p1 = gy * a.fy / Gz;
    const float p2 = -(p0 * Gx + p1 * Gy) / Gz;
    const float J[6] = {-p0, -p1, -p2, -(-Gz * p1 + Gy * p2), -(Gz * p0 - Gx * p2),
                        -(-Gy * p0 + Gx * p1)};
    const float w = robust_weight(f, a.robust, a.robust_k);
    const float wf = w * f;
    int s = 0;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      const float jw = J[r] * w;
#pragma unroll
      for (int c = r; c < 6; ++c) acc[s++] += jw * J[c];
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) acc[21 + r] += J[r] * wf;
    acc[27] += f * wf;
    acc[28] += 1.f;
  }

  // One partial per block: shuffles, then the warps' sums in order.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    float x = acc[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) red[warp][i] = x;
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
  // scale = rgb_weight / max(count, 1), as PyTorch evaluates a Python
  // scalar over a tensor: reciprocal, then product
  const float scale = __fmul_rn(__frcp_rn(fmaxf(count, 1.f)), *a.rgb_weight);
  if (lane < 21) {
    int r = 0, c = lane;
    while (c >= 6 - r) {
      c -= 6 - r;
      ++r;
    }
    c += r;
    a.out[r * 6 + c] = tot * scale;
    a.out[c * 6 + r] = tot * scale;
  } else if (lane < 28) {
    a.out[36 + lane - 21] = tot * scale;  // g, then the energy
  } else if (lane == 28) {
    a.out[43] = count;
  }
  if (lane == 0) *a.ticket = 0u;
}

int launch(Args& a, int max_blocks, void* stream, bool sparse) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, count = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    sms = count;
  }
  int blocks = (a.n + kThreads - 1) / kThreads;
  if (blocks > sms) blocks = sms;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;  // an empty pixel set still writes the zeros
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sparse)
    photometric_kernel<true><<<blocks, kThreads, 0, s>>>(a);
  else
    photometric_kernel<false><<<blocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args common(const float* prev, int W, int H, const float* R, const float* t,
            const float* K, const float* Kinv, float fx, float fy, float cx, float cy, float max_dd, int robust,
            float robust_k, const float* rgb_weight, float* partials, unsigned int* ticket,
            float* out) {
  Args a = {};
  a.prev = reinterpret_cast<const float2*>(prev);
  a.W = W;
  a.H = H;
  a.R = R;
  a.t = t;
  a.K = K;
  a.Kinv = Kinv;
  a.fx = fx;
  a.fy = fy;
  a.cx = cx;
  a.cy = cy;
  a.max_dd = max_dd;
  a.robust = robust;
  a.robust_k = robust_k;
  a.rgb_weight = rgb_weight;
  a.partials = partials;
  a.ticket = ticket;
  a.out = out;
  return a;
}

}  // namespace

extern "C" {

// prev (H*W, 2) f32 (8-byte aligned); intensity, depth (H, W) and grad
// (2, H, W) f32 of the current level, evaluated at every stride-th pixel;
// R (3, 3), t (3,) the relative pose and K, Kinv (3, 3) the level's
// intrinsics f32 (the warp's K R K^-1 and K t); partials (max_blocks, 32) f32 and ticket (a
// zero uint32) are the wrapper's workspace -> out (44,) = [H (6, 6), g (6),
// energy, count].
int photometric_hg_dense(const float* prev, int W, int H, const float* intensity,
                         const float* depth, const float* grad, int stride,
                         const float* R, const float* t, const float* K,
                         const float* Kinv, float fx, float fy,
                         float cx, float cy, float min_grad, float max_dd, int robust,
                         float robust_k, const float* rgb_weight, float* partials,
                         int max_blocks, unsigned int* ticket, float* out,
                         void* stream) {
  if (W <= 0 || H <= 0 || stride < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a = common(prev, W, H, R, t, K, Kinv, fx, fy, cx, cy, max_dd, robust, robust_k,
                  rgb_weight, partials, ticket, out);
  a.inten = intensity;
  a.depth = depth;
  a.gx = grad;
  a.gy = grad + (size_t)H * W;
  a.stride = stride;
  a.gw = (W + stride - 1) / stride;
  a.n = a.gw * ((H + stride - 1) / stride);
  a.min_grad = min_grad;
  return launch(a, max_blocks, stream, false);
}

// As photometric_hg_dense over n selected pixels: u, v (full-resolution
// pixel coordinates), i1, d1, gx, gy (n,) f32 and valid (n,) bool.
int photometric_hg_sparse(const float* prev, int W, int H, const float* u,
                          const float* v, const float* i1, const float* d1,
                          const float* gx, const float* gy, const uint8_t* valid, int n,
                          const float* R, const float* t, const float* K,
                          const float* Kinv, float fx, float fy,
                          float cx, float cy, float max_dd, int robust, float robust_k,
                          const float* rgb_weight, float* partials, int max_blocks,
                          unsigned int* ticket, float* out, void* stream) {
  if (W <= 0 || H <= 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a = common(prev, W, H, R, t, K, Kinv, fx, fy, cx, cy, max_dd, robust, robust_k,
                  rgb_weight, partials, ticket, out);
  a.u = u;
  a.v = v;
  a.inten = i1;
  a.depth = d1;
  a.gx = gx;
  a.gy = gy;
  a.valid = valid;
  a.n = n;
  return launch(a, max_blocks, stream, true);
}

}  // extern "C"
