// Hand-written CUDA (sm_90a) gathers: the photometric warp's row gather and
// the windowed lane gather.
//
// Replaces the Pallas kernels of the JAX package's gather probes:
//   row_gather<2> <- tools/gather_exp3.py:88 pallas_gather (pl.pallas_call
//       :90): clip-mode gather of (N, 2) [intensity, depth] rows, the warp
//       gather of imgproc.rgb_odometry / rgb_odometry_sparse; also <4> for
//       the (N, 4) gather of select_photometric_pixels;
//   row_gather<1> <- tools/gather_exp3.py:115 pallas_gather1 (call :117):
//       the single-plane variant;
//   lane_gather   <- tools/gather_exp4.py:72 lane_gather (call :80):
//       take_along_axis(axis=1) over (H, B) row windows.
//   select_gather <- the same pallas_gather at C = 4 where the tracker runs
//       it: everything of imgproc.select_photometric_pixels after the sort
//       (the JAX package's imgproc.py:428-473), in one launch.
//
// What bounds them on an H100: bytes.  A 640x480 warp gather reads the
// 1.2 MB index vector, writes 2.4 MB and touches at most the 2.4 MB source,
// about 2 us at 3.35 TB/s; a launch costs more, so at the tracker's sizes
// both kernels are launch-bound.  That is recorded, not tuned.
//
// Design.  row_gather: one thread per output row, the index clamped into
// [0, N-1] in the kernel (clip mode), the row moved as one float2 / float4
// load and store (the wrapper checks the alignment).  The Pallas kernel pins
// its source in VMEM; here the source (2.4 MB at 640x480) stays in the 50 MB
// L2, so no shared-memory staging is needed.  lane_gather: one block per
// row; the block stages the source row in shared memory (at most 12288 f32,
// 48 KB) and gathers from there.  Indices follow jnp.take_along_axis: a
// negative index wraps once (-1 is the last lane); an index >= B or < -B
// gives NaN.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 256;
constexpr int kLaneThreads = 256;

template <int C>
struct RowT;
template <>
struct RowT<1> {
  using T = float;
};
template <>
struct RowT<2> {
  using T = float2;
};
template <>
struct RowT<4> {
  using T = float4;
};

template <int C>
__global__ void __launch_bounds__(kRowThreads)
    row_gather_kernel(const typename RowT<C>::T* __restrict__ rows, int n,
                      const int32_t* __restrict__ idx, int m,
                      typename RowT<C>::T* __restrict__ out) {
  const int i = blockIdx.x * kRowThreads + threadIdx.x;
  if (i >= m) return;
  const int j = min(max(idx[i], 0), n - 1);
  out[i] = rows[j];
}

__global__ void __launch_bounds__(kLaneThreads)
    lane_gather_kernel(const float* __restrict__ src,
                       const int32_t* __restrict__ idx, int b,
                       float* __restrict__ out) {
  extern __shared__ float row[];
  const size_t base = (size_t)blockIdx.x * b;
  for (int k = threadIdx.x; k < b; k += kLaneThreads) row[k] = src[base + k];
  __syncthreads();
  for (int k = threadIdx.x; k < b; k += kLaneThreads) {
    int j = idx[base + k];
    if (j < 0) j += b;
    out[base + k] = (j >= 0 && j < b) ? row[j] : __int_as_float(0x7fc00000);
  }
}

// select_gather: one thread per selected pixel k < kk.  It reads the k-th
// sorted score and flat index, and the four planes (intensity, depth, gx,
// gy; (H*W,) f32 each) in place at that index, clamped into [0, n-1] as
// jnp.take(..., mode="clip"); it writes u = idx % w, v = idx / w (exact in
// f32 below 2^24), the four values, and valid = score >= 0, each to its own
// contiguous vector (the layout photometric_hg's sparse variant reads).
// What bounds it: bytes, 12 in and 25 out per pixel plus one 32-byte sector
// per plane for each distinct sector the pixels touch (one sector holds four
// stride-2 pixels of a row); at the fast path's 24576 pixels that is under
// 4 MB, about a microsecond at 3.35 TB/s, so the launch sets its time.  It
// replaces the slice, compare, modulo, division, casts, the (H*W, 4) stack,
// the index cast, row_gather<4> and the transpose: about ten launches per
// level.
__global__ void __launch_bounds__(kRowThreads)
    select_gather_kernel(const float* __restrict__ vals, const int64_t* __restrict__ idx,
                         int kk, int w, int n, const float* __restrict__ inten,
                         const float* __restrict__ depth, const float* __restrict__ gx,
                         const float* __restrict__ gy, float* __restrict__ u,
                         float* __restrict__ v, float* __restrict__ i1,
                         float* __restrict__ d1, float* __restrict__ gxo,
                         float* __restrict__ gyo, uint8_t* __restrict__ valid) {
  const int k = blockIdx.x * kRowThreads + threadIdx.x;
  if (k >= kk) return;
  const int64_t p = idx[k];
  const int j = static_cast<int>(min(max(p, (int64_t)0), (int64_t)(n - 1)));
  u[k] = static_cast<float>(p % w);
  v[k] = static_cast<float>(p / w);
  i1[k] = inten[j];
  d1[k] = depth[j];
  gxo[k] = gx[j];
  gyo[k] = gy[j];
  valid[k] = vals[k] >= 0.f ? 1 : 0;
}

template <int C>
int launch_rows(const void* rows, int n, const int32_t* idx, int m, void* out,
                void* stream) {
  using T = typename RowT<C>::T;
  row_gather_kernel<C><<<(m + kRowThreads - 1) / kRowThreads, kRowThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), n, idx, m, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows (n, c) f32, c in {1, 2, 4}, idx (m,) i32 -> out (m, c) f32, clip mode.
// Returns cudaErrorInvalidValue for another c.
int row_gather(const void* rows, int n, int c, const int32_t* idx, int m,
               void* out, void* stream) {
  if (m <= 0) return 0;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (c) {
    case 1:
      return launch_rows<1>(rows, n, idx, m, out, stream);
    case 2:
      return launch_rows<2>(rows, n, idx, m, out, stream);
    case 4:
      return launch_rows<4>(rows, n, idx, m, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// src (h, b) f32, idx (h, b) i32 -> out (h, b) f32: take_along_axis(axis=1).
int lane_gather(const float* src, const int32_t* idx, int h, int b, float* out,
                void* stream) {
  if (h <= 0 || b <= 0) return 0;
  const size_t smem = (size_t)b * sizeof(float);
  lane_gather_kernel<<<h, kLaneThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(src, idx, b, out);
  return static_cast<int>(cudaGetLastError());
}

// vals (>= kk,) f32 and idx (>= kk,) i64: a stable descending sort's output;
// the four (n,) f32 planes of a w-wide level -> u, v, i1, d1, gx, gy (kk,)
// f32 and valid (kk,) u8.
int select_gather(const float* vals, const int64_t* idx, int kk, int w, int n,
                  const float* inten, const float* depth, const float* gx,
                  const float* gy, float* u, float* v, float* i1, float* d1, float* gxo,
                  float* gyo, uint8_t* valid, void* stream) {
  if (kk <= 0) return 0;
  if (w <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  select_gather_kernel<<<(kk + kRowThreads - 1) / kRowThreads, kRowThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      vals, idx, kk, w, n, inten, depth, gx, gy, u, v, i1, d1, gxo, gyo, valid);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
