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

}  // extern "C"
