// Hand-written CUDA (sm_90a) gathers: the photometric warp's row gather,
// the windowed lane gather and the sparse term's selection gather.
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
// The Pallas kernels pin the whole source in VMEM.  On an H100 a 640x480
// source (2.4 MB of (N, 2) rows) is ten times an SM's 227 KB of shared
// memory, and a cluster's distributed shared memory would copy it once a
// cluster, more bytes than the gather reads; it stays in the 50 MB L2.
//
// row_gather: what bounds it is bytes (each index read once, each output
// row written once, each distinct source row read once: 3.7 MB for the
// probe's (307200, 2) at 307200 warp indices, 1.1 us at 3.35 TB/s) and,
// below some 10^5 rows, latency: an output row waits for two dependent trips
// to device memory, the index and then the source row.  The design puts
// bytes in flight:
//  * R consecutive output rows a thread, R = 1 or 2 (ops/gather.py row_plan
//    picks R and the block from M).  Two indices come as one 8-byte load
//    with a streaming hint (__ldcs); the R source rows are loaded through the
//    read-only path (__ldg: a near-identity warp's neighbouring threads share
//    32-byte sectors, which L1 then serves) before any store; the R rows go
//    out as vectors of min(R * C, 4) floats with an evict-first hint
//    (__stcs).  So a thread has R source requests in flight, and issues 1/R
//    of the index and output instructions.  R = 2 only where one row a
//    thread would take more than one wave of resident threads (307200 rows).
//    A one-off sweep on the H100 of R in {1, 2, 4} and blocks of 32, 64 and
//    128 found R = 1 as fast inside one wave and R = 4 slower than 2 at
//    307200 (a warp's first source load then spans four times the sectors,
//    the next three hit them again); no caller sends enough rows for R = 4
//    to be the one-wave choice, so it is not built.  The cache hints
//    measured neither faster nor slower than plain loads and stores.
//  * Blocks of at most 128 threads and at most (SMs x resident blocks) of
//    them over a grid-stride loop; at small M the plan halves the block
//    until the grid reaches every SM.
//  * Ragged edges in the kernel: a last group of fewer than R rows is moved
//    row by row; an index vector that is not R*4-byte aligned (idx[1:])
//    takes the kVecIdx = false instance, which loads the R indices as
//    scalars into the same vector stores (the output, allocated by the
//    wrapper, is always 16-byte aligned, so groups align on it).
//
// lane_gather: bytes again (the index and the output, 8 bytes a lane, and
// the source rows once: 18.4 MB at (480, 3200), 5.5 us).  A block a row that
// stages the row with scalar loads, waits at a barrier and only then loads
// its indices overlaps nothing.  Here persistent blocks (ops/gather.py
// lane_plan: min(H, SMs x k), k = 4 from a one-off sweep of 1, 2, 4 and 8
// on the H100, which at H = 480 is one row a block; k = 1 lost by a fifth) walk
// rows r = blockIdx.x, r += gridDim.x through a two-slot ring of row
// buffers in dynamic shared memory (2 x B x 4 bytes, 96 KB at LANE_MAX =
// 12288, hence the attribute, set once a device).  Thread 0 issues the
// next row's 1-D bulk copy (cp.async.bulk, completed on the slot's mbarrier
// with expect_tx) while the block works on the current row; every thread
// loads its index words as int4 with a streaming hint before it waits on the
// barrier's phase, so the index loads overlap the row's arrival; the gather
// reads shared memory and stores float4 with __stcs.  A slot is rewritten
// only after the block has read it: fence.proxy.async, then __syncthreads().
// The k-th use of a slot waits for its barrier's phase parity k & 1.  A bulk
// copy needs 16-byte aligned rows of a multiple of 16 bytes: when B % 4 != 0
// or an operand is misaligned the block stages each row with its own loads
// (the same kernel, bulk = 0).  Indices follow jnp.take_along_axis: a
// negative index wraps once (-1 is the last lane); an index >= B or < -B
// gives NaN.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowMaxThreads = 128;
constexpr int kLaneThreads = 256;
constexpr int kLaneMax = 12288;                           // ops/gather.py LANE_MAX
constexpr int kLaneVecs = kLaneMax / 4 / kLaneThreads;    // int4 index words a thread
constexpr int kSelectThreads = 256;
constexpr int kMaxDevices = 64;                         // lane_gather's attribute flags

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

template <int W>
struct VecT;
template <>
struct VecT<1> {
  using T = float;
};
template <>
struct VecT<2> {
  using T = float2;
};
template <>
struct VecT<4> {
  using T = float4;
};

__device__ __forceinline__ int clip(int j, int n) { return min(max(j, 0), n - 1); }

template <int R, bool kVecIdx>
__device__ __forceinline__ void load_indices(const int32_t* p, int (&j)[R]) {
  if constexpr (kVecIdx && R == 2) {
    const int2 v = __ldcs(reinterpret_cast<const int2*>(p));
    j[0] = v.x, j[1] = v.y;
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) j[r] = __ldcs(p + r);
  }
}

// R rows of C floats, as vectors of min(R * C, 4) floats; o is aligned to
// that many floats (the group starts at a multiple of R rows).
template <int C, int R>
__device__ __forceinline__ void store_rows(float* o, const typename RowT<C>::T (&v)[R]) {
  constexpr int kN = R * C;
  constexpr int kW = kN < 4 ? kN : 4;
  using V = typename VecT<kW>::T;
  float f[kN];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) f[r * C + c] = reinterpret_cast<const float*>(&v[r])[c];
#pragma unroll
  for (int q = 0; q < kN / kW; ++q) {
    V w;
#pragma unroll
    for (int c = 0; c < kW; ++c) reinterpret_cast<float*>(&w)[c] = f[q * kW + c];
    __stcs(reinterpret_cast<V*>(o) + q, w);
  }
}

template <int C, int R, bool kVecIdx>
__global__ void __launch_bounds__(kRowMaxThreads)
    row_gather_kernel(const typename RowT<C>::T* __restrict__ rows, int n,
                      const int32_t* __restrict__ idx, int m, float* __restrict__ out) {
  using T = typename RowT<C>::T;
  const long long groups = ((long long)m + R - 1) / R;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    const long long i0 = g * R;
    if (i0 + R <= m) {
      int j[R];
      load_indices<R, kVecIdx>(idx + i0, j);
      T v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = __ldg(rows + clip(j[r], n));
      store_rows<C, R>(out + i0 * C, v);
    } else {
      // the last group, m % R rows
      for (long long i = i0; i < m; ++i) {
        const T v[1] = {__ldg(rows + clip(__ldcs(idx + i), n))};
        store_rows<C, 1>(out + i * C, v);
      }
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// Arm the barrier for `bytes` and copy them from global memory into `dst`.
__device__ __forceinline__ void bulk_row(uint64_t* bar, float* dst, const float* src,
                                         uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ float lane(const float* row, int j, int b) {
  if (j < 0) j += b;
  return (unsigned)j < (unsigned)b ? row[j] : __int_as_float(0x7fc00000);
}

__global__ void __launch_bounds__(kLaneThreads)
    lane_gather_kernel(const float* __restrict__ src, const int32_t* __restrict__ idx,
                       int h, int b, int bulk, float* __restrict__ out) {
  extern __shared__ __align__(16) float ring[];   // bulk: 2 slots of b; else 1
  __shared__ __align__(8) uint64_t bars[2];
  const int tid = threadIdx.x;
  if (!bulk) {
    for (int r = blockIdx.x; r < h; r += gridDim.x) {
      const size_t base = (size_t)r * b;
      for (int k = tid; k < b; k += kLaneThreads) ring[k] = __ldg(src + base + k);
      __syncthreads();
      for (int k = tid; k < b; k += kLaneThreads)
        __stcs(out + base + k, lane(ring, __ldcs(idx + base + k), b));
      __syncthreads();
    }
    return;
  }
  const uint32_t bytes = (uint32_t)b * 4u;
  const int nvec = b >> 2;
  if (tid == 0) {
    barrier_init(&bars[0]);
    barrier_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) bulk_row(&bars[0], ring, src + (size_t)blockIdx.x * b, bytes);
  int i = 0;
  for (int r = blockIdx.x; r < h; r += gridDim.x, ++i) {
    const int s = i & 1;
    const int next = r + gridDim.x;
    // slot s ^ 1 was read in the last step (fenced, then the barrier below)
    if (tid == 0 && next < h)
      bulk_row(&bars[s ^ 1], ring + (s ^ 1) * b, src + (size_t)next * b, bytes);
    const size_t base = (size_t)r * b;
    const int4* irow = reinterpret_cast<const int4*>(idx + base);
    int4 jv[kLaneVecs];
#pragma unroll
    for (int q = 0; q < kLaneVecs; ++q) {
      const int k = tid + q * kLaneThreads;
      if (k < nvec) jv[q] = __ldcs(irow + k);
    }
    barrier_wait(&bars[s], (i >> 1) & 1);
    const float* row = ring + s * b;
    float4* orow = reinterpret_cast<float4*>(out + base);
#pragma unroll
    for (int q = 0; q < kLaneVecs; ++q) {
      const int k = tid + q * kLaneThreads;
      if (k < nvec)
        __stcs(orow + k, make_float4(lane(row, jv[q].x, b), lane(row, jv[q].y, b),
                                     lane(row, jv[q].z, b), lane(row, jv[q].w, b)));
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
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
__global__ void __launch_bounds__(kSelectThreads)
    select_gather_kernel(const float* __restrict__ vals, const int64_t* __restrict__ idx,
                         int kk, int w, int n, const float* __restrict__ inten,
                         const float* __restrict__ depth, const float* __restrict__ gx,
                         const float* __restrict__ gy, float* __restrict__ u,
                         float* __restrict__ v, float* __restrict__ i1,
                         float* __restrict__ d1, float* __restrict__ gxo,
                         float* __restrict__ gyo, uint8_t* __restrict__ valid) {
  const int k = blockIdx.x * kSelectThreads + threadIdx.x;
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

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int C, int R>
int launch_rows(const void* rows, int n, const int32_t* idx, int m, void* out,
                int threads, int blocks, bool vec_idx, cudaStream_t stream) {
  using T = typename RowT<C>::T;
  const T* src = static_cast<const T*>(rows);
  float* dst = static_cast<float*>(out);
  if (vec_idx)
    row_gather_kernel<C, R, true><<<blocks, threads, 0, stream>>>(src, n, idx, m, dst);
  else
    row_gather_kernel<C, R, false><<<blocks, threads, 0, stream>>>(src, n, idx, m, dst);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_rows_r(const void* rows, int n, const int32_t* idx, int m, void* out, int r,
                  int threads, int blocks, bool vec_idx, cudaStream_t stream) {
  switch (r) {
    case 1:
      return launch_rows<C, 1>(rows, n, idx, m, out, threads, blocks, false, stream);
    case 2:
      return launch_rows<C, 2>(rows, n, idx, m, out, threads, blocks, vec_idx, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// rows (n, c) f32, c in {1, 2, 4}, idx (m,) i32 -> out (m, c) f32, clip mode;
// r rows a thread (1 or 2), blocks of `threads` (32 to 128) threads,
// `blocks` of them over a grid-stride loop (ops/gather.py row_plan); vec_idx:
// idx is r * 4-byte aligned and its r indices load as one vector
// (row_vector_index).  rows must be aligned to a row, out to 16 bytes.
// Returns cudaErrorInvalidValue for another c, r or launch shape.
int row_gather(const void* rows, int n, int c, const int32_t* idx, int m, void* out,
               int r, int threads, int blocks, int vec_idx, void* stream) {
  if (m <= 0) return 0;
  if ((c != 1 && c != 2 && c != 4) || n <= 0 || threads < 32 || threads > kRowMaxThreads ||
      threads % 32 || blocks <= 0 ||
      !aligned(rows, 4u * c) || !aligned(out, 16) ||
      (vec_idx && r > 1 && !aligned(idx, 4u * r)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = vec_idx != 0;
  switch (c) {
    case 1:
      return launch_rows_r<1>(rows, n, idx, m, out, r, threads, blocks, vec, s);
    case 2:
      return launch_rows_r<2>(rows, n, idx, m, out, r, threads, blocks, vec, s);
    case 4:
      return launch_rows_r<4>(rows, n, idx, m, out, r, threads, blocks, vec, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// src (h, b) f32, idx (h, b) i32 -> out (h, b) f32: take_along_axis(axis=1).
// `blocks` persistent blocks (ops/gather.py lane_plan, at most h); bulk:
// rows arrive by bulk copy (b % 4 == 0 and src, idx, out 16-byte aligned,
// lane_bulk), else each block stages them with its own loads.
int lane_gather(const float* src, const int32_t* idx, int h, int b, float* out, int blocks,
                int bulk, void* stream) {
  if (h <= 0 || b <= 0) return 0;
  if (b > kLaneMax || blocks <= 0 || blocks > h ||
      (bulk && (b % 4 || !aligned(src, 16) || !aligned(idx, 16) || !aligned(out, 16))))
    return static_cast<int>(cudaErrorInvalidValue);
  // the attribute (the 96 KB ring at kLaneMax), set once a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static bool prepared[kMaxDevices] = {};
  if (dev >= kMaxDevices || !prepared[dev]) {
    e = cudaFuncSetAttribute(lane_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             2 * kLaneMax * 4);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kMaxDevices) prepared[dev] = true;
  }
  const size_t smem = (size_t)(bulk ? 2 : 1) * b * sizeof(float);
  lane_gather_kernel<<<blocks, kLaneThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      src, idx, h, b, bulk, out);
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
  select_gather_kernel<<<(kk + kSelectThreads - 1) / kSelectThreads, kSelectThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      vals, idx, kk, w, n, inten, depth, gx, gy, u, v, i1, d1, gxo, gyo, valid);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
