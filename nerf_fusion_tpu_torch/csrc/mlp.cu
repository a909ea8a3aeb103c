// Hand-written CUDA (sm_90a) for the two small MLPs of the fusion loop.
//
// Replaces the Pallas kernels of the JAX package's ops/pallas_mlp.py:
//   decoder_forward, decoder_forward_grad <- _decoder_pallas_call (:98),
//       kernel _decoder_kernel (:82), entry decoder_forward_pallas (:113);
//   encoder_forward                       <- _encoder_pallas_call (:165),
//       kernel _encoder_kernel (:155), entry encoder_forward_pallas (:180);
// and, with no Pallas source, XLA's reverse mode through the decoder in the
// latent refinement: decoder_vjp (the last section).
//
// Both MLPs hold tens of thousands of MACs per row for a few hundred bytes
// in and out, far above any ridge point: arithmetic bounds them.  Their
// layers run as TF32 tensor-core products (mma.sync m16n8k8, f32
// accumulate) with the 3xTF32 split, operand x = hi + lo, both TF32, and
// acc += a_lo w_hi, acc += a_hi w_lo, acc += a_hi w_hi: small terms first,
// hi.hi last.  That is as exact as f32 products (the JAX package's bf16x3
// split is not: it misses the 1e-4 output tolerance on the mesher's
// inputs), at 3 passes of the TF32 rate, where the f32 CUDA cores (67
// TFLOP/s) bounded the first kernels.  What bounds them now is the rate of
// mma.sync's TF32 products, about half of the 495 TFLOP/s that only wgmma
// reaches (PERF.md); the shared loads and the splits fit between them.
//
// Shared design: a persistent grid; each block copies all the packed
// weights into shared memory once and its warps then loop over 16-row
// tiles.  A warp keeps its tile's activations in registers across the
// layers: the host packs each layer's (in, out) matrix in B-fragment order
// with the rows of every 8-wide K block permuted (fragment element (kb, nb,
// lane = 4g + t, j) = W[8kb + 2t + j][8nb + g]), so the m16n8 accumulator of
// one layer (row g, cols 2t and 2t+1) is the A fragment of the next with no
// shuffle and no trip through shared memory.  Each B fragment is one
// conflict-free 8-byte shared load per lane.  Its split costs two
// instructions: the block stages each weight as trunc(w) + rna(w - trunc(w)),
// a sum f32 holds exactly and whose truncation gives the two parts back
// (rna = cvt.rna.tf32.f32: to nearest, ties away from zero).  An activation
// is split as rna(a) + rna(a - rna(a)), once per layer and K block, and
// serves every N block of the layer.
//
// Decoder: hidden layers lin0 32->128, lin1 128->128, lin2 128->96 and lin3
// [h 96 | x 32]->128 on the tensor cores (199,560 bytes of weights, one
// block of 8 warps per SM).  The heads (lin4, unc: 128 -> 1) stay on the
// CUDA cores in f32: the four lanes of a row each sum 32 products, two
// xor-shuffles sum the row.  The gradient variant carries, in forward mode, the three
// tangents d h / d xyz beside the activation: a tile holds 4 points x 4
// planes (row 4p + s; plane 0 the activation, planes 1-3 the tangents).  A
// tangent row enters lin0 and lin3's re-fed input as the one-hot row of its
// xyz column, takes no bias, and takes the ReLU mask of its point's
// activation row, one shuffle from lane (lane & ~12) per accumulator
// register; the heads end with (1 - sdf^2) times the tangent's lin4 product.
//
// Encoder (cnp SharedMLP, eval BatchNorm folded): 6 -> 32 -> 64 -> 256 -> 29,
// all four layers on the tensor cores.  The first layer's K = 6 is padded
// to one 8-wide K block (zero weight rows): the input then arrives in the A
// layout, the layer costs 12 products a tile, and it leaves its output in
// the accumulator layout the next layer takes.  The last layer is padded to
// N = 32 (zero columns); only columns < 29 are stored, as scalars (an
// output row is 116 bytes, so odd rows are not 8-byte aligned).  The
// 256-wide layer is never held whole: it runs in four 64-column chunks,
// each taken through its ReLU and multiplied at once into the last layer's
// 16 x 32 accumulator as that layer's K chunk, so a warp holds the 64-wide
// input (32 registers, or its 64 split halves, which the compiler hoists
// out of the chunk loop), a 32-register chunk and the 16-register output
// accumulator.  That is more than the 128 registers a thread that two
// blocks of 8 warps leave (they spilled), so a block has 6 warps: two
// blocks (109,056 bytes of weights each) and 12 warps fit an SM.
//
// Decoder VJP: the forward pass recomputed on the same tiles and weights,
// then the reverse pass as transposed products read from the same shared
// copy (its section says how).
//
// Edges: a partial last tile reads rows >= n as zeros and stores none of
// them.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// 3xTF32 building blocks.
// ---------------------------------------------------------------------------

constexpr uint32_t kTf32Mask = 0xffffe000u;  // sign, exponent, 10 mantissa bits

// TF32 rounding of cvt.rna.tf32.f32 (to nearest, ties away from zero, low 13
// bits cleared) in two integer instructions; cvt compiles to more, with a
// NaN test these kernels do not need.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & kTf32Mask;
}

// An activation x = hi + lo up to lo's rounding (2^-23 |x|); both TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// A weight as the block stages it: hi = w truncated to TF32, lo = rna(w - hi),
// stored as their sum, which f32 holds exactly (at most 22 significant bits)
// and whose truncation is hi again, so each fragment load splits it back in
// two instructions (split_staged).  |w - hi - lo| <= 2^-22 |w|.
__device__ __forceinline__ float stage_weight(float w) {
  const float hi = __uint_as_float(__float_as_uint(w) & kTf32Mask);
  return hi + __uint_as_float(tf32(w - hi));
}

__device__ __forceinline__ void split_staged(float w, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(w) & kTf32Mask;
  lo = __float_as_uint(w - __uint_as_float(hi));
}

// The decoder VJP reads each staged hidden matrix two ways: as the B
// fragments of the forward product (lane l: one float2 at floats 2l, 2l + 1
// of each 64-float fragment block) and of the transposed product (lane
// 4g + t: floats 16t + g and 16t + 8 + g, see accumulate_t).  Stored as
// packed, the transposed reads of lanes t and t + 2 fall on one bank.  Its
// staging therefore swaps the two 8-float quarters of the second half of
// each block (float f of a block goes to f ^ ((f >> 2) & 8)): each
// transposed read then hits 32 banks, each half-warp of a forward read still
// 32 banks, and a float4 of the buffer stays a float4.
__device__ __forceinline__ int swizzle(int f) { return f ^ ((f >> 2) & 8); }

// The float2 slot of a block that lane `lane` reads in the forward product
// of a swizzled matrix (slot s goes to s ^ ((s >> 2) & 4)).
__device__ __forceinline__ int swizzled_slot(int lane) { return lane ^ ((lane >> 2) & 4); }

// Copies a packed weight buffer of L::kSize floats into shared memory,
// staging the matrices' entries (L::is_matrix), 16 bytes a load where the
// buffer allows it, and with SWIZZLED each matrix entry at L::swizzled(i).
// Each matrix range starts and ends on a multiple of 4.
template <typename L, int THREADS, bool SWIZZLED = false>
__device__ __forceinline__ void stage_weights(const float* __restrict__ wts, float* sw) {
  int staged = 0;
  if ((reinterpret_cast<uintptr_t>(wts) & 15) == 0) {
    const float4* src = reinterpret_cast<const float4*>(wts);
    float4* dst = reinterpret_cast<float4*>(sw);
#pragma unroll 8
    for (int i = threadIdx.x; i < L::kSize / 4; i += THREADS) {
      float4 v = __ldg(src + i);
      if (L::is_matrix(4 * i)) {
        v.x = stage_weight(v.x);
        v.y = stage_weight(v.y);
        v.z = stage_weight(v.z);
        v.w = stage_weight(v.w);
      }
      int d = i;
      if constexpr (SWIZZLED) d = L::swizzled(4 * i) / 4;
      dst[d] = v;
    }
    staged = L::kSize / 4 * 4;
  }
  for (int i = staged + threadIdx.x; i < L::kSize; i += THREADS) {
    const float v = __ldg(wts + i);
    int d = i;
    if constexpr (SWIZZLED) d = L::swizzled(i);
    sw[d] = L::is_matrix(i) ? stage_weight(v) : v;
  }
}

// d += a b: one m16n8k8 TF32 product with f32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's 16 x (8 KB) activations and 16 x (8 NB) pre-activations are held
// in the m16n8 accumulator layout: v[b][0], v[b][1] are row g, columns
// 8b + 2t and 8b + 2t + 1; v[b][2], v[b][3] the same columns of row g + 8
// (g = lane / 4, t = lane % 4).
//
// acc += a W for one layer (or one K chunk of it), W (8 KB x 8 NB) in
// B-fragment order in shared memory (SWIZZLED: as the VJP stages it).
//
// mma.sync adds its eight products and its accumulator as one block,
// aligned to the largest and the low bits truncated, so each product into a
// running sum loses bits against the sum.  With BLOCK_SUMS each K block's
// three products go into a fresh accumulator, added to acc in f32 (rounded
// to nearest).  The VJP takes its ReLU masks from these sums: at 327680
// rows on an H100 that halved the rows whose mask flipped against float64
// (18 to 9; cuBLAS's f32 products: 5), for 0.25 ms more a call (PERF.md).
template <int KB, int NB, bool SWIZZLED = false, bool BLOCK_SUMS = false>
__device__ __forceinline__ void accumulate(const float (&a)[KB][4], const float* w,
                                           int lane, float (&acc)[NB][4]) {
  // N blocks a group: with BLOCK_SUMS two, so that the group's sums take
  // the registers that two more B fragments would
  constexpr int G = BLOCK_SUMS ? 2 : 4;
  static_assert(NB % G == 0, "N blocks go in groups");
  const float2* wf =
      reinterpret_cast<const float2*>(w) + (SWIZZLED ? swizzled_slot(lane) : lane);
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    // A fragment: a0 (g, k position t), a1 (g + 8, t), a2 (g, t + 4),
    // a3 (g + 8, t + 4); positions t and t + 4 hold columns 2t and 2t + 1.
    uint32_t ah[4], al[4];
    split(a[kb][0], ah[0], al[0]);
    split(a[kb][2], ah[1], al[1]);
    split(a[kb][1], ah[2], al[2]);
    split(a[kb][3], ah[3], al[3]);
    // G N blocks at a time, pass by pass, so that neighbouring products
    // go to different accumulators.
#pragma unroll
    for (int n0 = 0; n0 < NB; n0 += G) {
      uint32_t bh[G][2], bl[G][2];
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const float2 wv = wf[(kb * NB + n0 + q) * 32];
        split_staged(wv.x, bh[q][0], bl[q][0]);
        split_staged(wv.y, bh[q][1], bl[q][1]);
      }
      if constexpr (BLOCK_SUMS) {
        float s[G][4] = {};
#pragma unroll
        for (int q = 0; q < G; ++q) mma(s[q], al, bh[q][0], bh[q][1]);
#pragma unroll
        for (int q = 0; q < G; ++q) mma(s[q], ah, bl[q][0], bl[q][1]);
#pragma unroll
        for (int q = 0; q < G; ++q) mma(s[q], ah, bh[q][0], bh[q][1]);
#pragma unroll
        for (int q = 0; q < G; ++q) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[n0 + q][i] += s[q][i];
        }
      } else {
#pragma unroll
        for (int q = 0; q < G; ++q) mma(acc[n0 + q], al, bh[q][0], bh[q][1]);
#pragma unroll
        for (int q = 0; q < G; ++q) mma(acc[n0 + q], ah, bl[q][0], bl[q][1]);
#pragma unroll
        for (int q = 0; q < G; ++q) mma(acc[n0 + q], ah, bh[q][0], bh[q][1]);
      }
    }
  }
}

// acc = bias + a W for one layer.  Rows of a tangent plane (GRAD, plane != 0)
// take no bias.
template <int KB, int NB, bool GRAD, bool SWIZZLED = false, bool BLOCK_SUMS = false>
__device__ __forceinline__ void hidden(const float (&a)[KB][4], const float* w,
                                       const float* b, int lane,
                                       float (&acc)[NB][4]) {
  const int t = lane & 3;
  const bool bias_row = !GRAD || ((lane >> 2) & 3) == 0;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const float2 bb = bias_row ? *reinterpret_cast<const float2*>(b + 8 * nb + 2 * t)
                               : make_float2(0.f, 0.f);
    acc[nb][0] = bb.x;
    acc[nb][1] = bb.y;
    acc[nb][2] = bb.x;
    acc[nb][3] = bb.y;
  }
  accumulate<KB, NB, SWIZZLED, BLOCK_SUMS>(a, w, lane, acc);
}

// h = relu(acc) over the first NB blocks of h.  In the gradient variant a
// tangent row is gated by its point's activation row, which lane
// (lane & ~12) holds in the same register (for an activation row that lane
// is the thread itself).
template <int NB, bool GRAD, int NH>
__device__ __forceinline__ void relu(const float (&acc)[NB][4], int lane,
                                     float (&h)[NH][4]) {
  static_assert(NB <= NH, "relu output too small");
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float gate = GRAD ? __shfl_sync(0xffffffffu, acc[nb][i], lane & ~12)
                              : acc[nb][i];
      h[nb][i] = gate > 0.f ? acc[nb][i] : 0.f;
    }
  }
}

// The SM count, once `kernel` may take `smem` bytes of dynamic shared memory
// (set on the first call of each launcher: `sms` is its own static).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem, int& sms) {
  if (sms != 0) return cudaSuccess;
  int dev = 0, count = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) sms = count;
  return e;
}

// ---------------------------------------------------------------------------
// Decoder: [latent 29 | xyz 3] -> 128 -> 128 -> 96 -> [h | x] 128 -> 128
//          -> sdf = tanh(lin4), std = 0.05 + 0.5 softplus(unc)
// ---------------------------------------------------------------------------

constexpr int kIn = 32;
constexpr int kLatent = 29;
constexpr int kH = 128;
constexpr int kH2 = 96;

// Packed weights (ops/mlp.py pack_decoder): the hidden layers' matrices in
// B-fragment order, each followed by its bias; then lin4 and unc as (128,)
// columns, each followed by its bias.
struct DecoderLayout {
  static constexpr int kW0 = 0;
  static constexpr int kB0 = kW0 + kIn * kH;
  static constexpr int kW1 = kB0 + kH;
  static constexpr int kB1 = kW1 + kH * kH;
  static constexpr int kW2 = kB1 + kH;
  static constexpr int kB2 = kW2 + kH * kH2;
  static constexpr int kW3 = kB2 + kH2;
  static constexpr int kB3 = kW3 + kH * kH;
  static constexpr int kW4 = kB3 + kH;
  static constexpr int kB4 = kW4 + kH;
  static constexpr int kWu = kB4 + 1;
  static constexpr int kBu = kWu + kH;
  static constexpr int kSize = kBu + 1;
  __device__ static bool is_matrix(int i) {
    return i < kB0 || (i >= kW1 && i < kB1) || (i >= kW2 && i < kB2) ||
           (i >= kW3 && i < kB3);
  }
  // Where the VJP stages entry i: a matrix entry swizzled within its
  // matrix's 64-float blocks (kW3 is not a multiple of 64), the rest as is.
  __device__ static int swizzled(int i) {
    if (!is_matrix(i)) return i;
    const int base = i < kB0 ? kW0 : i < kB1 ? kW1 : i < kB2 ? kW2 : kW3;
    return base + swizzle(i - base);
  }
};
using DL = DecoderLayout;
static_assert(DL::kSize == 49890, "decoder packing");
static_assert(DL::kB0 % 4 == 0 && DL::kW1 % 4 == 0 && DL::kB1 % 4 == 0 &&
                  DL::kW2 % 4 == 0 && DL::kB2 % 4 == 0 && DL::kW3 % 4 == 0 &&
                  DL::kB3 % 4 == 0,
              "16-byte staging loads");
constexpr int kDecoderSmem = DL::kSize * sizeof(float);
constexpr int kDecoderWarps = 8;
constexpr int kDecoderThreads = 32 * kDecoderWarps;

template <bool GRAD>
__global__ void __launch_bounds__(kDecoderThreads, 1)
    decoder_kernel(const float* __restrict__ x, const float* __restrict__ wts,
                   int n, float* __restrict__ out, float* __restrict__ grad) {
  extern __shared__ __align__(16) float sw[];
  stage_weights<DL, kDecoderThreads>(wts, sw);
  __syncthreads();

  constexpr int P = GRAD ? 4 : 16;  // points per 16-row tile
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int s = GRAD ? (g & 3) : 0;  // plane of both of the thread's rows
  const int tiles = (n + P - 1) / P;
  for (int tile = blockIdx.x * kDecoderWarps + (threadIdx.x >> 5); tile < tiles;
       tile += gridDim.x * kDecoderWarps) {
    // The points of the thread's rows g and g + 8.
    int r[2];
    if (GRAD) {
      r[0] = tile * P + (g >> 2);
      r[1] = r[0] + 2;
    } else {
      r[0] = tile * P + g;
      r[1] = r[0] + 8;
    }
    // The input rows in A layout: x itself, or for a tangent plane the
    // one-hot row of its xyz column.  Used by lin0 and re-fed at lin3.
    float xf[kIn / 8][4];
#pragma unroll
    for (int kb = 0; kb < kIn / 8; ++kb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r[i >> 1];
        const int c = 8 * kb + 2 * t + (i & 1);
        if (s == 0)
          xf[kb][i] = row < n ? __ldg(x + (size_t)row * kIn + c) : 0.f;
        else
          xf[kb][i] = c == kLatent - 1 + s ? 1.f : 0.f;
      }
    }

    float h[kH / 8][4];
    float acc[kH / 8][4];
    hidden<kIn / 8, kH / 8, GRAD>(xf, sw + DL::kW0, sw + DL::kB0, lane, acc);
    relu<kH / 8, GRAD>(acc, lane, h);
    hidden<kH / 8, kH / 8, GRAD>(h, sw + DL::kW1, sw + DL::kB1, lane, acc);
    relu<kH / 8, GRAD>(acc, lane, h);
    {
      float acc2[kH2 / 8][4];
      hidden<kH / 8, kH2 / 8, GRAD>(h, sw + DL::kW2, sw + DL::kB2, lane, acc2);
      relu<kH2 / 8, GRAD>(acc2, lane, h);
    }
    // latent_in at lin3: the input re-fed into columns 96..127
#pragma unroll
    for (int kb = 0; kb < kIn / 8; ++kb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) h[kH2 / 8 + kb][i] = xf[kb][i];
    }
    hidden<kH / 8, kH / 8, GRAD>(h, sw + DL::kW3, sw + DL::kB3, lane, acc);
    relu<kH / 8, GRAD>(acc, lane, h);

    // Heads in f32: lin4 (the sdf, or a tangent's d sdf) and unc.
    float d4[2] = {0.f, 0.f}, du[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < kH / 8; ++nb) {
      const int k = 8 * nb + 2 * t;
      const float w4a = sw[DL::kW4 + k], w4b = sw[DL::kW4 + k + 1];
      const float wua = sw[DL::kWu + k], wub = sw[DL::kWu + k + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        d4[half] = fmaf(h[nb][2 * half + 1], w4b, fmaf(h[nb][2 * half], w4a, d4[half]));
        du[half] = fmaf(h[nb][2 * half + 1], wub, fmaf(h[nb][2 * half], wua, du[half]));
      }
    }
    float sdf[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        d4[half] += __shfl_xor_sync(0xffffffffu, d4[half], o);
        du[half] += __shfl_xor_sync(0xffffffffu, du[half], o);
      }
      // a tangent row takes the sdf of its point's activation row
      const float pre = GRAD ? __shfl_sync(0xffffffffu, d4[half], lane & ~12) : d4[half];
      sdf[half] = tanhf(pre + sw[DL::kB4]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r[half];
      if (t != 0 || row >= n) continue;
      if (s == 0) {
        const float z = du[half] + sw[DL::kBu];
        const float softplus = fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
        out[2 * (size_t)row] = sdf[half];
        out[2 * (size_t)row + 1] = 0.05f + 0.5f * softplus;
      } else {
        grad[3 * (size_t)row + s - 1] = (1.f - sdf[half] * sdf[half]) * d4[half];
      }
    }
  }
}

template <bool GRAD>
int launch_decoder(const float* x, const float* wts, int n, float* out, float* grad,
                   void* stream) {
  if (n <= 0) return 0;
  static int sms = 0;  // per instantiation
  const cudaError_t e = prepare(decoder_kernel<GRAD>, kDecoderSmem, sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int P = GRAD ? 4 : 16;
  const int tiles = (n + P - 1) / P;
  const int wanted = (tiles + kDecoderWarps - 1) / kDecoderWarps;
  const int blocks = wanted < sms ? wanted : sms;
  decoder_kernel<GRAD><<<blocks, kDecoderThreads, kDecoderSmem,
                         static_cast<cudaStream_t>(stream)>>>(x, wts, n, out, grad);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Encoder: 6 -> 32 -> 64 -> 256 -> 29, ReLU after the first three.
// ---------------------------------------------------------------------------

constexpr int kEIn = 6;
constexpr int kEK0 = 8;  // the first layer's K, padded
constexpr int kE1 = 32;
constexpr int kE2 = 64;
constexpr int kE3 = 256;
constexpr int kEOut = 29;
constexpr int kEOutPad = 32;
constexpr int kEChunk = 64;  // columns of the 256-wide layer per chunk

// Packed weights (ops/mlp.py pack_encoder): each layer's matrix in
// B-fragment order (the first padded to 8 rows, the last to 32 columns;
// the 256-wide layer as four (64, 64) column chunks one after the other),
// each followed by its bias (the last padded to 32).
struct EncoderLayout {
  static constexpr int kW0 = 0;
  static constexpr int kB0 = kW0 + kEK0 * kE1;
  static constexpr int kW1 = kB0 + kE1;
  static constexpr int kB1 = kW1 + kE1 * kE2;
  static constexpr int kW2 = kB1 + kE2;
  static constexpr int kB2 = kW2 + kE2 * kE3;
  static constexpr int kW3 = kB2 + kE3;
  static constexpr int kB3 = kW3 + kE3 * kEOutPad;
  static constexpr int kSize = kB3 + kEOutPad;
  __device__ static bool is_matrix(int i) {
    return i < kB0 || (i >= kW1 && i < kB1) || (i >= kW2 && i < kB2) ||
           (i >= kW3 && i < kB3);
  }
};
using EL = EncoderLayout;
static_assert(EL::kSize == 27264, "encoder packing");
static_assert(EL::kB0 % 4 == 0 && EL::kW1 % 4 == 0 && EL::kB1 % 4 == 0 &&
                  EL::kW2 % 4 == 0 && EL::kB2 % 4 == 0 && EL::kW3 % 4 == 0 &&
                  EL::kB3 % 4 == 0,
              "16-byte staging loads");
constexpr int kEncoderSmem = EL::kSize * sizeof(float);  // 109,056 bytes
constexpr int kEncoderBlocksPerSm = 2;
constexpr int kEncoderWarps = 6;
constexpr int kEncoderThreads = 32 * kEncoderWarps;

__global__ void __launch_bounds__(kEncoderThreads, kEncoderBlocksPerSm)
    encoder_kernel(const float* __restrict__ x, const float* __restrict__ wts,
                   int n, float* __restrict__ out) {
  extern __shared__ __align__(16) float sw[];
  stage_weights<EL, kEncoderThreads>(wts, sw);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int tiles = (n + 15) / 16;
  for (int tile = blockIdx.x * kEncoderWarps + (threadIdx.x >> 5); tile < tiles;
       tile += gridDim.x * kEncoderWarps) {
    const int r[2] = {tile * 16 + g, tile * 16 + g + 8};
    // The input in A layout: columns 2t, 2t + 1 of rows g and g + 8; the
    // padded columns 6 and 7 (t = 3) are zero.
    float xf[1][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r[i >> 1];
      const int c = 2 * t + (i & 1);
      xf[0][i] = (row < n && c < kEIn) ? __ldg(x + (size_t)row * kEIn + c) : 0.f;
    }
    float acc1[kE1 / 8][4], h1[kE1 / 8][4];
    hidden<1, kE1 / 8, false>(xf, sw + EL::kW0, sw + EL::kB0, lane, acc1);
    relu<kE1 / 8, false>(acc1, lane, h1);
    float acc2[kE2 / 8][4], h2[kE2 / 8][4];
    hidden<kE1 / 8, kE2 / 8, false>(h1, sw + EL::kW1, sw + EL::kB1, lane, acc2);
    relu<kE2 / 8, false>(acc2, lane, h2);

    // The 256-wide layer in 64-column chunks, each at once the last layer's
    // K chunk (rows 64c .. 64c + 63 of its matrix).
    float acc4[kEOutPad / 8][4];
#pragma unroll
    for (int nb = 0; nb < kEOutPad / 8; ++nb) {
      const float2 bb = *reinterpret_cast<const float2*>(sw + EL::kB3 + 8 * nb + 2 * t);
      acc4[nb][0] = bb.x;
      acc4[nb][1] = bb.y;
      acc4[nb][2] = bb.x;
      acc4[nb][3] = bb.y;
    }
#pragma unroll 1
    for (int c = 0; c < kE3 / kEChunk; ++c) {
      float acc3[kEChunk / 8][4];
      hidden<kE2 / 8, kEChunk / 8, false>(h2, sw + EL::kW2 + c * kE2 * kEChunk,
                                          sw + EL::kB2 + c * kEChunk, lane, acc3);
      relu<kEChunk / 8, false>(acc3, lane, acc3);
      accumulate<kEChunk / 8, kEOutPad / 8>(acc3, sw + EL::kW3 + c * kEChunk * kEOutPad,
                                           lane, acc4);
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r[half];
      if (row >= n) continue;
      float* o = out + (size_t)row * kEOut;
#pragma unroll
      for (int nb = 0; nb < kEOutPad / 8; ++nb) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 8 * nb + 2 * t + j;
          if (c < kEOut) o[c] = acc4[nb][2 * half + j];
        }
      }
    }
  }
}

int launch_encoder(const float* x, const float* wts, int n, float* out, void* stream) {
  if (n <= 0) return 0;
  static int sms = 0;
  const cudaError_t e = prepare(encoder_kernel, kEncoderSmem, sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (n + 15) / 16;
  const int wanted = (tiles + kEncoderWarps - 1) / kEncoderWarps;
  const int most = kEncoderBlocksPerSm * sms;
  const int blocks = wanted < most ? wanted : most;
  encoder_kernel<<<blocks, kEncoderThreads, kEncoderSmem, static_cast<cudaStream_t>(stream)>>>(
      x, wts, n, out);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Decoder VJP: dx = g^T d[sdf, std] / dx, 3xTF32 on the tensor cores.
// ---------------------------------------------------------------------------
//
// No Pallas source: the counterpart of XLA's reverse-mode autodiff through
// apply_decoder inside refine_latents (nerf_fusion_tpu/system/refine.py:79-101).
// It replaces an f32 CUDA-core kernel (64-row blocks, activations through
// shared memory, weights from L2: 2.11 ms at 327680 rows on an H100).
// About 2 x 98.8 kFLOP a row (the forward recompute and the reverse pass)
// for 264 bytes in and out: operations bound it, at the tensor cores' rate
// for f32-exact products (three TF32 passes), as they bound the forward
// decoder; registers bound the design.
//
// The forward decoder's design, run forward and back: a persistent grid of
// one 8-warp block per SM that stages the forward kernel's packed weights
// once (swizzled, see swizzle()), each warp looping over 16-row tiles held
// in registers in the m16n8 accumulator layout.  The forward pass keeps no
// activation, only each hidden layer's ReLU mask, as bits (relu_bits: 2
// words a 128-wide layer, parked in shared memory until they gate), and sums
// each K block apart (BLOCK_SUMS in accumulate) so that fewer masks flip.  The heads give each
// row's two coefficients in f32, c4 = g0 (1 - sdf^2) and cu = g1 0.5
// sigmoid(unc), and with them lin3's output gradient d3 = mask3 (c4 w4 +
// cu wu), built in the accumulator layout, which is the next product's A
// fragment.  Four transposed products follow (accumulate_t: each B fragment
// read from the forward matrix's copy by the transposed index map, two
// 4-byte loads), each gated by the mask of the layer below: lin3^T (its
// columns 96..127 are the re-fed input's gradient, parked in shared memory
// until lin0^T), lin2^T, lin1^T, and lin0^T, whose accumulator starts at the
// re-fed gradient.  dx is stored as float2s.
//
// Registers: the kernel takes all 255 a thread may have and spills none.
// Four things here keep it there: x is read again for lin3, only after
// h's K blocks are spent, rather than held through lin1 and lin2; the re-fed
// gradient and the masks of lin0-lin2 are parked; and neither the per-tile
// constants (opaque_zero) nor the masks (relu_bits) can be traced back by
// the compiler to values it would then hold instead.  With the masks in
// registers and x held beside all of h in lin3, the K-block sums made ptxas
// spill 7 words a thread.

// acc += a W^T for one layer: W (8 NB x 8 KB) the layer's (in, out) matrix
// as the VJP stages it.  Element (k, n) of W^T is W[n][k]: the forward
// fragment order puts it in block (n / 8, k / 8) at float 16 t + 8 j + g of
// the block (k = 8 kb + 2 t + j, n = 8 nb + g), which the swizzle moves to
// 16 t + 8 (j ^ (t >> 1)) + g.  Only the first KB blocks of a are read.
template <int KB, int NB, int NA>
__device__ __forceinline__ void accumulate_t(const float (&a)[NA][4], const float* w,
                                             int lane, float (&acc)[NB][4]) {
  constexpr int G = 2;   // N blocks a group
  static_assert(KB <= NA && NB % G == 0, "accumulate_t tiling");
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* w0 = w + 16 * t + 8 * (t >> 1) + g;        // j = 0
  const float* w1 = w + 16 * t + 8 * ((t >> 1) ^ 1) + g;  // j = 1
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    uint32_t ah[4], al[4];
    split(a[kb][0], ah[0], al[0]);
    split(a[kb][2], ah[1], al[1]);
    split(a[kb][1], ah[2], al[2]);
    split(a[kb][3], ah[3], al[3]);
#pragma unroll
    for (int n0 = 0; n0 < NB; n0 += G) {
      uint32_t bh[G][2], bl[G][2];
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const int o = ((n0 + q) * KB + kb) * 64;
        split_staged(w0[o], bh[q][0], bl[q][0]);
        split_staged(w1[o], bh[q][1], bl[q][1]);
      }
#pragma unroll
      for (int q = 0; q < G; ++q) mma(acc[n0 + q], al, bh[q][0], bh[q][1]);
#pragma unroll
      for (int q = 0; q < G; ++q) mma(acc[n0 + q], ah, bl[q][0], bl[q][1]);
#pragma unroll
      for (int q = 0; q < G; ++q) mma(acc[n0 + q], ah, bh[q][0], bh[q][1]);
    }
  }
}

// h = relu(acc) over NB blocks, and the mask acc > 0 as bits: register
// (nb, i) of the accumulator layout is bit 4 (nb % 8) + i of word nb / 8.
// The words pass through an empty asm: otherwise the compiler sees that a
// bit read back later is acc > 0 and keeps the NB x 4 floats of acc alive
// until then instead of the words (it spilled them).
template <int NB, int NH>
__device__ __forceinline__ void relu_bits(const float (&acc)[NB][4], float (&h)[NH][4],
                                          uint32_t (&m)[(NB + 7) / 8]) {
  static_assert(NB <= NH, "relu output too small");
#pragma unroll
  for (int w = 0; w < (NB + 7) / 8; ++w) m[w] = 0u;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool on = acc[nb][i] > 0.f;
      h[nb][i] = on ? acc[nb][i] : 0.f;
      m[nb >> 3] |= (on ? 1u : 0u) << (4 * (nb & 7) + i);
    }
  }
#pragma unroll
  for (int w = 0; w < (NB + 7) / 8; ++w) asm volatile("" : "+r"(m[w]));
}

// v where register (nb, i)'s mask bit is set, else 0.
template <int W>
__device__ __forceinline__ float gate(const uint32_t (&m)[W], int nb, int i, float v) {
  return (m[nb >> 3] >> (4 * (nb & 7) + i)) & 1u ? v : 0.f;
}

// 0, from an instruction the compiler cannot look through.
__device__ __forceinline__ int opaque_zero() {
  int z;
  asm volatile("mov.b32 %0, 0;" : "=r"(z));
  return z;
}

// Rows r[0], r[1] of x in the A layout (columns 8 kb + 2t, 8 kb + 2t + 1);
// rows >= n read as zeros.
template <int KB>
__device__ __forceinline__ void load_rows(const float* __restrict__ x, const int (&r)[2],
                                          int n, int t, float (&v)[KB][4]) {
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r[i >> 1];
      v[kb][i] = row < n ? __ldg(x + (size_t)row * kIn + 8 * kb + 2 * t + (i & 1)) : 0.f;
    }
  }
}

// The VJP's shared memory: the staged weights, then for each warp 22 words
// a lane, parked lane-major: the 16 registers of the re-fed input gradient
// from lin3^T to lin0^T, and the 6 mask words of lin0, lin1 and lin2 from
// the forward pass to the transposed product that each gates.  None of them
// then holds a register through the products in between.
constexpr int kVjpPark = (DL::kSize + 3) / 4 * 4;
constexpr int kVjpParkWords = 16 + 6;
constexpr int kVjpSmem = (kVjpPark + kDecoderWarps * kVjpParkWords * 32) * sizeof(float);
static_assert(kVjpSmem <= 232448, "VJP shared memory");

__global__ void __launch_bounds__(kDecoderThreads, 1)
    decoder_vjp_kernel(const float* __restrict__ x, const float* __restrict__ up,
                       const float* __restrict__ wts, int n, float* __restrict__ dx) {
  extern __shared__ __align__(16) float sw[];
  stage_weights<DL, kDecoderThreads, true>(wts, sw);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int tiles = (n + 15) / 16;
  for (int tile = blockIdx.x * kDecoderWarps + (threadIdx.x >> 5); tile < tiles;
       tile += gridDim.x * kDecoderWarps) {
    const int r[2] = {tile * 16 + g, tile * 16 + g + 8};
    // The weights through an offset the compiler cannot see through: the
    // loads of the biases and the heads' columns, the same in every tile,
    // then stay in the loop rather than being hoisted out of it into some
    // 100 registers held across it (they spilled).
    const float* ws = sw + opaque_zero();
    float* park = sw + kVjpPark + (threadIdx.x >> 5) * kVjpParkWords * 32 + lane;
    // the masks' words: m0 at 0-1, m1 at 2-3, m2 at 4-5 (volatile: each is
    // stored once and read back where it gates, not kept in a register)
    volatile uint32_t* mp = reinterpret_cast<volatile uint32_t*>(park + 16 * 32);

    // Forward, keeping the masks.
    uint32_t m0[2], m1[2], m2[2], m3[2];
    float h[kH / 8][4];
    float acc[kH / 8][4];
    {
      float xf[kIn / 8][4];
      load_rows(x, r, n, t, xf);
      hidden<kIn / 8, kH / 8, false, true, true>(xf, ws + DL::kW0, ws + DL::kB0, lane, acc);
    }
    relu_bits<kH / 8>(acc, h, m0);
    mp[0] = m0[0]; mp[32] = m0[1];
    hidden<kH / 8, kH / 8, false, true, true>(h, ws + DL::kW1, ws + DL::kB1, lane, acc);
    relu_bits<kH / 8>(acc, h, m1);
    mp[64] = m1[0]; mp[96] = m1[1];
    {
      float acc2[kH2 / 8][4];
      hidden<kH / 8, kH2 / 8, false, true, true>(h, ws + DL::kW2, ws + DL::kB2, lane, acc2);
      relu_bits<kH2 / 8>(acc2, h, m2);
      mp[128] = m2[0]; mp[160] = m2[1];
    }
    // lin3 on [h | x]: h's 12 K blocks, then x's 4, read again (from L1)
    // only once h's blocks are spent, so that the two are never held together
    hidden<kH2 / 8, kH / 8, false, true, true>(reinterpret_cast<const float(&)[kH2 / 8][4]>(h),
                                               ws + DL::kW3, ws + DL::kB3, lane, acc);
    {
      float xf[kIn / 8][4];
      load_rows(x, r, n, t, xf);
      accumulate<kIn / 8, kH / 8, true, true>(xf, ws + DL::kW3 + kH2 * kH, lane, acc);
    }
    relu_bits<kH / 8>(acc, h, m3);

    // Heads in f32: each row's lin4 and unc sums, then its coefficients.
    float d4[2] = {0.f, 0.f}, du[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < kH / 8; ++nb) {
      const int k = 8 * nb + 2 * t;
      const float w4a = ws[DL::kW4 + k], w4b = ws[DL::kW4 + k + 1];
      const float wua = ws[DL::kWu + k], wub = ws[DL::kWu + k + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        d4[half] = fmaf(h[nb][2 * half + 1], w4b, fmaf(h[nb][2 * half], w4a, d4[half]));
        du[half] = fmaf(h[nb][2 * half + 1], wub, fmaf(h[nb][2 * half], wua, du[half]));
      }
    }
    float c4[2], cu[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        d4[half] += __shfl_xor_sync(0xffffffffu, d4[half], o);
        du[half] += __shfl_xor_sync(0xffffffffu, du[half], o);
      }
      const int row = r[half];
      const float g0 = row < n ? __ldg(up + 2 * (size_t)row) : 0.f;
      const float g1 = row < n ? __ldg(up + 2 * (size_t)row + 1) : 0.f;
      const float sdf = tanhf(d4[half] + ws[DL::kB4]);
      const float sig = 1.f / (1.f + expf(-(du[half] + ws[DL::kBu])));
      c4[half] = g0 * (1.f - sdf * sdf);
      cu[half] = g1 * (0.5f * sig);
    }

    // Reverse.  d3 = mask3 (c4 w4 + cu wu), into h.
#pragma unroll
    for (int nb = 0; nb < kH / 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 8 * nb + 2 * t + (i & 1);
        h[nb][i] = gate(m3, nb, i,
                        fmaf(c4[i >> 1], ws[DL::kW4 + k], cu[i >> 1] * ws[DL::kWu + k]));
        acc[nb][i] = 0.f;
      }
    }
    // lin3^T: the h branch (gated by lin2's mask) and the re-fed input
    accumulate_t<kH / 8, kH / 8>(h, ws + DL::kW3, lane, acc);
    m2[0] = mp[128]; m2[1] = mp[160];
#pragma unroll
    for (int kb = 0; kb < kIn / 8; ++kb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) park[(4 * kb + i) * 32] = acc[kH2 / 8 + kb][i];
    }
#pragma unroll
    for (int nb = 0; nb < kH / 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (nb < kH2 / 8) h[nb][i] = gate(m2, nb, i, acc[nb][i]);
        acc[nb][i] = 0.f;
      }
    }
    accumulate_t<kH2 / 8, kH / 8>(h, ws + DL::kW2, lane, acc);   // lin2^T
    m1[0] = mp[64]; m1[1] = mp[96];
#pragma unroll
    for (int nb = 0; nb < kH / 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[nb][i] = gate(m1, nb, i, acc[nb][i]);
        acc[nb][i] = 0.f;
      }
    }
    accumulate_t<kH / 8, kH / 8>(h, ws + DL::kW1, lane, acc);    // lin1^T
    m0[0] = mp[0]; m0[1] = mp[32];
#pragma unroll
    for (int nb = 0; nb < kH / 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) h[nb][i] = gate(m0, nb, i, acc[nb][i]);
    }
    float o[kIn / 8][4];
#pragma unroll
    for (int kb = 0; kb < kIn / 8; ++kb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) o[kb][i] = park[(4 * kb + i) * 32];
    }
    accumulate_t<kH / 8, kIn / 8>(h, ws + DL::kW0, lane, o);     // lin0^T + re-fed

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r[half];
      if (row >= n) continue;
#pragma unroll
      for (int nb = 0; nb < kIn / 8; ++nb)
        *reinterpret_cast<float2*>(dx + (size_t)row * kIn + 8 * nb + 2 * t) =
            make_float2(o[nb][2 * half], o[nb][2 * half + 1]);
    }
  }
}

int launch_decoder_vjp(const float* x, const float* up, const float* wts, int n, float* dx,
                       void* stream) {
  if (n <= 0) return 0;
  static int sms = 0;
  const cudaError_t e = prepare(decoder_vjp_kernel, kVjpSmem, sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (n + 15) / 16;
  const int wanted = (tiles + kDecoderWarps - 1) / kDecoderWarps;
  const int blocks = wanted < sms ? wanted : sms;
  decoder_vjp_kernel<<<blocks, kDecoderThreads, kVjpSmem,
                       static_cast<cudaStream_t>(stream)>>>(x, up, wts, n, dx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (n, 32) f32, wts packed decoder (49,890 f32) -> out (n, 2) = [sdf, std].
int decoder_forward(const float* x, const float* wts, int n, float* out,
                    void* stream) {
  return launch_decoder<false>(x, wts, n, out, nullptr, stream);
}

// As decoder_forward, plus grad (n, 3) = d sdf / d x[:, 29:32].
int decoder_forward_grad(const float* x, const float* wts, int n, float* out,
                         float* grad, void* stream) {
  return launch_decoder<true>(x, wts, n, out, grad, stream);
}

// x (n, 6) f32, wts packed encoder (27,264 f32) -> out (n, 29).
int encoder_forward(const float* x, const float* wts, int n, float* out,
                    void* stream) {
  return launch_encoder(x, wts, n, out, stream);
}

// x (n, 32) f32, g (n, 2) upstream gradient of [sdf, std], wts packed decoder
// (49,890 f32, as decoder_forward) -> dx (n, 32).
int decoder_vjp(const float* x, const float* g, const float* wts, int n, float* dx,
                void* stream) {
  return launch_decoder_vjp(x, g, wts, n, dx, stream);
}

}  // extern "C"
