// Hand-written CUDA (sm_90a) for the two small MLPs of the fusion loop.
//
// Replaces the Pallas kernels of the JAX package's ops/pallas_mlp.py:
//   decoder_forward, decoder_forward_grad <- _decoder_pallas_call (:98),
//       kernel _decoder_kernel (:82), entry decoder_forward_pallas (:113);
//   encoder_forward                       <- _encoder_pallas_call (:165),
//       kernel _encoder_kernel (:155), entry encoder_forward_pallas (:180).
//
// Decoder.  Its four hidden layers (lin0 32->128, lin1 128->128, lin2
// 128->96, lin3 [h 96 | x 32]->128) hold 49,152 MACs per point for 128 bytes
// in and 8 out, far above any ridge point: arithmetic bounds it.  They run as
// TF32 tensor-core products (mma.sync m16n8k8, f32 accumulate) with the
// 3xTF32 split, operand x = hi + lo, both TF32, and acc += a_lo w_hi,
// acc += a_hi w_lo, acc += a_hi w_hi: small terms first, hi.hi last.  That is
// as exact as f32 products (the JAX package's bf16x3 split is not: it misses
// the 1e-4 output tolerance on the mesher's inputs), at 3 passes of the TF32
// rate, where the f32 CUDA cores (67 TFLOP/s) bounded the earlier kernel.
// What bounds it now is the rate of mma.sync's TF32 products, about half of
// the 495 TFLOP/s that only wgmma reaches (PERF.md); the shared loads and the
// splits fit between them.
//
// Design: a persistent grid of one block per SM (at most); the block copies
// all the packed weights (199,560 bytes) into shared memory once and its 8
// warps then loop over 16-row tiles.  A warp keeps its tile's activations in
// registers across the layers: the host packs each hidden layer's (in, out)
// matrix in B-fragment order with the rows of every 8-wide K block permuted
// (fragment element (kb, nb, lane = 4g + t, j) = W[8kb + 2t + j][8nb + g]),
// so the m16n8 accumulator of one layer (row g, cols 2t and 2t+1) is the A
// fragment of the next with no shuffle and no trip through shared memory.
// Each B fragment is one conflict-free 8-byte shared load per lane.  Its
// split costs two instructions: the block stages each weight as
// trunc(w) + rna(w - trunc(w)), a sum f32 holds exactly and whose truncation
// gives the two parts back (rna = cvt.rna.tf32.f32: to nearest, ties away
// from zero).  An activation is split as rna(a) + rna(a - rna(a)), once per
// layer and K block, and serves the 12-16 N blocks of the layer.  The heads
// (lin4, unc: 128 -> 1) stay on the CUDA cores in f32: the four lanes of a
// row each sum 32 products, two xor-shuffles sum the row.
//
// The gradient variant carries, in forward mode, the three tangents
// d h / d xyz beside the activation: a tile holds 4 points x 4 planes (row
// 4p + s; plane 0 the activation, planes 1-3 the tangents).  A tangent row
// enters lin0 and lin3's re-fed input as the one-hot row of its xyz column,
// takes no bias, and takes the ReLU mask of its point's activation row, one
// shuffle from lane (lane & ~12) per accumulator register; the heads end with
// (1 - sdf^2) times the tangent's lin4 product.  The rows of one layer are
// thus handled by the same code in both variants.
//
// Encoder: f32 FMAs on the CUDA cores, one block per tile of P rows, one
// thread per output neuron.  The tile's activations live in shared memory and
// are updated in place: a layer accumulates its outputs in registers (P per
// thread), synchronises, then overwrites the tile.  Its folded weights
// (104 KB) are read through the read-only data cache, once per tile.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// ---- decoder: [latent 29 | xyz 3] -> 128 -> 128 -> 96 -> [h | x] 128 -> 128
//      -> sdf = tanh(lin4), std = 0.05 + 0.5 softplus(unc)
constexpr int kIn = 32;
constexpr int kLatent = 29;
constexpr int kH = 128;
constexpr int kH2 = 96;
// Packed weights (ops/mlp.py pack_decoder): the hidden layers' matrices in
// B-fragment order, each followed by its bias; then lin4 and unc as (128,)
// columns, each followed by its bias.
constexpr int kW0 = 0;
constexpr int kB0 = kW0 + kIn * kH;
constexpr int kW1 = kB0 + kH;
constexpr int kB1 = kW1 + kH * kH;
constexpr int kW2 = kB1 + kH;
constexpr int kB2 = kW2 + kH * kH2;
constexpr int kW3 = kB2 + kH2;
constexpr int kB3 = kW3 + kH * kH;
constexpr int kW4 = kB3 + kH;
constexpr int kB4 = kW4 + kH;
constexpr int kWu = kB4 + 1;
constexpr int kBu = kWu + kH;
constexpr int kDecoderSize = kBu + 1;
static_assert(kDecoderSize == 49890, "decoder packing");

constexpr int kDecoderWarps = 8;
constexpr int kDecoderThreads = 32 * kDecoderWarps;
constexpr int kDecoderSmem = kDecoderSize * sizeof(float);

// ---- encoder (cnp SharedMLP, eval BatchNorm folded): 6 -> 32 -> 64 -> 256 -> 29
constexpr int kEIn = 6;
constexpr int kEInPad = 8;
constexpr int kE1 = 32;
constexpr int kE2 = 64;
constexpr int kE3 = 256;
constexpr int kEOut = 29;
constexpr int kEW0 = 0;
constexpr int kEB0 = kEW0 + kEIn * kE1;
constexpr int kEW1 = kEB0 + kE1;
constexpr int kEB1 = kEW1 + kE1 * kE2;
constexpr int kEW2 = kEB1 + kE2;
constexpr int kEB2 = kEW2 + kE2 * kE3;
constexpr int kEW3 = kEB2 + kE3;
constexpr int kEB3 = kEW3 + kE3 * kEOut;
constexpr int kEncoderSize = kEB3 + kEOut;
static_assert(kEncoderSize == 26429, "encoder packing");

constexpr int kEncoderTile = 32;  // rows per block

// ---------------------------------------------------------------------------
// Decoder: 3xTF32 tensor-core layers.
// ---------------------------------------------------------------------------

constexpr uint32_t kTf32Mask = 0xffffe000u;  // sign, exponent, 10 mantissa bits

// TF32 rounding of cvt.rna.tf32.f32 (to nearest, ties away from zero, low 13
// bits cleared) in two integer instructions; cvt compiles to more, with a
// NaN test this kernel does not need.
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

// Whether packed index i lies in a hidden layer's matrix.  Each range starts
// and ends on a multiple of 4, for the 16-byte staging loads and the 8-byte
// fragment and bias loads.
__device__ __forceinline__ bool is_matrix(int i) {
  return i < kB0 || (i >= kW1 && i < kB1) || (i >= kW2 && i < kB2) ||
         (i >= kW3 && i < kB3);
}
static_assert(kB0 % 4 == 0 && kW1 % 4 == 0 && kB1 % 4 == 0 && kW2 % 4 == 0 &&
                  kB2 % 4 == 0 && kW3 % 4 == 0 && kB3 % 4 == 0,
              "16-byte staging loads");

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
// acc = bias + a W for one hidden layer, W in B-fragment order in shared
// memory.  Rows of a tangent plane (GRAD, plane != 0) take no bias.
template <int KB, int NB, bool GRAD>
__device__ __forceinline__ void hidden(const float (&a)[KB][4], const float* w,
                                       const float* b, int lane,
                                       float (&acc)[NB][4]) {
  static_assert(NB % 4 == 0, "N blocks go in fours");
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
  const float2* wf = reinterpret_cast<const float2*>(w) + lane;
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    // A fragment: a0 (g, k position t), a1 (g + 8, t), a2 (g, t + 4),
    // a3 (g + 8, t + 4); positions t and t + 4 hold columns 2t and 2t + 1.
    uint32_t ah[4], al[4];
    split(a[kb][0], ah[0], al[0]);
    split(a[kb][2], ah[1], al[1]);
    split(a[kb][1], ah[2], al[2]);
    split(a[kb][3], ah[3], al[3]);
    // Four N blocks at a time, pass by pass, so that neighbouring products
    // go to different accumulators.
#pragma unroll
    for (int n0 = 0; n0 < NB; n0 += 4) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 wv = wf[(kb * NB + n0 + q) * 32];
        split_staged(wv.x, bh[q][0], bl[q][0]);
        split_staged(wv.y, bh[q][1], bl[q][1]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) mma(acc[n0 + q], al, bh[q][0], bh[q][1]);
#pragma unroll
      for (int q = 0; q < 4; ++q) mma(acc[n0 + q], ah, bl[q][0], bl[q][1]);
#pragma unroll
      for (int q = 0; q < 4; ++q) mma(acc[n0 + q], ah, bh[q][0], bh[q][1]);
    }
  }
}

// h = relu(acc).  In the gradient variant a tangent row is gated by its
// point's activation row, which lane (lane & ~12) holds in the same register
// (for an activation row that lane is the thread itself).
template <int NB, bool GRAD>
__device__ __forceinline__ void relu(const float (&acc)[NB][4], int lane,
                                     float (&h)[kH / 8][4]) {
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

template <bool GRAD>
__global__ void __launch_bounds__(kDecoderThreads, 1)
    decoder_kernel(const float* __restrict__ x, const float* __restrict__ wts,
                   int n, float* __restrict__ out, float* __restrict__ grad) {
  extern __shared__ __align__(16) float sw[];
  // Stage the weights, 16 bytes a load where the buffer allows it.
  int staged = 0;
  if ((reinterpret_cast<uintptr_t>(wts) & 15) == 0) {
    const float4* src = reinterpret_cast<const float4*>(wts);
    float4* dst = reinterpret_cast<float4*>(sw);
#pragma unroll 8
    for (int i = threadIdx.x; i < kDecoderSize / 4; i += kDecoderThreads) {
      float4 v = __ldg(src + i);
      if (is_matrix(4 * i)) {
        v.x = stage_weight(v.x);
        v.y = stage_weight(v.y);
        v.z = stage_weight(v.z);
        v.w = stage_weight(v.w);
      }
      dst[i] = v;
    }
    staged = kDecoderSize / 4 * 4;
  }
  for (int i = staged + threadIdx.x; i < kDecoderSize; i += kDecoderThreads) {
    const float v = __ldg(wts + i);
    sw[i] = is_matrix(i) ? stage_weight(v) : v;
  }
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
    hidden<kIn / 8, kH / 8, GRAD>(xf, sw + kW0, sw + kB0, lane, acc);
    relu<kH / 8, GRAD>(acc, lane, h);
    hidden<kH / 8, kH / 8, GRAD>(h, sw + kW1, sw + kB1, lane, acc);
    relu<kH / 8, GRAD>(acc, lane, h);
    {
      float acc2[kH2 / 8][4];
      hidden<kH / 8, kH2 / 8, GRAD>(h, sw + kW2, sw + kB2, lane, acc2);
      relu<kH2 / 8, GRAD>(acc2, lane, h);
    }
    // latent_in at lin3: the input re-fed into columns 96..127
#pragma unroll
    for (int kb = 0; kb < kIn / 8; ++kb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) h[kH2 / 8 + kb][i] = xf[kb][i];
    }
    hidden<kH / 8, kH / 8, GRAD>(h, sw + kW3, sw + kB3, lane, acc);
    relu<kH / 8, GRAD>(acc, lane, h);

    // Heads in f32: lin4 (the sdf, or a tangent's d sdf) and unc.
    float d4[2] = {0.f, 0.f}, du[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < kH / 8; ++nb) {
      const int k = 8 * nb + 2 * t;
      const float w4a = sw[kW4 + k], w4b = sw[kW4 + k + 1];
      const float wua = sw[kWu + k], wub = sw[kWu + k + 1];
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
      sdf[half] = tanhf(pre + sw[kB4]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r[half];
      if (t != 0 || row >= n) continue;
      if (s == 0) {
        const float z = du[half] + sw[kBu];
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
  static int sms = 0;  // per instantiation: set once, with the smem attribute
  if (sms == 0) {
    int dev = 0, count = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(decoder_kernel<GRAD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kDecoderSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sms = count;
  }
  constexpr int P = GRAD ? 4 : 16;
  const int tiles = (n + P - 1) / P;
  const int wanted = (tiles + kDecoderWarps - 1) / kDecoderWarps;
  const int blocks = wanted < sms ? wanted : sms;
  decoder_kernel<GRAD><<<blocks, kDecoderThreads, kDecoderSmem,
                         static_cast<cudaStream_t>(stream)>>>(x, wts, n, out, grad);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Encoder: f32 CUDA cores.
// ---------------------------------------------------------------------------

// acc[p] += sum_{k < IN} buf[p * LD + k] * w[k * OUT + j] over the P rows.
template <int P, int IN, int LD, int OUT>
__device__ __forceinline__ void accumulate(const float* buf,
                                           const float* __restrict__ w, int j,
                                           float (&acc)[P]) {
  static_assert(IN % 4 == 0 && LD % 4 == 0, "float4 activation reads");
#pragma unroll 2
  for (int k = 0; k < IN; k += 4) {
    const float w0 = __ldg(w + (k + 0) * OUT + j);
    const float w1 = __ldg(w + (k + 1) * OUT + j);
    const float w2 = __ldg(w + (k + 2) * OUT + j);
    const float w3 = __ldg(w + (k + 3) * OUT + j);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float4 a = *reinterpret_cast<const float4*>(buf + p * LD + k);
      float v = acc[p];
      v = fmaf(a.x, w0, v);
      v = fmaf(a.y, w1, v);
      v = fmaf(a.z, w2, v);
      v = fmaf(a.w, w3, v);
      acc[p] = v;
    }
  }
}

// Pre-activations of one layer for the thread's output j (bias included).
template <int P, int IN, int LD, int OUT>
__device__ __forceinline__ void dense(const float* buf,
                                      const float* __restrict__ w,
                                      const float* __restrict__ b, int j,
                                      float (&acc)[P]) {
  const float bj = __ldg(b + j);
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = bj;
  accumulate<P, IN, LD, OUT>(buf, w, j, acc);
}

// Writes relu(acc) into column j.
template <int P, int LD>
__device__ __forceinline__ void store_relu(float* buf, int j, const float (&acc)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) buf[p * LD + j] = acc[p] > 0.f ? acc[p] : 0.f;
}

template <int P>
__global__ void __launch_bounds__(kE3)
    encoder_kernel(const float* __restrict__ x, const float* __restrict__ wts,
                   int n, float* __restrict__ out) {
  __shared__ __align__(16) float xs[P * kEInPad];
  __shared__ __align__(16) float buf[P * kE3];
  const int j = threadIdx.x;
  const int row0 = blockIdx.x * P;
  for (int i = j; i < P * kEIn; i += kE3) {
    const int p = i / kEIn;
    xs[p * kEInPad + i % kEIn] = row0 + p < n ? x[(size_t)row0 * kEIn + i] : 0.f;
  }
  __syncthreads();
  float acc[P];
  // layer0: 6 -> 32 (scalar reads: 6 is no multiple of 4)
  if (j < kE1) {
    const float bj = __ldg(wts + kEB0 + j);
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = bj;
    for (int k = 0; k < kEIn; ++k) {
      const float w = __ldg(wts + kEW0 + k * kE1 + j);
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] = fmaf(xs[p * kEInPad + k], w, acc[p]);
    }
    store_relu<P, kE3>(buf, j, acc);
  }
  __syncthreads();
  // layer1: 32 -> 64
  if (j < kE2) dense<P, kE1, kE3, kE2>(buf, wts + kEW1, wts + kEB1, j, acc);
  __syncthreads();
  if (j < kE2) store_relu<P, kE3>(buf, j, acc);
  __syncthreads();
  // layer2: 64 -> 256
  dense<P, kE2, kE3, kE3>(buf, wts + kEW2, wts + kEB2, j, acc);
  __syncthreads();
  store_relu<P, kE3>(buf, j, acc);
  __syncthreads();
  // layer3: 256 -> 29, no activation.  Only 29 outputs, so the reduction is
  // split: 8 neighbouring lanes share output o and take every 8th input,
  // then combine with warp shuffles.
  const int o = j >> 3;
  const int slice = j & 7;
  float a[P];
#pragma unroll
  for (int p = 0; p < P; ++p) a[p] = 0.f;
  if (o < kEOut) {
    for (int k = slice; k < kE3; k += 8) {
      const float w = __ldg(wts + kEW3 + k * kEOut + o);
#pragma unroll
      for (int p = 0; p < P; ++p) a[p] = fmaf(buf[p * kE3 + k], w, a[p]);
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    a[p] += __shfl_xor_sync(0xffffffffu, a[p], 4);
    a[p] += __shfl_xor_sync(0xffffffffu, a[p], 2);
    a[p] += __shfl_xor_sync(0xffffffffu, a[p], 1);
  }
  if (o < kEOut && slice == 0) {
    const float bo = __ldg(wts + kEB3 + o);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (row0 + p < n) out[(size_t)(row0 + p) * kEOut + o] = a[p] + bo;
    }
  }
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

// x (n, 6) f32, wts packed encoder (26,429 f32) -> out (n, 29).
int encoder_forward(const float* x, const float* wts, int n, float* out,
                    void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kEncoderTile - 1) / kEncoderTile;
  encoder_kernel<kEncoderTile>
      <<<blocks, kE3, 0, static_cast<cudaStream_t>(stream)>>>(x, wts, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
