// Hand-written CUDA (sm_90a) for the two small MLPs of the fusion loop.
//
// Replaces the Pallas kernels of the JAX package's ops/pallas_mlp.py:
//   decoder_forward, decoder_forward_grad <- _decoder_pallas_call (:98),
//       kernel _decoder_kernel (:82), entry decoder_forward_pallas (:113);
//   encoder_forward                       <- _encoder_pallas_call (:165),
//       kernel _encoder_kernel (:155), entry encoder_forward_pallas (:180).
//
// What bounds them on an H100: arithmetic.  The decoder does 98,816 FLOP per
// point for 128 bytes in and 8 out, the encoder 52,096 FLOP per row for 24
// bytes in and 116 out; both sit far above the f32 ridge point (67 TFLOP/s
// over 3.35 TB/s = 20 FLOP/byte), so the f32 CUDA-core rate is their bound.
//
// Design (simple first): one block per tile of P points, one thread per
// output neuron.  The tile's activations live in shared memory and are
// updated in place: a layer accumulates its outputs in registers (P per
// thread), synchronises, then overwrites the tile.  The folded f32 weights
// (198 KB for the decoder, 104 KB for the encoder) are read through the
// read-only data cache: each weight is loaded once per tile and applied to P
// points held in registers, so weight traffic per FLOP falls as 1/P and stays
// in L1/L2.  Activations are read four at a time as float4 broadcasts.  All
// arithmetic is f32 whatever the mesher's decode-precision setting (the TPU's
// one-pass bf16 "default" decode has no counterpart here).
//
// The decoder's gradient variant carries, in forward mode, the three tangents
// d h / d xyz beside the activation (masked by each ReLU), injects the tangent
// of the re-fed input at lin3 and ends with (1 - sdf^2): the gradient of sdf
// w.r.t. the last three input columns, at three extra mat-vecs per layer and
// with no stored activations.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// ---- decoder: [latent 29 | xyz 3] -> 128 -> 128 -> 96 -> [h | x] 128 -> 128
//      -> sdf = tanh(lin4), std = 0.05 + 0.5 softplus(unc)
constexpr int kIn = 32;
constexpr int kLatent = 29;
constexpr int kH = 128;
constexpr int kH2 = 96;
// Packed weights: (in, out) row-major matrices, each followed by its bias.
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

constexpr int kDecoderTile = 32;      // points per block, forward
constexpr int kDecoderGradTile = 16;  // points per block, forward + gradient
constexpr int kEncoderTile = 32;      // rows per block

// acc[s][p] += sum_{k < IN} buf[(s * P + p) * LD + k] * w[k * OUT + j]
// for the NT stacked planes of the tile (the activation, then the tangents).
template <int P, int NT, int IN, int LD, int OUT>
__device__ __forceinline__ void accumulate(const float* buf,
                                           const float* __restrict__ w, int j,
                                           float (&acc)[NT][P]) {
  static_assert(IN % 4 == 0 && LD % 4 == 0, "float4 activation reads");
#pragma unroll 2
  for (int k = 0; k < IN; k += 4) {
    const float w0 = __ldg(w + (k + 0) * OUT + j);
    const float w1 = __ldg(w + (k + 1) * OUT + j);
    const float w2 = __ldg(w + (k + 2) * OUT + j);
    const float w3 = __ldg(w + (k + 3) * OUT + j);
#pragma unroll
    for (int s = 0; s < NT; ++s) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float4 a =
            *reinterpret_cast<const float4*>(buf + (s * P + p) * LD + k);
        float v = acc[s][p];
        v = fmaf(a.x, w0, v);
        v = fmaf(a.y, w1, v);
        v = fmaf(a.z, w2, v);
        v = fmaf(a.w, w3, v);
        acc[s][p] = v;
      }
    }
  }
}

// Pre-activations of one layer for the thread's output j (bias included).
template <int P, int NT, int IN, int LD, int OUT>
__device__ __forceinline__ void dense(const float* buf,
                                      const float* __restrict__ w,
                                      const float* __restrict__ b, int j,
                                      float (&acc)[NT][P]) {
  const float bj = __ldg(b + j);
#pragma unroll
  for (int s = 0; s < NT; ++s) {
#pragma unroll
    for (int p = 0; p < P; ++p) acc[s][p] = s == 0 ? bj : 0.f;
  }
  accumulate<P, NT, IN, LD, OUT>(buf, w, j, acc);
}

// Writes relu(acc[0]) and the ReLU-masked tangents acc[1..] into column j.
template <int P, int NT, int LD>
__device__ __forceinline__ void store_relu(float* buf, int j,
                                           const float (&acc)[NT][P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const bool on = acc[0][p] > 0.f;
    buf[p * LD + j] = on ? acc[0][p] : 0.f;
#pragma unroll
    for (int s = 1; s < NT; ++s) buf[(s * P + p) * LD + j] = on ? acc[s][p] : 0.f;
  }
}

template <int P, bool GRAD>
__global__ void __launch_bounds__(kH)
    decoder_kernel(const float* __restrict__ x, const float* __restrict__ wts,
                   int n, float* __restrict__ out, float* __restrict__ grad) {
  constexpr int NT = GRAD ? 4 : 1;  // activation (+ 3 tangents)
  __shared__ __align__(16) float xs[P * kIn];
  __shared__ __align__(16) float buf[NT * P * kH];
  const int j = threadIdx.x;
  const int row0 = blockIdx.x * P;
  for (int i = j; i < P * kIn; i += kH) {
    const int r = row0 + i / kIn;
    xs[i] = r < n ? x[(size_t)row0 * kIn + i] : 0.f;
  }
  __syncthreads();

  float acc[NT][P];
  // lin0: 32 -> 128.  The input tangent is one-hot, so the pre-activation
  // tangent of output j is the weight row of that xyz column.
  {
    float a[1][P];
    dense<P, 1, kIn, kIn, kH>(xs, wts + kW0, wts + kB0, j, a);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      acc[0][p] = a[0][p];
#pragma unroll
      for (int s = 1; s < NT; ++s)
        acc[s][p] = __ldg(wts + kW0 + (kLatent + s - 1) * kH + j);
    }
    store_relu<P, NT, kH>(buf, j, acc);
  }
  __syncthreads();
  // lin1: 128 -> 128
  dense<P, NT, kH, kH, kH>(buf, wts + kW1, wts + kB1, j, acc);
  __syncthreads();
  store_relu<P, NT, kH>(buf, j, acc);
  __syncthreads();
  // lin2: 128 -> 96, then the input is re-fed into columns 96..127
  // (latent_in at lin3) with its one-hot tangent.
  if (j < kH2) dense<P, NT, kH, kH, kH2>(buf, wts + kW2, wts + kB2, j, acc);
  __syncthreads();
  if (j < kH2) {
    store_relu<P, NT, kH>(buf, j, acc);
  } else {
    const int c = j - kH2;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      buf[p * kH + j] = xs[p * kIn + c];
#pragma unroll
      for (int s = 1; s < NT; ++s)
        buf[(s * P + p) * kH + j] = c == kLatent + s - 1 ? 1.f : 0.f;
    }
  }
  __syncthreads();
  // lin3: 128 -> 128
  dense<P, NT, kH, kH, kH>(buf, wts + kW3, wts + kB3, j, acc);
  __syncthreads();
  store_relu<P, NT, kH>(buf, j, acc);
  __syncthreads();

  // Heads: one warp per point, lanes split the 128-wide dot products.
  const int warp = j >> 5;
  const int lane = j & 31;
  for (int p = warp; p < P; p += kH / 32) {
    float s = 0.f, u = 0.f;
    float g[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) g[t] = 0.f;
#pragma unroll
    for (int m = 0; m < kH / 32; ++m) {
      const int k = lane + 32 * m;
      const float w4 = __ldg(wts + kW4 + k);
      const float h = buf[p * kH + k];
      s = fmaf(h, w4, s);
      u = fmaf(h, __ldg(wts + kWu + k), u);
#pragma unroll
      for (int t = 1; t < NT; ++t) g[t] = fmaf(buf[(t * P + p) * kH + k], w4, g[t]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      u += __shfl_xor_sync(0xffffffffu, u, o);
#pragma unroll
      for (int t = 1; t < NT; ++t) g[t] += __shfl_xor_sync(0xffffffffu, g[t], o);
    }
    const int r = row0 + p;
    if (lane == 0 && r < n) {
      const float sdf = tanhf(s + __ldg(wts + kB4));
      const float z = u + __ldg(wts + kBu);
      const float softplus = fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
      out[2 * (size_t)r] = sdf;
      out[2 * (size_t)r + 1] = 0.05f + 0.5f * softplus;
      if (GRAD) {
        const float dtanh = 1.f - sdf * sdf;
#pragma unroll
        for (int t = 1; t < NT; ++t) grad[3 * (size_t)r + t - 1] = dtanh * g[t];
      }
    }
  }
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
  float acc[1][P];
  // layer0: 6 -> 32 (scalar reads: 6 is no multiple of 4)
  if (j < kE1) {
    const float bj = __ldg(wts + kEB0 + j);
#pragma unroll
    for (int p = 0; p < P; ++p) acc[0][p] = bj;
    for (int k = 0; k < kEIn; ++k) {
      const float w = __ldg(wts + kEW0 + k * kE1 + j);
#pragma unroll
      for (int p = 0; p < P; ++p) acc[0][p] = fmaf(xs[p * kEInPad + k], w, acc[0][p]);
    }
    store_relu<P, 1, kE3>(buf, j, acc);
  }
  __syncthreads();
  // layer1: 32 -> 64
  if (j < kE2) dense<P, 1, kE1, kE3, kE2>(buf, wts + kEW1, wts + kEB1, j, acc);
  __syncthreads();
  if (j < kE2) store_relu<P, 1, kE3>(buf, j, acc);
  __syncthreads();
  // layer2: 64 -> 256
  dense<P, 1, kE2, kE3, kE3>(buf, wts + kEW2, wts + kEB2, j, acc);
  __syncthreads();
  store_relu<P, 1, kE3>(buf, j, acc);
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
  if (n <= 0) return 0;
  const int blocks = (n + kDecoderTile - 1) / kDecoderTile;
  decoder_kernel<kDecoderTile, false>
      <<<blocks, kH, 0, static_cast<cudaStream_t>(stream)>>>(x, wts, n, out,
                                                             nullptr);
  return static_cast<int>(cudaGetLastError());
}

// As decoder_forward, plus grad (n, 3) = d sdf / d x[:, 29:32].
int decoder_forward_grad(const float* x, const float* wts, int n, float* out,
                         float* grad, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kDecoderGradTile - 1) / kDecoderGradTile;
  decoder_kernel<kDecoderGradTile, true>
      <<<blocks, kH, 0, static_cast<cudaStream_t>(stream)>>>(x, wts, n, out,
                                                             grad);
  return static_cast<int>(cudaGetLastError());
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
