// Hand-written CUDA (sm_90a) windowed point-statistics stencil.
//
// Replaces the Pallas kernel of the JAX package's ops/pallas_stencil.py
// (_padded_call :190, pl.pallas_call :202):
//   stencil_normals <- normals_stencil_pallas (:218): 7x7 window (halo 3),
//       count of valid neighbours within the radius (centre included), their
//       mean and 3x3 covariance, the closed-form smallest eigenvector,
//       camera-facing and unit;
//   stencil_count   <- neighbor_count_pallas (:238): the count only.
//
// What bounds it on an H100: at the frontend's 320x240 the whole pass moves
// about 1.3 MB and does about 0.1 GFLOP, a few microseconds of work at the
// card's rates; a launch costs as much, so it is launch-bound.  That is
// recorded, not tuned.
//
// Design: one thread per pixel of a 32x8 output tile.  The tile plus a 3-pixel
// halo of the three point planes and the validity mask is staged in shared
// memory; the accumulators stay in registers.  Pixels outside the image are
// invalid (the Pallas kernel's zero padding).  Taps run dy, dx = -3..3 over the
// neighbour at (y - dy, x - dx), the order of the plain PyTorch version, and
// the squared distance is rounded without FMA contraction so the counts are
// those of the plain version exactly.  acosf replaces the Pallas kernel's
// polynomial (a Mosaic workaround).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kHalo = 3;
constexpr int kTX = 32;
constexpr int kTY = 8;
constexpr int kSX = kTX + 2 * kHalo;
constexpr int kSY = kTY + 2 * kHalo;
constexpr float kPi = 3.14159265358979323846f;

template <bool NORMALS>
__global__ void __launch_bounds__(kTX * kTY)
    stencil_kernel(const float* __restrict__ pts,
                   const uint8_t* __restrict__ valid, int H, int W, float r2,
                   float* __restrict__ normals, float* __restrict__ count) {
  __shared__ float sx[kSY][kSX];
  __shared__ float sy[kSY][kSX];
  __shared__ float sz[kSY][kSX];
  __shared__ uint8_t sv[kSY][kSX];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int x0 = blockIdx.x * kTX - kHalo;
  const int y0 = blockIdx.y * kTY - kHalo;
  const size_t plane = (size_t)H * W;
  for (int i = ty * kTX + tx; i < kSX * kSY; i += kTX * kTY) {
    const int ly = i / kSX;
    const int lx = i % kSX;
    const int gy = y0 + ly;
    const int gx = x0 + lx;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const size_t o = in ? (size_t)gy * W + gx : 0;
    sx[ly][lx] = in ? pts[o] : 0.f;
    sy[ly][lx] = in ? pts[plane + o] : 0.f;
    sz[ly][lx] = in ? pts[2 * plane + o] : 0.f;
    sv[ly][lx] = in ? valid[o] : 0;
  }
  __syncthreads();
  const int x = blockIdx.x * kTX + tx;
  const int y = blockIdx.y * kTY + ty;
  if (x >= W || y >= H) return;

  const float cx = sx[ty + kHalo][tx + kHalo];
  const float cy = sy[ty + kHalo][tx + kHalo];
  const float cz = sz[ty + kHalo][tx + kHalo];
  float cnt = 0.f;
  float s1x = 0.f, s1y = 0.f, s1z = 0.f;
  float sxx = 0.f, sxy = 0.f, sxz = 0.f, syy = 0.f, syz = 0.f, szz = 0.f;
  if (sv[ty + kHalo][tx + kHalo]) {
#pragma unroll
    for (int dy = -kHalo; dy <= kHalo; ++dy) {
#pragma unroll
      for (int dx = -kHalo; dx <= kHalo; ++dx) {
        const int ly = ty + kHalo - dy;
        const int lx = tx + kHalo - dx;
        const float nx = sx[ly][lx];
        const float ny = sy[ly][lx];
        const float nz = sz[ly][lx];
        const float ex = nx - cx;
        const float ey = ny - cy;
        const float ez = nz - cz;
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                                   __fmul_rn(ez, ez));
        if (sv[ly][lx] && d2 <= r2) {
          cnt += 1.f;
          if (NORMALS) {
            s1x += nx;
            s1y += ny;
            s1z += nz;
            sxx += nx * nx;
            sxy += nx * ny;
            sxz += nx * nz;
            syy += ny * ny;
            syz += ny * nz;
            szz += nz * nz;
          }
        }
      }
    }
  }
  const size_t o = (size_t)y * W + x;
  count[o] = cnt;
  if (!NORMALS) return;

  const float denom = fmaxf(cnt, 1.f);
  const float mx = s1x / denom, my = s1y / denom, mz = s1z / denom;
  const float a00 = sxx / denom - mx * mx;
  const float a01 = sxy / denom - mx * my;
  const float a02 = sxz / denom - mx * mz;
  const float a11 = syy / denom - my * my;
  const float a12 = syz / denom - my * mz;
  const float a22 = szz / denom - mz * mz;
  // Trigonometric smallest eigenvalue (Smith), then the eigenvector as the
  // largest cross product of two rows of (A - lam I).
  const float p1 = a01 * a01 + a02 * a02 + a12 * a12;
  const float q = (a00 + a11 + a22) / 3.f;
  const float p2 = (a00 - q) * (a00 - q) + (a11 - q) * (a11 - q) +
                   (a22 - q) * (a22 - q) + 2.f * p1;
  const float p = sqrtf(fmaxf(p2 / 6.f, 1e-30f));
  const float b00 = (a00 - q) / p, b11 = (a11 - q) / p, b22 = (a22 - q) / p;
  const float b01 = a01 / p, b02 = a02 / p, b12 = a12 / p;
  const float detB = b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02) +
                     b02 * (b01 * b12 - b11 * b02);
  const float r = fminf(fmaxf(detB / 2.f, -1.f), 1.f);
  const float phi = acosf(r) / 3.f;
  const float lam = q + 2.f * p * cosf(phi + 2.f * kPi / 3.f);
  const float r0x = a00 - lam, r0y = a01, r0z = a02;
  const float r1x = a01, r1y = a11 - lam, r1z = a12;
  const float r2x = a02, r2y = a12, r2z = a22 - lam;
  const float c01x = r0y * r1z - r0z * r1y, c01y = r0z * r1x - r0x * r1z,
              c01z = r0x * r1y - r0y * r1x;
  const float c02x = r0y * r2z - r0z * r2y, c02y = r0z * r2x - r0x * r2z,
              c02z = r0x * r2y - r0y * r2x;
  const float c12x = r1y * r2z - r1z * r2y, c12y = r1z * r2x - r1x * r2z,
              c12z = r1x * r2y - r1y * r2x;
  const float n01 = c01x * c01x + c01y * c01y + c01z * c01z;
  const float n02 = c02x * c02x + c02y * c02y + c02z * c02z;
  const float n12 = c12x * c12x + c12y * c12y + c12z * c12z;
  float vx, vy, vz;
  if (n01 >= fmaxf(n02, n12)) {
    vx = c01x; vy = c01y; vz = c01z;
  } else if (n02 >= n12) {
    vx = c02x; vy = c02y; vz = c02z;
  } else {
    vx = c12x; vy = c12y; vz = c12z;
  }
  // camera at the origin: flip toward -p, then normalise
  const float flip = (vx * cx + vy * cy + vz * cz) > 0.f ? -1.f : 1.f;
  const float inv = flip / sqrtf(fmaxf(vx * vx + vy * vy + vz * vz, 1e-24f));
  normals[o] = vx * inv;
  normals[plane + o] = vy * inv;
  normals[2 * plane + o] = vz * inv;
}

}  // namespace

extern "C" {

// pts (3, h, w) f32, valid (h, w) u8, r2 = radius^2
// -> normals (3, h, w) f32, count (h, w) f32 (centre included).
int stencil_normals(const float* pts, const uint8_t* valid, int h, int w,
                    float r2, float* normals, float* count, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const dim3 block(kTX, kTY);
  const dim3 grid((w + kTX - 1) / kTX, (h + kTY - 1) / kTY);
  stencil_kernel<true><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, valid, h, w, r2, normals, count);
  return static_cast<int>(cudaGetLastError());
}

// pts (3, h, w) f32, valid (h, w) u8 -> count (h, w) f32 (centre included).
int stencil_count(const float* pts, const uint8_t* valid, int h, int w,
                  float r2, float* count, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const dim3 block(kTX, kTY);
  const dim3 grid((w + kTX - 1) / kTX, (h + kTY - 1) / kTY);
  stencil_kernel<false><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, valid, h, w, r2, nullptr, count);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
