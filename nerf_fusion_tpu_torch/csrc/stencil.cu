// Hand-written CUDA (sm_90a) windowed point-statistics stencil: one template,
// three entries.
//
// Replaces the Pallas kernel of the JAX package's ops/pallas_stencil.py
// (_padded_call :190, pl.pallas_call :202):
//   stencil_normals  <- normals_stencil_pallas (:218): 7x7 window, count of
//       valid neighbours within the radius (centre included), their 3x3
//       covariance, the closed-form smallest eigenvector, camera-facing, unit;
//   stencil_count    <- neighbor_count_pallas (:238): the count only;
//   stencil_frontend <- both in turn as the frontend composes them, in one
//       launch: depth -> unprojected points, the radius-outlier count and its
//       gate, the normals on the gated mask, the normal gate and the final
//       mask.  It takes the place of two launches and about 25 small PyTorch
//       kernels a frame.
//
// What bounds it on an H100: nothing the data sheet lists.  At the frontend's
// 320x240 the fused pass moves 2.2 MB (0.7 us at 3.35 TB/s) and needs about
// 0.1 GFLOP (1.7 us at the f32 peak); a launch and a one-wave grid cost as
// much.  The time is a dependent chain (load, stage, barrier, 49 taps twice,
// the eigen-solve), so the design shortens the chain and keeps every SM busy
// for one wave.
//
// Design.
//  * Each block stages its output tile plus a halo as one float4 per pixel:
//    (x, y, z, t), where t is the squared radius the pixel may be counted
//    within, or -1 for an invalid pixel and for one outside the image (the
//    Pallas kernel's zero padding).  A tap is then one 16-byte shared load, the
//    squared distance, and one comparison d2 <= t: no validity load, no branch.
//    What a tap adds is chosen by selects, so a warp never diverges in the
//    window and a NaN in an invalid pixel's coordinates cannot leak.
//  * The squared distance is rounded without FMA contraction, in the plain
//    PyTorch version's order, so the counts are the plain version's exactly.
//  * The moments are taken about the centre pixel (the differences the
//    distance already needs): the covariance is the same and loses no digits
//    to the cancellation of E[p p^T] - E[p] E[p]^T.
//  * One pixel a thread.  A thread can own kPPT vertically adjacent pixels
//    and walk the union of their windows once, loading a staged pixel once for
//    up to kPPT taps; at 320x240 two pixels a thread measured slower (half the
//    warps to hide the taps' latency behind), so kPPT is 1.
//  * The eigen-solve takes one reciprocal of the count and one of p; acosf
//    stays, the cosine (argument in [2 pi / 3, pi]) is the hardware's __cosf.
//  * stencil_frontend stages only depth, with a 6-pixel halo, and unprojects
//    while staging in PyTorch's order ((u - cx) * (1 / fx) * depth: on a CUDA
//    tensor PyTorch divides by a Python scalar as a product with its
//    reciprocal, which the wrapper passes in), so its points are bitwise the
//    plain version's.  Phase 1 counts at the outlier radius for every staged
//    pixel within 3 of the tile and writes the gate back into t (now the
//    normal radius, or -1); phase 2 runs the normals on the tile's own pixels
//    against the gated t.  The counts at the tile's border are computed by two
//    or four blocks (1.54x of the count for a 32x20 tile): that is cheaper
//    than a second launch and a round trip through device memory.
//  * Tile 32x20: 120 blocks at 320x240, one wave on 132 SMs with no second
//    block on any SM.  STENCIL_TX / STENCIL_TY / STENCIL_PPT override the shape
//    for the variant probe (tools/stencil_variants.py).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#ifndef STENCIL_TX
#define STENCIL_TX 32
#endif
#ifndef STENCIL_TY
#define STENCIL_TY 20
#endif
#ifndef STENCIL_PPT
#define STENCIL_PPT 1
#endif

namespace {

constexpr int kWin = 3;  // window radius in pixels: 7x7 taps
constexpr int kTX = STENCIL_TX;
constexpr int kTY = STENCIL_TY;
constexpr int kPPT = STENCIL_PPT;  // pixels a thread owns, vertically adjacent
constexpr int kThreads = kTX * kTY / kPPT;
static_assert(kTY % kPPT == 0 && (kTY + 2 * kWin) % kPPT == 0,
              "the tile and its phase-1 region must split into whole threads");
constexpr float kPi = 3.14159265358979323846f;

enum Mode { kCount, kNormals, kFrontend };

struct Args {
  const float* __restrict__ pts;      // kCount, kNormals: (3, H, W)
  const uint8_t* __restrict__ valid;  // kCount, kNormals: (H, W)
  const float* __restrict__ depth;    // kFrontend: (H, W), NaN invalid
  int H, W;
  float cx, cy, inv_fx, inv_fy;  // kFrontend
  float r2_outlier;              // kFrontend: phase 1 radius^2
  float min_outlier;             // kFrontend: neighbours (centre excluded) to pass
  float r2;                      // the radius^2 of the count or the normals
  float min_normal;              // kFrontend: count (centre included) to pass
  float* __restrict__ pts_out;   // kFrontend: (3, H, W)
  float* __restrict__ normals;   // kNormals, kFrontend: (3, H, W)
  float* __restrict__ count;     // kCount, kNormals: (H, W)
  uint8_t* __restrict__ mask;    // kFrontend: (H, W)
};

// Count and, with NORMALS, first and second moments about the centre.
struct Moments {
  float n = 0.f;
  float sx = 0.f, sy = 0.f, sz = 0.f;
  float sxx = 0.f, sxy = 0.f, sxz = 0.f, syy = 0.f, syz = 0.f, szz = 0.f;
};

// The 7x7 windows of the kPPT pixels at staged (ly + i, lx): every staged
// pixel of their union is loaded once and added to each window it lies in.
// The order of the taps changes nothing in the counts and only the rounding
// of the moments.
template <bool NORMALS, int PITCH>
__device__ __forceinline__ void windows(const float4* __restrict__ s, int ly, int lx,
                                        const float4 (&c)[kPPT], Moments (&m)[kPPT]) {
#pragma unroll
  for (int wy = -kWin; wy < kPPT + kWin; ++wy) {
#pragma unroll
    for (int dx = -kWin; dx <= kWin; ++dx) {
      const float4 q = s[(ly + wy) * PITCH + (lx + dx)];
#pragma unroll
      for (int i = 0; i < kPPT; ++i) {
        if (wy - i < -kWin || wy - i > kWin) continue;
        const float ex = q.x - c[i].x;
        const float ey = q.y - c[i].y;
        const float ez = q.z - c[i].z;
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                                   __fmul_rn(ez, ez));
        const bool in = d2 <= q.w;
        m[i].n += in ? 1.f : 0.f;
        if (NORMALS) {
          const float wx = in ? ex : 0.f;
          const float wy_ = in ? ey : 0.f;
          const float wz = in ? ez : 0.f;
          m[i].sx += wx;
          m[i].sy += wy_;
          m[i].sz += wz;
          m[i].sxx = fmaf(wx, ex, m[i].sxx);
          m[i].sxy = fmaf(wx, ey, m[i].sxy);
          m[i].sxz = fmaf(wx, ez, m[i].sxz);
          m[i].syy = fmaf(wy_, ey, m[i].syy);
          m[i].syz = fmaf(wy_, ez, m[i].syz);
          m[i].szz = fmaf(wz, ez, m[i].szz);
        }
      }
    }
  }
}

// Unit smallest eigenvector of the window's covariance, flipped toward the
// camera at the origin: the trigonometric smallest eigenvalue (Smith), then
// the largest cross product of two rows of (A - lam I).
__device__ __forceinline__ float3 normal_of(const Moments& m, const float4 c) {
  const float inv_n = __frcp_rn(fmaxf(m.n, 1.f));
  const float mx = m.sx * inv_n, my = m.sy * inv_n, mz = m.sz * inv_n;
  const float a00 = m.sxx * inv_n - mx * mx;
  const float a01 = m.sxy * inv_n - mx * my;
  const float a02 = m.sxz * inv_n - mx * mz;
  const float a11 = m.syy * inv_n - my * my;
  const float a12 = m.syz * inv_n - my * mz;
  const float a22 = m.szz * inv_n - mz * mz;
  const float p1 = a01 * a01 + a02 * a02 + a12 * a12;
  const float q = (a00 + a11 + a22) * (1.f / 3.f);
  const float p2 = (a00 - q) * (a00 - q) + (a11 - q) * (a11 - q) +
                   (a22 - q) * (a22 - q) + 2.f * p1;
  const float p = sqrtf(fmaxf(p2 * (1.f / 6.f), 1e-30f));
  const float inv_p = __frcp_rn(p);
  const float b00 = (a00 - q) * inv_p, b11 = (a11 - q) * inv_p, b22 = (a22 - q) * inv_p;
  const float b01 = a01 * inv_p, b02 = a02 * inv_p, b12 = a12 * inv_p;
  const float detB = b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02) +
                     b02 * (b01 * b12 - b11 * b02);
  float r = 0.5f * detB;  // clamped as torch.clamp does: a NaN stays a NaN
  r = r < -1.f ? -1.f : (r > 1.f ? 1.f : r);
  const float phi = acosf(r) * (1.f / 3.f);
  const float lam = q + 2.f * p * __cosf(phi + 2.f * kPi / 3.f);
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
  const float flip = (vx * c.x + vy * c.y + vz * c.z) > 0.f ? -1.f : 1.f;
  const float inv = flip * rsqrtf(fmaxf(vx * vx + vy * vy + vz * vz, 1e-24f));
  return make_float3(vx * inv, vy * inv, vz * inv);
}

template <Mode MODE>
__global__ void __launch_bounds__(kThreads) stencil_kernel(const Args a) {
  constexpr int kHalo = MODE == kFrontend ? 2 * kWin : kWin;
  constexpr int kSX = kTX + 2 * kHalo;
  constexpr int kSY = kTY + 2 * kHalo;
  __shared__ float4 s[kSY * kSX];
  const int tid = threadIdx.y * kTX + threadIdx.x;
  const int x0 = blockIdx.x * kTX - kHalo;
  const int y0 = blockIdx.y * kTY - kHalo;
  const size_t plane = (size_t)a.H * a.W;

  // Stage the tile and its halo; the loads of all rounds are independent.
#pragma unroll
  for (int k = 0; k < (kSX * kSY + kThreads - 1) / kThreads; ++k) {
    const int i = tid + k * kThreads;
    if (i < kSX * kSY) {
      const int ly = i / kSX;
      const int gy = y0 + ly;
      const int gx = x0 + (i - ly * kSX);
      const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      const size_t o = in ? (size_t)gy * a.W + gx : 0;
      float4 v = make_float4(0.f, 0.f, 0.f, -1.f);
      if (MODE == kFrontend) {
        const float d = in ? __ldg(a.depth + o) : 0.f;
        if (in && isfinite(d)) {
          v.x = __fmul_rn(__fmul_rn(__fsub_rn((float)gx, a.cx), a.inv_fx), d);
          v.y = __fmul_rn(__fmul_rn(__fsub_rn((float)gy, a.cy), a.inv_fy), d);
          v.z = d;
          v.w = a.r2_outlier;
        }
      } else if (in) {
        v.x = __ldg(a.pts + o);
        v.y = __ldg(a.pts + plane + o);
        v.z = __ldg(a.pts + 2 * plane + o);
        v.w = __ldg(a.valid + o) ? a.r2 : -1.f;
      }
      s[i] = v;
    }
  }
  __syncthreads();

  if (MODE == kFrontend) {
    // Phase 1: the outlier count of every staged pixel within 3 of the tile,
    // then its gate written back as the radius of phase 2.
    constexpr int kRX = kTX + 2 * kWin;
    constexpr int kRY = (kTY + 2 * kWin) / kPPT;  // rows of kPPT pixels
    constexpr int kRounds = (kRX * kRY + kThreads - 1) / kThreads;
    bool gate[kRounds][kPPT];
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const int j = tid + k * kThreads;
      if (j < kRX * kRY) {
        const int ry = j / kRX;
        const int ly = ry * kPPT + kWin;
        const int lx = j - ry * kRX + kWin;
        float4 c[kPPT];
        Moments m[kPPT];
#pragma unroll
        for (int i = 0; i < kPPT; ++i) c[i] = s[(ly + i) * kSX + lx];
        windows<false, kSX>(s, ly, lx, c, m);
#pragma unroll
        for (int i = 0; i < kPPT; ++i)
          gate[k][i] = c[i].w >= 0.f && m[i].n - 1.f >= a.min_outlier;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const int j = tid + k * kThreads;
      if (j < kRX * kRY) {
        const int ry = j / kRX;
#pragma unroll
        for (int i = 0; i < kPPT; ++i)
          s[(ry * kPPT + kWin + i) * kSX + j - ry * kRX + kWin].w =
              gate[k][i] ? a.r2 : -1.f;
      }
    }
    __syncthreads();
  }

  const int x = blockIdx.x * kTX + threadIdx.x;
  const int y = blockIdx.y * kTY + threadIdx.y * kPPT;
  if (x >= a.W || y >= a.H) return;
  const int ly = threadIdx.y * kPPT + kHalo;
  const int lx = threadIdx.x + kHalo;
  float4 c[kPPT];
  Moments m[kPPT];
#pragma unroll
  for (int i = 0; i < kPPT; ++i) c[i] = s[(ly + i) * kSX + lx];
  windows<MODE != kCount, kSX>(s, ly, lx, c, m);
#pragma unroll
  for (int i = 0; i < kPPT; ++i) {
    if (y + i >= a.H) break;
    // an invalid centre has no neighbours: the plain version's zero sums
    if (!(c[i].w >= 0.f)) m[i] = Moments();
    const size_t o = (size_t)(y + i) * a.W + x;
    if (MODE != kFrontend) a.count[o] = m[i].n;
    if (MODE == kCount) continue;

    float3 n = normal_of(m[i], c[i]);
    if (MODE == kFrontend) {
      const bool ok =
          c[i].w >= 0.f && m[i].n >= a.min_normal && isfinite(n.x + n.y + n.z);
      if (!ok) n = make_float3(0.f, 0.f, 0.f);
      a.mask[o] = ok;
      a.pts_out[o] = c[i].x;
      a.pts_out[plane + o] = c[i].y;
      a.pts_out[2 * plane + o] = c[i].z;
    }
    a.normals[o] = n.x;
    a.normals[plane + o] = n.y;
    a.normals[2 * plane + o] = n.z;
  }
}

template <Mode MODE>
int launch(const Args& a, void* stream) {
  if (a.H <= 0 || a.W <= 0) return 0;
  const dim3 block(kTX, kTY / kPPT);
  const dim3 grid((a.W + kTX - 1) / kTX, (a.H + kTY - 1) / kTY);
  stencil_kernel<MODE><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// pts (3, h, w) f32, valid (h, w) u8, r2 = radius^2
// -> normals (3, h, w) f32, count (h, w) f32 (centre included).
int stencil_normals(const float* pts, const uint8_t* valid, int h, int w,
                    float r2, float* normals, float* count, void* stream) {
  Args a = {};
  a.pts = pts; a.valid = valid; a.H = h; a.W = w; a.r2 = r2;
  a.normals = normals; a.count = count;
  return launch<kNormals>(a, stream);
}

// pts (3, h, w) f32, valid (h, w) u8 -> count (h, w) f32 (centre included).
int stencil_count(const float* pts, const uint8_t* valid, int h, int w,
                  float r2, float* count, void* stream) {
  Args a = {};
  a.pts = pts; a.valid = valid; a.H = h; a.W = w; a.r2 = r2; a.count = count;
  return launch<kCount>(a, stream);
}

// depth (h, w) f32 (NaN invalid), the intrinsics at the depth's scale (the
// focal lengths as reciprocals), the outlier gate (radius^2, least neighbours, centre excluded) and the normal
// gate (radius^2, least count, centre included)
// -> pts0 (3, h, w) f32 (0 where depth is not finite), normals (3, h, w) f32
//    (0 off the final mask), mask (h, w) u8.
int stencil_frontend(const float* depth, int h, int w, float inv_fx, float inv_fy,
                     float cx, float cy, float r2_outlier, float min_outlier,
                     float r2_normal, float min_normal, float* pts0,
                     float* normals, uint8_t* mask, void* stream) {
  Args a = {};
  a.depth = depth; a.H = h; a.W = w;
  a.cx = cx; a.cy = cy; a.inv_fx = inv_fx; a.inv_fy = inv_fy;
  a.r2_outlier = r2_outlier; a.min_outlier = min_outlier;
  a.r2 = r2_normal; a.min_normal = min_normal;
  a.pts_out = pts0; a.normals = normals; a.mask = mask;
  return launch<kFrontend>(a, stream);
}

}  // extern "C"
