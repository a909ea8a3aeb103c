// Hand-written CUDA (sm_90a): one Gauss-Newton step of the tracker, with the
// group's state on the device.
//
// No Pallas source: this is the body of the JAX tracker's per-group
// while_loop (nerf_fusion_tpu/system/tracker.py:288-310), which XLA keeps on
// the device.  In the port it replaces the host's energy read per iteration
// and about 45 PyTorch kernels per step (torch.linalg.solve_ex, the
// non-finite guard, se3_exp with its left Jacobian, compose), so that a GN
// evaluation and its step can be captured in one CUDA graph.
//
// The step reads the normal equations of the group's terms as they are,
// one (H, g, energy) a term by pointer (at most kMaxTerms), and sums them in
// the tracker's order (build_Hg: zeros, then each term added), so that no
// PyTorch kernel runs between a term's kernel and the step; it writes the
// sums out (the evaluation's H, g, energy).
//
// One step, in the order of the JAX body:
//   worse = energy > best | !isfinite(energy)
//   (bR, bt, best) := worse ? (bR, bt, best) : (dR, dt, energy)
//   xi = solve(H + 1e-9 I, -g)       LU with partial pivoting, as LAPACK's
//                                    getrf / getrs behind jnp.linalg.solve
//   xi := 0 if any entry is not finite
//   (nR, nt) = exp(xi) o (dR, dt)    the Taylor branches of utils/se3_torch.py
//   (dR, dt) := (!worse & i < n_iters) ? (nR, nt) : (bR, bt)
//   used := worse ? used : i;  done := worse;  iters[group] := used
// The host keeps the loop's condition (!done & i <= n_iters): it reads the
// one-byte done flag after each step.  When the step ends the group (worse,
// or i + 1 > n_iters) the kernel also resets i, used and best for the next
// group, whose start pose is then the best pose (dR = bR).
//
// What bounds it: nothing on the card.  It moves 393 bytes with one term
// (280 in: H, g, energy, pose, the two counters; 113 out: pose, counters,
// done, one iters entry), 172 more a term (H, g, energy in; their sums out
// once), and does a few hundred flops; its time is the launch.  So it is one
// thread of one block, written for clarity, with IEEE sinf / cosf / divisions
// (no fast math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// state (25,) f32: dR (3, 3), dt (3,), bR (3, 3), bt (3,), best energy
constexpr int kDR = 0;
constexpr int kDT = 9;
constexpr int kBR = 12;
constexpr int kBT = 21;
constexpr int kBest = 24;
constexpr int kMaxTerms = 8;

// the group's terms: (H (6, 6), g (6,), energy ()) of each, in order
struct Terms {
  const float* H[kMaxTerms];
  const float* g[kMaxTerms];
  const float* e[kMaxTerms];
  int n;
};

// xi = (H + 1e-9 I)^-1 (-g): LU with partial pivoting on the augmented
// matrix, the first row of largest |pivot| taken, then back substitution.
__device__ void solve6(const float* __restrict__ H, const float* __restrict__ g,
                       float* xi) {
  float a[6][7];
  for (int r = 0; r < 6; ++r) {
    for (int c = 0; c < 6; ++c) a[r][c] = H[r * 6 + c] + (r == c ? 1e-9f : 0.f);
    a[r][6] = -g[r];
  }
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(a[k][k]);
    for (int r = k + 1; r < 6; ++r) {
      const float v = fabsf(a[r][k]);
      if (v > best) {
        best = v;
        p = r;
      }
    }
    if (p != k) {
      for (int c = 0; c < 7; ++c) {
        const float t = a[k][c];
        a[k][c] = a[p][c];
        a[p][c] = t;
      }
    }
    for (int r = k + 1; r < 6; ++r) {
      const float l = a[r][k] / a[k][k];
      for (int c = k + 1; c < 7; ++c) a[r][c] -= l * a[k][c];
    }
  }
  for (int r = 5; r >= 0; --r) {
    float s = a[r][6];
    for (int c = r + 1; c < 6; ++c) s -= a[r][c] * xi[c];
    xi[r] = s / a[r][r];
  }
}

// (R (3, 3), t) = exp(xi), xi = [rho, phi]: Rodrigues' rotation and the left
// Jacobian, Taylor forms below angle^2 = 1e-8 (utils/se3_torch.py).
__device__ void se3_exp(const float* xi, float* R, float* t) {
  const float x = xi[3], y = xi[4], z = xi[5];
  const float angle2 = x * x + y * y + z * z;
  const float angle = sqrtf(fmaxf(angle2, 1e-16f));
  const bool small = angle2 < 1e-8f;
  const float s = sinf(angle), c = cosf(angle);
  const float sin_by_a = small ? 1.f - angle2 / 6.f : s / angle;
  const float omc_by_a2 = small ? 0.5f - angle2 / 24.f : (1.f - c) / angle2;
  const float c2 = small ? 1.f / 6.f - angle2 / 120.f : (angle - s) / (angle2 * angle);
  const float K[9] = {0.f, -z, y, z, 0.f, -x, -y, x, 0.f};
  float K2[9];
  for (int r = 0; r < 3; ++r)
    for (int q = 0; q < 3; ++q)
      K2[r * 3 + q] = K[r * 3] * K[q] + K[r * 3 + 1] * K[3 + q] + K[r * 3 + 2] * K[6 + q];
  float J[9];
  for (int e = 0; e < 9; ++e) {
    const float eye = (e % 4 == 0) ? 1.f : 0.f;
    R[e] = eye + sin_by_a * K[e] + omc_by_a2 * K2[e];
    J[e] = eye + omc_by_a2 * K[e] + c2 * K2[e];
  }
  for (int r = 0; r < 3; ++r)
    t[r] = J[r * 3] * xi[0] + J[r * 3 + 1] * xi[1] + J[r * 3 + 2] * xi[2];
}

__global__ void gn_step_kernel(const Terms terms, float* sum, float* st, int* ist,
                               uint8_t* done, int* iters, int group, int n_iters) {
  float H[36], g[6], e = 0.f;
  for (int k = 0; k < 36; ++k) H[k] = 0.f;
  for (int k = 0; k < 6; ++k) g[k] = 0.f;
  for (int t = 0; t < terms.n; ++t) {  // a term's 43 loads issued together
#pragma unroll
    for (int k = 0; k < 36; ++k) H[k] = __fadd_rn(H[k], __ldcg(terms.H[t] + k));
#pragma unroll
    for (int k = 0; k < 6; ++k) g[k] = __fadd_rn(g[k], __ldcg(terms.g[t] + k));
    e = __fadd_rn(e, __ldcg(terms.e[t]));
  }
  for (int k = 0; k < 36; ++k) sum[k] = H[k];
  for (int k = 0; k < 6; ++k) sum[36 + k] = g[k];
  sum[42] = e;
  const float best = st[kBest];
  const int i = ist[0], used = ist[1];
  const bool worse = e > best || !isfinite(e);

  float xi[6];
  solve6(H, g, xi);
  bool finite = true;
  for (int k = 0; k < 6; ++k) finite = finite && isfinite(xi[k]);
  if (!finite)
    for (int k = 0; k < 6; ++k) xi[k] = 0.f;
  float eR[9], et[3];
  se3_exp(xi, eR, et);

  float dR[9], dt[3], bR[9], bt[3], nR[9], nt[3];
  for (int k = 0; k < 9; ++k) {
    dR[k] = st[kDR + k];
    bR[k] = worse ? st[kBR + k] : dR[k];
  }
  for (int k = 0; k < 3; ++k) {
    dt[k] = st[kDT + k];
    bt[k] = worse ? st[kBT + k] : dt[k];
  }
  for (int r = 0; r < 3; ++r) {
    for (int q = 0; q < 3; ++q)
      nR[r * 3 + q] = eR[r * 3] * dR[q] + eR[r * 3 + 1] * dR[3 + q] + eR[r * 3 + 2] * dR[6 + q];
    nt[r] = eR[r * 3] * dt[0] + eR[r * 3 + 1] * dt[1] + eR[r * 3 + 2] * dt[2] + et[r];
  }
  const bool update = !worse && i < n_iters;
  const int used2 = worse ? used : i;
  const bool finished = worse || i + 1 > n_iters;
  for (int k = 0; k < 9; ++k) {
    st[kDR + k] = update ? nR[k] : bR[k];
    st[kBR + k] = bR[k];
  }
  for (int k = 0; k < 3; ++k) {
    st[kDT + k] = update ? nt[k] : bt[k];
    st[kBT + k] = bt[k];
  }
  st[kBest] = finished ? INFINITY : (worse ? best : e);
  ist[0] = finished ? 0 : i + 1;
  ist[1] = finished ? 0 : used2;
  iters[group] = used2;
  *done = worse ? 1 : 0;
}

}  // namespace

extern "C" {

// parts: 3 n_parts device pointers (a host array), [H (6, 6), g (6,),
// energy ()] f32 of each term of this evaluation in order, 1 <= n_parts <=
// kMaxTerms -> sum (43,) f32 = [H, g, energy], their sums; state (25,) f32,
// istate (2,) i32 = [i, used], done (1,) u8 and iters (G,) i32 are updated
// in place; group indexes iters, n_iters is the group's step count.
int gn_step(const float* const* parts, int n_parts, float* sum, float* state, int* istate,
            uint8_t* done, int* iters, int group, int n_iters, void* stream) {
  if (group < 0 || n_iters < 0 || n_parts < 1 || n_parts > kMaxTerms)
    return static_cast<int>(cudaErrorInvalidValue);
  Terms terms = {};
  for (int t = 0; t < n_parts; ++t) {
    terms.H[t] = parts[3 * t];
    terms.g[t] = parts[3 * t + 1];
    terms.e[t] = parts[3 * t + 2];
  }
  terms.n = n_parts;
  gn_step_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      terms, sum, state, istate, done, iters, group, n_iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
