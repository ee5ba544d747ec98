// The contact group's epilogue on the grid path, in one pass: scatter the
// contacts kernel's output back through the sort permutation, the ground
// plane, the velocity add under the speed-up-only clamp and the two picker
// spheres.
//
// Replaces: no TPU kernel.  The JAX package leaves this epilogue to XLA
// (flingbot_tpu/engine/solver.py `_step_grid_pallas`, :600-615: the
// inverse sort of contact_group, solve_plane, _add_delta_clamped,
// solve_picker_spheres).  Its plain version is
// engine/kernels.py `contact_apply_plain`, which calls those functions of
// the port; on a card it is ~90 elementwise launches a contact group.
//
// Thread (b, i) owns sorted slot i of env b.  It reads, in sorted order,
// the contacts kernel's output, the pre-contact and the substep's
// previous positions (gathered by sort_particles, bit-equal to P and prev
// at the slot), the packed id (moving = neither the immobile nor the
// inactive bit, i.e. valid & (w > 0)) and s = order[b, i]; it gathers
// V[b, :, s], applies plane -> clamped velocity add -> picker spheres and
// writes P[b, :, s] and V[b, :, s].  order is a permutation of each env's
// slots, so every output slot is written exactly once.
//
// What bounds it on this card: HBM bytes, ~84 a slot (reads: 3 contact
// outputs, 6 sorted positions, the packed id, the int64 order, 3 of V;
// writes: 3 of P, 3 of V), against ~100 f32 operations.  Reads in sorted
// order are coalesced; the V gather and the P and V stores go through
// order, and the Morton order keeps neighbouring threads in few sectors.
//
// Bit-identity with contact_apply_plain: built with -fmad=false, every
// expression in the plain chain's order; dv_max / |dv| as PyTorch's
// Tensor.__rdiv__ computes a host float over a tensor (reciprocal, then
// the product); true divisions and the correctly rounded sqrtf; clamps
// that pass NaN through as torch.clamp does; slots that do not move go
// through the same expressions (x - dx * 0, y + 0), not an early return.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-9f;
constexpr int kParamLen = 21;  // engine/kernels.py SUB_PARAM_LEN
constexpr int kImmobileBit = 20;
constexpr int kInactiveBit = 21;

// torch.clamp(v, min=lo) and torch.clamp(v, max=hi): NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

__global__ void __launch_bounds__(kThreads) contact_apply_kernel(
    const float* __restrict__ params, const long long* __restrict__ order,
    const float* __restrict__ xs, const float* __restrict__ ys,
    const float* __restrict__ zs, const float* __restrict__ pxs,
    const float* __restrict__ pys, const float* __restrict__ pzs,
    const int* __restrict__ packed, const float* __restrict__ ox,
    const float* __restrict__ oy, const float* __restrict__ oz,
    const float* __restrict__ V, float* __restrict__ P_out,
    float* __restrict__ V_out, int B, int N) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)B * N) return;
  const int b = (int)(t / N);
  const float* p = params + (long long)b * kParamLen;
  const float dt = p[0], mu = p[3], coldist = p[4], R = p[12];
  const float dv_max = p[20] * dt;
  const int pk = packed[t];
  const bool moving = ((pk >> kImmobileBit) & 1) == 0
                      && ((pk >> kInactiveBit) & 1) == 0;
  const long long base = (long long)b * 3 * N + order[t];

  // solve_plane(P2, prev): the ground plane with Coulomb friction
  float x = ox[t], y = oy[t], z = oz[t];
  const float pen = coldist - y;
  const bool contact = pen > 0.f && moving;
  const float dy = contact ? pen : 0.f;
  const float dx_ = x - pxs[t], dz_ = z - pzs[t];
  const float t_norm = sqrtf(dx_ * dx_ + dz_ * dz_ + kEps);
  const float f = contact
      ? clamp_max(mu * clamp_min(pen, 0.f) / t_norm, 1.f) : 0.f;
  x = x - dx_ * f;
  y = y + dy;
  z = z - dz_ * f;

  // add_delta_clamped(P, P2, V): the velocity of the projection under the
  // speed-up-only clamp
  const float vx = V[base], vy = V[base + N], vz = V[base + 2 * N];
  const float dvx = (x - xs[t]) / dt, dvy = (y - ys[t]) / dt,
              dvz = (z - zs[t]) / dt;
  const float nx = vx + dvx, ny = vy + dvy, nz = vz + dvz;
  const float dv_norm = sqrtf(dvx * dvx + dvy * dvy + dvz * dvz + kEps);
  const bool speeding = nx * nx + ny * ny + nz * nz
                        > vx * vx + vy * vy + vz * vz;
  const float scale = speeding ? clamp_max((1.f / dv_norm) * dv_max, 1.f)
                               : 1.f;
  V_out[base] = moving ? vx + dvx * scale : vx;
  V_out[base + N] = moving ? vy + dvy * scale : vy;
  V_out[base + 2 * N] = moving ? vz + dvz * scale : vz;

  // solve_picker_spheres(P): both spheres push from the same P, their
  // pushes summed from zero
  float ax = 0.f, ay = 0.f, az = 0.f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float ex = x - p[14 + 3 * k], ey = y - p[15 + 3 * k],
                ez = z - p[16 + 3 * k];
    const float dist = sqrtf(ex * ex + ey * ey + ez * ez + kEps);
    const float pen_k = R - dist;
    const float push = pen_k > 0.f && moving ? pen_k / dist : 0.f;
    ax = ax + ex * push;
    ay = ay + ey * push;
    az = az + ez * push;
  }
  P_out[base] = x + ax;
  P_out[base + N] = y + ay;
  P_out[base + 2 * N] = z + az;
}

}  // namespace

extern "C" int flingbot_contact_apply(
    const void* params, const void* order, const void* xs, const void* ys,
    const void* zs, const void* pxs, const void* pys, const void* pzs,
    const void* packed, const void* ox, const void* oy, const void* oz,
    const void* V, void* P_out, void* V_out, int B, int N, void* stream) {
  const long long n = (long long)B * N;
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  contact_apply_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)params, (const long long*)order, (const float*)xs,
      (const float*)ys, (const float*)zs, (const float*)pxs,
      (const float*)pys, (const float*)pzs, (const int*)packed,
      (const float*)ox, (const float*)oy, (const float*)oz,
      (const float*)V, (float*)P_out, (float*)V_out, B, N);
  return (int)cudaGetLastError();
}

extern "C" const char* flingbot_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
