// Fused XPBD substeps for grid cloths, one thread block per env.
//
// Replaces: flingbot_tpu/engine/pallas_kernels.py `_substeps_kernel`
// (launched by `pallas_substeps`, pl.pallas_call at :314).  Per env,
// n_sub substeps of: integrate gravity + damping -> `iterations` x
// (6-class Jacobi springs with local-relaxation count normalization,
// Chebyshev-accelerated after 2 plain iterations, then the ground plane
// with Coulomb friction) -> velocity finalize under the speed-up-only
// maxAcceleration clamp -> picker-sphere push, position only (the last
// one skipped when picker_last == 0).  Returns P, V and the positions at
// the start of the last substep.
//
// What bounds it on this card: f32 issue and shared-memory bandwidth,
// not HBM.  The env's lattice positions (3 x H x W f32, 130 KB at 104^2),
// its inverse masses and per-particle relaxation factors stay resident in
// shared memory (216 KB at 104^2) for the whole launch; every Jacobi
// iteration reads 12 neighbours per particle from shared memory and does
// ~250 flops per particle.
//
// Design: one block of 1024 threads per env (an env's iterations are
// serial and need block-wide barriers); thread t owns particles
// t, t + 1024, ...  Each particle gathers both of its roles in every
// constraint (start and neighbour), so no atomics are needed and the sum
// order is fixed.  An iteration computes new positions into registers,
// barriers, then writes them, as Jacobi requires.  Neighbour reads are
// bounds-checked against the env's own dims (the TPU kernel's masked
// wraparound rolls).  The Chebyshev previous iterate, the substep-start
// positions and the velocities live in global memory (L2-resident per
// block); this first version does not keep them in registers.  Built with
// -fmad=false (engine/build.py) and summing in the plain version's order,
// it matches engine/kernels.py substeps_plain bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kPerThread = 11;  // 1024 * 11 >= 104 * 104
constexpr float kEps = 1e-9f;
constexpr int kChebDelay = 2;
constexpr int kParamLen = 21;

// GRID_STENCIL_CLASSES: (dy, dx, rest in spacings, stiffness class)
__device__ __forceinline__ void stencil(int k, int& dy, int& dx, float& rest,
                                        int& cls) {
  switch (k) {
    case 0: dy = 0; dx = 1; rest = 1.0f; cls = 0; break;
    case 1: dy = 1; dx = 0; rest = 1.0f; cls = 0; break;
    case 2: dy = 0; dx = 2; rest = 2.0f; cls = 1; break;
    case 3: dy = 2; dx = 0; rest = 2.0f; cls = 1; break;
    case 4: dy = 1; dx = 1; rest = 1.41421356237309515f; cls = 2; break;
    default: dy = 1; dx = -1; rest = 1.41421356237309515f; cls = 2; break;
  }
}

__device__ __forceinline__ bool inside(int y, int x, int dimy, int dimx) {
  return y >= 0 && y < dimy && x >= 0 && x < dimx;
}

struct Params {
  float dt, gravity_y, damping, mu, coldist, relax, spacing;
  float stiff[3];
  int dimx, dimy;
  float picker_R, rho2;
  float picker[6];
  float a_max;
};

__device__ __forceinline__ Params load_params(const float* p) {
  Params q;
  q.dt = p[0]; q.gravity_y = p[1]; q.damping = p[2]; q.mu = p[3];
  q.coldist = p[4]; q.relax = p[5]; q.spacing = p[6];
  q.stiff[0] = p[7]; q.stiff[1] = p[8]; q.stiff[2] = p[9];
  q.dimx = (int)p[10]; q.dimy = (int)p[11];
  q.picker_R = p[12]; q.rho2 = p[13];
  for (int k = 0; k < 6; ++k) q.picker[k] = p[14 + k];
  q.a_max = p[20];
  return q;
}

// One Jacobi spring pass for slot i = (y, x): the displaced position
// P_i + invc_i * sum of its corrections, summed per class as the TPU
// kernel does (start-role term, then neighbour-role term).
__device__ __forceinline__ void jacobi(const float* sx, const float* sy,
                                       const float* sz, const float* sw,
                                       float invc, const Params& q, int W,
                                       int i, int y, int x, bool valid,
                                       float& ox, float& oy, float& oz) {
  const float px = sx[i], py = sy[i], pz = sz[i], wi = sw[i];
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int dy, dx, cls;
    float rest_k;
    stencil(k, dy, dx, rest_k, cls);
    const float rest = rest_k * q.spacing;
    const float stiff = q.stiff[cls];
    // start role: constraint (i, i + off)
    if (valid && inside(y + dy, x + dx, q.dimy, q.dimx)) {
      const int j = (y + dy) * W + (x + dx);
      const float wn = sw[j];
      const float denom = wi + wn;
      if (denom > 0.f) {
        const float gA = wi * (stiff / (denom + kEps));
        const float d0 = sx[j] - px, d1 = sy[j] - py, d2 = sz[j] - pz;
        const float r = rsqrtf(d0 * d0 + d1 * d1 + d2 * d2 + kEps);
        const float a = gA * (1.f - rest * r);
        a0 += a * d0; a1 += a * d1; a2 += a * d2;
      }
    }
    // neighbour role: constraint (i - off, i)
    if (valid && inside(y - dy, x - dx, q.dimy, q.dimx)) {
      const int j = (y - dy) * W + (x - dx);
      const float wj = sw[j];
      const float denom = wj + wi;
      if (denom > 0.f) {
        const float gB = wi * (stiff / (denom + kEps));
        const float d0 = px - sx[j], d1 = py - sy[j], d2 = pz - sz[j];
        const float r = rsqrtf(d0 * d0 + d1 * d1 + d2 * d2 + kEps);
        const float b = gB * (1.f - rest * r);
        a0 -= b * d0; a1 -= b * d1; a2 -= b * d2;
      }
    }
  }
  ox = px + invc * a0;
  oy = py + invc * a1;
  oz = pz + invc * a2;
}

// ground plane y >= collision_distance with PBD Coulomb friction
__device__ __forceinline__ void plane(float& x, float& y, float& z, float prx,
                                      float prz, bool moving, const Params& q) {
  const float pen = q.coldist - y;
  const bool contact = pen > 0.f && moving;
  const float dx = x - prx, dz = z - prz;
  const float tn = sqrtf(dx * dx + dz * dz + kEps);
  const float f = contact ? fminf(1.f, q.mu * fmaxf(pen, 0.f) / tn) : 0.f;
  x -= dx * f;
  y += contact ? pen : 0.f;
  z -= dz * f;
}

__global__ void __launch_bounds__(kThreads, 1)
substeps_kernel(const float* __restrict__ params, const float* __restrict__ P,
                const float* __restrict__ V, const float* __restrict__ w,
                float* __restrict__ P_out, float* __restrict__ V_out,
                float* __restrict__ prev_out, float* __restrict__ cheb, int H,
                int W, int n_sub, int iterations, int picker_last) {
  extern __shared__ float smem[];
  const int HW = H * W;
  float* sx = smem;
  float* sy = sx + HW;
  float* sz = sy + HW;
  float* sw = sz + HW;
  float* sinvc = sw + HW;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const Params q = load_params(params + (size_t)b * kParamLen);
  const size_t o3 = (size_t)b * 3 * HW;
  const float* Pb = P + o3;
  const float* Vb = V + o3;
  float* Po = P_out + o3;
  float* Vo = V_out + o3;
  float* Pr = prev_out + o3;
  float* Cb = cheb + o3;

  for (int i = t; i < HW; i += kThreads) {
    const int y = i / W, x = i - (i / W) * W;
    sx[i] = Pb[i];
    sy[i] = Pb[HW + i];
    sz[i] = Pb[2 * HW + i];
    sw[i] = inside(y, x, q.dimy, q.dimx) ? w[(size_t)b * HW + i] : 0.f;
  }
  __syncthreads();

  // constraint counts (w is constant over the launch)
  for (int i = t; i < HW; i += kThreads) {
    const int y = i / W, x = i - (i / W) * W;
    const bool valid = inside(y, x, q.dimy, q.dimx);
    float count = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      int dy, dx, cls;
      float rest_k;
      stencil(k, dy, dx, rest_k, cls);
      if (valid && inside(y + dy, x + dx, q.dimy, q.dimx) &&
          sw[i] + sw[(y + dy) * W + x + dx] > 0.f)
        count += 1.f;
      if (valid && inside(y - dy, x - dx, q.dimy, q.dimx) &&
          sw[(y - dy) * W + x - dx] + sw[i] > 0.f)
        count += 1.f;
    }
    sinvc[i] = q.relax / fmaxf(count, 1.f);
  }

  const float dt = q.dt;
  for (int s = 0; s < n_sub; ++s) {
    // integrate: gravity, damping, predict
    for (int i = t; i < HW; i += kThreads) {
      const int y = i / W, x = i - (i / W) * W;
      const bool moving = inside(y, x, q.dimy, q.dimx) && sw[i] > 0.f;
      const float* Vs = s == 0 ? Vb : Vo;
      float vx = Vs[i], vy = Vs[HW + i] + dt * q.gravity_y, vz = Vs[2 * HW + i];
      const float damp = fmaxf(0.f, 1.f - q.damping * dt);
      vx *= damp; vy *= damp; vz *= damp;
      if (!moving) { vx = 0.f; vy = 0.f; vz = 0.f; }
      const float px = sx[i], py = sy[i], pz = sz[i];
      Vo[i] = vx; Vo[HW + i] = vy; Vo[2 * HW + i] = vz;
      Pr[i] = px; Pr[HW + i] = py; Pr[2 * HW + i] = pz;
      const float nx = moving ? px + dt * vx : px;
      const float ny = moving ? py + dt * vy : py;
      const float nz = moving ? pz + dt * vz : pz;
      sx[i] = nx; sy[i] = ny; sz[i] = nz;
      Cb[i] = nx; Cb[HW + i] = ny; Cb[2 * HW + i] = nz;
    }
    __syncthreads();

    // springs + plane, Chebyshev-accelerated
    float omega = 1.f;
    for (int it = 0; it < iterations; ++it) {
      const bool accel = it >= kChebDelay;
      if (it == kChebDelay) omega = 2.f / (2.f - q.rho2);
      else if (it > kChebDelay) omega = 4.f / (4.f - q.rho2 * omega);
      float nx[kPerThread], ny[kPerThread], nz[kPerThread];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int i = t + k * kThreads;
        if (i < HW) {
          const int y = i / W, x = i - (i / W) * W;
          const bool valid = inside(y, x, q.dimy, q.dimx);
          const bool moving = valid && sw[i] > 0.f;
          float jx, jy, jz;
          jacobi(sx, sy, sz, sw, sinvc[i], q, W, i, y, x, valid, jx, jy, jz);
          if (accel) {
            const float cx = Cb[i], cy = Cb[HW + i], cz = Cb[2 * HW + i];
            jx = omega * (jx - cx) + cx;
            jy = omega * (jy - cy) + cy;
            jz = omega * (jz - cz) + cz;
          }
          plane(jx, jy, jz, Pr[i], Pr[2 * HW + i], moving, q);
          nx[k] = jx; ny[k] = jy; nz[k] = jz;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int i = t + k * kThreads;
        if (i < HW) {
          Cb[i] = sx[i]; Cb[HW + i] = sy[i]; Cb[2 * HW + i] = sz[i];
          sx[i] = nx[k]; sy[i] = ny[k]; sz[i] = nz[k];
        }
      }
      __syncthreads();
    }

    // velocity finalize (speed-up-only clamp), then the picker push
    const bool push = s < n_sub - 1 || picker_last;
    for (int i = t; i < HW; i += kThreads) {
      const int y = i / W, x = i - (i / W) * W;
      const bool moving = inside(y, x, q.dimy, q.dimx) && sw[i] > 0.f;
      float px = sx[i], py = sy[i], pz = sz[i];
      if (moving) {
        const float vx = Vo[i], vy = Vo[HW + i], vz = Vo[2 * HW + i];
        const float nvx = (px - Pr[i]) / dt;
        const float nvy = (py - Pr[HW + i]) / dt;
        const float nvz = (pz - Pr[2 * HW + i]) / dt;
        const float d0 = nvx - vx, d1 = nvy - vy, d2 = nvz - vz;
        const float r = rsqrtf(d0 * d0 + d1 * d1 + d2 * d2 + kEps);
        const bool speeding =
            nvx * nvx + nvy * nvy + nvz * nvz > vx * vx + vy * vy + vz * vz;
        const float sc = speeding ? fminf(1.f, q.a_max * dt * r) : 1.f;
        Vo[i] = vx + d0 * sc;
        Vo[HW + i] = vy + d1 * sc;
        Vo[2 * HW + i] = vz + d2 * sc;
      }
      if (push) {
        for (int k = 0; k < 2; ++k) {
          const float d0 = px - q.picker[3 * k];
          const float d1 = py - q.picker[3 * k + 1];
          const float d2 = pz - q.picker[3 * k + 2];
          const float sq = d0 * d0 + d1 * d1 + d2 * d2 + kEps;
          const float r = rsqrtf(sq);
          const float pen = q.picker_R - sq * r;
          const float pu = (pen > 0.f && moving) ? pen * r : 0.f;
          px += d0 * pu; py += d1 * pu; pz += d2 * pu;
        }
        sx[i] = px; sy[i] = py; sz[i] = pz;
      }
    }
    // the next substep's integrate touches only this thread's slots; its
    // barrier orders them before any neighbour read
  }

  for (int i = t; i < HW; i += kThreads) {
    Po[i] = sx[i];
    Po[HW + i] = sy[i];
    Po[2 * HW + i] = sz[i];
  }
}

}  // namespace

extern "C" int flingbot_substeps(const void* params, const void* P,
                                 const void* V, const void* w, void* P_out,
                                 void* V_out, void* prev_out, void* cheb,
                                 int B, int H, int W, int n_sub,
                                 int iterations, int picker_last,
                                 void* stream) {
  const int smem = 5 * H * W * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      substeps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (B == 0) return 0;
  substeps_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)params, (const float*)P, (const float*)V,
      (const float*)w, (float*)P_out, (float*)V_out, (float*)prev_out,
      (float*)cheb, H, W, n_sub, iterations, picker_last);
  return (int)cudaGetLastError();
}

extern "C" const char* flingbot_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
