// Self-collision projection on Morton-sorted particles, one thread block
// per env (grid mode).
//
// Replaces: flingbot_tpu/engine/pallas_kernels.py `_contacts_kernel`
// (launched by `pallas_contacts`, pl.pallas_call at :563).  Per env, on
// arrays already in Morton order, `iterations` x: test pairs (i, i + k)
// for k = 1..window for penetration below rest_dist; drop lattice
// neighbours by their packed ids (SelfCollideFilter); project with PBD
// Coulomb particle friction against the substep's relative motion; split
// by mass share; average per particle by its contact count (Jacobi); then
// the ground plane with friction as the iteration's epilogue.
//
// What bounds it on this card: f32 issue (about 70 flops per pair side,
// 2 x window pair sides per particle per iteration) and shared-memory
// bandwidth, not HBM: sorted positions and packed ids stay resident in
// shared memory (173 KB at 104^2 particles) for the whole launch.
//
// Design: one block of 1024 threads per env, thread t owns sorted slots
// t, t + 1024, ...  Each particle evaluates both of its roles, (i, i + k)
// and (i - k, i), for every k and sums its own correction and count, so
// no atomics are needed and the result is deterministic.  New positions
// go to registers, a barrier separates the reads of an iteration from its
// writes.  The previous positions are constant over the launch and are
// read through the read-only cache from global memory.  The TPU kernel's
// folded (R, C) layout and row-seam shifts are gone: arrays are flat.
// Built with -fmad=false, it matches contacts_plain bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kPerThread = 11;  // 1024 * 11 >= 104 * 104
constexpr float kEps = 1e-9f;
constexpr int kParamLen = 8;
constexpr int kImmobileBit = 20;
constexpr int kInactiveBit = 21;

struct Slot {
  float w;
  bool active;
  int lx, ly;
};

__device__ __forceinline__ Slot decode(int pk, float w_uni) {
  Slot s;
  const bool immobile = ((pk >> kImmobileBit) & 1) != 0;
  const bool inactive = ((pk >> kInactiveBit) & 1) != 0;
  s.active = !inactive;
  s.w = (immobile || inactive) ? 0.f : w_uni;
  s.lx = pk & 0xFF;
  s.ly = (pk >> 8) & 0xFFF;
  return s;
}

// Correction g of the pair (a, c) as seen from its start a, and whether
// the pair is a live contact.  The start a takes +w_a * g, the
// neighbour c takes -w_c * g.
__device__ __forceinline__ bool pair(float ax, float ay, float az, float cx,
                                     float cy, float cz, float pax, float pay,
                                     float paz, float pcx, float pcy,
                                     float pcz, const Slot& A, const Slot& C,
                                     float rest_d, float mu_p, float& gx,
                                     float& gy, float& gz) {
  const bool nbr = abs(C.lx - A.lx) <= 1 && abs(C.ly - A.ly) <= 1;
  const float wsum = A.w + C.w;
  const bool ok = A.active && C.active && !nbr && wsum > 0.f;
  const float coef = ok ? 1.f / (wsum + kEps) : 0.f;
  const float d0 = ax - cx, d1 = ay - cy, d2 = az - cz;
  const float sq = d0 * d0 + d1 * d1 + d2 * d2 + kEps;
  const float r = rsqrtf(sq);
  const float pen = rest_d - sq * r;
  const bool live = pen > 0.f;
  const float s = live ? coef * pen * r : 0.f;
  // friction: tangential part of this substep's relative motion
  const float r0 = d0 - (pax - pcx);
  const float r1 = d1 - (pay - pcy);
  const float r2 = d2 - (paz - pcz);
  const float rel_n = (r0 * d0 + r1 * d1 + r2 * d2) * (r * r);
  const float t0 = r0 - rel_n * d0;
  const float t1 = r1 - rel_n * d1;
  const float t2 = r2 - rel_n * d2;
  const float tn_r = rsqrtf(t0 * t0 + t1 * t1 + t2 * t2 + kEps);
  const float fr = fminf(1.f, mu_p * fmaxf(pen, 0.f) * tn_r);
  const float fsc = live ? coef * fr : 0.f;
  gx = s * d0 - fsc * t0;
  gy = s * d1 - fsc * t1;
  gz = s * d2 - fsc * t2;
  return live && ok;
}

__global__ void __launch_bounds__(kThreads, 1)
contacts_kernel(const float* __restrict__ params, const float* __restrict__ xs,
                const float* __restrict__ ys, const float* __restrict__ zs,
                const float* __restrict__ pxs, const float* __restrict__ pys,
                const float* __restrict__ pzs, const int* __restrict__ packed,
                float* __restrict__ ox, float* __restrict__ oy,
                float* __restrict__ oz, int N, int window, int iterations) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + N;
  float* sz = sy + N;
  int* spk = reinterpret_cast<int*>(sz + N);

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const float* prm = params + (size_t)b * kParamLen;
  const float rest_d = prm[0], w_uni = prm[1], mu_p = prm[2];
  const float mu_plane = prm[3], coldist = prm[4];
  const size_t o = (size_t)b * N;
  const float* PX = pxs + o;
  const float* PY = pys + o;
  const float* PZ = pzs + o;

  for (int i = t; i < N; i += kThreads) {
    sx[i] = xs[o + i];
    sy[i] = ys[o + i];
    sz[i] = zs[o + i];
    spk[i] = packed[o + i];
  }
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    float nx[kPerThread], ny[kPerThread], nz[kPerThread];
#pragma unroll
    for (int kk = 0; kk < kPerThread; ++kk) {
      const int i = t + kk * kThreads;
      if (i < N) {
        const Slot A = decode(spk[i], w_uni);
        const bool immobile = ((spk[i] >> kImmobileBit) & 1) != 0;
        const float ms = (A.active && !immobile) ? 1.f : 0.f;
        const float X = sx[i], Y = sy[i], Z = sz[i];
        const float pX = __ldg(PX + i), pY = __ldg(PY + i), pZ = __ldg(PZ + i);
        float ax = 0.f, ay = 0.f, az = 0.f, cnt = 0.f;
        for (int k = 1; k <= window; ++k) {
          float gx, gy, gz;
          const int j = i + k;  // start role: pair (i, i + k)
          if (j < N) {
            const Slot C = decode(spk[j], w_uni);
            const bool lv = pair(X, Y, Z, sx[j], sy[j], sz[j], pX, pY, pZ,
                                 __ldg(PX + j), __ldg(PY + j), __ldg(PZ + j),
                                 A, C, rest_d, mu_p, gx, gy, gz);
            ax += A.w * gx; ay += A.w * gy; az += A.w * gz;
            cnt += lv ? 1.f : 0.f;
          }
          const int h = i - k;  // neighbour role: pair (i - k, i)
          if (h >= 0) {
            const Slot C = decode(spk[h], w_uni);
            const bool lv = pair(sx[h], sy[h], sz[h], X, Y, Z, __ldg(PX + h),
                                 __ldg(PY + h), __ldg(PZ + h), pX, pY, pZ, C,
                                 A, rest_d, mu_p, gx, gy, gz);
            ax -= A.w * gx; ay -= A.w * gy; az -= A.w * gz;
            cnt += lv ? 1.f : 0.f;
          }
        }
        const float inv_cnt = ms / fmaxf(cnt, 1.f);
        float x = X + ax * inv_cnt, y = Y + ay * inv_cnt, z = Z + az * inv_cnt;
        // ground plane with Coulomb friction
        const float pen = coldist - y;
        const float cf = pen > 0.f ? ms : 0.f;
        const float dx = x - pX, dz = z - pZ;
        const float tn = sqrtf(dx * dx + dz * dz + kEps);
        const float f = cf * fminf(1.f, mu_plane * fmaxf(pen, 0.f) / tn);
        nx[kk] = x - dx * f;
        ny[kk] = y + cf * pen;
        nz[kk] = z - dz * f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kPerThread; ++kk) {
      const int i = t + kk * kThreads;
      if (i < N) {
        sx[i] = nx[kk];
        sy[i] = ny[kk];
        sz[i] = nz[kk];
      }
    }
    __syncthreads();
  }

  for (int i = t; i < N; i += kThreads) {
    ox[o + i] = sx[i];
    oy[o + i] = sy[i];
    oz[o + i] = sz[i];
  }
}

}  // namespace

extern "C" int flingbot_contacts(const void* params, const void* xs,
                                 const void* ys, const void* zs,
                                 const void* pxs, const void* pys,
                                 const void* pzs, const void* packed,
                                 void* ox, void* oy, void* oz, int B, int N,
                                 int window, int iterations, void* stream) {
  const int smem = 4 * N * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      contacts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (B == 0) return 0;
  contacts_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)params, (const float*)xs, (const float*)ys,
      (const float*)zs, (const float*)pxs, (const float*)pys,
      (const float*)pzs, (const int*)packed, (float*)ox, (float*)oy,
      (float*)oz, N, window, iterations);
  return (int)cudaGetLastError();
}

extern "C" const char* flingbot_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
