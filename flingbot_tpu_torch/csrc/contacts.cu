// Self-collision projection on Morton-sorted particles, one thread block
// per env, in grid mode and in mesh mode.
//
// Replaces: flingbot_tpu/engine/pallas_kernels.py `_contacts_kernel`
// (launched by `pallas_contacts`, pl.pallas_call at :563), both of its
// modes.  Per env, on arrays already in Morton order, `iterations` x: test
// pairs (i, i + k) for k = 1..window for penetration below rest_dist;
// drop filtered pairs (SelfCollideFilter: lattice neighbours by their
// packed ids in grid mode; in mesh mode, pairs whose rest-pose distance^2
// rd0^2 + rd1^2 + rd2^2 is below rest_dist^2); project with PBD
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
//
// Mesh mode: the rest coordinates are constant over the launch, so the
// filter is too.  It is computed once per launch into a per-particle
// bitmask in shared memory (bit k - 1 of mask[i]: pair (i, i + k) is
// filtered; the neighbour role reads bit k - 1 of mask[i - k]), from rest
// coordinates read once through the read-only cache.  Keeping the three
// rest arrays resident instead would take 12 bytes a particle (172 KB at
// the eval shirts' 6144 slots, 302 KB at the grid's 10816, which does not
// fit) and recompute the filter 2 x window x iterations times; the mask
// takes 4 bytes (window <= 32), so both modes share the capacity of
// 1024 x 11 particles.  The packed id holds the flat slot index in mesh
// mode; only its immobile / inactive bits are read.  Inactive slots, keyed
// past every active one, sort to the end and stay passive.

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

__device__ __forceinline__ bool lattice_nbr(const Slot& A, const Slot& C) {
  return abs(C.lx - A.lx) <= 1 && abs(C.ly - A.ly) <= 1;
}

// Correction g of the pair (a, c) as seen from its start a, and whether
// the pair is a live contact.  The start a takes +w_a * g, the
// neighbour c takes -w_c * g.  nbr: the pair is filtered.
__device__ __forceinline__ bool pair(float ax, float ay, float az, float cx,
                                     float cy, float cz, float pax, float pay,
                                     float paz, float pcx, float pcy,
                                     float pcz, const Slot& A, const Slot& C,
                                     bool nbr, float rest_d, float mu_p,
                                     float& gx, float& gy, float& gz) {
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

template <bool kMesh>
__global__ void __launch_bounds__(kThreads, 1)
contacts_kernel(const float* __restrict__ params, const float* __restrict__ xs,
                const float* __restrict__ ys, const float* __restrict__ zs,
                const float* __restrict__ pxs, const float* __restrict__ pys,
                const float* __restrict__ pzs, const int* __restrict__ packed,
                const float* __restrict__ rxs, const float* __restrict__ rys,
                const float* __restrict__ rzs, float* __restrict__ ox,
                float* __restrict__ oy, float* __restrict__ oz, int N,
                int window, int iterations) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + N;
  float* sz = sy + N;
  int* spk = reinterpret_cast<int*>(sz + N);
  unsigned* smask = reinterpret_cast<unsigned*>(spk + N);  // mesh mode

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
    if constexpr (kMesh) {
      const float* RX = rxs + o;
      const float* RY = rys + o;
      const float* RZ = rzs + o;
      const float rx = __ldg(RX + i), ry = __ldg(RY + i), rz = __ldg(RZ + i);
      unsigned m = 0u;
      for (int k = 1; k <= window && i + k < N; ++k) {
        const float rd0 = rx - __ldg(RX + i + k);
        const float rd1 = ry - __ldg(RY + i + k);
        const float rd2 = rz - __ldg(RZ + i + k);
        if (rd0 * rd0 + rd1 * rd1 + rd2 * rd2 < rest_d * rest_d)
          m |= 1u << (k - 1);
      }
      smask[i] = m;
    }
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
            const bool nbr = kMesh ? ((smask[i] >> (k - 1)) & 1u) != 0u
                                   : lattice_nbr(A, C);
            const bool lv = pair(X, Y, Z, sx[j], sy[j], sz[j], pX, pY, pZ,
                                 __ldg(PX + j), __ldg(PY + j), __ldg(PZ + j),
                                 A, C, nbr, rest_d, mu_p, gx, gy, gz);
            ax += A.w * gx; ay += A.w * gy; az += A.w * gz;
            cnt += lv ? 1.f : 0.f;
          }
          const int h = i - k;  // neighbour role: pair (i - k, i)
          if (h >= 0) {
            const Slot C = decode(spk[h], w_uni);
            const bool nbr = kMesh ? ((smask[h] >> (k - 1)) & 1u) != 0u
                                   : lattice_nbr(C, A);
            const bool lv = pair(sx[h], sy[h], sz[h], X, Y, Z, __ldg(PX + h),
                                 __ldg(PY + h), __ldg(PZ + h), pX, pY, pZ, C,
                                 A, nbr, rest_d, mu_p, gx, gy, gz);
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

template <bool kMesh>
int launch(const void* params, const void* xs, const void* ys, const void* zs,
           const void* pxs, const void* pys, const void* pzs,
           const void* packed, const void* rxs, const void* rys,
           const void* rzs, void* ox, void* oy, void* oz, int B, int N,
           int window, int iterations, void* stream) {
  const int smem = (kMesh ? 5 : 4) * N * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      contacts_kernel<kMesh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  if (B == 0) return 0;
  contacts_kernel<kMesh><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)params, (const float*)xs, (const float*)ys,
      (const float*)zs, (const float*)pxs, (const float*)pys,
      (const float*)pzs, (const int*)packed, (const float*)rxs,
      (const float*)rys, (const float*)rzs, (float*)ox, (float*)oy,
      (float*)oz, N, window, iterations);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flingbot_contacts(const void* params, const void* xs,
                                 const void* ys, const void* zs,
                                 const void* pxs, const void* pys,
                                 const void* pzs, const void* packed,
                                 void* ox, void* oy, void* oz, int B, int N,
                                 int window, int iterations, void* stream) {
  return launch<false>(params, xs, ys, zs, pxs, pys, pzs, packed, nullptr,
                       nullptr, nullptr, ox, oy, oz, B, N, window,
                       iterations, stream);
}

extern "C" int flingbot_contacts_mesh(
    const void* params, const void* xs, const void* ys, const void* zs,
    const void* pxs, const void* pys, const void* pzs, const void* packed,
    const void* rxs, const void* rys, const void* rzs, void* ox, void* oy,
    void* oz, int B, int N, int window, int iterations, void* stream) {
  return launch<true>(params, xs, ys, zs, pxs, pys, pzs, packed, rxs, rys,
                      rzs, ox, oy, oz, B, N, window, iterations, stream);
}

extern "C" const char* flingbot_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
