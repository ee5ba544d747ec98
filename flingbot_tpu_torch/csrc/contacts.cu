// Self-collision projection on Morton-sorted particles, halo-tiled, in grid
// mode and in mesh mode.
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
// bandwidth, not HBM: each input is read once and each output written
// once.
//
// Design: halo tiles.  After `iterations` passes a particle depends only
// on the sorted slots within halo = window x iterations of it, so the
// sorted array of each env is cut into tiles of `tile` owned slots [s, e)
// (geometry from engine/kernels.py contact_tiles), one block each.  A
// block loads [s - halo, e + halo), runs every pass on it alone and
// writes back [s, e): blocks never wait for each other, and at the shirt
// path's 16 envs x 6144 slots, 512-slot tiles give 192 blocks.  Pass it
// only computes the slots that a later pass or the output still needs
// (the region shrinks by `window` on each side per pass).  Shared memory
// holds three float4 planes over the tile and its halos: two ping-pong
// buffers (x, y, z, packed id) that a pass reads and writes in turn, so
// one barrier separates passes, and (px, py, pz, mesh filter bits), the
// previous positions that the friction reads: no pair reads device
// memory.  Inactive slots, keyed past every active one, sort to the end,
// so a tile whose first slot is inactive copies its input through.  Each
// particle evaluates both of its roles, (i, i + k) and (i - k, i), for
// every k and sums its own correction and count, so no atomics are needed
// and the sum runs in the plain version's order.  Built with -fmad=false,
// it matches contacts_plain bit for bit.
//
// Mesh mode: the rest coordinates are constant over the launch, so the
// filter is too.  A block computes it once into a per-slot bitmask (bit
// k - 1 of mask[i]: pair (i, i + k) is filtered; the neighbour role reads
// bit k - 1 of mask[i - k]; window <= 32) from rest coordinates staged in
// the second position buffer.  The packed id holds the flat slot index in
// mesh mode; only its immobile / inactive bits are read.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
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
__global__ void __launch_bounds__(kThreads)
contacts_kernel(const float* __restrict__ params, const float* __restrict__ xs,
                const float* __restrict__ ys, const float* __restrict__ zs,
                const float* __restrict__ pxs, const float* __restrict__ pys,
                const float* __restrict__ pzs, const int* __restrict__ packed,
                const float* __restrict__ rxs, const float* __restrict__ rys,
                const float* __restrict__ rzs, float* __restrict__ ox,
                float* __restrict__ oy, float* __restrict__ oz, int N,
                int window, int iterations, int tile, int halo, int n_tiles) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x / n_tiles;
  const int s = (blockIdx.x - b * n_tiles) * tile;
  const int e = min(N, s + tile);
  const int t = threadIdx.x;
  const size_t o = (size_t)b * N;

  if ((packed[o + s] >> kInactiveBit) & 1) {  // the env's inactive tail
    for (int i = s + t; i < e; i += kThreads) {
      ox[o + i] = xs[o + i];
      oy[o + i] = ys[o + i];
      oz[o + i] = zs[o + i];
    }
    return;
  }

  const int lo = max(0, s - halo);
  const int n = min(N, e + halo) - lo;  // loaded slots [lo, lo + n)
  const int cap = tile + 2 * halo;
  float4* buf0 = smem4;
  float4* buf1 = smem4 + cap;
  float4* stat = smem4 + 2 * cap;  // px, py, pz, mesh filter bits

  const float* prm = params + (size_t)b * kParamLen;
  const float rest_d = prm[0], w_uni = prm[1], mu_p = prm[2];
  const float mu_plane = prm[3], coldist = prm[4];

  for (int i = t; i < n; i += kThreads) {
    const size_t g = o + lo + i;
    buf0[i] = make_float4(xs[g], ys[g], zs[g], __int_as_float(packed[g]));
    stat[i] = make_float4(pxs[g], pys[g], pzs[g], 0.f);
    if constexpr (kMesh) buf1[i] = make_float4(rxs[g], rys[g], rzs[g], 0.f);
  }
  if constexpr (kMesh) {
    __syncthreads();
    for (int i = t; i < n; i += kThreads) {
      const float4 ri = buf1[i];
      unsigned m = 0u;
      for (int k = 1; k <= window && i + k < n; ++k) {
        const float4 rj = buf1[i + k];
        const float rd0 = ri.x - rj.x, rd1 = ri.y - rj.y, rd2 = ri.z - rj.z;
        if (rd0 * rd0 + rd1 * rd1 + rd2 * rd2 < rest_d * rest_d)
          m |= 1u << (k - 1);
      }
      stat[i].w = __uint_as_float(m);
    }
  }
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    const float4* src = (it & 1) ? buf1 : buf0;
    float4* dst = (it & 1) ? buf0 : buf1;
    // the slots a later pass or the output still reads
    const int reach = (iterations - 1 - it) * window;
    const int a = max(0, s - reach - lo);
    const int z = min(n, e + reach - lo);
    for (int i = a + t; i < z; i += kThreads) {
      const float4 ci = src[i];
      const float4 pi = stat[i];
      const int pk = __float_as_int(ci.w);
      const Slot A = decode(pk, w_uni);
      const bool immobile = ((pk >> kImmobileBit) & 1) != 0;
      const float ms = (A.active && !immobile) ? 1.f : 0.f;
      const unsigned mi = kMesh ? __float_as_uint(pi.w) : 0u;
      float ax = 0.f, ay = 0.f, az = 0.f, cnt = 0.f;
      for (int k = 1; k <= window; ++k) {
        float gx, gy, gz;
        const int j = i + k;  // start role: pair (i, i + k)
        if (j < n) {
          const float4 cj = src[j];
          const float4 pj = stat[j];
          const Slot C = decode(__float_as_int(cj.w), w_uni);
          const bool nbr = kMesh ? ((mi >> (k - 1)) & 1u) != 0u
                                 : lattice_nbr(A, C);
          const bool lv = pair(ci.x, ci.y, ci.z, cj.x, cj.y, cj.z, pi.x,
                               pi.y, pi.z, pj.x, pj.y, pj.z, A, C, nbr,
                               rest_d, mu_p, gx, gy, gz);
          ax += A.w * gx; ay += A.w * gy; az += A.w * gz;
          cnt += lv ? 1.f : 0.f;
        }
        const int h = i - k;  // neighbour role: pair (i - k, i)
        if (h >= 0) {
          const float4 ch = src[h];
          const float4 ph = stat[h];
          const Slot C = decode(__float_as_int(ch.w), w_uni);
          const bool nbr = kMesh ? ((__float_as_uint(ph.w) >> (k - 1)) & 1u)
                                       != 0u
                                 : lattice_nbr(C, A);
          const bool lv = pair(ch.x, ch.y, ch.z, ci.x, ci.y, ci.z, ph.x,
                               ph.y, ph.z, pi.x, pi.y, pi.z, C, A, nbr,
                               rest_d, mu_p, gx, gy, gz);
          ax -= A.w * gx; ay -= A.w * gy; az -= A.w * gz;
          cnt += lv ? 1.f : 0.f;
        }
      }
      const float inv_cnt = ms / fmaxf(cnt, 1.f);
      float x = ci.x + ax * inv_cnt, y = ci.y + ay * inv_cnt,
            zz = ci.z + az * inv_cnt;
      // ground plane with Coulomb friction
      const float pen = coldist - y;
      const float cf = pen > 0.f ? ms : 0.f;
      const float dx = x - pi.x, dz = zz - pi.z;
      const float tn = sqrtf(dx * dx + dz * dz + kEps);
      const float f = cf * fminf(1.f, mu_plane * fmaxf(pen, 0.f) / tn);
      dst[i] = make_float4(x - dx * f, y + cf * pen, zz - dz * f, ci.w);
    }
    __syncthreads();
  }

  const float4* res = (iterations & 1) ? buf1 : buf0;
  for (int i = s + t; i < e; i += kThreads) {
    const float4 r = res[i - lo];
    ox[o + i] = r.x;
    oy[o + i] = r.y;
    oz[o + i] = r.z;
  }
}

}  // namespace

// rxs == nullptr: grid mode; else mesh mode with the sorted rest
// coordinates rxs, rys, rzs
extern "C" int flingbot_contacts(
    const void* params, const void* xs, const void* ys, const void* zs,
    const void* pxs, const void* pys, const void* pzs, const void* packed,
    const void* rxs, const void* rys, const void* rzs, void* ox, void* oy,
    void* oz, int B, int N, int window, int iterations, int tile, int halo,
    int n_tiles, int smem, void* stream) {
  const bool mesh = rxs != nullptr;
  auto kernel = mesh ? contacts_kernel<true> : contacts_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || N == 0) return 0;
  kernel<<<B * n_tiles, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)params, (const float*)xs, (const float*)ys,
      (const float*)zs, (const float*)pxs, (const float*)pys,
      (const float*)pzs, (const int*)packed, (const float*)rxs,
      (const float*)rys, (const float*)rzs, (float*)ox, (float*)oy,
      (float*)oz, N, window, iterations, tile, halo, n_tiles);
  return (int)cudaGetLastError();
}

extern "C" const char* flingbot_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
