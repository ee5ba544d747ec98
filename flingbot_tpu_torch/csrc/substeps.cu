// Fused XPBD substeps for grid cloths, one env across a thread-block
// cluster.
//
// Replaces: flingbot_tpu/engine/pallas_kernels.py `_substeps_kernel`
// (launched by `pallas_substeps`, pl.pallas_call at :314).  Per env,
// n_sub substeps of: integrate gravity + damping -> `iterations` x
// (6-class Jacobi springs with local-relaxation count normalization,
// Chebyshev-accelerated after 2 plain iterations when cheb != 0, then the
// ground plane with Coulomb friction) -> velocity finalize under the
// speed-up-only maxAcceleration clamp -> picker-sphere push, position only
// (the last one skipped when picker_last == 0).  Returns P, V and the
// positions at the start of the last substep.
//
// What bounds it on this card: f32 issue and shared-memory bandwidth.
// Every iteration reads 12 neighbours and 12 spring coefficients per
// particle; device memory is touched only at launch start, integrate,
// finalize and launch end.
//
// Design.  An iteration reads the whole previous iterate of an env, so one
// env is one cluster of kCluster = 8 CTAs (a launch attribute), each owning
// a band of the env's own rows (max(2, ceil(dimy / 8))) and holding it
// with a 2-row halo above and below (the stencil reaches dy = +-2) in
// shared memory:
//   - two ping-pong position buffers X0, X1 (3 planes each).  Iteration it
//     reads A = X[it & 1] and writes its result over B = X[(it + 1) & 1],
//     which holds the iterate before A: the Chebyshev update
//     omega * (J(A) - B) + B reads and writes only the thread's own slot of
//     B, so one barrier per iteration suffices;
//   - the spring coefficient q = stiff / (w_i + w_j + eps) of each class
//     at each constraint's start slot (6 planes over the band and the halo
//     above it), computed once per launch: the start end takes (w_i * q)
//     and the other end (w_j * q) of the same q, so the loop does no
//     division and never reads a neighbour's w;
//   - a record per owned slot: a metadata word (12 constraint-liveness
//     bits, moving, halo-row flags and the slot's shared-memory index, so
//     the loop does no bounds check and no i / W), the relaxation factor,
//     w and the substep-start position (the plane's friction and the
//     finalize read it).
// After writing its own slots a CTA writes its first and last two rows
// into its neighbours' halos through distributed shared memory
// (cluster.map_shared_rank), then the cluster synchronises once.  V stays
// in device memory, read at integrate and finalize only.  At 104 x 104
// and 8 CTAs, a CTA holds 17 + 15 rows x 104 x 6 planes + 13 x 104 x 6
// words (110 KB), so two CTAs of 512 threads share an SM and one's
// cluster barrier overlaps the other's work (a cluster of 4 needs 205 KB
// a CTA: one per SM).  Threads walk the env's dimx x dimy slots, not the
// lattice; slots outside the cloth are copied through once.  Each spring
// is evaluated from both ends (a start-role and a neighbour-role term per
// slot and class) so that no atomics are needed and every slot sums in
// the plain version's order.  Built with -fmad=false (engine/build.py),
// it matches engine/kernels.py substeps_plain bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
// CTAs per env; engine/kernels.py SUBSTEPS_CLUSTER sizes the bands with it
constexpr int kCluster = 8;
constexpr float kEps = 1e-9f;
constexpr int kChebDelay = 2;
constexpr int kParamLen = 21;
// metadata word of an owned slot: bit 2k start-role constraint of class k
// live, bit 2k + 1 neighbour-role constraint live, then these flags, and
// the slot's index in the band from kIndexShift up
constexpr unsigned kMoving = 1u << 12;
constexpr unsigned kHaloUp = 1u << 13;    // one of the band's first 2 rows
constexpr unsigned kHaloDown = 1u << 14;  // one of the band's last 2 rows
constexpr int kIndexShift = 16;
// the record of an owned slot: metadata word, relaxation factor, inverse
// mass, substep-start position (x, y, z); the first four are read as two
// float2 in every iteration
constexpr int kRec = 6;
constexpr int kMeta = 0, kInvc = 1, kW = 2, kPr = 3;

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

__device__ __forceinline__ Params load_params(const float* p, int H, int W) {
  Params q;
  q.dt = p[0]; q.gravity_y = p[1]; q.damping = p[2]; q.mu = p[3];
  q.coldist = p[4]; q.relax = p[5]; q.spacing = p[6];
  q.stiff[0] = p[7]; q.stiff[1] = p[8]; q.stiff[2] = p[9];
  q.dimx = min((int)p[10], W); q.dimy = min((int)p[11], H);
  q.picker_R = p[12]; q.rho2 = p[13];
  for (int k = 0; k < 6; ++k) q.picker[k] = p[14 + k];
  q.a_max = p[20];
  return q;
}

// One Jacobi spring pass for the owned slot at band index si: the displaced
// position P_i + invc * sum of its corrections, summed per class as the
// plain version does (start-role term, then neighbour-role term).  Every
// term is computed and a dead constraint's is replaced by 0 (select, not
// branch: no divergence at the cloth's edges, and the loads of all 12
// neighbours can be issued together).  Its reads stay inside the band
// (an owned slot's neighbours lie within 2 rows) but may be garbage, which
// the selects discard.  Adding +0 in place of skipping the term changes
// at most the sign of a zero sum.
__device__ __forceinline__ void jacobi(const float* A, const float* Q,
                                       int plane, int qplane, int W,
                                       unsigned m, int si, float wi,
                                       float invc, const Params& q,
                                       float& ox, float& oy, float& oz) {
  const float* Ay = A + plane;
  const float* Az = A + 2 * plane;
  const float px = A[si], py = Ay[si], pz = Az[si];
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int dy, dx, cls;
    float rest_k;
    stencil(k, dy, dx, rest_k, cls);
    const float rest = rest_k * q.spacing;
    const int off = dy * W + dx;
    const float* Qk = Q + k * qplane;
    {  // start role: constraint (i, i + off)
      const bool live = (m >> (2 * k)) & 1u;
      const int j = si + off;
      const float gA = wi * Qk[si];
      const float d0 = A[j] - px, d1 = Ay[j] - py, d2 = Az[j] - pz;
      const float r = rsqrtf(d0 * d0 + d1 * d1 + d2 * d2 + kEps);
      const float a = gA * (1.f - rest * r);
      a0 += live ? a * d0 : 0.f;
      a1 += live ? a * d1 : 0.f;
      a2 += live ? a * d2 : 0.f;
    }
    {  // neighbour role: constraint (i - off, i)
      const bool live = (m >> (2 * k + 1)) & 1u;
      const int h = si - off;
      const float gB = wi * Qk[h];
      const float d0 = px - A[h], d1 = py - Ay[h], d2 = pz - Az[h];
      const float r = rsqrtf(d0 * d0 + d1 * d1 + d2 * d2 + kEps);
      const float b = gB * (1.f - rest * r);
      a0 -= live ? b * d0 : 0.f;
      a1 -= live ? b * d1 : 0.f;
      a2 -= live ? b * d2 : 0.f;
    }
  }
  ox = px + invc * a0;
  oy = py + invc * a1;
  oz = pz + invc * a2;
}

// ground plane y >= collision_distance with PBD Coulomb friction; a slot
// out of contact keeps its position
__device__ __forceinline__ void ground(float& x, float& y, float& z, float prx,
                                       float prz, bool moving,
                                       const Params& q) {
  const float pen = q.coldist - y;
  if (!(pen > 0.f && moving)) return;
  const float dx = x - prx, dz = z - prz;
  const float tn = sqrtf(dx * dx + dz * dz + kEps);
  const float f = fminf(1.f, q.mu * fmaxf(pen, 0.f) / tn);
  x -= dx * f;
  y += pen;
  z -= dz * f;
}

// Store a position at band index si, and into a neighbour's halo when the
// slot lies in the band's first or last two rows.  `shift` = rows * W:
// row g is local row g - s + 2 in every CTA's band, so the upper
// neighbour (whose band starts rows earlier) keeps it `shift` further on.
__device__ __forceinline__ void put(float* buf, float* up, float* down,
                                    int plane, int si, int shift, unsigned m,
                                    float x, float y, float z) {
  buf[si] = x; buf[plane + si] = y; buf[2 * plane + si] = z;
  if (m & kHaloUp) {
    const int i = si + shift;
    up[i] = x; up[plane + i] = y; up[2 * plane + i] = z;
  }
  if (m & kHaloDown) {
    const int i = si - shift;
    down[i] = x; down[plane + i] = y; down[2 * plane + i] = z;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
substeps_kernel(const float* __restrict__ params, const float* __restrict__ P,
                const float* __restrict__ V, const float* __restrict__ w,
                float* __restrict__ P_out, float* __restrict__ V_out,
                float* __restrict__ prev_out, int H, int W, int n_sub,
                int iterations, int cheb, int picker_last, int band) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int C = kCluster;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int t = threadIdx.x;
  const Params q = load_params(params + (size_t)b * kParamLen, H, W);
  const int dimx = q.dimx, dimy = q.dimy;
  const int HW = H * W;
  const size_t o3 = (size_t)b * 3 * HW;

  // shared memory: 6 position planes of band + 4 rows, 6 coefficient
  // planes of band + 2 rows (the start slots of rows [s - 2, e)), then a
  // record of kRec words per owned slot
  const int plane = (band + 4) * W;
  const int qplane = (band + 2) * W;
  float* X0 = smem;
  float* X1 = smem + 3 * plane;
  float* Q = smem + 6 * plane;
  float* own = Q + 6 * qplane;

  // this CTA's rows [s, e) of the env; band row g is local row g - s + 2
  const int rows = max(2, (dimy + C - 1) / C);
  const int s = min(dimy, rank * rows);
  const int e = min(dimy, s + rows);
  const int n_own = (e - s) * dimx;
  const int base = (s - 2) * W;  // lattice slot = band index + base
  const int shift = rows * W;

  // slots outside the cloth never move: P and prev pass through, V is 0.
  // CTA r copies lattice rows [r * Hs, (r + 1) * Hs)
  {
    const int Hs = (H + C - 1) / C;
    const int y0 = rank * Hs;
    const int n = max(0, min(H, y0 + Hs) - y0) * W;
    for (int i = t; i < n; i += kThreads) {
      const int y = y0 + i / W, x = i - (i / W) * W;
      if (inside(y, x, dimy, dimx)) continue;
      const int g = y * W + x;
      for (int c = 0; c < 3; ++c) {
        const float p = P[o3 + c * HW + g];
        P_out[o3 + c * HW + g] = p;
        prev_out[o3 + c * HW + g] = p;
        V_out[o3 + c * HW + g] = 0.f;
      }
    }
  }

  // inverse masses of rows [s - 2, e + 2) into X1's first plane (free
  // until the first iteration), 0 outside the cloth
  float* wt = X1;
  {
    const int n = (e - s + 4) * dimx;
    for (int i = t; i < n; i += kThreads) {
      const int lr = i / dimx, x = i - (i / dimx) * dimx;
      const int g = s - 2 + lr;
      wt[lr * W + x] = inside(g, x, dimy, dimx)
                           ? w[(size_t)b * HW + g * W + x] : 0.f;
    }
  }
  __syncthreads();

  // spring coefficients at the start slots of rows [s - 2, e)
  {
    const int r0 = max(0, s - 2);
    const int n = (e - r0) * dimx;
    for (int i = t; i < n; i += kThreads) {
      const int g = r0 + i / dimx, x = i - (i / dimx) * dimx;
      const int si = (g - s + 2) * W + x;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        int dy, dx, cls;
        float rest_k;
        stencil(k, dy, dx, rest_k, cls);
        if (!inside(g + dy, x + dx, dimy, dimx)) continue;
        const float denom = wt[si] + wt[si + dy * W + dx];
        if (denom > 0.f) Q[k * qplane + si] = q.stiff[cls] / (denom + kEps);
      }
    }
  }
  // owned slots: metadata, relaxation factor, w; positions into X0
  for (int l = t; l < n_own; l += kThreads) {
    const int lo = l / dimx, x = l - (l / dimx) * dimx;
    const int g = s + lo;
    const int si = (lo + 2) * W + x;
    const float wi = wt[si];
    unsigned m = 0u;
    float count = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      int dy, dx, cls;
      float rest_k;
      stencil(k, dy, dx, rest_k, cls);
      const int off = dy * W + dx;
      if (inside(g + dy, x + dx, dimy, dimx) && wi + wt[si + off] > 0.f) {
        m |= 1u << (2 * k);
        count += 1.f;
      }
      if (inside(g - dy, x - dx, dimy, dimx) && wt[si - off] + wi > 0.f) {
        m |= 1u << (2 * k + 1);
        count += 1.f;
      }
    }
    if (wi > 0.f) m |= kMoving;
    if (lo < 2 && rank > 0) m |= kHaloUp;
    if (lo >= rows - 2 && e < dimy) m |= kHaloDown;
    float* rec = own + kRec * l;
    rec[kMeta] = __uint_as_float(m | ((unsigned)si << kIndexShift));
    rec[kInvc] = q.relax / fmaxf(count, 1.f);
    rec[kW] = wi;
    const int gi = si + base;
    X0[si] = P[o3 + gi];
    X0[plane + si] = P[o3 + HW + gi];
    X0[2 * plane + si] = P[o3 + 2 * HW + gi];
  }
  // every CTA of the cluster runs (distributed shared memory may be
  // touched from here on) and has read its inverse masses from X1
  cluster.sync();
  float* up0 = cluster.map_shared_rank(smem, max(rank - 1, 0));
  float* down0 = cluster.map_shared_rank(smem, min(rank + 1, C - 1));

  const float dt = q.dt;
  const float damp = fmaxf(0.f, 1.f - q.damping * dt);
  float* V_o = V_out + o3;
  int F = 0;  // the buffer holding the current positions
  for (int sub = 0; sub < n_sub; ++sub) {
    // integrate: gravity, damping, predict into X0
    const float* Vs = sub == 0 ? V + o3 : V_o;
    const float* Fb = F ? X1 : X0;
    for (int l = t; l < n_own; l += kThreads) {
      float* rec = own + kRec * l;
      const unsigned m = __float_as_uint(rec[kMeta]);
      const int si = (int)(m >> kIndexShift);
      const int gi = si + base;
      const bool moving = (m & kMoving) != 0u;
      float vx = Vs[gi], vy = Vs[HW + gi] + dt * q.gravity_y,
            vz = Vs[2 * HW + gi];
      vx *= damp; vy *= damp; vz *= damp;
      if (!moving) { vx = 0.f; vy = 0.f; vz = 0.f; }
      const float px = Fb[si], py = Fb[plane + si], pz = Fb[2 * plane + si];
      V_o[gi] = vx; V_o[HW + gi] = vy; V_o[2 * HW + gi] = vz;
      rec[kPr] = px; rec[kPr + 1] = py; rec[kPr + 2] = pz;
      put(X0, up0, down0, plane, si, shift, m,
          moving ? px + dt * vx : px, moving ? py + dt * vy : py,
          moving ? pz + dt * vz : pz);
    }
    cluster.sync();

    // springs + plane, Chebyshev-accelerated after the warm-up when cheb
    float omega = 1.f;
    for (int it = 0; it < iterations; ++it) {
      const bool accel = cheb && it >= kChebDelay;
      if (cheb && it == kChebDelay) omega = 2.f / (2.f - q.rho2);
      else if (cheb && it > kChebDelay) omega = 4.f / (4.f - q.rho2 * omega);
      const float* A = (it & 1) ? X1 : X0;
      float* Bb = (it & 1) ? X0 : X1;
      float* up = Bb - smem + up0;
      float* down = Bb - smem + down0;
#pragma unroll 1
      for (int l = t; l < n_own; l += kThreads) {
        const float* rec = own + kRec * l;
        const float2 r0 = *reinterpret_cast<const float2*>(rec);
        const float2 r1 = *reinterpret_cast<const float2*>(rec + 2);
        const unsigned m = __float_as_uint(r0.x);
        const int si = (int)(m >> kIndexShift);
        float jx, jy, jz;
        jacobi(A, Q, plane, qplane, W, m, si, r1.x, r0.y, q, jx, jy, jz);
        if (accel) {
          const float cx = Bb[si], cy = Bb[plane + si],
                      cz = Bb[2 * plane + si];
          jx = omega * (jx - cx) + cx;
          jy = omega * (jy - cy) + cy;
          jz = omega * (jz - cz) + cz;
        }
        ground(jx, jy, jz, r1.y, rec[kPr + 2], (m & kMoving) != 0u, q);
        put(Bb, up, down, plane, si, shift, m, jx, jy, jz);
      }
      cluster.sync();
    }
    F = iterations & 1;

    // velocity finalize (speed-up-only clamp), then the picker push; only
    // this thread's own slots are read and written until the next barrier
    const bool push = sub < n_sub - 1 || picker_last;
    float* Pb = F ? X1 : X0;
    for (int l = t; l < n_own; l += kThreads) {
      const float* rec = own + kRec * l;
      const unsigned m = __float_as_uint(rec[kMeta]);
      const int si = (int)(m >> kIndexShift);
      const int gi = si + base;
      const bool moving = (m & kMoving) != 0u;
      float px = Pb[si], py = Pb[plane + si], pz = Pb[2 * plane + si];
      if (moving) {
        const float vx = V_o[gi], vy = V_o[HW + gi], vz = V_o[2 * HW + gi];
        const float nvx = (px - rec[kPr]) / dt;
        const float nvy = (py - rec[kPr + 1]) / dt;
        const float nvz = (pz - rec[kPr + 2]) / dt;
        const float d0 = nvx - vx, d1 = nvy - vy, d2 = nvz - vz;
        const float r = rsqrtf(d0 * d0 + d1 * d1 + d2 * d2 + kEps);
        const bool speeding =
            nvx * nvx + nvy * nvy + nvz * nvz > vx * vx + vy * vy + vz * vz;
        const float sc = speeding ? fminf(1.f, q.a_max * dt * r) : 1.f;
        V_o[gi] = vx + d0 * sc;
        V_o[HW + gi] = vy + d1 * sc;
        V_o[2 * HW + gi] = vz + d2 * sc;
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
        Pb[si] = px; Pb[plane + si] = py; Pb[2 * plane + si] = pz;
      }
    }
    // the next integrate reads and writes this thread's own slots and
    // writes neighbours' halos, which nobody reads before its barrier
  }

  const float* Pb = F ? X1 : X0;
  for (int l = t; l < n_own; l += kThreads) {
    const float* rec = own + kRec * l;
    const int si = (int)(__float_as_uint(rec[kMeta]) >> kIndexShift);
    const int gi = si + base;
    P_out[o3 + gi] = Pb[si];
    P_out[o3 + HW + gi] = Pb[plane + si];
    P_out[o3 + 2 * HW + gi] = Pb[2 * plane + si];
    prev_out[o3 + gi] = rec[kPr];
    prev_out[o3 + HW + gi] = rec[kPr + 1];
    prev_out[o3 + 2 * HW + gi] = rec[kPr + 2];
  }
  // no CTA touches another's shared memory after the last cluster.sync
}

cudaLaunchConfig_t launch_config(int B, int smem, cudaLaunchAttribute* attr,
                                 void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// clusters of kCluster CTAs with `smem` bytes each that the card runs at
// once (0: the launch cannot run)
extern "C" int flingbot_substeps_max_clusters(int smem, int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      substeps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, smem, &attr, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(out, (const void*)substeps_kernel,
                                             &cfg);
}

extern "C" int flingbot_substeps(const void* params, const void* P,
                                 const void* V, const void* w, void* P_out,
                                 void* V_out, void* prev_out, int B, int H,
                                 int W, int n_sub, int iterations, int cheb,
                                 int picker_last, int band, int smem,
                                 void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      substeps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (B == 0) return 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(B, smem, &attr, stream);
  e = cudaLaunchKernelEx(&cfg, substeps_kernel, (const float*)params,
                         (const float*)P, (const float*)V, (const float*)w,
                         (float*)P_out, (float*)V_out, (float*)prev_out, H, W,
                         n_sub, iterations, cheb, picker_last, band);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* flingbot_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
