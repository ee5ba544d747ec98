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
// What bounds it on this card: instruction issue and latency in the spring
// loop.  Device memory is touched only at launch start, integrate,
// finalize and launch end.  A spring's length, rsqrt and relaxation
// e = 1 - rest / |d| cost ~16 instructions, its two end terms ~14 more; a
// row of a thread's strip (6 springs, 12 terms, Chebyshev, plane, store)
// is one dependent chain of ~300 instructions, so the loop runs at the
// pace of the warps an SM holds (two CTAs of 14 warps at 72 registers).
//
// Cluster and bands.  An iteration reads the whole previous iterate of an
// env, so one env is one cluster of kCluster = 8 CTAs (a launch attribute),
// each owning a band of the env's own rows (max(2, ceil(dimy / 8))) and
// holding it with a 2-row halo above and below (the stencil reaches
// dy = +-2) in shared memory:
//   - two ping-pong position buffers X0, X1 of float4 (x, y, z, w: the
//     inverse mass rides with the position, so a neighbour's w costs no
//     load).  Iteration it reads A = X[it & 1] and writes its result over
//     B = X[(it + 1) & 1], which holds the iterate before A: the Chebyshev
//     update omega * (J(A) - B) + B reads and writes only the thread's own
//     slot of B, so one barrier per iteration suffices;
//   - the spring coefficient q = stiff / (w_i + w_j + eps) of each class
//     at each constraint's start slot (6 planes over the band and the 2
//     rows above it), computed once per launch, 0 for a dead constraint;
//     the start end takes (w_i * q) and the other end (w_j * q);
//   - per owned slot the relaxation factor and the substep-start x and z
//     (the plane's friction reads them).
// Both buffers are zeroed at launch, so every cell the stencil can read
// outside the cloth holds 0: a dead constraint's zero coefficient then
// gives a zero term (as the plain version's zero coefficient planes do),
// and the loop needs no liveness bits and no selects.  After writing its
// own slots a CTA writes its first and last two rows into its neighbours'
// halos through distributed shared memory (st.shared::cluster), then
// arrives at the cluster barrier; the next iteration starts with the wait.
// V stays in device memory, read at integrate and finalize only.  At
// 104 x 104 a CTA holds 17 rows x 104 x 8 + 15 x 104 x 6 + 13 x 104 x 3
// words (110 KB), so two CTAs share an SM and one's cluster barrier
// overlaps the other's work.
//
// Column strips: each spring once, from registers.  The CTA's owned rows
// are cut into strips, the shortest that fit one column of each strip in
// the CTA's 14 x 29 owning lanes (at most `strip` rows, the lattice's:
// engine/kernels.py substeps_band; 5 at 104 for a full cloth, 3-4 for
// most of the hard set's 64-104).  A thread walks one column of one strip
// down, row by row, holding its column's rows y .. y + 2 in registers.
// Lanes 2..30 of a warp own consecutive positions of the strips laid end
// to end (position p = strip * dimx + x); lanes 0, 1 and 31 repeat the
// columns of the neighbouring warps' edges.  For each row the thread
// evaluates the 6 springs that START at its slot, once each:
//   - vertical springs (dy = 1, 2): both ends are this thread's; the far
//     end's term waits in registers for its row;
//   - horizontal and diagonal springs: the far end is lane +1 or +2 (dx =
//     1, 2; class 4 one row down) or lane -1 (class 5, one row down); the
//     thread computes the far end's term b * d and hands it over by
//     __shfl_up_sync / __shfl_down_sync (3 words), at once or at the next
//     row.
// Positions across a strip boundary (column dimx - 1 beside the next
// strip's column 0) are joined by no spring, so their exchanged terms are
// zeros; lanes past the last position wrap around to the first, where the
// same holds.  Each slot still sums its 12 terms in the plain order (per
// class: start-role term, then minus the neighbour-role term), and the
// terms are the plain version's bit for bit, as it too computes e and d
// once per spring.  Work still done twice: the springs that start in the
// 2 rows above a strip (5 of them a column: its top row's neighbour-role
// terms), the halo lanes' springs (3 of 32 lanes), and the rows that a
// warp's shorter strips idle through; engine/kernels.py
// substeps_evals_per_spring counts evaluations per spring from this
// layout: 1.54 at the hard set's dims, where each slot evaluating its 12
// spring ends made 2.04.  rsqrt and the plane's sqrt take their .ftz
// forms, which give the same bits on their arguments (>= eps, never
// subnormal) without the subnormal fix-up.  Built with -fmad=false
// (engine/build.py), it matches engine/kernels.py substeps_plain bit for
// bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// CTAs per env; engine/kernels.py SUBSTEPS_CLUSTER sizes the bands with it
constexpr int kCluster = 8;
// threads of a CTA (14 warps: two CTAs an SM at 72 registers), owning
// lanes of a warp (2..30) and the most rows of a strip; mirrored by
// engine/kernels.py SUBSTEPS_WARPS, SUBSTEPS_WARP_COLUMNS and
// SUBSTEPS_MAX_STRIP
constexpr int kThreads = 448;
constexpr int kOwnLanes = 29;
constexpr int kMaxStrip = 6;
constexpr float kEps = 1e-9f;
constexpr int kChebDelay = 2;
constexpr int kParamLen = 21;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kSqrt2 = 1.41421356237309515f;

// GRID_STENCIL_CLASSES: (dy, dx, rest in spacings, stiffness class)
__device__ __forceinline__ void stencil(int k, int& dy, int& dx, float& rest,
                                        int& cls) {
  switch (k) {
    case 0: dy = 0; dx = 1; rest = 1.0f; cls = 0; break;
    case 1: dy = 1; dx = 0; rest = 1.0f; cls = 0; break;
    case 2: dy = 0; dx = 2; rest = 2.0f; cls = 1; break;
    case 3: dy = 2; dx = 0; rest = 2.0f; cls = 1; break;
    case 4: dy = 1; dx = 1; rest = kSqrt2; cls = 2; break;
    default: dy = 1; dx = -1; rest = kSqrt2; cls = 2; break;
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

// rsqrt and sqrt of an argument >= kEps, never subnormal: the .ftz forms
// give rsqrtf's and sqrtf's bits without their subnormal fix-up code
__device__ __forceinline__ float rsqrt_normal(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float sqrt_normal(float x) {
  float r;
  asm("sqrt.rn.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// The spring from p to o: d = o - p and its relaxation
// e = 1 - rest * rsqrt(|d|^2 + eps), in the plain version's order.
__device__ __forceinline__ float spring(const float4& p, const float4& o,
                                        float rest, float3& d) {
  d = make_float3(o.x - p.x, o.y - p.y, o.z - p.z);
  const float r = rsqrt_normal(d.x * d.x + d.y * d.y + d.z * d.z + kEps);
  return 1.f - rest * r;
}

// (g * e) * d: a spring end's term, g = w * q of that end
__device__ __forceinline__ float3 term(float g, float e, const float3& d) {
  const float a = g * e;
  return make_float3(a * d.x, a * d.y, a * d.z);
}

__device__ __forceinline__ void plus(float3& acc, const float3& v) {
  acc.x = acc.x + v.x; acc.y = acc.y + v.y; acc.z = acc.z + v.z;
}

__device__ __forceinline__ void minus(float3& acc, const float3& v) {
  acc.x = acc.x - v.x; acc.y = acc.y - v.y; acc.z = acc.z - v.z;
}

// the value of lane - n (up) or lane + n (down)
__device__ __forceinline__ float3 from_below(const float3& v, int n) {
  return make_float3(__shfl_up_sync(kFull, v.x, n),
                     __shfl_up_sync(kFull, v.y, n),
                     __shfl_up_sync(kFull, v.z, n));
}

__device__ __forceinline__ float3 from_above(const float3& v, int n) {
  return make_float3(__shfl_down_sync(kFull, v.x, n),
                     __shfl_down_sync(kFull, v.y, n),
                     __shfl_down_sync(kFull, v.z, n));
}

// ground plane y >= collision_distance with PBD Coulomb friction; a slot
// out of contact keeps its position
__device__ __forceinline__ void ground(float& x, float& y, float& z, float prx,
                                       float prz, bool moving,
                                       const Params& q) {
  const float pen = q.coldist - y;
  if (!(pen > 0.f && moving)) return;
  const float dx = x - prx, dz = z - prz;
  const float tn = sqrt_normal(dx * dx + dz * dz + kEps);
  const float f = fminf(1.f, q.mu * fmaxf(pen, 0.f) / tn);
  x -= dx * f;
  y += pen;
  z -= dz * f;
}

// The cluster barrier in two halves: arrive (release: this thread's
// writes, distributed shared memory included, reach every CTA that waits)
// and wait (acquire); warp-uniform
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the shared::cluster address of this CTA's shared address p in CTA rank
__device__ __forceinline__ unsigned cluster_address(const void* p, int rank) {
  unsigned r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(r) : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
  return r;
}

// Store a position at band index i, and into a neighbour's halo when the
// slot lies in the band's first or last two rows (up, down: the
// neighbours' shared::cluster addresses of this buffer).  `shift` =
// rows * W: row g is local row g - s + 2 in every CTA's band, so the
// upper neighbour (whose band starts rows earlier) keeps it `shift`
// further on.
__device__ __forceinline__ void put(float4* buf, unsigned up, unsigned down,
                                    int i, int shift, bool to_up,
                                    bool to_down, const float4& v) {
  buf[i] = v;
  if (to_up)
    asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
                 :: "r"(up + 16u * (unsigned)(i + shift)), "f"(v.x),
                    "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
  if (to_down)
    asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
                 :: "r"(down + 16u * (unsigned)(i - shift)), "f"(v.x),
                    "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}

__global__ void __launch_bounds__(kThreads, 2)
substeps_kernel(const float* __restrict__ params, const float* __restrict__ P,
                const float* __restrict__ V, const float* __restrict__ w,
                float* __restrict__ P_out, float* __restrict__ V_out,
                float* __restrict__ prev_out, int H, int W, int n_sub,
                int iterations, int cheb, int picker_last, int band,
                int strip) {
  extern __shared__ float4 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int C = kCluster;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int t = threadIdx.x;
  const Params q = load_params(params + (size_t)b * kParamLen, H, W);
  const int dimx = q.dimx, dimy = q.dimy;
  const int HW = H * W;
  const size_t o3 = (size_t)b * 3 * HW;

  // shared memory: 2 float4 position buffers of band + 4 rows, the
  // substep-start (x, z) of band rows, the 6 coefficients of each start
  // slot of rows [s - 2, e) (band + 2 rows, a slot's 6 together: one
  // address and 3 float2 loads a row), the relaxation factors of band
  // rows
  const int plane = (band + 4) * W;
  const int qplane = (band + 2) * W;
  float4* X0 = smem;
  float4* X1 = smem + plane;
  float2* pr = reinterpret_cast<float2*>(smem + 2 * plane);
  float* Q = reinterpret_cast<float*>(pr + band * W);
  float* invc = Q + 6 * qplane;

  // this CTA's rows [s, e) of the env; band row g is local row g - s + 2
  const int rows = max(2, (dimy + C - 1) / C);
  const int s = min(dimy, rank * rows);
  const int e = min(dimy, s + rows);
  const int n_own = (e - s) * dimx;
  const int base = (s - 2) * W;  // lattice slot = band index + base
  const int shift = rows * W;

  // this thread's column of a strip: position p of the strips laid end to
  // end; a lane past either end wraps around (its terms reach no owner).
  // The env's strips are the shortest that fit its columns in the CTA's
  // owning lanes (at most `strip`, the lattice's): more warps at work
  const int lane = t & 31;
  const int fit = (kThreads / 32) * kOwnLanes / max(dimx, 1);
  strip = min(strip, max(1, (e - s + fit - 1) / max(fit, 1)));
  const int total = (e - s + strip - 1) / strip * dimx;
  const int p = (t >> 5) * kOwnLanes - 2 + lane;
  const bool own = lane >= 2 && lane < 2 + kOwnLanes && p < total;
  const int pw = total > 0 ? ((p % total) + total) % total : 0;
  const int col = total > 0 ? pw % dimx : 0;
  const int y0 = s + (total > 0 ? pw / dimx : 0) * strip;
  const int h = min(strip, e - y0);  // rows of the strip, >= 1 if total > 0
  const int i0 = (y0 - s + 2) * W + col;
  // rows the warp walks: its owning lanes' longest strip
  const int hw = __reduce_max_sync(kFull, own ? h : 0);

  // slots outside the cloth never move: P and prev pass through, V is 0.
  // CTA r copies lattice rows [r * Hs, (r + 1) * Hs)
  {
    const int Hs = (H + C - 1) / C;
    const int ya = rank * Hs;
    const int n = max(0, min(H, ya + Hs) - ya) * W;
    for (int i = t; i < n; i += kThreads) {
      const int y = ya + i / W, x = i - (i / W) * W;
      if (inside(y, x, dimy, dimx)) continue;
      const int g = y * W + x;
      for (int c = 0; c < 3; ++c) {
        const float v = P[o3 + c * HW + g];
        P_out[o3 + c * HW + g] = v;
        prev_out[o3 + c * HW + g] = v;
        V_out[o3 + c * HW + g] = 0.f;
      }
    }
  }

  // both position buffers and the coefficient planes start at 0
  {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = t; i < 2 * plane; i += kThreads) smem[i] = zero;
    for (int i = t; i < 6 * qplane; i += kThreads) Q[i] = 0.f;
  }
  __syncthreads();
  // inverse masses of rows [s - 2, e + 2) into both buffers (constant over
  // the launch), positions of the owned rows into X0
  {
    const int n = (e - s + 4) * dimx;
    for (int k = t; k < n; k += kThreads) {
      const int lr = k / dimx, x = k - (k / dimx) * dimx;
      const int g = s - 2 + lr;
      if (!inside(g, x, dimy, dimx)) continue;
      const int i = lr * W + x;
      const float wi = w[(size_t)b * HW + g * W + x];
      X0[i].w = wi;
      X1[i].w = wi;
      if (g >= s && g < e) {
        const int gi = i + base;
        X0[i].x = P[o3 + gi];
        X0[i].y = P[o3 + HW + gi];
        X0[i].z = P[o3 + 2 * HW + gi];
      }
    }
  }
  __syncthreads();

  // spring coefficients at the start slots of rows [s - 2, e)
  {
    const int r0 = max(0, s - 2);
    const int n = (e - r0) * dimx;
    for (int k = t; k < n; k += kThreads) {
      const int g = r0 + k / dimx, x = k - (k / dimx) * dimx;
      const int i = (g - s + 2) * W + x;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        int dy, dx, cls;
        float rest_k;
        stencil(c, dy, dx, rest_k, cls);
        if (!inside(g + dy, x + dx, dimy, dimx)) continue;
        const float denom = X0[i].w + X0[i + dy * W + dx].w;
        if (denom > 0.f) Q[6 * i + c] = q.stiff[cls] / (denom + kEps);
      }
    }
  }
  // relaxation factors of the owned slots: relax / live constraints
  for (int k = t; k < n_own; k += kThreads) {
    const int lo = k / dimx, x = k - (k / dimx) * dimx;
    const int g = s + lo;
    const int i = (lo + 2) * W + x;
    const float wi = X0[i].w;
    float count = 0.f;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      int dy, dx, cls;
      float rest_k;
      stencil(c, dy, dx, rest_k, cls);
      const int off = dy * W + dx;
      if (inside(g + dy, x + dx, dimy, dimx) && wi + X0[i + off].w > 0.f)
        count += 1.f;
      if (inside(g - dy, x - dx, dimy, dimx) && X0[i - off].w + wi > 0.f)
        count += 1.f;
    }
    invc[i - 2 * W] = q.relax / fmaxf(count, 1.f);
  }
  // every CTA of the cluster runs (distributed shared memory may be
  // touched from here on) and has set up its buffers
  cluster.sync();
  const unsigned up0 = cluster_address(smem, max(rank - 1, 0));
  const unsigned down0 = cluster_address(smem, min(rank + 1, C - 1));

  const float dt = q.dt;
  const float damp = fmaxf(0.f, 1.f - q.damping * dt);
  const float rest1 = q.spacing, rest2 = 2.0f * q.spacing;
  const float restd = kSqrt2 * q.spacing;
  // the owned rows of this thread, band index i0 + j * W: rows j < n_up
  // go to the upper neighbour's halo, rows j >= j_down to the lower's
  const int hown = own ? h : 0;
  const int n_up = rank > 0 ? s + 2 - y0 : 0;
  const int j_down = e < dimy ? e - 2 - y0 : kMaxStrip;
  float* V_o = V_out + o3;
  float* Pr = prev_out + o3;  // the substep-start positions
  int F = 0;  // the buffer holding the current positions
  for (int sub = 0; sub < n_sub; ++sub) {
    // integrate: gravity, damping, predict into X0
    const float* Vs = sub == 0 ? V + o3 : V_o;
    const float4* Fb = F ? X1 : X0;
    for (int j = 0; j < hown; ++j) {
      const int i = i0 + j * W;
      const int gi = i + base;
      const float4 c = Fb[i];
      const bool moving = c.w > 0.f;
      float vx = Vs[gi], vy = Vs[HW + gi] + dt * q.gravity_y,
            vz = Vs[2 * HW + gi];
      vx *= damp; vy *= damp; vz *= damp;
      if (!moving) { vx = 0.f; vy = 0.f; vz = 0.f; }
      V_o[gi] = vx; V_o[HW + gi] = vy; V_o[2 * HW + gi] = vz;
      Pr[gi] = c.x;
      Pr[HW + gi] = c.y;
      Pr[2 * HW + gi] = c.z;
      pr[i - 2 * W] = make_float2(c.x, c.z);
      put(X0, up0, down0, i, shift, j < n_up, j >= j_down,
          make_float4(moving ? c.x + dt * vx : c.x,
                      moving ? c.y + dt * vy : c.y,
                      moving ? c.z + dt * vz : c.z, c.w));
    }
    cluster.sync();

    // springs + plane, Chebyshev-accelerated after the warm-up when cheb;
    // an iteration ends with the cluster arrive and the next one starts
    // with the wait (which also orders this CTA's own warps)
    float omega = 1.f;
    for (int it = 0; it < iterations; ++it) {
      if (it > 0) cluster_wait();
      const bool accel = cheb && it >= kChebDelay;
      if (cheb && it == kChebDelay) omega = 2.f / (2.f - q.rho2);
      else if (cheb && it > kChebDelay) omega = 4.f / (4.f - q.rho2 * omega);
      const float4* A = (it & 1) ? X1 : X0;
      float4* Bb = (it & 1) ? X0 : X1;
      const unsigned up = up0 + 16u * (unsigned)(Bb - smem);
      const unsigned down = down0 + 16u * (unsigned)(Bb - smem);
      if (hw > 0) {
        // the springs from rows y0 - 2 and y0 - 1 that end in this strip:
        // the neighbour-role terms of its first two rows
        float3 d;
        const float4 pa = A[i0 - 2 * W], pb = A[i0 - W];
        float4 p0 = A[i0], p1 = A[i0 + W];
        float4 r0 = A[i0 + 1];
        const float4 l0 = A[i0 - 1];
        const float* Qb = Q + 6 * (i0 - W);
        float ee = spring(pa, p0, rest2, d);
        float3 v3a = term(p0.w * Q[6 * (i0 - 2 * W) + 3], ee, d);
        ee = spring(pb, p0, rest1, d);
        float3 v1 = term(p0.w * Qb[1], ee, d);
        ee = spring(pb, p1, rest2, d);
        float3 v3b = term(p1.w * Qb[3], ee, d);
        ee = spring(pb, r0, restd, d);
        float3 in4 = from_below(term(r0.w * Qb[4], ee, d), 1);
        ee = spring(pb, l0, restd, d);
        float3 in5 = from_above(term(l0.w * Qb[5], ee, d), 1);
#pragma unroll
        for (int j = 0; j < kMaxStrip; ++j) {
          if (j >= hw) break;
          // a lane past its strip's end recomputes its last row: its
          // terms reach only lanes past their ends too.  (jj hides j from
          // the compiler, which would keep the rows' indices live across
          // the iteration loop and spill them)
          int jj = j;
          asm volatile("" : "+r"(jj));
          const int i = i0 + min(jj, h - 1) * W;
          const float2* Qi = reinterpret_cast<const float2*>(Q + 6 * i);
          const float2 q01 = Qi[0], q23 = Qi[1], q45 = Qi[2];
          const float4 p2 = A[i + 2 * W];   // (y + 2, x)
          const float4 r1 = A[i + W + 1];   // (y + 1, x + 1)
          const float4 q0 = A[i + 2];       // (y, x + 2)
          const float4 l1 = A[i + W - 1];   // (y + 1, x - 1)
          float3 acc = make_float3(0.f, 0.f, 0.f);
          // class 0: (y, x) -> (y, x + 1), from lane - 1
          ee = spring(p0, r0, rest1, d);
          plus(acc, term(p0.w * q01.x, ee, d));
          minus(acc, from_below(term(r0.w * q01.x, ee, d), 1));
          // class 1: (y, x) -> (y + 1, x), this thread's row above
          ee = spring(p0, p1, rest1, d);
          plus(acc, term(p0.w * q01.y, ee, d));
          minus(acc, v1);
          v1 = term(p1.w * q01.y, ee, d);
          // class 2: (y, x) -> (y, x + 2), from lane - 2
          ee = spring(p0, q0, rest2, d);
          plus(acc, term(p0.w * q23.x, ee, d));
          minus(acc, from_below(term(q0.w * q23.x, ee, d), 2));
          // class 3: (y, x) -> (y + 2, x), this thread's row 2 above
          ee = spring(p0, p2, rest2, d);
          plus(acc, term(p0.w * q23.y, ee, d));
          minus(acc, v3a);
          v3a = v3b;
          v3b = term(p2.w * q23.y, ee, d);
          // class 4: (y, x) -> (y + 1, x + 1), lane - 1's row above
          ee = spring(p0, r1, restd, d);
          plus(acc, term(p0.w * q45.x, ee, d));
          minus(acc, in4);
          in4 = from_below(term(r1.w * q45.x, ee, d), 1);
          // class 5: (y, x) -> (y + 1, x - 1), lane + 1's row above
          ee = spring(p0, l1, restd, d);
          plus(acc, term(p0.w * q45.y, ee, d));
          minus(acc, in5);
          in5 = from_above(term(l1.w * q45.y, ee, d), 1);

          const float ic = invc[i - 2 * W];
          float jx = p0.x + ic * acc.x;
          float jy = p0.y + ic * acc.y;
          float jz = p0.z + ic * acc.z;
          if (accel) {
            const float4 c = Bb[i];
            jx = omega * (jx - c.x) + c.x;
            jy = omega * (jy - c.y) + c.y;
            jz = omega * (jz - c.z) + c.z;
          }
          const float2 r = pr[i - 2 * W];
          ground(jx, jy, jz, r.x, r.y, p0.w > 0.f, q);
          if (j < hown)
            put(Bb, up, down, i, shift, j < n_up, j >= j_down,
                make_float4(jx, jy, jz, p0.w));
          p0 = p1;
          p1 = p2;
          r0 = r1;
        }
      }
      cluster_arrive();
    }
    if (iterations > 0) cluster_wait();
    F = iterations & 1;

    // velocity finalize (speed-up-only clamp), then the picker push; only
    // this thread's own slots are read and written until the next barrier
    const bool push = sub < n_sub - 1 || picker_last;
    float4* Pb = F ? X1 : X0;
    for (int j = 0; j < hown; ++j) {
      const int i = i0 + j * W;
      const int gi = i + base;
      const float4 c = Pb[i];
      const bool moving = c.w > 0.f;
      float px = c.x, py = c.y, pz = c.z;
      if (moving) {
        const float vx = V_o[gi], vy = V_o[HW + gi], vz = V_o[2 * HW + gi];
        const float nvx = (px - Pr[gi]) / dt;
        const float nvy = (py - Pr[HW + gi]) / dt;
        const float nvz = (pz - Pr[2 * HW + gi]) / dt;
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
        Pb[i] = make_float4(px, py, pz, c.w);
      }
    }
    // the next integrate reads and writes this thread's own slots and
    // writes neighbours' halos, which nobody reads before its barrier
  }

  const float4* Pb = F ? X1 : X0;
  for (int j = 0; j < hown; ++j) {
    const int i = i0 + j * W;
    const int gi = i + base;
    const float4 c = Pb[i];
    P_out[o3 + gi] = c.x;
    P_out[o3 + HW + gi] = c.y;
    P_out[o3 + 2 * HW + gi] = c.z;
  }
  // no CTA touches another's shared memory after the last cluster wait
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
                                 int picker_last, int band, int strip,
                                 int smem, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      substeps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (B == 0) return 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(B, smem, &attr, stream);
  e = cudaLaunchKernelEx(&cfg, substeps_kernel, (const float*)params,
                         (const float*)P, (const float*)V, (const float*)w,
                         (float*)P_out, (float*)V_out, (float*)prev_out, H, W,
                         n_sub, iterations, cheb, picker_last, band, strip);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* flingbot_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
