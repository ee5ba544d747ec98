// The contact group's Morton sort, the two passes around torch.sort: every
// slot's Morton key in one pass (contact_keys), and the sorted arrays of the
// contacts kernel in one pass through the sort's permutation
// (contact_gather).
//
// Replaces: no TPU kernel.  The JAX package leaves the sort to XLA
// (flingbot_tpu/engine/collisions.py `contact_group`, :336-364: the Morton
// keys, the packed ids and one multi-operand jax.lax.sort that carries the
// arrays).  Their plain versions are engine/kernels.py `contact_keys_plain`
// and `contact_gather_plain`; on a card those are ~75 launches a contact
// group (the keys' elementwise passes, the packed ids, seven gathers).
//
// contact_keys: thread (b, i) reads P[b, :, i] and active[b, i] and writes
// keys[b, i], the Morton code of the slot's cell
// clamp(floor(P / rd) + 512, 0, 1023) on each axis, or 2^30 for an
// inactive slot.  contact_gather: thread (b, j) reads s = order[b, j] and
// writes sorted slot j of each output plane: P[b, :, s], prev[b, :, s],
// the packed id of slot s and, in mesh mode, the rest position
// rest[b, :, s].
//
// What bounds them on this card: HBM bytes, against a few dozen integer
// operations a slot.  keys: 17 bytes a slot (12 of P, 1 of active, 4
// written).  gather: 65 bytes a slot in grid mode (8 of order, 24 of P and
// prev and 5 of w and active gathered, 28 written), 89 in mesh mode (12
// more gathered, 12 more written).  Reads and writes in slot order are
// coalesced.  The gathers go through order: the Morton order keeps
// neighbouring threads on few sectors, and the ~25 envs whose blocks run at
// once keep their arrays in L2.
//
// Bit-identity with the plain versions: P / rd is an IEEE division by the
// float32 rest distance, a kernel argument (no fast math: -prec-div), as
// the plain version divides by a device tensor; PyTorch divides by a host
// scalar through its reciprocal, which can move a particle across a cell.
// __float2int_rz is the conversion PyTorch's cast to int32 compiles to on
// the card (truncating; saturating out of range, NaN to 0); the + 512 wraps
// as an int32 tensor add does.  The Morton code and the packed ids are the
// plain versions' integer operations.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInt32Big = 1 << 30;  // engine/kernels.py INT32_BIG
constexpr int kImmobileBit = 20;    // PACK_IMMOBILE_BIT
constexpr int kInactiveBit = 21;    // PACK_INACTIVE_BIT

// _part1by2: the 10 low bits of x spread to every third bit
__device__ __forceinline__ int part1by2(int x) {
  x = x & 0x3FF;
  x = (x | (x << 16)) & 0x30000FF;
  x = (x | (x << 8)) & 0x300F00F;
  x = (x | (x << 4)) & 0x30C30C3;
  x = (x | (x << 2)) & 0x9249249;
  return x;
}

// torch.clamp(torch.floor(v / rd).to(torch.int32) + 512, 0, 1023)
__device__ __forceinline__ int cell_of(float v, float rd) {
  const int c = __float2int_rz(floorf(v / rd));
  const int s = (int)((unsigned)c + 512u);
  return min(max(s, 0), 1023);
}

__global__ void __launch_bounds__(kThreads) contact_keys_kernel(
    const float* __restrict__ P, const unsigned char* __restrict__ active,
    float rd, int* __restrict__ keys, int B, int N) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)B * N) return;
  const int b = (int)(t / N);
  const long long p = t + 2LL * b * N;  // P[b, 0, i]
  const int code = part1by2(cell_of(P[p], rd))
                   | (part1by2(cell_of(P[p + N], rd)) << 1)
                   | (part1by2(cell_of(P[p + 2LL * N], rd)) << 2);
  keys[t] = active[t] ? code : kInt32Big;
}

// out holds 6 planes of (B, N) (xs, ys, zs, pxs, pys, pzs), 9 in mesh mode
// (then rx, ry, rz)
template <bool kMesh>
__global__ void __launch_bounds__(kThreads) contact_gather_kernel(
    const long long* __restrict__ order, const float* __restrict__ P,
    const float* __restrict__ prev, const float* __restrict__ w,
    const unsigned char* __restrict__ active, const float* __restrict__ rest,
    int lattice_w, float* __restrict__ out, int* __restrict__ packed, int B,
    int N) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long plane = (long long)B * N;
  if (t >= plane) return;
  const int b = (int)(t / N);
  const int s = (int)order[t];
  const long long slot = (long long)b * N + s;  // w, active
  const long long p = slot + 2LL * b * N;       // P, prev, rest at [b, 0, s]
  out[t] = P[p];
  out[t + plane] = P[p + N];
  out[t + 2 * plane] = P[p + 2LL * N];
  out[t + 3 * plane] = prev[p];
  out[t + 4 * plane] = prev[p + N];
  out[t + 5 * plane] = prev[p + 2LL * N];
  const int flags = (w[slot] <= 0.f ? 1 << kImmobileBit : 0)
                    | (active[slot] ? 0 : 1 << kInactiveBit);
  if (kMesh) {  // pack_slot_ids
    packed[t] = s | flags;
    out[t + 6 * plane] = rest[p];
    out[t + 7 * plane] = rest[p + N];
    out[t + 8 * plane] = rest[p + 2LL * N];
  } else {  // pack_lattice_ids
    packed[t] = (s % lattice_w) | ((s / lattice_w) << 8) | flags;
  }
}

int blocks_of(long long n, unsigned* blocks) {
  const long long b = (n + kThreads - 1) / kThreads;
  if (b > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  *blocks = (unsigned)b;
  return 0;
}

}  // namespace

extern "C" int flingbot_contact_keys(const void* P, const void* active,
                                     float rd, void* keys, int B, int N,
                                     void* stream) {
  unsigned blocks = 0;
  if ((long long)B * N == 0) return 0;
  if (int err = blocks_of((long long)B * N, &blocks)) return err;
  contact_keys_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)P, (const unsigned char*)active, rd, (int*)keys, B, N);
  return (int)cudaGetLastError();
}

// rest == nullptr: grid mode (lattice ids of a lattice_w-wide lattice);
// otherwise mesh mode (slot indices, and the rest positions gathered)
extern "C" int flingbot_contact_gather(
    const void* order, const void* P, const void* prev, const void* w,
    const void* active, const void* rest, int lattice_w, void* out,
    void* packed, int B, int N, void* stream) {
  unsigned blocks = 0;
  if ((long long)B * N == 0) return 0;
  if (int err = blocks_of((long long)B * N, &blocks)) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  if (rest != nullptr) {
    contact_gather_kernel<true><<<blocks, kThreads, 0, st>>>(
        (const long long*)order, (const float*)P, (const float*)prev,
        (const float*)w, (const unsigned char*)active, (const float*)rest,
        lattice_w, (float*)out, (int*)packed, B, N);
  } else {
    contact_gather_kernel<false><<<blocks, kThreads, 0, st>>>(
        (const long long*)order, (const float*)P, (const float*)prev,
        (const float*)w, (const unsigned char*)active, nullptr, lattice_w,
        (float*)out, (int*)packed, B, N);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* flingbot_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
