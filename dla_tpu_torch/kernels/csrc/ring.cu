// The ring collectives on a flat mesh of D members that share one card:
// ring_broadcast (each sub-ring's root block to every member of that sub-ring)
// and ring_all_gather (every member's block to every member of its sub-ring,
// stacked in member order), as one cooperative kernel.
//
// Replaces dla_tpu/kernels/collectives.py:ring_broadcast (_bcast_kernel) and
// :ring_all_gather (_ring_kernel), the Pallas kernels whose steps are remote
// DMAs between TPU chips. There every member forwards every step through two
// comm slots, because a conditional DMA in an SPMD ring deadlocks, and a
// member captures each slot into its output. On one card a member that has
// nothing to send simply does nothing, and a hop can write straight into the
// receiver's output: here each member is a pair of allocations (its block x,
// its output), and a hop is one member's thread blocks writing rows of their
// own output into the same rows of their right neighbour's output.
//
// What it computes. Member id d = r * group + c; the ring runs over c within
// each sub-ring r, and member d only ever writes its own output and that of
// right = r * group + (c + 1) % group. Every output row is written exactly
// once, by its own member or by its left neighbour.
//  - broadcast: let dist = (c - root) % group. The root (dist 0) reads each
//    unit of x once and writes it to its own output and to its right
//    neighbour's; a member with 1 <= dist <= group - 2 waits for each unit to
//    land in its output and copies it on into its right neighbour's; the
//    member at dist group - 1 launches no blocks (nothing goes back to the
//    root, nothing travels behind the front). A sub-ring of one member copies
//    its block to its output. Non-root blocks x are never read.
//  - all-gather: member c writes its block to its own output rows c * m and
//    to its right neighbour's rows c * m (unit 0); at unit t = 1 .. group - 2
//    it waits for block src = (c - t) % group to land in its own output and
//    copies those rows on into its right neighbour's.
//  The output thus holds the bits of the plain versions (ring_broadcast_plain
//  and ring_all_gather_plain of kernels/collectives.py): bytes are only moved.
//
// Design.
//  - One cooperative launch (cudaLaunchCooperativeKernel) of senders x B
//    blocks (the wrapper's ring_plan: senders = every member for the
//    all-gather, all but the last of each sub-ring for the broadcast; the
//    launcher checks the count it is given, the kernel takes it). Block b
//    of a sender copies bytes [b * stripe, (b + 1) * stripe) of every unit.
//    The spin-waits below need all blocks resident at once, which the launch
//    guarantees; when they cannot be (occupancy x SMs), the launcher returns
//    cudaErrorCooperativeLaunchTooLarge without launching.
//  - Pipeline unit. The all-gather's unit is one member block. The
//    broadcast's is a whole number of the caller's chunks: the fewest that
//    give each block 32 KB (ring_plan's MIN_SEGMENT). The caller's chunk
//    count was sized for a TPU link (C = 32 chunks of 256 KB for a 1024 x
//    1024 fp64 tile, 3 KB a block when cut over B = 88 blocks); here every
//    unit costs each block a __threadfence and a flag round trip, about a
//    microsecond, so a block needs tens of KB of copying between flags.
//    Measured on an H100 (PERF.md, the cuts tried): 32 KB gives 24 units of
//    5 MB for the planes' 15360 x 1024 fp64 panel and 2 units for the
//    1024 x 1024 tile, as fast as any cut tried for the panel and faster
//    than 16 KB for the tile.
//  - Flags: one monotonic 64-bit flag per (member, block), flag[d * B + b] =
//    the number of units landed in block b's stripe of d's output. Its only
//    writer is block b of d's left neighbour, its only reader block b of d:
//    blocks of one index b meet only each other, so no member signals before
//    all of a stripe has landed, without an atomic counter. A sender raises
//    its right neighbour's flag only for units that neighbour forwards (not
//    for the last member's).
//  - No deadlock, no credits: a block waits only on its own member's flag,
//    which its left neighbour raises, so every wait points left along the
//    chain. The root (broadcast) and unit 0 (all-gather) wait for nothing;
//    by induction on dist (on t), every block finishes, provided all are
//    resident. Outputs are never reused within a launch, so no sender waits
//    for its receiver. A wait that outlasts about ten seconds traps (a fault,
//    not a hang).
//  - Memory order. A sender's threads copy, each runs __threadfence(), the
//    block meets at __syncthreads(), and thread 0 stores the flag with
//    st.release.gpu. A receiver's thread 0 spins on ld.acquire.gpu with
//    __nanosleep, then the block meets at __syncthreads(); the rows it
//    forwards were written by another SM and are read with ld.global.cg
//    (L2, never a stale L1 line). Writes use st.global.cg.
//  - Flags are never cleared: the wrapper passes a base that grows by the
//    launch's unit count (its epoch), a flag is set to base + the units
//    landed, and a wait compares against base + the units that must have
//    landed (u + 1 for the broadcast's unit u, u for the all-gather's, whose
//    unit 0 is the member's own). A flag left by an earlier launch is at most
//    that launch's base + units, below every value this launch waits for.
//  - The member pointer table travels as one const __grid_constant__ struct:
//    two pointers per member, kMaxMembers = 128 (the wrapper raises above).
//  - The kernel moves bytes: 16-byte vector copies, four in flight a thread,
//    where source and destinations share their alignment modulo 16 (bytes up
//    to the first aligned address, then vectors, then the tail), bytes
//    otherwise; so one instantiation serves fp32, fp64 and bf16, and rows of
//    any width.
//
// Bound. Bytes: the root's block read once and D outputs written once,
// (1 + D) * V for the broadcast; D * V read and D * group * V written for the
// all-gather. The broadcast moves V read + 2V written at the root and 2V at
// each of the group - 2 middle hops: 7V for group 4, of which the forwarded
// reads (2V) come from L2 while the pipeline front stays tight.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxMembers = 128;
constexpr int kMaxDevices = 64;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte loads in flight a thread

struct RingArgs {
  unsigned long long* flags;  // flag[d * blocks + b]
  long long block_bytes;      // one member block
  long long unit_bytes;       // one pipeline unit
  long long stripe;           // bytes of a unit that one block copies, a multiple of 16
  unsigned long long base;    // this launch's epoch
  int group, root, per_ring, units, blocks, gather;  // per_ring: senders of one sub-ring
  const char* x[kMaxMembers];
  char* out[kMaxMembers];
};
static_assert(sizeof(RingArgs) <= 4096, "the member table must fit the 4 KB of kernel parameters");

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The whole block waits until *flag >= want.
__device__ __forceinline__ void wait_flag(const unsigned long long* flag, unsigned long long want) {
  if (threadIdx.x == 0 && ld_acquire(flag) < want) {
    const unsigned long long t0 = now_ns();
    while (ld_acquire(flag) < want) {
      __nanosleep(64);
      if (now_ns() - t0 > 10000000000ull) __trap();  // 10 s: a lost flag faults, never hangs
    }
  }
  if (threadIdx.x == 0) __threadfence();
  __syncthreads();
}

// Every thread's copies are visible on the card before thread 0 stores the flag.
__device__ __forceinline__ void publish(unsigned long long* flag, unsigned long long v) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) st_release(flag, v);
}

__device__ __forceinline__ void copy_byte(char* d0, char* d1, const char* s, long long i) {
  const unsigned char v = __ldcg(reinterpret_cast<const unsigned char*>(s) + i);
  __stcg(reinterpret_cast<unsigned char*>(d0) + i, v);
  if (d1) __stcg(reinterpret_cast<unsigned char*>(d1) + i, v);
}

// The block copies n bytes of src to d0 and, unless d1 is null, to d1 too.
__device__ __forceinline__ void copy_bytes(char* d0, char* d1, const char* src, long long n) {
  if (n <= 0) return;
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const bool shared_alignment = ((reinterpret_cast<uintptr_t>(d0) ^ s) & 15) == 0 &&
                                (d1 == nullptr || ((reinterpret_cast<uintptr_t>(d1) ^ s) & 15) == 0);
  const long long head = shared_alignment ? min(n, (long long)((16 - (s & 15)) & 15)) : n;
  for (long long i = threadIdx.x; i < head; i += kThreads) copy_byte(d0, d1, src, i);
  const long long nv = (n - head) >> 4;
  const uint4* sv = reinterpret_cast<const uint4*>(src + head);
  uint4* v0 = reinterpret_cast<uint4*>(d0 + head);
  uint4* v1 = d1 ? reinterpret_cast<uint4*>(d1 + head) : nullptr;
  long long i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < nv; i += kUnroll * kThreads) {
    uint4 v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) v[j] = __ldcg(sv + i + j * kThreads);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      __stcg(v0 + i + j * kThreads, v[j]);
      if (v1) __stcg(v1 + i + j * kThreads, v[j]);
    }
  }
  for (; i < nv; i += kThreads) {
    const uint4 v = __ldcg(sv + i);
    __stcg(v0 + i, v);
    if (v1) __stcg(v1 + i, v);
  }
  for (long long j = head + (nv << 4) + threadIdx.x; j < n; j += kThreads)
    copy_byte(d0, d1, src, j);
}

__global__ void __launch_bounds__(kThreads) ring_kernel(const __grid_constant__ RingArgs a) {
  const int g = a.group;
  const int w = blockIdx.x / a.blocks, b = blockIdx.x % a.blocks;
  const int r = w / a.per_ring, k = w % a.per_ring;  // k: the distance from the root, or c
  const int c = a.gather ? k : (a.root + k) % g;
  const int d = r * g + c, right = r * g + (c + 1) % g;
  const long long s0 = (long long)b * a.stripe;
  const long long len = (s0 < a.unit_bytes) ? min(a.stripe, a.unit_bytes - s0) : 0;
  char* out = a.out[d];
  char* next = (g > 1) ? a.out[right] : nullptr;
  unsigned long long* mine = a.flags + (long long)d * a.blocks + b;
  unsigned long long* theirs = a.flags + (long long)right * a.blocks + b;

  for (int u = 0; u < a.units; ++u) {
    // unit u's rows: the broadcast's u-th unit; the all-gather's block (c - u) % g
    const long long off =
        (a.gather ? (long long)(((c - u) % g + g) % g) * a.block_bytes : u * a.unit_bytes) + s0;
    if (a.gather ? u == 0 : k == 0) {  // the member's own block, read from x
      copy_bytes(out + off, next ? next + off : nullptr, a.x[d] + (a.gather ? s0 : off), len);
    } else {  // rows that the left neighbour wrote into this member's output
      wait_flag(mine, a.base + u + (a.gather ? 0 : 1));
      copy_bytes(next + off, nullptr, out + off, len);
    }
    // raise the right neighbour's flag for a unit that it forwards in turn: the
    // all-gather's next unit, or any unit where that neighbour is a sender too
    if (a.gather ? u + 1 < a.units : k + 1 < a.per_ring) publish(theirs, a.base + u + 1);
  }
}

}  // namespace

// C interface, loaded with ctypes; the wrapper's ring_plan gives senders,
// units, unit_bytes, stripe and blocks. gather selects the all-gather (root 0);
// xs and outs are host arrays of ndev device pointers (block, output); flags
// a device array of flag_capacity 64-bit words that earlier launches left,
// never cleared; base this launch's epoch.
// Returns cudaErrorCooperativeLaunchTooLarge when the launch's blocks cannot
// all be resident, cudaErrorInvalidValue for arguments out of range, else
// cudaGetLastError() after the launch: 0 means launched.
extern "C" int dla_ring_launch(int gather, int ndev, int group, int root, int senders, int units,
                               const void* const* xs, void* const* outs, void* flags,
                               long long flag_capacity, long long block_bytes,
                               long long unit_bytes, long long stripe, unsigned long long base,
                               int blocks, void* stream) {
  if (ndev < 1 || ndev > kMaxMembers || group < 1 || ndev % group || root < 0 || root >= group ||
      senders != ndev / group * ((gather || group == 1) ? group : group - 1) || units < 1 ||
      blocks < 1 || block_bytes < 1 || unit_bytes < 1 || stripe < 16 || stripe % 16 ||
      stripe * blocks < unit_bytes ||
      (gather ? (unit_bytes != block_bytes || units != (group > 1 ? group - 1 : 1))
              : (long long)units * unit_bytes != block_bytes))
    return (int)cudaErrorInvalidValue;
  // the card's resident blocks, asked once per device: the queries cost microseconds, which
  // the card would otherwise spend idle before a short launch
  static long long resident[kMaxDevices];  // 0: not asked yet; -1: no cooperative launch
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidValue;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0, coop = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    resident[dev] = coop ? (long long)per_sm * sms : -1;
  }
  if (resident[dev] < 0) return (int)cudaErrorNotSupported;
  if ((long long)senders * blocks > resident[dev]) return (int)cudaErrorCooperativeLaunchTooLarge;
  if ((long long)ndev * blocks > flag_capacity) return (int)cudaErrorInvalidValue;

  RingArgs a;
  a.flags = static_cast<unsigned long long*>(flags);
  a.block_bytes = block_bytes;
  a.unit_bytes = unit_bytes;
  a.stripe = stripe;
  a.base = base;
  a.group = group;
  a.root = root;
  a.per_ring = senders / (ndev / group);
  a.units = units;
  a.blocks = blocks;
  a.gather = gather;
  for (int i = 0; i < ndev; ++i) {
    a.x[i] = static_cast<const char*>(xs[i]);
    a.out[i] = static_cast<char*>(outs[i]);
  }
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(ring_kernel, dim3((unsigned)(senders * blocks)), dim3(kThreads),
                                  params, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: a refused launch leaves the context usable
    return (int)e;
  }
  return (int)cudaGetLastError();
}
