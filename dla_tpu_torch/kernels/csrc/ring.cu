// The ring collectives on a flat mesh of D members, on one card or spread over
// the cards of one host: ring_broadcast (each sub-ring's root block to every
// member of that sub-ring) and ring_all_gather (every member's block to every
// member of its sub-ring, stacked in member order), as one cooperative kernel.
//
// Replaces dla_tpu/kernels/collectives.py:ring_broadcast (_bcast_kernel) and
// :ring_all_gather (_ring_kernel), the Pallas kernels whose steps are remote
// DMAs between TPU chips. There every member forwards every step through two
// comm slots, because a conditional DMA in an SPMD ring deadlocks, and a
// member captures each slot into its output. Here a member that has nothing
// to send simply does nothing, and a hop writes straight into the receiver's
// output: each member is a pair of allocations (its block x, its output) on
// its own card, and a hop is one member's thread blocks writing rows of their
// own output into the same rows of their right neighbour's output, over
// NVLink through a peer pointer where that neighbour lies on another card.
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
//  - One cooperative launch (cudaLaunchCooperativeKernel) per card that holds
//    senders, of that card's senders x B blocks (the wrapper's ring_plan:
//    senders = every member for the all-gather, all but the last of each
//    sub-ring for the broadcast; card_launches: which of them each card
//    runs, as a table of sender indices, which the launcher checks). Block b
//    of a sender copies bytes [b * stripe, (b + 1) * stripe) of every unit.
//    The spin-waits below need all blocks of every card's launch resident at
//    once: the cooperative launch guarantees it within a card (when they
//    cannot be, the launcher returns cudaErrorCooperativeLaunchTooLarge
//    without launching), and across cards the wrapper enqueues every card's
//    launch before anything waits on one.
//  - Pipeline unit. The all-gather's unit is one member block. The
//    broadcast's is a whole number of the caller's chunks: the fewest that
//    give each block ring_plan's min_segment bytes. The caller's chunk count
//    was sized for a TPU link (C = 32 chunks of 256 KB for a 1024 x 1024 fp64
//    tile); here every unit costs each block a fence and a flag round trip,
//    about a microsecond on one card, more across NVLink, so a block needs
//    tens of KB of copying between flags (PERF.md, the cuts tried).
//  - Flags: one monotonic 64-bit flag per (member, block), on the card of the
//    member that waits on it: flag[d][b] = the number of units landed in
//    block b's stripe of d's output. Its only writer is block b of d's left
//    neighbour, its only reader block b of d: blocks of one index b meet only
//    each other, so no member signals before all of a stripe has landed,
//    without an atomic counter. A sender raises its right neighbour's flag
//    only for units that neighbour forwards (not for the last member's).
//  - No deadlock, no credits: a block waits only on its own member's flag,
//    which its left neighbour raises, so every wait points left along the
//    chain. The root (broadcast) and unit 0 (all-gather) wait for nothing;
//    by induction on dist (on t), every block finishes, provided all are
//    resident. Outputs are never reused within a launch, so no sender waits
//    for its receiver. A wait that outlasts about ten seconds traps (a fault,
//    not a hang).
//  - Memory order. A sender's threads copy, each fences, the block meets at
//    __syncthreads(), and thread 0 stores the flag with a release; a
//    receiver's thread 0 spins on an acquire load with __nanosleep, fences,
//    and the block meets at __syncthreads(); the rows it forwards were
//    written by another SM or card and are read with ld.global.cg (L2,
//    never a stale L1 line). Writes use st.global.cg. On one card the scope
//    is gpu (__threadfence, st.release.gpu, ld.acquire.gpu); a launch whose
//    ring spans cards uses sys scope (__threadfence_system, st.release.sys,
//    ld.acquire.sys), since a peer's stores reach this card over NVLink: two
//    instantiations of the kernel, chosen at launch.
//  - Flags are never cleared: the wrapper passes a base, one epoch for the
//    whole process that grows by each launch's unit count (its flags live on
//    several cards), a flag is set to base + the units landed, and a wait
//    compares against base + the units that must have landed (u + 1 for the
//    broadcast's unit u, u for the all-gather's, whose unit 0 is the
//    member's own). A flag left by an earlier launch is at most that
//    launch's base + units, below every value this launch waits for; and
//    the wrapper orders each card's launch after the earlier work of every
//    card that it writes into, so no late write of an earlier launch lands
//    in a flag or an output of this one.
//  - The member table travels as one const __grid_constant__ struct: three
//    pointers per member (block, output, flag row) and the launch's sender
//    table, kMaxMembers = 128 (the wrapper raises above).
//  - The kernel moves bytes: 16-byte vector copies, four in flight a thread,
//    where source and destinations share their alignment modulo 16 (bytes up
//    to the first aligned address, then vectors, then the tail), bytes
//    otherwise; so one instantiation serves fp32, fp64 and bf16, and rows of
//    any width.
//
// Bound. Bytes: the root's block read once and D outputs written once,
// (1 + D) * V for the broadcast; D * V read and D * group * V written for the
// all-gather. Across cards, each hop carries V (broadcast) or (group - 1) * V
// (all-gather) over one NVLink direction of its sender's card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxMembers = 128;
constexpr int kMaxDevices = 64;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte loads in flight a thread

struct RingArgs {
  unsigned long long* flag[kMaxMembers];  // member d's flag row (blocks words), on d's card
  const char* x[kMaxMembers];
  char* out[kMaxMembers];
  long long block_bytes;      // one member block
  long long unit_bytes;       // one pipeline unit
  long long stripe;           // bytes of a unit that one block copies, a multiple of 16
  unsigned long long base;    // this launch's epoch
  int group, root, per_ring, units, blocks, gather;  // per_ring: senders of one sub-ring
  short sender[kMaxMembers];  // the senders (r * per_ring + k) of this card's launch
};
static_assert(sizeof(RingArgs) <= 4096, "the member table must fit the 4 KB of kernel parameters");

// kSys: the ring spans cards (sys-scope fences and flags); else one card (gpu scope).
template <bool kSys>
__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  if constexpr (kSys)
    asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

template <bool kSys>
__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  if constexpr (kSys)
    asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
  else
    asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

template <bool kSys>
__device__ __forceinline__ void fence() {
  if constexpr (kSys)
    __threadfence_system();
  else
    __threadfence();
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The whole block waits until *flag >= want.
template <bool kSys>
__device__ __forceinline__ void wait_flag(const unsigned long long* flag, unsigned long long want) {
  if (threadIdx.x == 0 && ld_acquire<kSys>(flag) < want) {
    const unsigned long long t0 = now_ns();
    while (ld_acquire<kSys>(flag) < want) {
      __nanosleep(64);
      if (now_ns() - t0 > 10000000000ull) __trap();  // 10 s: a lost flag faults, never hangs
    }
  }
  if (threadIdx.x == 0) fence<kSys>();
  __syncthreads();
}

// Every thread's copies are visible to the reader (on this card, or on every
// card for kSys) before thread 0 stores the flag.
template <bool kSys>
__device__ __forceinline__ void publish(unsigned long long* flag, unsigned long long v) {
  fence<kSys>();
  __syncthreads();
  if (threadIdx.x == 0) st_release<kSys>(flag, v);
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

template <bool kSys>
__global__ void __launch_bounds__(kThreads) ring_kernel(const __grid_constant__ RingArgs a) {
  const int g = a.group;
  const int w = a.sender[blockIdx.x / a.blocks], b = blockIdx.x % a.blocks;
  const int r = w / a.per_ring, k = w % a.per_ring;  // k: the distance from the root, or c
  const int c = a.gather ? k : (a.root + k) % g;
  const int d = r * g + c, right = r * g + (c + 1) % g;
  const long long s0 = (long long)b * a.stripe;
  const long long len = (s0 < a.unit_bytes) ? min(a.stripe, a.unit_bytes - s0) : 0;
  char* out = a.out[d];
  char* next = (g > 1) ? a.out[right] : nullptr;
  const unsigned long long* mine = a.flag[d] + b;
  unsigned long long* theirs = a.flag[right] + b;

  for (int u = 0; u < a.units; ++u) {
    // unit u's rows: the broadcast's u-th unit; the all-gather's block (c - u) % g
    const long long off =
        (a.gather ? (long long)(((c - u) % g + g) % g) * a.block_bytes : u * a.unit_bytes) + s0;
    if (a.gather ? u == 0 : k == 0) {  // the member's own block, read from x
      copy_bytes(out + off, next ? next + off : nullptr, a.x[d] + (a.gather ? s0 : off), len);
    } else {  // rows that the left neighbour wrote into this member's output
      wait_flag<kSys>(mine, a.base + u + (a.gather ? 0 : 1));
      copy_bytes(next + off, nullptr, out + off, len);
    }
    // raise the right neighbour's flag for a unit that it forwards in turn: the
    // all-gather's next unit, or any unit where that neighbour is a sender too
    if (a.gather ? u + 1 < a.units : k + 1 < a.per_ring) publish<kSys>(theirs, a.base + u + 1);
  }
}

// The current card's resident ring blocks (the fewer of the two instantiations),
// asked once per device: the queries cost microseconds, which the card would
// otherwise spend idle before a short launch. -1: the card takes no cooperative
// launch.
cudaError_t resident_blocks(long long* out) {
  static long long resident[kMaxDevices];  // 0: not asked yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidValue;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0, per_sm_sys = 0, coop = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_kernel<false>, kThreads, 0);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm_sys, ring_kernel<true>, kThreads,
                                                        0);
    if (e != cudaSuccess) return e;
    resident[dev] = coop ? (long long)(per_sm < per_sm_sys ? per_sm : per_sm_sys) * sms : -1;
  }
  *out = resident[dev];
  return cudaSuccess;
}

}  // namespace

// The ring blocks that the current card holds at once (0 where it takes no
// cooperative launch or cannot say): a spread ring checks every card's part
// before it launches any, since a part launched alone would spin.
extern "C" long long dla_ring_resident() {
  long long resident = 0;
  return (resident_blocks(&resident) == cudaSuccess && resident > 0) ? resident : 0;
}

// C interface, loaded with ctypes. One call launches one card's part of a
// ring collective on the current device (the card of its senders) and the
// given stream; the wrapper's ring_plan gives per_ring, units, unit_bytes,
// stripe and blocks, and card_launches the senders of this card (nsend
// indices r * per_ring + k into the whole ring's senders). gather selects the
// all-gather (root 0); xs, outs and flags are host arrays of ndev device
// pointers (block, output, the member's row of `blocks` flags on its own
// card), peers' pointers included; base this launch's epoch; sys 1 where the
// ring spans cards.
// Returns cudaErrorCooperativeLaunchTooLarge when the launch's blocks cannot
// all be resident, cudaErrorInvalidValue for arguments out of range, else
// cudaGetLastError() after the launch: 0 means launched.
extern "C" int dla_ring_launch(int gather, int ndev, int group, int root, int per_ring, int units,
                               const void* const* xs, void* const* outs, void* const* flags,
                               long long block_bytes, long long unit_bytes, long long stripe,
                               unsigned long long base, int blocks, int nsend,
                               const int* senders, int sys, void* stream) {
  if (ndev < 1 || ndev > kMaxMembers || group < 1 || ndev % group || root < 0 || root >= group ||
      per_ring != ((gather || group == 1) ? group : group - 1) || units < 1 || blocks < 1 ||
      block_bytes < 1 || unit_bytes < 1 || stripe < 16 || stripe % 16 ||
      stripe * blocks < unit_bytes || nsend < 1 || nsend > ndev ||
      (gather ? (unit_bytes != block_bytes || units != (group > 1 ? group - 1 : 1))
              : (long long)units * unit_bytes != block_bytes))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nsend; ++i)
    if (senders[i] < 0 || senders[i] >= ndev / group * per_ring) return (int)cudaErrorInvalidValue;
  long long resident = 0;
  const cudaError_t e0 = resident_blocks(&resident);
  if (e0 != cudaSuccess) return (int)e0;
  if (resident < 0) return (int)cudaErrorNotSupported;
  if ((long long)nsend * blocks > resident) return (int)cudaErrorCooperativeLaunchTooLarge;

  RingArgs a;
  a.block_bytes = block_bytes;
  a.unit_bytes = unit_bytes;
  a.stripe = stripe;
  a.base = base;
  a.group = group;
  a.root = root;
  a.per_ring = per_ring;
  a.units = units;
  a.blocks = blocks;
  a.gather = gather;
  for (int i = 0; i < ndev; ++i) {
    a.flag[i] = static_cast<unsigned long long*>(flags[i]);
    a.x[i] = static_cast<const char*>(xs[i]);
    a.out[i] = static_cast<char*>(outs[i]);
  }
  for (int i = 0; i < nsend; ++i) a.sender[i] = (short)senders[i];
  void* params[] = {&a};
  const cudaError_t e =
      cudaLaunchCooperativeKernel(sys ? ring_kernel<true> : ring_kernel<false>,
                                  dim3((unsigned)(nsend * blocks)), dim3(kThreads), params, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: a refused launch leaves the context usable
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// Lets card `from` read and write card `to`'s memory (peer pointers over
// NVLink), once per pair and process: cudaErrorPeerAccessUnsupported where
// the two cannot reach each other; a pair already enabled (by an earlier call
// or by PyTorch's own peer copies) is no error.
extern "C" int dla_ring_enable_peer(int from, int to) {
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, from, to);
  if (e != cudaSuccess) return (int)e;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int prev = 0;
  e = cudaGetDevice(&prev);
  if (e == cudaSuccess) e = cudaSetDevice(from);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceEnablePeerAccess(to, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    e = cudaSuccess;
  }
  const cudaError_t back = cudaSetDevice(prev);
  return (int)(e != cudaSuccess ? e : back);
}
