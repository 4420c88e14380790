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
//  - broadcast: let dist = (c - root) % group. The root (dist 0) reads its
//    block x once and writes it to its own output and to its right
//    neighbour's; a member with 1 <= dist <= group - 2 waits for each segment
//    to land in its output and copies it on into its right neighbour's; the
//    member at dist group - 1 sends nothing (nothing goes back to the root,
//    nothing travels behind the front). A sub-ring of one member copies its
//    block to its output. Non-root blocks x are never read.
//  - all-gather: member c writes its block to its own output rows c * m and
//    to its right neighbour's rows c * m (unit 0); at unit t = 1 .. group - 2
//    it waits for block src = (c - t) % group to land in its own output and
//    copies those rows on into its right neighbour's.
//  The output thus holds the bits of the plain versions (ring_broadcast_plain
//  and ring_all_gather_plain of kernels/collectives.py): bytes are only moved.
//
// Design.
//  - One cooperative launch (cudaLaunchCooperativeKernel) per card that holds
//    members taking part, `blocks` thread blocks per member, all enqueued by
//    one call of dla_ring_launch (the wrapper's card_launches lists each
//    card's members; the launcher checks the list). A member takes part if it
//    sends (every member of the all-gather; all but the last of each sub-ring
//    of the broadcast) or, across cards, if it receives from a member on
//    another card (then it may only wait: the last member of a broadcast).
//    The spin-waits below need all blocks of every card's launch resident at
//    once: the cooperative launch guarantees it within a card (when they
//    cannot be, the launcher returns cudaErrorCooperativeLaunchTooLarge
//    before it launches any card's part), and across cards every part is
//    enqueued before anything waits on one, in ring order from the root (the
//    order in which the bytes reach the cards).
//  - Per-block segment pipeline. Block b of a member owns one contiguous
//    slice of the member block, bytes [b * stripe, (b + 1) * stripe), and of
//    every block it forwards (the all-gather's units). It walks its slice in
//    segments of `segment` bytes and raises its right neighbour's flag after
//    each; a forwarder waits on its own flag per segment. The pipeline's fill
//    is thus (hops - 1) segments of one block, whatever the block count, and
//    the segment (the wrapper's ring_plan: the slice cut into pieces of at
//    least min_segment bytes) trades that fill against a flag round trip per
//    segment (PERF.md, the cuts measured).
//  - Flags: one monotonic 64-bit word per (member, block), on the card of the
//    member that waits on it: flag[d][b] = the number of segments landed in
//    block b's slices of d's output. Its only writer is block b of d's left
//    neighbour, its only reader block b of d: blocks of one index b meet only
//    each other, so no member signals before all of a segment has landed,
//    without an atomic counter. A sender raises its right neighbour's flag
//    for the segments that neighbour forwards, and across cards for every
//    segment (that neighbour then waits for its last one).
//  - Ordering across cards on the device, with no host events. A member that
//    receives from another card raises a ready word on its left neighbour's
//    card as soon as its card's stream has reached the launch (its block 0
//    does, before any wait); that neighbour's blocks wait for it before their
//    first write into its output, so nothing lands in memory that the
//    receiver's caching allocator may still hand to earlier work on its
//    stream. The receiver's blocks end only when every segment has landed in
//    their slices, so its stream runs past the collective only after all its
//    bytes have: a caller's next kernel on that card reads the output as it
//    would after any other kernel.
//  - No deadlock, no credits: a block waits on data only through its own
//    member's flag, which its left neighbour raises, so every data wait
//    points left along the chain. The root (broadcast) and unit 0
//    (all-gather) wait for no data; by induction on dist (on t), every block
//    finishes, provided all are resident. The ready wait points right, but
//    its word is raised at the very start of the receiver's launch, before
//    the receiver waits on anything, so no cycle passes through it. Outputs
//    are never reused within a launch, so no sender waits for its receiver
//    beyond that. A wait that outlasts about ten seconds traps (a fault, not
//    a hang).
//  - Memory order. A block's copying threads copy a segment and meet at a
//    barrier, then thread 0 alone issues fence.acq_rel and st.release of the
//    flag (gpu scope on one card, sys scope across cards, since a peer's
//    stores reach this card over NVLink: two instantiations, chosen at
//    launch). That is enough: the barrier orders every copying thread's
//    stores before thread 0's fence in causality order (bar.sync, named or
//    not, synchronizes the threads that meet), and a release is cumulative,
//    so every store that precedes it in causality order becomes visible at
//    the fence's scope before the flag does; the same pattern as cooperative
//    groups' grid sync and NCCL's simple protocol. A receiver's waiting
//    thread spins on ld.acquire with __nanosleep and the copying threads meet
//    it at a barrier: the acquire orders their later loads after the flag.
//    The rows it forwards were written by another SM or card and are read
//    with ld.global.cg (L2, never a stale L1 line); writes use st.global.cg.
//  - Roles across cards. There a sys-scope fence waits a few microseconds
//    for the peer's acknowledgements, so the block splits: thread 32 waits
//    for each segment's flag (and once for the ready word), warps 1-7 copy
//    the segment (named barrier 2 between them), all eight warps meet at
//    named barrier 1 when it is copied, and thread 0 then fences and raises
//    the flag while warps 1-7 already wait for and copy the next segment; so
//    the fence overlaps the copying instead of stalling the block at every
//    segment (PERF.md: the stage probe, bench/ring_stages_probe.py). On one
//    card the gpu-scope fence is short, and every warp copies: thread 0
//    waits, __syncthreads(), all copy, __syncthreads(), thread 0 raises.
//  - Flags are never cleared: the wrapper passes a base, one epoch for the
//    whole process that grows by each launch's steps (units x segments a
//    block at most), a flag is set to base + the segments landed, a ready
//    word to base + 1, and a wait compares against base + the segments that
//    must have landed. A value left by an earlier launch is below every value
//    this launch waits for. No write of an earlier launch lands late: on one
//    card the launches run in stream order, and across cards every flag
//    write into a card is awaited at its final value by that card's part of
//    the same launch (a receiver waits for all its segments; a sender's
//    block 0 for its ready word), while a later launch writes a card's data
//    flags only after that card's ready, i.e. after its earlier parts ended.
//    A ready word is keyed by the card that raises it and the receiving
//    member (kDataWords + card * kMaxMembers + member on the neighbour's
//    card), so only one card ever writes it, its launches in stream order.
//  - One card. The one-card path is this same schedule with the gpu-scope
//    instantiation, every warp copying, and no ready words or final waits
//    (one launch holds every member, so the kernel's end is the
//    collective's); with the wrapper's one-card cut its segments are the
//    earlier units for the factor tile and smaller for the panels, and its
//    card time at phase 29's shapes is within 5% of the earlier kernel's
//    (PERF.md, the one-card A/B).
//  - The member table travels as one const __grid_constant__ struct: each
//    member's block, output and card, each card's flag buffer, and the
//    members of this card's launch, kMaxMembers = 128 (the wrapper raises
//    above).
//  - The SM copy moves bytes: 16-byte vector copies, four in flight a thread,
//    where source and destinations share their alignment modulo 16 (bytes up
//    to the first aligned address, then vectors, then the tail), bytes
//    otherwise; so one instantiation serves fp32, fp64 and bf16, and rows of
//    any width. A bulk copy across cards (thread 0 of a block moving each
//    segment with cp.async.bulk through shared memory, from fewer SMs) was
//    measured against it and lost at both the tile and the panel (PERF.md,
//    the copies measured), so the SM copy is the only one.
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
// a card's flag buffer: member d's row of `blocks` data flags at d * blocks,
// then the ready words (the design above)
constexpr long long kDataWords = 1 << 16;

struct RingArgs {
  const char* x[kMaxMembers];
  char* out[kMaxMembers];
  unsigned long long* flags[kMaxDevices];  // each card's flag buffer, by device index
  long long block_bytes;                   // one member block
  long long stripe;   // bytes of a member block that one thread block owns, a multiple of 16
  long long segment;  // bytes a thread block copies between two flags, a multiple of 16
  unsigned long long base;  // this launch's epoch
  int group, root, blocks, gather;
  signed char card[kMaxMembers];      // member d's device index
  unsigned char member[kMaxMembers];  // the members of this card's launch
};
static_assert(sizeof(RingArgs) <= 4096, "the member table must fit the 4 KB of kernel parameters");

// Member d's place in the collective: its neighbours, its distance from the
// root (broadcast) or its place c (all-gather), and whether it sends into its
// right neighbour (or its own output) and receives from its left.
struct Roles {
  int left, right, dist;
  bool sends, receives;
};

__host__ __device__ __forceinline__ Roles roles(int gather, int group, int root, int d) {
  const int g = group, r = d / g, c = d % g;
  Roles o;
  o.right = r * g + (c + 1) % g;
  o.left = r * g + (c + g - 1) % g;
  o.dist = gather ? c : (c - root + g) % g;
  o.sends = gather || g == 1 || o.dist != g - 1;
  o.receives = g > 1 && (gather || o.dist != 0);
  return o;
}

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
__device__ __forceinline__ void fence_acq_rel() {
  if constexpr (kSys)
    asm volatile("fence.acq_rel.sys;" ::: "memory");
  else
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The calling thread spins until *flag >= want; a wait past about ten
// seconds traps (a lost flag faults, never hangs).
template <bool kSys>
__device__ __forceinline__ void spin(const unsigned long long* flag, unsigned long long want) {
  if (ld_acquire<kSys>(flag) < want) {
    const unsigned long long t0 = now_ns();
    while (ld_acquire<kSys>(flag) < want) {
      __nanosleep(64);
      if (now_ns() - t0 > 10000000000ull) __trap();
    }
  }
}

// The whole block waits until *flag >= want.
template <bool kSys>
__device__ __forceinline__ void wait_flag(const unsigned long long* flag, unsigned long long want) {
  if (threadIdx.x == 0) spin<kSys>(flag, want);
  __syncthreads();
}

// Every thread's copies reach the reader (on this card, or on every card for
// kSys) before the flag does: the barrier, then one thread's fence and
// release (the header says why that is enough).
template <bool kSys>
__device__ __forceinline__ void publish(unsigned long long* flag, unsigned long long v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    fence_acq_rel<kSys>();
    st_release<kSys>(flag, v);
  }
}

__device__ __forceinline__ void copy_byte(char* d0, char* d1, const char* s, long long i) {
  const unsigned char v = __ldcg(reinterpret_cast<const unsigned char*>(s) + i);
  __stcg(reinterpret_cast<unsigned char*>(d0) + i, v);
  if (d1) __stcg(reinterpret_cast<unsigned char*>(d1) + i, v);
}

// kN threads of the block (t: this thread's place among them) copy n bytes of
// src to d0 and, unless d1 is null, to d1 too.
template <int kN>
__device__ __forceinline__ void copy_bytes(char* d0, char* d1, const char* src, long long n,
                                           int t) {
  if (n <= 0) return;
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const bool shared_alignment = ((reinterpret_cast<uintptr_t>(d0) ^ s) & 15) == 0 &&
                                (d1 == nullptr || ((reinterpret_cast<uintptr_t>(d1) ^ s) & 15) == 0);
  const long long head = shared_alignment ? min(n, (long long)((16 - (s & 15)) & 15)) : n;
  for (long long i = t; i < head; i += kN) copy_byte(d0, d1, src, i);
  const long long nv = (n - head) >> 4;
  const uint4* sv = reinterpret_cast<const uint4*>(src + head);
  uint4* v0 = reinterpret_cast<uint4*>(d0 + head);
  uint4* v1 = d1 ? reinterpret_cast<uint4*>(d1 + head) : nullptr;
  long long i = t;
  for (; i + (kUnroll - 1) * kN < nv; i += kUnroll * kN) {
    uint4 v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) v[j] = __ldcg(sv + i + j * kN);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      __stcg(v0 + i + j * kN, v[j]);
      if (v1) __stcg(v1 + i + j * kN, v[j]);
    }
  }
  for (; i < nv; i += kN) {
    const uint4 v = __ldcg(sv + i);
    __stcg(v0 + i, v);
    if (v1) __stcg(v1 + i, v);
  }
  for (long long j = head + (nv << 4) + t; j < n; j += kN) copy_byte(d0, d1, src, j);
}

// Named barrier `id` of `count` threads (0 is __syncthreads'); like it, it
// orders the memory accesses of the threads that meet.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

template <bool kSys>
__global__ void __launch_bounds__(kThreads) ring_kernel(const __grid_constant__ RingArgs a) {
  const int g = a.group;
  const int d = a.member[blockIdx.x / a.blocks], b = blockIdx.x % a.blocks;
  const Roles ro = roles(a.gather, g, a.root, d);
  const int me = a.card[d];
  const bool remote_out = kSys && ro.sends && g > 1 && a.card[ro.right] != me;
  const bool remote_in = kSys && ro.receives && a.card[ro.left] != me;
  const long long s0 = (long long)b * a.stripe;
  const long long len = s0 < a.block_bytes ? min(a.stripe, a.block_bytes - s0) : 0;
  const long long nseg = (len + a.segment - 1) / a.segment;
  const int units = a.gather ? max(g - 1, 1) : 1;
  const unsigned long long* mine = a.flags[me] + (long long)d * a.blocks + b;
  if (remote_in && b == 0 && threadIdx.x == 0)  // this card's stream has reached the launch
    st_release<true>(a.flags[a.card[ro.left]] + kDataWords + me * kMaxMembers + d, a.base + 1);
  if (ro.sends) {
    char* out = a.out[d];
    char* next = g > 1 ? a.out[ro.right] : nullptr;
    unsigned long long* theirs =
        g > 1 ? a.flags[a.card[ro.right]] + (long long)ro.right * a.blocks + b : nullptr;
    const unsigned long long* ready =  // the right neighbour's ready word, raised from its card
        remote_out ? a.flags[me] + kDataWords + a.card[ro.right] * kMaxMembers + ro.right : nullptr;
    for (int u = 0; u < units; ++u) {
      // unit u's rows: the broadcast's block; the all-gather's block (c - u) % g
      const long long off =
          (a.gather ? (long long)((ro.dist - u + g) % g) * a.block_bytes : 0) + s0;
      const bool own = a.gather ? u == 0 : ro.dist == 0;  // the member's own block, read from x
      // raise the right neighbour's flag where it forwards the unit in turn
      // (the all-gather's next unit, or any unit where it sends too), and
      // across cards always: it then waits for its last segment
      const bool raise = remote_out || (a.gather ? u + 1 < units : ro.dist + 1 < g - 1);
      for (long long j = 0; j < nseg; ++j) {
        const long long lo = j * a.segment, n = min(a.segment, len - lo);
        const unsigned long long want = a.base + (a.gather ? (u - 1) * nseg : 0) + j + 1;
        char* d0 = own ? out + off + lo : next + off + lo;
        char* d1 = own && next ? next + off + lo : nullptr;
        const char* src = own ? a.x[d] + s0 + lo : out + off + lo;
        if constexpr (kSys) {
          // across cards thread 0 raises the flags while warps 1-7 go on: thread
          // 32 waits for the segment (and, once, for the ready word: no write
          // into a card whose stream may still run earlier work), warps 1-7
          // copy it and meet warp 0 at barrier 1, then thread 0 fences and
          // raises the flag while they wait for and copy the next
          if (threadIdx.x >= 32) {
            if (threadIdx.x == 32) {
              if (!own) spin<kSys>(mine, want);
              if (ready) spin<true>(ready, a.base + 1);
            }
            bar_sync(2, kThreads - 32);
            copy_bytes<kThreads - 32>(d0, d1, src, n, threadIdx.x - 32);
          }
          ready = nullptr;
          bar_sync(1, kThreads);
          if (raise && threadIdx.x == 0) {
            fence_acq_rel<kSys>();
            st_release<kSys>(theirs, a.base + u * nseg + j + 1);
          }
        } else {
          if (!own) wait_flag<kSys>(mine, want);
          if (ready) {
            wait_flag<true>(ready, a.base + 1);
            ready = nullptr;
          }
          copy_bytes<kThreads>(d0, d1, src, n, threadIdx.x);
          if (raise) publish<kSys>(theirs, a.base + u * nseg + j + 1);
        }
      }
    }
  }
  if (remote_in) wait_flag<true>(mine, a.base + units * nseg);  // every segment has landed
}

// Ring blocks one card holds at once, per instantiation (sys: across cards),
// asked once per device: the queries cost microseconds, which the card would
// otherwise spend idle before a short launch. -1: the card takes no
// cooperative launch.
cudaError_t resident_blocks(int dev, int sys, long long* out) {
  static long long resident[kMaxDevices][2];  // 0: not asked yet
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidValue;
  if (resident[dev][sys] == 0) {
    int sms = 0, per_sm = 0, coop = 0;
    cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sys ? ring_kernel<true> : ring_kernel<false>, kThreads, 0);
    if (e != cudaSuccess) return e;
    resident[dev][sys] = coop ? (long long)per_sm * sms : -1;
  }
  *out = resident[dev][sys];
  return cudaSuccess;
}

}  // namespace

// C interface, loaded with ctypes. One call launches every card's part of a
// ring collective: nparts parts, part p on device part_card[p] and stream
// streams[p], holding the part_size[p] members listed next in `members`
// (the wrapper's card_launches: every member that sends, and across cards
// every member that receives from another card, each on its own card), with
// `blocks` thread blocks each; the wrapper's ring_plan gives blocks, stripe
// and segment. gather selects the all-gather (root 0); xs and outs are host
// arrays of the ndev members' device pointers (block, output), peers'
// pointers included, cards their device indices, flags a host array of
// kMaxDevices flag buffers by device index (null where unused); base this
// launch's epoch; sys 1 where the ring spans cards. The current device is
// the same after the call as before.
// Returns cudaErrorCooperativeLaunchTooLarge when some part's blocks cannot
// all be resident (no part is launched then), cudaErrorInvalidValue for
// arguments out of range or a member table that is not the collective's,
// else cudaGetLastError() after the launches: 0 means launched.
extern "C" int dla_ring_launch(int gather, int ndev, int group, int root, const void* const* xs,
                               void* const* outs, const int* cards, void* const* flags,
                               long long block_bytes, long long stripe, long long segment,
                               unsigned long long base, int blocks, int nparts,
                               const int* part_card, const int* part_size, const int* members,
                               void* const* streams, int sys) {
  if (ndev < 1 || ndev > kMaxMembers || group < 1 || ndev % group || root < 0 || root >= group ||
      blocks < 1 || block_bytes < 1 || stripe < 16 || stripe % 16 || segment < 16 ||
      segment % 16 || stripe * blocks < block_bytes || (long long)ndev * blocks > kDataWords ||
      nparts < 1 || nparts > kMaxDevices || (sys != 0 && sys != 1) || (!sys && nparts != 1))
    return (int)cudaErrorInvalidValue;
  for (int d = 0; d < ndev; ++d)
    if (cards[d] < 0 || cards[d] >= kMaxDevices || flags[cards[d]] == nullptr ||
        (!sys && cards[d] != cards[0]))
      return (int)cudaErrorInvalidValue;
  // every member that takes part lies in exactly one part, on its own card, and no other
  bool listed[kMaxMembers] = {}, used[kMaxDevices] = {};
  for (int p = 0, k = 0; p < nparts; ++p) {
    if (part_card[p] < 0 || part_card[p] >= kMaxDevices || used[part_card[p]] ||
        part_size[p] < 1 || part_size[p] > ndev - k)
      return (int)cudaErrorInvalidValue;
    used[part_card[p]] = true;
    for (int i = 0; i < part_size[p]; ++i, ++k) {
      const int m = members[k];
      if (m < 0 || m >= ndev || listed[m] || cards[m] != part_card[p])
        return (int)cudaErrorInvalidValue;
      listed[m] = true;
    }
  }
  for (int d = 0; d < ndev; ++d) {
    const Roles ro = roles(gather, group, root, d);
    const bool takes = ro.sends || (sys && ro.receives && cards[ro.left] != cards[d]);
    if (takes != listed[d]) return (int)cudaErrorInvalidValue;
  }

  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  int current = prev;
  const auto set_device = [&](int dev) {
    if (dev != current && e == cudaSuccess) {
      e = cudaSetDevice(dev);
      current = dev;
    }
  };
  // every part is checked before any launches: a part launched alone would spin
  for (int p = 0; p < nparts && e == cudaSuccess; ++p) {
    long long resident = 0;
    set_device(part_card[p]);
    if (e == cudaSuccess) e = resident_blocks(part_card[p], sys, &resident);
    if (e == cudaSuccess && resident < 0) e = cudaErrorNotSupported;
    if (e == cudaSuccess && (long long)part_size[p] * blocks > resident)
      e = cudaErrorCooperativeLaunchTooLarge;
  }

  RingArgs a;
  a.block_bytes = block_bytes;
  a.stripe = stripe;
  a.segment = segment;
  a.base = base;
  a.group = group;
  a.root = root;
  a.blocks = blocks;
  a.gather = gather;
  for (int i = 0; i < kMaxDevices; ++i) a.flags[i] = static_cast<unsigned long long*>(flags[i]);
  for (int d = 0; d < ndev; ++d) {
    a.x[d] = static_cast<const char*>(xs[d]);
    a.out[d] = static_cast<char*>(outs[d]);
    a.card[d] = (signed char)cards[d];
  }
  const void* kernel = sys ? (const void*)ring_kernel<true> : (const void*)ring_kernel<false>;
  void* params[] = {&a};
  for (int p = 0, k = 0; p < nparts && e == cudaSuccess; k += part_size[p], ++p) {
    for (int i = 0; i < part_size[p]; ++i) a.member[i] = (unsigned char)members[k + i];
    set_device(part_card[p]);
    if (e == cudaSuccess)
      e = cudaLaunchCooperativeKernel(kernel, dim3((unsigned)(part_size[p] * blocks)),
                                      dim3(kThreads), params, 0,
                                      static_cast<cudaStream_t>(streams[p]));
  }
  if (e != cudaSuccess) cudaGetLastError();  // clear it: a refused launch leaves the context usable
  const cudaError_t back = current != prev ? cudaSetDevice(prev) : cudaSuccess;
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : back);
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
