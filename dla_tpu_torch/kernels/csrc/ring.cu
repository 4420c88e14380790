// The ring collectives on a flat mesh of D members that share one card:
// ring_broadcast (chunk-pipelined broadcast of each sub-ring's root block) and
// ring_all_gather (one-way ring all-gather), as one cooperative kernel.
//
// Replaces dla_tpu/kernels/collectives.py:ring_broadcast (_bcast_kernel) and
// :ring_all_gather (_ring_kernel), the Pallas kernels whose steps are remote
// DMAs between TPU chips. Here each member is a set of allocations on the card
// (its block x, its output, its two comm slots), and a "remote DMA" is one
// member's thread blocks writing into its right neighbour's receive slot.
//
// What it computes (the Pallas protocol, step for step). Member id
// d = r * group + c; the ring runs over c within each sub-ring r, and member d
// always sends to base + (c + 1) % group.
//  - broadcast: C chunks of mc = m / C rows; every member puts chunk 0 of its
//    block in slot 0; steps t = 0 .. C + group - 3; at step t the root (ring
//    distance dist = (c - root) % group == 0) first puts chunk min(t, C - 1)
//    in its send slot t % 2 (t > 0), then every member forwards send slot t % 2
//    into its right neighbour's slot (t + 1) % 2, and a non-root member
//    captures that receive slot into output chunk t - (dist - 1) when that
//    index lies in [0, C). The root's output is its block. (The Pallas kernel
//    first copies every block to its output; a non-root output is then
//    overwritten whole by its C captures, so here only the root copies.)
//  - all-gather: one chunk, the whole block; every member writes its block to
//    output rows c * m and to slot 0; steps 0 .. group - 2 forward as above;
//    the block received at step t goes to output rows src * m,
//    src = (c - t - 1) % group.
//
// Design.
//  - One cooperative launch (cudaLaunchCooperativeKernel) of D x B blocks,
//    block d * B + b copying byte stripe b of every chunk for member d. The
//    launch guarantees that all blocks are resident at once, which the
//    spin-waits below need; when D * B blocks cannot be (occupancy x SMs), the
//    launcher returns cudaErrorCooperativeLaunchTooLarge without launching.
//  - The member pointer table travels as one const __grid_constant__ struct
//    (as the offset functors of trailing_df64.cuh do). Three pointers per
//    member: kMaxMembers = 128 keeps it at 3,140 bytes, inside the 4 KB of
//    kernel parameters (static_assert below; the wrapper raises above 128).
//  - Flags, one pair per (member, block): recv[d][b] = the last step whose
//    stripe b has landed in d's receive slot, sent[d][b] = the last step whose
//    send d's block b has finished. Blocks of the same index b of neighbouring
//    members synchronize with each other only, so no member signals before all
//    of a stripe has landed, without an atomic counter.
//  - Memory order. A sender's threads copy, each runs __threadfence(), the
//    block meets at __syncthreads(), and thread 0 stores the flags with
//    st.release.gpu. A receiver's thread 0 spins on ld.acquire.gpu with
//    __nanosleep, then the block meets at __syncthreads(). Slots are read with
//    ld.global.cg (L2, never a stale L1 line: each slot is reused every two
//    steps) and written with st.global.cg.
//  - Slot reuse (back-pressure). The Pallas kernel waits on its own send and
//    receive semaphores only; the TPU's DMA order keeps a sender from
//    overwriting a slot its neighbour still forwards. Here a sender waits
//    before step t >= 1 until sent[right][b] >= step t - 1 done: the slot it
//    writes, (t + 1) % 2, was last read by the right neighbour's step t - 1
//    send, and its step t - 2 capture came before that in program order. A
//    root waits for its own receive of step t - 1 before it injects into slot
//    t % 2, which that receive wrote.
//  - No deadlock: at step t a block waits only for its left neighbour's step
//    t - 1 send (receive of t - 1), its right neighbour's step t - 1 send
//    (credit) and its left neighbour's step t send (receive of t). If every
//    block has finished its step t - 1 send, every credit and every receive of
//    t - 1 is given, so every block sends step t, so every receive of t is
//    given; step 0 needs no credit. By induction all blocks finish, provided
//    all are resident, which the cooperative launch guarantees. A wait that
//    outlasts about ten seconds traps (a fault, not a hang).
//  - Flags are never cleared: the wrapper passes a base that grows by
//    steps + 1 at each launch (its epoch), a flag of step t is set to
//    base + t + 1, and a wait compares against base + t + 1. A flag left by an
//    earlier launch is at most that launch's base + steps, below every value
//    this launch waits for.
//  - The kernel moves bytes: 16-byte vector copies where both addresses are
//    16-byte aligned, bytes otherwise, so one instantiation serves fp32, fp64
//    and bf16, and rows of any width.
//
// Bound. Bytes: the root's block read once and D outputs written once,
// (1 + D) * V for the broadcast; D * V read and D * group * V written for the
// all-gather. The protocol itself moves each chunk once per hop through a
// slot, and pays one flag round trip per step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxMembers = 128;
constexpr int kThreads = 256;
constexpr long long kStripeTarget = 16 * 1024;  // bytes per block and step, for the auto B

struct RingArgs {
  unsigned long long* flags;  // recv[ndev * blocks], then sent[ndev * blocks]
  long long chunk_bytes;      // one chunk of a block (the whole block for the all-gather)
  long long slot_bytes;       // chunk_bytes rounded up to 16: slot 1 starts aligned
  long long stripe;           // bytes of a chunk that one block copies, a multiple of 16
  unsigned long long base;    // this launch's epoch
  int ndev, group, root, chunks, steps, blocks, gather;
  const char* x[kMaxMembers];
  char* out[kMaxMembers];
  char* comm[kMaxMembers];  // two slots of slot_bytes each
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
      __nanosleep(100);
      if (now_ns() - t0 > 10000000000ull) __trap();  // 10 s: a lost flag faults, never hangs
    }
  }
  if (threadIdx.x == 0) __threadfence();
  __syncthreads();
}

// Every thread's copies are visible on the card before thread 0 stores the flags.
__device__ __forceinline__ void publish(unsigned long long* a, unsigned long long* b,
                                       unsigned long long v) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    st_release(a, v);
    st_release(b, v);
  }
}

// The block copies n bytes, reading through L2 only.
__device__ __forceinline__ void copy_bytes(char* dst, const char* src, long long n) {
  if (n <= 0) return;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const long long nv = n >> 4;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (long long i = threadIdx.x; i < nv; i += blockDim.x) __stcg(d + i, __ldcg(s + i));
    done = nv << 4;
  }
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
  unsigned char* d = reinterpret_cast<unsigned char*>(dst);
  for (long long i = done + threadIdx.x; i < n; i += blockDim.x) __stcg(d + i, __ldcg(s + i));
}

__global__ void __launch_bounds__(kThreads) ring_kernel(const __grid_constant__ RingArgs a) {
  const int d = blockIdx.x / a.blocks, b = blockIdx.x % a.blocks;
  const int g = a.group, c = d % g, right = (d / g) * g + (c + 1) % g;
  const int dist = ((c - a.root) % g + g) % g;
  const long long s0 = b * a.stripe;
  const long long len = (s0 < a.chunk_bytes) ? min(a.stripe, a.chunk_bytes - s0) : 0;
  const long long cb = a.chunk_bytes;
  const char* x = a.x[d];
  char* out = a.out[d];
  char* mine = a.comm[d];
  char* theirs = a.comm[right];
  unsigned long long* recv = a.flags;
  unsigned long long* sent = a.flags + (long long)a.ndev * a.blocks;
  const int me = d * a.blocks + b, nbr = right * a.blocks + b;
  const unsigned long long base = a.base;

  if (a.gather) {
    copy_bytes(out + c * cb + s0, x + s0, len);
  } else if (dist == 0) {
    for (int i = 0; i < a.chunks; ++i) copy_bytes(out + i * cb + s0, x + i * cb + s0, len);
  }
  copy_bytes(mine + s0, x + s0, len);  // slot 0 <- chunk 0

  for (int t = 0; t < a.steps; ++t) {
    char* sslot = mine + (t & 1) * a.slot_bytes;
    char* rslot = mine + ((t + 1) & 1) * a.slot_bytes;
    if (t >= 1) wait_flag(recv + me, base + t);  // step t - 1 landed in slot t % 2
    if (!a.gather && dist == 0 && t > 0) {
      const long long ci = min(t, a.chunks - 1);
      copy_bytes(sslot + s0, x + ci * cb + s0, len);
    }
    if (t >= 1) wait_flag(sent + nbr, base + t);  // the right neighbour has sent step t - 1
    copy_bytes(theirs + ((t + 1) & 1) * a.slot_bytes + s0, sslot + s0, len);
    publish(sent + me, recv + nbr, base + t + 1);
    wait_flag(recv + me, base + t + 1);  // step t landed in slot (t + 1) % 2
    if (a.gather) {
      const int src = ((c - t - 1) % g + g) % g;
      copy_bytes(out + src * cb + s0, rslot + s0, len);
    } else if (dist != 0) {
      const int cap = t - (dist - 1);
      if (cap >= 0 && cap < a.chunks) copy_bytes(out + cap * cb + s0, rslot + s0, len);
    }
  }
}

}  // namespace

// C interface, loaded with ctypes. gather selects the all-gather (chunks 1);
// xs, outs and comms are host arrays of ndev device pointers (block, output,
// two slots of slot_bytes); flags a device array of flag_capacity 64-bit
// words that earlier launches left, never cleared; base this launch's epoch;
// blocks_per_member 0 picks B from the chunk size.
// Returns cudaErrorCooperativeLaunchTooLarge when ndev * B blocks cannot all
// be resident, cudaErrorInvalidValue for arguments out of range, else
// cudaGetLastError() after the launch: 0 means launched.
extern "C" int dla_ring_launch(int gather, int ndev, int group, int root, int chunks, int steps,
                               const void* const* xs, void* const* outs, void* const* comms,
                               void* flags, long long flag_capacity, long long chunk_bytes,
                               unsigned long long base, int blocks_per_member, void* stream) {
  if (ndev < 1 || ndev > kMaxMembers || group < 1 || ndev % group || chunks < 1 || steps < 0 ||
      chunk_bytes < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  const long long resident = (long long)per_sm * sms;
  long long nb = blocks_per_member;
  if (nb <= 0) {
    nb = (chunk_bytes + kStripeTarget - 1) / kStripeTarget;
    nb = nb < 1 ? 1 : nb;
    nb = nb > resident / ndev ? resident / ndev : nb;
    nb = nb < 1 ? 1 : nb;
  }
  if (ndev * nb > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (2 * ndev * nb > flag_capacity) return (int)cudaErrorInvalidValue;

  RingArgs a;
  a.flags = static_cast<unsigned long long*>(flags);
  a.chunk_bytes = chunk_bytes;
  a.slot_bytes = (chunk_bytes + 15) / 16 * 16;
  a.stripe = ((chunk_bytes + nb - 1) / nb + 15) / 16 * 16;
  a.base = base;
  a.ndev = ndev;
  a.group = group;
  a.root = root;
  a.chunks = chunks;
  a.steps = steps;
  a.blocks = (int)nb;
  a.gather = gather;
  for (int i = 0; i < ndev; ++i) {
    a.x[i] = static_cast<const char*>(xs[i]);
    a.out[i] = static_cast<char*>(outs[i]);
    a.comm[i] = static_cast<char*>(comms[i]);
  }
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(ring_kernel, dim3((unsigned)(ndev * nb)), dim3(kThreads), params,
                                  0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: a refused launch leaves the context usable
    return (int)e;
  }
  return (int)cudaGetLastError();
}
