// knossos_frontier_scan: the bounded sorted frontier's whole event walk
// for a batch of CAS-register histories, every completion step of every
// history in one launch.
//
// Replaces jepsen_tpu/checker/knossos/kernels.py:_scan_history (two
// arrays, with and without its stats carry) and
// jepsen_tpu/checker/knossos/packed.py:_scan_history_packed (one int32
// a configuration). Neither is a Pallas kernel: each is a lax.scan over
// the events with a lax.while_loop of up to S+2 expansion rounds at a
// completion, vmapped over histories and compiled by XLA into one
// program. Eager PyTorch runs the same walk as a Python loop of about
// 15 small launches a round and one host read a round (the plain
// versions, kept beside this kernel).
//
// What it computes, for history b (events [B,E,6] int32 rows of (kind,
// slot, f, a1, a2, known); kind 0 invoke, 1 complete, 2 pad):
//   * a frontier of F configurations (register state, mask of applied
//     pending slots), starting as {(0, 0)};
//   * an invoke writes (f, a1, a2, known) into its slot's row of the
//     slot table; a completion runs rounds until one changes nothing or
//     S+2 have run, then keeps only the configurations that applied the
//     completing slot, clears its bit and frees the slot (f = -1);
//   * a round builds the F originals and the F·S candidates (slot s
//     applied to configuration i: legal iff i is live, s occupied and
//     not in i's mask, and read (known == 0 or state == a1), cas
//     (state == a1) or any other f; the new state is a1 for a write, a2
//     for a cas, else the state), sorts them, keeps the first
//     occurrence of each live configuration, and writes the frontier
//     in the plain versions' canonical order, truncated to F:
//       - two arrays: the kept entries in (state, mask) order, then
//         every other entry (duplicates and dead candidates, with the
//         state and mask they were built with) in (state, mask) order;
//         the exit test compares the whole array, dead tail included;
//       - packed (`state << S | mask`, 2^31 - 1 for an empty entry):
//         the kept entries in order, then empty entries;
//     overflow is sticky: more unique live configurations than F;
//   * valid[b] = any live configuration at the end; rounds[b] = the
//     rounds run, summed over completions; with STATS (two arrays),
//     peak[b] = the most unique live configurations a round found (1 at
//     the start) and explored[b] = the legal candidates generated.
//
// Why one sort gives both orders. The two-array key is
// ((state << 24 | mask) << 1) | dead: sorted, each (state, mask) run
// holds its live entries first, so "live and first of its run" is the
// kept test, and a stable partition of the sorted array (kept first)
// is the plain version's second sort: entries equal in the key are
// equal in every field, so no sort here needs to be stable. The
// partition is a prefix sum of the kept flags.
//
// What bounds it on an H100. A round is a sort of N = F·(S+1) keys, a
// few hundred thousand compares at conc-20's F = 512, S = 8: well under
// a microsecond of the card's 32-bit rate spread over its SMs, and the
// events are a few kilobytes. But each history's walk is serial (its
// rounds, its completions), so a history costs the latency of a round
// times its rounds, and a round is one block's bitonic sort of the next
// power of two at or above N: log2(P)·(log2(P) + 1)/2 stages (91 at
// P = 8,192). What sets a round's latency is then what a stage costs:
// a stage that moves every key through shared memory and ends in a
// block barrier costs the block's whole shared-memory traffic plus a
// barrier, a stage inside a thread's registers a few integer
// instructions a key.
//
// The design (shared tier: keys and frontier fit the 227 KB a block may
// opt into, F = 512 up to S = 24 for both variants):
//   * Keys live in registers. The round sorts Q = T·KPT keys (Q = P, or
//     256 for the smallest frontiers): thread t owns KPT contiguous keys
//     of the order, [t·KPT, t·KPT + KPT) ("layout A"), and builds its
//     originals, candidates and padding straight into them.
//   * A bitonic stage of stride j < KPT is a compare-exchange between a
//     thread's own registers; KPT <= j < 32·KPT is a __shfl_xor_sync at
//     lane distance j/KPT (the partner's key kept where it is the one
//     the direction wants: one compare and one select a key). Neither
//     touches memory or a barrier. A warp whose keys are all padding
//     skips its own stages: they would change nothing.
//   * Only a stride on the warp bits (j >= 32·KPT) crosses warps. A
//     merge step that has such strides transposes once: the keys go to
//     shared memory in layout A and come back in "layout B", where the
//     warp bits and the low lane bits trade places, so those strides are
//     shuffles too; then back to A for the rest. Two barriers a merge
//     step (2·(log2(Q) - log2(KPT) - 5) a round: 10 of 91 stages' worth
//     at Q = 8,192, KPT = 8), each moving the Q keys once, as 16-byte
//     vectors swizzled so that a quarter warp hits eight distinct bank
//     groups in either layout.
//   * The kept test reads a key's left neighbour from the previous
//     register, across a thread boundary by __shfl_up_sync, across a
//     warp boundary from one shared word a warp (one more barrier); the
//     prefix sum is `block_exclusive_scan`; each thread then writes its
//     kept (and, for two arrays, dead-tail) keys into the frontier `cur`,
//     which stays in shared memory since any thread reads any cur[i].
//   * Packed, a round sorts only the live configurations and their
//     candidates (see `frontier_kernel`): at conc-20 most rounds have a
//     few dozen live configurations, so most sorts are 256 to 1,024 keys
//     on one to four warps. Two arrays cannot: their dead tail is part
//     of the exit test.
//   * A history's events go to shared memory in one cp.async.bulk (the
//     TMA's one-dimensional copy) completing on an mbarrier, where
//     E·24 bytes fit beside the arrays and E is even (the copy moves
//     16-byte multiples); otherwise rows are read from device memory.
//     On this tier every block walks one history (grid = B from the
//     wrapper), so nothing is prefetched.
//   * KPT is a template parameter, so every register index is static:
//     KEYS (8), or P / 1,024 (16 or 32) where 1,024 threads of KEYS keys
//     hold fewer than P. The entry point picks it from P alone.
// Global tier (every larger F·(S+1); a user may ask for any frontier):
// the keys and frontier of a block in a device-memory workspace that
// the wrapper allocates, blocks striding over histories, and the round
// a block bitonic sort in that workspace, P/2 compare-exchanges a
// stage and a barrier each (`bitonic_sort`).

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int INVOKE_EV = 0, COMPLETE_EV = 1;
constexpr int READ = 0, WRITE = 1, CAS = 2;
// the two-array key holds a mask in 24 bits; `state << S | mask` in an
// int32 needs S < 31
constexpr int MAX_SLOTS_PAIR = 24, MAX_SLOTS_PACKED = 30;
constexpr int REG_WORDS = 32;              // slot table rows (>= S)
constexpr int MAX_THREADS = 1024;
constexpr long long MAX_SMEM = 232448;     // shared memory a block, Hopper
constexpr long long EVENT_BYTES = 24;      // an event row, 6 int32
constexpr uint32_t BIG = 0x7fffffffu;      // the packed empty entry
constexpr unsigned FULL = 0xffffffffu;
// shared bytes past the arrays: the scan's warp totals, each warp's last
// key, the slot table, then the events' mbarrier (16 bytes, so that
// staged events start 16-aligned)
constexpr long long TAIL_BYTES = 32 * sizeof(long long) +
                                 32 * sizeof(uint64_t) +
                                 4 * REG_WORDS * sizeof(int32_t) + 16;

__host__ __device__ constexpr int ilog2(long long n) {
  return n > 1 ? 1 + ilog2(n >> 1) : 0;
}

__host__ __device__ inline long long next_pow2(long long n) {
  long long p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Bytes of the shared tier's arrays (Q keys, the F of the frontier and,
// packed, F more for the live copy), rounded up to 16.
__host__ __device__ inline long long array_bytes(long long Q, int F,
                                                 bool packed) {
  const long long b = packed ? (Q + 2LL * F) * 4 : (Q + F) * 8;
  return (b + 15) & ~15LL;
}

// Keys a thread of the register walk where 1,024 threads hold them all
// (every sort up to 8,192 keys): 8 is the fastest of 8, 16 and 32 on an
// H100 at the default arena (PERF.md, the frontier kernel's row).
constexpr int KEYS = 8;

// Keys a thread for a sort of P keys (a power of two): KEYS, or as many
// as 1,024 threads need.
__host__ __device__ constexpr int keys_for(long long P) {
  return P > static_cast<long long>(MAX_THREADS) * KEYS
             ? static_cast<int>(P / MAX_THREADS) : KEYS;
}

// The largest sort (a power of two) whose keys fit a block's shared
// memory beside the tail: 32,768 packed, 16,384 for two arrays. Each
// variant builds the keys a thread of its sorts up to that size only.
__host__ __device__ constexpr long long max_shared_keys(bool packed) {
  long long p = 1;
  while (2 * p * (packed ? 4 : 8) + TAIL_BYTES <= MAX_SMEM) p *= 2;
  return p;
}


#ifdef __CUDACC__
// The events' one-dimensional bulk copy and its mbarrier (PTX).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: `bytes` (a multiple of 16, both ends 16-aligned) from
// `src` to shared `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Every thread: until the phase of parity `parity` of `bar` completes.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}
#endif

// Exclusive prefix sum of x over the block; `total` gets the sum.
// Begins and ends with a barrier's worth of ordering on `wsum`.
template <typename I>
__device__ I block_exclusive_scan(I x, I& total, long long* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  I v = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const I y = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) wsum[warp] = static_cast<long long>(v);
  __syncthreads();
  if (warp == 0) {
    long long w = lane < nw ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) wsum[lane] = w;
  }
  __syncthreads();
  total = static_cast<I>(wsum[nw - 1]);
  return v - x + (warp ? static_cast<I>(wsum[warp - 1]) : I(0));
}

// Ascending block bitonic sort of buf[0, P), P a power of two; ends
// with a barrier (the global tier).
template <typename K, typename I>
__device__ void bitonic_sort(K* buf, I P) {
  const I half = P >> 1;
  for (I k = 2; k <= P; k <<= 1) {
    for (I j = k >> 1; j > 0; j >>= 1) {
      for (I i = threadIdx.x; i < half; i += blockDim.x) {
        const I lo = 2 * i - (i & (j - 1));    // bit j of lo clear
        const I hi = lo + j;
        const K a = buf[lo], b = buf[hi];
        if ((a > b) == ((lo & k) == 0)) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// ------------------------------------------------ the register sort

// Vector v (16 bytes) of the key order lives at this vector of the
// exchange buffer: its low three bits XORed with bits c..c+2 and
// c+5..c+7, c = log2 of a thread's vectors. The map is a bijection (each
// changed bit is XORed with higher bits only). In layout A a quarter
// warp's eight lanes differ in bits c..c+2; in layout B in bits c+5..c+7
// (or, with fewer than eight warps, in those and bits c..c+2): either
// way eight distinct bank groups.
__device__ __forceinline__ int swizzle(int v, int c) {
  return v ^ (((v >> c) ^ (v >> (c + 5))) & 7);
}

// A thread's KPT keys, which sit at [base, base + KPT) of the order,
// into (STORE) or out of the exchange buffer `buf`.
template <bool STORE, int KPT, typename K>
__device__ __forceinline__ void exchange(K* buf, K (&x)[KPT], int base) {
  constexpr int V = 16 / sizeof(K);          // keys a vector
  constexpr int C = ilog2(KPT / V);
  uint4* vb = reinterpret_cast<uint4*>(buf);
  const int v0 = base / V;
#pragma unroll
  for (int q = 0; q < KPT / V; ++q) {
    uint4& slot = vb[swizzle(v0 + q, C)];
    if constexpr (sizeof(K) == 4) {
      if constexpr (STORE) {
        slot = make_uint4(x[4 * q], x[4 * q + 1], x[4 * q + 2],
                          x[4 * q + 3]);
      } else {
        const uint4 w = slot;
        x[4 * q] = w.x;
        x[4 * q + 1] = w.y;
        x[4 * q + 2] = w.z;
        x[4 * q + 3] = w.w;
      }
    } else {
      if constexpr (STORE) {
        slot = make_uint4(static_cast<uint32_t>(x[2 * q]),
                          static_cast<uint32_t>(x[2 * q] >> 32),
                          static_cast<uint32_t>(x[2 * q + 1]),
                          static_cast<uint32_t>(x[2 * q + 1] >> 32));
      } else {
        const uint4 w = slot;
        x[2 * q] = (static_cast<uint64_t>(w.y) << 32) | w.x;
        x[2 * q + 1] = (static_cast<uint64_t>(w.w) << 32) | w.z;
      }
    }
  }
}

// One bitonic stage of stride j (KPT <= j) held across lanes: each key
// meets its partner's at lane distance d. `base` is the thread's first
// index in the layout the keys are in.
template <int KPT, typename K>
__device__ __forceinline__ void warp_stage(K (&x)[KPT], int base, int k,
                                           int j, int d) {
  const bool take_min = ((base & k) == 0) == ((base & j) == 0);
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const K y = __shfl_xor_sync(FULL, x[r], d);
    // the partner's key where it is the one to keep (equal keys: either)
    x[r] = (y < x[r]) == take_min ? y : x[r];
  }
}

// Ascending bitonic sort of the first 2^lg_q = 2^lg_w · 32 · KPT keys of
// the order, held by the block's first 2^lg_w warps (`active`) in layout
// A (thread t: [t·KPT, t·KPT + KPT)) on entry and on return. `buf` holds
// 2^lg_q keys. Barriers: two a merge step with warp-bit strides, reached
// by every thread of the block; none else. A warp holding only padding
// (all ones) skips its in-warp stages.
template <int KPT, typename K>
__device__ void register_sort(K (&x)[KPT], K* buf, int lg_q, int lg_w,
                              bool active) {
  constexpr int LGK = ilog2(KPT);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wb = LGK + 5;                    // the first warp bit
  const int base_a = threadIdx.x * KPT;
  // layout B: the warp index in bits [LGK, LGK + lg_w), the lane's low
  // lg_w bits in [wb, wb + lg_w), its other bits where they were
  const int ll = lane & ((1 << lg_w) - 1), lh = lane >> lg_w;
  const int base_b = (warp << LGK) | (lh << (LGK + lg_w)) | (ll << wb);
  for (int m = 1; m <= lg_q; ++m) {
    const int k = 1 << m;
    int p = m - 1;                           // the stride's bit
    if (p >= wb) {
      if (active) exchange<true>(buf, x, base_a);
      __syncthreads();
      if (active) {
        exchange<false>(buf, x, base_b);
        for (int q = p; q >= LGK + lg_w; --q)
          warp_stage(x, base_b, k, 1 << q,
                     q >= wb ? 1 << (q - wb) : 1 << (q - LGK));
        exchange<true>(buf, x, base_b);
      }
      p = LGK + lg_w - 1;
      __syncthreads();
      if (active) exchange<false>(buf, x, base_a);
    }
    if (!active) continue;
    // a warp whose keys are all padding (the sort's tail, past the real
    // keys) changes nothing in its own stages: skip them
    bool pad = true;
#pragma unroll
    for (int r = 0; r < KPT; ++r) pad &= x[r] == ~K(0);
    if (__all_sync(FULL, pad)) continue;
    for (; p >= LGK; --p) warp_stage(x, base_a, k, 1 << p, 1 << (p - LGK));
#pragma unroll
    for (int t = 1; t <= LGK; ++t) {
      const int j = KPT >> t;
      if (j < k) {
#pragma unroll
        for (int r = 0; r < KPT; ++r) {
          if (r & j) continue;
          const bool up = ((base_a | r) & k) == 0;
          const K a = x[r], b = x[r | j];
          const bool swap = (a > b) == up;
          x[r] = swap ? b : a;
          x[r | j] = swap ? a : b;
        }
      }
    }
  }
}

// --------------------------------------------------------- the walk

// The key of slot s applied to configuration c (its legality in the
// two-array key's dead bit, or BIG packed).
template <bool PACKED, typename K>
__device__ __forceinline__ K candidate(K c, int s, int S, const int32_t* sf,
                                       const int32_t* sa1,
                                       const int32_t* sa2,
                                       const int32_t* skn, bool& can) {
  const int f = sf[s], a1 = sa1[s], a2 = sa2[s];
  int32_t st;
  uint32_t m;
  bool live;
  if constexpr (PACKED) {
    st = static_cast<int32_t>(c) >> S;
    m = c & ((1u << S) - 1u);
    live = c != BIG;
  } else {
    st = static_cast<int32_t>(c >> 25);
    m = static_cast<uint32_t>(c >> 1) & 0xffffffu;
    live = !(c & 1);
  }
  const bool ok = f == READ ? (skn[s] == 0 || st == a1)
                : f == CAS  ? st == a1
                            : true;
  const int32_t nst = f == WRITE ? a1 : f == CAS ? a2 : st;
  const uint32_t bit = 1u << s;
  can = live && f >= 0 && !(m & bit) && ok;
  if constexpr (PACKED) {
    return can ? (static_cast<uint32_t>(nst) << S) | m | bit : BIG;
  } else {
    return (((static_cast<K>(static_cast<uint32_t>(nst)) << 24) |
             (m | bit))
            << 1) |
           (can ? K(0) : K(1));
  }
}

// One block a history (blocks stride over histories). PACKED: uint32
// keys, else the uint64 two-array keys. STATS (two arrays only): peak
// and explored. KPT > 0: the shared tier's register walk, KPT keys a
// thread; KPT == 0: the global tier's walk over `work` (P + F keys a
// block), its index type 64 bits wide. `staged`: the events go to
// shared memory first (shared tier only).
//
// The packed register walk sorts the live part only. Empty entries and
// their candidates are all BIG, which sorts last and is never kept, so
// a round over the L live configurations (originals, then their L·S
// candidates, padded to a power of two of at least a warp's keys) by
// the first warps of the block writes the frontier a round over all F
// would. The live ones are the first L entries of `cur` after a round
// (L = min(unique, F)); after a completion's filter they are scattered,
// so a prefix sum copies them, in order, to `src`, and `cur` stays as
// the filter left it: the next round's changed test compares with the
// array as it stood, as the plain version's does.
template <bool PACKED, bool STATS, int KPT>
__global__ void __launch_bounds__(MAX_THREADS)
frontier_kernel(const int32_t* __restrict__ events,
                uint8_t* __restrict__ valid_out,
                uint8_t* __restrict__ overflow_out,
                int32_t* __restrict__ rounds_out,
                int32_t* __restrict__ peak_out,
                int32_t* __restrict__ explored_out, void* work, int B,
                int E, int F, int S, long long P, bool staged) {
  using K = typename std::conditional<PACKED, uint32_t, uint64_t>::type;
  constexpr bool GLOBAL = KPT == 0;
  using I = typename std::conditional<GLOBAL, long long, int>::type;
  constexpr K PAD = ~K(0);                   // sorts past every real key
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const I T = blockDim.x;
  const I FF = F;
  // the keys a round sorts: P, or T·KPT >= P on the shared tier
  const I PP = GLOBAL ? static_cast<I>(P) : T * KPT;
  const I N = FF * static_cast<I>(S + 1);
  const int lg_q = ilog2(PP), lg_w = ilog2(T >> 5);
  K* buf;
  unsigned char* tail;
  if constexpr (GLOBAL) {
    buf = static_cast<K*>(work) + static_cast<size_t>(blockIdx.x) *
                                      static_cast<size_t>(P + F);
    tail = smem;
  } else {
    buf = reinterpret_cast<K*>(smem);
    tail = smem + array_bytes(PP, F, PACKED);
  }
  K* cur = buf + PP;
  K* src = cur + FF;              // the packed register walk's live copy
  long long* wsum = reinterpret_cast<long long*>(tail);
  uint64_t* edge = reinterpret_cast<uint64_t*>(wsum + 32);
  int32_t* sf = reinterpret_cast<int32_t*>(edge + 32);
  int32_t* sa1 = sf + REG_WORDS;
  int32_t* sa2 = sa1 + REG_WORDS;
  int32_t* skn = sa2 + REG_WORDS;
  uint64_t* ev_bar = reinterpret_cast<uint64_t*>(skn + REG_WORDS);
  int32_t* ev_smem = reinterpret_cast<int32_t*>(tail + TAIL_BYTES);
  // the global tier's scan chunks: thread t owns [t * CH, t * CH + CH)
  const I CH = PP >= T ? PP / T : I(1);
  const I lo = static_cast<I>(tid) * CH;
  const I hi = lo + CH < N ? lo + CH : N;

  auto kept_at = [&](I i) -> bool {
    const K k = buf[i];
    if constexpr (PACKED)
      return k != BIG && (i == 0 || buf[i - 1] != k);
    else
      return !(k & 1) && (i == 0 || (buf[i - 1] >> 1) != (k >> 1));
  };

  if (staged && tid == 0) mbar_init(ev_bar);
  uint32_t parity = 0;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int32_t* ev = events + static_cast<size_t>(b) * E * 6;
    for (I i = tid; i < FF; i += T) {
      if constexpr (PACKED)
        cur[i] = i == 0 ? 0u : BIG;
      else
        cur[i] = i == 0 ? K(0) : K(1);       // (0, 0), live only at 0
    }
    if (tid < REG_WORDS) {
      sf[tid] = -1;
      sa1[tid] = sa2[tid] = skn[tid] = 0;
    }
    bool overflow = false;
    int rounds = 0;
    int live = 1;                            // packed: the live prefix
    const K* from = cur;                     // packed: where it lies
    long long peak = 1;
    uint32_t explored = 0;                   // this thread's candidates
    __syncthreads();                         // (and the mbarrier's init)
    if (staged) {
      if (tid == 0)
        bulk_load(ev_smem, ev, static_cast<uint32_t>(E * EVENT_BYTES),
                  ev_bar);
      mbar_wait(ev_bar, parity);
      parity ^= 1u;
      ev = ev_smem;
    }
    for (int e = 0; e < E; ++e) {
      const int32_t* row = ev + 6 * e;
      const int kind = row[0], slot = row[1];
      const bool in = slot >= 0 && slot < S;
      if (kind == INVOKE_EV) {
        if (tid == 0 && in) {
          sf[slot] = row[2];
          sa1[slot] = row[3];
          sa2[slot] = row[4];
          skn[slot] = row[5];
        }
        continue;
      }
      if (kind != COMPLETE_EV) continue;
      __syncthreads();                       // the slot table is written
      for (int rnd = 0; rnd < S + 2;) {
        bool ch = false;
        I total;
        if constexpr (GLOBAL) {
          // the originals, the candidates, the padding
          for (I idx = tid; idx < PP; idx += T) {
            K key;
            if (idx < FF) {
              key = cur[idx];
            } else if (idx < N) {
              const I r = idx - FF;
              const I i = r / S;
              bool can;
              key = candidate<PACKED>(cur[i], static_cast<int>(r - i * S),
                                      S, sf, sa1, sa2, skn, can);
              if constexpr (STATS) explored += can;
            } else {
              key = PAD;
            }
            buf[idx] = key;
          }
          __syncthreads();
          bitonic_sort<K, I>(buf, PP);
          // kept flags, their prefix sum, the canonical frontier
          I cnt = 0;
          for (I i = lo; i < hi; ++i) cnt += kept_at(i);
          I before = block_exclusive_scan<I>(cnt, total, wsum);
          for (I i = lo; i < hi; ++i) {
            const K k = buf[i];
            const bool kp = kept_at(i);
            if constexpr (PACKED) {
              if (kp) {
                if (before < FF) {
                  ch |= cur[before] != k;
                  cur[before] = k;
                }
                ++before;
              }
            } else {
              const I pos = kp ? before : total + (i - before);
              if (kp) ++before;
              if (pos < FF) {
                const K nk = kp ? k : (k | 1);
                ch |= cur[pos] != nk;
                cur[pos] = nk;
              }
            }
          }
        } else {
          // the sort: packed, the `live` configurations of `from` and
          // their candidates on the first warps; two arrays, all F of
          // `cur`
          constexpr int LGK = ilog2(KPT);
          const int n_orig = PACKED ? live : F;
          const K* orig = PACKED ? from : cur;
          const int n_keys = n_orig * (S + 1);
          int lq = lg_q, lw = lg_w;
          if constexpr (PACKED) {
            lq = LGK + 5;
            while ((1 << lq) < n_keys) ++lq;
            lw = lq - LGK - 5;
          }
          const bool active = warp < (1 << lw);
          // this thread's keys of the order: originals, candidates
          // (slot s of configuration ci, in index order), padding
          const int base = tid * KPT;
          // (all padding past the active warps)
          int ci = 0, s = 0;
          if (base > n_orig) {
            ci = (base - n_orig) / S;
            s = base - n_orig - ci * S;
          }
          K x[KPT];
#pragma unroll
          for (int r = 0; r < KPT; ++r) {
            const int idx = base + r;
            if (idx < n_orig) {
              x[r] = orig[idx];
            } else if (idx < n_keys) {
              bool can;
              x[r] = candidate<PACKED>(orig[ci], s, S, sf, sa1, sa2, skn,
                                       can);
              if constexpr (STATS) explored += can;
              if (++s == S) {
                s = 0;
                ++ci;
              }
            } else {
              x[r] = PAD;
            }
          }
          register_sort<KPT>(x, buf, lq, lw, active);
          // kept: live and unlike its left neighbour (the previous
          // register, the previous lane's last, the previous warp's
          // last through `edge`)
          K left = __shfl_up_sync(FULL, x[KPT - 1], 1);
          if (lw > 0) {
            if (lane == 31 && active) edge[warp] = x[KPT - 1];
            __syncthreads();
            if (lane == 0 && warp > 0 && active)
              left = static_cast<K>(edge[warp - 1]);
          }
          uint32_t kept = 0;
          int cnt = 0;
          if (active) {
#pragma unroll
            for (int r = 0; r < KPT; ++r) {
              const int i = base + r;
              const K p = r ? x[r - 1] : left;
              bool kp;
              if constexpr (PACKED)
                kp = x[r] != BIG && (i == 0 || p != x[r]);
              else
                kp = !(x[r] & 1) && (i == 0 || (p >> 1) != (x[r] >> 1));
              kp = kp && i < n_keys;
              kept |= static_cast<uint32_t>(kp) << r;
              cnt += kp;
            }
          }
          int before = block_exclusive_scan<int>(cnt, total, wsum);
          if (active) {
#pragma unroll
            for (int r = 0; r < KPT; ++r) {
              const int i = base + r;
              const bool kp = (kept >> r) & 1u;
              if constexpr (PACKED) {
                if (kp) {
                  if (before < F) {
                    ch |= cur[before] != x[r];
                    cur[before] = x[r];
                  }
                  ++before;
                }
              } else if (i < n_keys) {
                const int pos = kp ? before : total + (i - before);
                if (kp) ++before;
                if (pos < F) {
                  const K nk = kp ? x[r] : (x[r] | 1);
                  ch |= cur[pos] != nk;
                  cur[pos] = nk;
                }
              }
            }
          }
          live = total < F ? total : F;
          from = cur;
        }
        if constexpr (PACKED) {
          for (I p = total + tid; p < FF; p += T) {
            ch |= cur[p] != BIG;
            cur[p] = BIG;
          }
        }
        const bool changed = __syncthreads_or(ch);
        ++rnd;
        ++rounds;
        overflow |= total > FF;
        if constexpr (STATS)
          peak = peak > static_cast<long long>(total)
                     ? peak : static_cast<long long>(total);
        if (!changed) break;
      }
      // the completion deadline: keep what applied the slot, retire its
      // bit, free the slot
      if (in) {
        if constexpr (PACKED && !GLOBAL) {
          // by contiguous chunks, so that a prefix sum of the chunks'
          // live counts places them in `src` in order
          const int chunk = (F + T - 1) / T;
          const int c0 = tid * chunk < F ? tid * chunk : F;
          const int c1 = c0 + chunk < F ? c0 + chunk : F;
          int n = 0;
          for (int i = c0; i < c1; ++i) {
            const K c = cur[i];
            const bool keep = c != BIG && ((c >> slot) & 1u);
            cur[i] = keep ? c & ~(1u << slot) : BIG;
            n += keep;
          }
          int at = block_exclusive_scan<int>(n, live, wsum);
          for (int i = c0; i < c1; ++i)
            if (cur[i] != BIG) src[at++] = cur[i];
          from = src;
        } else {
          for (I i = tid; i < FF; i += T) {
            const K c = cur[i];
            if constexpr (PACKED) {
              const bool keep = c != BIG && ((c >> slot) & 1u);
              cur[i] = keep ? c & ~(1u << slot) : BIG;
            } else {
              const uint32_t m = static_cast<uint32_t>(c >> 1) & 0xffffffu;
              const bool keep = !(c & 1) && ((m >> slot) & 1u);
              cur[i] = ((c >> 25) << 25) |
                       (static_cast<K>(m & ~(1u << slot)) << 1) |
                       (keep ? K(0) : K(1));
            }
          }
        }
        if (tid == 0) sf[slot] = -1;
      }
      __syncthreads();
    }
    bool any = false;
    for (I i = tid; i < FF; i += T) {
      if constexpr (PACKED)
        any |= cur[i] != BIG;
      else
        any |= !(cur[i] & 1);
    }
    const bool valid = __syncthreads_or(any);
    long long total_explored = 0;
    if constexpr (STATS)
      block_exclusive_scan<long long>(explored, total_explored, wsum);
    if (tid == 0) {
      valid_out[b] = valid;
      overflow_out[b] = overflow;
      rounds_out[b] = rounds;
      if constexpr (STATS) {
        peak_out[b] = static_cast<int32_t>(peak);
        explored_out[b] = static_cast<int32_t>(
            static_cast<uint32_t>(total_explored));
      }
    }
    __syncthreads();              // before the next history (its events)
  }
}

}  // namespace

// ------------------------------------------------------------- launch

namespace {

struct Args {
  const int32_t* events;
  uint8_t* valid;
  uint8_t* overflow;
  int32_t* rounds;
  int32_t* peak;
  int32_t* explored;
  void* work;
  int B, E, F, S, grid;
};

template <bool PACKED, bool STATS, int KPT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long P = next_pow2(static_cast<long long>(a.F) * (a.S + 1));
  long long threads = KPT ? P / KPT : P / 2;
  if (threads < 32) threads = 32;
  if (threads > MAX_THREADS) {
    if (KPT) return cudaErrorInvalidValue;
    threads = MAX_THREADS;
  }
  const long long arrays = KPT ? array_bytes(threads * KPT, a.F, PACKED) : 0;
  const long long ev_bytes = EVENT_BYTES * a.E;
  const bool staged =
      KPT && ev_bytes > 0 && ev_bytes % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(a.events) & 15) == 0 &&
      arrays + TAIL_BYTES + ev_bytes <= MAX_SMEM;
  const long long smem = arrays + TAIL_BYTES + (staged ? ev_bytes : 0);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        frontier_kernel<PACKED, STATS, KPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  frontier_kernel<PACKED, STATS, KPT>
      <<<a.grid, static_cast<int>(threads), static_cast<size_t>(smem),
         stream>>>(a.events, a.valid, a.overflow, a.rounds, a.peak,
                   a.explored, a.work, a.B, a.E, a.F, a.S, P, staged);
  return cudaGetLastError();
}

// The instantiation for `kpt` keys a thread (0: the global tier), among
// KEYS, 2·KEYS, ... up to what the variant's largest shared sort needs.
template <bool PACKED, bool STATS, int KPT = KEYS>
cudaError_t launch_keys(const Args& a, int kpt, cudaStream_t stream) {
  if (kpt == 0) return launch<PACKED, STATS, 0>(a, stream);
  if (kpt == KPT) return launch<PACKED, STATS, KPT>(a, stream);
  if constexpr (2 * KPT <= keys_for(max_shared_keys(PACKED)))
    return launch_keys<PACKED, STATS, 2 * KPT>(a, kpt, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Launch on `stream` of `device`: events [B,E,6] int32; valid and
// overflow [B] bytes and rounds [B] int32 written, and peak and
// explored [B] int32 when both are not null (two arrays only: the STATS
// instantiations). `packed` picks the packed configurations. `work`
// null is the shared tier (the arrays must fit a block's shared
// memory), its register walk with keys_for(P) keys a thread and
// max(32, P / keys) threads, a history's events staged in shared memory
// where E * 24 is a multiple of 16, `events` is 16-aligned and they fit
// beside the arrays; else the global tier over `work`, which holds
// (P + F) keys (4 bytes packed, 8 else) for each of `grid` blocks. P is
// the power of two at or above F * (S + 1). `grid`
// blocks (1..B) stride over the histories. Returns a cudaError_t (0 on
// success): cudaErrorInvalidValue for arguments outside these bounds,
// else cudaGetLastError() right after the launch.
extern "C" int knossos_frontier_launch(const void* events, void* valid, void* overflow, void* rounds, void* peak, void* explored, void* work, int B, int E, int F, int S, int packed, int grid, int device, void* stream) {
  const int max_slots = packed ? MAX_SLOTS_PACKED : MAX_SLOTS_PAIR;
  if (B <= 0 || E < 0 || F < 1 || S < 1 || S > max_slots || grid < 1 ||
      grid > B || (peak == nullptr) != (explored == nullptr) ||
      (packed && peak != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // this library carries its own (static) CUDA runtime, whose current
  // device is not PyTorch's: name the tensor's device explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const int32_t*>(events),
               static_cast<uint8_t*>(valid),
               static_cast<uint8_t*>(overflow),
               static_cast<int32_t*>(rounds),
               static_cast<int32_t*>(peak),
               static_cast<int32_t*>(explored),
               work, B, E, F, S, grid};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kpt =
      work ? 0 : keys_for(next_pow2(static_cast<long long>(F) * (S + 1)));
  err = packed  ? launch_keys<true, false>(a, kpt, st)
        : peak  ? launch_keys<false, true>(a, kpt, st)
                : launch_keys<false, false>(a, kpt, st);
  return static_cast<int>(err);
}

// The CUDA runtime's text for an error code returned above.
extern "C" const char* knossos_frontier_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
