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
// times its rounds. The design: one block a history (blocks loop over
// histories when the workspace bounds the grid), the whole walk in one
// launch, the slot table in shared memory, each event read once, and
// a round's keys sorted in place by a block bitonic sort over the next
// power of two P >= N (P/2 compare-exchanges a stage, log2(P)·(log2(P)
// + 1)/2 stages, a barrier each). Shared tier: keys and frontier in
// shared memory while (P + F) keys fit the 227 KB a block may opt into
// (F = 512 up to S = 24 for both variants). Global tier: the same code
// over a workspace in device memory that the wrapper allocates (every
// larger F·(S+1); a user may ask for any frontier).

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
constexpr uint32_t BIG = 0x7fffffffu;      // the packed empty entry
constexpr unsigned FULL = 0xffffffffu;
// shared bytes past the arrays: the scan's warp totals, then the slot
// table
constexpr long long TAIL_BYTES =
    32 * sizeof(long long) + 4 * REG_WORDS * sizeof(int32_t);

__host__ __device__ inline long long next_pow2(long long n) {
  long long p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Bytes of the arrays (P keys, then F), rounded up to 16.
__host__ __device__ inline long long array_bytes(long long P, int F,
                                                 bool packed) {
  const long long b = (P + F) * (packed ? 4 : 8);
  return (b + 15) & ~15LL;
}

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
// with a barrier.
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

// One block a history (blocks stride over histories). PACKED: uint32
// keys, else the uint64 two-array keys. STATS (two arrays only): peak
// and explored. GLOBAL: keys and frontier in `work` (P + F keys a
// block), else in dynamic shared memory; the index type widens with it.
template <bool PACKED, bool STATS, bool GLOBAL>
__global__ void __launch_bounds__(MAX_THREADS)
frontier_kernel(const int32_t* __restrict__ events,
                uint8_t* __restrict__ valid_out,
                uint8_t* __restrict__ overflow_out,
                int32_t* __restrict__ rounds_out,
                int32_t* __restrict__ peak_out,
                int32_t* __restrict__ explored_out, void* work, int B,
                int E, int F, int S, long long P) {
  using K = typename std::conditional<PACKED, uint32_t, uint64_t>::type;
  using I = typename std::conditional<GLOBAL, long long, int>::type;
  constexpr K PAD = ~K(0);                   // sorts past every real key
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const I T = blockDim.x;
  const I FF = F, PP = static_cast<I>(P);
  const I N = FF * static_cast<I>(S + 1);
  K* buf;
  unsigned char* tail;
  if constexpr (GLOBAL) {
    buf = static_cast<K*>(work) + static_cast<size_t>(blockIdx.x) *
                                      static_cast<size_t>(P + F);
    tail = smem;
  } else {
    buf = reinterpret_cast<K*>(smem);
    tail = smem + array_bytes(P, F, PACKED);
  }
  K* cur = buf + PP;
  long long* wsum = reinterpret_cast<long long*>(tail);
  int32_t* sf = reinterpret_cast<int32_t*>(wsum + 32);
  int32_t* sa1 = sf + REG_WORDS;
  int32_t* sa2 = sa1 + REG_WORDS;
  int32_t* skn = sa2 + REG_WORDS;
  // the scan's chunks: thread t owns [t * CH, t * CH + CH)
  const I CH = PP >= T ? PP / T : I(1);
  const I lo = static_cast<I>(tid) * CH;
  const I hi = lo + CH < N ? lo + CH : N;
  const uint32_t low = PACKED ? (1u << S) - 1u : 0u;

  auto kept = [&](I i) -> bool {
    const K k = buf[i];
    if constexpr (PACKED)
      return k != BIG && (i == 0 || buf[i - 1] != k);
    else
      return !(k & 1) && (i == 0 || (buf[i - 1] >> 1) != (k >> 1));
  };

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
    long long peak = 1;
    uint32_t explored = 0;                   // this thread's candidates
    __syncthreads();
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
        // the originals, the candidates, the padding
        for (I idx = tid; idx < PP; idx += T) {
          K key;
          if (idx < FF) {
            key = cur[idx];
          } else if (idx < N) {
            const I r = idx - FF;
            const I i = r / S;
            const int s = static_cast<int>(r - i * S);
            const K c = cur[i];
            const int f = sf[s], a1 = sa1[s], a2 = sa2[s];
            int32_t st;
            uint32_t m;
            bool live;
            if constexpr (PACKED) {
              st = static_cast<int32_t>(c) >> S;
              m = c & low;
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
            const bool can = live && f >= 0 && !(m & bit) && ok;
            if constexpr (PACKED) {
              key = can ? (static_cast<uint32_t>(nst) << S) | m | bit : BIG;
            } else {
              key = ((((static_cast<K>(static_cast<uint32_t>(nst)) << 24) |
                       (m | bit))
                      << 1) |
                     (can ? K(0) : K(1)));
              if constexpr (STATS) explored += can;
            }
          } else {
            key = PAD;
          }
          buf[idx] = key;
        }
        __syncthreads();
        bitonic_sort<K, I>(buf, PP);
        // kept flags, their prefix sum, the canonical frontier
        I cnt = 0;
        for (I i = lo; i < hi; ++i) cnt += kept(i);
        I total;
        I before = block_exclusive_scan<I>(cnt, total, wsum);
        bool ch = false;
        for (I i = lo; i < hi; ++i) {
          const K k = buf[i];
          const bool kp = kept(i);
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
        for (I i = tid; i < FF; i += T) {
          const K c = cur[i];
          if constexpr (PACKED) {
            const bool keep = c != BIG && ((c >> slot) & 1u);
            cur[i] = keep ? c & ~(1u << slot) : BIG;
          } else {
            const uint32_t m = static_cast<uint32_t>(c >> 1) & 0xffffffu;
            const bool live = !(c & 1) && ((m >> slot) & 1u);
            cur[i] = ((c >> 25) << 25) |
                     (static_cast<K>(m & ~(1u << slot)) << 1) |
                     (live ? K(0) : K(1));
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
    __syncthreads();                         // before the next history
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

template <bool PACKED, bool STATS, bool GLOBAL>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long P = next_pow2(static_cast<long long>(a.F) * (a.S + 1));
  long long threads = P / 2;
  if (threads < 32) threads = 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const long long smem =
      (GLOBAL ? 0 : array_bytes(P, a.F, PACKED)) + TAIL_BYTES;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        frontier_kernel<PACKED, STATS, GLOBAL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  frontier_kernel<PACKED, STATS, GLOBAL>
      <<<a.grid, static_cast<int>(threads), static_cast<size_t>(smem),
         stream>>>(a.events, a.valid, a.overflow, a.rounds, a.peak,
                   a.explored, a.work, a.B, a.E, a.F, a.S, P);
  return cudaGetLastError();
}

template <bool GLOBAL>
cudaError_t launch_tier(const Args& a, bool packed, cudaStream_t stream) {
  if (packed) return launch<true, false, GLOBAL>(a, stream);
  if (a.peak) return launch<false, true, GLOBAL>(a, stream);
  return launch<false, false, GLOBAL>(a, stream);
}

}  // namespace

// Launch on `stream` of `device`: events [B,E,6] int32; valid and
// overflow [B] bytes and rounds [B] int32 written, and peak and
// explored [B] int32 when both are not null (two arrays only: the STATS
// instantiations). `packed` picks the packed configurations. `work`
// null is the shared tier (the arrays must fit a block's shared
// memory); else the global tier over `work`, which holds
// (P + F) keys (4 bytes packed, 8 else) for each of `grid` blocks, P
// the power of two at or above F * (S + 1). `grid` blocks (1..B) stride
// over the histories. Returns a cudaError_t (0 on success):
// cudaErrorInvalidValue for arguments outside these bounds, else
// cudaGetLastError() right after the launch.
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
  err = work ? launch_tier<true>(a, packed != 0, st)
             : launch_tier<false>(a, packed != 0, st);
  return static_cast<int>(err);
}

// The CUDA runtime's text for an error code returned above.
extern "C" const char* knossos_frontier_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
