// knossos_dense_scan: the whole just-in-time linearizability search of a
// batch of CAS-register histories over the dense configuration grid,
// one thread block per history, every step in one launch.
//
// Replaces jepsen_tpu/checker/knossos/dense.py:_scan_dense (under the
// jitted check_dense_device). That is not a Pallas kernel: it is plain
// JAX, a lax.scan over the C completion steps with a lax.while_loop of
// up to S+2 expansion rounds inside each, vmapped over histories and
// compiled by XLA into one program. Eager PyTorch has no such compiler:
// the same scan is a Python loop, and one round written over slots is
// about ten small ops for each of S slots, so a 1,000-op history at
// concurrency 10 (C ~ 1,000, S = 10) costs C * (S+2) * 10 * S ~ 1.2 M
// launches per bucket. Here the loop runs on the card instead.
//
// What it computes, for history b (regs [B,C,S,4] int32 rows of
// (f or -1, a1, a2, known); comp [B,C] int32, the completing slot or -1
// on a pad step):
//   * grid[v, m], v < V register values (0 is nil), m < 2^S masks of
//     applied pending slots, starts as {(0, 0)};
//   * at a step with comp >= 0, rounds run until a round changes nothing
//     or S+2 rounds have run. A round adds every (v', m | bit_s)
//     reachable from a set (v, m) with slot s occupied, lacking from m
//     and legal for v: read (known == 0 or v == a1) keeps v, write goes
//     to a1, cas (v == a1) goes to a2;
//   * then the completing slot's bit retires: grid'[v, m] =
//     grid[v, m | bit_cs] for m lacking cs, 0 elsewhere (no slot cs < S:
//     the grid empties, as the reference's select over s < S does);
//   * valid[b] = any bit of the grid still set; rounds[b] = the rounds
//     run, summed over steps.
//
// Bound on an H100: the inputs are small (16*S bytes a step) and the
// rounds are 32-bit logic over a grid of V * 2^S bits, so operations
// bound it, on the integer pipes; but each round is short (at S = 10,
// V = 8 the grid is 256 words), so what it pays for in practice is the
// latency of the block-wide barriers between rounds. Design:
//
//  * The grid lives as bits in shared memory for the whole scan: V <= 64
//    rows of 2^S bits, 32 masks a word, at most 64 * 16,384 bits =
//    128 KB (dynamic shared memory, opted in above 48 KB). Nothing of it
//    goes to device memory; the block reads its timeline once, one
//    step ahead of use (the next step's slots and comp are loaded into
//    registers while the current step runs).
//  * Each word of the grid has one owner thread, which ORs the round's
//    contributions into it: for slot s >= 5 the mask shift m & ~bit_s ->
//    m moves whole words (word w ^ 2^(s-5)), for s < 5 it stays inside a
//    word (a shift by 2^s and the pattern of positions with bit s). A
//    write's sources are all rows, so their OR is built first, once a
//    round.
//  * In place: a round reads words that other owners may already have
//    updated in the same round. That is allowed because the update is
//    monotone (bits are only set) and every chain applies at most S
//    slots: an in-place round starts from a superset of what a Jacobi
//    round (the reference's) starts from and adds at least as much, so
//    both reach the same least fixpoint within S rounds and see it
//    unchanged by round S+1, under the S+2 cap. Only the round count,
//    the telemetry in rounds[b], can differ from the reference's.
//  * A block-wide OR (__syncthreads_or) gives the round's changed flag.
//    There are no mbarriers and no spin waits: every wait is a barrier
//    of the block.
//
// Inputs must be contiguous; 1 <= S <= 14, 1 <= V <= 64 (the wrapper
// checks). Values a1, a2 >= V never match a grid row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int READ = 0, WRITE = 1, CAS = 2;
constexpr int MAX_SLOTS = 14;
constexpr int MAX_VALUES = 64;
constexpr int MAX_THREADS = 1024;

// bit positions p < 32 with bit s of p set, for s < 5 (the index is
// the same across a warp, so constant memory broadcasts it)
__constant__ uint32_t kHasBit[5] = {0xAAAAAAAAu, 0xCCCCCCCCu, 0xF0F0F0F0u,
                                    0xFF00FF00u, 0xFFFF0000u};

__device__ __forceinline__ uint32_t has_bit(int s) { return kHasBit[s]; }

// Word w of "row with slot s applied": bit m set iff m has bit s and the
// row has bit m ^ bit_s.
__device__ __forceinline__ uint32_t lift(const uint32_t* row, int w, int s) {
  if (s >= 5) {
    const int b = 1 << (s - 5);
    return (w & b) ? row[w ^ b] : 0u;
  }
  return (row[w] << (1 << s)) & has_bit(s);
}

// at most 1,024 threads: 64 registers a thread, so a full block fits
__global__ void __launch_bounds__(MAX_THREADS)
knossos_dense_kernel(const int32_t* __restrict__ regs,
                     const int32_t* __restrict__ comp,
                     uint8_t* __restrict__ valid_out,
                     int32_t* __restrict__ rounds_out, int C, int S, int V) {
  extern __shared__ uint32_t smem[];
  const int log_w = S > 5 ? S - 5 : 0;
  const int W = 1 << log_w;          // words a row
  const int VW = V * W;
  const int S4 = S * 4;
  uint32_t* grid = smem;             // [V][W]
  uint32_t* any_row = grid + VW;     // [W], OR of all rows
  int32_t* slot = reinterpret_cast<int32_t*>(any_row + W);   // [S][4]

  const int tid = threadIdx.x, nt = blockDim.x;
  const int32_t* hregs = regs + static_cast<size_t>(blockIdx.x) * C * S4;
  const int32_t* hcomp = comp + static_cast<size_t>(blockIdx.x) * C;

  for (int i = tid; i < VW; i += nt) grid[i] = i == 0 ? 1u : 0u;

  int cs_next = C > 0 ? hcomp[0] : -1;
  int32_t reg_next = (C > 0 && tid < S4) ? hregs[tid] : 0;
  int total_rounds = 0;
  for (int c = 0; c < C; ++c) {
    const int cs = cs_next;          // the same in every thread
    const int32_t reg = reg_next;
    if (c + 1 < C) {
      cs_next = hcomp[c + 1];
      if (tid < S4) reg_next = hregs[static_cast<size_t>(c + 1) * S4 + tid];
    }
    if (cs < 0) continue;            // a pad step: no expansion, no retire
    if (tid < S4) slot[tid] = reg;
    __syncthreads();                 // slots (and, at first, the grid) in

    bool any_write = false;
    for (int s = 0; s < S; ++s) any_write |= slot[4 * s] == WRITE;
    int changed = 1, rnd = 0;
    while (changed && rnd < S + 2) {
      if (any_write) {
        for (int w = tid; w < W; w += nt) {
          uint32_t a = 0u;
          for (int u = 0; u < V; ++u) a |= grid[u * W + w];
          any_row[w] = a;
        }
        __syncthreads();
      }
      int mine = 0;
      for (int i = tid; i < VW; i += nt) {
        const int v = i >> log_w, w = i & (W - 1);
        const uint32_t old = grid[i];
        uint32_t acc = 0u;
        for (int s = 0; s < S; ++s) {
          const int f = slot[4 * s], a1 = slot[4 * s + 1];
          if (f == READ) {
            if (slot[4 * s + 3] == 0 || a1 == v)
              acc |= lift(grid + v * W, w, s);
          } else if (f == WRITE) {
            if (a1 == v) acc |= lift(any_row, w, s);
          } else if (f == CAS) {
            if (slot[4 * s + 2] == v && a1 >= 0 && a1 < V)
              acc |= lift(grid + a1 * W, w, s);
          }
        }
        const uint32_t now = old | acc;
        if (now != old) {
          grid[i] = now;
          mine = 1;
        }
      }
      changed = __syncthreads_or(mine);
      ++rnd;
    }
    total_rounds += rnd;

    // the completion deadline: keep configurations that applied cs, and
    // retire its bit
    if (cs >= S) {
      for (int i = tid; i < VW; i += nt) grid[i] = 0u;
    } else if (cs >= 5) {
      const int b = 1 << (cs - 5);
      for (int i = tid; i < VW; i += nt) {
        if (!(i & b)) {              // i | b: the same row, word w | b
          grid[i] = grid[i | b];
          grid[i | b] = 0u;
        }
      }
    } else {
      const uint32_t lacks = ~has_bit(cs);
      const int sh = 1 << cs;
      for (int i = tid; i < VW; i += nt) grid[i] = (grid[i] >> sh) & lacks;
    }
    __syncthreads();
  }
  int mine = 0;
  for (int i = tid; i < VW; i += nt) mine |= grid[i] != 0u;
  const int any = __syncthreads_or(mine);
  if (tid == 0) {
    valid_out[blockIdx.x] = any ? 1 : 0;
    rounds_out[blockIdx.x] = total_rounds;
  }
}

}  // namespace

// Launch on `stream` of `device`: regs [B,C,S,4] int32, comp [B,C] int32,
// valid [B] bytes and rounds [B] int32 written. Returns a cudaError_t
// (0 on success), cudaGetLastError() right after the launch.
extern "C" int knossos_dense_launch(const void* regs, const void* comp,
                                    void* valid, void* rounds, int B, int C,
                                    int S, int V, int device, void* stream) {
  if (B <= 0 || C < 0 || S < 1 || S > MAX_SLOTS || V < 1 ||
      V > MAX_VALUES) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // this library carries its own (static) CUDA runtime, whose current
  // device is not PyTorch's: name the tensor's device explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int W = S > 5 ? 1 << (S - 5) : 1;
  const size_t smem = sizeof(uint32_t) * (static_cast<size_t>(V) * W + W) +
                      sizeof(int32_t) * 4 * S;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(knossos_dense_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = (V * W + 31) / 32 * 32;
  threads = threads < 64 ? 64 : threads > MAX_THREADS ? MAX_THREADS : threads;
  knossos_dense_kernel<<<B, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(regs), static_cast<const int32_t*>(comp),
      static_cast<uint8_t*>(valid), static_cast<int32_t*>(rounds), C, S, V);
  return static_cast<int>(cudaGetLastError());
}

// The CUDA runtime's text for an error code returned above.
extern "C" const char* knossos_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
