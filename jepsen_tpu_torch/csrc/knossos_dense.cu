// knossos_dense_scan: the whole just-in-time linearizability search of a
// batch of CAS-register histories over the dense configuration grid,
// every completion step of every history in one launch.
//
// Replaces jepsen_tpu/checker/knossos/dense.py:_scan_dense (under the
// jitted check_dense_device). That is not a Pallas kernel: it is plain
// JAX, a lax.scan over the C completion steps with a lax.while_loop of
// up to S+2 expansion rounds inside each, vmapped over histories and
// compiled by XLA into one program. Eager PyTorch has no such compiler:
// the same scan is a Python loop of about C * (S+2) * 10 * S small
// launches (~1.2 M for a 1,000-op history at concurrency 10). Here the
// loop runs on the card instead.
//
// What it computes, for history b (regs [B,C,S,4] int32 rows of
// (f or -1, a1, a2, known); comp [B,C] int32, the completing slot or -1
// on a pad step):
//   * grid[v, m], v < V register values (0 is nil), m < 2^S masks of
//     applied pending slots, starts as {(0, 0)};
//   * at a step with comp >= 0, Jacobi rounds run until a round changes
//     nothing or S+2 rounds have run. A round computes, from the grid
//     the previous round left, every (v', m | bit_s) reachable from a
//     set (v, m) with slot s occupied, lacking from m and legal for v:
//     read (known == 0 or v == a1) keeps v, write goes to a1, cas
//     (v == a1) goes to a2;
//   * then the completing slot's bit retires: grid'[v, m] =
//     grid[v, m | bit_cs] for m lacking cs, 0 elsewhere (no slot cs < S:
//     the grid empties, as the reference's select over s < S does);
//   * valid[b] = any bit of the grid still set; rounds[b] = the rounds
//     run, summed over steps: the reference's count, since every round
//     reads only the previous round's grid.
//
// What bounds it on an H100. The inputs are small (16*S bytes a step)
// and a round is 32-bit logic over V * 2^S bits: at S = 10, V = 8 that
// is 256 words and about (2S+1) * 256 word operations, which the integer
// pipes of one SM finish in under a hundred cycles (chip_smoke.py
// computes the bound by operations from each run's rounds). The walk is
// sequential in its steps and rounds, though, so what it pays for is
// the latency of a round times the rounds; the design cuts that latency:
//
//  * Warp tier (grids of at most 512 words, V counted as 2^(5 - LW) >= 8
//    rows: S <= 11 at V <= 8, S <= 8 at V = 64). One warp a history,
//    two histories a block, the grid in registers: a lane holds K <= 16
//    words. Word (v, w), w the word index within a row (bit m of a row
//    is bit m & 31 of word m >> 5): the low 5 - LW bits of v index
//    lanes, the LW <= 2 other lane bits hold the low bits of w, and
//    registers hold the high bits of w (and, at V > 32, v's sixth bit).
//    A lift by slot s (a row's word with bit s clear moved to where it
//    is set) is then an in-register shift and mask (s < 5), a shuffle
//    across lanes (a w bit held in lanes) or a register select (a w bit
//    held in registers). LW and K are template parameters, so every slot
//    has a static place, every register index is static and the round is
//    straight-line code: one __shfl_sync a slot a word (the source lane
//    is its own for a read or write without a lane bit, another row's
//    for a cas), a shift, a mask and an OR, with the shuffles of all
//    slots free to issue back to back. The round's changed flag is
//    __any_sync; there is no barrier at all. 19 instantiations, none
//    spilling (ptxas; `tools/knossos_dense_variants.py` prints it).
//  * Block tier (larger grids, up to S = 14, V = 64: 32,768 words). One
//    block a history, the grid in shared memory (<= 128 KB plus a row,
//    opted in above 48 KB). Each thread computes the new values of its
//    words from the grid as it stands, the first <= 8 in registers and
//    the rest into a shared-memory buffer past the grid (at most 96 KB:
//    227 KB hold no second grid), then one __syncthreads_or (the changed
//    flag) separates those reads from the writes, and one barrier the
//    writes from the next round. The rows' OR, the source of a write, is
//    kept beside the grid: a round's writes OR themselves into it
//    (shared atomics), and the retire transforms it as it transforms a
//    row, so it is never rebuilt. 4 instantiations (words a thread
//    keeps in registers: 1, 2, 4, 8), none spilling.
//  * Both tiers decode a step once: every warp holds the step's slot
//    table one slot a lane, loaded a step ahead of use, and turns it into
//    warp-uniform masks by ballots (read, read of any value, write, cas);
//    the warp tier also derives, per slot, its source lane and the bits
//    it may set in each row a lane holds.
//
// The wrapper (dense.plan_scan) picks the tier and launch shape; the
// tier boundary is where the warp tier's registers run out, and the
// measured times are in PERF.md.
//
// Inputs must be contiguous, regs 16-byte aligned; 1 <= S <= 14,
// 1 <= V <= 64 (the wrapper checks). Values a1, a2 outside [0, V) never
// match a grid row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int READ = 0, WRITE = 1, CAS = 2;
constexpr int MAX_SLOTS = 14;
constexpr int MAX_VALUES = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_MAX_LOGK = 4;          // warp tier: <= 16 words a lane
constexpr int WARP_MAX_THREADS = 256;     // <= 8 histories a block
constexpr int BLOCK_MAX_THREADS = 1024;
constexpr int BLOCK_MAX_WORDS = 32;       // block tier: words a thread
constexpr int BLOCK_MAX_REG_WORDS = 8;    // of them in registers, at most
constexpr int MAX_SMEM = 232448;          // shared memory a block, Hopper

// bit positions p < 32 with bit s of p set, for s < 5 (the index is
// the same across a warp, so constant memory broadcasts it)
__constant__ uint32_t kHasBit[5] = {0xAAAAAAAAu, 0xCCCCCCCCu, 0xF0F0F0F0u,
                                    0xFF00FF00u, 0xFFFF0000u};

// One step's slot table as warp-uniform masks of slots. `row` is slot
// `lane`'s (f, a1, a2, known) for lane < S.
struct StepMasks {
  uint32_t rd, rd_any, wr, cas;
};

__device__ __forceinline__ StepMasks decode(const int4 row, int lane, int S,
                                            int V) {
  const bool in = lane < S;
  const bool ok1 = row.y >= 0 && row.y < V, ok2 = row.z >= 0 && row.z < V;
  StepMasks m;
  m.rd = __ballot_sync(FULL, in && row.x == READ);
  m.rd_any = __ballot_sync(FULL, in && row.x == READ && row.w == 0);
  m.wr = __ballot_sync(FULL, in && row.x == WRITE && ok1);
  m.cas = __ballot_sync(FULL, in && row.x == CAS && ok1 && ok2);
  return m;
}

// ---------------------------------------------------------------- warp

// Bit pattern of the positions p < 32 with bit s of p set (s < 5).
__host__ __device__ constexpr uint32_t has_bit_pattern(int s) {
  return s == 0 ? 0xAAAAAAAAu : s == 1 ? 0xCCCCCCCCu : s == 2 ? 0xF0F0F0F0u
       : s == 3 ? 0xFF00FF00u : 0xFFFF0000u;
}

// One warp a history. LW: lane bits of w (V rounded up to 2^(5 - LW)
// values, at least 8, so LW <= 2); 2^LOGK words a lane; VHI: V > 32, so
// a lane holds two rows, v = vl and v = vl + 32 (LW = 0 then). The
// instantiation lifts NS = 5 + LW + log2(words of a row a lane holds)
// slots: S itself when it has a register bit of w, else S <= NS and the
// slots past S are free.
template <int LW, int LOGK, bool VHI>
__global__ void __launch_bounds__(WARP_MAX_THREADS, 1)
dense_warp_kernel(const int32_t* __restrict__ regs,
                  const int32_t* __restrict__ comp,
                  uint8_t* __restrict__ valid_out,
                  int32_t* __restrict__ rounds_out, int B, int C, int S,
                  int V) {
  constexpr int LV = 5 - LW;                 // lane bits of v
  constexpr int VMASK = (1 << LV) - 1;
  constexpr int K = 1 << LOGK;
  constexpr int H = VHI ? 2 : 1;             // rows a lane holds
  constexpr int KW = K / H;                  // words of one row a lane holds
  constexpr int LOGKW = VHI ? LOGK - 1 : LOGK;
  constexpr int NS = 5 + LW + LOGKW;
  static_assert(LW >= 0 && LW <= 2 && (!VHI || LW == 0), "lane layout");
  static_assert(LOGKW >= 0 && NS <= MAX_SLOTS, "register layout");
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;                        // the whole warp leaves
  const int vl = lane & VMASK, wl = lane >> LV;

  // g[h * KW + wh]: word w = wh << LW | wl of row v = vl + 32 h
  uint32_t g[K];
#pragma unroll
  for (int r = 0; r < K; ++r) g[r] = 0u;
  if (lane == 0) g[0] = 1u;

  const int4* hregs = reinterpret_cast<const int4*>(regs) +
                      static_cast<size_t>(b) * C * S;
  const int32_t* hcomp = comp + static_cast<size_t>(b) * C;
  const int4 none = make_int4(-1, 0, 0, 0);
  int4 row_next = (C > 0 && lane < S) ? hregs[lane] : none;
  int cs_next = C > 0 ? hcomp[0] : -1;
  int total_rounds = 0;
  for (int c = 0; c < C; ++c) {
    const int4 row = row_next;
    const int cs = cs_next;
    if (c + 1 < C) {                         // the next step, in flight
      cs_next = hcomp[c + 1];
      if (lane < S) row_next = hregs[static_cast<size_t>(c + 1) * S + lane];
    }
    if (cs < 0) continue;                    // a pad step: no expansion

    // The step, decoded once. Slot s sends word (u, w ^ bit) of its
    // source row to word (v, w) of each row v it applies to: the lane
    // to read it from (srcl), and per row a lane holds the bits of the
    // word it may set (mk: 0 where the slot does not apply to the row).
    const StepMasks sm = decode(row, lane, S, V);
    int srcl[NS];
    uint32_t mk[NS][H];
    uint32_t hi_src = 0u;                    // cas slots reading row a1 >= 32
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const uint32_t bit = 1u << s;
      const int a1 = __shfl_sync(FULL, row.y, s);
      const int a2 = __shfl_sync(FULL, row.z, s);
      const bool cas = sm.cas & bit;
      const int flip = (s >= 5 && s - 5 < LW) ? 1 << (s - 5) : 0;
      const uint32_t m = s < 5 ? has_bit_pattern(s)
                       : (flip && !(wl & flip)) ? 0u : FULL;
      srcl[s] = cas ? ((wl ^ flip) << LV) | (a1 & VMASK)
                    : lane ^ (flip << LV);
      if (VHI && cas && a1 >= 32) hi_src |= bit;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int v = vl + 32 * h;
        const bool app = (sm.rd_any & bit) ||
                         (((sm.rd | sm.wr) & bit) && a1 == v) ||
                         (cas && a2 == v);
        mk[s][h] = app ? m : 0u;
      }
    }

    int rnd = 0;
    bool changed = true;
    while (changed && rnd < S + 2) {
      // the OR of the rows, word by word: the source of every write
      uint32_t any[KW];
#pragma unroll
      for (int wh = 0; wh < KW; ++wh) any[wh] = 0u;
      if (sm.wr) {
#pragma unroll
        for (int wh = 0; wh < KW; ++wh) {
          uint32_t a = g[wh];
          if constexpr (VHI) a |= g[KW + wh];
#pragma unroll
          for (int o = 0; o < LV; ++o) a |= __shfl_xor_sync(FULL, a, 1 << o);
          any[wh] = a;
        }
      }
      uint32_t acc[K];
#pragma unroll
      for (int r = 0; r < K; ++r) acc[r] = 0u;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const uint32_t bit = 1u << s;
        // a free slot runs with empty masks: no branch between slots
        const int j = s - 5 - LW;            // register bit of wh, if >= 0
        const bool from_any = sm.wr & bit;
        const bool from_hi = hi_src & bit;
        const bool is_cas = sm.cas & bit;
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const int h = r / KW, wh = r % KW;
          if (j >= 0 && !((wh >> j) & 1)) continue;
          const int swh = j >= 0 ? wh ^ (1 << j) : wh;
          uint32_t p = g[swh];               // row vl (cas: row a1 < 32)
          if constexpr (VHI) {
            if (is_cas ? from_hi : h == 1) p = g[KW + swh];
          }
          if (from_any) p = any[swh];
          uint32_t x = __shfl_sync(FULL, p, srcl[s]);
          if (s < 5) x <<= (1 << s);
          acc[r] |= x & mk[s][h];
        }
      }

      uint32_t diff = 0u;
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const uint32_t now = g[r] | acc[r];
        diff |= now ^ g[r];
        g[r] = now;
      }
      changed = __any_sync(FULL, diff != 0u);
      ++rnd;
    }
    total_rounds += rnd;

    // the completion deadline: keep configurations that applied cs, and
    // retire its bit
    if (cs >= S) {
#pragma unroll
      for (int r = 0; r < K; ++r) g[r] = 0u;
    } else if (cs < 5) {
      const uint32_t lacks = ~kHasBit[cs];
      const int sh = 1 << cs;
#pragma unroll
      for (int r = 0; r < K; ++r) g[r] = (g[r] >> sh) & lacks;
    } else if (cs - 5 < LW) {
      const int lf = 1 << (LV + cs - 5);
      const bool has = (wl >> (cs - 5)) & 1;
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const uint32_t x = __shfl_xor_sync(FULL, g[r], lf);
        g[r] = has ? 0u : x;
      }
    } else {
      const int jc = cs - 5 - LW;
#pragma unroll
      for (int j = 0; j < LOGKW; ++j) {
        if (j != jc) continue;
#pragma unroll
        for (int r = 0; r < K; ++r) {
          if (r & (1 << j)) continue;
          g[r] = g[r | (1 << j)];
          g[r | (1 << j)] = 0u;
        }
      }
    }
  }
  uint32_t nz = 0u;
#pragma unroll
  for (int r = 0; r < K; ++r) nz |= g[r];
  const bool any_set = __any_sync(FULL, nz != 0u);
  if (lane == 0) {
    valid_out[b] = any_set ? 1 : 0;
    rounds_out[b] = total_rounds;
  }
}

// --------------------------------------------------------------- block

// Word w of "row with slot s applied": bit m set iff m has bit s and the
// row has bit m ^ bit_s.
__device__ __forceinline__ uint32_t lift(const uint32_t* row, int w, int s) {
  if (s >= 5) {
    const int b = 1 << (s - 5);
    return (w & b) ? row[w ^ b] : 0u;
  }
  return (row[w] << (1 << s)) & kHasBit[s];
}

// One block a history; thread t owns words t + k * blockDim.x: it
// computes a round's new values of the first KR of them in registers,
// and of the rest in `scratch`, a shared-memory buffer past the grid.
template <int KR>
__global__ void __launch_bounds__(BLOCK_MAX_THREADS, 1)
dense_block_kernel(const int32_t* __restrict__ regs,
                   const int32_t* __restrict__ comp,
                   uint8_t* __restrict__ valid_out,
                   int32_t* __restrict__ rounds_out, int C, int S, int V) {
  extern __shared__ uint32_t smem[];
  const int log_w = S > 5 ? S - 5 : 0;
  const int W = 1 << log_w;                  // words a row
  const int VW = V * W;
  uint32_t* grid = smem;                     // [V][W]
  uint32_t* any_row = grid + VW;             // [W], the OR of the rows
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int in_regs = KR * nt;               // words whose new value is
  uint32_t* scratch = any_row + W;           // in registers; the rest here

  for (int i = tid; i < VW; i += nt) grid[i] = i == 0 ? 1u : 0u;
  for (int w = tid; w < W; w += nt) any_row[w] = w == 0 ? 1u : 0u;

  const int4* hregs = reinterpret_cast<const int4*>(regs) +
                      static_cast<size_t>(blockIdx.x) * C * S;
  const int32_t* hcomp = comp + static_cast<size_t>(blockIdx.x) * C;
  const int4 none = make_int4(-1, 0, 0, 0);
  int4 row_next = (C > 0 && lane < S) ? hregs[lane] : none;
  int cs_next = C > 0 ? hcomp[0] : -1;
  int total_rounds = 0;
  __syncthreads();                           // the first grid in
  for (int c = 0; c < C; ++c) {
    const int4 row = row_next;
    const int cs = cs_next;
    if (c + 1 < C) {
      cs_next = hcomp[c + 1];
      if (lane < S) row_next = hregs[static_cast<size_t>(c + 1) * S + lane];
    }
    if (cs < 0) continue;
    const StepMasks sm = decode(row, lane, S, V);
    const uint32_t live = sm.rd | sm.wr | sm.cas;

    int rnd = 0, changed = 1;
    while (changed && rnd < S + 2) {
      uint32_t nw[KR];
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        const int i = k * nt + tid;
        nw[k] = i < VW ? grid[i] : 0u;
      }
      for (int i = in_regs + tid; i < VW; i += nt) scratch[i - in_regs] = grid[i];
      uint32_t todo = live;
      while (todo) {
        const int s = __ffs(todo) - 1;
        todo &= todo - 1u;
        const uint32_t bit = 1u << s;
        const int a1 = __shfl_sync(FULL, row.y, s);
        const int a2 = __shfl_sync(FULL, row.z, s);
        // the rows it applies to (-1: every row) and its source row
        // (nullptr: the row itself)
        const int tgt = (sm.rd_any & bit) ? -1 : (sm.cas & bit) ? a2 : a1;
        const uint32_t* src = (sm.rd & bit) ? nullptr
                            : (sm.wr & bit) ? any_row : grid + a1 * W;
#pragma unroll
        for (int k = 0; k < KR; ++k) {
          const int i = k * nt + tid;
          const int v = i >> log_w;
          if (i < VW && (tgt < 0 || v == tgt))
            nw[k] |= lift(src ? src : grid + v * W, i & (W - 1), s);
        }
        for (int i = in_regs + tid; i < VW; i += nt) {
          const int v = i >> log_w;
          if (tgt < 0 || v == tgt)
            scratch[i - in_regs] |= lift(src ? src : grid + v * W, i & (W - 1), s);
        }
      }
      int mine = 0;
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        const int i = k * nt + tid;
        if (i < VW) mine |= nw[k] != grid[i];
      }
      for (int i = in_regs + tid; i < VW; i += nt)
        mine |= scratch[i - in_regs] != grid[i];
      changed = __syncthreads_or(mine);      // every read of the round done
      if (changed) {
#pragma unroll
        for (int k = 0; k < KR; ++k) {
          const int i = k * nt + tid;
          if (i < VW && nw[k] != grid[i]) {
            grid[i] = nw[k];
            atomicOr(any_row + (i & (W - 1)), nw[k]);
          }
        }
        for (int i = in_regs + tid; i < VW; i += nt) {
          const uint32_t now = scratch[i - in_regs];
          if (now != grid[i]) {
            grid[i] = now;
            atomicOr(any_row + (i & (W - 1)), now);
          }
        }
        __syncthreads();                     // every write of the round done
      }
      ++rnd;
    }
    total_rounds += rnd;

    // the completion deadline, on the grid and on the rows' OR alike
    if (cs >= S) {
      for (int i = tid; i < VW; i += nt) grid[i] = 0u;
      for (int w = tid; w < W; w += nt) any_row[w] = 0u;
    } else if (cs < 5) {
      const uint32_t lacks = ~kHasBit[cs];
      const int sh = 1 << cs;
      for (int i = tid; i < VW; i += nt) grid[i] = (grid[i] >> sh) & lacks;
      for (int w = tid; w < W; w += nt)
        any_row[w] = (any_row[w] >> sh) & lacks;
    } else {
      const int b = 1 << (cs - 5);
      for (int i = tid; i < VW; i += nt) {
        if (!(i & b)) {                      // i | b: the same row, word w | b
          grid[i] = grid[i | b];
          grid[i | b] = 0u;
        }
      }
      for (int w = tid; w < W; w += nt) {
        if (!(w & b)) {
          any_row[w] = any_row[w | b];
          any_row[w | b] = 0u;
        }
      }
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

int ceil_log2(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

struct Args {
  const int32_t* regs;
  const int32_t* comp;
  uint8_t* valid;
  int32_t* rounds;
  int B, C, S, V;
};

template <int LW, int LOGK, bool VHI>
cudaError_t launch_warp(const Args& a, int threads, cudaStream_t stream) {
  const int per_block = threads / 32;
  const int blocks = (a.B + per_block - 1) / per_block;
  dense_warp_kernel<LW, LOGK, VHI><<<blocks, threads, 0, stream>>>(
      a.regs, a.comp, a.valid, a.rounds, a.B, a.C, a.S, a.V);
  return cudaGetLastError();
}

template <int LW, bool VHI>
cudaError_t launch_warp_k(const Args& a, int logk, int threads,
                          cudaStream_t stream) {
  switch (logk) {
    case 0:
      if constexpr (!VHI) return launch_warp<LW, 0, VHI>(a, threads, stream);
      break;
    case 1: return launch_warp<LW, 1, VHI>(a, threads, stream);
    case 2: return launch_warp<LW, 2, VHI>(a, threads, stream);
    case 3: return launch_warp<LW, 3, VHI>(a, threads, stream);
    case 4: return launch_warp<LW, 4, VHI>(a, threads, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_warp_tier(const Args& a, int threads,
                             cudaStream_t stream) {
  if (threads < 32 || threads > WARP_MAX_THREADS || threads % 32)
    return cudaErrorInvalidValue;
  const int lv_all = ceil_log2(a.V) < 3 ? 3 : ceil_log2(a.V);
  const bool vhi = lv_all > 5;
  const int lw = vhi ? 0 : 5 - lv_all;
  const int log_w = a.S > 5 ? a.S - 5 : 0;
  const int logk = (log_w > lw ? log_w - lw : 0) + (vhi ? 1 : 0);
  if (logk > WARP_MAX_LOGK) return cudaErrorInvalidValue;
  if (vhi) return launch_warp_k<0, true>(a, logk, threads, stream);
  switch (lw) {
    case 0: return launch_warp_k<0, false>(a, logk, threads, stream);
    case 1: return launch_warp_k<1, false>(a, logk, threads, stream);
    case 2: return launch_warp_k<2, false>(a, logk, threads, stream);
  }
  return cudaErrorInvalidValue;
}

template <int KR>
cudaError_t launch_block(const Args& a, int threads, size_t smem,
                         cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_block_kernel<KR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dense_block_kernel<KR><<<a.B, threads, smem, stream>>>(
      a.regs, a.comp, a.valid, a.rounds, a.C, a.S, a.V);
  return cudaGetLastError();
}

cudaError_t launch_block_tier(const Args& a, int threads,
                              cudaStream_t stream) {
  const int W = a.S > 5 ? 1 << (a.S - 5) : 1;
  const int VW = a.V * W;
  if (threads < 32 || threads > BLOCK_MAX_THREADS || threads % 32 ||
      threads * BLOCK_MAX_WORDS < VW)
    return cudaErrorInvalidValue;
  // words a thread keeps in registers: all of its own up to 8, the rest
  // of the round's new values in shared memory past the grid
  int log_kr = ceil_log2((VW + threads - 1) / threads);
  while ((1 << log_kr) > BLOCK_MAX_REG_WORDS) --log_kr;
  const int scratch = VW - (threads << log_kr);
  const size_t smem = sizeof(uint32_t) *
      (static_cast<size_t>(VW) + W + (scratch > 0 ? scratch : 0));
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  switch (log_kr) {
    case 0: return launch_block<1>(a, threads, smem, stream);
    case 1: return launch_block<2>(a, threads, smem, stream);
    case 2: return launch_block<4>(a, threads, smem, stream);
    case 3: return launch_block<8>(a, threads, smem, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Launch on `stream` of `device`: regs [B,C,S,4] int32, comp [B,C] int32,
// valid [B] bytes and rounds [B] int32 written. `tier` 0 is the warp
// tier (`threads` = 32 a history a block, <= 256), 1 the block tier
// (`threads` a history, <= 1,024, at least a 32nd of V * 2^S / 32 words).
// Returns a cudaError_t (0 on success): cudaErrorInvalidValue for
// arguments outside these bounds (a grid too large for the warp tier
// among them), else cudaGetLastError() right after the launch.
extern "C" int knossos_dense_launch(const void* regs, const void* comp,
                                    void* valid, void* rounds, int B, int C,
                                    int S, int V, int tier, int threads,
                                    int device, void* stream) {
  if (B <= 0 || C < 0 || S < 1 || S > MAX_SLOTS || V < 1 ||
      V > MAX_VALUES || (tier != 0 && tier != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // this library carries its own (static) CUDA runtime, whose current
  // device is not PyTorch's: name the tensor's device explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const int32_t*>(regs),
               static_cast<const int32_t*>(comp),
               static_cast<uint8_t*>(valid), static_cast<int32_t*>(rounds),
               B, C, S, V};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = tier == 0 ? launch_warp_tier(a, threads, st)
                  : launch_block_tier(a, threads, st);
  return static_cast<int>(err);
}

// The CUDA runtime's text for an error code returned above.
extern "C" const char* knossos_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
