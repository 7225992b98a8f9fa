// closure_square: one boolean closure round over a batch of reachability
// matrices, out[b,i,j] = OR_k (m[b,i,k] AND m[b,k,j]), with the round's
// transposed result and a per-history "did anything change" flag.
//
// Replaces the Pallas TPU kernel jepsen_tpu/checker/elle/pallas_square.py
// (closure_square, body _square_kernel). That kernel casts the bool tiles
// to bf16/int8, accumulates a 256x256 MXU product over a sequential k grid
// axis in VMEM and thresholds it at the last k step; the fixpoint test
// (jnp.any(m2 != m) in kernels._closure_batched) is a second pass. Here
// both live in one kernel.
//
// Bound on an H100: 2*B*T^3 multiply-adds against ~5*B*T^2 bytes, so at
// the closure's shapes (T in the thousands) operations bound it, at the
// int8 tensor-core rate. Design:
//
//  * Tensor cores on the bytes as they are. A torch.bool byte is 0 or 1,
//    so wgmma.mma_async .u8 x .u8 -> .s32 computes the path counts
//    exactly (a count is at most T <= 32768) with no cast pass, and the
//    epilogue thresholds them at > 0.
//  * Both operands K-major. 8-bit wgmma cannot transpose in shared
//    memory, so B is read from the rows of m^T: the kernel takes (m, mT)
//    and writes (out, outT), the transposed tile staged through shared
//    memory, so the next round has both layouts without another pass.
//  * A TMA ring with warp specialisation. One producer thread keeps
//    STAGES stages of [128 x 128] A and [256 x 128] B bytes in flight
//    (cp.async.bulk.tensor, 128-byte swizzle, mbarrier full/empty
//    pairs); two consumer warpgroups each run m64n256k32 on their 64
//    rows, 128 s32 accumulators a thread, with setmaxnreg moving
//    registers from the producer to them.
//  * A persistent grid, one CTA per SM, walking 128x256 output tiles in
//    grouped order (GROUP_M row panels at a time) so neighbouring tiles'
//    A and B panels come from L2 rather than HBM. The descriptors are
//    3-D over [B,T,T], so no tile crosses histories; at T = 128 * odd
//    the ragged N tile is zero-filled on load and clipped on store.
//  * The changed flag in the epilogue. The m tile at (i,j) is loaded by
//    TMA into the output staging buffer while the mainloop runs; each
//    thread compares its outputs with it, the consumers OR-reduce at
//    their barrier (bar.red.or), and one thread sets changed[b]. This is
//    the reference's any(m2 != m), no reflexivity assumed.
//
//  * The closure loop's condition on the device. An optional int32
//    pair `active` replaces the host's per-round "did anything change"
//    read (the reference's lax.while_loop condition): every thread reads
//    active[0] first; when it is 0 the round is skipped, and the launch
//    only copies m to out and mT to outT (16-byte words, grid-stride),
//    so a skipped round costs one pass over the four matrices; when it
//    is nonzero the round squares as above and a changed history also
//    sets active[1], the next round's word. A loop thus enqueues every
//    round of a closure and reads nothing back until it resolves.
//
//  * A column range for a model-parallel split. closure_square_cols_launch
//    computes only the output columns [c0, c1) of each history (c0 a
//    multiple of BN, c1 one too or T): out[b,:,c0:c1] and its transpose
//    outT[b,c0:c1,:], reading all of m and rows c0..c1 of mT, with the
//    changed flag over those columns. Its grid walks B * T/BM *
//    (c1-c0)/BN tiles; a skipped round copies just that block. Several
//    devices, each given one block, together compute the whole round;
//    the full round is the range [0, T).
//
// Input bytes must be 0 or 1; output bytes are 0 or 1; changed[b] is
// set to 1 where out[b] != m[b] and left as the caller zeroed it
// elsewhere. T must be a multiple of 128, layouts [B,T,T] contiguous.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;            // output tile rows (2 warpgroups x 64)
constexpr int BN = 256;            // output tile columns (one wgmma N)
constexpr int BK = 128;            // k bytes per stage: one 128B swizzle row
constexpr int STAGES = 3;
constexpr int GROUP_M = 8;         // row panels walked together
constexpr int THREADS = 384;       // producer warpgroup + 2 consumers
constexpr int A_BYTES = BM * BK;   // 16 KB
constexpr int B_BYTES = BN * BK;   // 32 KB
constexpr int OUT_BYTES = BM * BN; // 32 KB, also the m tile
constexpr int OFF_A = 0;
constexpr int OFF_B = OFF_A + STAGES * A_BYTES;
constexpr int OFF_OUT = OFF_B + STAGES * B_BYTES;   // two [128][128] halves
constexpr int OFF_OUTT = OFF_OUT + OUT_BYTES;       // [256][128]
constexpr int OFF_BAR = OFF_OUTT + OUT_BYTES;
constexpr int SMEM_BYTES = OFF_BAR + 64 + 1024;     // + 1024B alignment slack

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the phase of `bar` with this parity to complete. A wait that
// outlasts every legitimate one by orders of magnitude (an arrival that
// will never come) traps, so a fault fails the launch instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n) {
    if (n == (1u << 26)) __trap();
  }
}

// TMA tile load of box (c0, c1, c2) into shared memory, completing on bar
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row core
// groups 1024 bytes apart (SBO), LBO unused for this layout
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

#define D4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define D16(i) D4(i), D4(i + 4), D4(i + 8), D4(i + 12)
#define D64(i) D16(i), D16(i + 16), D16(i + 32), D16(i + 48)

// d[64x256 s32] (+)= A[64x32 u8] * B[256x32 u8]^T; scale_d 0 overwrites
__device__ __forceinline__ void wgmma_u8(uint32_t (&d)[128], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
      "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, "
      "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, %128, %129, p;\n"
      "}\n"
      : D64(0), D64(64)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef D64
#undef D16
#undef D4

// tile t of the batch -> (history, row tile, column tile), GROUP_M row
// tiles at a time so that concurrently running CTAs share panels in L2
__device__ __forceinline__ void tile_coords(int t, int tm, int tn, int& b,
                                            int& mi, int& ni) {
  const int per = tm * tn;
  b = t / per;
  const int w = t - b * per;
  const int span = GROUP_M * tn;
  const int g = w / span;
  const int first = g * GROUP_M;
  const int gs = min(GROUP_M, tm - first);
  const int r = w - g * span;
  mi = first + r % gs;
  ni = r / gs;
}

// byte offset of (row, col) in a tile of 128-byte rows written by TMA
// with 128-byte swizzle: 16-byte chunk index XOR row % 8
__device__ __forceinline__ int sw128(int row, int col) {
  return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}

__global__ void __launch_bounds__(THREADS, 1)
closure_square_kernel(const __grid_constant__ CUtensorMap tm_m,
                      const __grid_constant__ CUtensorMap tm_mT,
                      const __grid_constant__ CUtensorMap tm_out,
                      const __grid_constant__ CUtensorMap tm_outT,
                      const uint4* __restrict__ m_words,
                      const uint4* __restrict__ mT_words,
                      uint4* __restrict__ out_words,
                      uint4* __restrict__ outT_words,
                      uint8_t* __restrict__ changed, int* active, int B,
                      int T, int c0, int c1) {
  if (active != nullptr && *reinterpret_cast<volatile int*>(active) == 0) {
    // a skipped round: out = m, outT = mT over the launch's columns,
    // nothing else written. The word is uniform across the grid, so
    // every thread takes this branch or none does, before any barrier
    // is touched.
    const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
    const size_t first = static_cast<size_t>(blockIdx.x) * blockDim.x +
                         threadIdx.x;
    if (c0 == 0 && c1 == T) {
      const size_t n = static_cast<size_t>(B) * T * T / 16;
      for (size_t i = first; i < n; i += stride) {
        const uint4 a = m_words[i];
        const uint4 c = mT_words[i];
        out_words[i] = a;
        outT_words[i] = c;
      }
      return;
    }
    // out: columns c0..c1 of every row; outT: rows c0..c1, contiguous
    const size_t row_words = static_cast<size_t>(T) / 16;
    const size_t span = static_cast<size_t>(c1 - c0) / 16;
    const size_t n_out = static_cast<size_t>(B) * T * span;
    for (size_t i = first; i < n_out; i += stride) {
      const size_t w = (i / span) * row_words + c0 / 16 + i % span;
      out_words[w] = m_words[w];
    }
    const size_t block = span * T;           // words of one history's rows
    const size_t n_outT = static_cast<size_t>(B) * block;
    for (size_t i = first; i < n_outT; i += stride) {
      const size_t w = (i / block) * row_words * T +
                       static_cast<size_t>(c0) * row_words + i % block;
      outT_words[w] = mT_words[w];
    }
    return;
  }
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_base = smem_addr(smem);
  const uint32_t bar_full = s_base + OFF_BAR;         // STAGES x 8 bytes
  const uint32_t bar_empty = bar_full + STAGES * 8;   // STAGES x 8 bytes
  const uint32_t bar_epi = bar_empty + STAGES * 8;    // the m tile

  const int tm = T / BM;
  const int tn = (c1 - c0 + BN - 1) / BN;
  const int n_tiles = B * tm * tn;
  const int nk = T / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);   // every consumer warp releases
    }
    mbar_init(bar_epi, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int b, mi, ni;
        tile_coords(t, tm, tn, b, mi, ni);
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(bar_empty + 8 * stage, phase ^ 1);
          const uint32_t full = bar_full + 8 * stage;
          mbar_expect_tx(full, A_BYTES + B_BYTES);
          tma_load(&tm_m, s_base + OFF_A + stage * A_BYTES, full, kb * BK,
                   mi * BM, b);
          tma_load(&tm_mT, s_base + OFF_B + stage * B_BYTES, full, kb * BK,
                   c0 + ni * BN, b);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumer warpgroups 1 and 2: rows (wg-1)*64 .. +63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int ct = threadIdx.x - 128;       // 0..255 among consumers
    const int lane = threadIdx.x % 32;
    const int row0 = (wg - 1) * 64 + ((threadIdx.x / 32) % 4) * 16 + lane / 4;
    const int q2 = (lane % 4) * 2;
    uint8_t* s_out = smem + OFF_OUT;
    uint8_t* s_outT = smem + OFF_OUTT;
    uint32_t d[128];
#pragma unroll
    for (int r = 0; r < 128; ++r) d[r] = 0u;
    int stage = 0;
    uint32_t phase = 0;
    uint32_t epi_phase = 0;

    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int b, mi, ni;
      tile_coords(t, tm, tn, b, mi, ni);
      const int i0 = mi * BM;
      const int j0 = c0 + ni * BN;
      const int halves = (j0 + 128 < c1) ? 2 : 1;  // live 128-col halves
      if (ct == 0) {
        // the previous tile's stores must have read the staging buffers
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        mbar_expect_tx(bar_epi, halves * (BM * 128));
        for (int h = 0; h < halves; ++h) {
          tma_load(&tm_m, s_base + OFF_OUT + h * (BM * 128), bar_epi,
                   j0 + h * 128, i0, b);
        }
      }

      int prev = -1;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(bar_full + 8 * stage, phase);
        const uint32_t a = s_base + OFF_A + stage * A_BYTES + (wg - 1) * 64 * BK;
        const uint32_t bb = s_base + OFF_B + stage * B_BYTES;
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < BK / 32; ++ks) {
          wgmma_u8(d, sw128_desc(a + ks * 32), sw128_desc(bb + ks * 32),
                   (kb > 0 || ks > 0) ? 1 : 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        // keep this stage's group in flight; the previous one is done
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        if (prev >= 0 && lane == 0) mbar_arrive(bar_empty + 8 * prev);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      // the accumulators are final only now: keep their reads below
#pragma unroll
      for (int r = 0; r < 128; ++r) asm volatile("" : "+r"(d[r])::"memory");
      if (lane == 0) mbar_arrive(bar_empty + 8 * prev);

      // epilogue: threshold, compare with m's tile, stage out and out^T
      mbar_wait(bar_epi, epi_phase);
      epi_phase ^= 1;
      const int live_cols = c1 - j0;
      uint32_t diff = 0;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int col = c * 8 + q2;
        const uint32_t v00 = d[4 * c] != 0u, v01 = d[4 * c + 1] != 0u;
        const uint32_t v10 = d[4 * c + 2] != 0u, v11 = d[4 * c + 3] != 0u;
        uint16_t* p0 = reinterpret_cast<uint16_t*>(
            s_out + (col >> 7) * (BM * 128) + sw128(row0, col & 127));
        uint16_t* p1 = reinterpret_cast<uint16_t*>(
            s_out + (col >> 7) * (BM * 128) + sw128(row0 + 8, col & 127));
        const uint16_t n0 = static_cast<uint16_t>(v00 | (v01 << 8));
        const uint16_t n1 = static_cast<uint16_t>(v10 | (v11 << 8));
        if (col < live_cols) diff |= (*p0 ^ n0) | (*p1 ^ n1);
        *p0 = n0;
        *p1 = n1;
        s_outT[sw128(col, row0)] = static_cast<uint8_t>(v00);
        s_outT[sw128(col + 1, row0)] = static_cast<uint8_t>(v01);
        s_outT[sw128(col, row0 + 8)] = static_cast<uint8_t>(v10);
        s_outT[sw128(col + 1, row0 + 8)] = static_cast<uint8_t>(v11);
      }
      // make the generic-proxy writes visible to the TMA stores, then
      // OR the threads' diffs at the consumers' barrier
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      uint32_t any;
      asm volatile(
          "{\n"
          ".reg .pred p, q;\n"
          "setp.ne.u32 q, %1, 0;\n"
          "bar.red.or.pred p, 1, 256, q;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}"
          : "=r"(any)
          : "r"(diff)
          : "memory");
      if (ct == 0) {
        if (any) {
          *reinterpret_cast<volatile uint8_t*>(changed + b) = 1;
          if (active != nullptr) {
            *reinterpret_cast<volatile int*>(active + 1) = 1;
          }
        }
        for (int h = 0; h < halves; ++h) {
          tma_store(&tm_out, s_base + OFF_OUT + h * (BM * 128), j0 + h * 128,
                    i0, b);
        }
        tma_store(&tm_outT, s_base + OFF_OUTT, i0, j0, b);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    }
    if (ct == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, through the runtime's entry
// point query (the library does not link libcuda)
cudaError_t encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr) {
      return cudaErrorSymbolNotFound;
    }
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// a [B,T,T] byte tensor as a 3-D map with box (box0 cols, box1 rows, 1)
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int B,
              int T, int box0, int box1) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(T),
                                 static_cast<cuuint64_t>(T) * T};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box0),
                             static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

namespace {

// one closure round over the output columns [c0, c1) (see below)
int launch(const void* m, const void* mT, void* out, void* outT,
           void* changed, void* active, int B, int T, int c0, int c1,
           int device, void* stream) {
  if (B <= 0 || T <= 0 || T % BM != 0 || c0 < 0 || c0 % BN != 0 ||
      c1 <= c0 || c1 > T || (c1 % BN != 0 && c1 != T)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // this library carries its own (static) CUDA runtime, whose current
  // device is not PyTorch's: name the tensor's device explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  EncodeTiled encode;
  err = encode_fn(&encode);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tm_m, tm_mT, tm_out, tm_outT;
  if (!make_map(encode, &tm_m, m, B, T, BK, BM) ||
      !make_map(encode, &tm_mT, mT, B, T, BK, BN) ||
      !make_map(encode, &tm_out, out, B, T, 128, BM) ||
      !make_map(encode, &tm_outT, outT, B, T, BM, BN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaFuncSetAttribute(closure_square_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_tiles =
      static_cast<long long>(B) * (T / BM) * ((c1 - c0 + BN - 1) / BN);
  const int grid = static_cast<int>(n_tiles < sms ? n_tiles : sms);
  closure_square_kernel<<<grid, THREADS, SMEM_BYTES,
                          static_cast<cudaStream_t>(stream)>>>(
      tm_m, tm_mT, tm_out, tm_outT, static_cast<const uint4*>(m),
      static_cast<const uint4*>(mT), static_cast<uint4*>(out),
      static_cast<uint4*>(outT), static_cast<uint8_t*>(changed),
      static_cast<int*>(active), B, T, c0, c1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch one closure round on `stream` (a cudaStream_t of `device`): m and
// mT (= m transposed per history) are device pointers to B contiguous
// T x T byte matrices; out and outT receive the round and its transpose;
// changed (B bytes, zeroed by the caller) gets 1 where out[b] != m[b].
// active (null, or two device int32 words) makes the round conditional:
// skipped when active[0] == 0 (out = m, outT = mT), and a changed
// history sets active[1]. Returns a cudaError_t (0 on success); it never
// synchronises.
extern "C" int closure_square_launch(const void* m, const void* mT, void* out,
                                     void* outT, void* changed, void* active,
                                     int B, int T, int device, void* stream) {
  return launch(m, mT, out, outT, changed, active, B, T, 0, T, device,
                stream);
}

// closure_square_launch over the output columns [c0, c1) of each history
// only: out[b,:,c0:c1], outT[b,c0:c1,:] (both [B,T,T] buffers, the rest
// left as it was), changed[b] = 1 where those columns changed, a skipped
// round copying just that block. c0 is a multiple of 256 (the column
// tile), c1 one too or T; a bad range returns cudaErrorInvalidValue.
extern "C" int closure_square_cols_launch(const void* m, const void* mT,
                                          void* out, void* outT,
                                          void* changed, void* active, int B,
                                          int T, int c0, int c1, int device,
                                          void* stream) {
  return launch(m, mT, out, outT, changed, active, B, T, c0, c1, device,
                stream);
}

// The CUDA runtime's text for an error code returned above.
extern "C" const char* closure_square_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
