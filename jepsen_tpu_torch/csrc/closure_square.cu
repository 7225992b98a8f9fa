// closure_square: one boolean closure round over a batch of reachability
// matrices, out[b,i,j] = OR_k (m[b,i,k] AND m[b,k,j]).
//
// Replaces the Pallas TPU kernel jepsen_tpu/checker/elle/pallas_square.py
// (closure_square, body _square_kernel). That kernel casts the bool tiles
// to bf16/int8, accumulates a 256x256 MXU product over a sequential k grid
// axis in VMEM and thresholds it at the last k step. Nothing here carries
// that block structure over: blocks run in parallel and in no order on
// Hopper, so each block owns one output tile and loops over k itself, and
// no sum is formed at all — the product is an OR of ANDs on bytes, exact
// for any T.
//
// Bound on an H100: the work is 2*B*T^3 boolean multiply-adds against
// 3*B*T^2 bytes moved, so at the closure's shapes (T in the thousands) it
// is bound by operations, not by memory. This first kernel makes the
// operations cheap without tensor cores: a thread owns an 8x8 block of
// output bytes kept as 16 32-bit words (4 output bools per word), and for
// each k it does two 8-byte shared-memory loads, replicates each of its 8
// A bytes across a word with one byte-permute, and folds the B word in
// with AND+OR (one LOP3) — about 26 instructions per 64 output/k pairs.
// A block computes a 128x128 output tile from 32-deep stages of the A row
// panel (stored transposed, so a thread's 8 rows are one 8-byte load) and
// the B column panel. wgmma on bit-packed or int8 operands, TMA staging
// and folding the fixpoint's changed flag into the epilogue are later work.
//
// Input bytes must be 0 or 1 (a torch.bool tensor viewed as uint8); the
// output bytes are 0 or 1. T must be a multiple of 128 (the port pads
// every batch to that multiple), layout [B,T,T] contiguous.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;          // output tile edge, rows and columns
constexpr int BK = 32;             // k depth of one shared-memory stage
constexpr int THREADS = 256;       // 16 x 16 threads, 8 x 8 outputs each
constexpr int A_STRIDE = TILE + 8; // bytes per k row of the transposed A panel

__global__ void __launch_bounds__(THREADS)
closure_square_kernel(const uint8_t* __restrict__ m,
                      uint8_t* __restrict__ out, int T) {
  // As[k][i] = m[b, i0 + i, k0 + k]   (A row panel, transposed)
  // Bs[k][j] = m[b, k0 + k, j0 + j]   (B column panel)
  __shared__ __align__(16) uint8_t As[BK][A_STRIDE];
  __shared__ __align__(16) uint8_t Bs[BK][TILE];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx*8 .. tx*8+7
  const int ty = tid / 16;  // output rows ty*8 .. ty*8+7
  const size_t plane = static_cast<size_t>(T) * T;
  const uint8_t* mb = m + blockIdx.z * plane;
  const int i0 = blockIdx.y * TILE;
  const int j0 = blockIdx.x * TILE;

  // acc[r][h]: output row ty*8+r, columns tx*8+4h .. tx*8+4h+3, one
  // byte each
  uint32_t acc[8][2];
#pragma unroll
  for (int r = 0; r < 8; ++r) acc[r][0] = acc[r][1] = 0u;

  for (int k0 = 0; k0 < T; k0 += BK) {
    // A row panel: 128 rows x 32 bytes = 1024 words, 4 per thread;
    // neighbouring threads read neighbouring words of one row
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int w = tid + q * THREADS;
      const int row = w / 8;
      const int kw = w % 8;
      const uint32_t v = *reinterpret_cast<const uint32_t*>(
          mb + static_cast<size_t>(i0 + row) * T + k0 + kw * 4);
      As[kw * 4 + 0][row] = static_cast<uint8_t>(v);
      As[kw * 4 + 1][row] = static_cast<uint8_t>(v >> 8);
      As[kw * 4 + 2][row] = static_cast<uint8_t>(v >> 16);
      As[kw * 4 + 3][row] = static_cast<uint8_t>(v >> 24);
    }
    // B column panel: 32 rows x 128 bytes = 1024 words, 4 per thread
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int w = tid + q * THREADS;
      const int row = w / 32;
      const int cw = w % 32;
      *reinterpret_cast<uint32_t*>(&Bs[row][cw * 4]) =
          *reinterpret_cast<const uint32_t*>(
              mb + static_cast<size_t>(k0 + row) * T + j0 + cw * 4);
    }
    __syncthreads();

#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const uint2 a = *reinterpret_cast<const uint2*>(&As[k][ty * 8]);
      const uint2 b = *reinterpret_cast<const uint2*>(&Bs[k][tx * 8]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // byte r of the A word replicated into all four bytes: 0x01010101
        // when m[i,k] is set, else 0 — ANDed with four B bytes at once
        const uint32_t lo = __byte_perm(a.x, 0u, r * 0x1111);
        const uint32_t hi = __byte_perm(a.y, 0u, r * 0x1111);
        acc[r][0] |= b.x & lo;
        acc[r][1] |= b.y & lo;
        acc[r + 4][0] |= b.x & hi;
        acc[r + 4][1] |= b.y & hi;
      }
    }
    __syncthreads();
  }

  uint8_t* ob = out + blockIdx.z * plane;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    *reinterpret_cast<uint2*>(
        ob + static_cast<size_t>(i0 + ty * 8 + r) * T + j0 + tx * 8) =
        make_uint2(acc[r][0], acc[r][1]);
  }
}

}  // namespace

// Launch one closure round on `stream` (a cudaStream_t of `device`): m and
// out are device pointers to B contiguous T x T byte matrices. Returns the
// cudaError_t of the launch (0 on success); it never synchronises.
extern "C" int closure_square_launch(const void* m, void* out, int B, int T,
                                     int device, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || T % TILE != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // this library carries its own (static) CUDA runtime, whose current
  // device is not PyTorch's: name the tensor's device explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(T / TILE, T / TILE, B);
  closure_square_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(m), static_cast<uint8_t*>(out), T);
  return static_cast<int>(cudaGetLastError());
}

// The CUDA runtime's text for an error code returned above.
extern "C" const char* closure_square_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
