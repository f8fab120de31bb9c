// K4: the block-balanced grouped GEMM of the Accel-GCN MoE dispatch on
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_gmm_kernel` of
// src/repro/kernels/grouped_matmul.py, driven there by `grouped_matmul`.
//
//   x            TX[M, K]   rows sorted by expert and padded per expert to
//                           m_tile-row blocks; row-major, contiguous
//   w            TW[E, K, N] expert weights; row-major, contiguous
//   block_expert int32[M / m_tile]  expert of each row block, in [0, E)
//   out          f32[M, N]  out[b-th block rows] = x[those rows] @ w[e_b]
//
// TX and TW are each float or __nv_bfloat16; every product and sum is fp32.
//
// Design:
//   * one CTA of 256 threads per (row block b, 128-column output tile). The
//     CTA reads block_expert[b] once and takes its weight pointer from it:
//     the paper's "all warps deduce their workload from one block record",
//     which replaces the TPU's scalar-prefetched BlockSpec index_map. A
//     block longer than 128 rows is walked in 128-row chunks; rows past
//     the block (m_tile < 128) are masked;
//   * the K loop stages a 128 x 16 tile of x (transposed) and a 16 x 128
//     tile of w through shared memory as fp32, two stages deep: the global
//     loads of stage k + 1 are in flight in registers, in the operands' own
//     types, while stage k is multiplied, and are converted to fp32 only
//     when stored;
//   * each thread owns an 8 x 8 register tile of the output (rows
//     4ty..4ty+3 and 64+4ty..64+4ty+3, likewise for columns), read from
//     shared memory as float4s without bank conflicts, and accumulates each
//     output with fmaf over k in order 0..K-1: one rounding per term;
//   * ragged K and N (any size, not only multiples of 4) are masked with
//     zeros on load and on store.
//
// Bound on an H100: operations at the MoE shapes. The wi product of
// dbrx-132b at 4,096 tokens (M = 18,432, K = 6,144, N = 10,752) is 2.435
// TFLOP against 3.1 GB of compulsory traffic. With bf16 operands every
// product is exact in fp32, so a bf16 tensor-core kernel with fp32
// accumulation (mma.sync or wgmma) computes this same function, differing
// only in summation order: the bound for bf16 operands is therefore the
// 989 TFLOP/s bf16 tensor-core rate (2.46 ms), for fp32 operands the
// 67 TFLOP/s CUDA-core rate (36.3 ms). This kernel runs on the CUDA cores;
// tensor cores, TMA and a persistent schedule are later work.
//
// Offsets are 64-bit: E * K * N is 1.06e9 at these widths, and M * K
// passes 2^31 at large token counts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // rows of a CTA tile
constexpr int kBN = 128;      // columns of a CTA tile
constexpr int kBK = 16;       // depth of one shared-memory stage
constexpr int kThreads = 256;
constexpr int kPad = 4;       // spreads the transposed x stores over banks
constexpr int kLoads = kBM * kBK / kThreads;   // elements per thread per tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                      const int32_t* __restrict__ block_expert,
                      float* __restrict__ out, int m_tile, int64_t K,
                      int64_t N, int n_col_tiles) {
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][kBN];

  const int64_t b = blockIdx.x / n_col_tiles;
  const int64_t c0 = (int64_t)(blockIdx.x % n_col_tiles) * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const TW* __restrict__ we = w + (int64_t)block_expert[b] * K * N;
  const int n_k = (int)((K + kBK - 1) / kBK);

  for (int r0 = 0; r0 < m_tile; r0 += kBM) {
    const int64_t row0 = b * m_tile + r0;   // first row of this chunk
    const int rows = min(kBM, m_tile - r0);
    // The next stage is held in registers in the operands' own types and
    // converted only when stored: a conversion right after the load would
    // wait for it, and the loads would no longer overlap the FMAs.
    TX xr[kLoads];
    TW wr[kLoads];

    auto load = [&](int64_t k0) {
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int idx = i * kThreads + tid;
        const int r = idx / kBK, kk = idx % kBK;     // x: 16 k per row
        const int wk = idx / kBN, c = idx % kBN;     // w: 128 n per k
        xr[i] = (r < rows && k0 + kk < K) ? x[(row0 + r) * K + k0 + kk]
                                          : zero_of<TX>();
        wr[i] = (k0 + wk < K && c0 + c < N) ? we[(k0 + wk) * N + c0 + c]
                                            : zero_of<TW>();
      }
    };
    auto store = [&](int s) {
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int idx = i * kThreads + tid;
        As[s][idx % kBK][idx / kBK] = to_f32(xr[i]);
        Bs[s][idx / kBN][idx % kBN] = to_f32(wr[i]);
      }
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    load(0);
    store(0);
    __syncthreads();
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt & 1;
      const bool more = kt + 1 < n_k;
      if (more) load((int64_t)(kt + 1) * kBK);
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[s][kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[s][kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[s][kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[s][kk][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      // Stage s^1 was last read in iteration kt - 1, which every thread
      // finished before the barrier that ended it.
      if (more) store(s ^ 1);
      __syncthreads();
    }

    // Write the 8 x 8 tile; float4 stores when every row starts 16-byte
    // aligned (N % 4 == 0), so a 4-column group is either all in or all out.
    const bool vec = (N & 3) == 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
      if (r >= rows) continue;
      float* orow = out + (row0 + r) * N;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t c = c0 + h * 64 + tx * 4;
        if (vec) {
          if (c < N)
            *reinterpret_cast<float4*>(orow + c) =
                make_float4(acc[i][h * 4], acc[i][h * 4 + 1],
                            acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < N) orow[c + j] = acc[i][h * 4 + j];
        }
      }
    }
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, const void* block_expert,
                   void* out, long long n_blocks, int m_tile, long long K,
                   long long N, cudaStream_t stream) {
  const int n_col_tiles = (int)((N + kBN - 1) / kBN);
  const unsigned grid = (unsigned)(n_blocks * n_col_tiles);
  grouped_matmul_kernel<TX, TW><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<const int32_t*>(block_expert), static_cast<float*>(out),
      m_tile, (int64_t)K, (int64_t)N, n_col_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Output columns one CTA covers: the wrapper checks that
// n_blocks * ceil(N / cols) fits the grid.
int grouped_matmul_cols_per_cta() { return kBN; }

// Launches K4 on `stream`; x_bf16 / w_bf16 select bf16 (1) or fp32 (0)
// operands. Returns cudaGetLastError() after the launch (0 when the
// launch was accepted). The caller checks shapes, types and contiguity.
int grouped_matmul_launch(const void* x, const void* w,
                          const void* block_expert, void* out, int x_bf16,
                          int w_bf16, long long n_blocks, int m_tile,
                          long long K, long long N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_bf16 && w_bf16)
    e = launch<__nv_bfloat16, __nv_bfloat16>(x, w, block_expert, out,
                                             n_blocks, m_tile, K, N, s);
  else if (x_bf16)
    e = launch<__nv_bfloat16, float>(x, w, block_expert, out, n_blocks,
                                     m_tile, K, N, s);
  else if (w_bf16)
    e = launch<float, __nv_bfloat16>(x, w, block_expert, out, n_blocks,
                                     m_tile, K, N, s);
  else
    e = launch<float, float>(x, w, block_expert, out, n_blocks, m_tile, K,
                             N, s);
  return (int)e;
}

const char* grouped_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
