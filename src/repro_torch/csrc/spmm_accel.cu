// K1: the Accel-GCN block-slab SpMM on Hopper (sm_90a), X read straight
// from device memory.
//
// Replaces the Pallas TPU kernel `_spmm_kernel` of
// src/repro/kernels/spmm_accel.py together with its `scatter_block_rows`
// epilogue. Inputs and the fused epilogue: slab_common.cuh.
//
// Design (the paper's GPU design, not the TPU's one-hot matmul):
//   * one CTA per (block b, feature tile). The tile is the combined warp:
//     thread t owns column tile * f_tile + t, so the 32 lanes of a warp read
//     32 neighbouring floats of each gathered X row (one 128-byte line);
//   * the CTA stages its block's C slots in shared memory, finds the last
//     live (non-zero) slot, and skips the gather entirely for the all-zero
//     padding blocks that bucketing appends;
//   * each thread walks the live slots in order, keeps a running sum in a
//     register while the local row stays the same and flushes it into a
//     shared [R, f_tile] tile when the row changes. A column has one
//     writer, so the intra-block reduction needs no atomics;
//   * the X loads of kUnroll slots are issued before any of them is used,
//     so every thread keeps several independent gathers in flight;
//   * fused epilogue: each live local row is added into out[out_row] with
//     a fp32 atomicAdd.
//
// Bound on an H100: memory. Per call the kernel must read X's referenced
// rows once (N * F * 4 bytes), write out once (n_rows * F * 4) and read the
// slabs once (B * (3 * C + R) * 4); its arithmetic is 2 flops per slot and
// column, far below the fp32 rate. Offsets into X and out are 64-bit:
// a fused dispatch may index more than 2^31 elements.

#include "slab_common.cuh"

namespace {

constexpr int kUnroll = 8;

__global__ void spmm_block_slabs_kernel(
    const int32_t* __restrict__ colidx, const float* __restrict__ values,
    const int32_t* __restrict__ rowloc, const int32_t* __restrict__ out_row,
    const float* __restrict__ x, float* __restrict__ out,
    int C, int R, int64_t F, int n_rows, int n_ftiles) {
  extern __shared__ float smem[];
  const int f_tile = blockDim.x;
  float* acc = smem;                                               // [R, f_tile]
  int32_t* s_col = reinterpret_cast<int32_t*>(acc + (size_t)R * f_tile);  // [C]
  float* s_val = reinterpret_cast<float*>(s_col + C);             // [C]
  int32_t* s_row = reinterpret_cast<int32_t*>(s_val + C);         // [C]
  int32_t* s_out = s_row + C;                                      // [R]
  __shared__ int s_live;

  const int64_t b = blockIdx.x / n_ftiles;
  const int tile = blockIdx.x % n_ftiles;
  const int t = threadIdx.x;
  const int64_t f = (int64_t)tile * f_tile + t;
  const bool f_ok = f < F;

  for (int r = 0; r < R; ++r) acc[r * f_tile + t] = 0.f;
  const int n_live = slab::stage_block(colidx, values, rowloc, out_row, b, C,
                                       R, s_col, s_val, s_row, s_out, &s_live);
  if (n_live == 0) return;  // all-zero block: it adds nothing anywhere

  slab::RowRun run;
  for (int c0 = 0; c0 < n_live; c0 += kUnroll) {
    float xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u;
      xv[u] = (f_ok && c < n_live && s_val[c] != 0.f)
                  ? __ldg(x + (int64_t)s_col[c] * F + f)
                  : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u;
      if (c < n_live && s_val[c] != 0.f)
        run.add(s_row[c], s_val[c], xv[u], acc, f_tile, t);
    }
  }
  run.flush(acc, f_tile, t);

  // Each thread reads back only its own column of acc: no barrier needed.
  if (!f_ok) return;
  slab::add_block_rows(acc, s_out, out, R, f_tile, t, F, f, n_rows);
}

}  // namespace

extern "C" {

// Shared memory one CTA needs, in bytes.
long long spmm_block_slabs_smem_bytes(int C, int R, int f_tile) {
  return (long long)R * f_tile * 4 + 3LL * C * 4 + (long long)R * 4;
}

// CTAs one SM holds at once (-1 if the runtime refuses to say).
int spmm_block_slabs_ctas_per_sm(int C, int R, int f_tile) {
  return slab::ctas_per_sm(spmm_block_slabs_kernel, f_tile,
                           spmm_block_slabs_smem_bytes(C, R, f_tile));
}

// Launches K1 on `stream`. Returns cudaGetLastError() after the launch
// (0 when the launch was accepted). The caller checks shapes, types and
// that B * n_ftiles fits the grid.
int spmm_block_slabs_launch(const void* colidx, const void* values,
                            const void* rowloc, const void* out_row,
                            const void* x, void* out, int B, int C, int R,
                            long long F, int n_rows, int f_tile,
                            void* stream) {
  const int n_ftiles = (int)((F + f_tile - 1) / f_tile);
  const long long smem = spmm_block_slabs_smem_bytes(C, R, f_tile);
  cudaError_t e = slab::allow_smem(spmm_block_slabs_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((long long)B * n_ftiles);
  spmm_block_slabs_kernel<<<grid, f_tile, (size_t)smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(colidx), static_cast<const float*>(values),
      static_cast<const int32_t*>(rowloc), static_cast<const int32_t*>(out_row),
      static_cast<const float*>(x), static_cast<float*>(out), C, R,
      (int64_t)F, n_rows, n_ftiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
