// K3: the block-slab SpMM with X gathered into shared memory, on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of src/repro/kernels/spmm_hbm.py
// (driven by `spmm_block_slabs_hbm`), which leaves X in HBM and gathers a
// block's C rows of one feature tile with a double-buffered one-row DMA
// into a [C, F_tile] VMEM scratch, then reduces them; an all-zero padding
// block skips the gather. Inputs and the fused epilogue: slab_common.cuh.
//
// Design:
//   * one CTA per (block b, feature tile) of f_tile threads;
//   * the CTA stages its block's slots in shared memory and finds the last
//     live slot; an all-zero padding block exits before issuing any copy;
//   * the row segments [f_tile floats] of the live slots are gathered with
//     cp.async into a ring of kStages stages of `stage_rows` rows each.
//     Where F % 4 == 0 and X is 16-byte aligned, a copy moves 16 bytes
//     (f_tile / 4 threads per row segment, 4 rows per pass of the CTA);
//     otherwise thread t copies column t, 4 bytes at a time. kStages - 1
//     stages are in flight while the CTA reduces the oldest one, so every
//     thread keeps many independent loads outstanding;
//   * the reduction is K1's: thread t walks the staged slots in slot order,
//     keeps a running sum in a register while the local row stays the same
//     and flushes it into a shared [R, f_tile] tile when the row changes;
//   * fused epilogue: each live local row is added into out[out_row] with
//     an fp32 atomicAdd, so the [B, R, F] block rows the TPU version
//     scatters in a second pass are never written.
//
// Bound on an H100: memory, as K1. Per call it must read the referenced X
// rows once (N * F * 4 bytes), write out once (n_rows * F * 4) and read the
// slabs once (B * (3 * C + R) * 4); the arithmetic is 2 flops per slot and
// column. The ring trades K1's register-held loads (kUnroll per thread) for
// more bytes in flight per SM. Offsets into X and out are 64-bit.

#include "slab_common.cuh"

namespace {

constexpr int kStages = 4;

__global__ void spmm_hbm_kernel(
    const int32_t* __restrict__ colidx, const float* __restrict__ values,
    const int32_t* __restrict__ rowloc, const int32_t* __restrict__ out_row,
    const float* __restrict__ x, float* __restrict__ out,
    int C, int R, int64_t F, int n_rows, int n_ftiles, int stage_rows,
    int vec16) {
  extern __shared__ __align__(16) float smem[];
  const int f_tile = blockDim.x;
  const size_t stage_elems = (size_t)stage_rows * f_tile;
  float* ring = smem;                                   // [kStages, rows, f_tile]
  float* acc = ring + kStages * stage_elems;            // [R, f_tile]
  int32_t* s_col = reinterpret_cast<int32_t*>(acc + (size_t)R * f_tile);
  float* s_val = reinterpret_cast<float*>(s_col + C);
  int32_t* s_row = reinterpret_cast<int32_t*>(s_val + C);
  int32_t* s_out = s_row + C;
  __shared__ int s_live;

  const int64_t b = blockIdx.x / n_ftiles;
  const int tile = blockIdx.x % n_ftiles;
  const int t = threadIdx.x;
  const int64_t f0 = (int64_t)tile * f_tile;
  const int64_t f = f0 + t;
  const bool f_ok = f < F;

  for (int r = 0; r < R; ++r) acc[r * f_tile + t] = 0.f;
  const int n_live = slab::stage_block(colidx, values, rowloc, out_row, b, C,
                                       R, s_col, s_val, s_row, s_out, &s_live);
  if (n_live == 0) return;  // all-zero block: no copy, nothing to add

  const int n_stages = (n_live + stage_rows - 1) / stage_rows;
  // Gathers the row segments of stage s's live slots into ring slot s % kStages.
  auto issue = [&](int s) {
    float* buf = ring + (size_t)(s % kStages) * stage_elems;
    const int c0 = s * stage_rows;
    const int rows = min(stage_rows, n_live - c0);
    if (vec16) {
      const int seg = f_tile / 4;  // 16-byte chunks per row segment
      for (int j = t; j < rows * seg; j += f_tile) {
        const int i = j / seg, q = j - i * seg;
        const int c = c0 + i;
        const int64_t fc = f0 + 4 * q;  // F % 4 == 0: fc < F means fc + 4 <= F
        if (s_val[c] != 0.f && fc < F)
          slab::cp_async16(buf + (size_t)i * f_tile + 4 * q,
                           x + (int64_t)s_col[c] * F + fc);
      }
    } else if (f_ok) {
      for (int i = 0; i < rows; ++i) {
        const int c = c0 + i;
        if (s_val[c] != 0.f)
          slab::cp_async4(buf + (size_t)i * f_tile + t,
                          x + (int64_t)s_col[c] * F + f);
      }
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) issue(s);
    slab::cp_async_commit();
  }
  slab::RowRun run;
  for (int s = 0; s < n_stages; ++s) {
    slab::cp_async_wait<kStages - 2>();  // stage s has landed for this thread
    __syncthreads();  // ... and for every thread; stage s - 1 is consumed
    if (s + kStages - 1 < n_stages) issue(s + kStages - 1);
    slab::cp_async_commit();
    if (f_ok) {
      const float* buf = ring + (size_t)(s % kStages) * stage_elems;
      const int c0 = s * stage_rows;
      const int rows = min(stage_rows, n_live - c0);
      for (int i = 0; i < rows; ++i) {
        const int c = c0 + i;
        const float v = s_val[c];
        if (v != 0.f)
          run.add(s_row[c], v, buf[(size_t)i * f_tile + t], acc, f_tile, t);
      }
    }
  }
  slab::cp_async_wait<0>();
  run.flush(acc, f_tile, t);

  // Each thread reads back only its own column of acc: no barrier needed.
  if (!f_ok) return;
  slab::add_block_rows(acc, s_out, out, R, f_tile, t, F, f, n_rows);
}

}  // namespace

extern "C" {

// Shared memory one CTA needs, in bytes.
long long spmm_hbm_smem_bytes(int C, int R, int f_tile, int stage_rows) {
  return 4LL * ((long long)kStages * stage_rows * f_tile +
                (long long)R * f_tile + 3LL * C + R);
}

// Launches K3 on `stream`. Returns cudaGetLastError() after the launch
// (0 when the launch was accepted). The caller checks shapes, types, that
// B * n_ftiles fits the grid, and passes vec16 = 1 only when F % 4 == 0
// and x is 16-byte aligned.
int spmm_hbm_launch(const void* colidx, const void* values,
                    const void* rowloc, const void* out_row, const void* x,
                    void* out, int B, int C, int R, long long F, int n_rows,
                    int f_tile, int stage_rows, int vec16, void* stream) {
  const int n_ftiles = (int)((F + f_tile - 1) / f_tile);
  const long long smem = spmm_hbm_smem_bytes(C, R, f_tile, stage_rows);
  cudaError_t e = slab::allow_smem(spmm_hbm_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((long long)B * n_ftiles);
  spmm_hbm_kernel<<<grid, f_tile, (size_t)smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(colidx), static_cast<const float*>(values),
      static_cast<const int32_t*>(rowloc), static_cast<const int32_t*>(out_row),
      static_cast<const float*>(x), static_cast<float*>(out), C, R,
      (int64_t)F, n_rows, n_ftiles, stage_rows, vec16);
  return (int)cudaGetLastError();
}

}  // extern "C"
