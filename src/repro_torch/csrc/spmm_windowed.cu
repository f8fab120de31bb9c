// K2: the block-slab SpMM with X swept in row windows, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_spmm_kernel_windowed` of
// src/repro/kernels/spmm_accel.py (driven by `spmm_block_slabs_windowed`).
// There a third, sequential grid axis sweeps X in row windows of
// `window` rows held in VMEM; in sweep w the slots whose column lies
// outside window w add nothing, and the block's output accumulates the
// window partials in window order. Inputs: slab_common.cuh.
//
// The window stays the semantic unit: it decides which slots a partial
// sums and the order in which partials are added. It is no longer a unit
// of copying: only the live slots' row segments are gathered.
//
// Design: the live-row gather pipeline of slab_common.cuh (K3's), walking
// the block's live slots by (local row, window, slot).
//   * one CTA per (block, feature tile), in K3's order;
//   * the CTA stages its block's slots and gives each live slot the key
//     local row << 48 | window << 16 | slot; an all-zero padding block
//     exits before any copy. Keys already in order (every row within one
//     window, or its windows visited in order) are used as they are;
//     otherwise a bitonic sort in shared memory orders them. Any number of
//     windows works, and columns need not be sorted inside a row;
//   * each thread keeps, per local row, the current window's partial
//     (summed in slot order) and the row total (adding the partials in
//     window order), and adds the total into out[out_row] with one fp32
//     RED when the row's run ends. This is the reference's order and its
//     plain version's (spmm_block_slabs_windowed_plain).
//
// Bound on an H100: memory, as K1 and K3 (the referenced X rows once, out
// once, slabs once). The router sends it dispatches with at most 4
// windows. Offsets into X and out are 64-bit.

#include "slab_common.cuh"

namespace {

template <bool kBulk>
__global__ void spmm_windowed_kernel(
    const int32_t* __restrict__ colidx, const float* __restrict__ values,
    const int32_t* __restrict__ rowloc, const int32_t* __restrict__ out_row,
    const float* __restrict__ x, float* __restrict__ out, int64_t B, int C,
    int R, int64_t F, int n_rows, int64_t window) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_live;
  const int f_tile = kBulk ? blockDim.x - 32 : blockDim.x;
  const slab::GatherSmem sm(smem, C, f_tile, true);
  int64_t b;
  int tile;
  slab::cta_tile(B, b, tile);
  if (kBulk) slab::init_ring(sm, f_tile);
  const int n_live = slab::stage_block(colidx, values, rowloc, out_row, b, C,
                                       R, sm.col, sm.val, sm.row, sm.out,
                                       &s_live);
  if (n_live == 0) return;  // all-zero block: no copy, nothing to add
  const int n = slab::order_by_row_window(sm, n_live, window);
  slab::gather_reduce<kBulk>(x, out, F, (int64_t)tile * f_tile, f_tile, n,
                             slab::KeyOrder{sm.key, sm.col, sm.val}, sm.out,
                             n_rows, sm);
}

}  // namespace

extern "C" {

// Shared memory one CTA needs, in bytes.
long long spmm_windowed_smem_bytes(int C, int R, int f_tile) {
  return slab::GatherSmem::bytes(C, R, f_tile, true);
}

// CTAs one SM holds at once (-1 if the runtime refuses to say).
int spmm_windowed_ctas_per_sm(int C, int R, int f_tile, int bulk) {
  const long long smem = spmm_windowed_smem_bytes(C, R, f_tile);
  return bulk ? slab::ctas_per_sm(spmm_windowed_kernel<true>, f_tile + 32,
                                  smem)
              : slab::ctas_per_sm(spmm_windowed_kernel<false>, f_tile, smem);
}

// Launches K2 on `stream`. Returns cudaGetLastError() after the launch
// (0 when the launch was accepted). The caller checks shapes, types, that
// B * n_ftiles fits the grid, that C and R are below 2^16 (the sort key's
// fields), that window >= 1, and passes bulk = 1 only when F % 4 == 0 and
// x is 16-byte aligned.
int spmm_windowed_launch(const void* colidx, const void* values,
                         const void* rowloc, const void* out_row,
                         const void* x, void* out, int B, int C, int R,
                         long long F, int n_rows, int f_tile,
                         long long window, int bulk, void* stream) {
  const int n_ftiles = (int)((F + f_tile - 1) / f_tile);
  const long long smem = spmm_windowed_smem_bytes(C, R, f_tile);
  auto kernel =
      bulk ? &spmm_windowed_kernel<true> : &spmm_windowed_kernel<false>;
  cudaError_t e = slab::allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((long long)B * n_ftiles);
  kernel<<<grid, f_tile + (bulk ? 32 : 0), (size_t)smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(colidx), static_cast<const float*>(values),
      static_cast<const int32_t*>(rowloc), static_cast<const int32_t*>(out_row),
      static_cast<const float*>(x), static_cast<float*>(out), (int64_t)B, C,
      R, (int64_t)F, n_rows, (int64_t)window);
  return (int)cudaGetLastError();
}

}  // extern "C"
