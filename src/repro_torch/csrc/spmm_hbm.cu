// K3: the block-slab SpMM with X gathered into shared memory, on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of src/repro/kernels/spmm_hbm.py
// (driven by `spmm_block_slabs_hbm`), which leaves X in HBM and gathers a
// block's C rows of one feature tile with a double-buffered one-row DMA
// into a [C, F_tile] VMEM scratch, then reduces them; an all-zero padding
// block skips the gather. Inputs: slab_common.cuh.
//
// Design: the live-row gather pipeline of slab_common.cuh, walking the
// block's slots in slot order (slot_order_kernel, which K1 launches too).
//   * one CTA per (block, feature tile), feature-tile-major, so that the
//     CTAs resident together share a column slice of X in L2;
//   * the CTA stages its block's slots in shared memory and finds the last
//     live slot; an all-zero padding block exits before issuing any copy;
//   * each live slot's row segment (f_tile floats) is gathered into a ring
//     of kRingStages x kStageRows segments: by one producer thread with a
//     bulk copy per segment on mbarriers (the `bulk` instance, F % 4 == 0
//     and X 16-byte aligned), or by each thread for its own column with
//     4-byte cp.async (the `cp_async` instance, every other layout);
//   * each thread sums its column of a local row's run in a register and
//     adds it into out[out_row] with one fp32 RED when the run ends, so
//     neither the [B, R, F] block rows of the TPU version nor a shared
//     [R, f_tile] tile exist, and shared memory (the ring and the slots)
//     does not limit how many CTAs an SM holds.
//
// Bound on an H100: memory. Per call it must read the referenced X rows
// once (N * F * 4 bytes), write out once (n_rows * F * 4) and read the
// slabs once (B * (3 * C + R) * 4); the arithmetic is 2 flops per slot and
// column. What it gathers is one row segment per live slot (nnz * F * 4
// bytes), of which L2 serves the rows that recur. Offsets into X and out
// are 64-bit; the ragged feature edge is masked.

#include "slab_common.cuh"

extern "C" {

// Shared memory one CTA needs, in bytes.
long long spmm_hbm_smem_bytes(int C, int R, int f_tile) {
  return slab::slot_order_smem_bytes(C, R, f_tile);
}

// CTAs one SM holds at once (-1 if the runtime refuses to say).
int spmm_hbm_ctas_per_sm(int C, int R, int f_tile, int bulk) {
  return slab::slot_order_ctas_per_sm(C, R, f_tile, bulk);
}

// Launches K3 on `stream`. Returns cudaGetLastError() after the launch
// (0 when the launch was accepted). The caller checks shapes, types, that
// B * n_ftiles fits the grid, and passes bulk = 1 only when F % 4 == 0,
// x is 16-byte aligned and f_tile <= 992.
int spmm_hbm_launch(const void* colidx, const void* values,
                    const void* rowloc, const void* out_row, const void* x,
                    void* out, int B, int C, int R, long long F, int n_rows,
                    int f_tile, int bulk, void* stream) {
  return slab::slot_order_launch(colidx, values, rowloc, out_row, x, out, B,
                                 C, R, F, n_rows, f_tile, bulk, stream);
}

}  // extern "C"
