// K1: the Accel-GCN block-slab SpMM on Hopper (sm_90a), X read straight
// from device memory.
//
// Replaces the Pallas TPU kernel `_spmm_kernel` of
// src/repro/kernels/spmm_accel.py (driven by `spmm_block_slabs`) together
// with its `scatter_block_rows` epilogue. The TPU kernel keeps an
// [N_pad, f_tile] column slice of X resident in VMEM while it sweeps every
// block, reduces each block's C gathered rows into R block rows with a
// one-hot matmul, and scatters the [B, R, F] block rows in a second pass.
// Inputs: slab_common.cuh.
//
// Bound on an H100: memory. Per call it must read the referenced X rows
// once (N * F * 4 bytes), write out once (n_rows * F * 4) and read the
// slabs once (B * (3 * C + R) * 4); the arithmetic is 2 flops per slot and
// column, far below the fp32 rate. What it gathers is one row segment per
// live slot (nnz * F * 4 bytes); the on-chip place for the TPU's resident
// column slice is the 50 MB L2, which serves the rows that recur within
// the slice that the CTAs in flight share.
//
// Design: the live-row gather pipeline of slab_common.cuh in slot order
// (slot_order_kernel, the kernel K3 launches too).
//   * one CTA per (block, feature tile), feature-tile-major over the whole
//     grid, so that the CTAs in flight share one column slice of X and L2
//     serves the rows that recur within it;
//   * the CTA stages its block's slots in shared memory and finds the last
//     live slot; an all-zero padding block exits before issuing any copy;
//   * each live slot's row segment goes into a ring of kRingStages x
//     kStageRows segments: one bulk copy per segment on mbarriers (the
//     `bulk` instance) or 4-byte cp.async per thread (`cp_async`);
//   * each thread sums its column of a local row's run in a register and
//     adds it into out[out_row] with one fp32 RED. No [R, f_tile] tile and
//     no per-row epilogue: shared memory holds the ring and the slots, so
//     it does not cap the CTAs an SM holds.
// The slice width is picked from F by kernels/spmm_accel.py::k1_f_tile:
// F in whole warps, at most K1_F_TILE (256). A narrow F thus launches no
// warp without columns, and its ring, sized by f_tile, leaves room for
// more CTAs an SM: K1's per-slot work is per warp, so the warps with
// columns an SM holds set the time of a narrow call (PERF.md). Where F
// exceeds the slice, 256 is the width the sweep of chip_smoke.py found
// fastest: a narrower slice, which L2 could hold whole, re-reads the
// slabs once per slice and moves each gathered byte in more, smaller
// copies, and lost (PERF.md).

#include "slab_common.cuh"

extern "C" {

// Shared memory one CTA needs, in bytes.
long long spmm_block_slabs_smem_bytes(int C, int R, int f_tile) {
  return slab::slot_order_smem_bytes(C, R, f_tile);
}

// CTAs one SM holds at once (-1 if the runtime refuses to say).
int spmm_block_slabs_ctas_per_sm(int C, int R, int f_tile, int bulk) {
  return slab::slot_order_ctas_per_sm(C, R, f_tile, bulk);
}

// Launches K1 on `stream`. Returns cudaGetLastError() after the launch
// (0 when the launch was accepted). The caller checks shapes, types, that
// B * n_ftiles fits the grid, and passes bulk = 1 only when F % 4 == 0,
// x is 16-byte aligned and f_tile <= 992.
int spmm_block_slabs_launch(const void* colidx, const void* values,
                            const void* rowloc, const void* out_row,
                            const void* x, void* out, int B, int C, int R,
                            long long F, int n_rows, int f_tile, int bulk,
                            void* stream) {
  return slab::slot_order_launch(colidx, values, rowloc, out_row, x, out, B,
                                 C, R, F, n_rows, f_tile, bulk, stream);
}

}  // extern "C"
