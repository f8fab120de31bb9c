// Pieces shared by the block-slab SpMM kernels K1 (spmm_accel.cu),
// K2 (spmm_windowed.cu) and K3 (spmm_hbm.cu).
//
// Every kernel runs one CTA per (block, feature tile) of f_tile threads;
// thread t owns feature column tile * f_tile + t of the CTA's output rows.
// Inputs are the packed slabs of core/partition.py::pack_slabs:
//
//   colidx  int32[B, C]   column of X each slab slot gathers
//   values  f32[B, C]     edge value per slot (0 on padding slots)
//   rowloc  int32[B, C]   local output row of each slot, in [0, R)
//   out_row int32[B, R]   global output row of each local row; n_rows = drop
//   x       f32[N, F]     dense features, row-major, contiguous
//   out     f32[n_rows, F] zero-initialised by the caller; accumulated into
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace slab {

// Stages block b's C slots and R output rows in shared memory and returns
// the number of slots up to and including the last live (non-zero) one:
// 0 for an all-zero padding block. Every thread of the CTA must call it;
// it ends with a barrier, so the staged arrays are visible on return.
__device__ __forceinline__ int stage_block(
    const int32_t* __restrict__ colidx, const float* __restrict__ values,
    const int32_t* __restrict__ rowloc, const int32_t* __restrict__ out_row,
    int64_t b, int C, int R, int32_t* s_col, float* s_val, int32_t* s_row,
    int32_t* s_out, int* s_live) {
  const int t = threadIdx.x;
  if (t == 0) *s_live = 0;
  __syncthreads();
  int live = 0;
  for (int c = t; c < C; c += blockDim.x) {
    const float v = values[b * C + c];
    s_col[c] = colidx[b * C + c];
    s_val[c] = v;
    s_row[c] = rowloc[b * C + c];
    if (v != 0.f) live = c + 1;
  }
  for (int r = t; r < R; r += blockDim.x) s_out[r] = out_row[b * R + r];
  if (live) atomicMax(s_live, live);
  __syncthreads();
  return *s_live;
}

// Running sum of one thread's column over consecutive slots of the same
// local row (pack_slabs emits a row's slots contiguously); flushed into the
// shared [R, f_tile] tile `acc` when the row changes. The product is
// rounded before the sum, as the plain versions do.
struct RowRun {
  int cur = -1;
  float run = 0.f;

  __device__ __forceinline__ void add(int r, float v, float xv, float* acc,
                                      int f_tile, int t) {
    if (r != cur) {
      if (cur >= 0) acc[cur * f_tile + t] += run;
      cur = r;
      run = 0.f;
    }
    run = __fadd_rn(run, __fmul_rn(v, xv));
  }

  __device__ __forceinline__ void flush(float* acc, int f_tile, int t) {
    if (cur >= 0) acc[cur * f_tile + t] += run;
  }
};

// Fused epilogue: adds each local row of the block into out[out_row] with
// an fp32 atomicAdd (compiled to a fire-and-forget RED). A row with degree
// <= C has one writer onto a zero, which is exact; the blocks of a split
// row (degree > C) sum across CTAs in no fixed order.
__device__ __forceinline__ void add_block_rows(
    const float* acc, const int32_t* s_out, float* __restrict__ out, int R,
    int f_tile, int t, int64_t F, int64_t f, int n_rows) {
  for (int r = 0; r < R; ++r) {
    const int o = s_out[r];
    if (o == n_rows) continue;  // sentinel: padding row
    atomicAdd(out + (int64_t)o * F + f, acc[r * f_tile + t]);
  }
}

// Asynchronous global -> shared copies (sm_80+). A thread's copies are
// visible to itself after cp_async_wait; to the CTA after a barrier too.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most `pending` of this thread's committed groups are
// still in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

// Opts the kernel in to more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace slab

extern "C" const char* slab_kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
