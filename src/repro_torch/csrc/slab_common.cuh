// Pieces shared by the block-slab SpMM kernels K1 (spmm_accel.cu),
// K2 (spmm_windowed.cu) and K3 (spmm_hbm.cu).
//
// Every kernel runs one CTA per (block, feature tile); consumer thread t
// owns feature column tile * f_tile + t of the CTA's output rows. Inputs
// are the packed slabs of core/partition.py::pack_slabs:
//
//   colidx  int32[B, C]   column of X each slab slot gathers
//   values  f32[B, C]     edge value per slot (0 on padding slots)
//   rowloc  int32[B, C]   local output row of each slot, in [0, R)
//   out_row int32[B, R]   global output row of each local row; n_rows = drop
//   x       f32[N, F]     dense features, row-major, contiguous
//   out     f32[n_rows, F] zero-initialised by the caller; accumulated into
//
// pack_slabs emits a local row's slots contiguously (slot j of a block of
// degree d serves local row j / d; a split block has one row) and puts the
// padding slots, value 0, after the live ones. So in every block the live
// slots' rowloc never decreases, and each local row is one run of slots.
// All three kernels use that invariant to add each run straight into out
// (the live-row gather pipeline below); K1 and K3 compute the same
// function and launch the same kernel, slot_order_kernel.
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

// Asynchronous global -> shared copies (sm_80+). A thread's copies are
// visible to itself after cp_async_wait; to the CTA after a barrier too.
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

// CTAs of `kernel` one SM holds at once, or -1 if the runtime refuses.
template <typename Kernel>
inline int ctas_per_sm(Kernel kernel, int threads, long long smem) {
  int n = 0;
  if (allow_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    (size_t)smem) !=
          cudaSuccess)
    return -1;
  return n;
}

// ------------------------------------------------------------------------
// The live-row gather pipeline of K1, K2 and K3.
//
// A CTA walks its block's live slots in an order the kernel gives (K1 and
// K3: slot order; K2: by local row, then window, then slot), gathers each
// slot's row segment x[col, f0 : f0 + f_tile] into a shared-memory ring of
// kRingStages stages of kStageRows segments, and reduces it in registers:
// per local row a window partial summed in walk order and a row total that
// adds the partials in window order. At the end of each row's run the
// total is added into out[out_row] with one fp32 RED. No [R, f_tile] tile
// exists, so shared memory holds only the ring and the block's slots.
//
// Two instances, picked by the wrapper from shape, alignment and f_tile:
//   bulk     (F % 4 == 0, x 16-byte aligned, f_tile <= 992): one thread of
//            a producer warp issues one cp.async.bulk per live segment, completing on
//            the stage's full mbarrier; the f_tile / 32 consumer warps wait
//            on it and release the stage through its empty mbarrier. The
//            CTA has f_tile + 32 threads;
//   cp_async (every other layout): each consumer thread copies its own
//            column of every segment with 4-byte cp.async and reads only
//            what it copied, so no barrier is needed. f_tile threads.

constexpr int kRingStages = 4;   // ring depth, in stages
constexpr int kStageRows = 8;    // row segments per stage

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Dynamic shared memory of a pipeline CTA: the ring, a full and an empty
// barrier per stage, K2's sort keys, then the block's slots and rows.
struct GatherSmem {
  float* ring;       // [kRingStages, kStageRows, f_tile]
  uint64_t* full;    // [kRingStages]
  uint64_t* empty;   // [kRingStages]
  uint64_t* key;     // [pow2_at_least(C)], K2 only
  int32_t* col;      // [C]
  float* val;        // [C]
  int32_t* row;      // [C]
  int32_t* out;      // [R]

  __host__ __device__ static long long bytes(int C, int R, int f_tile,
                                             bool keys) {
    return 4LL * kRingStages * kStageRows * f_tile + 16LL * kRingStages +
           (keys ? 8LL * pow2_at_least(C) : 0) + 4LL * (3LL * C + R);
  }

  __device__ GatherSmem(unsigned char* p, int C, int f_tile, bool keys) {
    ring = reinterpret_cast<float*>(p);
    full = reinterpret_cast<uint64_t*>(ring + kRingStages * kStageRows *
                                                  (size_t)f_tile);
    empty = full + kRingStages;
    key = empty + kRingStages;
    col = reinterpret_cast<int32_t*>(key + (keys ? pow2_at_least(C) : 0));
    val = reinterpret_cast<float*>(col + C);
    row = reinterpret_cast<int32_t*>(val + C);
    out = row + C;
  }
};

// The CTA's (block, feature tile), feature-tile-major over the whole
// grid, so the CTAs resident together share one column slice of X in L2.
__device__ __forceinline__ void cta_tile(int64_t B, int64_t& b, int& tile) {
  const int64_t idx = blockIdx.x;
  b = idx % B;
  tile = (int)(idx / B);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(const uint64_t* bar,
                                          uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits for the phase of `bar` with this parity to complete. A wait of
// more than 10 s can only be a fault of the pipeline: it traps, which the
// caller's next synchronize reports, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(const uint64_t* bar,
                                          uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = now_ns();
    } else if (now_ns() - t0 > 10000000000ull) {
      __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(const uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(const uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes,
                                          const uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Initialises the ring's barriers (bulk instance). Thread 0 only; the
// caller's next __syncthreads publishes them.
__device__ __forceinline__ void init_ring(const GatherSmem& sm, int f_tile) {
  if (threadIdx.x != 0) return;
  for (int s = 0; s < kRingStages; ++s) {
    mbar_init(sm.full + s, 1);
    mbar_init(sm.empty + s, f_tile / 32);   // one arrival per consumer warp
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One walked slot: the X row it gathers, its value, local row and window.
struct Slot {
  int32_t col;
  float val;
  int row;
  uint32_t win;
};

// K1's and K3's walk: the block's first n_live slots in slot order (zero-valued
// ones are walked over without a copy or a product).
struct SlotOrder {
  const int32_t* col;
  const float* val;
  const int32_t* row;
  __device__ __forceinline__ Slot operator()(int i) const {
    return {col[i], val[i], row[i], 0u};
  }
};

// K2's walk: the live slots by sort key (local row << 48 | window << 16 |
// slot), so by row, then window, then slot.
struct KeyOrder {
  const uint64_t* key;
  const int32_t* col;
  const float* val;
  __device__ __forceinline__ Slot operator()(int i) const {
    const uint64_t k = key[i];
    const int c = (int)(k & 0xFFFFu);
    return {col[c], val[c], (int)(k >> 48), (uint32_t)(k >> 16)};
  }
};

// Writes K2's sort keys for the first n_live slots (dead slots sort last),
// sorts them unless they are in order already (bitonic, in shared memory)
// and returns the number of live slots. Every thread of the CTA calls it;
// it ends with a barrier. The caller guarantees C, R < 2^16.
__device__ __forceinline__ int order_by_row_window(const GatherSmem& sm,
                                                   int n_live,
                                                   int64_t window) {
  const int n_pad = pow2_at_least(n_live);
  const int t = threadIdx.x, nt = blockDim.x;
  int n = 0;
  for (int base = 0; base < n_pad; base += nt) {
    const int c = base + t;
    bool live = false;
    if (c < n_pad) {
      live = c < n_live && sm.val[c] != 0.f;
      sm.key[c] = live ? (uint64_t)sm.row[c] << 48 |
                             (uint64_t)(sm.col[c] / window) << 16 |
                             (uint64_t)c
                       : ~0ull;
    }
    n += __syncthreads_count(live);
  }
  bool sorted = true;
  for (int base = 0; base < n_pad; base += nt) {
    const int c = base + t;
    const int ok = __syncthreads_and(c == 0 || c >= n_pad ||
                                     sm.key[c - 1] <= sm.key[c]);
    sorted = sorted && ok;
  }
  if (sorted) return n;
  for (int k = 2; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = t; i < n_pad; i += nt) {
        const int l = i ^ j;
        if (l > i) {
          const uint64_t a = sm.key[i], b = sm.key[l];
          if (((i & k) == 0) == (a > b)) {
            sm.key[i] = b;
            sm.key[l] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  return n;
}

// One thread's column along the walk: the partial of the current window
// and the total of the current row, which takes the window partials in
// window order. Each row's total is added into out[out_row] once, when
// the walk leaves the row: a row of degree <= C has one writer onto a
// zero, which is exact; a split row's blocks sum across CTAs in no fixed
// order. Products are rounded before the sum, as in the plain versions.
struct RowWindowRun {
  int row = -1;
  uint32_t win = 0;
  float part = 0.f;
  float total = 0.f;

  __device__ __forceinline__ void add(const Slot& e, float xv,
                                      const int32_t* s_out, float* out,
                                      int64_t F, int64_t f, int n_rows) {
    if (e.row != row) {
      flush(s_out, out, F, f, n_rows);
      row = e.row;
      win = e.win;
      part = 0.f;
      total = 0.f;
    } else if (e.win != win) {
      total = __fadd_rn(total, part);
      part = 0.f;
      win = e.win;
    }
    part = __fadd_rn(part, __fmul_rn(e.val, xv));
  }

  __device__ __forceinline__ void flush(const int32_t* s_out, float* out,
                                        int64_t F, int64_t f, int n_rows) {
    if (row < 0) return;
    const int o = s_out[row];
    if (o != n_rows) atomicAdd(out + (int64_t)o * F + f, __fadd_rn(total, part));
  }
};

// The pipeline: walks the first n entries of `order`, gathering and
// reducing as described above, and flushes every row into out. The bulk
// instance needs init_ring before the block's staging barrier.
template <bool kBulk, typename Order>
__device__ __forceinline__ void gather_reduce(
    const float* __restrict__ x, float* __restrict__ out, int64_t F,
    int64_t f0, int f_tile, int n, const Order& order, const int32_t* s_out,
    int n_rows, const GatherSmem& sm) {
  const int t = threadIdx.x;
  const int n_stages = (n + kStageRows - 1) / kStageRows;
  const int64_t f = f0 + t;
  const bool f_ok = t < f_tile && f < F;
  const size_t stage_elems = (size_t)kStageRows * f_tile;
  RowWindowRun run;
  auto reduce = [&](int s) {
    const float* buf = sm.ring + (size_t)(s % kRingStages) * stage_elems + t;
    const int i0 = s * kStageRows;
#pragma unroll
    for (int j = 0; j < kStageRows; ++j) {
      if (i0 + j >= n) break;
      const Slot e = order(i0 + j);
      if (e.val != 0.f)
        run.add(e, buf[(size_t)j * f_tile], s_out, out, F, f, n_rows);
    }
  };

  if constexpr (kBulk) {
    if (t >= f_tile) {            // the producer warp
      if (t != f_tile) return;
      // F % 4 == 0, so the ragged last segment is a multiple of 16 bytes
      const uint32_t seg =
          (uint32_t)((F - f0 < f_tile ? F - f0 : f_tile) * 4);
      for (int s = 0; s < n_stages; ++s) {
        const int k = s % kRingStages;
        if (s >= kRingStages) mbar_wait(sm.empty + k, (s / kRingStages - 1) & 1);
        const int i0 = s * kStageRows;
        const int rows = n - i0 < kStageRows ? n - i0 : kStageRows;
        uint32_t bytes = 0;
        for (int j = 0; j < rows; ++j)
          if (order(i0 + j).val != 0.f) bytes += seg;
        mbar_expect_tx(sm.full + k, bytes);
        float* buf = sm.ring + (size_t)k * stage_elems;
        for (int j = 0; j < rows; ++j) {
          const Slot e = order(i0 + j);
          if (e.val != 0.f)
            bulk_copy(buf + (size_t)j * f_tile, x + (int64_t)e.col * F + f0,
                      seg, sm.full + k);
        }
      }
      return;
    }
    for (int s = 0; s < n_stages; ++s) {   // the consumer warps
      const int k = s % kRingStages;
      mbar_wait(sm.full + k, (s / kRingStages) & 1);
      if (f_ok) reduce(s);
      __syncwarp();
      if (t % 32 == 0) mbar_arrive(sm.empty + k);
    }
  } else {
    if (!f_ok) return;
    // Thread t copies column t of stage s's segments into the ring.
    auto issue = [&](int s) {
      float* buf = sm.ring + (size_t)(s % kRingStages) * stage_elems + t;
      const int i0 = s * kStageRows;
      for (int j = 0; j < kStageRows && i0 + j < n; ++j) {
        const Slot e = order(i0 + j);
        if (e.val != 0.f)
          cp_async4(buf + (size_t)j * f_tile, x + (int64_t)e.col * F + f);
      }
    };
    for (int s = 0; s < kRingStages - 1; ++s) {
      if (s < n_stages) issue(s);
      cp_async_commit();
    }
    for (int s = 0; s < n_stages; ++s) {
      cp_async_wait<kRingStages - 2>();   // stage s has landed
      // refills the buffer this thread emptied in the previous step
      if (s + kRingStages - 1 < n_stages) issue(s + kRingStages - 1);
      cp_async_commit();
      reduce(s);
    }
    cp_async_wait<0>();
  }
  if (f_ok) run.flush(s_out, out, F, f, n_rows);
}

// K1's and K3's kernel: the pipeline over the block's slots in slot order.
// One CTA per (block, feature tile), feature-tile-major; an all-zero
// padding block exits before issuing any copy.
template <bool kBulk>
__global__ void slot_order_kernel(
    const int32_t* __restrict__ colidx, const float* __restrict__ values,
    const int32_t* __restrict__ rowloc, const int32_t* __restrict__ out_row,
    const float* __restrict__ x, float* __restrict__ out, int64_t B, int C,
    int R, int64_t F, int n_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_live;
  const int f_tile = kBulk ? blockDim.x - 32 : blockDim.x;
  const GatherSmem sm(smem, C, f_tile, false);
  int64_t b;
  int tile;
  cta_tile(B, b, tile);
  if (kBulk) init_ring(sm, f_tile);
  const int n_live = stage_block(colidx, values, rowloc, out_row, b, C, R,
                                 sm.col, sm.val, sm.row, sm.out, &s_live);
  if (n_live == 0) return;  // all-zero block: no copy, nothing to add
  gather_reduce<kBulk>(x, out, F, (int64_t)tile * f_tile, f_tile, n_live,
                       SlotOrder{sm.col, sm.val, sm.row}, sm.out, n_rows, sm);
}

// Host side of slot_order_kernel, for the C interfaces of K1 and K3.
inline long long slot_order_smem_bytes(int C, int R, int f_tile) {
  return GatherSmem::bytes(C, R, f_tile, false);
}

inline int slot_order_ctas_per_sm(int C, int R, int f_tile, int bulk) {
  const long long smem = slot_order_smem_bytes(C, R, f_tile);
  return bulk ? ctas_per_sm(slot_order_kernel<true>, f_tile + 32, smem)
              : ctas_per_sm(slot_order_kernel<false>, f_tile, smem);
}

// Launches slot_order_kernel on `stream` and returns cudaGetLastError().
// The caller checks shapes, types, that B * n_ftiles fits the grid, and
// passes bulk = 1 only when F % 4 == 0, x is 16-byte aligned and
// f_tile + 32 <= 1024.
inline int slot_order_launch(const void* colidx, const void* values,
                             const void* rowloc, const void* out_row,
                             const void* x, void* out, int B, int C, int R,
                             long long F, int n_rows, int f_tile, int bulk,
                             void* stream) {
  const int n_ftiles = (int)((F + f_tile - 1) / f_tile);
  const long long smem = slot_order_smem_bytes(C, R, f_tile);
  auto kernel = bulk ? &slot_order_kernel<true> : &slot_order_kernel<false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((long long)B * n_ftiles);
  kernel<<<grid, f_tile + (bulk ? 32 : 0), (size_t)smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(colidx), static_cast<const float*>(values),
      static_cast<const int32_t*>(rowloc), static_cast<const int32_t*>(out_row),
      static_cast<const float*>(x), static_cast<float*>(out), (int64_t)B, C,
      R, (int64_t)F, n_rows);
  return (int)cudaGetLastError();
}

}  // namespace slab

extern "C" const char* slab_kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
