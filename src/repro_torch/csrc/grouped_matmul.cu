// K4: the block-balanced grouped GEMM of the Accel-GCN MoE dispatch on
// Hopper (sm_90a), in two instances.
//
// Replaces the Pallas TPU kernel `_gmm_kernel` of
// src/repro/kernels/grouped_matmul.py:33, driven there by `grouped_matmul`.
//
//   x            TX[M, K]   rows sorted by expert and padded per expert to
//                           m_tile-row blocks; row-major, contiguous
//   w            TW[E, K, N] expert weights; row-major, contiguous
//   block_expert int32[M / m_tile]  expert of each row block, in [0, E)
//   out          f32[M, N]  out[b-th block rows] = x[those rows] @ w[e_b]
//
// Bound on an H100. At prefill the product is bound by operations: the wi
// product of dbrx-132b at 4,096 tokens (M = 18,432, K = 6,144,
// N = 10,752) is 2.435 TFLOP against 3.1 GB of compulsory traffic (x once,
// the used experts' weights once, the fp32 output once), 2.46 ms at the
// 989 TFLOP/s bf16 tensor-core rate against 0.93 ms at 3.35 TB/s. At a
// decode step it is bound by bytes: each live block's expert weights are
// read once (6.3 GB for the three products of a dbrx-132b layer, 1.9 ms).
//
// The wgmma instance takes bf16 x and w with K % 8 == 0, N % 8 == 0,
// m_tile % 64 == 0 and 16-byte aligned bases (the wrapper's `_instance`
// decides). A bf16 x bf16 product is exact in fp32, so tensor cores that
// accumulate in fp32 compute the reference's function, in another
// summation order. Against the operations bound:
//   * one CTA per (128-row tile, 256-column tile): two consumer warpgroups
//     of 64 rows each run `wgmma.m64n256k16` with fp32 accumulators in
//     registers, one producer warp keeps TMA loads in flight, and
//     `setmaxnreg` moves the producer's registers to the consumers;
//   * TMA fills a ring of 4 shared-memory stages, each the x tile
//     [128 rows, 64 k] and the w tile [64 k, 256 n], both in the 128-byte
//     swizzle that wgmma reads without bank conflicts; a full and an empty
//     mbarrier per stage hand each stage from producer to consumers and
//     back, so loads of later k run while earlier k is multiplied;
//   * x is K-major (a 2-D tensor map over (K, M)); w is read as it lies,
//     N-major, through wgmma's transpose bit for B: no transposed copy of
//     the weights exists. Its 3-D tensor map over (N, K, E) takes the
//     block's expert as its third coordinate, read once per CTA from
//     block_expert (the counterpart of the TPU's scalar-prefetched index
//     map), and zero-fills a ragged last K tile inside that expert, where
//     a 2-D map over E * K rows would read the next expert's rows (a NaN
//     there would poison the output through 0 * NaN);
//   * CTAs are ordered in groups of 16 consecutive row tiles: within
//     a group, all row tiles take column tile 0, then 1, and so on. The row
//     blocks of one expert are consecutive, so the CTAs in flight share a
//     weight tile and read it from HBM about once, and the group's x rows
//     stay in L2 across its column tiles. Row-block-major order (each
//     block across all column tiles) would stream one expert's whole
//     weights per block: 19 GB for wi, 5.7 ms of bytes alone;
//   * the tiling (256 columns, 4 stages, groups of 16 row tiles) was the
//     fastest of those timed on the wi product (PERF.md records them): a
//     256-column tile reads each x tile half as often as a 128-column one,
//     and a 5th 48 KB stage would not fit in shared memory;
//   * the epilogue pairs lanes with one shuffle so that each thread stores
//     16-byte float4s, each warp store filling whole 32-byte sectors, with
//     a streaming hint so the 0.79 GB of fp32 output does not evict the
//     weights from L2. A 128-row tile never spans two blocks: a block of
//     m_tile % 128 == 64 rows ends in a 64-row tile, whose second
//     warpgroup computes and stores nothing; columns past N are not
//     stored.
//
// The simt instance takes every other input on the CUDA cores, as before
// the wgmma instance existed: fp32 or mixed operands (TF32 tensor cores
// would round fp32 operands to 10 mantissa bits and compute another
// function; converting them to bf16 likewise), K or N not a multiple of
// 8, any other m_tile. Its design:
//   * one CTA of 256 threads per (row block b, 128-column output tile). The
//     CTA reads block_expert[b] once and takes its weight pointer from it.
//     A block longer than 128 rows is walked in 128-row chunks; rows past
//     the block (m_tile < 128) are masked;
//   * the K loop stages a 128 x 16 tile of x (transposed) and a 16 x 128
//     tile of w through shared memory as fp32, two stages deep: the global
//     loads of stage k + 1 are in flight in registers, in the operands' own
//     types, while stage k is multiplied, and are converted to fp32 only
//     when stored;
//   * each thread owns an 8 x 8 register tile of the output, read from
//     shared memory as float4s without bank conflicts, and accumulates each
//     output with fmaf over k in order 0..K-1: one rounding per term;
//   * ragged K and N (any size) are masked with zeros on load and on store.
//   Its bound with fp32 operands is the 67 TFLOP/s CUDA-core rate (36.3 ms
//   for the wi product above).
//
// Offsets are 64-bit: E * K * N is 1.06e9 at these widths, and M * K
// passes 2^31 at large token counts.

#include <cuda.h>            // CUtensorMap and its enums; no -lcuda needed
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ----------------------------------------------------------------------
// The wgmma instance.
// ----------------------------------------------------------------------
namespace tc {

constexpr int kBM = 128;              // rows of a CTA tile
constexpr int kBK = 64;               // k of a stage: one 128-byte bf16 span
constexpr int kThreads = 384;         // warpgroups 0, 1 consume; 2 produces
constexpr int kABytes = kBM * kBK * 2;           // x tile of a stage
constexpr int kBoxBytes = kBK * 64 * 2;          // one [64 k, 64 n] w box
constexpr int kBN = 256;              // columns of a CTA tile
constexpr int kStages = 4;            // stages of the shared-memory ring
constexpr int kGroupM = 16;           // row tiles per group of the order
constexpr int kStageBytes = kABytes + kBN / 64 * kBoxBytes;
// Dynamic shared memory: the ring, a full and an empty barrier per stage,
// and slack to align the ring to the 1024-byte swizzle atom.
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
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
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = now_ns();
    } else if (now_ns() - t0 > 10000000000ull) {
      __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor in the 128-byte swizzle; the leading
// and stride byte offsets are given in bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses to the accumulators across an
// asynchronous wgmma that writes them.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64, 256] += A[64, 16] B[16, 256]: A K-major, B N-major (transpose
// bit).
__device__ __forceinline__ void mma(float (&d)[128], uint64_t a,
                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// Registers per thread after `setmaxnreg`: the producer warpgroup gives
// its registers to the two consumer warpgroups (64K per SM, one CTA).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

__global__ void __launch_bounds__(kThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w,
                 const int32_t* __restrict__ block_expert,
                 float* __restrict__ out, int m_tile, int64_t N, int K,
                 int tiles_per_block, int n_row_tiles, int n_col_tiles) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + kStages * kStageBytes;   // kStages barriers
  const uint32_t empty = full + kStages * 8;            // kStages barriers

  // Tile order: groups of kGroupM row tiles, column-tile-major inside.
  const int per_group = kGroupM * n_col_tiles;
  const int group = blockIdx.x / per_group;
  const int first = group * kGroupM;
  const int in_group = min(kGroupM, n_row_tiles - first);
  const int local = blockIdx.x - group * per_group;
  const int row_tile = first + local % in_group;
  const int n0 = (local / in_group) * kBN;
  const int b = row_tile / tiles_per_block;                 // row block
  const int r_in_b = (row_tile - b * tiles_per_block) * kBM;
  const int row0 = b * m_tile + r_in_b;                     // < M < 2^31
  const int consumers = m_tile - r_in_b > 64 ? 2 : 1;       // 64-row halves
  const int n_k = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * consumers);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x == 256) {
      const int e = block_expert[b];
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty + 8 * s, (kt / kStages - 1) & 1);
        const uint32_t a = ring + s * kStageBytes;
        mbar_expect_tx(full + 8 * s, kStageBytes);
        tma_2d(a, &map_x, full + 8 * s, kt * kBK, row0);
#pragma unroll
        for (int j = 0; j < kBN / 64; ++j)
          tma_3d(a + kABytes + j * kBoxBytes, &map_w, full + 8 * s,
                 n0 + j * 64, kt * kBK, e);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    if (wg < consumers) {
      float acc[kBN / 2];
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
      const int lane = threadIdx.x % 32;
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        mbar_wait(full + 8 * s, (kt / kStages) & 1);
        // A: this warpgroup's 64 rows, 128 bytes of k per row, 8-row
        // swizzle atoms 1024 bytes apart; a k16 step is 32 bytes along
        // the row. B: kBN / 64 boxes of [64 k, 64 n], 8 KB apart (leading
        // offset), 8-k-row atoms 1024 bytes apart (stride offset); a k16
        // step is 16 rows of 128 bytes.
        const uint32_t a = ring + s * kStageBytes + wg * 64 * 128;
        const uint32_t bw = ring + s * kStageBytes + kABytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          mma(acc, desc(a + kk * 32, 16, 1024),
                  desc(bw + kk * 2048, kBoxBytes, 1024));
        wgmma_commit();
        // The previous stage's products are done: hand it back.
        wgmma_wait<1>();
        fence_acc(acc);
        if (kt > 0 && lane == 0)
          mbar_arrive(empty + 8 * ((kt - 1) % kStages));
      }
      wgmma_wait<0>();
      fence_acc(acc);

      // Accumulator i of thread t: row 16 (t / 32) + (t % 32) / 4 +
      // 8 ((i / 2) % 2), column 8 (i / 4) + 2 (t % 4) + i % 2. Lanes 2l and
      // 2l + 1 swap halves so that each holds 4 consecutive columns of
      // one row: the even lane of row r, the odd lane of row r + 8.
      const bool odd = lane & 1;
      const int r = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4 +
                    (odd ? 8 : 0);
      const int c = ((lane % 4) / 2) * 4;
      float* dst = out + (int64_t)(row0 + r) * N + n0 + c;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const float s0 = odd ? acc[4 * j] : acc[4 * j + 2];
        const float s1 = odd ? acc[4 * j + 1] : acc[4 * j + 3];
        const float t0 = __shfl_xor_sync(0xffffffffu, s0, 1);
        const float t1 = __shfl_xor_sync(0xffffffffu, s1, 1);
        const float4 v =
            odd ? make_float4(t0, t1, acc[4 * j + 2], acc[4 * j + 3])
                : make_float4(acc[4 * j], acc[4 * j + 1], t0, t1);
        if (n0 + 8 * j + c < N)
          __stcs(reinterpret_cast<float4*>(dst + 8 * j), v);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, found through the
// runtime so the library needs no -lcuda; null when it is missing.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Error codes beside cudaError_t's (all positive).
constexpr int kNoEncode = -1;      // no cuTensorMapEncodeTiled in CUDA
constexpr int kBadMap = -2;        // it refused a tensor map

int64_t ctas(int64_t n_blocks, int m_tile, int64_t N) {
  return n_blocks * ((m_tile + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
}

int launch(const void* x, const void* w, const void* block_expert, void* out,
           int64_t E, int64_t n_blocks, int m_tile, int64_t K, int64_t N,
           cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return kNoEncode;
  const int64_t M = n_blocks * m_tile;
  CUtensorMap map_x, map_w;
  const cuuint32_t ones[3] = {1, 1, 1};
  const cuuint64_t x_dim[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t x_stride[1] = {(cuuint64_t)K * 2};
  const cuuint32_t x_box[2] = {kBK, kBM};
  const cuuint64_t w_dim[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t w_stride[2] = {(cuuint64_t)N * 2, (cuuint64_t)(K * N) * 2};
  const cuuint32_t w_box[3] = {64, kBK, 1};
  if (encode(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(x), x_dim, x_stride, x_box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&map_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(w), w_dim, w_stride, w_box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return kBadMap;
  const cudaError_t e = cudaFuncSetAttribute(
      gmm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const int tiles_per_block = (m_tile + kBM - 1) / kBM;
  const unsigned grid = (unsigned)ctas(n_blocks, m_tile, N);
  gmm_wgmma_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      map_x, map_w, static_cast<const int32_t*>(block_expert),
      static_cast<float*>(out), m_tile, N, (int)K, tiles_per_block,
      (int)(n_blocks * tiles_per_block), (int)((N + kBN - 1) / kBN));
  return (int)cudaGetLastError();
}

}  // namespace tc

// ----------------------------------------------------------------------
// The simt instance.
// ----------------------------------------------------------------------
namespace simt {

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

}  // namespace simt

}  // namespace

extern "C" {

// CTAs of one launch (the wrapper checks that they fit the grid):
// instance 0 is simt, 1 wgmma.
long long grouped_matmul_ctas(int instance, long long n_blocks, int m_tile,
                              long long N) {
  if (instance == 0) return n_blocks * ((N + simt::kBN - 1) / simt::kBN);
  return tc::ctas(n_blocks, m_tile, N);
}

// Launches K4 on `stream`. instance 0 is the simt instance, for any
// operand types (x_bf16 / w_bf16: bf16 (1) or fp32 (0)); 1 is the wgmma
// instance, for bf16 x and w only. The caller
// checks shapes, types, contiguity, the grid (grouped_matmul_ctas) and,
// for wgmma, what `_instance` asks.
// Returns 0 when the launch was accepted, else cudaGetLastError() or one
// of the negative codes of grouped_matmul_error_string.
int grouped_matmul_launch(const void* x, const void* w,
                          const void* block_expert, void* out, int x_bf16,
                          int w_bf16, long long n_experts, long long n_blocks,
                          int m_tile, long long K, long long N, int instance,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (instance == 1) {
    if (!x_bf16 || !w_bf16) return (int)cudaErrorInvalidValue;
    return tc::launch(x, w, block_expert, out, n_experts, n_blocks, m_tile,
                      K, N, s);
  }
  cudaError_t e;
  if (x_bf16 && w_bf16)
    e = simt::launch<__nv_bfloat16, __nv_bfloat16>(x, w, block_expert, out,
                                                   n_blocks, m_tile, K, N, s);
  else if (x_bf16)
    e = simt::launch<__nv_bfloat16, float>(x, w, block_expert, out,
                                           n_blocks, m_tile, K, N, s);
  else if (w_bf16)
    e = simt::launch<float, __nv_bfloat16>(x, w, block_expert, out,
                                           n_blocks, m_tile, K, N, s);
  else
    e = simt::launch<float, float>(x, w, block_expert, out, n_blocks,
                                   m_tile, K, N, s);
  return (int)e;
}

const char* grouped_matmul_error_string(int code) {
  switch (code) {
    case tc::kNoEncode:
      return "the CUDA driver has no cuTensorMapEncodeTiled";
    case tc::kBadMap:
      return "cuTensorMapEncodeTiled refused a tensor map of x or w";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
