// K2: the block-slab SpMM with X streamed through shared memory in row
// windows, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_spmm_kernel_windowed` of
// src/repro/kernels/spmm_accel.py (driven by `spmm_block_slabs_windowed`).
// There a third, sequential grid axis sweeps X in row windows of
// `window` rows held in VMEM; in sweep w the slots whose column lies
// outside window w add nothing, and the block's output accumulates the
// window partials in window order. Inputs and the fused epilogue:
// slab_common.cuh.
//
// The window stays the semantic unit: it decides which slots a sweep sums
// and the order in which partials are added. Its reference size (4096
// rows x 128 columns x 4 B = 2 MiB) does not fit in a CTA's shared memory,
// so each window is staged in sub-tiles of `sub_rows` rows.
//
// Design:
//   * one CTA per (block b, feature tile) of f_tile threads; a loop inside
//     the CTA takes the place of the TPU's sequential window axis;
//   * the CTA stages its block's slots in shared memory and ranks the live
//     (non-zero) slots by column, ties in slot order; an all-zero padding
//     block exits before any copy;
//   * walking the ranked slots, the CTA visits only the sub-tiles that hold
//     at least one live slot, in row order: windows and sub-tiles that no
//     live slot needs are skipped. Each visited sub-tile [sub_rows, f_tile]
//     is copied whole into shared memory with cp.async, double-buffered
//     (the next sub-tile is in flight while the current one is reduced);
//   * thread t copies and reads only column t of each sub-tile, so after
//     the ranking no barrier is needed;
//   * the slots of a sub-tile add their products into a shared [R, f_tile]
//     window partial; when the walk enters the next window, the partial is
//     added into the block's [R, f_tile] tile and cleared, so each block
//     row sums its window partials in window order;
//   * fused epilogue: each live local row is added into out[out_row] with
//     an fp32 atomicAdd.
//
// Bound on an H100: memory, and this design is slow by construction. The
// least work is K1's (referenced X rows once, out once, slabs once), but
// each CTA copies every sub-tile a live slot touches, up to
// N_pad * f_tile * 4 bytes per CTA, where K1 and K3 read one row segment
// per slot. The router sends it only dispatches with N_pad <= 4 windows.
// Offsets into X and out are 64-bit.

#include "slab_common.cuh"

namespace {

__global__ void spmm_windowed_kernel(
    const int32_t* __restrict__ colidx, const float* __restrict__ values,
    const int32_t* __restrict__ rowloc, const int32_t* __restrict__ out_row,
    const float* __restrict__ x, float* __restrict__ out,
    int C, int R, int64_t F, int64_t N, int n_rows, int n_ftiles,
    int64_t window, int sub_rows) {
  extern __shared__ __align__(16) float smem[];
  const int f_tile = blockDim.x;
  const size_t sub_elems = (size_t)sub_rows * f_tile;
  float* xs = smem;                                   // [2, sub_rows, f_tile]
  float* acc = xs + 2 * sub_elems;                    // [R, f_tile]
  float* part = acc + (size_t)R * f_tile;             // [R, f_tile]
  int32_t* s_col = reinterpret_cast<int32_t*>(part + (size_t)R * f_tile);
  float* s_val = reinterpret_cast<float*>(s_col + C);
  int32_t* s_row = reinterpret_cast<int32_t*>(s_val + C);
  int32_t* s_order = s_row + C;                       // [C] live slots by column
  int32_t* s_out = s_order + C;                       // [R]
  __shared__ int s_live;

  const int64_t b = blockIdx.x / n_ftiles;
  const int tile = blockIdx.x % n_ftiles;
  const int t = threadIdx.x;
  const int64_t f = (int64_t)tile * f_tile + t;
  const bool f_ok = f < F;

  for (int r = 0; r < R; ++r) {
    acc[r * f_tile + t] = 0.f;
    part[r * f_tile + t] = 0.f;
  }
  const int n_live = slab::stage_block(colidx, values, rowloc, out_row, b, C,
                                       R, s_col, s_val, s_row, s_out, &s_live);
  if (n_live == 0) return;  // all-zero block: no copy, nothing to add

  // Rank the live slots by (column, slot): a stable order by column.
  int n = 0;
  for (int c = 0; c < n_live; ++c) n += s_val[c] != 0.f;
  for (int c = t; c < n_live; c += f_tile) {
    if (s_val[c] == 0.f) continue;
    const int col = s_col[c];
    int rank = 0;
    for (int d = 0; d < n_live; ++d)
      rank += s_val[d] != 0.f &&
              (s_col[d] < col || (s_col[d] == col && d < c));
    s_order[rank] = c;
  }
  __syncthreads();
  if (!f_ok) return;  // no barrier below: each thread works on its column

  // The sub-tile [lo, hi) of X rows that holds ranked slot p, and its window.
  auto locate = [&](int p, int64_t& lo, int64_t& hi, int64_t& w) {
    const int64_t col = s_col[s_order[p]];
    w = col / window;
    const int64_t w0 = w * window;
    lo = w0 + (col - w0) / sub_rows * sub_rows;
    hi = lo + sub_rows;
    if (hi > w0 + window) hi = w0 + window;
    if (hi > N) hi = N;
  };
  // Copies column t of rows [lo, hi) into buffer `buf`.
  auto issue = [&](int buf, int64_t lo, int64_t hi) {
    float* dst = xs + buf * sub_elems + t;
    const float* src = x + lo * F + f;
    for (int64_t r = 0; r < hi - lo; ++r)
      slab::cp_async4(dst + r * f_tile, src + r * F);
  };
  auto close_window = [&]() {
    for (int r = 0; r < R; ++r) {
      acc[r * f_tile + t] = __fadd_rn(acc[r * f_tile + t], part[r * f_tile + t]);
      part[r * f_tile + t] = 0.f;
    }
  };

  int64_t lo, hi, w;
  locate(0, lo, hi, w);
  issue(0, lo, hi);
  slab::cp_async_commit();
  int64_t cur_w = w;
  int buf = 0;
  for (int p = 0;;) {
    int q = p;  // ranked slots [p, q) lie in this sub-tile
    while (q < n && s_col[s_order[q]] < hi) ++q;
    const bool more = q < n;
    int64_t nlo = 0, nhi = 0, nw = 0;
    if (more) {
      locate(q, nlo, nhi, nw);
      issue(buf ^ 1, nlo, nhi);
    }
    slab::cp_async_commit();
    slab::cp_async_wait<1>();  // this sub-tile has landed
    if (w != cur_w) {
      close_window();
      cur_w = w;
    }
    const float* xb = xs + buf * sub_elems + t;
    for (int k = p; k < q; ++k) {
      const int c = s_order[k];
      float* dst = part + s_row[c] * f_tile + t;
      *dst = __fadd_rn(*dst, __fmul_rn(s_val[c], xb[(s_col[c] - lo) * f_tile]));
    }
    if (!more) break;
    p = q;
    lo = nlo;
    hi = nhi;
    w = nw;
    buf ^= 1;
  }
  slab::cp_async_wait<0>();
  close_window();
  slab::add_block_rows(acc, s_out, out, R, f_tile, t, F, f, n_rows);
}

}  // namespace

extern "C" {

// Shared memory one CTA needs, in bytes.
long long spmm_windowed_smem_bytes(int C, int R, int f_tile, int sub_rows) {
  return 4LL * (2LL * sub_rows * f_tile + 2LL * R * f_tile + 4LL * C + R);
}

// Launches K2 on `stream`. Returns cudaGetLastError() after the launch
// (0 when the launch was accepted). The caller checks shapes, types, that
// B * n_ftiles fits the grid, and that 1 <= sub_rows <= window.
int spmm_windowed_launch(const void* colidx, const void* values,
                         const void* rowloc, const void* out_row,
                         const void* x, void* out, int B, int C, int R,
                         long long F, long long N, int n_rows, int f_tile,
                         long long window, int sub_rows, void* stream) {
  const int n_ftiles = (int)((F + f_tile - 1) / f_tile);
  const long long smem = spmm_windowed_smem_bytes(C, R, f_tile, sub_rows);
  cudaError_t e = slab::allow_smem(spmm_windowed_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((long long)B * n_ftiles);
  spmm_windowed_kernel<<<grid, f_tile, (size_t)smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(colidx), static_cast<const float*>(values),
      static_cast<const int32_t*>(rowloc), static_cast<const int32_t*>(out_row),
      static_cast<const float*>(x), static_cast<float*>(out), C, R,
      (int64_t)F, (int64_t)N, n_rows, n_ftiles, (int64_t)window, sub_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
