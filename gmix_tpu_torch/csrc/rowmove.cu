// Arena row movers for Hopper (sm_90a): gather and scatter whole rows of
// (S, N, W) tables by per-stream row indices.
//
// Replaces gmix_tpu/ops/rowmove.py:_pallas_gather_fn and
// _pallas_scatter_fn, the TPU kernels that kept a ring of row DMAs in
// flight (_ring_loop).
//
//   gather:  out[s, m, :]      = tbl[s, idx[s, m], :]
//   scatter: tbl[s, idx[s, m], :] = upd[s, m, :]   (in place; idx unique
//                                                     within each stream)
//
// What bounds it on this card: nothing but memory latency and bandwidth.
// The codec moves a few dozen scattered rows per stream per byte (512 B
// indirect blocks and mixer rows, 4 KB position blocks, 1056 B APM rows),
// about 65 rows per stream, out of arenas many times larger than the L2
// cache, so almost every row is a cold read from HBM. There is no
// arithmetic at all.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, a launch per arena took
// 3.2-3.5 us on the device for 0.02-0.2 us of bytes, and more than that on
// the host: launches, not bytes, are what a byte step pays for. So the
// gather takes a group of arenas in ONE launch (gather_rows_many_kernel): the
// byte step's four gathers are one launch, and a single-arena gather is a
// group of one through the same kernel.
//
// Why it looks as it does:
// - The launcher takes the group as a small array of descriptors by value in
//   the kernel's parameters (up to kMaxArenas; per arena the table, index and
//   row pointers, N, M, the row's 16-byte words, the threads per row and the
//   first block): no device allocation and no host-to-device copy per call. A
//   block finds its arena from blockIdx.x, then moves rows as below. The
//   descriptor and the host code that fills it (fill_group) hold nothing of
//   the direction, so that a grouped scatter can take them as they are.
// - A group of threads moves one row, neighbouring threads on neighbouring
//   16-byte words (uint4 loads/stores, fully coalesced). Every row width of
//   the codec is a multiple of 16 bytes; the wrapper checks that. Rows of up
//   to 512 B get one warp; wider rows get the smallest power-of-two group
//   of threads that covers them, up to a whole 256-thread block, so that a
//   4 KB row is one coalesced wave instead of eight per warp.
// - The TPU kernel issued row copies from one scalar core and needed a ring
//   of DMA semaphores to overlap them; here every row is independent, so
//   all rows of the call are in flight at once across the SMs and no
//   ordering or staging through shared memory is needed.
// - Offsets are computed in int64: the indirect arena at the reference table
//   sizes is (16, 1543680, 256) u16, 6.3e9 elements.
// - The kernels copy raw bytes, so one kernel serves u16 and f32 arenas and
//   the result is bitwise identical to torch indexing by construction.
// - Indices are checked on the device (assert), like torch's own indexing
//   kernels; an out-of-range index is a fault, never a silent write.

#include <cassert>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// threads per row: one warp for rows of up to 32 words (512 B), else the
// smallest power of two >= the row's word count, capped at one block
int threads_per_row(int64_t vecs) {
  int tpr = 32;
  while (tpr < vecs && tpr < kThreads) tpr *= 2;
  return tpr;
}

constexpr int kMaxArenas = 8;

// one arena of a grouped launch, as the kernel reads it
struct ArenaDesc {
  void* tbl;           // (S, N, vecs) 16-byte words
  const int32_t* idx;  // (S, M)
  void* rows;          // (S, M, vecs): the gather's output, a scatter's input
  int64_t n_rows;      // N
  int64_t M;
  int64_t rows_total;  // S * M
  int vecs;            // 16-byte words per row
  int tpr_shift;       // log2 of the threads per row
  unsigned int first_block;
};

struct ArenaGroup {
  ArenaDesc a[kMaxArenas];
  int n;
};

__global__ void __launch_bounds__(kThreads) gather_rows_many_kernel(const __grid_constant__ ArenaGroup g) {
  int a = 0;
#pragma unroll
  for (int i = 1; i < kMaxArenas; ++i)
    if (i < g.n && blockIdx.x >= g.a[i].first_block) a = i;
  const ArenaDesc& d = g.a[a];
  const int tpr = 1 << d.tpr_shift;
  const int64_t r = (static_cast<int64_t>(blockIdx.x - d.first_block) << (8 - d.tpr_shift)) +
                    (threadIdx.x >> d.tpr_shift);
  if (r >= d.rows_total) return;
  const int64_t s = r / d.M;
  const int64_t row = d.idx[r];
  assert(row >= 0 && row < d.n_rows);
  const uint4* src = static_cast<const uint4*>(d.tbl) + (s * d.n_rows + row) * d.vecs;
  uint4* dst = static_cast<uint4*>(d.rows) + r * d.vecs;
  for (int v = threadIdx.x & (tpr - 1); v < d.vecs; v += tpr) dst[v] = src[v];
}

__global__ void scatter_rows_kernel(uint4* __restrict__ tbl,
                                    const int32_t* __restrict__ idx,
                                    const uint4* __restrict__ upd,
                                    int64_t n_rows, int64_t M, int64_t rows,
                                    int64_t vecs, int tpr) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (kThreads / tpr) +
                    threadIdx.x / tpr;
  if (r >= rows) return;
  const int64_t s = r / M;
  const int64_t row = idx[r];
  assert(row >= 0 && row < n_rows);
  const uint4* src = upd + r * vecs;
  uint4* dst = tbl + (s * n_rows + row) * vecs;
  for (int64_t v = threadIdx.x % tpr; v < vecs; v += tpr) dst[v] = src[v];
}

int launch_shape(int64_t S, int64_t M, int64_t row_bytes, int64_t* vecs,
                 int* tpr, int64_t* blocks) {
  if (S < 0 || M <= 0 || row_bytes <= 0 || row_bytes % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  *vecs = row_bytes / 16;
  *tpr = threads_per_row(*vecs);
  const int64_t rows_per_block = kThreads / *tpr;
  *blocks = (S * M + rows_per_block - 1) / rows_per_block;
  return 0;
}

// Fill the kernel's descriptors from the caller's (HostArena is the C
// interface's GmixRowArena) and count the blocks; arenas without rows take
// no block. Serves either direction.
template <typename HostArena>
int fill_group(const HostArena* arenas, int n, ArenaGroup* g, int64_t* blocks) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (n < 0 || n > kMaxArenas) return invalid;
  g->n = 0;
  *blocks = 0;
  for (int i = 0; i < n; ++i) {
    const HostArena& h = arenas[i];
    int64_t vecs, nb;
    int tpr;
    if (int rc = launch_shape(h.S, h.M, h.row_bytes, &vecs, &tpr, &nb)) return rc;
    if (h.N < 0 || vecs > INT32_MAX || *blocks + nb > INT32_MAX) return invalid;
    if (nb == 0) continue;
    ArenaDesc& d = g->a[g->n++];
    d.tbl = h.tbl;
    d.idx = h.idx;
    d.rows = h.rows;
    d.n_rows = h.N;
    d.M = h.M;
    d.rows_total = h.S * h.M;
    d.vecs = static_cast<int>(vecs);
    d.tpr_shift = 0;
    while ((1 << d.tpr_shift) < tpr) ++d.tpr_shift;
    d.first_block = static_cast<unsigned int>(*blocks);
    *blocks += nb;
  }
  return 0;
}

}  // namespace

// one arena of a grouped call, as the Python wrapper fills it (every field
// 8 bytes wide)
struct GmixRowArena {
  void* tbl;
  const int32_t* idx;
  void* rows;
  int64_t S, N, M, row_bytes;
};

extern "C" {

// Both entry points launch on `stream` (a cudaStream_t), do not
// synchronise, and return the launch's cudaError_t (0 on success).

// rows[a][s, m, :] = tbl[a][s, idx[a][s, m], :] for the n <= 8 arenas of
// `arenas`, in one launch
int gmix_gather_rows_many(const GmixRowArena* arenas, int n, void* stream) {
  ArenaGroup g;
  int64_t blocks;
  if (int rc = fill_group(arenas, n, &g, &blocks)) return rc;
  if (blocks == 0) return 0;
  gather_rows_many_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

int gmix_scatter_rows(void* tbl, const int32_t* idx, const void* upd,
                      int64_t S, int64_t N, int64_t M, int64_t row_bytes,
                      void* stream) {
  int64_t vecs, blocks;
  int tpr;
  if (int rc = launch_shape(S, M, row_bytes, &vecs, &tpr, &blocks)) return rc;
  if (blocks == 0) return 0;
  scatter_rows_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(tbl), idx, static_cast<const uint4*>(upd), N, M,
      S * M, vecs, tpr);
  return static_cast<int>(cudaGetLastError());
}

const char* gmix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
