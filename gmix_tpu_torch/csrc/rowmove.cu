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
// indirect blocks and mixer rows, 4 KB position blocks, 1056 B APM rows,
// 544 B PPM count rows), 65 to 83 rows per stream each way, out of arenas
// many times larger than the L2 cache, so almost every row is a cold read
// from HBM. There is no arithmetic at all.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, a launch per arena took
// 2.8-3.5 us on the device for 0.02-0.2 us of bytes, and more than that on
// the host: launches, not bytes, are what a byte step pays for. So each
// mover takes a group of arenas in ONE launch (gather_rows_many_kernel,
// scatter_rows_many_kernel): the byte step's gathers are one launch, its
// byte-end scatters another, and a single-arena call is a group of one
// through the same kernel. The four arenas of a byte step then take 3.3 us
// (scatter) to 3.8 us (gather) in one launch against 11.3 and 12.9 us in
// four; an empty kernel launched the same way takes 1.8 us.
//
// Why it looks as it does:
// - The launcher takes the group as a small array of descriptors by value in
//   the kernel's parameters (up to kMaxArenas; per arena the table, index and
//   row pointers, N, M, the row's 16-byte words, the threads per row and the
//   first block): no device allocation and no host-to-device copy per call. A
//   block finds its arena from blockIdx.x, then moves rows as below. The
//   descriptor, the host code that fills it (fill_group) and the row a
//   thread group owns (find_row) hold nothing of the direction: the two
//   kernels differ only in which side of the copy is the table.
// - A group of threads moves one row, neighbouring threads on neighbouring
//   16-byte words (uint4 loads/stores, fully coalesced). Every row width of
//   the codec is a multiple of 16 bytes; the wrapper checks that. Rows of up
//   to 512 B get one warp; wider rows get the smallest power-of-two group
//   of threads that covers them, up to a whole 256-thread block, so that a
//   4 KB row is one coalesced wave instead of eight per warp. A row whose
//   word count is no power of two (the PPM rows: 34 words) leaves the
//   group's last lanes idle.
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

// The row this thread's group moves: its arena, the row's number r among the
// S * M rows of the call, its first word in the table and in the packed
// rows, and this thread's lane within the group. False where the group has
// no row (the ragged end of an arena's last block).
struct RowRef {
  uint4* tbl;
  uint4* packed;
  int vecs, lane, tpr;
};

__device__ __forceinline__ bool find_row(const ArenaGroup& g, RowRef* ref) {
  int a = 0;
#pragma unroll
  for (int i = 1; i < kMaxArenas; ++i)
    if (i < g.n && blockIdx.x >= g.a[i].first_block) a = i;
  const ArenaDesc& d = g.a[a];
  const int tpr = 1 << d.tpr_shift;
  const int64_t r = (static_cast<int64_t>(blockIdx.x - d.first_block) << (8 - d.tpr_shift)) +
                    (threadIdx.x >> d.tpr_shift);
  if (r >= d.rows_total) return false;
  const int64_t s = r / d.M;
  const int64_t row = d.idx[r];
  assert(row >= 0 && row < d.n_rows);
  ref->tbl = static_cast<uint4*>(d.tbl) + (s * d.n_rows + row) * d.vecs;
  ref->packed = static_cast<uint4*>(d.rows) + r * d.vecs;
  ref->vecs = d.vecs;
  ref->lane = threadIdx.x & (tpr - 1);
  ref->tpr = tpr;
  return true;
}

__global__ void __launch_bounds__(kThreads) gather_rows_many_kernel(const __grid_constant__ ArenaGroup g) {
  RowRef r;
  if (!find_row(g, &r)) return;
  for (int v = r.lane; v < r.vecs; v += r.tpr) r.packed[v] = r.tbl[v];
}

__global__ void __launch_bounds__(kThreads) scatter_rows_many_kernel(const __grid_constant__ ArenaGroup g) {
  RowRef r;
  if (!find_row(g, &r)) return;
  for (int v = r.lane; v < r.vecs; v += r.tpr) r.tbl[v] = r.packed[v];
}

__global__ void __launch_bounds__(kThreads) empty_kernel(const __grid_constant__ ArenaGroup g) {}

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
    if (h.S < 0 || h.N < 0 || h.M <= 0 || h.row_bytes <= 0 || h.row_bytes % 16 != 0) return invalid;
    const int64_t vecs = h.row_bytes / 16;
    const int tpr = threads_per_row(vecs);
    const int64_t rows_per_block = kThreads / tpr;
    const int64_t nb = (h.S * h.M + rows_per_block - 1) / rows_per_block;
    if (vecs > INT32_MAX || *blocks + nb > INT32_MAX) return invalid;
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

// Both entry points take the n <= 8 arenas of `arenas` in one launch on
// `stream` (a cudaStream_t), do not synchronise, and return the launch's
// cudaError_t (0 on success).

// rows[a][s, m, :] = tbl[a][s, idx[a][s, m], :]
int gmix_gather_rows_many(const GmixRowArena* arenas, int n, void* stream) {
  ArenaGroup g;
  int64_t blocks;
  if (int rc = fill_group(arenas, n, &g, &blocks)) return rc;
  if (blocks == 0) return 0;
  gather_rows_many_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// tbl[a][s, idx[a][s, m], :] = rows[a][s, m, :] in place; the tables are
// distinct and idx[a] is unique within each stream, so no two rows race
int gmix_scatter_rows_many(const GmixRowArena* arenas, int n, void* stream) {
  ArenaGroup g;
  int64_t blocks;
  if (int rc = fill_group(arenas, n, &g, &blocks)) return rc;
  if (blocks == 0) return 0;
  scatter_rows_many_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel launched as the movers are (the same parameter block, one
// block of kThreads): what a launch costs on the device before any byte
// moves. For measurement only.
int gmix_empty_launch(void* stream) {
  ArenaGroup g = {};
  empty_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// Load both movers' kernels on the current device (what their first launch
// does), so that a CUDA graph capture, which records launches only, finds
// them loaded. Launches nothing.
int gmix_rowmove_prepare(void) {
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, gather_rows_many_kernel);
  if (rc == cudaSuccess) rc = cudaFuncGetAttributes(&attr, scatter_rows_many_kernel);
  return static_cast<int>(rc);
}

const char* gmix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
