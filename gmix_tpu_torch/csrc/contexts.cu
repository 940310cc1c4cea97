// The byte step's boundary contexts and match pointers for Hopper (sm_90a)
// (core/contexts.py):
//
//   contexts_boundary_kernel: after the PPM count update, the completed byte
//                             into `last_byte` and the recent-byte ring, and
//                             every context the byte boundary recomputes: the
//                             byte columns of `ctx`, the interval, skip,
//                             rolling-hash and indirect-hash slots, the
//                             `ih_tbl` write, `roll_h`, `ih_outer_ctx`,
//                             `ih_outer_hash`; `acc` zeroed
//   match_pointer_kernel:     after the LSTM's forward pass, each match
//                             model's length rule, its `match_tbl` read, the
//                             pointer rule and its `hist` read; writes
//                             `match_ptr`, `match_byte`, `match_len` and the
//                             rows `match_ix` that the byte end writes
//
// Replaces no TPU kernel: gmix_tpu computes both in plain jnp outside any
// pallas_call (gmix_tpu/core/step.py `_boundary`, the match block of
// `_byte_step`). Their plain versions here, core/contexts.py, are ~340 small
// torch ops a byte step, each a node of the step's CUDA graph at about 1.2 us
// for a few hundred bytes.
//
// What bounds it on this card: latency alone. A stream reads and writes a
// few hundred bytes (20 recent bytes, ~50 context slots, 9 + 9 indirect-hash
// words, 6 + 6 match words and bytes): at 54 streams ~40 KB, 12 ns at
// 3.35 TB/s. So each kernel is one launch and one short dependent chain:
// - the boundary: one block of 64 threads a stream. The recent ring goes
//   through shared memory (the shift reads what a neighbour writes); every
//   context slot is then one thread's task, the indirect-hash contexts (the
//   longest chains: a read of `ih_tbl`, its write, a murmur hash, a second
//   read) on the lowest threads. The slots a task writes are distinct and the
//   one slot a task reads (an interval context's old value) is its own, so
//   the tasks need no barrier;
// - the match pointers: one thread a (stream, match model), 128 a block; the
//   `match_tbl` read is issued unconditionally, before the length rule
//   decides whether it is taken.
//
// Exactness (the decoder replays these values; the kernels equal the plain
// version bit for bit, tests/test_torch_kernels.py): it is integer work
// alone. u32 values are int64 in the state (state.py), and the arithmetic is
// the plain version's in uint64, which wraps as int64 does, masked where it
// masks; MurmurHash3 in uint32 equals ops/murmur.py's int64 lanes, whose
// every multiply and rotation is taken mod 2^32. Within an indirect-hash
// context the `ih_tbl` write comes before the read of the new index, which
// may be the same word; contexts own disjoint ranges of `ih_tbl`, so the one
// thread's program order is the plain version's order. The stream's first
// byte (t == 0) keeps `last_byte`, the ring and `roll_h`, as `not_first`
// selects in the plain version; t is read on the device.

#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

// The kernels' arguments, as the Python wrapper fills them (core/contexts.py
// _ContextsArgs, _MatchArgs). `consts` is the plan's table of each part's
// constants, laid out as core/contexts.py `boundary_table` / `match_table`
// write it. A pointer of a part the spec does not have may be null.
struct GmixContextsArgs {
  const int64_t* t;         // () the byte index
  int64_t* acc;             // (S,) the completed byte; zeroed
  int64_t* last_byte;       // (S,)
  int64_t* recent;          // (S, R)
  int64_t* ctx;             // (S, n_ctx) u32 context values
  int64_t* roll_h;          // (S, NR)
  int32_t* ih_tbl;          // (S, ih_total) u32 bits
  int64_t* ih_outer_ctx;    // (S, NIH)
  int64_t* ih_outer_hash;   // (S, NIH)
  const int64_t* consts;    // boundary_table
  int64_t S, R, n_ctx, NI, NSK, NR, NIH, ih_total;
};

struct GmixMatchArgs {
  const int64_t* new_bit;   // (S,)
  const int64_t* hist_n;    // (S,)
  const int64_t* ctx;       // (S, n_ctx)
  int64_t* match_ptr;       // (S, NM)
  int64_t* match_byte;      // (S, NM)
  int32_t* match_len;       // (S, NM)
  const int32_t* match_tbl; // (S, match_total) u32 bits
  const uint8_t* hist;      // (S, history_size)
  int64_t* match_ix;        // (S, NM) out: the rows of match_tbl
  const int64_t* consts;    // match_table
  int64_t S, NM, n_ctx, match_total, history_size;
};

namespace {

constexpr int kThreads = 64;       // boundary: a block a stream
constexpr int kMatchThreads = 128; // match pointers: a thread a (stream, model)
constexpr int kByteCols = 10;      // last_byte and recent_1 .. recent_9 (core/meta.py byte_ctx_cols)
constexpr int kMaxSkip = 8;        // core/meta.py MAX_SKIP
constexpr int kMaxRecent = 256;
// the table's entries per context of each kind (core/contexts.py)
constexpr int kInterval = 3, kSkip = 1 + 3 * kMaxSkip, kRoll = 3, kIhash = 5, kMatch = 3;
constexpr uint64_t kMask32 = 0xFFFFFFFFull;
constexpr uint32_t kSeed = 0xDEADBEEFu;
constexpr uint32_t kRollBase = 0x01000193u;  // core/meta.py ROLL_BASE

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

__device__ __forceinline__ uint32_t mix_block(uint32_t h1, uint32_t k1) {
  k1 *= 0xCC9E2D51u;
  k1 = rotl32(k1, 15);
  k1 *= 0x1B873593u;
  h1 ^= k1;
  h1 = rotl32(h1, 13);
  return h1 * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// ops/murmur.py murmur3_u64 / murmur3_u32 on the low 32 bits of each lane
__device__ __forceinline__ int64_t murmur_u64(uint64_t lo, uint64_t hi) {
  return fmix32(mix_block(mix_block(kSeed, static_cast<uint32_t>(lo)), static_cast<uint32_t>(hi)) ^ 8u);
}
__device__ __forceinline__ int64_t murmur_u32(uint64_t x) {
  return fmix32(mix_block(kSeed, static_cast<uint32_t>(x)) ^ 4u);
}

__device__ __forceinline__ uint64_t u(int64_t x) { return static_cast<uint64_t>(x); }

__global__ void __launch_bounds__(kThreads) contexts_boundary_kernel(const __grid_constant__ GmixContextsArgs a) {
  const int s = blockIdx.x, k = threadIdx.x;
  const int R = static_cast<int>(a.R), NI = static_cast<int>(a.NI), NSK = static_cast<int>(a.NSK);
  const int NR = static_cast<int>(a.NR), NIH = static_cast<int>(a.NIH);
  __shared__ int64_t old_ring[kMaxRecent], ring[kMaxRecent];

  const bool not_first = *a.t > 0;
  const int64_t completed = a.acc[s];
  const int64_t lb = not_first ? completed : a.last_byte[s];
  int64_t* recent = a.recent + static_cast<int64_t>(s) * R;
  for (int i = k; i < R; i += kThreads) old_ring[i] = recent[i];
  __syncthreads();
  for (int i = k; i < R; i += kThreads) ring[i] = not_first ? (i == 0 ? completed : old_ring[i - 1]) : old_ring[i];
  __syncthreads();

  int64_t* ctx = a.ctx + static_cast<int64_t>(s) * a.n_ctx;
  const int64_t* byte_cols = a.consts;
  const int64_t* interval = byte_cols + kByteCols;
  const int64_t* maps = interval + kInterval * NI;
  const int64_t* skip = maps + 256 * NI;
  const int64_t* roll = skip + kSkip * NSK;
  const int64_t* ihash = roll + kRoll * NR;
  const int tasks = NIH + kByteCols + NI + NSK + NR;
  for (int j = k; j < tasks; j += kThreads) {
    int i = j;
    if (i < NIH) {
      // indirect-hash context i (indirect-hash.cpp:16-31)
      const int64_t* c = ihash + kIhash * i;
      const int64_t off = c[0], mask = c[1], imask = c[2], omask = c[3];
      int32_t* tbl = a.ih_tbl + static_cast<int64_t>(s) * a.ih_total;
      const int64_t at = static_cast<int64_t>(s) * NIH + i;
      const int64_t old_idx = (a.ih_outer_hash[at] & mask) + off;
      assert(old_idx >= 0 && old_idx < a.ih_total);
      const uint64_t inner = u(tbl[old_idx]) & kMask32;
      tbl[old_idx] = static_cast<int32_t>(static_cast<uint32_t>(((inner & u(imask)) << 8) + u(lb)));
      const int64_t outer_new = static_cast<int64_t>(((u(a.ih_outer_ctx[at]) & u(omask)) << 8) + u(lb));
      const int64_t new_hash = murmur_u64(u(outer_new), 0);
      const int64_t new_idx = (new_hash & mask) + off;
      assert(new_idx >= 0 && new_idx < a.ih_total);
      ctx[c[4]] = murmur_u32(u(tbl[new_idx]) & kMask32);
      a.ih_outer_ctx[at] = outer_new;
      a.ih_outer_hash[at] = new_hash;
      continue;
    }
    i -= NIH;
    if (i < kByteCols) {
      ctx[byte_cols[i]] = i == 0 ? lb : ring[i];
      continue;
    }
    i -= kByteCols;
    if (i < NI) {
      // interval context i (interval-context.cpp:17-23)
      const int64_t* c = interval + kInterval * i;
      assert(lb >= 0 && lb < 256);
      const uint64_t v = u(maps[256 * i + lb]);
      ctx[c[0]] = static_cast<int64_t>(u(c[2]) & ((u(ctx[c[0]]) << c[1]) + v));
      continue;
    }
    i -= NI;
    if (i < NSK) {
      // skip context i (skip-context.cpp:9-19): bytes packed big-endian into
      // a u64; a shift of -1 leaves the byte out of that half
      const int64_t* c = skip + kSkip * i;
      uint64_t lo = 0, hi = 0;
#pragma unroll
      for (int q = 0; q < kMaxSkip; ++q) {
        const uint64_t b = u(ring[c[1 + 3 * q]]);
        const int64_t lo_sh = c[2 + 3 * q], hi_sh = c[3 + 3 * q];
        lo += lo_sh >= 0 ? b << lo_sh : 0;
        hi += hi_sh >= 0 ? b << hi_sh : 0;
      }
      ctx[c[0]] = murmur_u64(lo & kMask32, hi & kMask32);
      continue;
    }
    i -= NSK;
    // rolling-hash context i: h' = (h - leaving * B^(n-1)) * B + completed
    // over the pre-shift ring, the difference masked to 32 bits
    const int64_t* c = roll + kRoll * i;
    const int64_t at = static_cast<int64_t>(s) * NR + i;
    const int64_t h_old = a.roll_h[at];
    const uint32_t diff = static_cast<uint32_t>(u(h_old) - u(old_ring[c[1]]) * u(c[2]));
    const int64_t h_rolled = static_cast<int64_t>((u(diff * kRollBase) + u(completed)) & kMask32);
    const int64_t h_new = not_first ? h_rolled : h_old;
    ctx[c[0]] = murmur_u32(u(h_new));
    a.roll_h[at] = h_new;
  }

  for (int i = k; i < R; i += kThreads) recent[i] = ring[i];
  if (k == 0) {
    a.last_byte[s] = lb;
    a.acc[s] = 0;
  }
}

__global__ void __launch_bounds__(kMatchThreads) match_pointer_kernel(const __grid_constant__ GmixMatchArgs a) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kMatchThreads + threadIdx.x;
  if (j >= a.S * a.NM) return;
  const int64_t s = j / a.NM, m = j - s * a.NM;
  const int64_t* c = a.consts + kMatch * m;
  const int64_t match_ix = (a.ctx[s * a.n_ctx + c[0]] & c[1]) + c[2];
  assert(match_ix >= 0 && match_ix < a.match_total);
  const uint64_t tbl_ptr = u(a.match_tbl[s * a.match_total + match_ix]) & kMask32;
  const int64_t hist_n = a.hist_n[s], ptr = a.match_ptr[j], byte = a.match_byte[j];
  // match.cpp:38-58: the length grows on a hit (to 255) and restarts on a
  // miss or where the pointer is the last history byte; a short match takes
  // the table's pointer, a long one steps on
  const bool hit = a.new_bit[s] == ((byte & 1) != 0 ? 1 : 0);
  int32_t len = hit ? min(static_cast<int32_t>(static_cast<uint32_t>(a.match_len[j]) + 1u), 255) : 0;
  if (u(ptr) == ((u(hist_n) - 1) & kMask32)) len = 0;
  const int64_t mptr = static_cast<int64_t>(len < 8 ? tbl_ptr : (u(ptr) + 1) & kMask32);
  const uint8_t hb = a.hist[s * a.history_size + (mptr & (a.history_size - 1))];
  a.match_ptr[j] = mptr;
  a.match_byte[j] = hist_n > 0 ? static_cast<int64_t>(hb) : byte;
  a.match_len[j] = len;
  a.match_ix[j] = match_ix;
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

extern "C" {

// Both entry points launch on `stream` (a cudaStream_t), do not synchronise,
// and return the launch's cudaError_t (0 on success).

int gmix_contexts_boundary(const GmixContextsArgs* a, void* stream) {
  if (a->S < 0 || a->S > INT32_MAX || a->R < kByteCols || a->R > kMaxRecent || a->n_ctx < 1 || a->NI < 0 ||
      a->NSK < 0 || a->NR < 0 || a->NIH < 0 || (a->NIH > 0 && a->ih_total < 1))
    return invalid();
  if (a->S == 0) return 0;
  contexts_boundary_kernel<<<static_cast<unsigned int>(a->S), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

int gmix_match_pointer(const GmixMatchArgs* a, void* stream) {
  const int64_t n = a->S * a->NM;
  if (a->S < 0 || a->NM < 1 || a->n_ctx < 1 || a->match_total < 1 || a->history_size < 1 ||
      (a->history_size & (a->history_size - 1)) != 0 || n > static_cast<int64_t>(INT32_MAX))
    return invalid();
  if (n == 0) return 0;
  const unsigned int blocks = static_cast<unsigned int>((n + kMatchThreads - 1) / kMatchThreads);
  match_pointer_kernel<<<blocks, kMatchThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// Load both kernels on the current device (what their first launch does), so
// that a CUDA graph capture, which records launches only, finds them loaded.
// Launches nothing.
int gmix_contexts_prepare(void) {
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, contexts_boundary_kernel);
  if (rc == cudaSuccess) rc = cudaFuncGetAttributes(&attr, match_pointer_kernel);
  return static_cast<int>(rc);
}

}  // extern "C"
