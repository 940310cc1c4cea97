// The PPM byte model's two boundary computations for Hopper (sm_90a), between
// the row movers' gather and scatter of `ppm_tbl` rows (core/ppm.py):
//
//   ppm_update_kernel:  the count update with the completed byte: tag check,
//                       exclusion cascade, learned escapes, the SEE learn,
//                       the increment under update exclusion, the rescale and
//                       the owner tag; writes the rows to scatter and the new
//                       `ppm_see`
//   ppm_predict_kernel: the next-byte distribution from the new contexts'
//                       rows: the cascade, the escape weight chain highest
//                       order first, the uniform order -1; writes `ppm_probs`,
//                       `ppm_top`, `ppm_bot`
//
// Replaces no TPU kernel: gmix_tpu computes the cascade in plain jnp outside
// any pallas_call (gmix_tpu/core/step.py _ppm_update, _ppm_predict). Its plain
// version here, core/ppm.py, is about 330 small torch ops a byte step, each a
// node of the step's CUDA graph at about 1.6 us for almost no data.
//
// What bounds it on this card: neither bytes nor operations. A stream moves
// 9 rows of 544 B in and out and does ~9 x 256 x 20 integer and float ops;
// at 54 streams that is 1.6 MB, 0.5 us at 3.35 TB/s. What is left is the
// launch and one dependent chain per order (logit, logistic: ~60 float ops)
// and the 9-step weight chain. So the design spends no launch and no pass
// over memory it can avoid:
// - one block of 256 threads a stream, one thread a symbol lane. A thread
//   keeps its lane's counts at every order in registers (orders <= 16, loops
//   unrolled). It issues every load at once, orders past the runtime count
//   reading the last order again, so that the block waits for memory once:
//   a load behind a branch on the order count would wait for the one
//   before it, 18 memory latencies in a row;
// - the escape offsets of the stream go to shared memory beside the rows,
//   so that the order scalars and the SEE learn read no global memory;
// - exclusion (any higher order saw the symbol) and `higher_found` are a
//   per-thread loop from the top order, not cumulative sums;
// - one reduction round gives every order's masked total, distinct count
//   and (update) tag-checked row sum: warp shuffles of (total << 6 | nonzero)
//   and the row sum, then the 8 warps' partials through shared memory. A
//   warp's total is at most 32 x 65535 < 2^21, so the packed sum fits 31 bits;
// - lanes 0 .. NO-1 of warp 0 take one order each for its scalars (has,
//   PPM-C prior, bucket, escape); everything else is lane-parallel again;
// - the update needs the row total after the increment, which is the row sum
//   plus the increment when it lands (one lane gets it), so no second
//   reduction.
//
// Exactness (the decoder replays these bits; the kernels equal the plain
// version bit for bit, tests/test_torch_kernels.py):
// - counts are u16 and a row has 256 lanes, so every total is at most
//   16 776 960 < 2^24: integer sums converted to float equal the plain
//   version's fixed float tree (_tree_sum), and total + distinct is exact;
// - adj is the plain version's (see * one-hot).sum over the buckets, a sum
//   with one nonzero term: the selected bucket's offset. Its zero's sign
//   cannot reach the escape (the logit is +0 or nonzero);
// - every float op is detmath.cuh's (never contracted, never approximate),
//   in the plain version's order: ppmc = distinct / max(total + distinct, 1),
//   esc = logistic(logit(ppmc) + adj), terms = (contrib * count) /
//   max(total, 1), p from +0 highest order first, then + w * uni;
// - the SEE learn is flush(flush(see) + onehot * delta) at every bucket,
//   the zero products included: 0 * (negative delta) is -0, and -0 + +0 is +0
//   where the flushed offset was -0. flush(x) = |x| < FLT_MIN ? x * 0 : x.

#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

#include "detmath.cuh"

// the kernels' arguments, as the Python wrapper fills them (core/ppm.py
// _PpmArgs); a field a kernel does not use may be null
struct GmixPpmArgs {
  const uint16_t* raw;       // (S, NO, kRowW) gathered rows, u16 bits
  const int64_t* cv;         // (S, NO) the orders' context values (u32)
  const int64_t* completed;  // (S,) the completed byte (update)
  const float* see;          // (S, NO, NB) learned escape offsets
  uint16_t* rows_out;        // (S, NO, kRowW) rows to scatter (update)
  float* see_out;            // (S, NO, NB) (update)
  float* probs;              // (S, 256) (predict)
  int32_t* top;              // (S,) (predict)
  int32_t* bot;              // (S,) (predict)
  int64_t S, NO, NB, inc, rescale_total, exclusion, update_exclusion;
  float see_lr;
};

namespace {

using namespace gmix;

constexpr int kLanes = 256;  // symbols, one thread each
constexpr int kWarps = kLanes / 32;
constexpr int kRowW = 272;  // u16 lanes of a ppm_tbl row (core/meta.py PPM_ROW_W)
constexpr int kTagLane = 256;  // PPM_TAG_LANE
constexpr int kMaxOrders = 16;
constexpr int kMaxBuckets = 64;
constexpr float kFltMin = 1.17549435082228750797e-38f;  // numpy's finfo(float32).tiny
constexpr float kUniform = static_cast<float>(1.0 / 256);

// x with a denormal as a signed zero (core/ppm.py _flush)
__device__ __forceinline__ float flush(float x) { return fabsf(x) < kFltMin ? fmul(x, 0.0f) : x; }

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int context_tag(int64_t cv) { return static_cast<int>((cv >> 24) & 255); }

// Thread k's lane of the stream's rows: per order i, the count bits as
// stored, the row's tag and this context's tag, the tag-checked count r[i]
// (0 past NO or where the row's tag is another context's) and the count
// under exclusion m[i] (0 where a higher order saw k); whether any order
// saw k.
struct Lane {
  uint16_t bits[kMaxOrders];
  uint32_t tags[kMaxOrders];  // stored tag | this context's tag << 16
  int r[kMaxOrders], m[kMaxOrders];
  bool seen;
};

__device__ __forceinline__ void load_lane(const uint16_t* raw, const int64_t* cv, int NO, int k, bool exclusion,
                                          Lane& l) {
#pragma unroll
  for (int i = 0; i < kMaxOrders; ++i) {
    const int j = min(i, NO - 1);  // no branch: every load in flight at once
    const uint16_t* row = raw + j * kRowW;
    l.bits[i] = row[k];
    l.tags[i] = static_cast<uint32_t>(row[kTagLane]) | (static_cast<uint32_t>(context_tag(cv[j])) << 16);
  }
#pragma unroll
  for (int i = 0; i < kMaxOrders; ++i)
    l.r[i] = i < NO && (l.tags[i] & 0xFFFFu) == (l.tags[i] >> 16) ? l.bits[i] : 0;
  l.seen = false;
#pragma unroll
  for (int i = kMaxOrders - 1; i >= 0; --i) {
    l.m[i] = exclusion && l.seen ? 0 : l.r[i];
    l.seen = l.seen || l.r[i] > 0;
  }
}

// The stream's escape offsets (NO x NB floats) into shared memory
__device__ __forceinline__ void load_see(const float* see, int n, float* see_s) {
  for (int t = threadIdx.x; t < n; t += kLanes) see_s[t] = see[t];
}

// Warp w's share of each order's masked total and distinct count, packed as
// total << 6 | distinct, into packed[i][w]; with `rsum`, of the tag-checked
// row sums too
__device__ __forceinline__ void warp_partials(const int (&m)[kMaxOrders], const int (&r)[kMaxOrders], int NO,
                                              int (*packed)[kWarps], int (*rsum)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kMaxOrders; ++i) {
    if (i < NO) {
      const int pk = warp_sum((m[i] << 6) | (m[i] > 0 ? 1 : 0));
      const int rs = rsum ? warp_sum(r[i]) : 0;
      if (lane == 0) {
        packed[i][warp] = pk;
        if (rsum) rsum[i][warp] = rs;
      }
    }
  }
}

// One order's scalars from the warps' partials: total and distinct count
// under exclusion, and the escape probability
struct OrderStats {
  int total, distinct;
  float esc;
  int bucket;
};

__device__ __forceinline__ OrderStats order_stats(const int* packed, const float* see, int NB) {
  OrderStats o{0, 0, 0.0f, 0};
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    o.total += packed[w] >> 6;
    o.distinct += packed[w] & 63;
  }
  const float total = __int2float_rn(o.total), distinct = __int2float_rn(o.distinct);
  const float ppmc = fdiv(distinct, fmaxf(fadd(total, distinct), 1.0f));
  o.bucket = min(o.distinct, NB - 1);
  o.esc = logistic(fadd(logit(ppmc), see[o.bucket]));
  return o;
}

__global__ void __launch_bounds__(kLanes) ppm_update_kernel(const __grid_constant__ GmixPpmArgs a) {
  const int s = blockIdx.x, k = threadIdx.x, lane = k & 31;
  const int NO = static_cast<int>(a.NO), NB = static_cast<int>(a.NB);
  const uint16_t* raw = a.raw + static_cast<int64_t>(s) * NO * kRowW;
  const int64_t* cv = a.cv + static_cast<int64_t>(s) * NO;
  const float* see = a.see + static_cast<int64_t>(s) * NO * NB;
  const int64_t c = a.completed[s];

  __shared__ int packed[kMaxOrders][kWarps], rsum[kMaxOrders][kWarps];
  __shared__ float see_s[kMaxOrders * kMaxBuckets], esc_s[kMaxOrders];
  __shared__ int bucket_s[kMaxOrders], rowsum_s[kMaxOrders];
  __shared__ uint32_t codable_s, has_s, found_s;

  Lane l;
  load_lane(raw, cv, NO, k, a.exclusion != 0, l);
  load_see(see, NO * NB, see_s);
  assert(c >= 0 && c < kLanes);
  warp_partials(l.m, l.r, NO, packed, rsum);
  if (k == c) {
    // the orders at which the completed byte was codable under exclusion
    uint32_t bits = 0;
#pragma unroll
    for (int i = 0; i < kMaxOrders; ++i) bits |= (l.m[i] > 0 ? 1u : 0u) << i;
    codable_s = bits;
  }
  __syncthreads();

  if (k < 32) {
    const bool on = lane < NO;
    const int i = on ? lane : 0;
    const OrderStats o = order_stats(packed[i], see_s + i * NB, NB);
    int rs = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) rs += rsum[i][w];
    const bool has = o.total > 0;
    // found: the byte was codable at the order; the cascade stops at the
    // highest such order
    const uint32_t has_bits = __ballot_sync(0xffffffffu, on && has);
    const uint32_t found_bits = __ballot_sync(0xffffffffu, on && has && ((codable_s >> i) & 1));
    if (on) {
      esc_s[i] = o.esc;
      bucket_s[i] = o.bucket;
      rowsum_s[i] = rs;
    }
    if (lane == 0) {
      has_s = has_bits;
      found_s = found_bits;
    }
  }
  __syncthreads();
  const uint32_t found = found_s, has = has_s;

  // SEE learn: at exercised orders (has, and no higher order found) the
  // escape moves toward the observed event; every bucket is rewritten
  float* see_out = a.see_out + static_cast<int64_t>(s) * NO * NB;
  for (int t = k; t < NO * NB; t += kLanes) {
    const int i = t / NB, b = t - i * NB;
    const bool exercised = ((has >> i) & 1) && (found >> (i + 1)) == 0;
    const float target = (found >> i) & 1 ? 0.0f : 1.0f;
    const float delta = exercised ? fmul(a.see_lr, fsub(target, esc_s[i])) : 0.0f;
    const float oh = b == bucket_s[i] ? 1.0f : 0.0f;
    see_out[t] = flush(fadd(flush(see_s[t]), fmul(oh, delta)));
  }

  // counts: the increment at orders at and above the coded one (all orders
  // without update exclusion), halved above rescale_total; an updated row
  // takes this context's tag, an untouched row keeps its bits and owner
  uint16_t* out = a.rows_out + static_cast<int64_t>(s) * NO * kRowW;
  const int inc = static_cast<int>(a.inc), rescale_total = static_cast<int>(a.rescale_total);
#pragma unroll
  for (int i = 0; i < kMaxOrders; ++i) {
    if (i < NO) {
      const bool inc_on = !a.update_exclusion || (found >> (i + 1)) == 0;
      const int add = inc_on ? inc : 0;
      const int v = l.r[i] + (k == c ? add : 0);
      const int scaled = rowsum_s[i] + add > rescale_total ? (v + 1) >> 1 : v;
      out[i * kRowW + k] = inc_on ? static_cast<uint16_t>(scaled) : l.bits[i];
      if (k < kRowW - kLanes) {
        const uint32_t tag = inc_on ? l.tags[i] >> 16 : l.tags[i] & 0xFFFFu;
        out[i * kRowW + kLanes + k] = static_cast<uint16_t>(k == 0 ? tag : 0);
      }
    }
  }
}

__global__ void __launch_bounds__(kLanes) ppm_predict_kernel(const __grid_constant__ GmixPpmArgs a) {
  const int s = blockIdx.x, k = threadIdx.x, lane = k & 31;
  const int NO = static_cast<int>(a.NO), NB = static_cast<int>(a.NB);
  const uint16_t* raw = a.raw + static_cast<int64_t>(s) * NO * kRowW;
  const int64_t* cv = a.cv + static_cast<int64_t>(s) * NO;
  const float* see = a.see + static_cast<int64_t>(s) * NO * NB;

  __shared__ int packed[kMaxOrders][kWarps];
  __shared__ float see_s[kMaxOrders * kMaxBuckets], esc_s[kMaxOrders], keep_s[kMaxOrders], total_s[kMaxOrders];
  __shared__ uint32_t has_s;

  Lane l;
  load_lane(raw, cv, NO, k, a.exclusion != 0, l);
  load_see(see, NO * NB, see_s);
  const bool excluded = l.seen && a.exclusion;
  warp_partials(l.m, l.r, NO, packed, nullptr);
  // order -1's symbols: those no order saw (all of them without exclusion)
  const int nex = __syncthreads_count(!excluded);

  if (k < 32) {
    const bool on = lane < NO;
    const int i = on ? lane : 0;
    const OrderStats o = order_stats(packed[i], see_s + i * NB, NB);
    const uint32_t has_bits = __ballot_sync(0xffffffffu, on && o.total > 0);
    if (on) {
      esc_s[i] = o.esc;
      keep_s[i] = fsub(1.0f, o.esc);
      total_s[i] = __int2float_rn(o.total);
    }
    if (lane == 0) has_s = has_bits;
  }
  __syncthreads();

  // the escape weight w, highest order first, and p accumulated from +0 in
  // the same order
  const uint32_t has = has_s;
  float w = 1.0f, p = 0.0f;
#pragma unroll
  for (int i = kMaxOrders - 1; i >= 0; --i) {
    if (i < NO) {
      const bool h = (has >> i) & 1;
      const float contrib = h ? fmul(w, keep_s[i]) : 0.0f;
      w = h ? fmul(w, esc_s[i]) : w;
      p = fadd(p, fdiv(fmul(contrib, __int2float_rn(l.m[i])), fmaxf(total_s[i], 1.0f)));
    }
  }
  const float nexf = __int2float_rn(nex);
  const float uni = nex > 0 ? fdiv(excluded ? 0.0f : 1.0f, fmaxf(nexf, 1.0f)) : kUniform;
  a.probs[static_cast<int64_t>(s) * kLanes + k] = fadd(p, fmul(w, uni));
  if (k == 0) {
    a.top[s] = 255;
    a.bot[s] = 0;
  }
}

int check_args(const GmixPpmArgs* a) {
  if (a->S < 0 || a->S > INT32_MAX || a->NO < 1 || a->NO > kMaxOrders || a->NB < 1 || a->NB > kMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

// Both entry points launch one block a stream on `stream` (a cudaStream_t),
// do not synchronise, and return the launch's cudaError_t (0 on success).

int gmix_ppm_update(const GmixPpmArgs* a, void* stream) {
  if (int rc = check_args(a)) return rc;
  if (a->S == 0) return 0;
  ppm_update_kernel<<<static_cast<unsigned int>(a->S), kLanes, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

int gmix_ppm_predict(const GmixPpmArgs* a, void* stream) {
  if (int rc = check_args(a)) return rc;
  if (a->S == 0) return 0;
  ppm_predict_kernel<<<static_cast<unsigned int>(a->S), kLanes, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// Load both kernels on the current device (what their first launch does), so
// that a CUDA graph capture, which records launches only, finds them loaded.
// Launches nothing.
int gmix_ppm_prepare(void) {
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, ppm_update_kernel);
  if (rc == cudaSuccess) rc = cudaFuncGetAttributes(&attr, ppm_predict_kernel);
  return static_cast<int>(rc);
}

}  // extern "C"
