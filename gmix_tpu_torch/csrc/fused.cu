// The 8 bit sub-steps of one byte for every stream, as one kernel for Hopper
// (sm_90a).
//
// Replaces gmix_tpu/core/fused.py:_kernel_body, the TPU kernel that ran the
// sub-steps of a block of streams as one Pallas program in VMEM. It computes
// what gmix_tpu_torch/core/fused.py:fused_substeps_plain computes, bit for
// bit on every output that can reach an archive (all but `ent` and `ema`,
// which go through log2f): indirect and match predict/learn, the PPM and
// LSTM interval bit predictions, the 3-layer mixer forward with the
// triangular solve, the SSE/APM chain, the arithmetic coder, the entropy
// metrics, the mixer SGD, and the deferred per-bit write stacks applied at
// byte end.
//
// What bounds it on this card: at the reference widths without PPM and LSTM,
// 16 streams, one launch moves 5.1 MB in and out (1.5 us at 3.35 TB/s) and
// does about 26 MFLOP (0.4 us at 67 TFLOP/s), so neither bytes nor
// operations are the floor. The floor is the dependent chain: 8 sub-steps,
// each a chain of stages (predict -> layer 0 dots -> triangular solve ->
// layer 1 -> final -> APM and coder on one thread -> learn). Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): 0.24 ms per launch.
//
// Why it looks as it does:
// - One thread block per stream (streams are independent), 256 threads. The
//   working mixer rows of all five placement classes, the APM rows and the
//   8-deep write stacks live in shared memory for the whole byte, so a stage
//   boundary is a __syncthreads() and a look-up is a load. Tables read one
//   lane per model per sub-step (p_tbl, ind_blk, mt_pred, mt_cnt) stay in
//   global memory. 16 blocks leave most of the 132 SMs idle; that is the
//   price of the simple design.
// - One compiled kernel serves every spec: the sizes arrive in `Dims`, the
//   per-mixer structure (class and index of each row, longest-match table
//   sizes, skip columns, APM constants) in two small descriptor arrays.
// - The rounding of every float op is pinned (detmath.cuh): no contraction,
//   IEEE division, round-half-even. The one fused multiply-add is the A @ A
//   product of the triangular solve, a forward loop of __fmaf_rn from +0
//   (the plain version emulates that FMA in float64).
// - Inexact sums are fixed-pairing trees: lane i adds lane i + h for
//   h = P/2 ... 1 (warp_tree_sum), the pairs and order of _tree_sum. The
//   8-deep stack corrections are ((s0+s4)+(s2+s6)) + ((s1+s5)+(s3+s7)) with
//   masked-out terms as del * 0.
// - The deferred writes are applied as dense passes over all 256 lanes, as
//   the plain version does: a lane that no slot hits still takes eight
//   additions of del * 0, which turns a stored -0.0 into +0.0.
// - u32 registers arrive as int64 (the port's state) and are uint32_t here;
//   they wrap as gmix_tpu's do. bits_seen, the steps counters and max_steps
//   convert to f32 as unsigned values (gmix_tpu's TPU kernel goes through
//   int32: equal below 2^31).
// - Rows of the longest-match tables are read with gmix_tpu's denormal
//   flush (|x| < FLT_MIN -> 0) unless the table has one row.

#include <cassert>
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "detmath.cuh"

namespace {

using namespace gmix;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 16;  // a warp sums up to 32 * kMaxQ = 512 lanes
constexpr int kApmBins = 33;
constexpr float kApmSpan = 16.0f;
constexpr int kWinPad = 64;
constexpr int kMaxSmem = 232448;
// (1f - 3e-6f), the mixer weight decay
constexpr float kWeightDecay = 1.0f - static_cast<float>(3e-6);

}  // namespace

// int64 sizes as the Python wrapper passes them (ctypes structure)
struct FusedDims {
  int64_t S, M, NM, n0, n1, WP, SL, n_pred, pl0, pl12, nskip, Kst, Kp, Kcd, Kpd, Klm, Tlm, NA, ppm, lstm, nc,
      learn, analysis;
};

// device pointers, inputs then outputs, in the order of the Python wrapper's
// slot lists; a pointer the spec or the flags do not use is null
struct FusedIO {
  const int64_t* in_sc;
  const int64_t* in_coder;
  const int64_t* in_win_r;
  const float* in_ent;
  const float* in_mix_lrs;
  const int16_t* in_ind_blk;
  const int64_t* in_ind_rot;
  const float* in_p_tbl;
  const float* in_ind_lrs;
  const int32_t* in_ns_next;
  const int32_t* in_rm_next;
  const float* in_rows_st;
  const float* in_rows_pos;
  const float* in_rows_cd;
  const float* in_blocks_pd;
  const float* in_lm_tbl;
  const int64_t* in_max_steps;
  const float* in_apm_rows;
  const float* in_ppm_probs;
  const int32_t* in_ppm_regs;
  const float* in_lstm_probs;
  const int32_t* in_lstm_regs;
  const int32_t* in_match_len;
  const int64_t* in_match_byte;
  const float* in_mt_pred;
  const int32_t* in_mt_cnt;
  const int32_t* in_match_limits;
  const float* in_ema;
  const int32_t* in_desc_i;
  const float* in_desc_f;
  int64_t* out_coder;
  int64_t* out_win_w;
  int64_t* out_bitregs;
  float* out_ent;
  int16_t* out_ind_blk;
  float* out_p_tbl;
  float* out_rows_st;
  float* out_rows_pos;
  float* out_rows_cd;
  float* out_blocks_pd;
  float* out_lm_tbl;
  int64_t* out_max_steps;
  float* out_apm_rows;
  int32_t* out_ppm_regs;
  int32_t* out_lstm_regs;
  int32_t* out_match_len;
  float* out_mt_pred;
  int32_t* out_mt_cnt;
  float* out_ema;
};

namespace {

struct Dims {
  int S, M, NM, n0, n1, WP, SL, n_pred, pl0, pl12, nskip, Kst, Kp, Kcd, Kpd, Klm, Tlm, NA, ppm, lstm, nc, learn,
      analysis;
  int K;     // n0 + n1 + 1
  int nmax;  // max(n0, n1, 1)
  int P;     // WP rounded up to a power of two
};

__host__ __device__ inline int pow2_ceil(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// Offsets, in 4-byte words, of the block's arrays in dynamic shared memory.
struct Smem {
  // float
  int st, pos, cd, pd, lm, lmscr, apm, base, dvec, ya, yb, y0, y1, amat, upd, wdf, pcur, ptdel, mp, mpdel, apmw,
      apmpv, ema, scalf;
  // int / uint32
  int rowoff, dstoff, stepv, stepnew, maxst, steff, pair, lanesel, iblane, ibdel, ptslot, mlen, mpslot, mcdel,
      apmi0, winw, scali;
  int total;
};

__host__ __device__ inline Smem smem_layout(const Dims& d) {
  Smem L;
  int o = 0;
  auto take = [&o](int n) {
    const int r = o;
    o += (n + 3) & ~3;
    return r;
  };
  L.st = take(d.Kst * d.WP);
  L.pos = take(d.Kp * 8 * d.WP);
  L.cd = take(d.Kcd * d.WP);
  L.pd = take(d.Kpd * 8 * d.WP);
  L.lm = take(d.Tlm * d.WP);
  L.lmscr = take(d.Klm * d.WP);
  L.apm = take(d.NA * 8 * kApmBins);
  L.base = take(3 * d.WP);
  L.dvec = take(d.nmax);
  L.ya = take(d.nmax);
  L.yb = take(d.nmax);
  L.y0 = take(d.n0);
  L.y1 = take(d.n1);
  L.amat = take(2 * d.nmax * d.nmax);
  L.upd = take(d.K);
  L.wdf = take(d.K);
  L.pcur = take(2 * d.M);
  L.ptdel = take(16 * d.M);
  L.mp = take(d.NM);
  L.mpdel = take(8 * d.NM);
  L.apmw = take(d.NA);
  L.apmpv = take(d.NA);
  L.ema = take(d.nc);
  L.scalf = take(4);
  L.rowoff = take(d.K);
  L.dstoff = take(d.K);
  L.stepv = take(d.K);
  L.stepnew = take(d.K);
  L.maxst = take(d.K);
  L.steff = take(2 * d.M);
  L.pair = take(d.M);
  L.lanesel = take(d.M);
  L.iblane = take(8 * d.M);
  L.ibdel = take(8 * d.M);
  L.ptslot = take(16 * d.M);
  L.mlen = take(d.NM);
  L.mpslot = take(8 * d.NM);
  L.mcdel = take(8 * d.NM);
  L.apmi0 = take(d.NA);
  L.winw = take(kWinPad);
  L.scali = take(4);
  L.total = o;
  return L;
}

// Fixed-pairing tree sum of P values (P a power of two, P <= 32 * kMaxQ)
// spread over a warp: thread t holds v[q] = x[t + 32 q]. Lane i adds lane
// i + h for h = P/2, ..., 1, the pairs and the order of _tree_sum. Values
// at or past P are never read. Returns the sum to every thread of the warp.
__device__ __forceinline__ float warp_tree_sum(float (&v)[kMaxQ], int P) {
#pragma unroll
  for (int hq = kMaxQ / 2; hq >= 1; hq >>= 1) {  // h = 32 * hq
    if (64 * hq <= P) {
#pragma unroll
      for (int q = 0; q < hq; ++q) v[q] = fadd(v[q], v[q + hq]);
    }
  }
  float x = v[0];
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) {
    const float o = __shfl_down_sync(0xffffffffu, x, h);
    if (2 * h <= P) x = fadd(x, o);
  }
  return __shfl_sync(0xffffffffu, x, 0);
}

// tree sum over lanes [0, n) of a[l] * b[l], padded with +0 to P lanes
__device__ __forceinline__ float warp_dot(const float* a, const float* b, int n, int P, int lane) {
  float v[kMaxQ];
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) {
    const int l = lane + 32 * q;
    v[q] = l < n ? fmul(a[l], b[l]) : 0.0f;
  }
  return warp_tree_sum(v, P);
}

// a mixer row's dot with a base vector, the steps lane read as 0 (a select)
__device__ __forceinline__ float row_dot(const float* row, const float* base, const Dims& d, int lane) {
  float v[kMaxQ];
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) {
    const int l = lane + 32 * q;
    v[q] = l < d.WP ? fmul(l == d.SL ? 0.0f : row[l], base[l]) : 0.0f;
  }
  return warp_tree_sum(v, d.P);
}

// the 8-deep stack correction of a deferred write: the tree sum over the
// sub-steps jj of del[jj] * (slot[jj] == key and jj < j)
__device__ __forceinline__ float stack_corr(const float* del, const int* slot, int stride, int key, int j) {
  float t[8];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
    t[jj] = fmul(del[jj * stride], (slot[jj * stride] == key && jj < j) ? 1.0f : 0.0f);
  return fadd(fadd(fadd(t[0], t[4]), fadd(t[2], t[6])), fadd(fadd(t[1], t[5]), fadd(t[3], t[7])));
}

// One bit of a byte distribution's binary search (the PPM and LSTM heads),
// by one warp: narrow [bot, top] by the last bit, then the logit of the
// upper half's share of the interval's mass.
__device__ __forceinline__ float interval_pred(const float* probs, int& top, int& bot, int& mid, uint32_t nb,
                                               bool first, int lane) {
  if (!first) {
    if (nb == 1) bot = mid + 1;
    else top = mid;
  }
  mid = bot + ((top - bot) >> 1);  // floor division
  float v[kMaxQ];
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) {
    const int l = lane + 32 * q;
    v[q] = (l < 256 && l >= mid + 1 && l <= top) ? probs[l] : 0.0f;
  }
  const float num = warp_tree_sum(v, 256);
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) {
    const int l = lane + 32 * q;
    v[q] = (l < 256 && l >= bot && l <= mid) ? probs[l] : 0.0f;
  }
  const float den = fadd(num, warp_tree_sum(v, 256));
  const bool nz = den != 0.0f;
  const float p = nz ? fdiv(num, den) : 0.5f;
  return nz ? logit(p) : 0.0f;
}

// Solve y = d + strict_lower(L) y for one mixer layer by nilpotent doubling
// ((I-A)^-1 = (I+A)(I+A^2)(I+A^4)...), block-wide. L[i][c] is lane off + c
// of the layer's row i (pool + rowoff[k0 + i]). Reads dvec, leaves y in
// `out` (and nowhere else); every thread of the block must call it.
__device__ void tri_solve(const float* pool, const int* rowoff, int k0, int n, int off, const Dims& d,
                          const float* dvec, float* ya, float* yb, float* amat, float* out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (n <= 1) {
    if (tid < n) out[tid] = dvec[tid];
    __syncthreads();
    return;
  }
  const int p = pow2_ceil(n);
  float* a_cur = amat;
  float* a_nxt = amat + d.nmax * d.nmax;
  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int i = idx / n, c = idx - i * n, l = off + c;
    a_cur[idx] = c < i ? (l == d.SL ? 0.0f : pool[rowoff[k0 + i] + l]) : 0.0f;
  }
  __syncthreads();
  for (int i = warp; i < n; i += kWarps) {
    const float s = warp_dot(a_cur + i * n, dvec, n, p, lane);
    if (lane == 0) ya[i] = fadd(dvec[i], s);
  }
  __syncthreads();
  float* y_cur = ya;
  float* y_nxt = yb;
  for (int cover = 2; cover < n; cover *= 2) {
    // A <- A @ A: per element a forward loop of fused multiply-adds from +0
    for (int idx = tid; idx < n * n; idx += kThreads) {
      const int i = idx / n, k = idx - i * n;
      float acc = 0.0f;
      for (int jj = 0; jj < n; ++jj) acc = __fmaf_rn(a_cur[i * n + jj], a_cur[jj * n + k], acc);
      a_nxt[idx] = acc;
    }
    __syncthreads();
    for (int i = warp; i < n; i += kWarps) {
      const float s = warp_dot(a_nxt + i * n, y_cur, n, p, lane);
      if (lane == 0) y_nxt[i] = fadd(y_cur[i], s);
    }
    __syncthreads();
    float* t = a_cur; a_cur = a_nxt; a_nxt = t;
    t = y_cur; y_cur = y_nxt; y_nxt = t;
  }
  if (tid < n) out[tid] = y_cur[tid];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) fused_substeps_kernel(const Dims d, const FusedIO io) {
  extern __shared__ __align__(16) float smf[];
  int* smi = reinterpret_cast<int*>(smf);
  uint32_t* smu = reinterpret_cast<uint32_t*>(smf);
  const Smem L = smem_layout(d);
  const int s = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = d.M, M2 = 2 * d.M, NM = d.NM, n0 = d.n0, n1 = d.n1, K = d.K, WP = d.WP, SL = d.SL;
  const int n_pred = d.n_pred, nskip = d.nskip, NA = d.NA, Klm = d.Klm, nh = d.ppm + d.lstm;
  const bool learn = d.learn != 0, analysis = d.analysis != 0;

  // descriptors
  const int* k_class = io.in_desc_i;
  const int* k_index = k_class + K;
  const int* lm_sizes = k_index + K;
  const int* lm_offs = lm_sizes + Klm;
  const int* skip_cols = lm_offs + Klm;
  const float* apm_wgt = io.in_desc_f;
  const float* apm_omw = apm_wgt + NA;
  const float* apm_lr = apm_omw + NA;

  // shared arrays
  float* pool = smf;  // all class rows, addressed by word offsets
  float* lmscr = smf + L.lmscr;
  float* apm = smf + L.apm;
  float* base0 = smf + L.base;
  float* base1 = base0 + WP;
  float* base2 = base1 + WP;
  float* dvec = smf + L.dvec;
  float* y0 = smf + L.y0;
  float* y1 = smf + L.y1;
  float* upd = smf + L.upd;
  float* wdf = smf + L.wdf;
  float* pcur = smf + L.pcur;
  float* ptdel = smf + L.ptdel;
  float* mpv = smf + L.mp;
  float* mpdel = smf + L.mpdel;
  float* apmw = smf + L.apmw;
  float* apmpv = smf + L.apmpv;
  float* ema = smf + L.ema;
  float* scalf = smf + L.scalf;
  int* rowoff = smi + L.rowoff;
  int* dstoff = smi + L.dstoff;
  uint32_t* stepv = smu + L.stepv;
  uint32_t* stepnew = smu + L.stepnew;
  uint32_t* maxst = smu + L.maxst;
  int* steff = smi + L.steff;
  int* pairv = smi + L.pair;
  int* lanesel = smi + L.lanesel;
  int* iblane = smi + L.iblane;
  int* ibdel = smi + L.ibdel;
  int* ptslot = smi + L.ptslot;
  int* mlenv = smi + L.mlen;
  int* mpslot = smi + L.mpslot;
  int* mcdel = smi + L.mcdel;
  int* apmi0 = smi + L.apmi0;
  uint32_t* winw = smu + L.winw;
  int* scali = smi + L.scali;

  // this stream's inputs
  const int64_t* sc = io.in_sc + int64_t(s) * 8;
  const int64_t* cr = io.in_coder + int64_t(s) * 8;
  const int64_t* win_r = io.in_win_r + int64_t(s) * kWinPad;
  const int16_t* ind_blk = M ? io.in_ind_blk + int64_t(s) * M * 256 : nullptr;
  const int64_t* ind_rot = M ? io.in_ind_rot + int64_t(s) * M : nullptr;
  const float* p_tbl = M ? io.in_p_tbl + int64_t(s) * M2 * 256 : nullptr;
  const float* mt_pred = NM ? io.in_mt_pred + int64_t(s) * NM * 256 : nullptr;
  const int32_t* mt_cnt = NM ? io.in_mt_cnt + int64_t(s) * NM * 256 : nullptr;
  const int64_t* match_byte = NM ? io.in_match_byte + int64_t(s) * NM : nullptr;
  const float* ppm_probs = d.ppm ? io.in_ppm_probs + int64_t(s) * 256 : nullptr;
  const float* lstm_probs = d.lstm ? io.in_lstm_probs + int64_t(s) * 256 : nullptr;

  // ---- load the working sets ----
  for (int i = tid; i < d.Kst * WP; i += kThreads) pool[L.st + i] = io.in_rows_st[int64_t(s) * d.Kst * WP + i];
  for (int i = tid; i < d.Kp * 8 * WP; i += kThreads) pool[L.pos + i] = io.in_rows_pos[int64_t(s) * d.Kp * 8 * WP + i];
  for (int i = tid; i < d.Kcd * WP; i += kThreads) pool[L.cd + i] = io.in_rows_cd[int64_t(s) * d.Kcd * WP + i];
  for (int i = tid; i < d.Kpd * 8 * WP; i += kThreads) pool[L.pd + i] = io.in_blocks_pd[int64_t(s) * d.Kpd * 8 * WP + i];
  for (int i = tid; i < d.Tlm * WP; i += kThreads) pool[L.lm + i] = io.in_lm_tbl[int64_t(s) * d.Tlm * WP + i];
  for (int i = tid; i < NA * 8 * kApmBins; i += kThreads) apm[i] = io.in_apm_rows[int64_t(s) * NA * 8 * kApmBins + i];
  for (int i = tid; i < K; i += kThreads) maxst[i] = static_cast<uint32_t>(io.in_max_steps[int64_t(s) * K + i]);
  for (int i = tid; i < NM; i += kThreads) mlenv[i] = io.in_match_len[int64_t(s) * NM + i];
  if (analysis)
    for (int i = tid; i < d.nc; i += kThreads) ema[i] = io.in_ema[int64_t(s) * d.nc + i];
  for (int i = tid; i < kWinPad; i += kThreads) winw[i] = 0u;
  if (learn) {
    for (int i = tid; i < 8 * M; i += kThreads) { iblane[i] = -1; ibdel[i] = 0; }
    for (int i = tid; i < 16 * M; i += kThreads) { ptslot[i] = -1; ptdel[i] = 0.0f; }
    for (int i = tid; i < 8 * NM; i += kThreads) { mpslot[i] = -1; mpdel[i] = 0.0f; mcdel[i] = 0; }
  }

  // per-stream scalars; every thread keeps the uniform ones
  const uint32_t data_byte = static_cast<uint32_t>(sc[0]);
  const uint32_t last_byte = static_cast<uint32_t>(sc[1]);
  const uint32_t recent1 = static_cast<uint32_t>(sc[2]);
  const bool decode = sc[3] != 0;
  const bool not_first = sc[4] != 0;
  uint32_t x1 = static_cast<uint32_t>(cr[0]), x2 = static_cast<uint32_t>(cr[1]), x = static_cast<uint32_t>(cr[2]);
  uint32_t wpos = static_cast<uint32_t>(cr[3]), rpos = static_cast<uint32_t>(cr[4]);
  uint32_t acc = static_cast<uint32_t>(cr[5]), bits_seen = static_cast<uint32_t>(cr[6]);
  uint32_t new_bit = static_cast<uint32_t>(cr[7]);
  const uint32_t wpos0 = wpos, rpos0 = rpos;
  float ent = io.in_ent[s];
  // the head registers are uniform within the warp that runs the head
  int ppm_top = 0, ppm_bot = 0, ppm_mid = 0, l_top = 0, l_bot = 0, l_mid = 0;
  if (d.ppm) {
    const int32_t* r = io.in_ppm_regs + int64_t(s) * 4;
    ppm_top = r[0]; ppm_bot = r[1]; ppm_mid = r[2];
  }
  if (d.lstm) {
    const int32_t* r = io.in_lstm_regs + int64_t(s) * 4;
    l_top = r[0]; l_bot = r[1]; l_mid = r[2];
  }
  uint32_t bit_ctx = 0, lb_ctx = 0, slb_ctx = 0, longest = 0;
  __syncthreads();

#pragma unroll 1
  for (int j = 0; j < 8; ++j) {
    const uint32_t check_mask = j == 0 ? 1u : (256u >> j);
    const uint32_t pred_mask = 128u >> j;
    // bits_seen counts every bit except the very first; it doubles as the
    // mixer steps counter
    bits_seen += (not_first || j > 0) ? 1u : 0u;
    bit_ctx = (acc + (1u << j)) - 1u;
    lb_ctx = (last_byte << 8) + bit_ctx;
    slb_ctx = (recent1 << 8) + bit_ctx;

    // ---- stage 1: model predictions into base0[0, n_pred), the rest of
    // base0 (zeros and the bit-prefix features) ----
    for (int l = n_pred + tid; l < WP; l += kThreads) {
      float v = 0.0f;
      const int i = l - d.pl0;
      if (d.pl0 >= 0 && i >= 0 && i < 8 && i < j) {
        int sh = j - 1 - i;
        sh = sh < 0 ? 0 : (sh > 31 ? 31 : sh);
        v = fsub(fmul(2.0f, static_cast<float>((acc >> sh) & 1u)), 1.0f);
      }
      base0[l] = v;
    }
    // indirect models: column c of [ns models | rm models]
    for (int c = tid; c < M2; c += kThreads) {
      const int m = c < M ? c : c - M;
      const int ls = static_cast<int>((bit_ctx + static_cast<uint32_t>(ind_rot[m])) & 255u);
      const int pair = static_cast<uint16_t>(ind_blk[m * 256 + ls]);  // ns | rm << 8
      const int ns_raw = pair & 255, rm_raw = pair >> 8;
      // ns state 255 (unseen) predicts/learns/advances from slot 0
      const bool active = c < M ? ns_raw != 255 : rm_raw != 0;
      const int st = c < M ? (ns_raw == 255 ? 0 : ns_raw) : rm_raw;
      float p = p_tbl[c * 256 + st];
      if (learn) p = fadd(p, stack_corr(ptdel + c, ptslot + c, M2, st, j));
      pcur[c] = p;
      steff[c] = st;
      if (c < M) { pairv[c] = pair; lanesel[c] = ls; }
      base0[nh + 2 * m + (c < M ? 0 : 1)] = active ? p : 0.0f;
    }
    // match models; j == 0's length update ran at the byte boundary
    for (int m = tid; m < NM; m += kThreads) {
      const uint32_t mbyte = static_cast<uint32_t>(match_byte[m]);
      int mlen = mlenv[m];
      if (j > 0) {
        const bool hit = new_bit == ((mbyte & check_mask) != 0 ? 1u : 0u);
        mlen = hit ? min(mlen + 1, 255) : 0;
        mlenv[m] = mlen;
      }
      assert(mlen >= 0 && mlen < 256);
      float mp = mt_pred[m * 256 + mlen];
      if (learn) mp = fadd(mp, stack_corr(mpdel + m, mpslot + m, NM, mlen, j));
      mpv[m] = mp;
      const float p_prob = (mbyte & pred_mask) != 0 ? mp : fsub(1.0f, mp);
      base0[nh + M2 + m] = mlen > 2 ? logit(p_prob) : 0.0f;
    }
    // PPM / LSTM interval bit predictions, one warp each
    if (d.ppm && warp == kWarps - 1) {
      const float lg = interval_pred(ppm_probs, ppm_top, ppm_bot, ppm_mid, new_bit, j == 0, lane);
      if (lane == 0) base0[0] = lg;
    }
    if (d.lstm && warp == kWarps - 2) {
      const float lg = interval_pred(lstm_probs, l_top, l_bot, l_mid, new_bit, j == 0, lane);
      if (lane == 0) base0[d.ppm] = lg;
    }
    __syncthreads();

    // ---- stage 2: the sub-step's working rows (k-order) and the tails of
    // base1 / base2 ----
    if (NM) {
      int mx = 0;
      for (int m = 0; m < NM; ++m) mx = max(mx, mlenv[m] / 32);
      longest = static_cast<uint32_t>(mx);
    }
    for (int idx = tid; idx < Klm * WP; idx += kThreads) {
      const int i = idx / WP, l = idx - i * WP, T = lm_sizes[i];
      float v = static_cast<int>(longest) < T ? pool[L.lm + (lm_offs[i] + static_cast<int>(longest)) * WP + l] : 0.0f;
      if (T > 1 && fabsf(v) < FLT_MIN) v = 0.0f;
      lmscr[idx] = v;
    }
    for (int k = tid; k < K; k += kThreads) {
      const int c = k_class[k], i = k_index[k];
      int off, dst;
      if (c == 0) off = dst = L.st + i * WP;
      else if (c == 1) off = dst = L.pos + (i * 8 + j) * WP;
      else if (c == 2) off = dst = L.cd + i * WP;
      else if (c == 3) off = dst = L.pd + (i * 8 + j) * WP;
      else {
        off = L.lmscr + i * WP;
        dst = static_cast<int>(longest) < lm_sizes[i] ? L.lm + (lm_offs[i] + static_cast<int>(longest)) * WP : -1;
      }
      rowoff[k] = off;
      dstoff[k] = dst;
    }
    for (int l = tid; l < WP; l += kThreads) {
      // lanes at or past n0 + n1: skip-connection predictions, prefix
      // features, zeros; base1 also has zeros in [n0, n0 + n1)
      float v = 0.0f;
      const int isk = l - (n0 + n1), ipf = l - d.pl12;
      if (isk >= 0 && isk < nskip) v = base0[skip_cols[isk]];
      else if (d.pl12 >= 0 && ipf >= 0 && ipf < 8) v = base0[d.pl0 + ipf];
      if (l >= n0) base1[l] = l < n0 + n1 ? 0.0f : v;
      if (l >= n0 + n1) base2[l] = v;
    }
    __syncthreads();

    // ---- stage 3: layer 0 ----
    for (int k = tid; k < K; k += kThreads) stepv[k] = __float_as_uint(pool[rowoff[k] + SL]);
    for (int i = warp; i < n0; i += kWarps) {
      const float s0 = row_dot(pool + rowoff[i], base0, d, lane);
      if (lane == 0) dvec[i] = s0;
    }
    __syncthreads();
    tri_solve(pool, rowoff, 0, n0, n_pred, d, dvec, smf + L.ya, smf + L.yb, smf + L.amat, y0);
    for (int i = tid; i < n0; i += kThreads) base1[i] = base2[i] = y0[i];
    __syncthreads();

    // ---- stage 4: layer 1 ----
    for (int i = warp; i < n1; i += kWarps) {
      const float s1 = row_dot(pool + rowoff[n0 + i], base1, d, lane);
      if (lane == 0) dvec[i] = s1;
    }
    __syncthreads();
    tri_solve(pool, rowoff, n0, n1, n0, d, dvec, smf + L.ya, smf + L.yb, smf + L.amat, y1);
    for (int i = tid; i < n1; i += kThreads) base2[n0 + i] = y1[i];
    __syncthreads();

    // ---- stage 5: final mixer, APM chain, coder (one warp, then one
    // thread) ----
    if (warp == 0) {
      const float final_logit = row_dot(pool + rowoff[K - 1], base2, d, lane);
      if (lane == 0) {
        float prob = clamp_prob(logistic(final_logit));
        float apm_l = final_logit, apm_p = prob;
        for (int a = 0; a < NA; ++a) {
          const float* row = apm + a * 8 * kApmBins + j * kApmBins;
          const float pos = fmul(fadd(clampf(apm_l, -kApmSpan, kApmSpan), kApmSpan),
                                 static_cast<float>((kApmBins - 1) / (2 * 16.0)));
          const int i0 = min(__float2int_rz(pos), kApmBins - 2);
          const float w = fsub(pos, static_cast<float>(i0));
          // the interpolation of the two bins: the only nonzero terms of
          // the plain version's 33-term sum
          const float pv = fadd(fmul(row[i0], fsub(1.0f, w)), fmul(row[i0 + 1], w));
          apm_p = clamp_prob(fadd(fmul(apm_wgt[a], pv), fmul(apm_omw[a], apm_p)));
          apm_l = logit(apm_p);
          apmi0[a] = i0;
          apmw[a] = w;
          apmpv[a] = pv;
        }
        prob = apm_p;

        // arithmetic coder (encoder.cpp:10-25 / decoder.cpp:19-39)
        const uint32_t enc_bit = (data_byte >> (7 - j)) & 1u;
        const uint32_t p16 = static_cast<uint32_t>(__float2int_rz(fadd(1.0f, fmul(65534.0f, prob))));
        const uint32_t rng = x2 - x1;
        const uint32_t xmid = x1 + (rng >> 16) * p16 + (((rng & 0xFFFFu) * p16) >> 16);
        const uint32_t bit = decode ? (x <= xmid ? 1u : 0u) : enc_bit;
        if (bit) x2 = xmid;      // bit==1 keeps [x1, xmid]
        else x1 = xmid + 1u;     // bit==0 keeps [xmid+1, x2]
        const uint32_t off_r = rpos - rpos0, off_w = wpos - wpos0;
        uint32_t emits[4];
        uint32_t nren = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool cond = ((x1 ^ x2) & 0xFF000000u) == 0;
          emits[i] = cond ? (x2 >> 24) : 0u;
          // window lanes past the window read 0
          const uint32_t in_byte = off_r + i < kWinPad ? static_cast<uint32_t>(win_r[off_r + i]) : 0u;
          if (cond) {
            x1 = x1 << 8;
            x2 = (x2 << 8) | 255u;
            if (decode) x = (x << 8) | in_byte;
            nren += 1u;
          }
        }
        if (!decode) {
          // each window lane is written at most once per byte
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (static_cast<uint32_t>(i) < nren && off_w + i < kWinPad) winw[off_w + i] += emits[i];
          wpos += nren;
        } else {
          rpos += nren;
        }
        const float p_bit = bit == 1u ? prob : fsub(1.0f, prob);
        ent = fsub(ent, log2f(p_bit));
        scali[0] = static_cast<int>(bit);
        scalf[0] = final_logit;
      }
    }
    __syncthreads();
    const uint32_t bit = static_cast<uint32_t>(scali[0]);
    const float final_logit = scalf[0];
    const float bitf = static_cast<float>(bit);

    // ---- stage 6: metrics and the per-model learn steps; the loops start
    // at different threads so that they spread over the block ----
    if (analysis) {
      for (int c = tid; c < d.nc; c += kThreads) {
        const float lg = c < n_pred ? base0[c] : c < n_pred + n0 ? y0[c - n_pred]
                         : c < n_pred + n0 + n1 ? y1[c - n_pred - n0] : final_logit;
        const float pc = clampf(logistic(lg), static_cast<float>(0.01), static_cast<float>(0.99));
        const float pb = bit == 1u ? pc : fsub(1.0f, pc);
        ema[c] = fadd(ema[c], fmul(static_cast<float>(1e-5), fsub(-log2f(pb), ema[c])));
      }
    }
    if (learn) {
      // APM: move the two interpolation bins toward the bit (dense over the
      // stage's 33 bins)
      for (int idx = tid; idx < NA * kApmBins; idx += kThreads) {
        const int a = idx / kApmBins, b = idx - a * kApmBins;
        float* cell = apm + a * 8 * kApmBins + j * kApmBins + b;
        const int i0 = apmi0[a];
        const float w = apmw[a];
        const float wv = fadd(b == i0 ? fsub(1.0f, w) : 0.0f, b == i0 + 1 ? w : 0.0f);
        *cell = fadd(*cell, fmul(fmul(apm_lr[a], fsub(bitf, apmpv[a])), wv));
      }
      // indirect Learn (indirect.cpp:47-70): the state->logit delta and the
      // advanced state pair go into the byte stacks
      for (int c = (tid - d.nc) & (kThreads - 1); c < M2; c += kThreads) {
        ptslot[j * M2 + c] = steff[c];
        ptdel[j * M2 + c] = fmul(fsub(bitf, logistic(pcur[c])), io.in_ind_lrs[c]);
        if (c < M) {
          const int new_ns = io.in_ns_next[bit * 256 + steff[c]];
          const int new_rm = io.in_rm_next[bit * 256 + steff[M + c]];
          iblane[j * M + c] = lanesel[c];
          ibdel[j * M + c] = (new_ns | (new_rm << 8)) - pairv[c];
        }
      }
      // match per-bit Learn (match.cpp:79-90)
      for (int m = (tid - d.nc - M2) & (kThreads - 1); m < NM; m += kThreads) {
        const uint32_t mbyte = static_cast<uint32_t>(match_byte[m]);
        const int mlen = mlenv[m];
        const float hit2 = bit == ((mbyte & pred_mask) != 0 ? 1u : 0u) ? 1.0f : 0.0f;
        int cnt = mt_cnt[m * 256 + mlen];
        for (int jj = 0; jj < j; ++jj)
          if (mpslot[jj * NM + m] == mlen) cnt += mcdel[jj * NM + m];
        const int limit = io.in_match_limits[m];
        const bool grow = cnt < limit;
        const float lr = fdiv(1.0f, static_cast<float>(grow ? cnt + 1 : limit));
        const float mp = mpv[m];
        const float mp_new = fadd(mp, fmul(fsub(hit2, mp), lr));
        const bool upd_on = mlen > 2;  // only matched rows learn
        mpslot[j * NM + m] = mlen;
        mpdel[j * NM + m] = upd_on ? fsub(mp_new, mp) : 0.0f;
        mcdel[j * NM + m] = (upd_on && grow) ? 1 : 0;
      }
      // mixer Learn (mixer.cpp:108-176): the per-row step size
      for (int k = (tid - d.nc - M2 - NM) & (kThreads - 1); k < K; k += kThreads) {
        const float steps_f = __uint2float_rn(bits_seen);
        const float decay_global =
            fdiv(static_cast<float>(0.9), pow_det(fadd(fmul(static_cast<float>(1e-7), steps_f), static_cast<float>(0.8)),
                                                  static_cast<float>(0.8)));
        const float y = k < n0 ? y0[k] : k < n0 + n1 ? y1[k - n0] : final_logit;
        const float novelty = fsub(1.5f, fdiv(__uint2float_rn(stepv[k]), __uint2float_rn(maxst[k])));
        upd[k] = fmul(fmul(fmul(decay_global, novelty), io.in_mix_lrs[k]), fsub(logistic(y), bitf));
        const uint32_t sn = stepv[k] + 1u;
        stepnew[k] = sn;
        wdf[k] = (sn & 1023u) == 0 ? kWeightDecay : 1.0f;  // weight decay every 1024 context-steps
        maxst[k] = max(maxst[k], sn);
      }
      __syncthreads();
      // w <- (w - upd * input) * decay, the steps lane rewritten with the
      // incremented bitcast counter; rows go back to where their class
      // keeps them
      for (int idx = tid; idx < K * WP; idx += kThreads) {
        const int k = idx / WP, l = idx - k * WP;
        float in;
        if (k < n0) {
          const int c = l - n_pred;
          in = (c >= 0 && c < n0) ? fmul(y0[c], c < k ? 1.0f : 0.0f) : base0[l];
        } else if (k < n0 + n1) {
          const int c = l - n0;
          in = (c >= 0 && c < n1) ? fmul(y1[c], c < k - n0 ? 1.0f : 0.0f) : base1[l];
        } else {
          in = base2[l];
        }
        float w = fsub(pool[rowoff[k] + l], fmul(upd[k], in));
        w = fmul(w, wdf[k]);
        if (l == SL) w = __uint_as_float(stepnew[k]);
        if (dstoff[k] >= 0) pool[dstoff[k] + l] = w;
      }
    }
    // advance the bit registers
    new_bit = bit;
    acc = (acc << 1) | bit;
    __syncthreads();
  }

  // ---- apply the deferred per-bit table writes, in sub-step order, as
  // dense passes over all 256 lanes ----
  if (learn) {
    for (int idx = tid; idx < M * 256; idx += kThreads) {
      const int m = idx >> 8, l = idx & 255;
      int ib = static_cast<uint16_t>(ind_blk[idx]);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) ib += ibdel[jj * M + m] * (l == iblane[jj * M + m] ? 1 : 0);
      io.out_ind_blk[int64_t(s) * M * 256 + idx] = static_cast<int16_t>(ib);
    }
    for (int idx = tid; idx < M2 * 256; idx += kThreads) {
      const int c = idx >> 8, l = idx & 255;
      float pt = p_tbl[idx];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) pt = fadd(pt, fmul(ptdel[jj * M2 + c], l == ptslot[jj * M2 + c] ? 1.0f : 0.0f));
      io.out_p_tbl[int64_t(s) * M2 * 256 + idx] = pt;
    }
    for (int idx = tid; idx < NM * 256; idx += kThreads) {
      const int m = idx >> 8, l = idx & 255;
      float mtp = mt_pred[idx];
      int mtc = mt_cnt[idx];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const bool eq = l == mpslot[jj * NM + m];
        mtp = fadd(mtp, fmul(mpdel[jj * NM + m], eq ? 1.0f : 0.0f));
        mtc += mcdel[jj * NM + m] * (eq ? 1 : 0);
      }
      io.out_mt_pred[int64_t(s) * NM * 256 + idx] = mtp;
      io.out_mt_cnt[int64_t(s) * NM * 256 + idx] = mtc;
    }
    for (int i = tid; i < d.Kst * WP; i += kThreads) io.out_rows_st[int64_t(s) * d.Kst * WP + i] = pool[L.st + i];
    for (int i = tid; i < d.Kp * 8 * WP; i += kThreads) io.out_rows_pos[int64_t(s) * d.Kp * 8 * WP + i] = pool[L.pos + i];
    for (int i = tid; i < d.Kcd * WP; i += kThreads) io.out_rows_cd[int64_t(s) * d.Kcd * WP + i] = pool[L.cd + i];
    for (int i = tid; i < d.Kpd * 8 * WP; i += kThreads) io.out_blocks_pd[int64_t(s) * d.Kpd * 8 * WP + i] = pool[L.pd + i];
    for (int i = tid; i < d.Tlm * WP; i += kThreads) io.out_lm_tbl[int64_t(s) * d.Tlm * WP + i] = pool[L.lm + i];
    for (int i = tid; i < NA * 8 * kApmBins; i += kThreads) io.out_apm_rows[int64_t(s) * NA * 8 * kApmBins + i] = apm[i];
    for (int i = tid; i < K; i += kThreads) io.out_max_steps[int64_t(s) * K + i] = static_cast<int64_t>(maxst[i]);
  }

  // ---- registers and metrics ----
  for (int i = tid; i < kWinPad; i += kThreads) io.out_win_w[int64_t(s) * kWinPad + i] = static_cast<int64_t>(winw[i]);
  for (int i = tid; i < NM; i += kThreads) io.out_match_len[int64_t(s) * NM + i] = mlenv[i];
  if (analysis)
    for (int i = tid; i < d.nc; i += kThreads) io.out_ema[int64_t(s) * d.nc + i] = ema[i];
  if (tid == 0) {
    int64_t* oc = io.out_coder + int64_t(s) * 8;
    oc[0] = x1; oc[1] = x2; oc[2] = x; oc[3] = wpos; oc[4] = rpos; oc[5] = acc; oc[6] = bits_seen; oc[7] = new_bit;
    int64_t* ob = io.out_bitregs + int64_t(s) * 8;
    ob[0] = bit_ctx; ob[1] = lb_ctx; ob[2] = slb_ctx; ob[3] = longest; ob[4] = ob[5] = ob[6] = ob[7] = 0;
    io.out_ent[s] = ent;
  }
  if (d.ppm && tid == (kWarps - 1) * 32) {
    int32_t* r = io.out_ppm_regs + int64_t(s) * 4;
    r[0] = ppm_top; r[1] = ppm_bot; r[2] = ppm_mid; r[3] = 0;
  }
  if (d.lstm && tid == (kWarps - 2) * 32) {
    int32_t* r = io.out_lstm_regs + int64_t(s) * 4;
    r[0] = l_top; r[1] = l_bot; r[2] = l_mid; r[3] = 0;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t), does not synchronise, and returns
// the launch's cudaError_t (0 on success). Sizes the kernel does not take
// return cudaErrorInvalidValue.
int gmix_fused_substeps(const FusedDims* hd, const FusedIO* io, void* stream) {
  Dims d;
  d.S = static_cast<int>(hd->S); d.M = static_cast<int>(hd->M); d.NM = static_cast<int>(hd->NM);
  d.n0 = static_cast<int>(hd->n0); d.n1 = static_cast<int>(hd->n1); d.WP = static_cast<int>(hd->WP);
  d.SL = static_cast<int>(hd->SL); d.n_pred = static_cast<int>(hd->n_pred); d.pl0 = static_cast<int>(hd->pl0);
  d.pl12 = static_cast<int>(hd->pl12); d.nskip = static_cast<int>(hd->nskip); d.Kst = static_cast<int>(hd->Kst);
  d.Kp = static_cast<int>(hd->Kp); d.Kcd = static_cast<int>(hd->Kcd); d.Kpd = static_cast<int>(hd->Kpd);
  d.Klm = static_cast<int>(hd->Klm); d.Tlm = static_cast<int>(hd->Tlm); d.NA = static_cast<int>(hd->NA);
  d.ppm = hd->ppm ? 1 : 0; d.lstm = hd->lstm ? 1 : 0; d.nc = static_cast<int>(hd->nc);
  d.learn = hd->learn ? 1 : 0; d.analysis = hd->analysis ? 1 : 0;
  d.K = d.n0 + d.n1 + 1;
  d.nmax = d.n0 > d.n1 ? d.n0 : d.n1;
  if (d.nmax < 1) d.nmax = 1;
  d.P = pow2_ceil(d.WP);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (d.S < 0 || d.M < 0 || d.NM < 0 || d.n0 < 0 || d.n1 < 0 || d.NA < 0) return invalid;
  if (d.WP <= 0 || d.WP % 32 != 0 || d.WP > 32 * kMaxQ || d.nmax > 32 * kMaxQ) return invalid;
  if (d.SL < 0 || d.SL >= d.WP || d.n_pred + d.n0 > d.WP || d.n0 + d.n1 + d.nskip > d.WP) return invalid;
  if (d.pl0 >= 0 && (d.pl0 + 8 > d.WP || d.pl12 < 0 || d.pl12 + 8 > d.WP)) return invalid;
  if (d.Kst + d.Kp + d.Kcd + d.Kpd + d.Klm != d.K) return invalid;
  if (d.ppm + d.lstm + 2 * d.M + d.NM != d.n_pred) return invalid;
  if (d.analysis && d.nc != d.n_pred + d.n0 + d.n1 + 1) return invalid;
  if (d.S == 0) return 0;
  const Smem L = smem_layout(d);
  const size_t bytes = static_cast<size_t>(L.total) * 4;
  if (bytes > static_cast<size_t>(kMaxSmem)) return invalid;
  cudaError_t rc = cudaFuncSetAttribute(fused_substeps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  fused_substeps_kernel<<<static_cast<unsigned int>(d.S), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(d, *io);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
