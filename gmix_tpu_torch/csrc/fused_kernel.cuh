// The 8 bit sub-steps of one byte for every stream, as one kernel for Hopper
// (sm_90a): the kernel template. fused.cu holds the C interface and picks an
// instantiation; fused_inst.cu is compiled once per instantiation
// (utils/build.py), so that the instantiations build in parallel.
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
// layer 1 -> final -> APM and coder on one thread -> learn), one block per
// stream, so every stage is latency and barriers, not throughput. The first
// version of this kernel took 0.243 ms per launch (NVIDIA H100 80GB HBM3,
// 700 W, 1980 MHz, chip_smoke.py); its clocks instantiation showed where:
// the two triangular solves 48% of the launch (squarings with a run-time n,
// an integer division per element, 18 barriers), the dense deferred passes
// and the write-back 13%, the row update of the learn stage 11%, the row
// dots 9%, the one-thread tail 5%, the per-model learn steps 5%, stage 1's
// dependent global loads 4%. This version takes 0.076 ms; of its launch the
// front of a sub-step (stage 1 and the layer-0 dots, beside the squarings)
// is 36%, the two chains with the layer-1 dots 16%, the tail beside the
// learn stage 29%, load, dense passes and write-back 15% (PERF.md has the
// table).
//
// What the design does about it:
// - One thread block per stream (streams are independent), 256 threads (512
//   were measured and are slower: 0.088 ms, the barriers cost more and the
//   registers spill at 128 a thread). The working mixer rows of all five
//   placement classes, the APM rows, the 8-deep write stacks and every
//   constant of the spec live in shared memory for the whole byte, so a
//   stage boundary is a barrier and a look-up is a shared load.
// - One thread starts bulk asynchronous copies (cp.async.bulk, completion on
//   an mbarrier) of the working rows and of the byte's look-up tables
//   (ind_blk, p_tbl, mt_pred, mt_cnt: 117 KB at the reference) into shared
//   memory at kernel entry; a sub-step waits only on what it reads. The
//   dense passes then read shared memory and write 16 bytes a thread, and
//   the learned rows go back by bulk stores. Where the tables do not fit
//   (kTables = false, decided by the launcher from the sizes) they stay in
//   global memory and everything else is the same.
// - The kernel is a template on Q = P / 32, the 32-lane groups of a mixer
//   row padded to a power of two P, so that the dots, the tree sums and the
//   row update unroll over the lanes that exist. No loop divides: a warp
//   owns a row and a lane a column, in the dots, the solves and the update.
// - The squarings A^2, A^4, ... of both triangular solves depend on the
//   sub-step's rows alone, not on the predictions. Warps 4-7 (the "prep"
//   group) compute them, with the row offsets and the longest-match rows,
//   while warps 0-3 (the "chain" group) run stage 1 and the layer-0 dots;
//   the groups meet at named barriers. The chain then holds only the
//   matrix-vector products y <- y + A^(2^r) y. For n = 24 and n = 8 (the
//   reference layers) the loops are unrolled from a template value: in a
//   squaring a lane keeps its column of the tile in registers and a warp
//   reads its rows 16 bytes at a time; the chain of such a layer runs on ONE
//   warp, a lane a row, so its rounds meet at __syncwarp() and not at a
//   block barrier. The tile's rows are padded by 4 floats against bank
//   conflicts (solve_ld). Any other n takes the generic loops. Every element
//   is still the forward loop of __fmaf_rn over jj = 0 .. n-1 from +0: no
//   term is skipped, because fma(a, 0, acc) is not acc when a is an infinity
//   or a NaN.
//   THE TENSOR CORES ARE NOT USED, here or anywhere: wgmma and mma.sync take
//   float32 only as TF32 and accumulate in an order of their own, and the
//   archive depends on every rounding.
// - The one-thread tail (logistic, APM chain, coder, log2f) needs only the
//   final logit. When encoding the bit is known beforehand, so the tail runs
//   on lane 0 of warp 0 while warps 1-7 run the per-model learn steps and the
//   row update; warp 0 then applies the APM learn. When decoding the bit
//   comes out of the coder first. Both orders compute the same values. The
//   mixers' global step size depends on the bit count alone: all eight are
//   made at kernel entry.
// - Sampling (generation, learn off) is a run-time mode like the direction:
//   `Dims::sample` says that the uniforms and the inverse temperature are
//   there, `sc[5]` that a stream samples. Its bit is drawn in the tail
//   against the tempered probability logistic(logit(p) * inv_temp) of the
//   APM chain's output and then coded in encode mode, so it takes the
//   decoder's order: the tail first, the bit to every thread through shared
//   memory.
// - What the compiler does to such code decided as much as the design, and
//   each of these cost a factor of two to five in the stage it sat in: a
//   loop whose step is a shift is not always unrolled, and an array indexed
//   by it lands in local memory (the tree sums write their levels out); a
//   load under a per-lane condition becomes a branch of its own, one after
//   the other (every lane loads, with the index clamped, and selects); the
//   transcendentals inlined at a dozen places, with every run-time loop
//   unrolled four times by default, made 14 120 instructions of code (they
//   are out of line, one copy each, and such loops are not unrolled: 7 648).
// - One compiled library serves every spec: the sizes arrive in `Dims`, the
//   per-mixer structure (class and index of each row, longest-match table
//   sizes, skip columns, APM constants) in two small descriptor arrays.
// - The rounding of every float op is pinned (detmath.cuh): no contraction,
//   IEEE division, round-half-even. The one fused multiply-add is the A @ A
//   product of the triangular solve (the plain version emulates that FMA in
//   float64).
// - Inexact sums are fixed-pairing trees: lane i adds lane i + h for
//   h = P/2 ... 1 (warp_tree_sums), the pairs and order of _tree_sum. The
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
#pragma once

#include <cassert>
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "detmath.cuh"

// int64 sizes as the Python wrapper passes them (ctypes structure)
struct FusedDims {
  int64_t S, M, NM, n0, n1, WP, SL, n_pred, pl0, pl12, nskip, Kst, Kp, Kcd, Kpd, Klm, Tlm, NA, ppm, lstm, nc,
      learn, analysis, sample;
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
  const float* in_sample_u;   // (S, 8), sampling only
  const float* in_inv_temp;   // (1, 1), sampling only
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
  int64_t* out_clocks;  // (S, 8, kClockCols), the clocks instantiation only
};

namespace gmix {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// warps [0, kChainWarps) run stage 1 and the layer-0 dots of a sub-step
// while warps [kChainWarps, kWarps) prepare the triangular solves
constexpr int kChainWarps = 4;
constexpr int kChainThreads = 32 * kChainWarps;
constexpr int kPrepWarps = kWarps - kChainWarps;
constexpr int kPrepThreads = 32 * kPrepWarps;
// warp 0 runs the one-thread tail and the APM learn while the others learn
constexpr int kLearnWarps = kWarps - 1;
constexpr int kLearnThreads = 32 * kLearnWarps;
constexpr int kMaxQ = 16;  // a warp sums up to 32 * kMaxQ = 512 lanes
constexpr int kApmBins = 33;
constexpr float kApmSpan = 16.0f;
constexpr int kWinPad = 64;
constexpr int kMaxSmem = 232448;
// (1f - 3e-6f), the mixer weight decay
constexpr float kWeightDecay = 1.0f - static_cast<float>(3e-6);

// named barriers (0 is __syncthreads)
constexpr int kBarChain = 1;    // the chain group among itself
constexpr int kBarRowsReady = 2;  // prep arrives, chain waits: row offsets and longest-match rows are there
constexpr int kBarPrep = 3;     // the prep group among itself
constexpr int kBarLearn = 4;    // warps 1.. among themselves

// clock columns of the clocks instantiation, the order of
// core/fused.py:CLOCK_COLS: the stages of a sub-step as thread 0 passes
// them, then the launch's own (row 0), then those of the warps that work
// beside thread 0: the prep group's first thread (row offsets ready,
// squarings done) and warp 1's (per-model learn steps done, rows updated)
enum ClockCol {
  kClkPredict, kClkRowsWait, kClkLayer0Dots, kClkSquaringsWait, kClkLayer0Solve, kClkLayer1Dots, kClkLayer1Solve,
  kClkFinalDot, kClkTail, kClkLearn,
  kClkStart, kClkLoaded, kClkDeferred, kClkWriteback, kClkEnd,
  kClkPrepRows, kClkPrepDone, kClkLearnModels, kClkLearnRows,
  kClockCols
};

struct Dims {
  int S, M, NM, n0, n1, WP, SL, n_pred, pl0, pl12, nskip, Kst, Kp, Kcd, Kpd, Klm, Tlm, NA, ppm, lstm, nc, learn,
      analysis, sample;
  int K;     // n0 + n1 + 1
  int nmax;  // max(n0, n1, 1)
  int P;     // WP rounded up to a power of two
  int r0, r1;    // squarings of each layer's triangular solve
  int ld0, ld1;  // row strides of each layer's tiles
};

__host__ __device__ constexpr int pow2_ceil(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// The row stride of a layer's n x n tiles. The layer sizes with unrolled
// code (24 and 8, the reference's) pad a row by 4 floats: rows stay 16-byte
// aligned, and the lanes of a warp that each read 16 bytes of their own row
// (solve_chain_warp) fall on different banks (28 i mod 32 and 12 i mod 32
// are distinct multiples of 4 for the rows of a quarter warp).
__host__ __device__ constexpr bool solve_unrolled(int n) { return n == 24 || n == 8; }
__host__ __device__ constexpr int solve_ld(int n) { return solve_unrolled(n) ? n + 4 : n; }

// the squarings of the nilpotent doubling: cover = 2, 4, ... while < n
__host__ __device__ constexpr int solve_rounds(int n) {
  int r = 0;
  for (int cover = 2; cover < n; cover *= 2) ++r;
  return r;
}

// Offsets, in 4-byte words, of the block's arrays in dynamic shared memory.
struct Smem {
  // float
  int st, pos, cd, pd, lm, lmscr, apm, base, dvec, ya, yb, y0, y1, amat0, amat1, upd, wdf, pcur, ptdel, mp, mpdel,
      apmw, apmpv, ema, mixlrs, indlrs, descf, scalf, sampu;
  // int / uint32
  int rowoff, dstoff, stepv, stepnew, maxst, steff, pair, lanesel, iblane, ibdel, ptslot, mlen, mpslot, mcdel,
      apmi0, winw, winr, scali, indrot, mbyte, mlimit, nsnext, rmnext, desci, tindblk, tptbl, tmtpred, tmtcnt,
      mbar;
  int total;
};

// `tables`: the byte's look-up tables (ind_blk, p_tbl, mt_pred, mt_cnt) have
// room in shared memory too
__host__ __device__ inline Smem smem_layout(const Dims& d, bool tables) {
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
  L.amat0 = take((d.r0 + 1) * d.n0 * d.ld0);
  L.amat1 = take((d.r1 + 1) * d.n1 * d.ld1);
  L.upd = take(d.K);
  L.wdf = take(d.K);
  L.pcur = take(2 * d.M);
  L.ptdel = take(16 * d.M);
  L.mp = take(d.NM);
  L.mpdel = take(8 * d.NM);
  L.apmw = take(d.NA);
  L.apmpv = take(d.NA);
  L.ema = take(d.nc);
  L.mixlrs = take(d.K);
  L.indlrs = take(2 * d.M);
  L.descf = take(3 * d.NA);
  L.scalf = take(8);
  L.sampu = take(d.sample ? 8 : 0);
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
  L.mlen = take(2 * d.NM);  // two buffers: a sub-step reads one and writes the other
  L.mpslot = take(8 * d.NM);
  L.mcdel = take(8 * d.NM);
  L.apmi0 = take(d.NA);
  L.winw = take(kWinPad);
  L.winr = take(kWinPad);
  L.scali = take(4);
  L.indrot = take(d.M);
  L.mbyte = take(d.NM);
  L.mlimit = take(d.NM);
  L.nsnext = take((d.learn && d.M) ? 512 : 0);
  L.rmnext = take((d.learn && d.M) ? 512 : 0);
  L.desci = take(2 * d.K + 2 * d.Klm + d.nskip);
  L.tindblk = take(tables ? d.M * 128 : 0);  // 256 int16 a model
  L.tptbl = take(tables ? 2 * d.M * 256 : 0);
  L.tmtpred = take(tables ? d.NM * 256 : 0);
  L.tmtcnt = take(tables ? d.NM * 256 : 0);
  L.mbar = take(8);  // three 8-byte mbarriers
  L.total = o;
  return L;
}

// The transcendentals and the heads' interval search are called from many
// places of the sub-step loop. They are kept out of line, one copy each:
// inlined they made the kernel twice as long, and a call costs a few tens of
// cycles.
static __device__ __noinline__ float logistic_fn(float x) { return logistic(x); }
static __device__ __noinline__ float logit_fn(float p) { return logit(p); }
static __device__ __noinline__ float pow_fn(float x, float a) { return pow_det(x, a); }

// ---- bulk asynchronous copies (the TMA's 1-D form) between global and
// shared memory: one thread issues them, the hardware moves the bytes and
// counts them off on an mbarrier (loads) or a bulk group (stores). Addresses
// and sizes are multiples of 16 bytes. ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(arrivals) : "memory");
}

// one arrival that also announces `bytes` of copies to wait for
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait for the barrier's first phase; returns at once when it is over
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(0)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst_shared, const void* src_global, uint32_t bytes, uint64_t* bar) {
  if (bytes == 0) return;
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_u32(dst_shared)),
               "l"(src_global), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst_global, const void* src_shared, uint32_t bytes) {
  if (bytes == 0) return;
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst_global),
               "r"(smem_u32(src_shared)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Fixed-pairing tree sums of R sets of P values each (P a power of two,
// P <= 32 * QQ) spread over a warp: thread t holds v[r][q] = x_r[t + 32 q].
// Lane i adds lane i + h for h = P/2, ..., 1, the pairs and the order of
// _tree_sum. Values at or past P are never read. The R sums go side by
// side, so that their shuffles overlap. Leaves sum r in out[r] on every
// thread of the warp.
// (The levels are written out one by one: a loop whose step is a shift is
// not always unrolled, and an array indexed by such a loop's variable lands
// in local memory.)
template <int HQ, int QQ, int R>
__device__ __forceinline__ void fold_groups(float (&v)[R][QQ], int P) {
  if constexpr (HQ >= 1 && HQ < QQ) {
    if (64 * HQ <= P) {  // h = 32 * HQ
#pragma unroll
      for (int q = 0; q < HQ; ++q) {
#pragma unroll
        for (int r = 0; r < R; ++r) v[r][q] = fadd(v[r][q], v[r][q + HQ]);
      }
    }
  }
}

template <int H, int R>
__device__ __forceinline__ void fold_lanes(float (&x)[R], int P) {
  float o[R];
#pragma unroll
  for (int r = 0; r < R; ++r) o[r] = __shfl_down_sync(0xffffffffu, x[r], H);
  if (2 * H <= P) {
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = fadd(x[r], o[r]);
  }
}

template <int QQ, int R>
__device__ __forceinline__ void warp_tree_sums(float (&v)[R][QQ], int P, float (&out)[R]) {
  static_assert(QQ == 1 || QQ == 2 || QQ == 4 || QQ == 8 || QQ == 16, "lane groups are a power of two");
  fold_groups<8>(v, P);
  fold_groups<4>(v, P);
  fold_groups<2>(v, P);
  fold_groups<1>(v, P);
  float x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) x[r] = v[r][0];
  fold_lanes<16>(x, P);
  fold_lanes<8>(x, P);
  fold_lanes<4>(x, P);
  fold_lanes<2>(x, P);
  fold_lanes<1>(x, P);
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = __shfl_sync(0xffffffffu, x[r], 0);
}

template <int QQ>
__device__ __forceinline__ float warp_tree_sum(float (&v)[QQ], int P) {
  float vv[1][QQ], out[1];
#pragma unroll
  for (int q = 0; q < QQ; ++q) vv[0][q] = v[q];
  warp_tree_sums<QQ, 1>(vv, P, out);
  return out[0];
}

// tree sum over lanes [0, n) of a[l] * b[l], padded with +0 to P lanes
template <int QQ>
__device__ __forceinline__ float warp_dot(const float* a, const float* b, int n, int P, int lane) {
  // a lane past n loads lane 0 and drops it: a load under a condition
  // would become a branch of its own, one after the other
  float v[QQ];
#pragma unroll
  for (int q = 0; q < QQ; ++q) {
    const int l = lane + 32 * q, lc = l < n ? l : 0;
    const float x = fmul(a[lc], b[lc]);
    v[q] = l < n ? x : 0.0f;
  }
  return warp_tree_sum<QQ>(v, P);
}

// The dots of mixer rows k0 .. k0 + n - 1 with a base vector, the steps lane
// read as 0 (a select), by warp w of nw, R rows side by side:
// dvec[i] = tree sum of row_i[l] * base[l].
template <int Q, int R>
__device__ __forceinline__ void row_dots(const float* pool, const int* rowoff, int k0, int n, const float* base,
                                         float* dvec, const Dims& d, int w, int nw, int lane) {
#pragma unroll 1
  for (int i0 = w; i0 < n; i0 += nw * R) {
    float v[R][Q];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r * nw;
      const float* row = pool + rowoff[k0 + (i < n ? i : n - 1)];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int l = lane + 32 * q, lc = l < d.WP ? l : 0;  // see warp_dot
        const float w = row[lc], b = base[lc];
        v[r][q] = l < d.WP ? fmul(l == d.SL ? 0.0f : w, b) : 0.0f;
      }
    }
    float s[R];
    warp_tree_sums<Q, R>(v, d.P, s);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r * nw;
      if (lane == 0 && i < n) dvec[i] = s[r];
    }
  }
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
static __device__ __noinline__ float interval_pred(const float* probs, int& top, int& bot, int& mid, uint32_t nb,
                                               bool first, int lane) {
  if (!first) {
    if (nb == 1) bot = mid + 1;
    else top = mid;
  }
  mid = bot + ((top - bot) >> 1);  // floor division
  float v[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int l = lane + 32 * q;
    const float pv = probs[l];
    v[q] = (l >= mid + 1 && l <= top) ? pv : 0.0f;
  }
  const float num = warp_tree_sum<8>(v, 256);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int l = lane + 32 * q;
    const float pv = probs[l];
    v[q] = (l >= bot && l <= mid) ? pv : 0.0f;
  }
  const float den = fadd(num, warp_tree_sum<8>(v, 256));
  const bool nz = den != 0.0f;
  const float p = nz ? fdiv(num, den) : 0.5f;
  return nz ? logit_fn(p) : 0.0f;
}

// a match model's length after the previous sub-step's bit (sub-step 0's
// update ran at the byte boundary)
__device__ __forceinline__ int next_mlen(int mlen, uint32_t mbyte, uint32_t new_bit, uint32_t check_mask, int j) {
  if (j == 0) return mlen;
  const bool hit = new_bit == ((mbyte & check_mask) != 0 ? 1u : 0u);
  return hit ? min(mlen + 1, 255) : 0;
}

// ---- the triangular solve y = d + strict_lower(L) y of one mixer layer by
// nilpotent doubling, (I-A)^-1 = (I+A)(I+A^2)(I+A^4)...: the powers are
// made by the prep group off the dependent chain (solve_build,
// solve_square), the chain runs the products (solve_chain). The tile of
// power r is amat + r * n * n, row-major. N > 0 is n known at compile time
// (n <= 32), N == 0 any n at run time. ----

// A = strict_lower(L): L[i][c] is lane off + c of the layer's row i
__device__ __forceinline__ void solve_build(const float* pool, const int* rowoff, int k0, int n, int ld, int off,
                                            int SL, float* amat, int w, int lane) {
  // four rows of a warp at a time, every load before the first store (the
  // compiler does not move a shared load above an earlier shared store)
#pragma unroll 1
  for (int c = lane; c < n; c += 32) {
#pragma unroll 1
    for (int i0 = w; i0 < n; i0 += 4 * kPrepWarps) {
      float x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kPrepWarps;
        x[u] = pool[rowoff[k0 + (i < n ? i : n - 1)] + off + c];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kPrepWarps;
        if (i < n) amat[i * ld + c] = (c < i && off + c != SL) ? x[u] : 0.0f;
      }
    }
  }
}

// dst = src @ src: per element a forward loop of fused multiply-adds from
// +0 over jj = 0 .. n-1. A lane owns a column and keeps it in registers, a
// warp owns a set of rows and reads them 16 bytes at a time (a broadcast).
template <int N>
__device__ __forceinline__ void solve_square(const float* src, float* dst, int n_rt, int w, int lane) {
  if constexpr (N > 0) {
    static_assert(N <= 32 && N % 4 == 0, "a lane owns one column; rows are read as float4");
    constexpr int LD = solve_ld(N);
    constexpr int R = (N + kPrepWarps - 1) / kPrepWarps;  // rows of a warp: w, w + kPrepWarps, ...
    const int k = lane < N ? lane : 0;
    float b[N];
#pragma unroll
    for (int jj = 0; jj < N; ++jj) b[jj] = src[jj * LD + k];
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll
    for (int j4 = 0; j4 < N / 4; ++j4) {
      float4 a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = w + r * kPrepWarps;
        a[r] = *reinterpret_cast<const float4*>(src + (i < N ? i : 0) * LD + 4 * j4);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = __fmaf_rn(a[r].x, b[4 * j4], acc[r]);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = __fmaf_rn(a[r].y, b[4 * j4 + 1], acc[r]);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = __fmaf_rn(a[r].z, b[4 * j4 + 2], acc[r]);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = __fmaf_rn(a[r].w, b[4 * j4 + 3], acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = w + r * kPrepWarps;
      if (i < N && lane < N) dst[i * LD + lane] = acc[r];
    }
  } else {
    const int n = n_rt;
#pragma unroll 1
    for (int i = w; i < n; i += kPrepWarps) {
#pragma unroll 1
      for (int k = lane; k < n; k += 32) {
        float acc = 0.0f;
#pragma unroll 4
        for (int jj = 0; jj < n; ++jj) acc = __fmaf_rn(src[i * n + jj], src[jj * n + k], acc);
        dst[i * n + k] = acc;
      }
    }
  }
}

// one level of the fixed-pairing tree over an array in registers
template <int H, int P>
__device__ __forceinline__ void fold_serial(float (&t)[P]) {
  if constexpr (2 * H <= P) {
#pragma unroll
    for (int k = 0; k < H; ++k) t[k] = fadd(t[k], t[k + H]);
  }
}

// The chain of a layer of N <= 32 rows on ONE warp, so that its rounds meet
// at __syncwarp() and not at a block barrier: lane i owns row i, reads it 16
// bytes at a time, and sums the N products by the same fixed pairs as the
// warp-wide tree (x[k] + x[k + h] for h = P/2 .. 1, products at or past N as
// +0), only serially. y goes from round to round through ya / yb. Leaves y
// in `out` and, where they are not null, in o1 and o2; the caller's block
// barrier publishes them.
template <int N>
__device__ __forceinline__ void solve_chain_warp(const float* amat, int rounds, const float* dvec, float* ya,
                                                 float* yb, float* out, float* o1, float* o2, int lane) {
  static_assert(N <= 32 && N % 4 == 0, "a lane owns one row; rows are read as float4");
  constexpr int LD = solve_ld(N), P = pow2_ceil(N);
  const int i = lane < N ? lane : 0;
  const float* yin = dvec;
  float mine = dvec[i];
#pragma unroll 1
  for (int r = 0; r <= rounds; ++r) {
    const float4* row = reinterpret_cast<const float4*>(amat + r * N * LD + i * LD);
    const float4* y4 = reinterpret_cast<const float4*>(yin);
    float t[P];
#pragma unroll
    for (int k4 = 0; k4 < N / 4; ++k4) {
      const float4 a = row[k4], y = y4[k4];
      t[4 * k4] = fmul(a.x, y.x);
      t[4 * k4 + 1] = fmul(a.y, y.y);
      t[4 * k4 + 2] = fmul(a.z, y.z);
      t[4 * k4 + 3] = fmul(a.w, y.w);
    }
#pragma unroll
    for (int k = N; k < P; ++k) t[k] = 0.0f;
    fold_serial<16>(t);
    fold_serial<8>(t);
    fold_serial<4>(t);
    fold_serial<2>(t);
    fold_serial<1>(t);
    mine = fadd(mine, t[0]);
    float* yout = (r & 1) ? yb : ya;
    if (lane < N) yout[lane] = mine;
    __syncwarp();
    yin = yout;
  }
  if (lane < N) {
    out[lane] = mine;
    if (o1) o1[lane] = mine;
    if (o2) o2[lane] = mine;
  }
}

// yout[i] = yin[i] + tree sum over k of a[i][k] * yin[k], any n, by all
// warps; the result also goes to o1 and o2 where they are not null
template <int Q>
__device__ __forceinline__ void solve_matvec(const float* a, const float* yin, int n, int warp, int lane,
                                             float* yout, float* o1, float* o2) {
  const int p = pow2_ceil(n);
#pragma unroll 1
  for (int i = warp; i < n; i += kWarps) {
    const float s = warp_dot<Q>(a + i * n, yin, n, p, lane);
    if (lane == 0) {
      const float y = fadd(yin[i], s);
      yout[i] = y;
      if (o1) o1[i] = y;
      if (o2) o2[i] = y;
    }
  }
}

// The chain of a layer of any size on the whole block, the generic path:
// reads dvec, leaves y in `out` and, where they are not null, in o1 and o2.
// Every thread of the block calls it; it ends with a block barrier. One
// copy serves both layers, out of line.
template <int Q>
static __device__ __noinline__ void solve_chain_any(const float* amat, int n, int rounds, const float* dvec, float* ya,
                                                    float* yb, float* out, float* o1, float* o2, int warp, int lane) {
  if (n <= 1) {
    if (threadIdx.x < n) {
      const float y = dvec[threadIdx.x];
      out[threadIdx.x] = y;
      if (o1) o1[threadIdx.x] = y;
      if (o2) o2[threadIdx.x] = y;
    }
    __syncthreads();
    return;
  }
  const float* yin = dvec;
#pragma unroll 1
  for (int r = 0; r <= rounds; ++r) {
    const bool last = r == rounds;
    float* yout = last ? out : ((r & 1) ? yb : ya);
    solve_matvec<Q>(amat + r * n * n, yin, n, warp, lane, yout, last ? o1 : nullptr, last ? o2 : nullptr);
    __syncthreads();
    yin = yout;
  }
}

// the generic squaring serves both layers: one copy, out of line
static __device__ __noinline__ void solve_square_any(const float* src, float* dst, int n, int w, int lane) {
  solve_square<0>(src, dst, n, w, lane);
}

// The one-thread tail of a sub-step: the final probability, the SSE/APM
// chain, one bit through the arithmetic coder, the entropy metric. Out of
// line, because the encoder and the decoder call it from different places.
struct TailState {
  uint32_t x1, x2, x, wpos, rpos;
  float ent;
};

struct TailArgs {
  const float* apm;      // (NA, 8, kApmBins)
  const float* apm_wgt;  // weights, then 1 - weights
  float* apmw;
  float* apmpv;
  int* apmi0;
  const uint32_t* winr;
  uint32_t* winw;
  int NA;
  uint32_t wpos0, rpos0;
  bool decode;
  bool sample;           // draw the bit (encode mode): sampu[j] < logistic(logit(p) * inv_temp)
  const float* sampu;    // the byte's 8 uniforms
  float inv_temp;
};

static __device__ __noinline__ uint32_t coder_tail(TailState& st, const TailArgs& a, float final_logit,
                                                   uint32_t enc_bit, int j) {
  const float* apm_omw = a.apm_wgt + a.NA;
  float prob = clamp_prob(logistic_fn(final_logit));
  float apm_l = final_logit, apm_p = prob;
#pragma unroll 1
  for (int s = 0; s < a.NA; ++s) {
    const float* row = a.apm + s * 8 * kApmBins + j * kApmBins;
    const float pos = fmul(fadd(clampf(apm_l, -kApmSpan, kApmSpan), kApmSpan),
                           static_cast<float>((kApmBins - 1) / (2 * 16.0)));
    const int i0 = min(__float2int_rz(pos), kApmBins - 2);
    const float w = fsub(pos, static_cast<float>(i0));
    // the interpolation of the two bins: the only nonzero terms of the
    // plain version's 33-term sum
    const float pv = fadd(fmul(row[i0], fsub(1.0f, w)), fmul(row[i0 + 1], w));
    apm_p = clamp_prob(fadd(fmul(a.apm_wgt[s], pv), fmul(apm_omw[s], apm_p)));
    apm_l = logit_fn(apm_p);
    a.apmi0[s] = i0;
    a.apmw[s] = w;
    a.apmpv[s] = pv;
  }
  prob = apm_p;
  if (a.sample) {
    // temperature sampling (runner-utils.cpp:202-206)
    const float p_temp = logistic_fn(fmul(logit_fn(prob), a.inv_temp));
    enc_bit = a.sampu[j] < p_temp ? 1u : 0u;
  }

  // arithmetic coder (encoder.cpp:10-25 / decoder.cpp:19-39)
  uint32_t x1 = st.x1, x2 = st.x2, x = st.x;
  const uint32_t p16 = static_cast<uint32_t>(__float2int_rz(fadd(1.0f, fmul(65534.0f, prob))));
  const uint32_t rng = x2 - x1;
  const uint32_t xmid = x1 + (rng >> 16) * p16 + (((rng & 0xFFFFu) * p16) >> 16);
  const uint32_t bit = a.decode ? (x <= xmid ? 1u : 0u) : enc_bit;
  if (bit) x2 = xmid;      // bit==1 keeps [x1, xmid]
  else x1 = xmid + 1u;     // bit==0 keeps [xmid+1, x2]
  const uint32_t off_r = st.rpos - a.rpos0, off_w = st.wpos - a.wpos0;
  uint32_t emits[4];
  uint32_t nren = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool cond = ((x1 ^ x2) & 0xFF000000u) == 0;
    emits[i] = cond ? (x2 >> 24) : 0u;
    // window lanes past the window read 0
    const uint32_t in_byte = off_r + i < kWinPad ? a.winr[off_r + i] : 0u;
    if (cond) {
      x1 = x1 << 8;
      x2 = (x2 << 8) | 255u;
      if (a.decode) x = (x << 8) | in_byte;
      nren += 1u;
    }
  }
  if (!a.decode) {
    // each window lane is written at most once per byte
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (static_cast<uint32_t>(i) < nren && off_w + i < kWinPad) a.winw[off_w + i] += emits[i];
    st.wpos += nren;
  } else {
    st.rpos += nren;
  }
  st.x1 = x1; st.x2 = x2; st.x = x;
  const float p_bit = bit == 1u ? prob : fsub(1.0f, prob);
  st.ent = fsub(st.ent, log2f(p_bit));
  return bit;
}

template <int Q, bool kTables, bool kClocks>
__global__ void __launch_bounds__(kThreads, 1) fused_substeps_kernel(const Dims d, const FusedIO io) {
  extern __shared__ __align__(16) float smf[];
  int* smi = reinterpret_cast<int*>(smf);
  uint32_t* smu = reinterpret_cast<uint32_t*>(smf);
  const Smem L = smem_layout(d, kTables);
  const int s = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = d.M, M2 = 2 * d.M, NM = d.NM, n0 = d.n0, n1 = d.n1, K = d.K, WP = d.WP, SL = d.SL;
  const int n_pred = d.n_pred, nskip = d.nskip, NA = d.NA, Klm = d.Klm, nh = d.ppm + d.lstm;
  const bool learn = d.learn != 0, analysis = d.analysis != 0;

  auto stamp = [&](int j, int col) {
    if (kClocks) {
      // the memory clobber keeps the read where it stands among barriers and loads
      long long t;
      asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
      io.out_clocks[(int64_t(s) * 8 + j) * kClockCols + col] = t;
    }
  };
  if (tid == 0) stamp(0, kClkStart);

  // shared arrays
  float* pool = smf;  // all class rows, addressed by word offsets
  float* lmscr = smf + L.lmscr;
  float* apm = smf + L.apm;
  float* base0 = smf + L.base;
  float* base1 = base0 + WP;
  float* base2 = base1 + WP;
  float* dvec = smf + L.dvec;
  float* ya = smf + L.ya;
  float* yb = smf + L.yb;
  float* y0 = smf + L.y0;
  float* y1 = smf + L.y1;
  float* amat0 = smf + L.amat0;
  float* amat1 = smf + L.amat1;
  float* upd = smf + L.upd;
  float* wdf = smf + L.wdf;
  float* pcur = smf + L.pcur;
  float* ptdel = smf + L.ptdel;
  float* mpv = smf + L.mp;
  float* mpdel = smf + L.mpdel;
  float* apmw = smf + L.apmw;
  float* apmpv = smf + L.apmpv;
  float* ema = smf + L.ema;
  float* mix_lrs = smf + L.mixlrs;
  float* ind_lrs = smf + L.indlrs;
  float* apm_wgt = smf + L.descf;
  float* apm_lr = apm_wgt + 2 * NA;
  float* decay = smf + L.scalf;  // the learn stage's global step size of each sub-step
  float* sampu = smf + L.sampu;  // the byte's 8 uniforms, when sampling
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
  int* mlen_buf = smi + L.mlen;
  int* mpslot = smi + L.mpslot;
  int* mcdel = smi + L.mcdel;
  int* apmi0 = smi + L.apmi0;
  uint32_t* winw = smu + L.winw;
  uint32_t* winr = smu + L.winr;
  int* scali = smi + L.scali;
  uint32_t* ind_rot = smu + L.indrot;
  uint32_t* match_byte = smu + L.mbyte;
  int* match_limits = smi + L.mlimit;
  int* ns_next = smi + L.nsnext;
  int* rm_next = smi + L.rmnext;
  // descriptors
  int* k_class = smi + L.desci;
  int* k_index = k_class + K;
  int* lm_sizes = k_index + K;
  int* lm_offs = lm_sizes + Klm;
  int* skip_cols = lm_offs + Klm;

  // this stream's inputs
  const int64_t* sc = io.in_sc + int64_t(s) * 8;
  const int64_t* cr = io.in_coder + int64_t(s) * 8;
  // the byte's look-up tables: in shared memory where they fit (kTables)
  const int16_t* g_ind_blk = M ? io.in_ind_blk + int64_t(s) * M * 256 : nullptr;
  const float* g_p_tbl = M ? io.in_p_tbl + int64_t(s) * M2 * 256 : nullptr;
  const float* g_mt_pred = NM ? io.in_mt_pred + int64_t(s) * NM * 256 : nullptr;
  const int32_t* g_mt_cnt = NM ? io.in_mt_cnt + int64_t(s) * NM * 256 : nullptr;
  const int16_t* ind_blk = kTables ? reinterpret_cast<const int16_t*>(smi + L.tindblk) : g_ind_blk;
  const float* p_tbl = kTables ? smf + L.tptbl : g_p_tbl;
  const float* mt_pred = kTables ? smf + L.tmtpred : g_mt_pred;
  const int32_t* mt_cnt = kTables ? smi + L.tmtcnt : g_mt_cnt;
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smi + L.mbar);
  uint64_t* bar_tables = mbar;    // ind_blk, p_tbl, mt_pred: stage 1 of sub-step 0 reads them
  uint64_t* bar_rows = mbar + 1;  // the working rows and the APM rows
  uint64_t* bar_late = mbar + 2;  // mt_cnt: the learn stage reads it first
  const float* ppm_probs = d.ppm ? io.in_ppm_probs + int64_t(s) * 256 : nullptr;
  const float* lstm_probs = d.lstm ? io.in_lstm_probs + int64_t(s) * 256 : nullptr;

  // ---- load: one thread starts the bulk copies of the working rows and,
  // where they fit, of the tables; every thread loads constants meanwhile ----
  if (tid == 0) {
    mbar_init(bar_tables, 1);
    mbar_init(bar_rows, 1);
    mbar_init(bar_late, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const uint32_t b_st = d.Kst * WP * 4, b_pos = d.Kp * 8 * WP * 4, b_cd = d.Kcd * WP * 4, b_pd = d.Kpd * 8 * WP * 4,
                   b_lm = d.Tlm * WP * 4, b_apm = NA * 8 * kApmBins * 4;
    const uint32_t b_ib = kTables ? M * 512 : 0, b_pt = kTables ? M2 * 1024 : 0, b_mt = kTables ? NM * 1024 : 0;
    mbar_expect(bar_tables, b_ib + b_pt + b_mt);
    bulk_load(smi + L.tindblk, g_ind_blk, b_ib, bar_tables);
    bulk_load(smf + L.tptbl, g_p_tbl, b_pt, bar_tables);
    bulk_load(smf + L.tmtpred, g_mt_pred, b_mt, bar_tables);
    mbar_expect(bar_rows, b_st + b_pos + b_cd + b_pd + b_lm + b_apm);
    bulk_load(pool + L.st, io.in_rows_st + int64_t(s) * d.Kst * WP, b_st, bar_rows);
    bulk_load(pool + L.pos, io.in_rows_pos + int64_t(s) * d.Kp * 8 * WP, b_pos, bar_rows);
    bulk_load(pool + L.cd, io.in_rows_cd + int64_t(s) * d.Kcd * WP, b_cd, bar_rows);
    bulk_load(pool + L.pd, io.in_blocks_pd + int64_t(s) * d.Kpd * 8 * WP, b_pd, bar_rows);
    bulk_load(pool + L.lm, io.in_lm_tbl + int64_t(s) * d.Tlm * WP, b_lm, bar_rows);
    bulk_load(apm, io.in_apm_rows + int64_t(s) * NA * 8 * kApmBins, b_apm, bar_rows);
    mbar_expect(bar_late, b_mt);
    bulk_load(smi + L.tmtcnt, g_mt_cnt, b_mt, bar_late);
  }
#pragma unroll 1
  for (int i = tid; i < K; i += kThreads) {
    maxst[i] = static_cast<uint32_t>(io.in_max_steps[int64_t(s) * K + i]);
    mix_lrs[i] = io.in_mix_lrs[i];
  }
#pragma unroll 1
  for (int i = tid; i < M; i += kThreads) ind_rot[i] = static_cast<uint32_t>(io.in_ind_rot[int64_t(s) * M + i]);
#pragma unroll 1
  for (int i = tid; i < M2; i += kThreads) ind_lrs[i] = io.in_ind_lrs[i];
#pragma unroll 1
  for (int i = tid; i < NM; i += kThreads) {
    mlen_buf[i] = io.in_match_len[int64_t(s) * NM + i];
    match_byte[i] = static_cast<uint32_t>(io.in_match_byte[int64_t(s) * NM + i]);
    match_limits[i] = io.in_match_limits[i];
  }
#pragma unroll 1
  for (int i = tid; i < 3 * NA; i += kThreads) apm_wgt[i] = io.in_desc_f[i];
#pragma unroll 1
  for (int i = tid; i < 2 * K + 2 * Klm + nskip; i += kThreads) k_class[i] = io.in_desc_i[i];
  if (learn && M) {
#pragma unroll 1
    for (int i = tid; i < 512; i += kThreads) {
      ns_next[i] = io.in_ns_next[i];
      rm_next[i] = io.in_rm_next[i];
    }
  }
  if (analysis) {
#pragma unroll 1
    for (int i = tid; i < d.nc; i += kThreads) ema[i] = io.in_ema[int64_t(s) * d.nc + i];
  }
  if (d.sample && tid < 8) sampu[tid] = io.in_sample_u[int64_t(s) * 8 + tid];
#pragma unroll 1
  for (int i = tid; i < kWinPad; i += kThreads) {
    winw[i] = 0u;
    winr[i] = static_cast<uint32_t>(io.in_win_r[int64_t(s) * kWinPad + i]);
  }
  if (learn) {
#pragma unroll 1
    for (int i = tid; i < 8 * M; i += kThreads) { iblane[i] = -1; ibdel[i] = 0; }
#pragma unroll 1
    for (int i = tid; i < 16 * M; i += kThreads) { ptslot[i] = -1; ptdel[i] = 0.0f; }
#pragma unroll 1
    for (int i = tid; i < 8 * NM; i += kThreads) { mpslot[i] = -1; mpdel[i] = 0.0f; mcdel[i] = 0; }
  }

  // per-stream scalars; every thread keeps the uniform ones
  const uint32_t data_byte = static_cast<uint32_t>(sc[0]);
  const uint32_t last_byte = static_cast<uint32_t>(sc[1]);
  const uint32_t recent1 = static_cast<uint32_t>(sc[2]);
  const bool decode = sc[3] != 0;
  const bool not_first = sc[4] != 0;
  // a sampling stream codes, in encode mode, the bit the tail draws
  const bool sample = d.sample && !decode && sc[5] != 0;
  // the coder's registers are live in thread 0 alone
  TailState ts;
  ts.x1 = static_cast<uint32_t>(cr[0]); ts.x2 = static_cast<uint32_t>(cr[1]); ts.x = static_cast<uint32_t>(cr[2]);
  ts.wpos = static_cast<uint32_t>(cr[3]); ts.rpos = static_cast<uint32_t>(cr[4]);
  ts.ent = io.in_ent[s];
  TailArgs ta;
  ta.apm = apm; ta.apm_wgt = apm_wgt; ta.apmw = apmw; ta.apmpv = apmpv; ta.apmi0 = apmi0;
  ta.winr = winr; ta.winw = winw; ta.NA = NA; ta.wpos0 = ts.wpos; ta.rpos0 = ts.rpos; ta.decode = decode;
  ta.sample = sample; ta.sampu = sampu; ta.inv_temp = d.sample ? io.in_inv_temp[0] : 1.0f;
  uint32_t acc = static_cast<uint32_t>(cr[5]), bits_seen = static_cast<uint32_t>(cr[6]);
  uint32_t new_bit = static_cast<uint32_t>(cr[7]);
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
  // the mixers' global step size depends on the bit count alone, which
  // advances by one a sub-step: all eight are made here, off the chain
  if (learn && tid < 8) {
    const float steps_f = __uint2float_rn(bits_seen + static_cast<uint32_t>(not_first ? tid + 1 : tid));
    decay[tid] = fdiv(static_cast<float>(0.9), pow_fn(fadd(fmul(static_cast<float>(1e-7), steps_f), static_cast<float>(0.8)),
                                                      static_cast<float>(0.8)));
  }
  uint32_t bit_ctx = 0, lb_ctx = 0, slb_ctx = 0, longest = 0;
  // where a thread of warps 1.. starts in each per-model learn loop, so
  // that the loops spread over those warps
  const int lt = tid - 32;
  const int lt_ind = lt < 0 ? 0 : (lt + kLearnThreads - d.nc % kLearnThreads) % kLearnThreads;
  const int lt_match = lt < 0 ? 0 : (lt + 2 * kLearnThreads - (d.nc + M2) % kLearnThreads) % kLearnThreads;
  const int lt_mix = lt < 0 ? 0 : (lt + 3 * kLearnThreads - (d.nc + M2 + NM) % kLearnThreads) % kLearnThreads;
  __syncthreads();
  if (tid == 0) stamp(0, kClkLoaded);

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
    // match lengths: read from one buffer, written to the other, because the
    // two groups below both need the lengths of this sub-step
    const int* mlen_in = mlen_buf + (j & 1) * NM;
    int* mlenv = mlen_buf + ((j + 1) & 1) * NM;
    if (NM) {
      int mx = 0;
#pragma unroll 4
      for (int m = 0; m < NM; ++m) mx = max(mx, next_mlen(mlen_in[m], match_byte[m], new_bit, check_mask, j) / 32);
      longest = static_cast<uint32_t>(mx);
    }

    if (warp < kChainWarps) {
      // ======== the chain group ========
      mbar_wait(bar_tables);
      // ---- stage 1: model predictions into base0[0, n_pred), the rest of
      // base0 (zeros and the bit-prefix features) ----
#pragma unroll 1
      for (int l = n_pred + tid; l < WP; l += kChainThreads) {
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
#pragma unroll 1
      for (int c = tid; c < M2; c += kChainThreads) {
        const int m = c < M ? c : c - M;
        const int ls = static_cast<int>((bit_ctx + ind_rot[m]) & 255u);
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
      // match models, from the group's last thread down
#pragma unroll 1
      for (int m = kChainThreads - 1 - tid; m < NM; m += kChainThreads) {
        const uint32_t mbyte = match_byte[m];
        const int mlen = next_mlen(mlen_in[m], mbyte, new_bit, check_mask, j);
        mlenv[m] = mlen;
        assert(mlen >= 0 && mlen < 256);
        float mp = mt_pred[m * 256 + mlen];
        if (learn) mp = fadd(mp, stack_corr(mpdel + m, mpslot + m, NM, mlen, j));
        mpv[m] = mp;
        const float p_prob = (mbyte & pred_mask) != 0 ? mp : fsub(1.0f, mp);
        base0[nh + M2 + m] = mlen > 2 ? logit_fn(p_prob) : 0.0f;
      }
      // PPM / LSTM interval bit predictions, one warp each
      if (d.ppm && warp == kChainWarps - 1) {
        const float lg = interval_pred(ppm_probs, ppm_top, ppm_bot, ppm_mid, new_bit, j == 0, lane);
        if (lane == 0) base0[0] = lg;
      }
      if (d.lstm && warp == kChainWarps - 2) {
        const float lg = interval_pred(lstm_probs, l_top, l_bot, l_mid, new_bit, j == 0, lane);
        if (lane == 0) base0[d.ppm] = lg;
      }
      bar_sync(kBarChain, kChainThreads);
      if (tid == 0) stamp(j, kClkPredict);
      // ---- the tails of base1 / base2: lanes at or past n0 + n1 hold the
      // skip-connection predictions, the prefix features and zeros; base1
      // also has zeros in [n0, n0 + n1) ----
#pragma unroll 1
      for (int l = tid; l < WP; l += kChainThreads) {
        float v = 0.0f;
        const int isk = l - (n0 + n1), ipf = l - d.pl12;
        if (isk >= 0 && isk < nskip) v = base0[skip_cols[isk]];
        else if (d.pl12 >= 0 && ipf >= 0 && ipf < 8) v = base0[d.pl0 + ipf];
        if (l >= n0) base1[l] = l < n0 + n1 ? 0.0f : v;
        if (l >= n0 + n1) base2[l] = v;
      }
      bar_sync(kBarRowsReady, kThreads);  // the prep group's row offsets
      mbar_wait(bar_rows);
      if (tid == 0) stamp(j, kClkRowsWait);
      // ---- layer 0: the rows' dots with base0 ----
      row_dots<Q, (Q <= 4 ? 6 : 3)>(pool, rowoff, 0, n0, base0, dvec, d, warp, kChainWarps, lane);
      if (tid == 0) stamp(j, kClkLayer0Dots);
    } else {
      // ======== the prep group: what depends on the rows alone ========
      const int pw = warp - kChainWarps, pt = tid - kChainThreads;
      mbar_wait(bar_rows);
      // the sub-step's working rows (k-order); longest-match rows go
      // through a scratch copy with the denormal flush
#pragma unroll 1
      for (int i = pw; i < Klm; i += kPrepWarps) {
        const int T = lm_sizes[i];
        const bool in = static_cast<int>(longest) < T;
        const float* src = pool + L.lm + (lm_offs[i] + (in ? static_cast<int>(longest) : 0)) * WP;
        float x[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int l = lane + 32 * q;
          x[q] = src[l < WP ? l : 0];
        }
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int l = lane + 32 * q;
          float v = in ? x[q] : 0.0f;
          if (T > 1 && fabsf(v) < FLT_MIN) v = 0.0f;
          if (l < WP) lmscr[i * WP + l] = v;
        }
      }
#pragma unroll 1
      for (int k = pt; k < K; k += kPrepThreads) {
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
      bar_sync(kBarPrep, kPrepThreads);
      if (pt == 0) stamp(j, kClkPrepRows);
      __threadfence_block();
      bar_arrive(kBarRowsReady, kThreads);
#pragma unroll 1
      for (int k = pt; k < K; k += kPrepThreads) stepv[k] = __float_as_uint(pool[rowoff[k] + SL]);
      // the strictly lower triangles and their powers
      if (n0 > 1) solve_build(pool, rowoff, 0, n0, d.ld0, n_pred, SL, amat0, pw, lane);
      if (n1 > 1) solve_build(pool, rowoff, n0, n1, d.ld1, n0, SL, amat1, pw, lane);

      const int rmax = max(d.r0, d.r1);
#pragma unroll 1
      for (int r = 1; r <= rmax; ++r) {
        bar_sync(kBarPrep, kPrepThreads);
        if (r <= d.r0) {
          const float* src = amat0 + (r - 1) * n0 * d.ld0;
          if (n0 == 24) solve_square<24>(src, amat0 + r * n0 * d.ld0, n0, pw, lane);
          else if (n0 == 8) solve_square<8>(src, amat0 + r * n0 * d.ld0, n0, pw, lane);
          else solve_square_any(src, amat0 + r * n0 * d.ld0, n0, pw, lane);
        }
        if (r <= d.r1) {
          const float* src = amat1 + (r - 1) * n1 * d.ld1;
          if (n1 == 8) solve_square<8>(src, amat1 + r * n1 * d.ld1, n1, pw, lane);
          else if (n1 == 24) solve_square<24>(src, amat1 + r * n1 * d.ld1, n1, pw, lane);
          else solve_square_any(src, amat1 + r * n1 * d.ld1, n1, pw, lane);
        }
      }
      if (pt == 0) stamp(j, kClkPrepDone);
    }
    __syncthreads();
    if (tid == 0) stamp(j, kClkSquaringsWait);

    // ---- layer 0: the triangular solve's chain; y0 also goes to the heads
    // of base1 and base2 ----
    if (solve_unrolled(n0)) {
      if (warp == 0) {
        if (n0 == 24) solve_chain_warp<24>(amat0, d.r0, dvec, ya, yb, y0, base1, base2, lane);
        else solve_chain_warp<8>(amat0, d.r0, dvec, ya, yb, y0, base1, base2, lane);
      }
      __syncthreads();
    } else {
      solve_chain_any<Q>(amat0, n0, d.r0, dvec, ya, yb, y0, base1, base2, warp, lane);
    }
    if (tid == 0) stamp(j, kClkLayer0Solve);

    // ---- layer 1 ----
    row_dots<Q, 1>(pool, rowoff, n0, n1, base1, dvec, d, warp, kWarps, lane);
    __syncthreads();
    if (tid == 0) stamp(j, kClkLayer1Dots);
    if (solve_unrolled(n1)) {
      if (warp == 0) {
        if (n1 == 8) solve_chain_warp<8>(amat1, d.r1, dvec, ya, yb, y1, base2 + n0, nullptr, lane);
        else solve_chain_warp<24>(amat1, d.r1, dvec, ya, yb, y1, base2 + n0, nullptr, lane);
      }
      __syncthreads();
    } else {
      solve_chain_any<Q>(amat1, n1, d.r1, dvec, ya, yb, y1, base2 + n0, nullptr, warp, lane);
    }
    if (tid == 0) stamp(j, kClkLayer1Solve);

    // ---- the final mixer: every warp takes the same dot, so that no
    // barrier has to hand it on ----
    float final_logit;
    {
      float v[1][Q];
      const float* row = pool + rowoff[K - 1];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int l = lane + 32 * q, lc = l < WP ? l : 0;
        const float w = row[lc], b = base2[lc];
        v[0][q] = l < WP ? fmul(l == SL ? 0.0f : w, b) : 0.0f;
      }
      float o[1];
      warp_tree_sums<Q, 1>(v, d.P, o);
      final_logit = o[0];
    }
    if (tid == 0) stamp(j, kClkFinalDot);

    const uint32_t enc_bit = (data_byte >> (7 - j)) & 1u;
    // when decoding or sampling the bit comes out of the tail; when
    // encoding it is known, and the tail runs beside the learn stage below
    uint32_t bit = enc_bit;
    if (decode || sample) {
      if (tid == 0) bit = coder_tail(ts, ta, final_logit, enc_bit, j);
      if (tid == 0) scali[0] = static_cast<int>(bit);
      __syncthreads();
      bit = static_cast<uint32_t>(scali[0]);
    }
    const float bitf = static_cast<float>(bit);

    if (warp == 0) {
      if (!decode && !sample && lane == 0) coder_tail(ts, ta, final_logit, enc_bit, j);
      __syncwarp();
      if (learn) {
        // APM: move the two interpolation bins toward the bit (dense over
        // the stage's 33 bins)
#pragma unroll 1
        for (int a = 0; a < NA; ++a) {
          const int i0 = apmi0[a];
          const float w = apmw[a];
          const float step = fmul(apm_lr[a], fsub(bitf, apmpv[a]));
#pragma unroll 1
          for (int b = lane; b < kApmBins; b += 32) {
            float* cell = apm + a * 8 * kApmBins + j * kApmBins + b;
            const float wv = fadd(b == i0 ? fsub(1.0f, w) : 0.0f, b == i0 + 1 ? w : 0.0f);
            *cell = fadd(*cell, fmul(step, wv));
          }
        }
      }
      if (tid == 0) stamp(j, kClkTail);
    } else {
      // ---- metrics and the per-model learn steps, on warps 1..; the
      // loops start at different threads so that they spread ----
      if (analysis) {
#pragma unroll 1
        for (int c = lt; c < d.nc; c += kLearnThreads) {
          // one load from wherever the column lives
          const float* src = c < n_pred ? base0 + c : c < n_pred + n0 ? y0 + (c - n_pred)
                             : c < n_pred + n0 + n1 ? y1 + (c - n_pred - n0) : base0;
          const float lv = *src;
          const float lg = c < n_pred + n0 + n1 ? lv : final_logit;
          const float pc = clampf(logistic_fn(lg), static_cast<float>(0.01), static_cast<float>(0.99));
          const float pb = bit == 1u ? pc : fsub(1.0f, pc);
          ema[c] = fadd(ema[c], fmul(static_cast<float>(1e-5), fsub(-log2f(pb), ema[c])));
        }
      }
      if (learn) {
        // indirect Learn (indirect.cpp:47-70): the state->logit delta and the
        // advanced state pair go into the byte stacks
#pragma unroll 1
        for (int c = lt_ind; c < M2; c += kLearnThreads) {
          ptslot[j * M2 + c] = steff[c];
          ptdel[j * M2 + c] = fmul(fsub(bitf, logistic_fn(pcur[c])), ind_lrs[c]);
          if (c < M) {
            const int new_ns = ns_next[bit * 256 + steff[c]];
            const int new_rm = rm_next[bit * 256 + steff[M + c]];
            iblane[j * M + c] = lanesel[c];
            ibdel[j * M + c] = (new_ns | (new_rm << 8)) - pairv[c];
          }
        }
        // match per-bit Learn (match.cpp:79-90)
        if (kTables) mbar_wait(bar_late);
#pragma unroll 1
        for (int m = lt_match; m < NM; m += kLearnThreads) {
          const uint32_t mbyte = match_byte[m];
          const int mlen = mlenv[m];
          const float hit2 = bit == ((mbyte & pred_mask) != 0 ? 1u : 0u) ? 1.0f : 0.0f;
          int cnt = mt_cnt[m * 256 + mlen];
#pragma unroll 1
          for (int jj = 0; jj < j; ++jj)
            if (mpslot[jj * NM + m] == mlen) cnt += mcdel[jj * NM + m];
          const int limit = match_limits[m];
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
#pragma unroll 1
        for (int k = lt_mix; k < K; k += kLearnThreads) {
          const float decay_global = decay[j];
          const float yv = *(k < n0 ? y0 + k : k < n0 + n1 ? y1 + (k - n0) : base0);
          const float y = k < n0 + n1 ? yv : final_logit;
          const float novelty = fsub(1.5f, fdiv(__uint2float_rn(stepv[k]), __uint2float_rn(maxst[k])));
          upd[k] = fmul(fmul(fmul(decay_global, novelty), mix_lrs[k]), fsub(logistic_fn(y), bitf));
          const uint32_t sn = stepv[k] + 1u;
          stepnew[k] = sn;
          wdf[k] = (sn & 1023u) == 0 ? kWeightDecay : 1.0f;  // weight decay every 1024 context-steps
          maxst[k] = max(maxst[k], sn);
        }
        bar_sync(kBarLearn, kLearnThreads);
        if (lt == 0) stamp(j, kClkLearnModels);
        // w <- (w - upd * input) * decay, the steps lane rewritten with the
        // incremented bitcast counter; rows go back to where their class
        // keeps them. A warp takes a row, a lane its columns.
#pragma unroll 1
        for (int k = warp - 1; k < K; k += kLearnWarps) {
          const float u = upd[k], wd = wdf[k];
          const int ro = rowoff[k], dst = dstoff[k];
          const float sn = __uint_as_float(stepnew[k]);
          // the row's input is its layer's base vector, but for the lanes of
          // the layer's own outputs, which hold y masked to the rows before k
          const bool l0 = k < n0, l1 = !l0 && k < n0 + n1;
          const float* bp = l0 ? base0 : l1 ? base1 : base2;
          const float* yp = l0 ? y0 : y1;
          const int c0 = l0 ? n_pred : n0, nn = l0 ? n0 : l1 ? n1 : 0, kk = l0 ? k : k - n0;
          // every load is taken by every lane (the index clamped): a load
          // under a condition would become a branch of its own
          float wnew[Q];
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int l = lane + 32 * q, lc = l < WP ? l : 0;
            const int c = lc - c0;
            const bool own = c >= 0 && c < nn;
            const float old = pool[ro + lc], yv = yp[own ? c : 0], bv = bp[lc];
            const float in = own ? fmul(yv, c < kk ? 1.0f : 0.0f) : bv;
            float w = fsub(old, fmul(u, in));
            w = fmul(w, wd);
            wnew[q] = lc == SL ? sn : w;
          }
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int l = lane + 32 * q;
            if (l < WP && dst >= 0) pool[dst + l] = wnew[q];
          }
        }
        if (lt == 0) stamp(j, kClkLearnRows);
      }
    }
    // advance the bit registers
    new_bit = bit;
    acc = (acc << 1) | bit;
    __syncthreads();
    if (tid == 0) stamp(j, kClkLearn);
  }
  const int* mlenv = mlen_buf;  // eight sub-steps leave the lengths in the first buffer

  // ---- apply the deferred per-bit table writes, in sub-step order, as
  // dense passes over all 256 lanes: a thread takes 16 bytes of a table,
  // from shared memory where the tables are there ----
  if (learn) {
    if (kTables) {
      mbar_wait(bar_tables);
      mbar_wait(bar_late);
    }
#pragma unroll 1
    for (int i8 = tid; i8 < M * 32; i8 += kThreads) {  // 8 states (int16) a thread
      const int m = i8 >> 5, l0 = (i8 & 31) * 8;
      const uint4 in = reinterpret_cast<const uint4*>(ind_blk)[i8];
      const uint32_t w[4] = {in.x, in.y, in.z, in.w};
      int lanes[8], dels[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) { lanes[jj] = iblane[jj * M + m]; dels[jj] = ibdel[jj * M + m]; }
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int lo = static_cast<int>(w[e] & 0xFFFFu), hi = static_cast<int>(w[e] >> 16);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          lo += dels[jj] * (l0 + 2 * e == lanes[jj] ? 1 : 0);
          hi += dels[jj] * (l0 + 2 * e + 1 == lanes[jj] ? 1 : 0);
        }
        o[e] = (static_cast<uint32_t>(lo) & 0xFFFFu) | (static_cast<uint32_t>(hi) << 16);
      }
      reinterpret_cast<uint4*>(io.out_ind_blk + int64_t(s) * M * 256)[i8] = make_uint4(o[0], o[1], o[2], o[3]);
    }
#pragma unroll 1
    for (int i4 = tid; i4 < M2 * 64; i4 += kThreads) {  // 4 floats a thread
      const int c = i4 >> 6, l0 = (i4 & 63) * 4;
      const float4 in = reinterpret_cast<const float4*>(p_tbl)[i4];
      float pt[4] = {in.x, in.y, in.z, in.w};
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float del = ptdel[jj * M2 + c];
        const int slot = ptslot[jj * M2 + c];
#pragma unroll
        for (int e = 0; e < 4; ++e) pt[e] = fadd(pt[e], fmul(del, l0 + e == slot ? 1.0f : 0.0f));
      }
      reinterpret_cast<float4*>(io.out_p_tbl + int64_t(s) * M2 * 256)[i4] = make_float4(pt[0], pt[1], pt[2], pt[3]);
    }
#pragma unroll 1
    for (int i4 = tid; i4 < NM * 64; i4 += kThreads) {
      const int m = i4 >> 6, l0 = (i4 & 63) * 4;
      const float4 inp = reinterpret_cast<const float4*>(mt_pred)[i4];
      const int4 inc = reinterpret_cast<const int4*>(mt_cnt)[i4];
      float mtp[4] = {inp.x, inp.y, inp.z, inp.w};
      int mtc[4] = {inc.x, inc.y, inc.z, inc.w};
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float del = mpdel[jj * NM + m];
        const int slot = mpslot[jj * NM + m], cdel = mcdel[jj * NM + m];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool eq = l0 + e == slot;
          mtp[e] = fadd(mtp[e], fmul(del, eq ? 1.0f : 0.0f));
          mtc[e] += cdel * (eq ? 1 : 0);
        }
      }
      reinterpret_cast<float4*>(io.out_mt_pred + int64_t(s) * NM * 256)[i4] = make_float4(mtp[0], mtp[1], mtp[2], mtp[3]);
      reinterpret_cast<int4*>(io.out_mt_cnt + int64_t(s) * NM * 256)[i4] = make_int4(mtc[0], mtc[1], mtc[2], mtc[3]);
    }
  }
  if (kClocks) __syncthreads();
  if (tid == 0) stamp(0, kClkDeferred);
  // ---- write the learned working sets back: bulk stores out of shared
  // memory, which must first see what the threads wrote there ----
  if (learn) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      bulk_store(io.out_rows_st + int64_t(s) * d.Kst * WP, pool + L.st, d.Kst * WP * 4);
      bulk_store(io.out_rows_pos + int64_t(s) * d.Kp * 8 * WP, pool + L.pos, d.Kp * 8 * WP * 4);
      bulk_store(io.out_rows_cd + int64_t(s) * d.Kcd * WP, pool + L.cd, d.Kcd * WP * 4);
      bulk_store(io.out_blocks_pd + int64_t(s) * d.Kpd * 8 * WP, pool + L.pd, d.Kpd * 8 * WP * 4);
      bulk_store(io.out_lm_tbl + int64_t(s) * d.Tlm * WP, pool + L.lm, d.Tlm * WP * 4);
      bulk_store(io.out_apm_rows + int64_t(s) * NA * 8 * kApmBins, apm, NA * 8 * kApmBins * 4);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
#pragma unroll 1
    for (int i = tid; i < K; i += kThreads) io.out_max_steps[int64_t(s) * K + i] = static_cast<int64_t>(maxst[i]);
  }
  if (kClocks) __syncthreads();
  if (tid == 0) stamp(0, kClkWriteback);

  // ---- registers and metrics ----
#pragma unroll 1
  for (int i = tid; i < kWinPad; i += kThreads) io.out_win_w[int64_t(s) * kWinPad + i] = static_cast<int64_t>(winw[i]);
#pragma unroll 1
  for (int i = tid; i < NM; i += kThreads) io.out_match_len[int64_t(s) * NM + i] = mlenv[i];
  if (analysis) {
#pragma unroll 1
    for (int i = tid; i < d.nc; i += kThreads) io.out_ema[int64_t(s) * d.nc + i] = ema[i];
  }
  if (tid == 0) {
    int64_t* oc = io.out_coder + int64_t(s) * 8;
    oc[0] = ts.x1; oc[1] = ts.x2; oc[2] = ts.x; oc[3] = ts.wpos; oc[4] = ts.rpos; oc[5] = acc; oc[6] = bits_seen; oc[7] = new_bit;
    int64_t* ob = io.out_bitregs + int64_t(s) * 8;
    ob[0] = bit_ctx; ob[1] = lb_ctx; ob[2] = slb_ctx; ob[3] = longest; ob[4] = ob[5] = ob[6] = ob[7] = 0;
    io.out_ent[s] = ts.ent;
  }
  if (d.ppm && tid == (kChainWarps - 1) * 32) {
    int32_t* r = io.out_ppm_regs + int64_t(s) * 4;
    r[0] = ppm_top; r[1] = ppm_bot; r[2] = ppm_mid; r[3] = 0;
  }
  if (d.lstm && tid == (kChainWarps - 2) * 32) {
    int32_t* r = io.out_lstm_regs + int64_t(s) * 4;
    r[0] = l_top; r[1] = l_bot; r[2] = l_mid; r[3] = 0;
  }
  // the block may not end before its bulk stores have read shared memory
  if (learn && tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  if (kClocks) __syncthreads();
  if (tid == 0) stamp(0, kClkEnd);
}

// Launch the instantiation for Q lane groups, with the tables in shared
// memory or not. Defined once per pair by fused_inst.cu; fused.cu picks. Returns the launch's cudaError_t.
// prepare_fused_variant does what the first launch on a device does before
// it launches (raise the dynamic shared-memory limit) and launches nothing.
template <int Q, bool kTables>
int launch_fused_variant(const Dims& d, const FusedIO& io, size_t smem_bytes, bool clocks, cudaStream_t stream);
template <int Q, bool kTables>
int prepare_fused_variant();
#define GMIX_DECLARE_VARIANT(Q_)                                                                         \
  template <> int launch_fused_variant<Q_, false>(const Dims&, const FusedIO&, size_t, bool, cudaStream_t); \
  template <> int launch_fused_variant<Q_, true>(const Dims&, const FusedIO&, size_t, bool, cudaStream_t);  \
  template <> int prepare_fused_variant<Q_, false>();                                                     \
  template <> int prepare_fused_variant<Q_, true>();
GMIX_DECLARE_VARIANT(1)
GMIX_DECLARE_VARIANT(2)
GMIX_DECLARE_VARIANT(4)
GMIX_DECLARE_VARIANT(8)
GMIX_DECLARE_VARIANT(16)
#undef GMIX_DECLARE_VARIANT

}  // namespace gmix
