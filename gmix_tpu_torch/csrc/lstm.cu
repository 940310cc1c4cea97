// The LSTM byte model's per-byte work for Hopper (sm_90a) (core/lstm.py):
//
//   lstm_forward_kernel:  one byte of the forward pass at the state's epoch:
//                         the layer input [ppm_probs | hidden[:C] | 1], the
//                         symbol column plus the w_in row products summed
//                         over the fixed tree, the layer norm with its gains,
//                         the CIFG gates, the cell and the hidden vector, the
//                         epoch's out_w logits, the softmax and its argmax;
//                         writes the epoch's records, `cell`, `hidden`,
//                         `probs`, `top`, `bot`, the head's registers, the
//                         `lstm_ctx` context, and advances the epoch
//   lstm_perceive_kernel: the byte end's SGD of the output layer: the
//                         symbol into `in_hist`, the error against the
//                         epoch's outputs, and out_w[e] = out_w[e - 1] -
//                         (hidden * lr) * err over all C+1 rows
//
// Replaces no TPU kernel: gmix_tpu computes both in plain jnp outside any
// pallas_call (gmix_tpu/core/step.py `_lstm_forward`, `_lstm_perceive`).
// Their plain versions here are ~200 small torch ops a byte step, each a node
// of the step's CUDA graph at about 1.2 us.
//
// What bounds it on this card: bytes, then latency. A stream reads its gate
// rows of w_in (3C x LI floats: 184 KB at C = 50) and the epoch's out_w slice
// ((C+1) x 256 floats: 52 KB) once, ~4 us at 54 streams and 3.35 TB/s; the
// arithmetic is ~100 k float ops a stream. So:
// - the forward pass is one thread-block cluster a stream, of K blocks
//   (K = 1, 2, 4 or 8, chosen by the wrapper from the stream count, so that
//   the clusters fill the SMs). Block r takes a contiguous share of the 3C
//   gate rows and of the 256 outputs. Its rows are one contiguous range of
//   w_in, its columns of out_w C+1 ranges: cp.async copies both into shared
//   memory 16 bytes at a time, with no register held, while the threads load
//   the layer input, the gains and the symbol column. (Held in registers,
//   the out_w columns went to local memory, which the large shared memory
//   leaves little L1 for: twice the time);
// - a warp takes a row: lane l holds the products l + 32k of the row padded
//   to a power of two, so the register tree and then the shuffles are the
//   plain version's tree. Each block's gate values go to the others through
//   distributed shared memory; every block then computes the layer norm and
//   the cells itself (C threads, a few hundred float ops), since its logits
//   need the whole hidden vector. Each block writes its logits into rank 0's
//   shared memory, and rank 0 alone does the softmax, the argmax and the
//   writes of the epoch's records;
// - the perceive kernel is a stream of 52 KB a stream read and written once:
//   a thread takes 4 weights (16-byte loads and stores), blocks of 256
//   threads cover a stream's C+1 rows, and the grid every stream.
//
// Exactness (the decoder replays these bits; the kernels equal the plain
// version bit for bit, tests/test_torch_kernels.py):
// - every inexact sum is core/lstm.py `_tree_sum_dim`: halves added
//   elementwise over the axis zero-padded to a power of two. The padding's
//   zeros are added, not skipped: -0.0 + 0.0 is +0.0. Lane l holding
//   elements l + 32k gives that pairing in registers (k with k + h) and then
//   over the lanes (xor shuffles: a lane above its partner adds the same two
//   values the other way round, which rounds the same);
// - every float op is detmath.cuh's (never contracted, never approximate),
//   in the plain version's order: f = w_sym + tree(w_in * li); ivar =
//   1 / sqrt_det(tree(f * f) / C + 1e-5); pre = (f * ivar) * gamma + beta;
//   cell = (last * forget) + (innode * in_gate); logits - max(max, 0);
//   probs = p / tree(p); new_w = w - ((hidden * lr) * err);
// - the max is exact in any order (a +0 / -0 tie changes no exp), and the
//   argmax takes the first of equal maxima, as torch.argmax does;
// - the state's leaves are written in place: a stream's `cell` and
//   `hidden` are read by every block of its cluster before the first
//   cluster barrier, and written by rank 0 after it. The epoch, one leaf of
//   all streams, is advanced by the launch's last cluster past that barrier
//   (a counter in device memory, which that cluster sets back to 0): every
//   block has read it by then, and no node is spent on it.

#include <cassert>
#include <climits>
#include <cmath>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "detmath.cuh"

// The kernels' arguments, as the Python wrappers fill them (core/lstm.py
// _ForwardArgs, _PerceiveArgs). Shapes by stream count S, cells C, horizon
// Hz, aux input IN, outputs OUT; LI = IN + C + 1.
struct GmixLstmForwardArgs {
  int32_t* epoch;         // () the window's epoch; advanced by the launch's last cluster
  const float* aux;       // (S, IN) ppm_probs
  const int64_t* sym;     // (S,) last_byte
  const float* w_sym;     // (S, 3, C, OUT)
  const float* w_in;      // (S, 3, C, LI), 16-byte aligned
  const float* gamma;     // (S, 3, C)
  const float* beta;      // (S, 3, C)
  const float* out_w;     // (S, Hz, C + 1, OUT)
  const int32_t* mid;     // (S,)
  float* cell;            // (S, C)
  float* hidden;          // (S, C + 1)
  float* probs;           // (S, OUT)
  int32_t* top;           // (S,)
  int32_t* bot;           // (S,)
  int32_t* regs;          // (S, 4) the head's registers: top, bot, mid, 0
  float* layer_input;     // (S, Hz, LI)
  float* norm;            // (S, 3, Hz, C)
  float* ivar;            // (S, 3, Hz)
  float* gate_state;      // (S, 3, Hz, C) forget, innode, output gate
  float* tanh_state;      // (S, Hz, C)
  float* in_gate;         // (S, Hz, C)
  float* last_state;      // (S, Hz, C)
  float* outputs;         // (S, Hz, OUT)
  int64_t* ctx;           // (S, n_ctx)
  int32_t* done;          // () clusters of the launch that have finished; 0 between launches
  int64_t S, C, Hz, IN, OUT, n_ctx, ctx_slot, cluster;
};

struct GmixLstmPerceiveArgs {
  const int32_t* epoch;   // () the epoch after this byte's forward pass
  const int64_t* inp;     // (S,) the byte just coded, every inp_stride-th
  const float* outputs;   // (S, Hz, OUT)
  const float* hidden;    // (S, C + 1)
  float* out_w;           // (S, Hz, C + 1, OUT), 16-byte aligned
  int32_t* in_hist;       // (S, Hz)
  int64_t S, C, Hz, OUT, record, inp_stride;
  float lr;
};

namespace {

using namespace gmix;
namespace cg = cooperative_groups;

constexpr int kThreads = 512;  // forward: a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxInput = 512;  // LI, padded
constexpr int kMaxHidden = 64;  // C + 1, padded
constexpr int kMaxRows = 3 * (kMaxHidden - 1);
constexpr int kMaxOut = 256;
constexpr int kMaxCluster = 8;  // the portable cluster size
// the forward kernel's dynamic shared memory at most (a block's rows of w_in
// and columns of out_w); the static arrays take ~9 KB of the 227 KB a block
// may opt in to
constexpr int kMaxDynamicSmem = 204800;
constexpr int kPerceiveThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNormEps = static_cast<float>(1e-5);

__host__ __device__ __forceinline__ int pow2_ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The levels of the fixed tree from half-size H down to 1, in registers:
// v[k] += v[k + h] for k < h, where a level of half-size `unit` x h exists
// (unit x 2h <= n). H is a template argument so that every loop has a
// constant bound and v never leaves the registers.
template <int H, int kMax>
__device__ __forceinline__ void tree_levels(float (&v)[kMax], int n, int unit) {
  if constexpr (H >= 1) {
    if (unit * H < n) {
#pragma unroll
      for (int k = 0; k < H; ++k) v[k] = fadd(v[k], v[k + H]);
    }
    tree_levels<H / 2>(v, n, unit);
  }
}

// The sum of a vector zero-padded to n (a power of two) elements over the
// fixed tree, across a warp: lane l holds element l + 32k in v[k]; below 32
// elements lane l < n holds element l in v[0]. Every lane returns the sum.
template <int kMax>
__device__ __forceinline__ float warp_tree(float (&v)[kMax], int n) {
  tree_levels<kMax / 2>(v, n, 32);
  float x = v[0];
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    if (off < n) x = fadd(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// The same tree within one thread: v holds the n elements.
template <int kMax>
__device__ __forceinline__ float thread_tree(float (&v)[kMax], int n) {
  tree_levels<kMax / 2>(v, n, 1);
  return v[0];
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most `kPending` of this thread's committed groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The blocks' share of n items: block r of K takes [r * per, min(n, (r + 1) * per))
__host__ __device__ __forceinline__ int share(int n, int K) { return (n + K - 1) / K; }

// A block's outputs: a multiple of 4, so that its columns of out_w start on
// a 16-byte boundary
__host__ __device__ __forceinline__ int out_share(int OUT, int K) { return 4 * share(OUT / 4, K); }

// Floats of a forward block's dynamic shared memory before its out_w columns:
// its rows of w_in, from the 16-byte boundary at or before its first float to
// the one after its last
__host__ __device__ __forceinline__ int rows_floats(int C, int IN, int K) {
  return (share(3 * C, K) * (IN + C + 1) + 8 + 3) / 4 * 4;
}

// The dynamic shared memory of a forward launch: the block's rows of w_in,
// then its columns of the epoch's out_w, (C+1) x its outputs
__host__ __device__ __forceinline__ int64_t forward_smem(int64_t C, int64_t IN, int64_t OUT, int64_t K) {
  const int k = static_cast<int>(K);
  return (static_cast<int64_t>(rows_floats(static_cast<int>(C), static_cast<int>(IN), k)) +
          (C + 1) * out_share(static_cast<int>(OUT), k)) * 4;
}

__global__ void __launch_bounds__(kThreads) lstm_forward_kernel(const __grid_constant__ GmixLstmForwardArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int s = static_cast<int>(blockIdx.x) / K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = static_cast<int>(a.C), Hz = static_cast<int>(a.Hz), IN = static_cast<int>(a.IN);
  const int OUT = static_cast<int>(a.OUT);
  const int LI = IN + C + 1, R = 3 * C, H = C + 1;
  const int P_in = pow2_ceil(LI), P_c = pow2_ceil(C), P_h = pow2_ceil(H), P_out = pow2_ceil(OUT);
  // a volatile read: it stays before the first cluster barrier, after which
  // the launch's last cluster may advance the epoch
  const int e = *static_cast<const volatile int32_t*>(a.epoch);
  const int rpb = share(R, K), r0 = min(R, rank * rpb), nrows = min(R, r0 + rpb) - r0;
  const int opb = out_share(OUT, K), o0 = min(OUT, rank * opb), nout = min(OUT, o0 + opb) - o0;
  const int64_t sR = static_cast<int64_t>(s) * R, se = static_cast<int64_t>(s) * Hz + e;

  extern __shared__ __align__(16) float rows_s[];
  __shared__ float li_s[kMaxInput];
  __shared__ float wsym_s[kMaxRows], f_s[kMaxRows], f_all[kMaxRows], gamma_s[kMaxRows], beta_s[kMaxRows];
  __shared__ float cell_s[kMaxHidden], hid_s[kMaxHidden], ivar_s[3];
  __shared__ float lg_all[kMaxOut], p_s[kMaxOut];
  __shared__ float red_v[kWarps], sum_s;
  __shared__ int red_i[kWarps];

  // (1) this block's gate rows of w_in and its columns of the epoch's out_w
  // into shared memory, 16 bytes a copy (4 where the last copy of w_in would
  // pass the tensor's end)
  const int64_t total = a.S * R * LI;
  const int64_t ga = (sR + r0) * LI, gb = ga + static_cast<int64_t>(nrows) * LI;
  const int64_t g0 = ga & ~static_cast<int64_t>(3);
  for (int64_t g = g0 + 4 * tid; g < gb; g += 4 * kThreads) {
    float* dst = rows_s + (g - g0);
    if (g + 4 <= total) {
      cp_async16(dst, a.w_in + g);
    } else {
      for (int j = 0; j < 4 && g + j < total; ++j) cp_async4(dst + j, a.w_in + g + j);
    }
  }
  cp_async_commit();
  const int shift = static_cast<int>(ga - g0);
  float* ow_s = rows_s + rows_floats(C, IN, K);  // (C+1, nout)
  const float* ow_src = a.out_w + se * H * OUT + o0;
  for (int i = tid; i < H * (nout / 4); i += kThreads) {
    const int c = i / (nout / 4), q = 4 * (i - c * (nout / 4));
    cp_async16(ow_s + c * nout + q, ow_src + static_cast<int64_t>(c) * OUT + q);
  }
  cp_async_commit();

  // (2) while the copies fly: the layer input, this block's symbol column,
  // every cell's gains and state
  const int64_t sym = a.sym[s];
  assert(sym >= 0 && sym < OUT);
  for (int j = tid; j < LI; j += kThreads) {
    li_s[j] = j < IN ? a.aux[static_cast<int64_t>(s) * IN + j]
                     : (j < IN + C ? a.hidden[static_cast<int64_t>(s) * H + (j - IN)] : 1.0f);
  }
  if (tid < nrows) wsym_s[tid] = a.w_sym[(sR + r0 + tid) * OUT + sym];
  for (int r = tid; r < R; r += kThreads) {
    gamma_s[r] = a.gamma[sR + r];
    beta_s[r] = a.beta[sR + r];
  }
  if (tid < C) cell_s[tid] = a.cell[static_cast<int64_t>(s) * C + tid];

  cp_async_wait<1>();  // the rows of w_in; out_w's columns may still fly
  __syncthreads();

  // (3) this block's gate rows: f = w_sym[sym] + tree(w_in * li), a warp a row
  for (int rl = warp; rl < nrows; rl += kWarps) {
    const float* row = rows_s + shift + rl * LI;
    float v[kMaxInput / 32];
#pragma unroll
    for (int k = 0; k < kMaxInput / 32; ++k) {
      const int j = lane + 32 * k;
      v[k] = j < LI ? fmul(row[j], li_s[j]) : 0.0f;
    }
    const float dot = warp_tree(v, P_in);
    if (lane == 0) f_s[rl] = fadd(wsym_s[rl], dot);
  }
  cluster.sync();

  // (4) every gate value of the stream, from the blocks that hold them.
  // Meanwhile the last thread of rank 0, idle until (7), counts this
  // cluster done with the epoch: every block of it has read the epoch
  // before the barrier above. The launch's last cluster advances it.
  if (rank == 0 && tid == kThreads - 1) {
    if (atomicAdd(a.done, 1) == static_cast<int>(a.S) - 1) {
      *a.done = 0;
      *a.epoch = (e + 1) % Hz;
    }
  }
  for (int r = tid; r < R; r += kThreads) {
    const int owner = r / rpb;
    f_all[r] = *cluster.map_shared_rank(f_s + (r - owner * rpb), owner);
  }
  __syncthreads();

  // (5) each gate's layer norm over the cells: 1 / sqrt(tree(f * f) / C + 1e-5)
  if (warp < 3) {
    float v[kMaxHidden / 32];
#pragma unroll
    for (int k = 0; k < kMaxHidden / 32; ++k) {
      const int c = lane + 32 * k;
      const float f = c < C ? f_all[warp * C + c] : 0.0f;
      v[k] = c < C ? fmul(f, f) : 0.0f;
    }
    const float ms = warp_tree(v, P_c);
    if (lane == 0) ivar_s[warp] = fdiv(1.0f, sqrt_det(fadd(fdiv(ms, static_cast<float>(C)), kNormEps)));
  }
  __syncthreads();

  // (6) the cells: gates, cell state and hidden vector in every block; rank
  // 0 writes the epoch's records and the new state
  const bool writes = rank == 0;
  if (tid < C) {
    const int c = tid;
    float nrm[3], pre[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      nrm[g] = fmul(f_all[g * C + c], ivar_s[g]);
      pre[g] = fadd(fmul(nrm[g], gamma_s[g * C + c]), beta_s[g * C + c]);
    }
    const float forget = logistic(pre[0]), innode = tanh_det(pre[1]), outg = logistic(pre[2]);
    const float in_gate = fsub(1.0f, forget);  // CIFG
    const float last = cell_s[c];
    const float cell = fadd(fmul(last, forget), fmul(innode, in_gate));
    const float tanh_c = tanh_det(cell);
    const float h = fmul(outg, tanh_c);
    hid_s[c] = h;
    if (writes) {
      const float gates[3] = {forget, innode, outg};
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const int64_t at = ((static_cast<int64_t>(s) * 3 + g) * Hz + e) * C + c;  // (S, 3, Hz, C)
        a.norm[at] = nrm[g];
        a.gate_state[at] = gates[g];
      }
      a.tanh_state[se * C + c] = tanh_c;
      a.in_gate[se * C + c] = in_gate;
      a.last_state[se * C + c] = last;
      a.cell[static_cast<int64_t>(s) * C + c] = cell;
      a.hidden[static_cast<int64_t>(s) * H + c] = h;
    }
  }
  if (tid == C) {
    hid_s[C] = 1.0f;  // the bias lane
    if (writes) a.hidden[static_cast<int64_t>(s) * H + C] = 1.0f;
  }
  if (writes) {
    if (tid < 3) a.ivar[(static_cast<int64_t>(s) * 3 + tid) * Hz + e] = ivar_s[tid];
    for (int j = tid; j < LI; j += kThreads) a.layer_input[se * LI + j] = li_s[j];
  }
  cp_async_wait<0>();
  __syncthreads();

  // (7) this block's logits: tree over the C+1 hidden lanes, in one thread
  // an output (its first level, lanes c and c + 32, as the products come),
  // written into rank 0's shared memory
  if (tid < nout) {
    constexpr int kHalf = kMaxHidden / 2;
    float v[kHalf];
#pragma unroll
    for (int k = 0; k < kHalf; ++k) {
      const float lo = k < H ? fmul(ow_s[k * nout + tid], hid_s[k]) : 0.0f;
      const float hi = k + kHalf < H ? fmul(ow_s[(k + kHalf) * nout + tid], hid_s[k + kHalf]) : 0.0f;
      v[k] = P_h == kMaxHidden ? fadd(lo, hi) : lo;
    }
    *cluster.map_shared_rank(lg_all + o0 + tid, 0) = thread_tree(v, min(P_h, kHalf));
  }
  cluster.sync();  // every block's logits are in rank 0, which alone goes on
  if (!writes) return;

  // (8) rank 0: softmax with the max clamped at 0, its tree sum, the
  // division and the first largest probability
  const bool on = tid < OUT;
  const float l = on ? lg_all[tid] : -INFINITY;
  float m = l;
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if (lane == 0) red_v[warp] = m;
  __syncthreads();
  m = red_v[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_v[w]);
  const float maxv = fmaxf(m, 0.0f);
  const float p = on ? exp_det(fsub(l, maxv)) : 0.0f;
  if (tid < P_out) p_s[tid] = p;
  __syncthreads();
  if (warp == 0) {
    float v[kMaxOut / 32];
#pragma unroll
    for (int k = 0; k < kMaxOut / 32; ++k) {
      const int o = lane + 32 * k;
      v[k] = o < P_out ? p_s[o] : 0.0f;
    }
    const float sum = warp_tree(v, P_out);
    if (lane == 0) sum_s = sum;
  }
  __syncthreads();
  const float prob = on ? fdiv(p, sum_s) : -INFINITY;
  if (on) {
    a.probs[static_cast<int64_t>(s) * OUT + tid] = prob;
    a.outputs[se * OUT + tid] = prob;
  }
  float bv = prob;
  int bi = on ? tid : INT_MAX;
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, bv, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) {
      if (red_v[w] > bv || (red_v[w] == bv && red_i[w] < bi)) {
        bv = red_v[w];
        bi = red_i[w];
      }
    }
    a.ctx[static_cast<int64_t>(s) * a.n_ctx + a.ctx_slot] = bi;
    a.top[s] = 255;
    a.bot[s] = 0;
    int32_t* regs = a.regs + static_cast<int64_t>(s) * 4;
    regs[0] = 255;
    regs[1] = 0;
    regs[2] = a.mid[s];
    regs[3] = 0;
  }
}

__global__ void __launch_bounds__(kPerceiveThreads) lstm_perceive_kernel(const __grid_constant__ GmixLstmPerceiveArgs a) {
  const int s = blockIdx.y;
  const int C = static_cast<int>(a.C), Hz = static_cast<int>(a.Hz), OUT = static_cast<int>(a.OUT), H = C + 1;
  const int e_cur = *a.epoch, last_e = (e_cur + Hz - 1) % Hz;
  const int64_t sym = a.inp[s * a.inp_stride];
  if (a.record && blockIdx.x == 0 && threadIdx.x == 0)
    a.in_hist[static_cast<int64_t>(s) * Hz + last_e] = static_cast<int32_t>(sym);
  const int q = blockIdx.x * kPerceiveThreads + threadIdx.x;  // 4 weights of the (C+1, OUT) slab
  if (q >= H * OUT / 4) return;
  const int c = 4 * q / OUT, o = 4 * q - c * OUT;
  const int64_t slab = static_cast<int64_t>(H) * OUT;
  const float4 w = reinterpret_cast<const float4*>(a.out_w + (static_cast<int64_t>(s) * Hz + last_e) * slab)[q];
  const float4 y = *reinterpret_cast<const float4*>(a.outputs + (static_cast<int64_t>(s) * Hz + last_e) * OUT + o);
  const float hl = fmul(a.hidden[static_cast<int64_t>(s) * H + c], a.lr);
  float4 out;
  out.x = fsub(w.x, fmul(hl, fsub(y.x, o == sym ? 1.0f : 0.0f)));
  out.y = fsub(w.y, fmul(hl, fsub(y.y, o + 1 == sym ? 1.0f : 0.0f)));
  out.z = fsub(w.z, fmul(hl, fsub(y.z, o + 2 == sym ? 1.0f : 0.0f)));
  out.w = fsub(w.w, fmul(hl, fsub(y.w, o + 3 == sym ? 1.0f : 0.0f)));
  reinterpret_cast<float4*>(a.out_w + (static_cast<int64_t>(s) * Hz + e_cur) * slab)[q] = out;
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

bool shapes_ok(int64_t S, int64_t C, int64_t Hz, int64_t OUT) {
  return S >= 0 && S <= 65535 && C >= 1 && C + 1 <= kMaxHidden && Hz >= 1 && OUT >= 4 && OUT <= kMaxOut &&
         OUT % 4 == 0;
}

// The forward kernel's dynamic shared-memory limit is an attribute of the
// current device's context: raised once per device, before the first launch
// on it (or before a CUDA graph capture records one: the capture only
// records).
int raise_smem_limit() {
  constexpr int kMaxDevices = 64;
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[dev]) {
    rc = cudaFuncSetAttribute(lstm_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    raised[dev] = true;
  }
  return 0;
}

}  // namespace

extern "C" {

// Both entry points launch on `stream` (a cudaStream_t), do not synchronise,
// and return the launch's cudaError_t (0 on success).

// One cluster of `cluster` blocks a stream (1, 2, 4 or 8).
int gmix_lstm_forward(const GmixLstmForwardArgs* a, void* stream) {
  const int64_t K = a->cluster;
  if (!shapes_ok(a->S, a->C, a->Hz, a->OUT) || a->IN < 1 || a->IN + a->C + 1 > kMaxInput || a->n_ctx < 1 ||
      a->ctx_slot < 0 || a->ctx_slot >= a->n_ctx || K < 1 || K > kMaxCluster || (K & (K - 1)) != 0 ||
      a->S * K > INT32_MAX)
    return invalid();
  const int64_t smem = forward_smem(a->C, a->IN, a->OUT, K);
  if (smem > kMaxDynamicSmem) return invalid();
  if (a->S == 0) return 0;
  if (int rc = raise_smem_limit()) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(a->S * K));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(K);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, lstm_forward_kernel, *a);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

int gmix_lstm_perceive(const GmixLstmPerceiveArgs* a, void* stream) {
  if (!shapes_ok(a->S, a->C, a->Hz, a->OUT)) return invalid();
  if (a->S == 0) return 0;
  const int64_t n4 = (a->C + 1) * a->OUT / 4;
  const dim3 grid(static_cast<unsigned int>((n4 + kPerceiveThreads - 1) / kPerceiveThreads),
                  static_cast<unsigned int>(a->S));
  lstm_perceive_kernel<<<grid, kPerceiveThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// Load both kernels on the current device and raise the forward kernel's
// shared-memory limit there (what their first launch does), so that a CUDA
// graph capture, which records launches only, finds them ready. Launches
// nothing.
int gmix_lstm_prepare(void) {
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, lstm_perceive_kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return raise_smem_limit();
}

}  // extern "C"
