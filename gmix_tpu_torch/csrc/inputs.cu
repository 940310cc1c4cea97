// The byte step's inputs up to the grouped gather, for Hopper (sm_90a)
// (core/inputs.py):
//
//   inputs_pack_kernel: after the contexts, the PPM prediction, the LSTM's
//                       forward pass and the match pointers, for every
//                       stream: the arenas' row indices (int32) that the
//                       grouped gather and the byte end's scatter take, the
//                       indirect models' lane rotation, the dense mixer rows
//                       (the ctx-dense rows by one-hot select, with their
//                       one-hot masks, the pos-dense blocks and the
//                       longest-match tables), and the packed per-stream
//                       inputs of the fused kernel: `sc`, `coder`, `win_r`
//                       (the decoder's code window), `ppm_regs` and, in a
//                       sampling step, `sample_u` transposed
//
// Replaces no TPU kernel: gmix_tpu computes all of it in plain jnp outside
// any pallas_call (gmix_tpu/core/step.py, the gathers and the fused branch of
// `_byte_step`). Its plain version, core/inputs.py `inputs_plain`, is ~70
// small torch ops a byte step, each a node of the step's CUDA graph at about
// 1.5 us for a few hundred bytes.
//
// What bounds it on this card: latency alone. A stream reads ~60 context
// slots, 39 dense rows of 512 bytes and a few registers, and writes as much:
// ~40 KB a stream, at 54 streams 2.2 MB, 0.7 us at 3.35 TB/s. So the kernel is
// one launch in which every thread does one task with one or two dependent
// loads: blocks of 256 threads, as many blocks a stream as its tasks need
// (grid y: the stream), so that one stream's ~1 400 tasks spread over ~6
// blocks and 54 streams over ~320 blocks, all resident at once. A dense row
// moves as 16-byte loads and stores, one a thread. Each task is either an
// index (one context slot read), a one-hot mask (one slot read, T bytes
// written), a 16-byte quarter-lane group of a dense row, or one lane of the
// small packed rows.
//
// Exactness (the decoder replays these values; the kernel equals the plain
// version bit for bit, tests/test_torch_kernels.py): indices and registers
// are integer work, the plain version's arithmetic in int64; dense rows are
// moved as bits. The ctx-dense rows follow the plain version's one-hot float
// sum: a table of T > 1 rows reads +0.0 where the selected value is +-0.0 or
// a denormal (|x| < FLT_MIN, tested on the bits, so no flush mode matters),
// and keeps every other value; a table of one row keeps every bit.

#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

// The kernel's arguments, as the Python wrapper fills them (core/inputs.py
// inputs_kernel). `consts` is the plan's table, laid out as core/inputs.py
// `inputs_table` writes it. A pointer of a part the spec does not have may
// be null.
struct GmixInputsArgs {
  const int64_t* t;         // () the byte index
  const int64_t* col;       // () the byte's column of `data`
  const int64_t* ctx;       // (S, n_ctx) u32 context values
  const float* dense;       // (S, D, WP) the dense mixer arena
  const uint8_t* data;      // (S, n_data) the input bytes
  const uint8_t* code;      // (S, cap) the decoder's code stream
  const int64_t* last_byte; // (S,)
  const int64_t* recent;    // (S, R)
  const int64_t* acc;       // (S,)
  const int64_t* bits_seen; // (S,)
  const int64_t* new_bit;   // (S,)
  const int64_t* x1;        // (S,) coder registers
  const int64_t* x2;
  const int64_t* x;
  const int64_t* wpos;
  const int64_t* rpos;
  const int32_t* ppm_top;   // (S,) the PPM head's interval registers
  const int32_t* ppm_bot;
  const int32_t* ppm_mid;
  const float* sample_u;    // (8, S) a sampling step's uniforms
  const int64_t* consts;    // inputs_table
  int32_t* blk_ix;          // (S, M) out: row indices
  int32_t* rowix_st;        // (S, Kst)
  int32_t* posix;           // (S, Kp)
  int32_t* apm_ix;          // (S, NA)
  int32_t* ppm_ix;          // (S, NO)
  int64_t* ppm_cv;          // (S, NO) out: the PPM orders' context values
  int64_t* ind_rot;         // (S, M) out: the lane rotation
  float* rows_cd;           // (S, Kcd, WP) out: the ctx-dense rows
  bool* cd_oh;              // (S, Tcd) out: their one-hot masks
  float* blocks_pd;         // (S, NPD, WP) out: the pos-dense blocks
  float* lm_tbl;            // (S, NLM, WP) out: the longest-match tables
  int64_t* sc;              // (S, 8) out: the packed per-stream inputs
  int64_t* coder;           // (S, 8)
  int64_t* win_r;           // (S, kWinPad)
  int32_t* ppm_regs;        // (S, 4)
  float* sample_out;        // (S, 8)
  int64_t S, n_ctx, D, WP, R, n_data, cap, M, Kst, Kp, NA, NO, Kcd, Tcd, NPD, NLM, decode, sample, regs;
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 65535;  // a stream's blocks (grid x)
constexpr int kCoderWin = 40;      // core/fused.py CODER_WIN
constexpr int kWinPad = 64;        // core/fused.py WIN_PAD
constexpr int kIndex = 3;          // the table's entries per index: (slot, mask, offset)
constexpr int kDense = 4;          // per ctx-dense table: (slot, rows T, arena row, mask offset)
constexpr uint32_t kAbs = 0x7FFFFFFFu, kMinNormal = 0x00800000u;  // FLT_MIN's bits

// The small packed rows' lanes, in task order: sc, coder, win_r, ppm_regs, sample_u
constexpr int kSmall = 8 + 8 + kWinPad;

__device__ __forceinline__ uint32_t flushed(uint32_t b) { return (b & kAbs) < kMinNormal ? 0u : b; }

__global__ void __launch_bounds__(kThreads) inputs_pack_kernel(const __grid_constant__ GmixInputsArgs a) {
  const int64_t s = blockIdx.y;
  int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t* ctx = a.ctx + s * a.n_ctx;

  // row indices: (ctx[slot] & mask) + offset, per class in the table's order
  const int64_t nix = a.M + a.Kst + a.Kp + a.NA + a.NO;
  if (j < nix) {
    const int64_t* c = a.consts + kIndex * j;
    const int64_t v = ctx[c[0]];
    const int32_t ix = static_cast<int32_t>((v & c[1]) + c[2]);
    if (j < a.M) {
      a.blk_ix[s * a.M + j] = ix;
      a.ind_rot[s * a.M + j] = ((v >> 16) & 255) * a.consts[kIndex * nix + j];
      return;
    }
    j -= a.M;
    if (j < a.Kst) {
      a.rowix_st[s * a.Kst + j] = ix;
      return;
    }
    j -= a.Kst;
    if (j < a.Kp) {
      a.posix[s * a.Kp + j] = ix;
      return;
    }
    j -= a.Kp;
    if (j < a.NA) {
      a.apm_ix[s * a.NA + j] = ix;
      return;
    }
    j -= a.NA;
    a.ppm_ix[s * a.NO + j] = ix;
    a.ppm_cv[s * a.NO + j] = v;
    return;
  }
  j -= nix;
  const int64_t* dense_tab = a.consts + kIndex * nix + a.M;
  const int64_t* copy_rows = dense_tab + kDense * a.Kcd;

  // the ctx-dense tables' one-hot masks
  if (j < a.Kcd) {
    const int64_t* c = dense_tab + kDense * j;
    const int64_t T = c[1], val = ctx[c[0]] & (T - 1);
    bool* oh = a.cd_oh + s * a.Tcd + c[3];
    for (int64_t k = 0; k < T; ++k) oh[k] = k == val;
    return;
  }
  j -= a.Kcd;

  // the dense rows, 16 bytes a task: ctx-dense by one-hot select, then the
  // pos-dense blocks and the longest-match tables as copies
  const int64_t quads = a.WP / 4, nrows = a.Kcd + a.NPD + a.NLM;
  if (j < nrows * quads) {
    const int64_t r = j / quads, q = j - r * quads;
    int64_t src;
    bool flush = false;
    uint4* dst;
    if (r < a.Kcd) {
      const int64_t* c = dense_tab + kDense * r;
      const int64_t T = c[1];
      src = c[2] + (ctx[c[0]] & (T - 1));
      flush = T > 1;
      dst = reinterpret_cast<uint4*>(a.rows_cd + (s * a.Kcd + r) * a.WP) + q;
    } else if (r < a.Kcd + a.NPD) {
      src = copy_rows[r - a.Kcd];
      dst = reinterpret_cast<uint4*>(a.blocks_pd + (s * a.NPD + r - a.Kcd) * a.WP) + q;
    } else {
      src = copy_rows[r - a.Kcd];
      dst = reinterpret_cast<uint4*>(a.lm_tbl + (s * a.NLM + r - a.Kcd - a.NPD) * a.WP) + q;
    }
    assert(src >= 0 && src < a.D);
    uint4 w = reinterpret_cast<const uint4*>(a.dense + (s * a.D + src) * a.WP)[q];
    if (flush) w = make_uint4(flushed(w.x), flushed(w.y), flushed(w.z), flushed(w.w));
    *dst = w;
    return;
  }
  j -= nrows * quads;

  // sc: the data byte, last byte, recent[1], decode, not first, sample, 0, 0
  if (j < 8) {
    int64_t v = 0;
    switch (j) {
      case 0: {
        const int64_t col = *a.col;
        assert(col >= 0 && col < a.n_data);
        v = a.data[s * a.n_data + col];
        break;
      }
      case 1: v = a.last_byte[s]; break;
      case 2: v = a.recent[s * a.R + 1]; break;
      case 3: v = a.decode; break;
      case 4: v = *a.t > 0; break;
      case 5: v = a.sample; break;
    }
    a.sc[s * 8 + j] = v;
    return;
  }
  j -= 8;
  // coder: x1, x2, x, wpos, rpos, acc, bits_seen, new_bit
  if (j < 8) {
    const int64_t* from = a.x1;
    switch (j) {
      case 1: from = a.x2; break;
      case 2: from = a.x; break;
      case 3: from = a.wpos; break;
      case 4: from = a.rpos; break;
      case 5: from = a.acc; break;
      case 6: from = a.bits_seen; break;
      case 7: from = a.new_bit; break;
    }
    a.coder[s * 8 + j] = from[s];
    return;
  }
  j -= 8;
  // win_r: the decoder's next code bytes, 0 past the stream's end, the
  // padding and in encode
  if (j < kWinPad) {
    int64_t v = 0;
    if (a.decode && j < kCoderWin) {
      const int64_t look = a.rpos[s] + j;
      if (look < a.cap) v = a.code[s * a.cap + look];
    }
    a.win_r[s * kWinPad + j] = v;
    return;
  }
  j -= kWinPad;
  // the PPM head's registers: top, bot, mid, 0
  if (a.regs) {
    if (j < 4) {
      a.ppm_regs[s * 4 + j] = j == 0 ? a.ppm_top[s] : j == 1 ? a.ppm_bot[s] : j == 2 ? a.ppm_mid[s] : 0;
      return;
    }
    j -= 4;
  }
  // a sampling step's uniforms, (8, S) -> (S, 8)
  if (a.sample && j < 8) a.sample_out[s * 8 + j] = a.sample_u[j * a.S + s];
}

int64_t tasks(const GmixInputsArgs* a) {
  return a->M + a->Kst + a->Kp + a->NA + a->NO + a->Kcd + (a->Kcd + a->NPD + a->NLM) * (a->WP / 4) + kSmall +
         (a->regs ? 4 : 0) + (a->sample ? 8 : 0);
}

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t), does not synchronise, and returns
// the launch's cudaError_t (0 on success).
int gmix_inputs_pack(const GmixInputsArgs* a, void* stream) {
  const int64_t dense_rows = a->Kcd + a->NPD + a->NLM;
  if (a->S < 0 || a->S > 65535 || a->n_ctx < 1 || a->R < 2 || a->n_data < 1 || a->WP < 4 || a->WP % 4 != 0 ||
      (dense_rows > 0 && a->D < 1) || (a->decode && a->cap < 1) || a->M < 0 || a->Kst < 0 || a->Kp < 0 ||
      a->NA < 0 || a->NO < 0 || a->Kcd < 0 || a->Tcd < a->Kcd || a->NPD < 0 || a->NLM < 0)
    return invalid();
  if (a->S == 0) return 0;
  const int64_t blocks = (tasks(a) + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) return invalid();
  const dim3 grid(static_cast<unsigned int>(blocks), static_cast<unsigned int>(a->S));
  inputs_pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// Load the kernel on the current device (what its first launch does), so
// that a CUDA graph capture, which records launches only, finds it loaded.
// Launches nothing.
int gmix_inputs_prepare(void) {
  cudaFuncAttributes attr;
  return static_cast<int>(cudaFuncGetAttributes(&attr, inputs_pack_kernel));
}

}  // extern "C"
