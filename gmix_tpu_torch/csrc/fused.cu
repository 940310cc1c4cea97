// The C interface of the fused sub-step kernel (fused_kernel.cuh): checks
// the sizes, picks the instantiation and launches it.
#include "fused_kernel.cuh"

namespace {

using namespace gmix;

// Check the sizes and choose the instantiation: Q lane groups, and the
// byte's tables in shared memory when they fit beside the working rows.
// Returns 0 or cudaErrorInvalidValue.
int plan_fused(const FusedDims* hd, Dims* out, bool* tables, size_t* smem_bytes) {
  Dims d;
  d.S = static_cast<int>(hd->S); d.M = static_cast<int>(hd->M); d.NM = static_cast<int>(hd->NM);
  d.n0 = static_cast<int>(hd->n0); d.n1 = static_cast<int>(hd->n1); d.WP = static_cast<int>(hd->WP);
  d.SL = static_cast<int>(hd->SL); d.n_pred = static_cast<int>(hd->n_pred); d.pl0 = static_cast<int>(hd->pl0);
  d.pl12 = static_cast<int>(hd->pl12); d.nskip = static_cast<int>(hd->nskip); d.Kst = static_cast<int>(hd->Kst);
  d.Kp = static_cast<int>(hd->Kp); d.Kcd = static_cast<int>(hd->Kcd); d.Kpd = static_cast<int>(hd->Kpd);
  d.Klm = static_cast<int>(hd->Klm); d.Tlm = static_cast<int>(hd->Tlm); d.NA = static_cast<int>(hd->NA);
  d.ppm = hd->ppm ? 1 : 0; d.lstm = hd->lstm ? 1 : 0; d.nc = static_cast<int>(hd->nc);
  d.learn = hd->learn ? 1 : 0; d.analysis = hd->analysis ? 1 : 0; d.sample = hd->sample ? 1 : 0;
  d.K = d.n0 + d.n1 + 1;
  d.nmax = d.n0 > d.n1 ? d.n0 : d.n1;
  if (d.nmax < 1) d.nmax = 1;
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (d.S < 0 || d.M < 0 || d.NM < 0 || d.n0 < 0 || d.n1 < 0 || d.NA < 0) return invalid;
  if (d.WP <= 0 || d.WP % 32 != 0 || d.WP > 32 * kMaxQ || d.nmax > 32 * kMaxQ) return invalid;
  if (d.SL < 0 || d.SL >= d.WP || d.n_pred + d.n0 > d.WP || d.n0 + d.n1 + d.nskip > d.WP) return invalid;
  if (d.pl0 >= 0 && (d.pl0 + 8 > d.WP || d.pl12 < 0 || d.pl12 + 8 > d.WP)) return invalid;
  if (d.Kst + d.Kp + d.Kcd + d.Kpd + d.Klm != d.K) return invalid;
  if (d.ppm + d.lstm + 2 * d.M + d.NM != d.n_pred) return invalid;
  if (d.analysis && d.nc != d.n_pred + d.n0 + d.n1 + 1) return invalid;
  if (d.sample && d.learn) return invalid;  // sampling runs with learn off
  d.P = pow2_ceil(d.WP);
  d.r0 = solve_rounds(d.n0);
  d.r1 = solve_rounds(d.n1);
  d.ld0 = solve_ld(d.n0);
  d.ld1 = solve_ld(d.n1);
  *tables = static_cast<size_t>(smem_layout(d, true).total) * 4 <= static_cast<size_t>(kMaxSmem);
  *smem_bytes = static_cast<size_t>(smem_layout(d, *tables).total) * 4;
  if (*smem_bytes > static_cast<size_t>(kMaxSmem)) return invalid;
  *out = d;
  return 0;
}

template <bool kTables>
int launch_q(const Dims& d, const FusedIO& io, size_t bytes, bool clocks, cudaStream_t st) {
  switch (d.P / 32) {
    case 1: return launch_fused_variant<1, kTables>(d, io, bytes, clocks, st);
    case 2: return launch_fused_variant<2, kTables>(d, io, bytes, clocks, st);
    case 4: return launch_fused_variant<4, kTables>(d, io, bytes, clocks, st);
    case 8: return launch_fused_variant<8, kTables>(d, io, bytes, clocks, st);
    case 16: return launch_fused_variant<16, kTables>(d, io, bytes, clocks, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kTables>
int prepare_q(const Dims& d) {
  switch (d.P / 32) {
    case 1: return prepare_fused_variant<1, kTables>();
    case 2: return prepare_fused_variant<2, kTables>();
    case 4: return prepare_fused_variant<4, kTables>();
    case 8: return prepare_fused_variant<8, kTables>();
    case 16: return prepare_fused_variant<16, kTables>();
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_fused(const FusedDims* hd, const FusedIO* io, void* stream, bool clocks) {
  Dims d;
  bool tables;
  size_t bytes;
  if (int rc = plan_fused(hd, &d, &tables, &bytes)) return rc;
  if (clocks && io->out_clocks == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (d.S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tables ? launch_q<true>(d, *io, bytes, clocks, st) : launch_q<false>(d, *io, bytes, clocks, st);
}

}  // namespace

extern "C" {

// Both launch on `stream` (a cudaStream_t), do not synchronise, and return
// the launch's cudaError_t (0 on success). Sizes the kernel does not take
// return cudaErrorInvalidValue.
int gmix_fused_substeps(const FusedDims* hd, const FusedIO* io, void* stream) {
  return launch_fused(hd, io, stream, false);
}

// the same kernel with thread 0 of every block storing clock64() at every
// stage boundary into io->out_clocks; for measurement only
int gmix_fused_substeps_clocks(const FusedDims* hd, const FusedIO* io, void* stream) {
  return launch_fused(hd, io, stream, true);
}

// Which instantiation a launch with these sizes takes: out[0] = Q (32-lane
// groups of a mixer row), out[1] = 1 when the byte's look-up tables go to
// shared memory, out[2] = the block's dynamic shared memory in bytes.
// Launches nothing.
int gmix_fused_substeps_plan(const FusedDims* hd, int64_t* out) {
  Dims d;
  bool tables;
  size_t bytes;
  if (int rc = plan_fused(hd, &d, &tables, &bytes)) return rc;
  out[0] = d.P / 32;
  out[1] = tables ? 1 : 0;
  out[2] = static_cast<int64_t>(bytes);
  return 0;
}

// What the first launch with these sizes on the current device does before
// it launches: raise the chosen instantiation's dynamic shared-memory limit.
// A CUDA graph capture records launches and runs none, so the codec calls
// this before it captures. Launches nothing.
int gmix_fused_substeps_prepare(const FusedDims* hd) {
  Dims d;
  bool tables;
  size_t bytes;
  if (int rc = plan_fused(hd, &d, &tables, &bytes)) return rc;
  return tables ? prepare_q<true>(d) : prepare_q<false>(d);
}

}  // extern "C"
