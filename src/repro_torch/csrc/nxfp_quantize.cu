// Host entry of the NxFP block quantizer (kernels: nxfp_quantize_kernels.cuh,
// whose note says what the kernel replaces, what bounds it and how).
//
// The wrapper (kernels/nxfp_quantize.py) passes the format's candidate list
// as core/quantize.candidates gives it. This file checks it against the
// compile-time element constants, reduces it to an instance (code width,
// block size, MX element, kind) and a runtime descriptor, and launches the
// regime the wrapper planned. A list no instance encodes is refused.
#include <cuda_runtime.h>

#include "nxfp_quantize.cuh"

namespace {

using nxfpq::kMaxCands;

struct CandDesc {
  int fmt_bit;
  int is_bfp;
  int mbits;
  int bias;
  int emax;
  int nano_mode;  // -1: nano 0, -2: Alg.-1 rounded nano, 0..3: that code
  float max_pos;
};

struct CandList {
  int cr;
  int asym;
  int ox;
  int n_cands;
  CandDesc c[kMaxCands];
  int table;  // the table-driven encoder's rules (quantize_blocks)
  float cr_lo[2], cr_hi[2], cr_val[2];  // CR: its window and value per fmt bit
};

bool matches(const CandDesc& cd, int bits, int ebits) {
  const nxfpq::ElemC e = nxfpq::elem_consts(bits, ebits);
  return cd.is_bfp == e.bfp && cd.mbits == e.mb && cd.bias == e.bias &&
         cd.emax == e.emax && cd.max_pos == e.max_pos;
}

// The candidate list as (has_bfp, has_mx, nm, MX exponent width, kind);
// false if no instance encodes it. core/quantize.candidates lists, for
// the BFP element (fmt_bit 0) and then the MX one (fmt_bit 1), the nano
// modes {0}, {rounded, 0} or {0, 1, 2, 3}.
bool reduce(const CandList& cl, int bits, nxfpq::Fmt& f, int& mxe,
            int& kind) {
  static const int kModes[3][4] = {{-1}, {-2, -1}, {0, 1, 2, 3}};
  static const int kCount[3] = {1, 2, 4};
  static const int kDefaultMxe[9] = {0, 0, 1, 2, 2, 2, 2, 2, 4};
  if (bits < 2 || bits > 8 || cl.n_cands < 1 || cl.n_cands > kMaxCands)
    return false;
  const int m0 = cl.c[0].nano_mode;
  f.nm = m0 == -1 ? 0 : m0 == -2 ? 1 : m0 == 0 ? 2 : -1;
  if (f.nm < 0 || cl.n_cands % kCount[f.nm]) return false;
  const int per = kCount[f.nm], n_elems = cl.n_cands / per;
  if (n_elems > 2) return false;
  f.has_bfp = f.has_mx = 0;
  mxe = kDefaultMxe[bits];
  for (int e = 0; e < n_elems; ++e) {
    const CandDesc& first = cl.c[e * per];
    const int ebits = first.is_bfp ? 0 : bits - 1 - first.mbits;
    if (first.fmt_bit != (first.is_bfp ? 0 : 1)) return false;
    if (e == 1 && !(f.has_bfp && !first.is_bfp)) return false;
    for (int k = 0; k < per; ++k) {
      const CandDesc& cd = cl.c[e * per + k];
      if (cd.fmt_bit != first.fmt_bit || cd.nano_mode != kModes[f.nm][k] ||
          !matches(cd, bits, ebits))
        return false;
    }
    if (first.is_bfp) {
      f.has_bfp = 1;
    } else {
      f.has_mx = 1;
      mxe = ebits;
    }
  }
  if ((cl.cr || cl.table) && (cl.asym || cl.ox)) return false;
  f.asym = cl.asym;
  for (int b = 0; b < 2; ++b) {
    f.cr_lo[b] = cl.cr_lo[b];
    f.cr_hi[b] = cl.cr_hi[b];
    f.cr_val[b] = cl.cr_val[b];
  }
  kind = cl.ox      ? nxfpq::KIND_OX
         : cl.asym  ? nxfpq::KIND_ASYM
         : cl.table ? (cl.cr ? nxfpq::KIND_CRT : nxfpq::KIND_TAB)
         : cl.cr    ? nxfpq::KIND_CR
                    : nxfpq::KIND_SYM;
  return true;
}

}  // namespace

// job: nxfpq::Job; cands: CandList. regime, per_cta, grid: the plan of
// kernels/nxfp_quantize.py:quantize_plan. Returns a cudaError_t.
extern "C" int nxfp_quantize_launch(const void* job_desc, int bits,
                                    int block_size, const void* cands,
                                    int regime, int per_cta, long long grid,
                                    void* stream) {
  const nxfpq::Job job = *reinterpret_cast<const nxfpq::Job*>(job_desc);
  const CandList cl = *reinterpret_cast<const CandList*>(cands);
  nxfpq::Fmt f;
  int mxe, kind;
  if (!reduce(cl, bits, f, mxe, kind)) return (int)cudaErrorInvalidValue;
  const long long n_total = job.n_per * job.n_tensors;
  if (n_total == 0) return 0;
  // blocks are counted in 32 bits on the card; the plan covers them once
  if (n_total >= (1LL << 31) || per_cta < 1 ||
      grid != (n_total + per_cta - 1) / per_cta || job.n_tensors < 1 ||
      job.n_tensors > 2)
    return (int)cudaErrorInvalidValue;
  auto st = reinterpret_cast<cudaStream_t>(stream);
#define NXFPQ_CASE(B, S, M, K)                                             \
  if (bits == B && block_size == S && mxe == M && kind == K)               \
    return (int)nxfpq::launch<B, S, M, K>(job, f, regime, per_cta,         \
                                          (unsigned)grid, st);
  NXFPQ_INSTANCES_4(NXFPQ_CASE)
  NXFPQ_INSTANCES_5(NXFPQ_CASE)
  NXFPQ_INSTANCES_6(NXFPQ_CASE)
  NXFPQ_INSTANCES_8(NXFPQ_CASE)
  NXFPQ_INSTANCES_3(NXFPQ_CASE)
  NXFPQ_INSTANCES_27(NXFPQ_CASE)
  NXFPQ_INSTANCES_BS8(NXFPQ_CASE)
  NXFPQ_INSTANCES_BS64(NXFPQ_CASE)
  NXFPQ_INSTANCES_BS128(NXFPQ_CASE)
  NXFPQ_INSTANCES_CRT(NXFPQ_CASE)
  NXFPQ_INSTANCES_TAB(NXFPQ_CASE)
  NXFPQ_INSTANCES_TABW(NXFPQ_CASE)
  NXFPQ_INSTANCES_TAB237(NXFPQ_CASE)
#undef NXFPQ_CASE
  return (int)cudaErrorInvalidValue;
}
