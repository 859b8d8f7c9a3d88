// NxFP block quantizer: what a launch encodes, the element-format constants
// bound at compile time, and the list of kernel instances.
//
// Shared by the host entry (nxfp_quantize.cu, which checks the Python
// candidate list and picks an instance) and the instance files
// (nxfp_quantize_b{4,5,6,8}.cu, which compile the kernels of
// nxfp_quantize_kernels.cuh for one code width each, in parallel).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace nxfpq {

constexpr int kMaxCands = 8;  // candidates of a format at most

// One launch: n_tensors tensors (1, or 2 for K and V) of (b, t, kvh, hd)
// rows, bf16 or f32, cut into nb blocks of BS along hd (the last one
// zero-padded), encoded into packed (b, s, kvh, nb, bpb) uint8 and meta
// (cb, s, kvh, nb) at cache rows pos[bb] + tt (pos null: rows from 0) of
// slot slot[bb] (slot null: slot bb); a row outside [0, s), a slot outside
// [0, cb) and a row tt >= n_valid[bb] are not written. With a block table
// (block non-null: the paged cache) slot sl's logical row r lands at row
// r % page of physical page block[sl * tw + r / page] of a (n_pages, page,
// kvh, nb[, bpb]) pool, s = tw * page; a row whose page is the null page 0
// (or lies outside [1, n_pages)) is not written either. A plain (T, BS)
// block array is the case b = T, t = kvh = s = nb = 1, hd = BS.
struct Job {
  const void* src[2];
  void* packed[2];
  void* meta[2];
  const int* pos;
  const int* slot;     // (b,) cache slot of batch row bb; null: slot bb
  const int* n_valid;  // (b,) rows tt >= n_valid[bb] dropped; null: none
  long long n_per;  // blocks per tensor: b * t * kvh * nb
  int n_tensors;
  int in_bf16;
  int b, t, kvh, hd, nb, s;
  int cb;  // the cache's slots (b when slot is null); the table's rows
  const int* block;  // (cb, tw) page table of a paged cache; null: dense
  int page, tw, n_pages;
};

// The candidate list in runtime terms; the element formats themselves are
// template parameters.
struct Fmt {
  int has_bfp;  // fmt_bit 0 candidates (BFP elements)
  int has_mx;   // fmt_bit 1 candidates (the MX element format)
  int nm;       // nano modes per element format: 0 {0}, 1 {rounded, 0},
                // 2 {0, 1, 2, 3} (exhaustive)
  int asym;     // KIND_OX only: per-sign scales (KIND_ASYM always has them)
  // KIND_CRT only, per fmt bit: the recycled value and the window of
  // scaled values (cr_lo, cr_hi] that snaps to it (its midpoints with its
  // neighbouring levels; empty when the value duplicates a level)
  float cr_lo[2], cr_hi[2], cr_val[2];
};

// The format kinds an instance is compiled for: symmetric, symmetric with
// code recycling, asymmetric (AMXFP), outlier mantissa (MX+, asym at run
// time), and the reference's table-driven encoder (core/quantize.py:
// quantize_blocks: a value on a midpoint between two levels takes the lower
// one), with code recycling (the recycled value wherever the format puts
// it: any custom value, or the default under the table's rules) or without
// (BFP, MxFP and the NxFP ablations as the reference's direct_cast_tree and
// fake_quant cast them). CR excludes asym and ox (formats.py).
enum Kind {
  KIND_SYM = 0,
  KIND_CR = 1,
  KIND_ASYM = 2,
  KIND_OX = 3,
  KIND_CRT = 4,
  KIND_TAB = 5
};
// A thread per block over a shared-memory tile, or a warp per block.
enum Regime { REGIME_TILE = 0, REGIME_WARP = 1 };

// Element-format constants, as core/levels.py derives them: EBITS 0 is the
// BFP element int<BITS>, else e<EBITS>m<BITS-1-EBITS> (e4m3 keeps
// S.1111.111 for NaN, so its top mantissa is 6).
struct ElemC {
  int bfp, mb, bias, emin, emax, mmax;
  float max_pos, smallest;
};

__host__ __device__ constexpr float pow2c(int e) {
  float v = 1.0f;
  for (; e > 0; --e) v *= 2.0f;
  for (; e < 0; ++e) v *= 0.5f;
  return v;
}

__host__ __device__ constexpr ElemC elem_consts(int bits, int ebits) {
  if (ebits == 0) {
    const int mmax = (1 << (bits - 1)) - 1;
    return ElemC{1, bits - 1, 0, 1, bits - 2, mmax, (float)mmax, 1.0f};
  }
  const int mb = bits - 1 - ebits;
  const int bias = (1 << (ebits - 1)) - 1;
  const int etop = (1 << ebits) - 1 - bias;
  const int mtop = (ebits == 4 && mb == 3) ? 6 : (1 << mb) - 1;
  return ElemC{0, mb, bias, 1 - bias, etop, 0,
               (1.0f + (float)mtop / (float)(1 << mb)) * pow2c(etop),
               pow2c(1 - bias - mb)};
}

// Encode one launch with the instance (BITS, BS, MXE, KIND): MXE is the
// exponent width of the MX element format (its candidates run only when
// fmt.has_mx). Grid and CTA from the Python plan (kernels/nxfp_quantize.py:
// quantize_plan): CTA c takes blocks [c * per_cta, (c + 1) * per_cta).
template <int BITS, int BS, int MXE, int KIND>
cudaError_t launch(const Job& job, const Fmt& fmt, int regime, int per_cta,
                   unsigned grid, cudaStream_t stream);

// Every instance: code width x block size x MX element x kind. A format
// without an MX element runs on its width's first MXE. The main path's
// instances (4/5/6/8 bits, bs 16/32, kinds 0-3: nxfp_quantize_b{4,5,6,8}.cu)
// are listed apart from the rest, each group in a file of its own so that
// nvcc compiles them in parallel: 3-bit codes (nxfp_quantize_b3.cu), 2- and
// 7-bit codes (nxfp_quantize_b27.cu), bs 8,
// 64 and 128 (nxfp_quantize_bs{8,64,128}.cu), the custom recycle value
// at bs 16/32 (nxfp_quantize_crt.cu) and the table-driven encoder without
// CR (KIND_TAB: nxfp_quantize_tab.cu at bs 16/32, nxfp_quantize_tabw.cu at
// bs 8/64/128, nxfp_quantize_tab237.cu for 2-, 3- and 7-bit codes). ox
// stops at bs 32 (its index is 5 bits).
#define NXFPQ_KINDS(X, B, S, M) X(B, S, M, 0) X(B, S, M, 1) X(B, S, M, 2) \
  X(B, S, M, 3)
#define NXFPQ_SIZES(X, B, M) NXFPQ_KINDS(X, B, 32, M) NXFPQ_KINDS(X, B, 16, M)
#define NXFPQ_INSTANCES_4(X) NXFPQ_SIZES(X, 4, 2)
#define NXFPQ_INSTANCES_5(X) NXFPQ_SIZES(X, 5, 2)
#define NXFPQ_INSTANCES_6(X) NXFPQ_SIZES(X, 6, 2) NXFPQ_SIZES(X, 6, 3)
#define NXFPQ_INSTANCES_8(X) NXFPQ_SIZES(X, 8, 4) NXFPQ_SIZES(X, 8, 5)
// the widths (code width, MX element) of the main path's instances
#define NXFPQ_WIDTHS(Y, A) Y(A, 4, 2) Y(A, 5, 2) Y(A, 6, 2) Y(A, 6, 3) \
  Y(A, 8, 4) Y(A, 8, 5)
#define NXFPQ_ALL_KINDS(X, B, S, M) NXFPQ_KINDS(X, B, S, M) X(B, S, M, 4)
#define NXFPQ_WIDE_KINDS(X, B, S, M) X(B, S, M, 0) X(B, S, M, 1) \
  X(B, S, M, 2) X(B, S, M, 4)
#define NXFPQ_BS8_(X, B, M) NXFPQ_ALL_KINDS(X, B, 8, M)
#define NXFPQ_BS64_(X, B, M) NXFPQ_WIDE_KINDS(X, B, 64, M)
#define NXFPQ_BS128_(X, B, M) NXFPQ_WIDE_KINDS(X, B, 128, M)
#define NXFPQ_CRT_(X, B, M) X(B, 32, M, 4) X(B, 16, M, 4)
#define NXFPQ_INSTANCES_BS8(X) NXFPQ_WIDTHS(NXFPQ_BS8_, X)
#define NXFPQ_INSTANCES_BS64(X) NXFPQ_WIDTHS(NXFPQ_BS64_, X)
#define NXFPQ_INSTANCES_BS128(X) NXFPQ_WIDTHS(NXFPQ_BS128_, X)
#define NXFPQ_INSTANCES_CRT(X) NXFPQ_WIDTHS(NXFPQ_CRT_, X)
#define NXFPQ_INSTANCES_3(X) NXFPQ_ALL_KINDS(X, 3, 8, 2) \
  NXFPQ_ALL_KINDS(X, 3, 16, 2) NXFPQ_ALL_KINDS(X, 3, 32, 2) \
  NXFPQ_WIDE_KINDS(X, 3, 64, 2) NXFPQ_WIDE_KINDS(X, 3, 128, 2)
// 2- and 7-bit codes have a BFP element only (int2, int7): no asym, no ox;
// their MXE (1, 2) is never run
#define NXFPQ_BFP_KINDS(X, B, S, M) X(B, S, M, 0) X(B, S, M, 1) X(B, S, M, 4)
#define NXFPQ_BFP_SIZES(X, B, M) NXFPQ_BFP_KINDS(X, B, 8, M) \
  NXFPQ_BFP_KINDS(X, B, 16, M) NXFPQ_BFP_KINDS(X, B, 32, M) \
  NXFPQ_BFP_KINDS(X, B, 64, M) NXFPQ_BFP_KINDS(X, B, 128, M)
#define NXFPQ_INSTANCES_27(X) NXFPQ_BFP_SIZES(X, 2, 1) NXFPQ_BFP_SIZES(X, 7, 2)
// the table-driven encoder without CR, at every width and block size
#define NXFPQ_TAB_(X, B, M) X(B, 32, M, 5) X(B, 16, M, 5)
#define NXFPQ_TABW_(X, B, M) X(B, 8, M, 5) X(B, 64, M, 5) X(B, 128, M, 5)
#define NXFPQ_TAB_SIZES(X, B, M) X(B, 8, M, 5) X(B, 16, M, 5) \
  X(B, 32, M, 5) X(B, 64, M, 5) X(B, 128, M, 5)
#define NXFPQ_INSTANCES_TAB(X) NXFPQ_WIDTHS(NXFPQ_TAB_, X)
#define NXFPQ_INSTANCES_TABW(X) NXFPQ_WIDTHS(NXFPQ_TABW_, X)
#define NXFPQ_INSTANCES_TAB237(X) NXFPQ_TAB_SIZES(X, 3, 2) \
  NXFPQ_TAB_SIZES(X, 2, 1) NXFPQ_TAB_SIZES(X, 7, 2)

#define NXFPQ_DECLARE(B, S, M, K)                                        \
  template cudaError_t launch<B, S, M, K>(const Job&, const Fmt&, int, int, \
                                          unsigned, cudaStream_t);

}  // namespace nxfpq
