// NxFP block quantizer for Hopper: Algorithm-1 encode + bit-pack.
//
// Replaces: src/repro/kernels/nxfp_quantize.py:nxfp_quantize_pack_pallas
// (body _kernel, which runs repro.core.quantize.arith_encode_blocks), and
// the K/V row writes around it (src/repro/models/kvcache.py: _quantize_kv
// + dynamic_update_slice).
//
// Computes, bit for bit, the port's plain codec (core/quantize.py:
// quantize_blocks_arith, or the table-driven quantize_blocks under
// KIND_CRT and KIND_TAB, + core/pack.pack_codes): per block of BS values
// (bf16 or f32 input; bf16 -> f32 is exact) nan_to_num to +-1e30,
// subnormals read as 0, the block max and its exponent (one per sign for
// asym), then every candidate (element format x nano mode, in the
// reference's order): shared exponent(s), nano, the snap onto the element
// grid, -0 -> +0, the code-recycling window, the ox substitution and the
// block MSE, summed left to right in f32. The first candidate is taken
// unconditionally, later ones on a strict `<`. Only packed bytes and the
// meta word are written (uint16, uint32 for asym; nxfp_decode.cuh).
//
// What bounds it on the H100. The bytes are few: an f32 weight block reads
// 128 bytes and writes 18, so the weight cast (1,835,008 blocks) needs
// 0.08 ms at 3.35 TB/s. The instructions are many: every block runs 1-8
// candidates over all its values. The kernel this one replaced read each
// candidate's element format from a runtime table inside the per-value
// loop, and it ran every candidate; at decode a K or V write was 128
// blocks on one thread each, one CTA of ~10 us of serial latency. The
// design:
//  * The element formats are template parameters (elem_consts), so the
//    snap is straight-line code on constants: a clamp, the exponent field,
//    two power-of-two multiplies and rint done as +-2^23 (exact for the
//    values below 2^(mbits+1) it sees), with the code's magnitude read off
//    the same integers (see encode()). The sm_90a build's SASS
//    (scripts/compare_kernels.py): per value and candidate 18.9
//    instructions for nxfp4's int4, 26.8 for its e2m1 (CR), 37.5 for
//    amxfp4's asym e2m1; ptxas: 54 registers (nxfp4), 66 (amxfp4).
//  * The nano-0 candidate that follows a rounded-nano candidate of the
//    same element format is skipped when the rounded nano came out 0 on
//    every side of every block of the warp: it is the same candidate
//    (same scale, codes, meta and MSE), and the strict `<` could never
//    take it. On an N(0, 0.02) weight 2.21 of nxfp4's 4 candidates are
//    needed per block, but the e2m1 one is needed by almost every warp.
//  * Two regimes (kernels/nxfp_quantize.py: quantize_plan). Large T: a
//    thread per block; the CTA stages its blocks into shared-memory rows
//    with coalesced 16-byte cp.async, and each thread sums its MSE in a
//    register, left to right. The value loop runs over packing periods
//    (8 values for 4-bit codes) rather than unrolled over the block, which
//    keeps the kernel short (1,432 SASS instructions for nxfp4; fully
//    unrolled, several times longer, it ran slower: instruction fetch the
//    likely cause).
//    Small T (decode K/V): a warp per block, one value per lane; the
//    block max by shuffles (max is order-free), the ox slot by a ballot,
//    and each candidate's squared errors go to shared memory, where one
//    lane per candidate sums them left to right (a shuffle tree would
//    change the bits).
//  * K and V are one launch that writes straight into the cache rows
//    pos[b] + t, reading pos on the device.
// Measured (scripts/compare_kernels.py, PERF.md): the weight cast takes
// ~2.7x its bytes bound, set by the instructions it issues; a decode K/V
// write is ~2 us above the timer's floor.
// Numerics: compiled with -fmad=false and without fast math (IEEE
// division for the rounded nano and 1/scale, the square and the sum of the
// MSE rounded separately); these are load-bearing for bitwise equality.
#pragma once

#include <cuda_bf16.h>

#include "nxfp_decode.cuh"
#include "nxfp_quantize.cuh"

namespace nxfpq {

constexpr float kMagic = 8388608.0f;  // 2^23
constexpr float kTiny = 1.17549435e-38f;
constexpr int kRound = -2;            // nano mode: Algorithm 1's rounded nano
constexpr int kZero = -1;             // nano mode: 0
constexpr unsigned kFull = 0xffffffffu;

template <int BITS, int EBITS>
struct Elem {
  static constexpr ElemC c = elem_consts(BITS, EBITS);
  static constexpr bool kBfp = EBITS == 0;
  static constexpr int kMb = c.mb, kEmin = c.emin, kEmax = c.emax;
  static constexpr int kMmax = c.mmax;
  // mag = ((e + bias - 1) << mb) + rint(a * 2^(mb - e)), e the snap's
  // exponent (>= emin), equals the codec's normal/subnormal code split
  static constexpr int kMagOff = (c.bias - 128) * (1 << c.mb);
  static constexpr float kMaxPos = c.max_pos;
  static constexpr float kWinLo = -0.75f * c.smallest;
  static constexpr float kWinHi = -0.25f * c.smallest;
  static constexpr float kCrVal = -0.5f * c.smallest;
};

// The codec's input cleanup, nan_to_num(nan 0, +-inf +-1e30) and a
// subnormal read as 0, in two steps: flush (NaN and subnormals to 0, two
// operations a value) and inf_to_1e30, which the tile kernel runs only on
// a block whose max is infinite.
__device__ __forceinline__ float flush(float v) {
  return fabsf(v) >= kTiny ? v : 0.0f;
}

__device__ __forceinline__ float inf_to_1e30(float v) {
  return fabsf(v) == __int_as_float(0x7f800000) ? (v > 0.0f ? 1e30f : -1e30f)
                                                 : v;
}

__device__ __forceinline__ float sanitize(float v) {
  return inf_to_1e30(flush(v));
}

__host__ __device__ constexpr int gcd_c(int a, int b) {
  return b == 0 ? a : gcd_c(b, a % b);
}

// Largest of n values, as a tree (max is exact and order-free).
template <int N>
__device__ __forceinline__ float tree_max(const float* v) {
  if constexpr (N == 1) {
    return v[0];
  } else {
    return fmaxf(tree_max<N / 2>(v), tree_max<N - N / 2>(v + N / 2));
  }
}

// Shared exponent, nano code, scale and its reciprocal fit to a block max.
struct Side {
  int e_sh, nano;
  float scale, inv;
};

template <class E>
__device__ __forceinline__ Side fit_side(float vm, int vm_e, int mode) {
  Side sd;
  sd.e_sh = min(max(vm_e - E::kEmax, -126), 127);
  const float scale0 = __int_as_float((sd.e_sh + 127) << 23);
  if (mode == kRound) {
    const float r = vm / (scale0 * E::kMaxPos);
    sd.nano = (int)fminf(fmaxf(rintf((r - 1.0f) * 4.0f), 0.0f), 3.0f);
  } else {
    sd.nano = max(mode, 0);
  }
  sd.scale = scale0 * (1.0f + (float)sd.nano * 0.25f);
  sd.inv = 1.0f / sd.scale;
  return sd;
}

// What one candidate needs per value (cr_lo, cr_hi: KIND_CRT's window).
struct Cand {
  float inv, inv_n, scale, scale_n, cr_dq, cr_lo, cr_hi;
};

// One value under one candidate: returns its code, sets the magnitude of
// its dequantized value. The codec's steps, with the snap on compile-time
// constants: rint(y) = (y + 2^23) - 2^23 for 0 <= y < 2^22 (y <
// 2^(mbits+1) here), and the code's magnitude from the exponent field and
// rint's integer. The codec's value has x's sign (or is 0), and IEEE
// subtraction is sign-symmetric, so (dq - x)^2 is (|dq| - |x|)^2 bit for
// bit; x's sign also gives the code's (a value that scales to -0 has
// magnitude 0 and takes code 0 either way).
//
// KIND_CRT and KIND_TAB take the table-driven encoder's rule instead: the
// nearest level, and a value on a midpoint takes the lower level (a smaller
// magnitude for x > 0, a larger one for x < 0); y - floor(y) is exact, so
// the tie test is exact. Above the top level both rules clamp, and a value
// that snaps to 0 takes the +0 code (the table drops -0 without CR). Under
// KIND_CRT the recycled value then takes the window (cr_lo, cr_hi] whatever
// the snap gave: outside it the nearest level of the grid with the recycled
// value is the nearest of the grid without it.
template <int BITS, class E, int KIND>
__device__ __forceinline__ int encode(float x, const Cand& c, bool asym,
                                      float& dqa) {
  constexpr int kSign = 1 << (BITS - 1);
  constexpr bool kTable = KIND == KIND_CRT || KIND == KIND_TAB;
  const bool neg = x < 0.0f;
  const float vp = x * ((asym && neg) ? c.inv_n : c.inv);
  float q;
  int mag;
  if constexpr (E::kBfp) {
    const float a = fminf(fabsf(vp), (float)E::kMmax);
    float t = a + kMagic;
    if constexpr (kTable) {
      const float fl = floorf(a);
      if (a - fl == 0.5f) t = (neg ? fl + 1.0f : fl) + kMagic;
    }
    q = t - kMagic;
    mag = __float_as_int(t) - 0x4B000000;
  } else {
    const float a = fminf(fabsf(vp), E::kMaxPos);
    const int ex = max(__float_as_int(a) >> 23, E::kEmin + 127);
    const float y = a * __int_as_float((E::kMb + 254 - ex) << 23);
    float t = y + kMagic;
    if constexpr (kTable) {
      const float fl = floorf(y);
      if (y - fl == 0.5f) t = (neg ? fl + 1.0f : fl) + kMagic;
    }
    q = (t - kMagic) * __int_as_float((ex - E::kMb) << 23);
    mag = ex * (1 << E::kMb) + (__float_as_int(t) - 0x4B000000) + E::kMagOff;
  }
  // sign | magnitude, and -0 -> +0: bit BITS-1 of -mag is set for
  // 0 < mag < kSign, clear for mag 0
  int code = mag | ((neg ? kSign : 0) & -mag);
  dqa = q * ((asym && neg) ? c.scale_n : c.scale);
  if constexpr (KIND == KIND_CR) {
    if (vp > E::kWinLo && vp < E::kWinHi) {
      code = kSign;
      dqa = c.cr_dq;
    }
  }
  if constexpr (KIND == KIND_CRT) {
    if (vp > c.cr_lo && vp <= c.cr_hi) {
      code = kSign;
      dqa = c.cr_dq;
    }
  }
  return code;
}

// Per-block state shared by the candidates.
struct Block {
  float vmax, vmax_n;
  int vmax_e, vmax_n_e;
  int ox_idx, code_ox, m_ox;
  bool has, neg_ox, ox_neg_side;
};

// ox (MX+): the block max's code and side depend on the block alone; the
// outlier's value depends on the candidate's exponent.
template <int BITS>
__device__ __forceinline__ void ox_code(Block& bk, bool asym) {
  constexpr int kMb = BITS - 1;
  bk.ox_neg_side = asym && bk.neg_ox;
  const float frac =
      (bk.ox_neg_side ? bk.vmax_n : bk.vmax) *
          nxfp::pow2i(-(bk.ox_neg_side ? bk.vmax_n_e : bk.vmax_e)) -
      1.0f;
  bk.m_ox = (int)fminf(fmaxf(rintf(frac * (float)(1 << kMb)), 0.0f),
                       (float)((1 << kMb) - 1));
  bk.code_ox = (bk.neg_ox ? 1 << kMb : 0) | bk.m_ox;
}

// One candidate's per-value arguments, its meta word and ox value.
template <int BITS, class E, int KIND>
__device__ __forceinline__ Cand make_cand(const Side& sp, const Side& sn,
                                          const Block& bk, int fmt_bit,
                                          bool asym, const Fmt& fmt,
                                          int& meta, float& v_ox) {
  Cand c;
  c.inv = sp.inv;
  c.scale = sp.scale;
  c.inv_n = sn.inv;
  c.scale_n = sn.scale;
  c.cr_dq = -(E::kCrVal * sp.scale);  // the recycled value's magnitude
  c.cr_lo = c.cr_hi = 0.0f;
  if constexpr (KIND == KIND_CRT) {
    // the window holds values of the recycled value's sign only
    c.cr_dq = fabsf(fmt.cr_val[fmt_bit]) * sp.scale;
    c.cr_lo = fmt.cr_lo[fmt_bit];
    c.cr_hi = fmt.cr_hi[fmt_bit];
  }
  meta = (sp.e_sh + 128) | (sp.nano << 8) | (fmt_bit << 10);
  v_ox = 0.0f;
  if constexpr (KIND == KIND_OX) {
    v_ox = (1.0f + (float)bk.m_ox * nxfp::pow2i(-(BITS - 1))) *
           nxfp::pow2i((bk.ox_neg_side ? sn.e_sh : sp.e_sh) + E::kEmax);
    meta |= bk.ox_idx << 11;
    // all-zero block: clear the E byte so the decode's ox gate is off
    if (!bk.has) meta &= ~0xFF;
  }
  if (asym) meta |= ((sn.e_sh + 128) << 16) | (sn.nano << 24);
  return c;
}

__device__ __forceinline__ int n_modes(int nm) {
  return nm == 0 ? 1 : (nm == 1 ? 2 : 4);
}

__device__ __forceinline__ int mode_of(int nm, int k) {
  return nm == 2 ? k : (nm == 1 && k == 0 ? kRound : kZero);
}

// ---------------------------------------------------------------------------
// addressing
// ---------------------------------------------------------------------------

// Cache block of source block lb (of one tensor); ok false for a row
// outside [0, s), a slot outside [0, cb), a row past n_valid or, paged, a
// row whose table entry is the null page.
__device__ __forceinline__ long long dest_block(const Job& job, unsigned lb,
                                                bool& ok) {
  if (job.pos == nullptr && job.slot == nullptr && job.n_valid == nullptr &&
      job.block == nullptr && job.t == 1 && job.kvh == 1 && job.nb == 1) {
    ok = true;
    return lb;
  }
  const unsigned row = lb / job.nb, nbi = lb - row * job.nb;
  const unsigned tk = (unsigned)job.t * job.kvh;
  const unsigned bb = row / tk, rem = row - bb * tk;
  const unsigned tt = rem / job.kvh, hh = rem - tt * job.kvh;
  const int p = (job.pos ? job.pos[bb] : 0) + (int)tt;
  const int sl = job.slot ? job.slot[bb] : (int)bb;
  ok = p >= 0 && p < job.s && sl >= 0 && sl < job.cb &&
       (job.n_valid == nullptr || (int)tt < job.n_valid[bb]);
  if (job.block == nullptr)
    return (((long long)sl * job.s + p) * job.kvh + hh) * job.nb + nbi;
  if (!ok) return 0;
  // paged: through the slot's table row; the null page is never written
  const int pg = job.block[sl * job.tw + p / job.page];
  ok = pg > 0 && pg < job.n_pages;
  return (((long long)pg * job.page + p % job.page) * job.kvh + hh) * job.nb +
         nbi;
}

// Value i of source block lb of tensor w (0 past hd), as f32.
template <int BS>
__device__ __forceinline__ float load_value(const Job& job, int w,
                                            unsigned lb, int i) {
  const unsigned row = lb / job.nb;
  const int col = (int)(lb - row * job.nb) * BS + i;
  if (col >= job.hd) return 0.0f;
  const size_t at = (size_t)row * job.hd + col;
  const void* src = w ? job.src[1] : job.src[0];
  return job.in_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(src)[at])
             : static_cast<const float*>(src)[at];
}

// ---------------------------------------------------------------------------
// large T: a thread per block
// ---------------------------------------------------------------------------

constexpr int kTileBlocks = 128;    // blocks (threads) per CTA at most
constexpr int kTileCtasPerSm = 6;   // the register budget
// blocks per CTA at most for block size BS: the staged rows stay within
// the 48 KB of static shared memory (64 blocks of 128 values)
template <int BS>
struct TileRows {
  static constexpr int kN = BS >= 128 ? 64 : kTileBlocks;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));  // src-size 0: zeros
}

// Stage blocks [g0, g0 + P) into `rows`: a tile of whole blocks of one
// tensor (hd % BS == 0, so block lb starts at element lb * BS) by 16-byte
// cp.async, lane after lane over consecutive bytes, as raw bf16 or f32;
// any other tile (zero-padded blocks, or the one tile that spans K and V)
// value by value, already as f32. Returns whether the rows hold raw input.
template <int BS, int ROW, typename T>
__device__ __forceinline__ bool stage_tile(const Job& job,
                                           float (*rows)[ROW], long long g0,
                                           int P, long long n_total) {
  constexpr int kCpb = BS * (int)sizeof(T) / 16;  // 16-byte chunks a block
  const long long g_end = min(g0 + P, n_total);
  const bool w0 = g0 >= job.n_per;
  if (job.hd % BS == 0 && g0 < n_total && (w0 || g_end <= job.n_per)) {
    // the tile's blocks are one contiguous run of one tensor
    const T* base = static_cast<const T*>(w0 ? job.src[1] : job.src[0]) +
                    (g0 - (w0 ? job.n_per : 0)) * BS;
    const int n_valid = (int)(g_end - g0) * kCpb;
    for (int c = threadIdx.x; c < P * kCpb; c += blockDim.x)
      cp_async16(reinterpret_cast<char*>(rows[c / kCpb]) + (c % kCpb) * 16,
                 reinterpret_cast<const char*>(base) + (c < n_valid ? c : 0) * 16,
                 c < n_valid);
    return true;
  }
  for (int e = threadIdx.x; e < P * BS; e += blockDim.x) {
    const int r = e / BS, i = e % BS;
    const long long g = g0 + r;
    float v = 0.0f;
    if (g < n_total) {
      const int w = g >= job.n_per;
      v = load_value<BS>(job, w, (unsigned)(g - (w ? job.n_per : 0)), i);
    }
    rows[r][i] = v;
  }
  return false;
}

// One candidate over a block's row of sanitized values (read again for
// each candidate, so that they need no registers): codes packed in
// registers, the MSE summed left to right. nano_zero: its nano came out 0
// on every side.
template <int BITS, int BS, class E, int KIND>
__device__ __forceinline__ float tile_cand(
    const float* row, const Block& bk, int fmt_bit, int mode, bool asym,
    const Fmt& fmt, unsigned (&cur)[(BS * BITS + 31) / 32], int& meta,
    bool& nano_zero) {
  constexpr int kWords = (BS * BITS + 31) / 32;
  const Side sp = fit_side<E>(bk.vmax, bk.vmax_e, mode);
  const Side sn = asym ? fit_side<E>(bk.vmax_n, bk.vmax_n_e, mode) : sp;
  nano_zero = sp.nano == 0 && sn.nano == 0;
  float v_ox;
  const Cand c = make_cand<BITS, E, KIND>(sp, sn, bk, fmt_bit, asym, fmt,
                                          meta, v_ox);
  // a period of values fills whole words (8 4-bit codes, 4 8-bit codes,
  // 16 6-bit codes): one period per loop step keeps the code short and the
  // word index constant; words shift in, so cur ends in block order
  constexpr int kPeriod = (32 / gcd_c(BITS, 32)) < BS ? 32 / gcd_c(BITS, 32)
                                                      : BS;
  constexpr int kPw = (kPeriod * BITS + 31) / 32;
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kWords; ++w) cur[w] = 0u;
#pragma unroll 1
  for (int i0 = 0; i0 < BS; i0 += kPeriod) {
    unsigned pw[kPw];
#pragma unroll
    for (int w = 0; w < kPw; ++w) pw[w] = 0u;
#pragma unroll
    for (int u = 0; u < kPeriod; ++u) {
      const int i = i0 + u;
      const float4 quad = reinterpret_cast<const float4*>(row)[i / 4];
      const float x = u % 4 == 0 ? quad.x : u % 4 == 1 ? quad.y
                    : u % 4 == 2 ? quad.z : quad.w;
      float dqa;
      int code = encode<BITS, E, KIND>(x, c, asym, dqa);
      if constexpr (KIND == KIND_OX) {
        if (bk.has && i == bk.ox_idx) {
          code = bk.code_ox;
          dqa = v_ox;
        }
      }
      const float d = dqa - fabsf(x);
      s = s + d * d;
      const int p = u * BITS;
      // disjoint bits: the multiply-add is an OR
      pw[p >> 5] = (unsigned)code * (1u << (p & 31)) + pw[p >> 5];
      if ((p & 31) + BITS > 32)
        pw[(p >> 5) + 1] += (unsigned)code >> (32 - (p & 31));
    }
#pragma unroll
    for (int w = 0; w + kPw < kWords; ++w) cur[w] = cur[w + kPw];
#pragma unroll
    for (int w = 0; w < kPw; ++w) cur[kWords - kPw + w] = pw[w];
  }
  return s / (float)BS;
}

// The candidates of one element format, in list order (the codec's rule:
// first taken, later ones on a strict `<`). Algorithm 1's nano-0
// candidate after a rounded nano only matters to a block whose rounded
// nano is not 0; the warp evaluates it when any of its blocks needs it (a
// block that does not gets the rounded candidate again, which never wins).
template <int BITS, int BS, class E, int KIND>
__device__ __forceinline__ void tile_elem(
    const float* row, const Block& bk, int fmt_bit, int nm, bool asym,
    const Fmt& fmt, int idx0, unsigned (&best)[(BS * BITS + 31) / 32],
    int& best_meta, float& best_mse, int& best_idx) {
  constexpr int kWords = (BS * BITS + 31) / 32;
  bool need = true;
#pragma unroll 1
  for (int k = 0; k < n_modes(nm); ++k) {
    if (nm == 1 && k == 1 && !__any_sync(__activemask(), need)) break;
    unsigned cur[kWords];
    int meta;
    bool nano_zero;
    const float mse = tile_cand<BITS, BS, E, KIND>(
        row, bk, fmt_bit, mode_of(nm, k), asym, fmt, cur, meta, nano_zero);
    need = !nano_zero;
    if (best_idx < 0 || mse < best_mse) {
      best_mse = mse;
      best_meta = meta;
      best_idx = idx0 + k;
#pragma unroll
      for (int w = 0; w < kWords; ++w) best[w] = cur[w];
    }
  }
}

// A CTA takes blockDim.x blocks, a thread each: the block's bytes staged
// into a shared-memory row by coalesced 16-byte cp.async, expanded and
// sanitized in place by its thread, which then runs the candidates over it.
template <int BITS, int BS, int MXE, int KIND>
__global__ void __launch_bounds__(kTileBlocks, kTileCtasPerSm)
quantize_tile_kernel(Job job, Fmt fmt) {
  constexpr int kRow = BS + 4;  // 16-byte aligned, reads conflict-free
  constexpr int kWords = (BS * BITS + 31) / 32;
  constexpr int kBpb = BS * BITS / 8;
  __shared__ __align__(16) float rows[TileRows<BS>::kN][kRow];
  const int P = blockDim.x, tid = threadIdx.x;
  const long long n_total = job.n_per * job.n_tensors;
  const long long g0 = (long long)blockIdx.x * P;
  const bool raw =
      job.in_bf16
          ? stage_tile<BS, kRow, __nv_bfloat16>(job, rows, g0, P, n_total)
          : stage_tile<BS, kRow, float>(job, rows, g0, P, n_total);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  const long long g = g0 + tid;
  if (g >= n_total) return;
  const bool asym = KIND == KIND_ASYM || (KIND == KIND_OX && fmt.asym);

  float* row = rows[tid];
  float xb[BS];
  if (job.in_bf16 && raw) {  // raw bf16: expand in place
#pragma unroll
    for (int j = 0; j < BS / 8; ++j) {
      const uint4 r = reinterpret_cast<const uint4*>(row)[j];
      const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // bf16 -> f32 is exact
        xb[8 * j + 2 * q] = __uint_as_float(w[q] << 16);
        xb[8 * j + 2 * q + 1] = __uint_as_float(w[q] & 0xFFFF0000u);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < BS / 4; ++j) {
      const float4 v = reinterpret_cast<const float4*>(row)[j];
      xb[4 * j] = v.x;
      xb[4 * j + 1] = v.y;
      xb[4 * j + 2] = v.z;
      xb[4 * j + 3] = v.w;
    }
  }
  float mag[BS];
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    xb[i] = flush(xb[i]);
    mag[i] = fabsf(xb[i]);
  }
  if (tree_max<BS>(mag) == __int_as_float(0x7f800000)) {  // rare
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      xb[i] = inf_to_1e30(xb[i]);
      mag[i] = fabsf(xb[i]);
    }
  }
#pragma unroll
  for (int j = 0; j < BS / 4; ++j)
    reinterpret_cast<float4*>(row)[j] =
        make_float4(xb[4 * j], xb[4 * j + 1], xb[4 * j + 2], xb[4 * j + 3]);
  Block bk;
  if (asym) {
#pragma unroll
    for (int i = 0; i < BS; ++i) mag[i] = fmaxf(xb[i], 0.0f);
    bk.vmax = tree_max<BS>(mag);
#pragma unroll
    for (int i = 0; i < BS; ++i) mag[i] = fmaxf(-xb[i], 0.0f);
    bk.vmax_n = tree_max<BS>(mag);
  } else {
    bk.vmax = tree_max<BS>(mag);
    bk.vmax_n = 0.0f;
  }
  bk.vmax_e = nxfp::floor_log2_bits(bk.vmax);
  bk.vmax_n_e = nxfp::floor_log2_bits(bk.vmax_n);
  bk.ox_idx = BS;
  bk.has = false;
  bk.neg_ox = false;
  if constexpr (KIND == KIND_OX) {
    const float vtot = asym ? fmaxf(bk.vmax, bk.vmax_n) : bk.vmax;
#pragma unroll
    for (int i = BS - 1; i >= 0; --i)
      if (fabsf(xb[i]) >= vtot) bk.ox_idx = i;
#pragma unroll
    for (int i = 0; i < BS; ++i)
      if (i == bk.ox_idx) bk.neg_ox = xb[i] < 0.0f;
    bk.has = vtot > 0.0f;
    ox_code<BITS>(bk, asym);
  }

  unsigned best[kWords];
  int best_meta = 0, best_idx = -1;
  float best_mse = 0.0f;
  // list index of an element format's first candidate: BFP's come first
  const int mx0 = fmt.has_bfp ? n_modes(fmt.nm) : 0;
  if (fmt.has_bfp)
    tile_elem<BITS, BS, Elem<BITS, 0>, KIND>(row, bk, 0, fmt.nm, asym, fmt, 0,
                                             best, best_meta, best_mse,
                                             best_idx);
  if (fmt.has_mx)
    tile_elem<BITS, BS, Elem<BITS, MXE>, KIND>(row, bk, 1, fmt.nm, asym, fmt,
                                               mx0, best, best_meta, best_mse,
                                               best_idx);

  const int w = g >= job.n_per;
  bool ok;
  const long long d = dest_block(job, (unsigned)(g - (w ? job.n_per : 0)), ok);
  if (!ok) return;
  uint8_t* dst = static_cast<uint8_t*>(w ? job.packed[1] : job.packed[0]) +
                 d * kBpb;
  if constexpr (kBpb % 16 == 0) {
#pragma unroll
    for (int j = 0; j < kBpb / 16; ++j)
      reinterpret_cast<uint4*>(dst)[j] =
          make_uint4(best[4 * j], best[4 * j + 1], best[4 * j + 2],
                     best[4 * j + 3]);
  } else if constexpr (kBpb % 4 == 0) {
#pragma unroll
    for (int j = 0; j < kBpb / 4; ++j)
      reinterpret_cast<unsigned*>(dst)[j] = best[j];
  } else {
#pragma unroll
    for (int j = 0; j < kBpb; ++j)
      dst[j] = (uint8_t)(best[j >> 2] >> ((j & 3) * 8));
  }
  void* meta_out = w ? job.meta[1] : job.meta[0];
  if (asym) static_cast<uint32_t*>(meta_out)[d] = (uint32_t)best_meta;
  else static_cast<uint16_t*>(meta_out)[d] = (uint16_t)best_meta;
}

// ---------------------------------------------------------------------------
// small T: a warp per block (32 / BS blocks per warp up to 32 values a
// block; BS / 32 values a lane above)
// ---------------------------------------------------------------------------

constexpr int kMaxWarps = 8;

template <int BS>
struct WarpShape {
  static constexpr int kSegs = BS <= 32 ? 32 / BS : 1;  // blocks per warp
  static constexpr int kVpl = BS <= 32 ? 1 : BS / 32;   // values per lane
  static constexpr int kVals = BS <= 32 ? 32 : BS;      // values per warp
  static constexpr int kLanes = BS <= 32 ? BS : 32;     // lanes per block
};

template <int BITS, int BS>
struct WarpSmem {
  static constexpr int kSegs = WarpShape<BS>::kSegs;
  static constexpr int kVals = WarpShape<BS>::kVals;
  float sq[kMaxWarps][kMaxCands][kVals + 1];     // squared errors by value
  uint8_t code[kMaxWarps][kMaxCands + 1][kVals];  // codes; [kMaxCands]: winner
  float mse[kMaxWarps][kSegs][kMaxCands];
  int meta[kMaxWarps][kSegs][kMaxCands];
};

// Candidates of one element format for this lane's values (value j at
// index lane + 32 j of the warp's); each candidate's squared errors, codes
// and meta go to shared memory.
template <int BITS, int BS, class E, int KIND>
__device__ __forceinline__ void warp_elem(
    const float (&x)[WarpShape<BS>::kVpl], int i, int seg, int lane,
    const Block& bk, int fmt_bit, int nm, bool asym, const Fmt& fmt,
    WarpSmem<BITS, BS>& sm, int warp, int& nc) {
  bool skip_zero = false;
#pragma unroll 1
  for (int k = 0; k < n_modes(nm); ++k) {
    const int mode = mode_of(nm, k);
    if (mode == kZero && skip_zero) continue;  // the same candidate again
    const Side sp = fit_side<E>(bk.vmax, bk.vmax_e, mode);
    const Side sn = asym ? fit_side<E>(bk.vmax_n, bk.vmax_n_e, mode) : sp;
    if (mode == kRound) skip_zero = sp.nano == 0 && sn.nano == 0;
    int meta;
    float v_ox;
    const Cand c = make_cand<BITS, E, KIND>(sp, sn, bk, fmt_bit, asym, fmt,
                                            meta, v_ox);
#pragma unroll
    for (int j = 0; j < WarpShape<BS>::kVpl; ++j) {
      float dqa;
      int code = encode<BITS, E, KIND>(x[j], c, asym, dqa);
      if constexpr (KIND == KIND_OX) {
        if (bk.has && i == bk.ox_idx) {
          code = bk.code_ox;
          dqa = v_ox;
        }
      }
      const float d = dqa - fabsf(x[j]);
      sm.sq[warp][nc][lane + 32 * j] = d * d;
      sm.code[warp][nc][lane + 32 * j] = (uint8_t)code;
    }
    if (i == 0) sm.meta[warp][seg][nc] = meta;
    ++nc;
  }
}

template <int BITS, int BS, int MXE, int KIND>
__global__ void __launch_bounds__(kMaxWarps * 32)
quantize_warp_kernel(Job job, Fmt fmt) {
  using WS = WarpShape<BS>;
  constexpr int kSegs = WS::kSegs, kVpl = WS::kVpl, kLanes = WS::kLanes;
  constexpr int kBpb = BS * BITS / 8;
  __shared__ WarpSmem<BITS, BS> sm;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // seg: this lane's block within the warp; i: its (first) value's index
  const int seg = lane / kLanes, i = lane % kLanes;
  const long long n_total = job.n_per * job.n_tensors;
  const long long g =
      ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * kSegs + seg;
  const bool valid = g < n_total;
  const int w = valid && g >= job.n_per;
  const unsigned lb = valid ? (unsigned)(g - (w ? job.n_per : 0)) : 0u;
  const bool asym = KIND == KIND_ASYM || (KIND == KIND_OX && fmt.asym);

  bool ok = false;  // the cache row first: its pos load overlaps the rest
  const long long d = valid ? dest_block(job, lb, ok) : 0;
  float x[kVpl];
#pragma unroll
  for (int j = 0; j < kVpl; ++j)
    x[j] = sanitize(valid ? load_value<BS>(job, w, lb, i + 32 * j) : 0.0f);
  Block bk;
  bk.vmax = asym ? fmaxf(x[0], 0.0f) : fabsf(x[0]);
  bk.vmax_n = asym ? fmaxf(-x[0], 0.0f) : 0.0f;
#pragma unroll
  for (int j = 1; j < kVpl; ++j) {
    bk.vmax = fmaxf(bk.vmax, asym ? fmaxf(x[j], 0.0f) : fabsf(x[j]));
    bk.vmax_n = fmaxf(bk.vmax_n, asym ? fmaxf(-x[j], 0.0f) : 0.0f);
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {  // max is order-free
    bk.vmax = fmaxf(bk.vmax, __shfl_xor_sync(kFull, bk.vmax, o, kLanes));
    bk.vmax_n =
        fmaxf(bk.vmax_n, __shfl_xor_sync(kFull, bk.vmax_n, o, kLanes));
  }
  bk.vmax_e = nxfp::floor_log2_bits(bk.vmax);
  bk.vmax_n_e = nxfp::floor_log2_bits(bk.vmax_n);
  bk.ox_idx = BS;
  bk.has = false;
  bk.neg_ox = false;
  if constexpr (KIND == KIND_OX) {
    static_assert(BS <= 32, "ox: a 5-bit index, blocks of 32 at most");
    const float vtot = asym ? fmaxf(bk.vmax, bk.vmax_n) : bk.vmax;
    // the first value with |x| >= max: the lowest set lane of the ballot
    const unsigned seg_mask = BS == 32 ? kFull : ((1u << BS) - 1u);
    const unsigned hit =
        (__ballot_sync(kFull, fabsf(x[0]) >= vtot) >> (seg * BS)) & seg_mask;
    bk.ox_idx = __ffs(hit) - 1;
    bk.neg_ox = __shfl_sync(kFull, x[0], seg * BS + bk.ox_idx) < 0.0f;
    bk.has = vtot > 0.0f;
    ox_code<BITS>(bk, asym);
  }

  int nc = 0;
  if (fmt.has_bfp)
    warp_elem<BITS, BS, Elem<BITS, 0>, KIND>(x, i, seg, lane, bk, 0, fmt.nm,
                                             asym, fmt, sm, warp, nc);
  if (fmt.has_mx)
    warp_elem<BITS, BS, Elem<BITS, MXE>, KIND>(x, i, seg, lane, bk, 1, fmt.nm,
                                               asym, fmt, sm, warp, nc);
  __syncwarp();
  // lane i of a block sums candidate i's squared errors, left to right
  if (i < nc) {
    const float* row = &sm.sq[warp][i][seg * BS];
    float s = row[0];
#pragma unroll
    for (int j = 1; j < BS; ++j) s = s + row[j];
    sm.mse[warp][seg][i] = s / (float)BS;
  }
  __syncwarp();
  int best = 0;
  float best_mse = sm.mse[warp][seg][0];
  for (int c = 1; c < nc; ++c) {
    const float m = sm.mse[warp][seg][c];
    if (m < best_mse) {
      best_mse = m;
      best = c;
    }
  }
#pragma unroll
  for (int j = 0; j < kVpl; ++j)
    sm.code[warp][kMaxCands][lane + 32 * j] =
        sm.code[warp][best][lane + 32 * j];
  __syncwarp();
  if (!valid || !ok) return;
  // byte by of the packed block: codes k*BITS..
  auto pack_byte = [&](int by) {
    const uint8_t* codes = &sm.code[warp][kMaxCands][seg * BS];
    unsigned v = 0;
    for (int k = (8 * by) / BITS; k <= (8 * by + 7) / BITS && k < BS; ++k) {
      const int sh = k * BITS - 8 * by;
      v |= sh >= 0 ? (unsigned)codes[k] << sh : (unsigned)codes[k] >> -sh;
    }
    (static_cast<uint8_t*>(w ? job.packed[1] : job.packed[0]))[d * kBpb + by] =
        (uint8_t)v;
  };
  if constexpr (BS <= 32) {  // a lane a byte
    if (i < kBpb) pack_byte(i);
  } else {                   // bs / 32 bytes a lane at 8 bits
    for (int by = i; by < kBpb; by += 32) pack_byte(by);
  }
  if (i == 0) {
    const int meta = sm.meta[warp][seg][best];
    void* mo = w ? job.meta[1] : job.meta[0];
    if (asym) static_cast<uint32_t*>(mo)[d] = (uint32_t)meta;
    else static_cast<uint16_t*>(mo)[d] = (uint16_t)meta;
  }
}

template <int BITS, int BS, int MXE, int KIND>
cudaError_t launch(const Job& job, const Fmt& fmt, int regime, int per_cta,
                   unsigned grid, cudaStream_t stream) {
  if (regime == REGIME_TILE) {
    if (per_cta < 1 || per_cta > TileRows<BS>::kN) return cudaErrorInvalidValue;
    quantize_tile_kernel<BITS, BS, MXE, KIND>
        <<<grid, per_cta, 0, stream>>>(job, fmt);
  } else {
    constexpr int kSegs = WarpShape<BS>::kSegs;
    if (per_cta < kSegs || per_cta % kSegs || per_cta / kSegs > kMaxWarps)
      return cudaErrorInvalidValue;
    quantize_warp_kernel<BITS, BS, MXE, KIND>
        <<<grid, per_cta / kSegs * 32, 0, stream>>>(job, fmt);
  }
  return cudaGetLastError();
}

}  // namespace nxfpq
