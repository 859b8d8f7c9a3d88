// Fused NxFP block quantizer: Algorithm-1 encode + bit-pack.
//
// Replaces: src/repro/kernels/nxfp_quantize.py:nxfp_quantize_pack_pallas
// (body _kernel, which runs repro.core.quantize.arith_encode_blocks).
//
// Computes, for each 32-element block of f32 input: nan_to_num to +-1e30
// (subnormals read as 0, as the reference's XLA/TPU arithmetic flushes them),
// the block max and its exponent (floor_log2_bits) -- for an asym format
// one max per sign --, and for every candidate of the format (element
// format x {rounded nano, 0}, in the reference's order) the shared
// exponent(s), the nano code(s), the ulp snap onto the element grid, -0 ->
// +0, the code-recycling window, the ox substitution of the block max and
// the block MSE; the first candidate is taken unconditionally and later
// ones on a strict `<`, so inf-MSE blocks (input 1e30) still encode. The
// winning codes are packed in registers (code i at bit i*bits,
// little-endian) and the kernel writes only packed bytes and the meta
// word: uint16, or uint32 for an asym format (E+ | nano+ | fmt | ox index
// | E- | nano-, nxfp_decode.cuh).
//
// asym (AMXFP): an element scales by 1/scale of its INPUT's sign (IEEE
// division), its dequantized value by the scale of the snapped value's
// sign, as the reference. ox (MX+): the first element with |x| >= max|x|
// is re-coded as sign | bits-1 mantissa bits of the max, which depend on
// the block alone; the outlier value depends on the candidate's exponent.
//
// Numerics: this file is compiled with -fmad=false and without fast math,
// so x*(1/scale), the IEEE division of the rounded-nano ratio, rintf
// (half to even) and the separately rounded square-then-add of the MSE are
// those of the reference. The MSE sums left to right, as the plain
// version (core/quantize.py) does; the reference's XLA reduction order may
// differ, which can flip a block whose two best candidates are within an
// ulp (counted by the tests, never loosened).
//
// Bound on the H100: memory. Each f32 input byte is read once and
// bits/32 + (2 or 4)/(4*32) bytes are written per input byte; the arithmetic is
// ~30 f32/int ops per element per candidate. Design: one thread per block,
// the block held in registers (float4 loads of its 128 bytes), candidates
// evaluated one after another, packed words kept in registers. Simple and
// exact; a warp-per-tile layout with coalesced shared-memory staging is
// later work.
#include <cuda_runtime.h>

#include "nxfp_decode.cuh"

namespace {

constexpr int kMaxCands = 8;

struct Cand {
  int fmt_bit;
  int is_bfp;
  int mbits;
  int bias;
  int emax;
  int nano_mode;  // -1: nano 0, -2: Alg.-1 rounded nano, 0..3: that code
  float max_pos;
};

struct QuantFmt {
  int cr;
  int asym;
  int ox;
  int n_cands;
  Cand c[kMaxCands];
};

struct Side {
  int e_sh, nano;
  float scale;
};

// Shared exponent, nano code and scale fit to one block max.
__device__ __forceinline__ Side fit_side(float vm, int vm_e, const Cand& cd) {
  Side sd;
  sd.e_sh = min(max(vm_e - cd.emax, -126), 127);
  const float scale0 = nxfp::pow2i(sd.e_sh);
  sd.nano = 0;
  if (cd.nano_mode == -2) {
    const float r = vm / (scale0 * cd.max_pos);
    sd.nano = (int)fminf(fmaxf(rintf((r - 1.0f) * 4.0f), 0.0f), 3.0f);
  } else if (cd.nano_mode >= 0) {
    sd.nano = cd.nano_mode;
  }
  sd.scale = scale0 * (1.0f + (float)sd.nano * 0.25f);
  return sd;
}

template <int BITS, int BS, bool EX>
__global__ void __launch_bounds__(128)
nxfp_quantize_kernel(const float* __restrict__ x, uint8_t* __restrict__ packed,
                     void* __restrict__ meta_out, long long n_blocks,
                     QuantFmt qf) {
  constexpr int kWords = (BS * BITS + 31) / 32;
  constexpr int kBpb = BS * BITS / 8;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_blocks) return;
  // the activation formats' code compiles away for the symmetric ones
  const bool asym = EX && qf.asym, ox = EX && qf.ox;

  float xb[BS];
  const float4* src = reinterpret_cast<const float4*>(x + t * BS);
#pragma unroll
  for (int j = 0; j < BS / 4; ++j) {
    const float4 v = src[j];
    xb[4 * j] = v.x;
    xb[4 * j + 1] = v.y;
    xb[4 * j + 2] = v.z;
    xb[4 * j + 3] = v.w;
  }
  float vmax = 0.0f, vmax_n = 0.0f;  // asym: positive / negative side
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    float v = xb[i];
    if (isnan(v)) v = 0.0f;
    else if (isinf(v)) v = v > 0.0f ? 1e30f : -1e30f;
    else if (fabsf(v) < 1.17549435e-38f) v = 0.0f;  // subnormal reads as 0
    xb[i] = v;
    if (asym) {
      vmax = fmaxf(vmax, fmaxf(v, 0.0f));
      vmax_n = fmaxf(vmax_n, fmaxf(-v, 0.0f));
    } else {
      vmax = fmaxf(vmax, fabsf(v));
    }
  }
  const int vmax_e = nxfp::floor_log2_bits(vmax);
  const int vmax_n_e = nxfp::floor_log2_bits(vmax_n);
  constexpr int kSign = 1 << (BITS - 1);
  constexpr int kMb = BITS - 1;

  // ox: the block max's slot and its code depend on the block alone
  const float vtot = asym ? fmaxf(vmax, vmax_n) : vmax;
  int ox_idx = BS;
#pragma unroll
  for (int i = BS - 1; i >= 0; --i)
    if (fabsf(xb[i]) >= vtot) ox_idx = i;
  const bool has = vtot > 0.0f;
  bool neg_ox = false;
#pragma unroll
  for (int i = 0; i < BS; ++i)
    if (i == ox_idx) neg_ox = xb[i] < 0.0f;
  const bool ox_neg_side = asym && neg_ox;
  const float frac = (ox_neg_side ? vmax_n : vmax) *
                         nxfp::pow2i(-(ox_neg_side ? vmax_n_e : vmax_e)) -
                     1.0f;
  const int m_ox = (int)fminf(fmaxf(rintf(frac * (float)(1 << kMb)), 0.0f),
                              (float)((1 << kMb) - 1));
  const int code_ox = (neg_ox ? 1 << kMb : 0) | m_ox;
  const bool ox_sub = ox && has;

  unsigned best[kWords];
  int best_meta = 0;
  float best_mse = 0.0f;
  for (int ci = 0; ci < qf.n_cands; ++ci) {
    const Cand cd = qf.c[ci];
    const Side sp = fit_side(vmax, vmax_e, cd);
    const Side sn = asym ? fit_side(vmax_n, vmax_n_e, cd) : sp;
    const float inv = 1.0f / sp.scale;
    const float inv_n = 1.0f / sn.scale;
    const int emin = 1 - cd.bias;
    const float smallest =
        cd.is_bfp ? 1.0f : nxfp::pow2i(-cd.mbits) * nxfp::pow2i(emin);
    const float win_lo = -0.75f * smallest, win_hi = -0.25f * smallest;
    const float two_emin = nxfp::pow2i(emin);
    const float sub_mul = nxfp::pow2i(cd.mbits - emin);
    const int mmax = (1 << (BITS - 1)) - 1;
    float v_ox = (1.0f + (float)m_ox * nxfp::pow2i(-kMb)) *
                 nxfp::pow2i((ox_neg_side ? sn.e_sh : sp.e_sh) + cd.emax);
    if (neg_ox) v_ox = -v_ox;

    unsigned cur[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) cur[w] = 0u;
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      const float vp = xb[i] * ((asym && xb[i] < 0.0f) ? inv_n : inv);
      const float a = fabsf(vp);
      const bool neg = vp < 0.0f;
      float q;
      int mag;
      if (cd.is_bfp) {
        q = fminf(fmaxf(rintf(a), 0.0f), (float)mmax);
        mag = (int)q;
      } else {
        const float a_c = fminf(a, cd.max_pos);
        const int e_eff = max(nxfp::floor_log2_bits(a_c), emin);
        q = rintf(a_c * nxfp::pow2i(cd.mbits - e_eff)) *
            nxfp::pow2i(e_eff - cd.mbits);
        q = fminf(q, cd.max_pos);
        const int qb = __float_as_int(q);
        const int e_q = ((qb >> 23) & 0xFF) - 127;
        const int m_top = (qb >> (23 - cd.mbits)) & ((1 << cd.mbits) - 1);
        const int m_sub = (int)(q * sub_mul);
        mag = q >= two_emin ? (((e_q + cd.bias) << cd.mbits) | m_top) : m_sub;
      }
      int code = neg ? (mag | kSign) : mag;
      float val = neg ? -q : q;
      if (mag == 0 && neg) code = 0;
      if (qf.cr && vp > win_lo && vp < win_hi) {
        code = kSign;
        val = -0.5f * smallest;
      }
      float dq = val * ((asym && neg) ? sn.scale : sp.scale);
      if (ox_sub && i == ox_idx) {
        code = code_ox;
        dq = v_ox;
      }
      const float d = dq - xb[i];
      s = s + d * d;
      const int p = i * BITS;
      cur[p >> 5] |= (unsigned)code << (p & 31);
      if ((p & 31) + BITS > 32) cur[(p >> 5) + 1] |= (unsigned)code >> (32 - (p & 31));
    }
    const float mse = s / (float)BS;
    if (ci == 0 || mse < best_mse) {
      best_mse = mse;
      int meta = (sp.e_sh + 128) | (sp.nano << 8) | (cd.fmt_bit << 10);
      if (ox) {
        meta |= ox_idx << 11;
        // all-zero block: clear the E byte so the decode's ox gate is off
        if (!has) meta &= ~0xFF;
      }
      if (asym) meta |= ((sn.e_sh + 128) << 16) | (sn.nano << 24);
      best_meta = meta;
#pragma unroll
      for (int w = 0; w < kWords; ++w) best[w] = cur[w];
    }
  }

  if constexpr (kBpb % 4 == 0) {
    unsigned* dst = reinterpret_cast<unsigned*>(packed + t * kBpb);
#pragma unroll
    for (int w = 0; w < kBpb / 4; ++w) dst[w] = best[w];
  } else {
    uint8_t* dst = packed + t * kBpb;
#pragma unroll
    for (int j = 0; j < kBpb; ++j)
      dst[j] = (uint8_t)(best[j >> 2] >> ((j & 3) * 8));
  }
  if (asym) reinterpret_cast<uint32_t*>(meta_out)[t] = (uint32_t)best_meta;
  else reinterpret_cast<uint16_t*>(meta_out)[t] = (uint16_t)best_meta;
}

template <int BITS, int BS>
void launch(const float* x, uint8_t* packed, void* meta, long long n,
            const QuantFmt& qf, cudaStream_t stream) {
  const int threads = 128;
  const long long grid = (n + threads - 1) / threads;
  if (qf.asym || qf.ox)
    nxfp_quantize_kernel<BITS, BS, true>
        <<<(unsigned)grid, threads, 0, stream>>>(x, packed, meta, n, qf);
  else
    nxfp_quantize_kernel<BITS, BS, false>
        <<<(unsigned)grid, threads, 0, stream>>>(x, packed, meta, n, qf);
}

}  // namespace

extern "C" int nxfp_quantize_launch(const void* x, void* packed, void* meta,
                                    long long n_blocks, int bits,
                                    int block_size, const void* fmt_desc,
                                    void* stream) {
  const QuantFmt qf = *reinterpret_cast<const QuantFmt*>(fmt_desc);
  if (qf.n_cands < 1 || qf.n_cands > kMaxCands) return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  auto* xs = reinterpret_cast<const float*>(x);
  auto* ps = reinterpret_cast<uint8_t*>(packed);
  auto st = reinterpret_cast<cudaStream_t>(stream);
#define NXFP_Q(B, S) \
  if (bits == B && block_size == S) launch<B, S>(xs, ps, meta, n_blocks, qf, st); else
  NXFP_Q(4, 32) NXFP_Q(5, 32) NXFP_Q(6, 32) NXFP_Q(8, 32)
  NXFP_Q(4, 16) NXFP_Q(5, 16) NXFP_Q(6, 16) NXFP_Q(8, 16)
  return (int)cudaErrorInvalidValue;
#undef NXFP_Q
  return (int)cudaGetLastError();
}
