// NxFP field decode shared by the CUDA kernels.
//
// Device twin of the reference's kernels/decode_lib.py (decode_elem,
// decode_scale, decode_block_values and, for the activation formats,
// decode_block_values_ex) and of the port's plain kernels/decode_lib.py.
// Values are exact in f32 (power-of-two assembly, no transcendentals), so
// the device decode is bitwise equal to the plain PyTorch dequantize.
//
// Meta word (uint16, or uint32 for asym formats):
//   [0:8] E+ + 128   [8:10] nano+   [10] fmt bit   [11:16] ox index
//   [16:24] E- + 128   [24:26] nano-                     (asym only)
// An asym element scales by the sign of its DECODED value (a -0 code takes
// the positive scale). An ox block's element at the stored index decodes to
// +-(1 + m/2^(bits-1)) * 2^(E_sign + emax), unless the E+ byte is 0 (an
// all-zero block, e.g. padding).
//
// Code i of a packed block sits at bit offset i*bits, little-endian, and
// straddles at most two bytes: one read serves 2- to 8-bit widths and any
// block count (the two-block pack tile of the TPU kernels is not needed).
//
// One long block. Every block of bs >= 8 codes is a whole number of bytes,
// so consecutive blocks of a row have exactly the bytes of one long block:
// a kernel may read a row's codes in units of its own choosing (8 or 32
// codes) and find each code's meta word by its position k along the row,
// word row * KB + (k >> log2(bs)). The kernels' instances for bs 16/32 at
// 4/5/6/8 bits read whole blocks; every other width and block size (3-bit
// codes, bs 8, 64, 128) runs a "generic" instance that reads such units,
// with the block size a runtime shift (2/7-bit codes, BFP only, too).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace nxfp {

// One element format, as the host describes it (kernels/build.py).
struct ElemDesc {
  int bits;    // code width
  int is_bfp;  // 1: sign-magnitude integer, 0: sign/exponent/mantissa
  int ebits;
  int mbits;
  int bias;
  int cr;      // code recycling: 10...0 decodes to cr_val
  float cr_val;  // the recycled value (-smallest/2 unless the format says)
};

// One block format (kernels/build.py: FmtDesc).
struct FmtDesc {
  ElemDesc elem[2];  // decode for fmt_bit 0 / 1 (equal when not AM)
  int bits;
  int block_size;
  int asym;          // per-sign dual scale (AMXFP)
  int ox;            // block-max outlier mantissa (MX+)
  int emax;          // emax of the ox outlier's element grid
};

// Exact 2**e for e clipped to [-126, 127], from exponent bits.
__device__ __forceinline__ float pow2i(int e) {
  e = min(max(e, -126), 127);
  return __int_as_float((e + 127) << 23);
}

// floor(log2 v) for v >= 0 from the exponent field; zeros and subnormals
// clamp to -126 (the reference's floor_log2_bits).
__device__ __forceinline__ int floor_log2_bits(float v) {
  const int e = ((__float_as_int(v) >> 23) & 0xFF) - 127;
  return v < 1.17549435e-38f ? -126 : e;
}

// Element code -> value in scaled units (decode_lib.decode_elem).
__device__ __forceinline__ float decode_elem(int c, const ElemDesc& f) {
  const int sign = (c >> (f.bits - 1)) & 1;
  const int mag = c & ((1 << (f.bits - 1)) - 1);
  float val;
  if (f.is_bfp) {
    val = (float)mag;
  } else {
    const int e = mag >> f.mbits;
    const float m = (float)(mag & ((1 << f.mbits) - 1)) * pow2i(-f.mbits);
    const float sub = m * pow2i(1 - f.bias);
    const float nrm = (1.0f + m) * pow2i(e - f.bias);
    val = e == 0 ? sub : nrm;
    if (f.ebits == 4 && f.mbits == 3 && mag == 127) val = 0.0f;  // e4m3 NaN
  }
  if (sign) val = -val;
  if (f.cr && c == (1 << (f.bits - 1))) val = f.cr_val;
  return val;
}

// uint16 meta word -> scale (1 + nano/4) * 2**E and the format bit.
__device__ __forceinline__ float decode_scale(unsigned meta, int* fmt_bit) {
  const int e_shared = (int)(meta & 0xFF) - 128;
  const int nano = (meta >> 8) & 0x3;
  *fmt_bit = (meta >> 10) & 0x1;
  return (1.0f + (float)nano * 0.25f) * pow2i(e_shared);
}

// Meta word i: uint32 words for an asym format, uint16 otherwise.
__device__ __forceinline__ unsigned read_meta(const void* meta, size_t i,
                                              const FmtDesc& f) {
  return f.asym ? reinterpret_cast<const uint32_t*>(meta)[i]
                : (unsigned)reinterpret_cast<const uint16_t*>(meta)[i];
}

// A block's scales, format bit and ox slot, read from its meta word (the
// activation formats; a symmetric format needs decode_scale alone).
struct BlockScale {
  float sp, sn;  // scale of positive / negative values (equal unless asym)
  float op, on;  // ox outlier bases 2**(E+ + emax), 2**(E- + emax)
  int fb;        // fmt bit (AM)
  int ox_idx;    // element re-coded as the outlier, -1 for none
};

__device__ __forceinline__ BlockScale block_scale(unsigned m,
                                                  const FmtDesc& f) {
  BlockScale s;
  const int e_p = (int)(m & 0xFF) - 128;
  s.sp = decode_scale(m, &s.fb);
  int e_n = e_p;
  s.sn = s.sp;
  if (f.asym) {
    e_n = (int)((m >> 16) & 0xFF) - 128;
    s.sn = (1.0f + (float)((m >> 24) & 0x3) * 0.25f) * pow2i(e_n);
  }
  s.ox_idx = (f.ox && (m & 0xFF) != 0) ? (int)((m >> 11) & 0x1F) : -1;
  s.op = pow2i(e_p + f.emax);
  s.on = pow2i(e_n + f.emax);
  return s;
}

// Element i of an activation-format block in original units, from its
// code and its element value v (decode_elem of the code, scaled units).
__device__ __forceinline__ float block_value(const BlockScale& s, float v,
                                             int code, int i, int bits) {
  if (i == s.ox_idx) {
    const int mb = bits - 1;
    const int sign = (code >> mb) & 1;
    const float vox = (1.0f + (float)(code & ((1 << mb) - 1)) * pow2i(-mb)) *
                      (sign ? s.on : s.op);
    return sign ? -vox : vox;
  }
  return v * (v < 0.0f ? s.sn : s.sp);
}

// Code i of a packed block of `bpb` bytes (little-endian, bit i*bits).
__device__ __forceinline__ int unpack_code(const uint8_t* bytes, int i,
                                           int bits) {
  const int p = i * bits;
  const int lo = p >> 3, off = p & 7;
  int word = bytes[lo];
  if (off + bits > 8) word |= (int)bytes[lo + 1] << 8;
  return (word >> off) & ((1 << bits) - 1);
}

// The codes of one packed block (QB codes of BITS bits), held in registers.
template <int BITS, int QB>
struct PackedBlock {
  unsigned w[(QB * BITS + 31) / 32];

  // Read block `blk`; the packed base must be 4-byte aligned.
  __device__ __forceinline__ void load(const uint8_t* __restrict__ packed,
                                       size_t blk) {
    constexpr int kBpb = QB * BITS / 8;
    if constexpr (kBpb % 4 == 0) {
      const unsigned* src =
          reinterpret_cast<const unsigned*>(packed + blk * kBpb);
#pragma unroll
      for (int j = 0; j < kBpb / 4; ++j) w[j] = src[j];
    } else {
      const uint8_t* src = packed + blk * kBpb;
#pragma unroll
      for (int j = 0; j < (QB * BITS + 31) / 32; ++j) w[j] = 0u;
#pragma unroll
      for (int b = 0; b < kBpb; ++b) w[b >> 2] |= (unsigned)src[b] << ((b & 3) * 8);
    }
  }

  // Code i (a compile-time constant once the caller's loop is unrolled).
  __device__ __forceinline__ int code(int i) const {
    const int p = i * BITS;
    unsigned v = w[p >> 5] >> (p & 31);
    if ((p & 31) + BITS > 32) v |= w[(p >> 5) + 1] << (32 - (p & 31));
    return (int)(v & ((1u << BITS) - 1));
  }
};

// Fill pb with block `blk` of a packed operand by the widest loads its
// byte count allows (the packed base is 16-byte aligned).
template <int BITS, int QB>
__device__ __forceinline__ void load_block_vec(
    PackedBlock<BITS, QB>& pb, const uint8_t* __restrict__ packed,
    size_t blk) {
  constexpr int kBpb = QB * BITS / 8;
  const uint8_t* src = packed + blk * kBpb;
  if constexpr (kBpb % 16 == 0) {
#pragma unroll
    for (int j = 0; j < kBpb / 16; ++j) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + j);
      pb.w[4 * j] = v.x;
      pb.w[4 * j + 1] = v.y;
      pb.w[4 * j + 2] = v.z;
      pb.w[4 * j + 3] = v.w;
    }
  } else if constexpr (kBpb % 8 == 0) {
#pragma unroll
    for (int j = 0; j < kBpb / 8; ++j) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(src) + j);
      pb.w[2 * j] = v.x;
      pb.w[2 * j + 1] = v.y;
    }
  } else if constexpr (kBpb % 4 == 0) {
#pragma unroll
    for (int j = 0; j < kBpb / 4; ++j)
      pb.w[j] = __ldg(reinterpret_cast<const unsigned*>(src) + j);
  } else {  // 10-byte blocks (5-bit codes, block size 16): 2-byte aligned
#pragma unroll
    for (int j = 0; j < (QB * BITS + 31) / 32; ++j) pb.w[j] = 0u;
#pragma unroll
    for (int j = 0; j < kBpb / 2; ++j)
      pb.w[j >> 1] |=
          (unsigned)__ldg(reinterpret_cast<const uint16_t*>(src) + j)
          << ((j & 1) * 16);
  }
}

// Decode packed block `blk` to QB/2 bf16 pairs at dst, each value rounded
// to nearest even as the TPU's _decode_tile does. `lut` holds decode_elem
// of every code for fmt bit 0 then 1. A symmetric format (the weights and
// the KV cache) takes one scale per block; only the activation formats
// pay for the per-element sign select and ox slot. The branch is on the
// format, uniform across the launch; a kernel instantiated with EX false
// (symmetric formats only) compiles without the activation-format path.
template <int BITS, int QB, bool EX>
__device__ __forceinline__ void decode_block_bf16(
    const uint8_t* __restrict__ packed, const void* __restrict__ meta,
    size_t blk, const float* lut, const FmtDesc& f, __nv_bfloat162* dst) {
  PackedBlock<BITS, QB> pb;
  pb.load(packed, blk);
  if (!EX || (!f.asym && !f.ox)) {
    int fb;
    const float sc =
        decode_scale(reinterpret_cast<const uint16_t*>(meta)[blk], &fb);
    const float* lt = lut + (fb << BITS);
#pragma unroll
    for (int i = 0; i < QB; i += 2)
      dst[i / 2] = __floats2bfloat162_rn(lt[pb.code(i)] * sc,
                                         lt[pb.code(i + 1)] * sc);
  } else {
    const BlockScale s = block_scale(read_meta(meta, blk, f), f);
    const float* lt = lut + (s.fb << BITS);
#pragma unroll
    for (int i = 0; i < QB; i += 2) {
      const int c0 = pb.code(i), c1 = pb.code(i + 1);
      dst[i / 2] = __floats2bfloat162_rn(
          block_value(s, lt[c0], c0, i, BITS),
          block_value(s, lt[c1], c1, i + 1, BITS));
    }
  }
}

// The BITS bytes of 8 codes starting at byte p (any alignment), as the low
// 8 * BITS bits of the result.
template <int BITS>
__device__ __forceinline__ unsigned long long load_octet(
    const uint8_t* __restrict__ p) {
  unsigned long long w = 0ull;
#pragma unroll
  for (int j = 0; j < BITS; ++j) w |= (unsigned long long)__ldg(p + j) << (8 * j);
  return w;
}

// Code j of an octet read by load_octet.
template <int BITS>
__device__ __forceinline__ int octet_code(unsigned long long w, int j) {
  return (int)((w >> (j * BITS)) & ((1u << BITS) - 1u));
}

// Value j of an octet of a long block (see the note at the top): `m` is
// the octet's meta word, `i0` the octet's first position within its block.
// A symmetric format's value is its element value times the block scale,
// an activation format's the per-sign scale or the ox value.
template <int BITS, bool EX>
__device__ __forceinline__ void decode_octet(unsigned long long w, unsigned m,
                                             int i0, const float* lut,
                                             const FmtDesc& f, float* dst) {
  if (!EX || (!f.asym && !f.ox)) {
    int fb;
    const float sc = decode_scale(m & 0xFFFFu, &fb);
    const float* lt = lut + (fb << BITS);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[j] = lt[octet_code<BITS>(w, j)] * sc;
  } else {
    const BlockScale s = block_scale(m, f);
    const float* lt = lut + (s.fb << BITS);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = octet_code<BITS>(w, j);
      dst[j] = block_value(s, lt[c], c, i0 + j, BITS);
    }
  }
}

// Whether (bits, bs) has kernel instances that read whole blocks (the
// widths and block sizes of the main path); every other format a kernel
// takes runs its generic instance for the width.
__host__ __device__ __forceinline__ bool native_fmt(int bits, int bs) {
  return (bits == 4 || bits == 5 || bits == 6 || bits == 8) &&
         (bs == 16 || bs == 32);
}

// The code widths and block sizes of the generic instances.
__host__ __device__ __forceinline__ bool generic_fmt(int bits, int bs) {
  return bits >= 2 && bits <= 8 &&
         (bs == 8 || bs == 16 || bs == 32 || bs == 64 || bs == 128);
}

// log2 of a power-of-two block size.
__host__ __device__ __forceinline__ int log2_bs(int bs) {
  int l = 0;
  while ((1 << l) < bs) ++l;
  return l;
}

// Fill lut[2 << BITS] with decode_elem of every code, for fmt bit 0 and 1.
template <int BITS>
__device__ __forceinline__ void fill_lut(float* lut, const FmtDesc& f,
                                         int tid, int n_threads) {
  for (int i = tid; i < 2 << BITS; i += n_threads)
    lut[i] = decode_elem(i & ((1 << BITS) - 1), f.elem[i >> BITS]);
}

}  // namespace nxfp
