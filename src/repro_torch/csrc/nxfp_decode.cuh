// NxFP field decode shared by the CUDA kernels (symmetric formats).
//
// Device twin of the reference's kernels/decode_lib.py (decode_elem,
// decode_scale) and of the port's plain kernels/decode_lib.py. Values are
// exact in f32 (power-of-two assembly, no transcendentals), so the device
// decode is bitwise equal to the plain PyTorch dequantize.
//
// Code i of a packed block sits at bit offset i*bits, little-endian, and
// straddles at most two bytes: one read serves 4/5/6/8-bit widths and any
// block count (the two-block pack tile of the TPU kernels is not needed).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace nxfp {

// One element format, as the host describes it (kernels/build.py).
struct ElemDesc {
  int bits;    // code width
  int is_bfp;  // 1: sign-magnitude integer, 0: sign/exponent/mantissa
  int ebits;
  int mbits;
  int bias;
  int cr;      // code recycling: 10...0 decodes to -smallest/2
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
  float val, smallest;
  if (f.is_bfp) {
    val = (float)mag;
    smallest = 1.0f;
  } else {
    const int e = mag >> f.mbits;
    const float m = (float)(mag & ((1 << f.mbits) - 1)) * pow2i(-f.mbits);
    const float sub = m * pow2i(1 - f.bias);
    const float nrm = (1.0f + m) * pow2i(e - f.bias);
    val = e == 0 ? sub : nrm;
    if (f.ebits == 4 && f.mbits == 3 && mag == 127) val = 0.0f;  // e4m3 NaN
    smallest = pow2i(-f.mbits) * pow2i(1 - f.bias);
  }
  if (sign) val = -val;
  if (f.cr && c == (1 << (f.bits - 1))) val = -0.5f * smallest;
  return val;
}

// uint16 meta word -> scale (1 + nano/4) * 2**E and the format bit.
__device__ __forceinline__ float decode_scale(int meta, int* fmt_bit) {
  const int e_shared = (meta & 0xFF) - 128;
  const int nano = (meta >> 8) & 0x3;
  *fmt_bit = (meta >> 10) & 0x1;
  return (1.0f + (float)nano * 0.25f) * pow2i(e_shared);
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

}  // namespace nxfp
