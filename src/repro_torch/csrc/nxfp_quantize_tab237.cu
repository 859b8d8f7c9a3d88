// The quantizer's table-driven instances without code recycling (KIND_TAB)
// for 2-, 3- and 7-bit codes at every block size
// (nxfp_quantize_kernels.cuh), in a file of their own so that nvcc compiles
// them in parallel with the main path's.
#include "nxfp_quantize_kernels.cuh"

namespace nxfpq {
NXFPQ_INSTANCES_TAB237(NXFPQ_DECLARE)
}  // namespace nxfpq
