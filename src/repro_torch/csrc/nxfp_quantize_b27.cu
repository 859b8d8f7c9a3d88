// The quantizer's 2- and 7-bit instances (BFP elements only, every block
// size; nxfp_quantize_kernels.cuh), in a file of their own so that nvcc
// compiles them in parallel with the main path's.
#include "nxfp_quantize_kernels.cuh"

namespace nxfpq {
NXFPQ_INSTANCES_27(NXFPQ_DECLARE)
}  // namespace nxfpq
