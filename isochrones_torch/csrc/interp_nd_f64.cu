// Kernel B's and B''s float64 entry points, interp_nd_f64 and
// interp_nd_grad_f64: the kernels of interp_nd.cu, compiled in a translation
// unit of their own so that the float64 instantiations build beside the
// float32 ones, in parallel.

#define INTERP_F64_UNIT
#include "interp_nd.cu"
