// The forward-model kernel's float64 entry point, generate_f64: the kernel
// of generate.cu, compiled in a translation unit of its own so that its
// float64 instantiations build beside the float32 ones, in parallel.

#define GENERATE_F64_UNIT
#include "generate.cu"
