// The tree kernels' float64 entry points, tree_lnlike_f64 and
// tree_lnlike_grad_f64: the kernels of tree_lnlike.cu, compiled in a
// translation unit of their own so that the float64 instantiations build
// beside the float32 ones, in parallel.

#define TREE_F64_UNIT
#include "tree_lnlike.cu"
