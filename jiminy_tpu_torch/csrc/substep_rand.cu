// The randomized whole-substep kernels (csrc/substep.cuh with JT_RAND true;
// the counterpart of the reference's `randomized` substep variant): the
// same 12 instantiations as csrc/substep.cu, each env reading its row of
// packed model parameters in place of the baked inertials, armature and
// (K2) motor gain and friction. Its entry points, the same as
// csrc/substep.cu's, require the model parameters.
#define JT_RAND true
#include "substep.cuh"
