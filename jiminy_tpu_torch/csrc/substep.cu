// The nominal whole-substep kernels (csrc/substep.cuh with JT_RAND false):
// K3 and K2, flat ground or an analytic ground per env, K2 with or without
// the sensor stage, each in the ANYmal frame and the largest: 12
// instantiations in one library. Its entry points refuse model parameters;
// csrc/substep_rand.cu builds the randomized instantiations apart, so that
// nvcc compiles the two halves at once.
#define JT_RAND false
#include "substep.cuh"
