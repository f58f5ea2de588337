// The nominal library of csrc/substep.cuh built with JT_WARP_STAGES: K2's
// warp body also counts the cycles of each of its stages (clock64, summed
// over every env's warp; jt_stage_reset, jt_stage_read). A measuring build
// for jiminy_tpu_torch/tools/profile_warp_stages.py, never on an env path.

#define JT_RAND false
#define JT_WARP_STAGES
#include "substep.cuh"
