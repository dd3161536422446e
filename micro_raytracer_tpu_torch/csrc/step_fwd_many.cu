// step_fwd_many: the per-step forward's instances for scenes with more
// lights than a block stages in shared memory (kStagedLights; the rest are
// read from global memory): step_fwd.cu's source with MRT_STEP_FWD_MANY
// set, built as a library of its own so that it compiles beside
// step_fwd.cu's (ops/step.py takes it for such scenes; its entry points are
// step_fwd.cu's). See step_fwd.cu for what the kernels compute and what
// bounds them.
#define MRT_STEP_FWD_MANY 1
#include "step_fwd.cu"
