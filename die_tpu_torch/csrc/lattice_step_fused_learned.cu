// lattice_steps_fused_learned (K4 with a learned rule): K full lattice steps
// per launch with a learned turn rule, each env with its own params.
//
// Replaces the banded kernel of die_tpu/fast/pallas_step.py::
// make_pallas_banded_step with learned=True (params scalar-prefetched into
// SMEM).  The margin is K times learned_halo_radius (fast/cuda_step.py),
// which counts the wide and ctx rules' reach; the TPU kernel's halo_radius
// does not.  Plain twin: die_tpu_torch/fast/tiled.py::tiled_steps_plain
// with the rule of die_tpu_torch/fast/learned.py; the two agree bit for bit.
// The kernel is lattice_persistent.cuh's.
#include "lattice_persistent.cuh"

// Arguments as die_lattice_step_fused (lattice_step_fused.cu); family,
// tparams and member as die_lattice_step_learned.
extern "C" int die_lattice_step_fused_learned(const long long* ptrs,
                                              const int* ip, const float* fp,
                                              void* stream) {
  return run_entry<false, false>(ptrs, ip, fp, stream);
}
