// lattice_step_learned (K3): one full lattice step with a learned turn rule
// in place of the Jones argmax, for a lockstep batch of envs that may each
// run their own params (an ES population in one launch).
//
// Replaces die_tpu/fast/pallas_step.py::_multi_step_kernel_learned (params
// in SMEM, vmapped over the population) and, with the flow field operand,
// _multi_step_kernel_perlin_learned, one step per launch (K = 1).  The
// rule is die_tpu/fast/learned.py::make_turn_rule's: linear f32[3, 7],
// per-cell MLP [h+3, max(8, h+1)], wide MLP [h+3, 14] (13 features with the
// chem probes at 2*sense_dist and the env_food probes at sense_dist) and
// ctx [7+h+3, 21] (wide plus 7 depthwise 3x3 taps over the base features).
// Its plain twin is die_tpu_torch/fast/env.py::fast_step_full with the rule
// of die_tpu_torch/fast/learned.py; the two agree bit for bit.
//
// The kernel is lattice_persistent.cuh's, the rule family a template
// parameter (FAM), so every phase after the turn is K1's code; this file
// instantiates the four learned families for 4, 8 and 16 directions.  The
// halo counts the rule's reach (learned_halo_radius in fast/cuda_step.py),
// which the JAX package's halo_radius does not.
#include "lattice_persistent.cuh"

// Arguments as die_lattice_step (lattice_step.cu); family is 1 linear,
// 2 MLP, 3 wide, 4 ctx, and tparams [P, rows, cols] with member [B] give
// env b the params tparams[member[b]].
extern "C" int die_lattice_step_learned(const long long* ptrs, const int* ip,
                                        const float* fp, void* stream) {
  return run_entry<false, true>(ptrs, ip, fp, stream);
}
