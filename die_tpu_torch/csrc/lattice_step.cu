// lattice_step (K1): one full step of the field-centric lattice engine with
// the Jones turn rule, for a lockstep batch of envs, f32 [B, W, H] per state
// field (W, H powers of 2), with flow none, wave (evaluated in-kernel) or a
// precomputed field (perlin).
//
// Replaces die_tpu/fast/pallas_step.py::_multi_step_kernel (body
// _multi_step_kernel_body, launched by make_pallas_multi_step through
// pl.pallas_call) and, with the flow field, _multi_step_kernel_perlin, one
// step per launch (K = 1).  Its plain twin is
// die_tpu_torch/fast/env.py::fast_step_full; the two agree bit for bit.
//
// The kernel is lattice_persistent.cuh's, with the Jones rule at K = 1,
// where its bound (bytes, 44 a cell) and its design are noted.
#include "lattice_persistent.cuh"

// ptrs: occ, dir, agent_food, env_food, chem, keys [B, 2], flow_t [B],
//   flow_f ([W, H] or [B, W, H]), tparams, member, occ_o, dir_o,
//   agent_food_o, env_food_o, chem_o, gained_o [B, W, H], num_o [B],
//   turned heading [B, W, H] (the learned one-step entry's turn pass; 0
//   elsewhere).
// ip: B, W, H, num_dirs, threefry, per_cell_priority, randomize_on_block,
//   agents_born, agents_die, food_infinite, flow_kind (0 none, 1 wave,
//   2 field), sense_dist, ntaps, halo (one step's), reach, flow_env_stride,
//   family, rows, cols, hidden, then the plan (fast/cuda_step.py::
//   StepPlan.words): tile rows, tile cols, column margin, floats a copy,
//   threads, blocks, input buffers (2: the next item loads during this one;
//   1: each item loads before its phases), inner steps (1 here); then a
//   turn pass's plan (8 words, zero but in the learned one-step entry).
// fp: idle_deposit, deposit_coef, rate_feed, cost_move, cost_deposit,
//   death_threshold, birth_threshold, flow_scale, flow_keep, chem_keep,
//   inv_wm1, inv_hm1, taps[ntaps].
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int die_lattice_step(const long long* ptrs, const int* ip,
                                const float* fp, void* stream) {
  return run_entry<true, true>(ptrs, ip, fp, stream);
}

extern "C" const char* die_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
