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
// The kernel itself, its bound and its design are in lattice_step.cuh,
// shared with the learned-rule kernel (lattice_step_learned.cu).
#include "lattice_step.cuh"

// ptrs: occ, dir, agent_food, env_food, chem, keys, flow_t, flow_f,
//   tparams, member, occ_o, dir_o, agent_food_o, env_food_o, chem_o,
//   gained_o, num_o.
// ip: B, W, H, num_dirs, threefry, per_cell_priority, randomize_on_block,
//   agents_born, agents_die, food_infinite, flow_kind (0 none, 1 wave,
//   2 field), sense_dist, ntaps, halo, reach, flow_env_stride, family,
//   rows, cols, hidden.
// fp: idle_deposit, deposit_coef, rate_feed, cost_move, cost_deposit,
//   death_threshold, birth_threshold, flow_scale, flow_keep, chem_keep,
//   inv_wm1, inv_hm1, taps[ntaps].
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int die_lattice_step(const long long* ptrs, const int* ip,
                                const float* fp, void* stream) {
  Params p;
  Buffers q;
  int n_dirs, family;
  if (!unpack(ptrs, ip, fp, &p, &q, &n_dirs, &family) || family != kJones)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (n_dirs) {
    case 4: return (int)launch<4, kJones>(p, q, st);
    case 8: return (int)launch<8, kJones>(p, q, st);
    case 16: return (int)launch<16, kJones>(p, q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* die_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
