// lattice_step: the field-centric lattice engine's step, every form, for a
// lockstep batch of envs, f32 [B, W, H] per state field (W, H powers of
// 2), with flow none, wave (evaluated in-kernel) or a precomputed field
// (perlin).  One entry point; the rule is the family word's:
// - K1: one step with the Jones rule.  Replaces die_tpu/fast/
//   pallas_step.py::_multi_step_kernel (body _multi_step_kernel_body,
//   launched by make_pallas_multi_step through pl.pallas_call) and, with
//   the flow field, _multi_step_kernel_perlin, one step per launch (K = 1).
//   Plain twin: die_tpu_torch/fast/env.py::fast_step_full.
// - K3: one step with a learned turn rule in place of the Jones argmax,
//   each env with its own params (an ES population in one launch).
//   Replaces _multi_step_kernel_learned (params in SMEM, vmapped over the
//   population) and, with the flow field, _multi_step_kernel_perlin_learned.
//   The rule is die_tpu/fast/learned.py::make_turn_rule's: linear f32[3, 7],
//   per-cell MLP [h+3, max(8, h+1)], wide MLP [h+3, 14] (13 features with
//   the chem probes at 2*sense_dist and the env_food probes at sense_dist)
//   and ctx [7+h+3, 21] (wide plus 7 depthwise 3x3 taps over the base
//   features).  Plain twin: fast_step_full with the rule of
//   die_tpu_torch/fast/learned.py.
// - K4: K fused steps per launch, Jones or learned, for fields of any
//   power-of-two size: the large-field kernel.  Replaces the banded kernel
//   of make_pallas_banded_step (its inner `kernel`, launched through
//   pl.pallas_call over a grid of (env, row band); learned=True with params
//   scalar-prefetched into SMEM): num_inner fused steps on a block padded
//   by num_inner halos, bits from global cell indices
//   (_kernel_bits_banded), a flow field per inner step.  Plain twin:
//   die_tpu_torch/fast/tiled.py::tiled_steps_plain, which agrees with K
//   whole-field steps of fast_step_full.  In place of the TPU kernel's row
//   bands, double-buffered DMA and 8-row rounding stand 2-D tiles walked by
//   a persistent grid, an exact margin (columns rounded to the copy width)
//   and the host's shared-memory plan (fast/cuda_step.py::step_plan),
//   which refuses a (config, K, tile) that does not fit.
// Each form agrees with its plain twin bit for bit.  The kernel is
// lattice_persistent.cuh's, the rule family a template parameter (FAM), so
// every phase after the turn is K1's code; its bound (bytes: 44 a cell at
// K = 1, 4 * (10 + K) fused) and its design are noted there.  The halo
// counts the rule's reach (learned_halo_radius in fast/cuda_step.py), which
// the JAX package's halo_radius does not.
#include "lattice_persistent.cuh"

// ptrs: occ, dir, agent_food, env_food, chem, keys [B, K, 2], flow_t
//   [B, K], flow_f ([K, W, H] or [B, K, W, H]), tparams [P, rows, cols],
//   member [B] (env b runs tparams[member[b]]), occ_o, dir_o, agent_food_o,
//   env_food_o, chem_o, gained_o [K, B, W, H], num_o [B, K], turned
//   heading [B, W, H] (a turn pass's; 0 elsewhere).
// ip: B, W, H, num_dirs, threefry, per_cell_priority, randomize_on_block,
//   agents_born, agents_die, food_infinite, flow_kind (0 none, 1 wave,
//   2 field), sense_dist, ntaps, halo (one step's), reach, flow_env_stride,
//   family (0 Jones, 1 linear, 2 MLP, 3 wide, 4 ctx), rows, cols, hidden,
//   then the plan (fast/cuda_step.py::StepPlan.words): tile rows, tile
//   cols, column margin, floats a copy, threads, blocks, input buffers (2:
//   the next item loads during this one; 1: each item loads before its
//   phases), inner steps K; then a turn pass's plan (8 words, zero but in
//   a wide or ctx rule's one step).
// fp: idle_deposit, deposit_coef, rate_feed, cost_move, cost_deposit,
//   death_threshold, birth_threshold, flow_scale, flow_keep, chem_keep,
//   inv_wm1, inv_hm1, taps[ntaps].
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int die_lattice_step(const long long* ptrs, const int* ip,
                                const float* fp, void* stream) {
  return run_entry(ptrs, ip, fp, stream);
}
