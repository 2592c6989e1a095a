// lattice_steps_fused (K4): K full steps of the field-centric lattice engine
// per launch with the Jones turn rule, for a lockstep batch of envs and
// fields of any power-of-two size: the large-field kernel.
//
// Replaces the banded kernel of die_tpu/fast/pallas_step.py::
// make_pallas_banded_step (its inner `kernel`, launched through
// pl.pallas_call over a grid of (env, row band)): num_inner fused steps on a
// block padded by num_inner halos, bits from global cell indices
// (_kernel_bits_banded), a flow field per inner step.  The plain twin is
// die_tpu_torch/fast/tiled.py::tiled_steps_plain; the two agree bit for bit,
// and both agree with K whole-field steps of fast/env.py::fast_step_full.
// In place of the TPU kernel's row bands, double-buffered DMA and 8-row
// rounding stand 2-D tiles walked by a persistent grid, an exact margin
// (columns rounded to the copy width) and the host's shared-memory plan
// (fast/cuda_step.py::step_plan), which refuses a (config, K, tile) that
// does not fit.  The kernel is lattice_persistent.cuh's, where its bound
// (bytes, 4 * (10 + K) a cell) and its design are noted; at K = 1 it runs
// K1's schedule.
#include "lattice_persistent.cuh"

// ptrs: as die_lattice_step (lattice_step.cu), with keys [B, K, 2],
//   flow_t [B, K], flow_f [K, W, H] (flow_env_stride 0) or [B, K, W, H],
//   gained_o [K, B, W, H] and num_o [B, K].
// ip, fp: as die_lattice_step, with K inner steps (ip[27]).
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int die_lattice_step_fused(const long long* ptrs, const int* ip,
                                      const float* fp, void* stream) {
  return run_entry<true, false>(ptrs, ip, fp, stream);
}
