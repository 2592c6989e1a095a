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
// The kernel is the FUSED instantiation of the template in lattice_step.cuh,
// where its bound (bytes, 4 * (10 + K) a cell) and its design are noted.
#include "lattice_step.cuh"

// ptrs: as die_lattice_step (lattice_step.cu), with keys [B, K, 2],
//   flow_t [B, K], flow_f [K, W, H] (flow_env_stride 0) or [B, K, W, H],
//   gained_o [K, B, W, H] and num_o [B, K].
// ip: as die_lattice_step with halo the ONE-step halo, then K, tile rows,
//   tile cols.  fp: as die_lattice_step.
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int die_lattice_step_fused(const long long* ptrs, const int* ip,
                                      const float* fp, void* stream) {
  Params p;
  Buffers q;
  int n_dirs, family;
  if (!unpack(ptrs, ip, fp, &p, &q, &n_dirs, &family, true) ||
      family != kJones)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (n_dirs) {
    case 4: return (int)launch_fused<4, kJones>(p, q, st);
    case 8: return (int)launch_fused<8, kJones>(p, q, st);
    case 16: return (int)launch_fused<16, kJones>(p, q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
