// lattice_steps_fused_learned (K4 with a learned rule): K full lattice steps
// per launch with a learned turn rule, each env with its own params.
//
// Replaces the banded kernel of die_tpu/fast/pallas_step.py::
// make_pallas_banded_step with learned=True (params scalar-prefetched into
// SMEM).  The margin is K times learned_halo_radius (fast/cuda_step.py),
// which counts the wide and ctx rules' reach; the TPU kernel's halo_radius
// does not.  Plain twin: die_tpu_torch/fast/tiled.py::tiled_steps_plain
// with the rule of die_tpu_torch/fast/learned.py; the two agree bit for bit.
// The kernel is the FUSED instantiation of the template in lattice_step.cuh.
#include "lattice_step.cuh"

// Arguments as die_lattice_step_fused (lattice_step_fused.cu); family,
// tparams and member as die_lattice_step_learned.
extern "C" int die_lattice_step_fused_learned(const long long* ptrs,
                                              const int* ip, const float* fp,
                                              void* stream) {
  Params p;
  Buffers q;
  int n_dirs, family;
  if (!unpack(ptrs, ip, fp, &p, &q, &n_dirs, &family, true) ||
      family < kLinear || family > kCtx)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define DIE_FAMILIES(N)                                           \
  switch (family) {                                               \
    case kLinear: return (int)launch_fused<N, kLinear>(p, q, st); \
    case kMlp: return (int)launch_fused<N, kMlp>(p, q, st);       \
    case kWide: return (int)launch_fused<N, kWide>(p, q, st);     \
    default: return (int)launch_fused<N, kCtx>(p, q, st);         \
  }
  switch (n_dirs) {
    case 4: DIE_FAMILIES(4)
    case 8: DIE_FAMILIES(8)
    case 16: DIE_FAMILIES(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef DIE_FAMILIES
}
