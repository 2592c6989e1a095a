"""Lattice state init, batched over env keys (twin of the JAX package's
``fast_init_np``): masked Perlin food, thresholded-uniform occupancy, random
lattice headings and on-grid agent food, every draw folded from the env key
with the init tags of ``core/channels.py``.

:func:`fast_init` routes by device: on CUDA the state is one launch of the
``lattice_init`` kernel (``fast/cuda_step.py::lattice_init``);
:func:`fast_init_plain`, the eager version, is its plain version and what
the CPU runs."""
from __future__ import annotations

import torch

from die_tpu_torch.core import channels as ch
from die_tpu_torch.core.device import resolve_device
from die_tpu_torch.core.mathx import f32, round3
from die_tpu_torch.core.rng import (as_key_tensor, fold_in, random_bits,
                                    uniform01_from_bits)
from die_tpu_torch.fast.config import FastDynamics
from die_tpu_torch.fast.env import FastEnvState
from die_tpu_torch.ops.perlin import lattice_gradients, perlin_field
from die_tpu_torch.utils.profiling import INIT, annotate


def fast_init(keys, field_size, dyn: FastDynamics,
              device="cuda") -> FastEnvState:
    """State of one env per key pair in ``keys`` (uint32 ``[..., 2]``,
    numpy or torch): fields f32 ``[..., W, H]``, flow_step int32 ``[...]``.

    ``device`` defaults to ``"cuda"`` and raises when CUDA is absent; pass
    ``device="cpu"`` to run on the CPU (:func:`fast_init_plain`).  On CUDA:
    one kernel launch and no host sync (keys given as numpy take their one
    copy to the card; an empty batch launches nothing).  The kernel takes
    fields with both sides at least 2, ``H`` a multiple of 4 and at most
    2**31 - 1 cells, and ``init_food_octaves`` 1..15; any other field or
    ``dyn`` raises before any launch (``cuda_step.check_init_supported``),
    where the CPU takes it."""
    dev = resolve_device(device)
    with annotate(INIT):        # every draw and field of the batch
        if dev.type == "cpu":
            return fast_init_plain(keys, field_size, dyn, dev)
        from die_tpu_torch.fast import cuda_step

        return cuda_step.lattice_init(keys, field_size, dyn, dev)


def fast_init_plain(keys, field_size, dyn: FastDynamics,
                    device) -> FastEnvState:
    """:func:`fast_init` in eager torch on ``device``: the kernel's plain
    version."""
    W, H = field_size
    keys = as_key_tensor(keys, device)
    grads = lattice_gradients(fold_in(keys, ch.TAG_INIT_PERLIN),
                              dyn.init_food_octaves)
    perlin = perlin_field(grads, (W, H), dyn.init_food_octaves)
    u_occ = round3(uniform01_from_bits(random_bits(
        fold_in(keys, ch.TAG_INIT_OCCUPANCY), (W, H))))
    u_food = round3(uniform01_from_bits(random_bits(
        fold_in(keys, ch.TAG_INIT_FOOD_GRID), (W, H))))
    dir_bits = random_bits(fold_in(keys, ch.TAG_INIT_DIR), (W, H))

    thr = f32(dyn.init_food_threshold)
    env_food = perlin * ((perlin >= 0.0)
                         & (perlin <= thr)).to(torch.float32)
    ratio = f32(dyn.init_agent_ratio)
    occ = ((u_occ > 0.0) & (u_occ <= ratio)).to(torch.float32)
    dirf = (dir_bits & (dyn.num_dirs - 1)).to(torch.float32) * occ
    agent_food = (f32(0.9) * u_food + f32(0.1)) * occ
    return FastEnvState(
        occ=occ, dir=dirf, agent_food=agent_food, env_food=env_food,
        chem=torch.zeros_like(env_food),
        flow_step=torch.zeros(keys.shape[:-1], dtype=torch.int32,
                              device=device))
