"""die_tpu_torch's plain lattice step against the JAX package's independent
naive oracle (``die_tpu/oracle/fast_naive.py``, a dict-of-agents, per-cell
restatement of the step that shares only the RNG bit contract), bitwise on
the CPU, over the configs and the seeded fuzz of ``tests/test_fast_naive.py``."""
import numpy as np
import pytest
import torch

from die_tpu.core.config import FlowConfig
from die_tpu.core.rng import np_key
from die_tpu.fast.config import FastDynamics as JD
from die_tpu.fast.init import fast_init_np
from die_tpu.oracle.fast_naive import naive_fast_rollout

from die_tpu_torch.fast.config import FastDynamics as TD
from die_tpu_torch.fast.env import FastEnvState
from die_tpu_torch.fast.rollout import fast_rollout

FIELDS = ("occ", "dir", "agent_food", "env_food", "chem")
SIZE = (16, 16)


def fuzz_configs():
    """The six seeded random configs of the JAX package's fuzz test, drawn
    in its order from its seed."""
    rng = np.random.RandomState(2026)
    out = []
    for _ in range(6):
        kw = dict(
            num_dirs=int(rng.choice([4, 8, 16])),
            sense_dist=int(rng.randint(1, 5)),
            randomize_on_block=bool(rng.randint(2)),
            per_cell_priority=bool(rng.randint(2)),
            deposit_coef=float(np.float32(rng.uniform(0.0, 6.0))),
            idle_deposit=float(np.float32(rng.uniform(0.0, 0.5))),
            rate_feed=float(np.float32(rng.uniform(0.0, 0.5))),
            cost_move=float(np.float32(rng.uniform(0.0, 0.1))),
            cost_deposit=float(np.float32(rng.uniform(0.0, 0.1))),
            food_infinite=bool(rng.randint(2)),
            agents_die=bool(rng.randint(2)),
            agents_born=bool(rng.randint(2)),
            birth_threshold=float(np.float32(rng.uniform(0.1, 1.0))),
            rng_kind=str(rng.choice(["murmur", "threefry"])),
            init_agent_ratio=float(np.float32(rng.uniform(0.05, 0.4))),
        )
        if rng.randint(2):
            kw["flow"] = FlowConfig(
                kind="wave", scale=float(np.float32(rng.uniform(0, 1))),
                decay=float(np.float32(rng.uniform(0, 1))))
        out.append(JD(**kw))
    return out


CONFIGS = {
    # name: (dynamics, steps, seed, key)
    **{f"defaults_{n}dir": (JD(num_dirs=n), 10, 7, 11) for n in (4, 8, 16)},
    **{f"births_{n}dir": (JD(num_dirs=n, agents_born=True,
                             birth_threshold=0.2, rate_feed=0.5,
                             food_infinite=True, init_agent_ratio=0.1),
                          12, 7, 11) for n in (4, 8, 16)},
    "deaths": (JD(agents_die=True, rate_feed=0.0, cost_move=0.5,
                  deposit_coef=2.0, cost_deposit=0.3), 12, 7, 11),
    "wave_flow": (JD(flow=FlowConfig(kind="wave", scale=0.5, decay=0.5)),
                  10, 7, 11),
    "scalar_priority_no_reblock": (JD(per_cell_priority=False,
                                      randomize_on_block=False), 10, 7, 11),
    "threefry": (JD(rng_kind="threefry"), 10, 7, 11),
    **{f"fuzz_{i}": (jd, 8, 100 + i, 200 + i)
       for i, jd in enumerate(fuzz_configs())},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_step_matches_naive_oracle(name):
    jd, steps, seed, key = CONFIGS[name]
    st = fast_init_np(np_key(seed), SIZE, jd)
    n_state, n_rewards, n_nums = naive_fast_rollout(jd, st, np_key(key),
                                                    steps)
    tst = FastEnvState(
        *(torch.from_numpy(np.array(getattr(st, f), np.float32))[None]
          for f in FIELDS),
        flow_step=torch.zeros(1, dtype=torch.int32))
    out, rew, num = fast_rollout(TD.from_json(jd.to_json()), tst,
                                 np_key(key)[None], steps, device="cpu")
    assert np.array_equal(np.asarray(n_rewards, np.float32).view(np.uint32),
                          rew[0].numpy().view(np.uint32))
    assert np.array_equal(np.asarray(n_nums), num[0].numpy())
    for f in FIELDS:
        a = np.asarray(getattr(n_state, f), np.float32)
        b = getattr(out, f)[0].numpy()
        # bitwise: tells -0.0 from 0.0 and NaN payloads apart
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), f
    if name.startswith("births"):
        assert n_nums[-1] > n_nums[0], "vacuous: no births occurred"
    if name == "deaths":
        assert n_nums[-1] < n_nums[0], "vacuous: no deaths occurred"
