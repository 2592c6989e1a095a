"""``mesh=`` of the port's three trainers on 2 and 4 gloo ranks on the CPU:
``fast/learned.py::train_lattice`` at ``tests/test_learned_lattice.py:173``'s
configuration, ``fast/nca.py::train_conv_nca`` and ``learn/train.py::train``
(the exact engine's NCA policy): on every rank the history, the best and
the ES state after the last ``tell`` bitwise the port's one-process run;
``train_lattice``'s history against the JAX package's to the ES tolerance
(rtol 1e-5).  ``learn/es.py::shard_population`` slices contiguous members
and raises where the rank count does not divide the population."""
import functools
import json

import numpy as np
import pytest
import torch

from die_tpu_torch.learn.es import shard_population, unshard_population
from die_tpu_torch.parallel.mesh import Mesh, env_mesh
from helpers.torch_exact import assert_bits
from helpers.torch_mesh import (LATTICE, conv_run, exact_train_run,
                                lattice_run, load, run_clusters,
                                train_record)
from helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORLDS = (2, 4)
RUNS = {"train_lattice": lattice_run, "train_conv": conv_run,
        "train_exact": exact_train_run}


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    return run_clusters(tmp_path_factory.mktemp("train"), WORLDS,
                        list(RUNS))


@functools.lru_cache(maxsize=None)
def one_process(case):
    return train_record(*RUNS[case](None))


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", list(RUNS))
def test_sharded_training_is_the_one_process_run(clusters, case, n):
    want = one_process(case)
    for r in range(n):
        got = load(clusters[n], case, r)
        assert sorted(got) == sorted(want)
        assert json.loads(str(got["history"])) == \
            json.loads(str(want["history"])), (case, r)
        for k in want:
            if k != "history":
                assert_bits(got[k], want[k], f"{case} {k}, rank {r}")


def test_train_lattice_history_against_jax():
    """The one-process run the sharded ones equal, against the JAX
    package's run of the same configuration (whose own sharded run is its
    unsharded one, tests/test_learned_lattice.py:173)."""
    from die_tpu.fast.config import FastDynamics
    from die_tpu.fast.learned import LatticeTrainConfig, train_lattice

    _, _, j_hist = train_lattice(FastDynamics(food_infinite=True),
                                 LatticeTrainConfig(**LATTICE))
    hist = json.loads(str(one_process("train_lattice")["history"]))
    assert [h["epoch"] for h in hist] == [h["epoch"] for h in j_hist]
    for h, j in zip(hist, j_hist):
        for k in ("best", "mean"):
            np.testing.assert_allclose(h[k], float(j[k]), rtol=1e-5,
                                       atol=1e-6)


def test_shard_population_slices_members_and_checks_the_divisor():
    pop = torch.arange(16).reshape(8, 2)
    assert shard_population(None, "pop", pop) is pop
    assert unshard_population(None, pop) is pop
    one = env_mesh(axis="pop", device="cpu")
    assert torch.equal(unshard_population(one, pop), pop)
    mesh = Mesh(None, "pop", 4, 2, torch.device("cpu"))
    a, b = shard_population(mesh, "pop", pop, pop * 10)
    assert torch.equal(a, pop[4:6]) and torch.equal(b, pop[4:6] * 10)
    with pytest.raises(ValueError, match="population"):
        shard_population(Mesh(None, "pop", 3, 0, torch.device("cpu")),
                         "pop", pop)
