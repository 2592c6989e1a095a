"""The committed wide and ctx learned-rule artifacts replayed by
die_tpu_torch, bitwise against the JAX package's ``learned_fast_rollout``
over two held-out eval-protocol seeds on the CPU (the check of
``test_torch_artifacts.py``)."""
import pytest

from test_torch_artifacts import NAMES, check_replay, family


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if family(n) in ("wide", "ctx")])
def test_wide_artifact_replay_matches_jax(name):
    check_replay(name)
