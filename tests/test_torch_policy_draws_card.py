"""The ``policy_draws`` kernel on the card, bit for bit against its plain
versions (``ops/draws.py``), at the exact cell's shape (1024 keys x 65,536
slots) and at ragged shapes; one launch a draw.  Every test is marked
``cuda`` and skips without a card (run them there with ``python -m pytest
tests/test_torch_policy_draws_card.py -m cuda``)."""
import numpy as np
import pytest
import torch

from die_tpu_torch.core import channels as ch
from die_tpu_torch.core.rng import fold_in, np_key
from die_tpu_torch.fast import cuda_step
from die_tpu_torch.models.gradient import NOISE_SCALE
from die_tpu_torch.ops import draws


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _keys(seed: int, lead, device) -> torch.Tensor:
    """int64 key pairs ``lead + (2,)``: ``fold_in(key(seed), i)``."""
    n = int(np.prod(lead, dtype=np.int64))
    base = torch.from_numpy(np_key(seed).astype(np.int64)).to(device)
    ks = fold_in(base, torch.arange(n, dtype=torch.int64, device=device))
    return ks.reshape(tuple(lead) + (2,))


def _draw(keys, tag, n, normals):
    if normals:
        return (draws.draw_normals(keys, tag, n, NOISE_SCALE),
                draws.draw_normals_plain(keys, tag, n, NOISE_SCALE))
    return draws.draw_signs(keys, tag, n), draws.draw_signs_plain(keys, tag, n)


def _same_words(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("normals", (False, True), ids=("signs", "normals"))
@pytest.mark.parametrize("tag", (ch.TAG_DRAW_0, ch.TAG_DRAW_1))
@pytest.mark.parametrize("n", (1, 3, 1000, 1024, 4097))
@pytest.mark.parametrize("lead", ((), (3,), (16,), (2, 5)))
def test_kernel_is_the_plain_draw_on_ragged_shapes(cuda_device, lead, n,
                                                   tag, normals):
    keys = _keys(n + len(lead), lead, cuda_device)
    before = dict(cuda_step.launches)
    got, plain = _draw(keys, tag, n, normals)
    name = "policy_draws_normals" if normals else "policy_draws_signs"
    assert cuda_step.launches[name] - before[name] == 1
    torch.cuda.synchronize()
    assert _same_words(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("normals", (False, True), ids=("signs", "normals"))
def test_kernel_is_the_plain_draw_at_the_cell_shape(cuda_device, normals):
    """1024 keys x 65,536 slots, each draw at its own tag."""
    keys = _keys(2718, (1024,), cuda_device)
    tag = ch.TAG_DRAW_1 if normals else ch.TAG_DRAW_0
    got, plain = _draw(keys, tag, 65536, normals)
    torch.cuda.synchronize()
    assert _same_words(got, plain)
    if normals:   # the noise's scale: mean 0, standard deviation 0.4
        assert abs(float(got.mean())) < 1e-3
        assert abs(float(got.std()) - 0.4) < 1e-3


@pytest.mark.cuda
def test_keys_as_int32_words_and_an_empty_draw(cuda_device):
    """Keys given as int32 words (their low 32 bits read), and empty
    draws: no launch."""
    keys = _keys(5, (4,), cuda_device)
    words = (keys - (keys >= 2 ** 31).to(torch.int64) * 2 ** 32).to(
        torch.int32)
    assert _same_words(draws.draw_signs(words, ch.TAG_DRAW_0, 333),
                       draws.draw_signs_plain(keys, ch.TAG_DRAW_0, 333))
    before = sum(cuda_step.launches.values())
    assert draws.draw_normals(keys, 1, 0, NOISE_SCALE).shape == (4, 2, 0)
    assert draws.draw_signs(keys[:0], 0, 9).shape == (0, 9)
    assert sum(cuda_step.launches.values()) == before
