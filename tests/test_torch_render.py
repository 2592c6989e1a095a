"""The port's render modules against the JAX package's, on the CPU: each
view of ``EnvRenderer`` (colour maps ``rgb``, ``one``, ``two``),
``FieldTrace``, ``GradientFieldRenderer``, ``GradientPolicy.render`` and
the lattice adapter's views, bit for bit, on states from a seed carried
across by ``core/convert.py`` and ``fast/convert.py``; tensors in place of
arrays; and a GIF through ``render_animation``."""
import matplotlib

matplotlib.use("Agg")

import jax.random as jr  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from die_tpu.core.config import Dynamics as JDynamics  # noqa: E402
from die_tpu.core.init import init_env_state as j_init  # noqa: E402
from die_tpu.fast import render_adapter as jadapt  # noqa: E402
from die_tpu.fast.config import FastDynamics as JFD  # noqa: E402
from die_tpu.fast.init import fast_init_np  # noqa: E402
from die_tpu.fast.rollout import oracle_fast_rollout  # noqa: E402
from die_tpu.models.gradient import GradientPolicy as JGradient  # noqa: E402
from die_tpu.models.gradient import PhysarumPolicy as JPhysarum  # noqa: E402
from die_tpu.core.rng import np_key  # noqa: E402
from die_tpu.render import renderer as jren  # noqa: E402

from die_tpu_torch.core.convert import env_state_from_numpy  # noqa: E402
from die_tpu_torch.fast import render_adapter as tadapt  # noqa: E402
from die_tpu_torch.fast.convert import state_from_numpy  # noqa: E402
from die_tpu_torch.models.gradient import (GradientPolicy,  # noqa: E402
                                           PhysarumPolicy)
from die_tpu_torch.render import renderer as tren  # noqa: E402
from die_tpu_torch.render.plotting import (InteractivePlotter,  # noqa: E402
                                           render_animation)
from helpers.torch_threads import one_torch_thread  # noqa: F401,E402

SIZE = (16, 24)


def _same(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, msg
    assert a.tobytes() == b.tobytes(), msg


def _exact_states(n=3):
    """JAX exact states of ``n`` seeds, with non-zero chem, and their port
    twins (unbatched, on the CPU)."""
    out = []
    for s in range(n):
        st = j_init(jr.PRNGKey(4 + s), SIZE, JDynamics(init_agent_ratio=0.2))
        rng = np.random.default_rng(s)
        medium = np.array(st.medium)
        medium[2] = rng.random(SIZE, dtype=np.float32)
        st = st._replace(medium=medium)
        out.append((st, env_state_from_numpy(st, device="cpu")))
    return out


@pytest.mark.parametrize("colors", ["rgb", "one", "two"])
def test_env_renderer_views_match_reference(colors):
    """Three frames in a row (the trace carries over), each view bitwise."""
    ref = jren.EnvRenderer(SIZE, field_colors_id=colors)
    port = tren.EnvRenderer(SIZE, field_colors_id=colors)
    for jst, tst in _exact_states():
        want = ref.render(np.asarray(jst.medium), np.asarray(jst.agents))
        got = port.render(tst.medium, tst.agents)
        assert len(got) == 3
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"view {i}")


def test_tensors_in_place_of_arrays():
    jst, tst = _exact_states(1)[0]
    a = tren.EnvRenderer(SIZE).render(tst.medium, tst.agents)
    b = tren.EnvRenderer(SIZE).render(tst.medium.numpy(), tst.agents.numpy())
    for x, y in zip(a, b):
        _same(x, y)
    tr, tr_np = tren.FieldTrace(SIZE), tren.FieldTrace(SIZE)
    for _ in range(2):
        tr.update(tst.medium[0])
        tr_np.update(tst.medium[0].numpy())
    _same(tr.trace, tr_np.trace)
    gx = torch.linspace(-2, 2, SIZE[0] * SIZE[1]).reshape(SIZE)
    _same(tren.GradientFieldRenderer.render(gx, -gx),
          tren.GradientFieldRenderer.render(gx.numpy(), (-gx).numpy()))


def test_field_trace_matches_reference():
    ref, port = jren.FieldTrace(SIZE, 5), tren.FieldTrace(SIZE, 5)
    rng = np.random.default_rng(1)
    for _ in range(4):
        f = rng.random(SIZE, dtype=np.float32)
        ref.update(f)
        port.update(torch.from_numpy(f))
        _same(port.trace, ref.trace)
    _same(port.as_mask(inverse=True), ref.as_mask(inverse=True))


def test_gradient_field_renderer_matches_reference():
    rng = np.random.default_rng(2)
    gx = (rng.random(SIZE, dtype=np.float32) - 0.5) * 3
    gy = (rng.random(SIZE, dtype=np.float32) - 0.5) * 3
    _same(tren.GradientFieldRenderer.render(torch.from_numpy(gx),
                                            torch.from_numpy(gy)),
          jren.GradientFieldRenderer.render(gx, gy))


@pytest.mark.parametrize("cls", ["gradient", "physarum"])
def test_gradient_policy_render_matches_reference(cls):
    tcls, jcls = {"gradient": (GradientPolicy, JGradient),
                  "physarum": (PhysarumPolicy, JPhysarum)}[cls]
    n = SIZE[0] * SIZE[1]
    states = _exact_states(2)
    for jst, tst in states:
        want = jcls(max_agents=n).render((jst.agents, jst.medium))
        got = tcls(max_agents=n).render((tst.agents, tst.medium))
        assert len(got) == len(want) == 1
        _same(got[0], want[0])
    # a batch gives one image per env
    batch = (torch.stack([t.agents for _, t in states]),
             torch.stack([t.medium for _, t in states]))
    imgs = tcls(max_agents=n).render(batch)
    assert len(imgs) == 2
    for img, (jst, _) in zip(imgs, states):
        _same(img, jcls(max_agents=n).render((jst.agents, jst.medium))[0])


def _fast_state(seed=6):
    jd = JFD(init_agent_ratio=0.3)
    st, _, _ = oracle_fast_rollout(jd, fast_init_np(np_key(seed), SIZE, jd),
                                   np_key(seed + 1), 3)
    return st, state_from_numpy(st, device="cpu")


def test_adapter_views_match_reference():
    jst, tst = _fast_state()
    _same(tadapt.fast_state_to_medium(tst), jadapt.fast_state_to_medium(jst))
    _same(tadapt.fast_state_to_agents(tst), jadapt.fast_state_to_agents(jst))
    # numpy fields too
    _same(tadapt.fast_state_to_agents(jst), jadapt.fast_state_to_agents(jst))
    holder = {"t": tst}
    got = tadapt.make_fast_render_fn(lambda: holder["t"],
                                     tren.EnvRenderer(SIZE))()
    want = jadapt.make_fast_render_fn(lambda: jst, jren.EnvRenderer(SIZE))()
    for g, w in zip(got, want):
        _same(g, w)


def test_render_animation_writes_gif(tmp_path):
    jst, tst = _fast_state()
    renderer = tren.EnvRenderer(SIZE)
    holder = {"s": tst, "frames": 0}

    def frame_step(i):
        holder["frames"] += 1
        holder["s"] = holder["s"]._replace(chem=holder["s"].chem * 0.5)

    plotter = InteractivePlotter.get(
        tadapt.make_fast_render_fn(lambda: holder["s"], renderer), ion=False)
    out = tmp_path / "anim.gif"
    render_animation(frame_step, plotter, str(out), num_frames=3)
    assert out.exists() and out.stat().st_size > 0
    from PIL import Image

    with Image.open(out) as im:
        assert im.n_frames == 3
    assert holder["frames"] >= 3
