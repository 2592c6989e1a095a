"""Live plotting and GIF recording (twin of the JAX package's
``render/plotting.py``): a 2x2 grid of images whose artists are reused
frame to frame, an idle draw that pumps the event loop, and a
``FuncAnimation`` written through matplotlib's pillow writer.  matplotlib
is imported when a plotter is made, not with this module."""
from __future__ import annotations

from itertools import chain
from typing import Callable, Optional, Sequence

import numpy as np

ImagesType = Sequence[np.ndarray]
RendererCallable = Callable[[], ImagesType]


class InteractivePlotter:
    @staticmethod
    def get(env_render: RendererCallable,
            agent_render: Optional[RendererCallable] = None,
            **kwargs) -> "InteractivePlotter":
        renderers = [env_render]
        if agent_render is not None:
            renderers.append(agent_render)
        return InteractivePlotter(*renderers, **kwargs)

    def __init__(self, *renderers: RendererCallable, size: float = 6,
                 aspect: float = 1.0, ion: bool = True):
        import matplotlib.pyplot as plt

        self._plt = plt
        self._renderers = renderers
        images = self._render_images()
        ncells = 4
        figsize = (size * aspect * 2, size * 2)
        self.fig, axs = plt.subplots(nrows=2, ncols=2, figsize=figsize)
        self._axes = list(axs.ravel())[:ncells]
        for ax in self._axes:
            ax.tick_params(axis="both", which="both", bottom=False,
                           labelbottom=False, left=False, labelleft=False)
        self.fig.tight_layout()
        self._artists = []
        for ax, img in zip(self._axes, images):
            self._artists.append(None if img is None else ax.imshow(img))
        if ion:
            plt.ion()
            plt.show()

    def _render_images(self) -> ImagesType:
        return list(chain(*(render() for render in self._renderers)))

    def update(self) -> None:
        for img, artist in zip(self._render_images(), self._artists):
            if img is None or artist is None:
                continue
            artist.set_data(img)

    def draw(self) -> None:
        self.update()
        self.fig.canvas.draw_idle()
        self.fig.canvas.start_event_loop(0.001)


def render_animation(frame_step: Callable[[int], None],
                     plotter: InteractivePlotter,
                     filename: Optional[str] = None,
                     num_frames: int = 100,
                     interval_ms: int = 40,
                     fps: int = 10,
                     dpi: int = 100):
    """Record ``num_frames`` frames: ``frame_step(i)`` advances the
    simulation one or more steps, then the plotter's renderers read the
    new state.  With ``filename`` the animation is saved (a ``.gif``
    through the pillow writer)."""
    from matplotlib.animation import FuncAnimation

    def _frame(i):
        frame_step(i)
        plotter.update()

    anim = FuncAnimation(fig=plotter.fig, func=_frame,
                         save_count=num_frames, interval=interval_ms)
    if filename:
        anim.save(filename, fps=fps, dpi=dpi)
    return anim
