"""User-extensible operator registries: custom action-cost and food-flow
rules without editing the package (twin of the JAX package's
``core/operators.py``, same function names and errors).

Configs are frozen and hashable, so operators are referenced by name: a
config carries a string, the registry maps it to a callable.  Registration
happens when the user's module is imported, so a config JSON round-trips as
long as the same modules are imported on load.

Where the JAX package passes ``xp`` (``numpy`` or ``jax.numpy``), this
package passes the ``torch`` module, and the registered callable is written
with torch operations on tensors that carry the batch:

* cost operator, instead of the built-in linear cost::

      fn(torch, dynamics, action) -> burned    # f32[..., N]

  ``action`` arrives channel-first, ``f32[3, ..., N]``, so that
  ``action[0]``, ``action[1]``, ``action[2]`` are dx, dy and deposit as in
  the JAX package.  Select it with ``Dynamics(cost_op="name")``.

* flow operator, instead of the built-in wave and perlin flow::

      fn(torch, flow_cfg, food, flow_step) -> new_food   # f32[..., W, H]

  ``food`` is ``f32[..., W, H]`` and ``flow_step`` ``int32[...]``, one
  counter per env (reshape it to ``[..., 1, 1]`` to combine it with the
  field); the engine advances it by one per step for every kind but
  ``"none"``.  Select it with ``FlowConfig(kind="name")``.

To stay bitwise equal to the same operator of the JAX package, restate it
with the same fp32 operations in the same order, constants as exact fp32
values (``core/mathx.py::f32``).  ``oracle_fn`` is kept in the signature for
registrations shared with that package; this package has no oracle of its
own and never calls it.  Registered kinds run on the exact engine
(``core/env.py``); the lattice kernels keep their fixed built-in set.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional


class _Op(NamedTuple):
    fn: Callable
    oracle_fn: Callable


_COST_OPS: dict = {}
_FLOW_OPS: dict = {}

#: kinds every engine handles itself; not registrable
BUILTIN_FLOW_KINDS = ("none", "wave", "perlin")


def _register(table: dict, what: str, name: str, fn: Optional[Callable],
              oracle_fn: Optional[Callable]):
    if not isinstance(name, str) or not name:
        raise TypeError(f"{what} operator name must be a non-empty string")
    if what == "flow" and name in BUILTIN_FLOW_KINDS:
        raise ValueError(f"flow kind {name!r} is built in")

    def deco(f: Callable) -> Callable:
        table[name] = _Op(f, oracle_fn if oracle_fn is not None else f)
        return f

    return deco(fn) if fn is not None else deco


def register_cost_operator(name: str, fn: Callable = None, *,
                           oracle_fn: Callable = None):
    """Register ``fn(torch, dynamics, action) -> burned`` under ``name``,
    as a decorator or a direct call.  Registering a name again overwrites
    it."""
    return _register(_COST_OPS, "cost", name, fn, oracle_fn)


def register_flow_operator(name: str, fn: Callable = None, *,
                           oracle_fn: Callable = None):
    """Register ``fn(torch, flow_cfg, food, flow_step) -> new_food`` under
    ``name`` (see the module docstring for the contract)."""
    return _register(_FLOW_OPS, "flow", name, fn, oracle_fn)


def get_cost_operator(name: str, oracle: bool = False) -> Callable:
    try:
        op = _COST_OPS[name]
    except KeyError:
        raise KeyError(
            f"unknown cost operator {name!r} — register it with "
            f"die_tpu_torch.core.operators.register_cost_operator "
            f"(registered: {sorted(_COST_OPS)})") from None
    return op.oracle_fn if oracle else op.fn


def get_flow_operator(name: str, oracle: bool = False) -> Callable:
    try:
        op = _FLOW_OPS[name]
    except KeyError:
        raise KeyError(
            f"unknown flow kind {name!r} — built-in kinds are "
            f"{BUILTIN_FLOW_KINDS}; register custom kinds with "
            f"die_tpu_torch.core.operators.register_flow_operator "
            f"(registered: {sorted(_FLOW_OPS)})") from None
    return op.oracle_fn if oracle else op.fn
