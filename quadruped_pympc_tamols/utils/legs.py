"""Array-first per-leg container.

The reference passes around a ``LegsAttr`` object holding four separate numpy arrays
(gym_quadruped's LegsAttr, used throughout e.g. the reference's quadruped_pympc/
interfaces/wb_interface.py). On device we want a single stacked array with the leg axis
leading, so every per-leg operation vectorizes instead of looping. ``Legs`` is a thin
view: it IS a jnp/np array of shape (4, ...) in leg order (FL, FR, RL, RR), with named
accessors for host-side ergonomics. It is registered as a jax pytree.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import numpy as np

from ..config import LEGS

_LEG_INDEX = {name: i for i, name in enumerate(LEGS)}


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Legs:
    """Stacked per-leg data: ``data`` has shape (4, ...) ordered FL, FR, RL, RR."""

    data: Any

    # -- construction ------------------------------------------------------
    @classmethod
    def of(cls, FL, FR, RL, RR) -> "Legs":
        import jax.numpy as jnp

        return cls(jnp.stack([jnp.asarray(FL), jnp.asarray(FR), jnp.asarray(RL), jnp.asarray(RR)]))

    @classmethod
    def of_np(cls, FL, FR, RL, RR) -> "Legs":
        return cls(np.stack([np.asarray(FL), np.asarray(FR), np.asarray(RL), np.asarray(RR)]))

    @classmethod
    def zeros(cls, shape=(3,), dtype=np.float32) -> "Legs":
        return cls(np.zeros((4,) + tuple(shape), dtype=dtype))

    # -- named views -------------------------------------------------------
    @property
    def FL(self):
        return self.data[0]

    @property
    def FR(self):
        return self.data[1]

    @property
    def RL(self):
        return self.data[2]

    @property
    def RR(self):
        return self.data[3]

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.data[_LEG_INDEX[key]]
        return self.data[key]

    def set(self, leg: str, value) -> "Legs":
        """Functional per-leg update (works for both np and jnp payloads)."""
        i = _LEG_INDEX[leg]
        if isinstance(self.data, np.ndarray):
            out = self.data.copy()
            out[i] = value
            return Legs(out)
        return Legs(self.data.at[i].set(value))

    def flat(self):
        """Flatten to (4*prod(rest),) — e.g. 12-vector of stacked xyz."""
        return self.data.reshape(-1)

    # -- pytree protocol ---------------------------------------------------
    def tree_flatten(self):
        return (self.data,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])

    def __repr__(self):
        return f"Legs(FL={self.FL}, FR={self.FR}, RL={self.RL}, RR={self.RR})"
