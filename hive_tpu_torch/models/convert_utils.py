"""Shared armour for torch-checkpoint converters (numpy only).

Counterpart of ``hive_tpu/models/convert_utils.py``, carried here so that
the port needs nothing of ``hive_tpu``. Released checkpoints drift: key
names move, heads get renamed, extra buffers appear. A converter wraps its
source state dict in :class:`TrackedState`, so that a checkpoint either
loads cleanly or fails with a complete report (every missing key with
close-name hints, every tensor left unconsumed), and writes its output
through :class:`WriteOnceDict`, which refuses a second write to one key.
"""

from __future__ import annotations

import difflib
import re
from typing import Dict, Iterable, Sequence

import numpy as np


class TrackedState:
    """A read-tracking view of a flat ``{name: array}`` checkpoint dict.

    * ``state[key]`` marks ``key`` consumed; a missing key raises with
      close-match suggestions (key-name drift reads as a rename, not a
      mystery KeyError).
    * :meth:`assert_fully_consumed` raises if any tensor was never read,
      listing all leftovers (minus explicitly ignored patterns).
    """

    def __init__(self, state: Dict[str, np.ndarray], name: str = "checkpoint"):
        self._state = dict(state)
        self._consumed: set = set()
        self.name = name

    def __getitem__(self, key: str) -> np.ndarray:
        if key not in self._state:
            hints = difflib.get_close_matches(key, self._state.keys(), n=3,
                                              cutoff=0.6)
            hint_text = f" Close matches: {hints}." if hints else ""
            raise KeyError(f"{self.name} has no tensor {key!r} — the source "
                           f"layout may have drifted.{hint_text}")

        self._consumed.add(key)
        return self._state[key]

    def __contains__(self, key: str) -> bool:
        # Membership probes guard optional tensors; a probe alone does not
        # consume.
        return key in self._state

    def assert_fully_consumed(self, ignore: Sequence[str] = ()) -> None:
        """Raise ``ValueError`` listing every tensor the converter ignored.

        :param ignore: regex patterns for tensors that are legitimately
            unused (e.g. a classification head the model does not keep).
        """
        patterns = [re.compile(p) for p in ignore]
        leftovers = sorted(key for key in self._state if key not in self._consumed
                           and not any(p.search(key) for p in patterns))

        if leftovers:
            shapes = {k: tuple(np.shape(self._state[k])) for k in leftovers[:20]}
            raise ValueError(
                f"{len(leftovers)} tensor(s) in {self.name} were not "
                f"consumed by the converter — the source layout has likely "
                f"drifted. First leftovers (name: shape): {shapes}. "
                f"Full list: {leftovers}")


class WriteOnceDict(dict):
    """A dict that refuses duplicate writes (converter output side).

    Two mappings landing on one Flax parameter would silently drop the first
    — make it loud instead.
    """

    def __setitem__(self, key, value):
        if key in self:
            raise ValueError(f"parameter {key!r} written twice by the "
                             f"converter (mapping collision)")
        super().__setitem__(key, value)


def iter_flat_numpy(raw: Iterable) -> Dict[str, np.ndarray]:
    """torch state dict → plain {name: np.ndarray} (detaching tensors)."""
    out = {}
    for key, value in raw.items():
        out[key] = np.asarray(value.detach().numpy()
                              if hasattr(value, "detach") else value)
    return out
