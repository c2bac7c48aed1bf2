"""Checkpoint/resume for long-running optimisation loops.

Counterpart of ``hive_tpu/checkpoint.py``: the same ``step_<n>.npz`` files
(a list of arrays plus a JSON metadata blob), so a checkpoint written by
either package restores in the other. The pose optimiser saves
its parameters and Adam state as the flat list of leaves that
``jax.tree.flatten((params, opt_state))`` gives in ``hive_tpu``;
:func:`adam_state_to_leaves` and :func:`adam_state_from_leaves` map the
port's tensors to and from that list.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


# Checkpoints kept in a directory; older ones are deleted on save.
MAX_TO_KEEP = 3


class CheckpointManager:
    """Saves and restores a list of arrays plus a JSON metadata blob as
    ``step_<n>.npz``: the arrays under ``#0``, ``#1``, ... (the keys
    ``hive_tpu``'s pytree codec gives a list) and the metadata as UTF-8
    bytes under ``__metadata__``. Keeps the latest :data:`MAX_TO_KEEP`.
    """

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}.npz")

    def all_steps(self):
        steps = []

        for name in os.listdir(self.directory):
            if name.startswith("step_") and name.endswith(".npz"):
                steps.append(int(name[5:-4]))

        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, leaves: Sequence[np.ndarray], metadata: Optional[dict] = None):
        payload = {f"#{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
        payload["__metadata__"] = np.frombuffer(
            json.dumps(metadata or {}).encode("utf-8"), dtype=np.uint8)

        tmp_path = self._step_path(step) + ".tmp"
        with open(tmp_path, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp_path, self._step_path(step))

        for old in self.all_steps()[:-MAX_TO_KEEP]:
            os.remove(self._step_path(old))

        logging.debug(f"Checkpointed step {step} to {self._step_path(step)}")

    def restore(self, step: Optional[int] = None):
        """Load (leaves, metadata) from the given (or latest) step.

        :return: (list of arrays, metadata) or (None, None) when no
            checkpoint exists.
        """
        if step is None:
            step = self.latest_step()

        if step is None:
            return None, None

        data = np.load(self._step_path(step), allow_pickle=False)

        metadata = json.loads(bytes(data["__metadata__"]).decode("utf-8")) \
            if "__metadata__" in data.files else {}

        keys = [key for key in data.files if key != "__metadata__"]
        if sorted(keys) != sorted(f"#{i}" for i in range(len(keys))):
            raise ValueError(f"{self._step_path(step)} does not hold a list of arrays "
                             f"(keys {keys})")
        return [data[f"#{i}"] for i in range(len(keys))], metadata


def adam_state_to_leaves(params: Dict[str, torch.Tensor],
                         state: Dict[str, Any]) -> List[np.ndarray]:
    """The leaves of ``(params, optax.adam state)`` in ``jax.tree.flatten``
    order: the parameters by sorted key, then ``ScaleByAdamState``'s
    ``count``, ``mu`` and ``nu`` (each by sorted key); the learning-rate
    scale's ``EmptyState`` has no leaves.

    :param state: ``{"count": int32 scalar, "mu": {...}, "nu": {...}}``.
    """
    keys = sorted(params)
    tensors = ([params[k] for k in keys] + [state["count"]]
               + [state["mu"][k] for k in keys] + [state["nu"][k] for k in keys])
    return [t.detach().cpu().numpy() for t in tensors]


def adam_state_from_leaves(leaves: Sequence[np.ndarray], keys: Sequence[str],
                           device=None) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Inverse of :func:`adam_state_to_leaves` for parameters named ``keys``:
    ``(params, state)`` as tensors on ``device``."""
    keys = sorted(keys)
    k = len(keys)
    if len(leaves) != 3 * k + 1:
        raise ValueError(f"{len(leaves)} checkpoint leaves; (params, Adam state) over "
                         f"{keys} has {3 * k + 1}")

    def tensors(arrays):
        return {key: torch.as_tensor(np.asarray(a), device=device)
                for key, a in zip(keys, arrays)}

    params = tensors(leaves[:k])
    state = {"count": torch.as_tensor(np.asarray(leaves[k], dtype=np.int32), device=device),
             "mu": tensors(leaves[k + 1:2 * k + 1]), "nu": tensors(leaves[2 * k + 1:])}
    return params, state
