"""Host-side utilities: shape validation, parallel map, profiling, logging.

Counterpart of ``hive_tpu/utils.py`` — the host helpers the pipeline uses:
``validate_shape``, ``tqdm_imap`` (:100), ``setup_logger``, ``format_bytes``,
``Timer``, ``set_key_path`` (:443), ``get_key_path`` (:453) and
``timed_block`` (:466).
"""

from __future__ import annotations

import contextlib
import enum
import logging
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional, Sequence, Type, Union

try:
    from tqdm import tqdm
except ImportError:  # tqdm is optional: without it progress bars are off
    tqdm = None


def validate_camera_parameter_shapes(K, R, t):
    """Assert K is 3x3, R is 3x3 and t is a 3x1 column vector."""
    validate_shape(K, "K", expected_shape=(3, 3))
    validate_shape(R, "R", expected_shape=(3, 3))
    validate_shape(t, "t", expected_shape=(3, 1))


def validate_shape(x, x_name: str, expected_shape: tuple):
    """Assert that ``x.shape`` matches ``expected_shape``.

    ``None`` entries in ``expected_shape`` act as wildcards, e.g. ``(None, 3)``
    accepts any Nx3 array.
    """
    if not isinstance(expected_shape, tuple):
        raise AssertionError("expected_shape should be given as a tuple.")

    actual = tuple(x.shape)
    if len(actual) != len(expected_shape):
        raise AssertionError(
            f"{x_name} has the wrong rank: "
            f"wanted {len(expected_shape)} dims, got {len(actual)}"
        )

    for want, got in zip(expected_shape, actual):
        if want is not None and want != got:
            pretty = "(" + ", ".join("?" if d is None else str(d) for d in expected_shape) + ")"
            raise AssertionError(
                f"{x_name} has the wrong shape: wanted {pretty}, got {actual}"
            )


class Domain(enum.Enum):
    """Value-domain constraints used by :func:`check_domain`."""

    Negative = enum.auto()  # < 0
    Positive = enum.auto()  # > 0
    NonNegative = enum.auto()  # >= 0


def check_domain(value: Any, name: str, value_type: Union[Type[int], Type[float]],
                 domain: Optional[Domain] = None, nullable: bool = False):
    """Raise ``ValueError`` unless ``value`` is a ``value_type`` inside ``domain``."""
    if nullable and value is None:
        return

    # Type check FIRST: the domain comparison on a non-numeric value would
    # raise TypeError instead of the promised ValueError (review finding,
    # r5 — validators exist precisely for the bad inputs).
    if not isinstance(value, value_type):
        raise ValueError(
            f"{name} must be a {value_type.__name__}, "
            f"but got {value!r} ({type(value).__name__}) instead")

    in_domain = True
    domain_name = ""

    if domain is Domain.Negative:
        in_domain = value < 0
        domain_name = " negative "
    elif domain is Domain.Positive:
        in_domain = value > 0
        domain_name = " positive "
    elif domain is Domain.NonNegative:
        in_domain = value >= 0
        domain_name = " non-negative "

    if not in_domain:
        raise ValueError(
            f"{name} must be a{domain_name}{value_type.__name__}, "
            f"but got {value!r} ({type(value).__name__}) instead"
        )


def tqdm_imap(func, args: Sequence, num_workers: Optional[int] = None,
              show_progress: bool = True) -> list:
    """Apply ``func`` over ``args`` with a thread pool, preserving order.

    Frames are independent on the host side, so a thread pool (numpy and
    zlib release the GIL) is the right tool; device work is batched
    separately.

    Pool width: explicit ``num_workers`` > the ``HIVE_NUM_WORKERS`` env var >
    ``os.cpu_count()``. The env var pins a width for benchmarking or for
    overlapping host meshing with device work on many-core machines.
    """
    args = list(args)
    workers = (num_workers or int(os.environ.get("HIVE_NUM_WORKERS", 0) or 0)
               or os.cpu_count() or 1)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        it = pool.map(func, args)

        if show_progress and tqdm is not None:
            it = tqdm(it, total=len(args))

        return list(it)


@contextlib.contextmanager
def temp_seed(seed: int):
    """Temporarily seed NumPy's global RNG."""
    import numpy as np

    state = np.random.get_state()
    try:
        np.random.seed(seed)
        yield
    finally:
        np.random.set_state(state)


def setup_logger(log_path: Optional[str] = None):
    """Configure root logging: DEBUG to file, INFO to stdout, WARNING+ to stderr.

    Mirrors the reference behaviour (hive/utils.py:186-239) so downstream log
    consumers see the same stream layout.
    """
    logger = logging.getLogger()
    logger.setLevel(logging.DEBUG)
    logger.handlers = []

    detailed = logging.Formatter(
        "%(asctime)s.%(msecs)03d %(levelname)s %(pathname)s:%(lineno)s %(funcName)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    simple = logging.Formatter(
        "%(asctime)s.%(msecs)03d %(levelname)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )

    if log_path is not None:
        fh = logging.FileHandler(log_path)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(detailed)
        logger.addHandler(fh)

    class _AtMost(logging.Filter):
        def __init__(self, level):
            super().__init__()
            self._level = level

        def filter(self, record):
            return record.levelno <= self._level

    out = logging.StreamHandler(sys.stdout)
    out.setLevel(logging.INFO)
    out.addFilter(_AtMost(logging.INFO))
    out.setFormatter(simple)
    logger.addHandler(out)

    err = logging.StreamHandler(sys.stderr)
    err.setLevel(logging.WARNING)
    err.setFormatter(detailed)
    logger.addHandler(err)

    logging.getLogger("PIL").setLevel(logging.INFO)
    logging.getLogger("matplotlib").setLevel(logging.INFO)


def format_bytes(bytes_count: float) -> str:
    """Human-readable byte count (binary units)."""
    for unit in ("", "Ki", "Mi", "Gi", "Ti"):
        if abs(bytes_count) < 1024.0:
            return f"{bytes_count:3.1f} {unit}B"
        bytes_count /= 1024.0

    return f"{bytes_count:3.1f} PiB"


class Timer:
    """Wall-clock timer; usable as a context manager."""

    def __init__(self):
        self._start: float = 0.0
        self._stop: Optional[float] = None

    @property
    def elapsed_seconds(self) -> float:
        end = self._stop if self._stop is not None else time.monotonic()
        return end - self._start

    def start(self):
        self._start = time.monotonic()
        self._stop = None

    def stop(self):
        self._stop = time.monotonic()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()


def set_key_path(dictionary: dict, path: Sequence, value: Any):
    """Set ``dictionary[path[0]][path[1]]... = value``, creating nested dicts."""
    node = dictionary

    for key in path[:-1]:
        node = node.setdefault(key, {})

    node[path[-1]] = value


def get_key_path(dictionary: dict, path: Sequence) -> Any:
    """Get the value at a nested key path; raises ``KeyError`` if absent."""
    node = dictionary

    for key in path[:-1]:
        if key not in node:
            raise KeyError(f"Key path {list(path)} missing at {key!r}")
        node = node[key]

    return node[path[-1]]


@contextlib.contextmanager
def timed_block(log_msg: Optional[str], profiling: Optional[dict], key_path: Sequence):
    """Run a block, recording its wall time (seconds) into ``profiling`` at ``key_path``.

    This is the profiling primitive whose output forms the ``profiling.json``
    benchmark contract (reference hive/utils.py:356-379).
    """
    if log_msg:
        logging.info(log_msg)

    timer = Timer()
    timer.start()

    try:
        yield timer
    finally:
        if profiling is not None:
            set_key_path(profiling, list(key_path), timer.elapsed_seconds)

