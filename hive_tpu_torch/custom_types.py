"""Shared type aliases. (Capability parity: reference hive/custom_types.py:20-22.)"""

from pathlib import Path
from typing import Tuple, Union

# A (height, width) 2D size, height first.
Size = Tuple[int, int]
# Anything accepted as a filesystem path.
File = Union[str, Path]
