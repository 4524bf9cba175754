"""The JAX package's TPU layout parameters, taken in their places.

Some of the JAX package's functions take parameters that only shape its
TPU programs: the chunk sizes of its tiled brute force (``chunk_a``,
``chunk_b``), the transposed (8, P) query packs (``qt8``, ``qt8_a``,
``qt8_b``), the Pallas interpret-mode switch (``interpret``) and the
``shard_map`` axis of the ring (``axis``). The port takes each one in
JAX's place, so that a positional call made the JAX package's way binds
every later argument to its JAX meaning. None of them changes a result
here: the port blocks its searches by its own sizes, reads the sorted
points as they are, has no interpret mode and keeps a ring's slots in a
list. Each is checked, so that an argument bound there by mistake (a row
offset, a normals array, a slot count) raises instead of being ignored.
"""
from __future__ import annotations

import numbers
import typing


def check_chunk(name: str, value: typing.Any) -> None:
    """A chunk size of the JAX package's tiled search: a positive int."""
    if isinstance(value, bool) or not isinstance(value, numbers.Integral):
        raise TypeError(f"{name} must be a positive int (the JAX package's "
                        f"chunk size; unused here), got {value!r}")
    if value <= 0:
        raise ValueError(f"{name} must be a positive int (the JAX package's "
                         f"chunk size; unused here), got {value}")


def check_pack(name: str, value: typing.Any) -> None:
    """A transposed query pack of the JAX package: None or a 2-D array of
    8 rows (any array type; only its shape is read)."""
    if value is None:
        return
    shape = tuple(getattr(value, "shape", ()))
    if len(shape) != 2 or shape[0] != 8:
        raise ValueError(f"{name} must be None or the JAX package's (8, P) "
                         f"transposed query pack (unused here), got shape "
                         f"{shape}")


def check_interpret(value: typing.Any) -> None:
    """The JAX package's Pallas interpret-mode switch: a bool."""
    if not isinstance(value, bool):
        raise TypeError(f"interpret must be a bool (the JAX package's Pallas "
                        f"interpret mode; unused here), got {value!r}")


def check_axis(value: typing.Any) -> None:
    """The JAX package's ring axis name: a str or None."""
    if value is not None and not isinstance(value, str):
        raise TypeError(f"axis must be a mesh axis name or None (the JAX "
                        f"package's shard_map axis; a ring's slots are a "
                        f"list here), got {value!r}")
