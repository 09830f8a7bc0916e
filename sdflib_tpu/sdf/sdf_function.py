"""Abstract SDF interface + format-dispatched serialization.

JAX re-design of the reference SdfFunction
(reference: include/SdfLib/SdfFunction.h:16-57, src/sdf/SdfFunction.cpp:9-79).
All queries are batched: ``get_distance(points)`` takes (..., 3) and returns
(...). Serialization uses an .npz container with a format tag first — the
same dispatch role cereal plays in the reference — round-tripping every
query-relevant field.
"""
from __future__ import annotations

import abc
from enum import Enum

import numpy as np

from ..mesh import BoundingBox

__all__ = ["SdfFormat", "SdfFunction"]


class SdfFormat(str, Enum):
    """Mirrors SdfFunction::SdfFormat (SdfFunction.h:16-22)."""

    GRID = "grid"
    OCTREE = "octree"
    EXACT_OCTREE = "exact_octree"
    # Additions: tile-sharded structures (no reference counterpart —
    # the reference is single-node; SURVEY.md S5.7).
    OCTREE_TILED = "octree_tiled"
    EXACT_OCTREE_TILED = "exact_octree_tiled"
    NONE = "none"


class SdfFunction(abc.ABC):
    """Base class of every SDF structure."""

    @abc.abstractmethod
    def get_distance(self, points):
        """Batched signed distance. points (..., 3) -> (...)."""

    @abc.abstractmethod
    def get_distance_and_gradient(self, points):
        """Batched signed distance + gradient. -> ((...), (..., 3))."""

    @abc.abstractmethod
    def get_sample_area(self) -> BoundingBox:
        """The region the structure covers (SdfFunction.h:44)."""

    @abc.abstractmethod
    def get_format(self) -> SdfFormat:
        ...

    # -- serialization ------------------------------------------------------

    def _state_arrays(self) -> dict:
        """Subclasses return the arrays/metadata to persist."""
        raise NotImplementedError

    @classmethod
    def _from_state_arrays(cls, state: dict) -> "SdfFunction":
        raise NotImplementedError

    def save(self, path: str) -> None:
        """Save with a leading format tag (SdfFunction.cpp:9-42 role)."""
        state = self._state_arrays()
        state["__format__"] = np.array(self.get_format().value)
        np.savez(path, **state)

    @staticmethod
    def load(path: str) -> "SdfFunction":
        """Factory dispatch on the stored format (SdfFunction.cpp:44-79)."""
        with np.load(path if path.endswith(".npz") else path, allow_pickle=False) as f:
            state = {k: f[k] for k in f.files}
        if "__format__" not in state:
            raise ValueError(
                f"{path!r} is not an sdflib_tpu SDF container (missing format tag)"
            )
        fmt = SdfFormat(str(state.pop("__format__")))
        # Local imports to avoid cycles.
        if fmt == SdfFormat.GRID:
            from .grid import UniformGridSdf

            return UniformGridSdf._from_state_arrays(state)
        if fmt == SdfFormat.OCTREE:
            from .octree import OctreeSdf

            return OctreeSdf._from_state_arrays(state)
        if fmt == SdfFormat.EXACT_OCTREE:
            from .exact_octree import ExactOctreeSdf

            return ExactOctreeSdf._from_state_arrays(state)
        if fmt == SdfFormat.EXACT_OCTREE_TILED:
            from ..parallel.tiles import TiledExactOctreeSdf

            return TiledExactOctreeSdf._from_state_arrays(state)
        if fmt == SdfFormat.OCTREE_TILED:
            from ..parallel.tiles import TiledOctreeSdf

            return TiledOctreeSdf._from_state_arrays(state)
        raise ValueError(f"Cannot load SDF with format {fmt}")
