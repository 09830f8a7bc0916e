"""sdflib_tpu — a differentiable signed-distance-field framework in JAX.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of
UPC-ViRVIG/SdfLib: exact triangle-list octrees, approximate
tricubic-polynomial octrees, brute-force oracles, uniform grids,
sphere-traced rendering, differentiable queries, serialization, and a CLI
tool suite — built for accelerator meshes (shard_map) rather than ported
from the reference C++.
"""

import os as _os

import jax as _jax

# Persistent XLA compilation cache: octree builds compile one kernel per
# (chunk, candidate-width) bucket, and re-runs should not pay for them
# again. Opt out with SDFLIB_NO_COMPILE_CACHE=1.
_CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
COMPILE_CACHE_DIR = _os.path.join(_CHECKOUT, ".jax_cache")


def compile_cache_dir(environ=_os.environ):
    """The directory this package points JAX's compile cache at: None when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads that itself) or the
    cache is opted out of; otherwise the one fixed directory
    ``COMPILE_CACHE_DIR`` inside the checkout (a fixed path, because the
    path is part of each cache entry's key)."""
    if environ.get("SDFLIB_NO_COMPILE_CACHE") or environ.get(
        "JAX_COMPILATION_CACHE_DIR"
    ):
        return None
    return COMPILE_CACHE_DIR


if compile_cache_dir() is not None:
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())

from .mesh import BoundingBox, Mesh, load_mesh
from .triangle import TriangleDataSoA, calculate_mesh_triangle_data

__version__ = "0.1.0"

# The SDF structures re-export lazily: the reference exposes everything
# under one `sdflib::` namespace (include/SdfLib/*.h), so users expect
# `sdflib_tpu.ExactOctreeSdf` etc., but importing them eagerly would pull
# the full builder/render stack into every `import sdflib_tpu`.
_LAZY = {
    "SdfFunction": ("sdf.sdf_function", "SdfFunction"),
    "SdfFormat": ("sdf.sdf_function", "SdfFormat"),
    "OctreeSdf": ("sdf.octree", "OctreeSdf"),
    "ExactOctreeSdf": ("sdf.exact_octree", "ExactOctreeSdf"),
    "UniformGridSdf": ("sdf.grid", "UniformGridSdf"),
    "RealSdf": ("sdf.real", "RealSdf"),
}


def __getattr__(name):
    entry = _LAZY.get(name)
    if entry is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(f".{entry[0]}", __name__)
    value = getattr(mod, entry[1])
    globals()[name] = value
    return value


__all__ = [
    "BoundingBox",
    "Mesh",
    "load_mesh",
    "TriangleDataSoA",
    "calculate_mesh_triangle_data",
    *_LAZY,
]
