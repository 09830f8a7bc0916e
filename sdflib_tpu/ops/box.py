"""Batched axis-aligned-box SDF used as the out-of-domain fallback.

Mirrors BoundingBox::getDistance (reference utils/Mesh.h:42-63), including
the reference's gradient-variant quirks (it uses the raw point instead of
centering it and the full size instead of the half size,
utils/Mesh.h:48-61) so out-of-box queries match the reference bit-for-bit
in behavior. All math elementwise fp32.
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = ["box_distance", "box_distance_gradient"]


def box_distance(points, box_center, box_size):
    """Exact box SDF. points (..., 3) -> (...)."""
    q = jnp.abs(points - box_center) - 0.5 * box_size
    outside = jnp.sqrt(jnp.sum(jnp.square(jnp.maximum(q, 0.0)), axis=-1))
    inside = jnp.minimum(jnp.max(q, axis=-1), 0.0)
    return outside + inside


def box_distance_gradient(points, box_center, box_size):
    """Distance + gradient with the reference's exact (quirky) gradient
    formula: a = |point| - size, NOT centered/halved (utils/Mesh.h:50)."""
    d = box_distance(points, box_center, box_size)

    a = jnp.abs(points) - box_size
    # index of the largest component of a (reference picks k then l)
    k = jnp.where(a[..., 0] > a[..., 1], 0, 1)
    ax_k = jnp.take_along_axis(a, k[..., None], axis=-1)[..., 0]
    l = jnp.where(a[..., 2] > ax_k, 2, k)
    a_l = jnp.take_along_axis(a, l[..., None], axis=-1)[..., 0]

    sign_p = jnp.where(points >= 0.0, 1.0, -1.0)

    # Inside branch: gradient = sign along the dominant axis.
    inside_grad = (
        jnp.zeros_like(points)
        .at[..., :]
        .set(0.0)
    )
    onehot = jnp.stack(
        [(l == 0), (l == 1), (l == 2)], axis=-1
    ).astype(points.dtype)
    inside_grad = onehot * sign_p

    # Outside branch
    b = jnp.maximum(a, 0.0)
    c = jnp.sqrt(jnp.sum(b * b, axis=-1, keepdims=True))
    c = jnp.maximum(c, 1e-30)
    outside_grad = jnp.where(a > 0.0, b / c * sign_p, 0.0)

    grad = jnp.where((a_l < 0.0)[..., None], inside_grad, outside_grad)
    return d, grad
