"""Shading for sphere-traced renders: normal shading, Blinn-Phong/PBR-lite,
ambient occlusion, soft shadows.

JAX equivalent of the reference's shading stack
(reference: shaders/sdfOctreeRender.comp — getAO :258-271, softshadow
:273-309, Cook-Torrance mapColor :329-389; palette :410-427). All shading
runs as batched jnp over the hit buffers; AO and soft shadows re-march the
SDF exactly like the reference (8 AO taps along the normal; shadow ray
toward the light).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["normal_color", "shade_lambert", "shade_pbr", "ambient_occlusion",
           "soft_shadow", "iteration_heatmap"]

# 5-color heatmap palette used by the reference compute shader for
# iteration/step visualization (sdfOctreeRender.comp:410-427).
ITER_PALETTE = jnp.asarray(
    [
        [1.0, 0.0, 1.0],
        [0.0, 0.0, 1.0],
        [0.0, 1.0, 0.0],
        [1.0, 1.0, 0.0],
        [1.0, 0.0, 0.0],
    ],
    jnp.float32,
)


def normal_color(normal, hit, background=(0.9, 0.9, 0.9)):
    """Classic 0.5*(n+1) normal visualization for hit pixels."""
    col = 0.5 * (normal + 1.0)
    bg = jnp.asarray(background, col.dtype)
    return jnp.where(hit[..., None], col, bg)


def shade_lambert(
    position,
    normal,
    hit,
    light_dir=(0.577, 0.577, 0.577),
    base_color=(0.8, 0.75, 0.7),
    ambient=0.25,
    specular=0.3,
    shininess=32.0,
    view_dir=None,
    ao=None,
    shadow=None,
    background=(0.9, 0.9, 0.9),
):
    """Lambert + Blinn specular with optional AO/shadow modulation —
    the role of mapColor (comp shader :329-389) without the Cook-Torrance
    microfacet terms."""
    l = jnp.asarray(light_dir, jnp.float32)
    l = l / jnp.sqrt(jnp.sum(l * l))
    ndotl = jnp.maximum(jnp.sum(normal * l, axis=-1), 0.0)
    diffuse = ndotl
    if shadow is not None:
        diffuse = diffuse * shadow
    spec = 0.0
    if view_dir is not None:
        v = -view_dir
        h = l + v
        h = h / jnp.maximum(
            jnp.sqrt(jnp.sum(h * h, axis=-1, keepdims=True)), 1e-9
        )
        spec = specular * jnp.power(
            jnp.maximum(jnp.sum(normal * h, axis=-1), 0.0), shininess
        )
        if shadow is not None:
            spec = spec * shadow
    amb = ambient if ao is None else ambient * ao
    intensity = amb + (1.0 - ambient) * diffuse
    col = jnp.asarray(base_color, jnp.float32) * intensity[..., None]
    col = col + spec[..., None]
    bg = jnp.asarray(background, jnp.float32)
    return jnp.clip(jnp.where(hit[..., None], col, bg), 0.0, 1.0)


def _normalize(v):
    return v / jnp.maximum(
        jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True)), 1e-9
    )


def shade_pbr(
    position,
    normal,
    hit,
    view_dir,
    light_dir=(0.577, 0.577, 0.577),
    light_color=(1.0, 1.0, 1.0),
    base_color=(0.8, 0.75, 0.7),
    metallic=0.0,
    roughness=0.45,
    ambient=0.22,
    ao=None,
    shadow=None,
    background=(0.9, 0.9, 0.9),
):
    """Cook-Torrance microfacet shading (GGX distribution, Smith geometry,
    Fresnel-Schlick) — the reference compute shader's mapColor pipeline
    (sdfOctreeRender.comp:82-121 BRDF terms, :329-389 composition)."""
    n = normal
    v = _normalize(-jnp.asarray(view_dir, jnp.float32))
    l = jnp.asarray(light_dir, jnp.float32)
    l = l / jnp.sqrt(jnp.sum(l * l))
    h = _normalize(l + v)

    albedo = jnp.asarray(base_color, jnp.float32)
    lc = jnp.asarray(light_color, jnp.float32)
    ndotl = jnp.maximum(jnp.sum(n * l, axis=-1), 0.0)
    ndotv = jnp.maximum(jnp.sum(n * v, axis=-1), 1e-4)
    ndoth = jnp.maximum(jnp.sum(n * h, axis=-1), 0.0)
    hdotv = jnp.maximum(jnp.sum(h * v, axis=-1), 0.0)

    # GGX normal distribution (comp shader DistributionGGX)
    a = roughness * roughness
    a2 = a * a
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    D = a2 / jnp.maximum(jnp.pi * denom * denom, 1e-9)

    # Smith geometry with Schlick-GGX (comp shader GeometrySmith)
    k = (roughness + 1.0) ** 2 / 8.0
    g1 = ndotv / (ndotv * (1.0 - k) + k)
    g2 = ndotl / jnp.maximum(ndotl * (1.0 - k) + k, 1e-9)
    G = g1 * g2

    # Fresnel-Schlick (comp shader fresnelSchlick)
    f0 = 0.04 * (1.0 - metallic) + metallic  # scalar workflow
    F = f0 + (1.0 - f0) * jnp.power(jnp.clip(1.0 - hdotv, 0.0, 1.0), 5.0)

    spec = (D * G * F) / jnp.maximum(4.0 * ndotv * ndotl, 1e-4)
    kd = (1.0 - F) * (1.0 - metallic)

    radiance = ndotl
    if shadow is not None:
        radiance = radiance * shadow
    direct = (
        kd[..., None] * albedo / jnp.pi + spec[..., None]
    ) * lc * radiance[..., None]

    amb = ambient if ao is None else ambient * ao[..., None]
    col = amb * albedo + direct
    # simple tonemap + gamma (comp shader :443-445)
    col = col / (col + 1.0)
    col = jnp.power(jnp.clip(col, 0.0, 1.0), 1.0 / 2.2)
    bg = jnp.asarray(background, jnp.float32)
    return jnp.where(hit[..., None], col, bg)


def ambient_occlusion(distance_fn, position, normal, *, taps: int = 8):
    """8-tap AO along the normal (comp shader getAO :258-271):
    occ += max(h - d(p + n*h), 0) for h = 0.002 + 0.1*i/8; 1 - 1.9*occ."""
    occ = jnp.zeros(position.shape[:-1], jnp.float32)
    for i in range(taps):
        h = 0.002 + 0.1 * i / taps
        d = distance_fn(position + normal * h)
        occ = occ + jnp.maximum(h - d, 0.0)
    return jnp.clip(1.0 - 1.9 * occ, 0.0, 1.0)


def soft_shadow(distance_fn, position, light_dir, *, k: float = 8.0,
                t_min: float = 0.005, t_max: float = 5.0, steps: int = 64):
    """Improved soft shadow march toward the light
    (comp shader softshadow :273-309 semantics, fixed step count)."""
    l = jnp.asarray(light_dir, jnp.float32)
    l = l / jnp.sqrt(jnp.sum(l * l))

    def body(i, carry):
        res, t, ph = carry
        h = distance_fn(position + l * t[..., None])
        y = h * h / (2.0 * jnp.maximum(ph, 1e-9))
        d = jnp.sqrt(jnp.maximum(h * h - y * y, 0.0))
        res = jnp.minimum(res, k * d / jnp.maximum(t - y, 1e-6))
        ph = h
        t = jnp.minimum(t + jnp.clip(h, 0.001, 0.2), t_max)
        return res, t, ph

    shape = position.shape[:-1]
    res0 = (
        jnp.ones(shape, jnp.float32),
        jnp.full(shape, t_min, jnp.float32),
        jnp.full(shape, 1e20, jnp.float32),
    )
    res, _, _ = jax.lax.fori_loop(0, steps, body, res0)
    return jnp.clip(res, 0.0, 1.0)


def iteration_heatmap(iterations, max_iters: int):
    """Map march-iteration counts through the 5-color palette."""
    t = jnp.clip(iterations.astype(jnp.float32) / max_iters, 0.0, 1.0)
    idx = jnp.clip(t * 4.0, 0.0, 3.999)
    i0 = idx.astype(jnp.int32)
    frac = idx - i0
    return ITER_PALETTE[i0] * (1.0 - frac[..., None]) + ITER_PALETTE[
        jnp.minimum(i0 + 1, 4)
    ] * frac[..., None]
