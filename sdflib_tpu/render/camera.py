"""Perspective camera: batched ray generation.

JAX equivalent of the reference's camera + per-pixel ray setup
(reference: src/render_engine/Camera.h:11-52 and the ray construction in
shaders/sdfOctreeRender.comp:429-436: pixel center on the near plane,
transformed by the inverse view-model matrix).
"""
from __future__ import annotations

import numpy as np

__all__ = ["Camera"]


class Camera:
    def __init__(
        self,
        position=(0.0, 0.0, 2.0),
        target=(0.0, 0.0, 0.0),
        up=(0.0, 1.0, 0.0),
        fov_y_deg: float = 60.0,
        near: float = 0.1,
        far: float = 20.0,
    ):
        self.position = np.asarray(position, np.float32)
        self.target = np.asarray(target, np.float32)
        self.up = np.asarray(up, np.float32)
        self.fov_y_deg = float(fov_y_deg)
        self.near = float(near)
        self.far = float(far)

    def rays(self, width: int, height: int):
        """Returns (origins (H,W,3), dirs (H,W,3)) float32. Pixel centers on
        the near plane (comp shader semantics); row 0 is the TOP of the
        image (written PNGs match screen orientation)."""
        fwd = self.target - self.position
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, self.up)
        right = right / np.linalg.norm(right)
        up = np.cross(right, fwd)

        half_h = np.tan(np.radians(0.5 * self.fov_y_deg)) * self.near
        half_w = half_h * (width / height)

        xs = (np.arange(width, dtype=np.float32) + 0.5) / width * 2.0 - 1.0
        ys = 1.0 - (np.arange(height, dtype=np.float32) + 0.5) / height * 2.0
        gx, gy = np.meshgrid(xs * half_w, ys * half_h, indexing="xy")

        pix = (
            self.position[None, None]
            + self.near * fwd[None, None]
            + gx[..., None] * right[None, None]
            + gy[..., None] * up[None, None]
        )
        dirs = pix - self.position[None, None]
        dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        origins = np.broadcast_to(self.position, dirs.shape).copy()
        return origins.astype(np.float32), dirs.astype(np.float32)
