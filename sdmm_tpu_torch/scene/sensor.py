"""The sensors: pixel + jitter → camera rays (port of
sdmm_tpu/scene/sensor.py ``generate_rays``: perspective, thinlens,
orthographic and spherical).

Mitsuba 0.6 convention: camera space looks down +z, y up, fov about the
axis given by ``fov_axis`` (default x = image width).
"""

from __future__ import annotations

import math

import torch

from ..core import draws
from ..core.frame import normalize

SENSOR_TYPES = ("perspective", "thinlens", "orthographic", "spherical")


def generate_rays(scene, pixel_xy: torch.Tensor, width: int, height: int,
                  fov_axis: str = "x", sensor_type: str = "perspective",
                  aperture: float = 0.0, focus_dist: float = 1.0,
                  lens_uv: torch.Tensor | None = None,
                  ortho_scale: float = 1.0):
    """pixel_xy [N, 2] float pixel coords (with jitter) → (origins [N, 3],
    directions [N, 3]). ``sensor_type``: perspective; thinlens (the origin
    on a lens disk of radius ``aperture`` at ``lens_uv`` [N, 2], refocused
    at ``focus_dist``; perspective when the aperture is 0); orthographic
    (a screen of half-width ``ortho_scale``); spherical (equirectangular:
    x the azimuth, y the polar angle)."""
    if sensor_type not in SENSOR_TYPES:
        raise ValueError(f"unknown sensor type {sensor_type!r}")
    rot = scene.cam_to_world[:3, :3]
    org = scene.cam_to_world[:3, 3]
    if sensor_type == "spherical":
        phi = (1.0 - pixel_xy[..., 0] / width) * 2.0 * math.pi
        theta = pixel_xy[..., 1] / height * math.pi
        d_cam = torch.stack([torch.sin(theta) * torch.sin(phi),
                             torch.cos(theta),
                             -torch.sin(theta) * torch.cos(phi)], dim=-1)
        d_world = normalize(d_cam @ rot.T)
        return org.expand_as(d_world), d_world
    aspect = width / height
    # Camera-space +x maps to image LEFT (Mitsuba 0.6 screen convention).
    sx = 1.0 - 2.0 * (pixel_xy[..., 0] / width)
    sy = 1.0 - 2.0 * (pixel_xy[..., 1] / height)
    tan_half = scene.cam_tan_half_fov
    if fov_axis == "x":
        tx = tan_half
        ty = tan_half / aspect
    else:
        ty = tan_half
        tx = tan_half * aspect
    if sensor_type == "orthographic":
        o_cam = torch.stack([sx * ortho_scale, sy * ortho_scale / aspect,
                             torch.zeros_like(sx)], dim=-1)
        o_world = o_cam @ rot.T + org
        return o_world, normalize(rot[:, 2]).expand_as(o_world)
    d_cam = torch.stack([sx * tx, sy * ty, torch.ones_like(sx)], dim=-1)
    if sensor_type == "thinlens" and aperture > 0.0:
        from ..core import warp

        if lens_uv is None:
            raise ValueError("a thinlens sensor with an aperture needs "
                             "lens_uv")
        p_lens = warp.square_to_uniform_disk_concentric(lens_uv) * aperture
        o_cam = torch.cat([p_lens, torch.zeros_like(sx)[..., None]], dim=-1)
        d_cam = d_cam * focus_dist - o_cam
        return o_cam @ rot.T + org, normalize(d_cam @ rot.T)
    d_world = normalize(d_cam @ rot.T)
    return org.expand_as(d_world), d_world


def pixel_rays(scene, pix: torch.Tensor, generator, width: int, height: int,
               fov_axis: str = "x"):
    """Camera rays through the pixels ``pix`` [N] (row-major indices),
    each jittered by two uniforms of ``generator`` (``core/draws.rand``:
    a ``torch.Generator`` or a mesh rank's ``WaveBlock``)."""
    u = draws.rand((pix.shape[0], 2), generator, pix.device)
    return generate_rays(scene, torch.stack(
        [(pix % width).float() + u[:, 0], (pix // width).float() + u[:, 1]],
        -1), width, height, fov_axis)
