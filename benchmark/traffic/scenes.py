"""The one traffic generator: it reads a traffic mix's parameters (a
workload file's ``traffic`` object) and the configuration's objects and
camera, and renders what a sensor would deliver.

Two kinds of mix:

* ``stream``: the configuration's objects placed in the view, moving at
  camera rate (``motion.py``), rendered once per frame of the arc and played
  forward and back. Each frame holds the noisy depth, the colour image, the
  instance masks (the visible pixels of each object) and the true poses.
* ``pool``: observations of one object at poses drawn from a pool seed
  (uniform rotations, a distance range, an offset from the image centre),
  requested one at a time in an order drawn from the run's seed.

Shapes, placements and pools come from seeds the files fix; the run's
``--seed`` draws the noise, the colour texture, the playback phase and the
order of the pool, unless the mix fixes a ``stream_seed`` (a recording
replayed alike for every run). Every seed therefore asks for the same work.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..reference import raster as rr
from . import motion, noise


@dataclass
class Frames:
    depth: np.ndarray  # (N, H, W) float32 metres, noisy, 0 off the objects
    color: np.ndarray  # (N, H, W, 3) uint8
    masks: np.ndarray  # (N, K, H, W) bool, visible pixels of each object
    poses: np.ndarray  # (N, K, 4, 4) float32 model-to-camera truths
    order: np.ndarray  # indices into the N frames, in request order


def rot_from(seed: int) -> np.ndarray:
    """A rotation drawn uniformly from ``seed``."""
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


def uniform_rotations(rng: np.random.Generator, n: int) -> np.ndarray:
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1)], 1)


def pose(R: np.ndarray, t) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def render_scene(meshes, poses: np.ndarray, cam: dict, coef: float, gen: torch.Generator,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """Noisy depth (N, H, W) and visible masks (N, K, H, W) of K meshes at
    poses (N, K, 4, 4): each object's inverse depth rendered apart, the
    nearest kept."""
    iz = []
    for k, (v, f) in enumerate(meshes):
        T = torch.as_tensor(poses[:, k], dtype=torch.float32, device=device)
        vt = torch.as_tensor(v, device=device)
        ft = torch.as_tensor(f, device=device)
        iz.append(torch.cat([rr.render_inverse_depth(rr.transform(T[s:s + 16], vt), ft, cam)
                             for s in range(0, T.shape[0], 16)]))
    iz = torch.stack(iz, 1)  # (N, K, H, W)
    top = iz.amax(1)
    masks = (iz == top[:, None]) & (top[:, None] > 0)
    depth = noise.add_noise(rr.to_depth(top), coef, gen)
    return depth, masks & (depth[:, None] > 0)


def texture(gen: torch.Generator, n: int, H: int, W: int, device) -> torch.Tensor:
    """Colour background: smooth seeded blobs, (H, W, 3) float in [0, 255]."""
    low = torch.rand((1, 3, H // 16 + 1, W // 16 + 1), generator=gen, device=device)
    img = torch.nn.functional.interpolate(low, size=(H, W), mode="bilinear", align_corners=False)
    return (img[0].permute(1, 2, 0) * 200.0 + 28.0).expand(n, H, W, 3)


def colorize(depth: torch.Tensor, masks: torch.Tensor, bg: torch.Tensor) -> torch.Tensor:
    """Each object a flat tint shaded by its depth over the background."""
    K = masks.shape[1]
    tint = torch.linspace(0.35, 1.0, K, device=depth.device)
    shade = torch.clamp(1.6 - depth, 0.2, 1.0)[..., None] * 255.0  # (N, H, W, 1)
    obj = masks.any(1)[..., None]
    which = (masks.float() * tint[None, :, None, None]).amax(1)[..., None]
    rgb = torch.cat([shade * which, shade * (1.0 - 0.5 * which), shade * 0.6], -1)
    return torch.where(obj, rgb, bg).round().clamp(0, 255).to(torch.uint8)


def stream(traffic: dict, meshes, placements: np.ndarray, cam: dict, coef: float, seed: int,
           device) -> Frames:
    """Frames of a ``stream`` mix: ``placements`` (K, 4, 4) the objects'
    poses at the middle of the arc. A mix with ``stream_seed`` is one
    recorded stream, replayed alike for every run seed (its noise, texture
    and starting phase drawn from ``stream_seed``)."""
    seed = int(traffic.get("stream_seed", seed))
    fwd = int(traffic["forward_frames"])
    deltas = motion.stream_deltas(fwd)
    poses = np.stack([[d @ P for P in placements] for d in deltas]).astype(np.float32)
    gen = torch.Generator(device=device).manual_seed(seed)
    depth, masks = render_scene(meshes, poses, cam, coef, gen, device)
    bg = texture(gen, fwd, cam["height"], cam["width"], device)
    color = colorize(depth, masks, bg)
    phase = int(np.random.default_rng(seed).integers(0, 2 * fwd - 2))
    order = motion.playback(int(traffic["frames"]), fwd, phase)
    return Frames(depth.cpu().numpy(), color.cpu().numpy(), masks.cpu().numpy(), poses, order)


def pool(traffic: dict, mesh, cam: dict, coef: float, seed: int, device) -> Frames:
    """Observations of a ``pool`` mix, one object each."""
    n = int(traffic["pool"])
    rng = np.random.default_rng(int(traffic["pool_seed"]))
    Rs = uniform_rotations(rng, n)
    z = rng.uniform(*traffic["distance_m"], size=n)
    off = rng.uniform(-1.0, 1.0, size=(n, 2)) * float(traffic["centre_offset"])
    u = cam["cx"] + off[:, 0] * cam["width"]
    v = cam["cy"] + off[:, 1] * cam["height"]
    t = np.stack([(u - cam["cx"]) * z / cam["fx"], (v - cam["cy"]) * z / cam["fy"], z], -1)
    poses = np.stack([pose(R, tt) for R, tt in zip(Rs, t)])[:, None].astype(np.float32)
    gen = torch.Generator(device=device).manual_seed(seed)
    depth, masks = render_scene([mesh], poses, cam, coef, gen, device)
    bg = texture(gen, n, cam["height"], cam["width"], device)
    color = colorize(depth, masks, bg)
    order = np.random.default_rng(seed).permutation(n)
    return Frames(depth.cpu().numpy(), color.cpu().numpy(), masks.cpu().numpy(), poses, order)
