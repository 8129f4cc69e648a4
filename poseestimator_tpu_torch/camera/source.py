"""Camera sources (counterpart of ``poseestimator_tpu/camera/source.py``):
the RealSense camera surface, backed by real hardware, a recorded replay or
a synthetic renderer, so that the whole tracking loop runs headless.

Surface: ``get_rgbd() -> color`` (H, W, 3) uint8 BGR numpy, or None at the
end of the stream; after it, ``depth`` is the (H, W) float32 depth in metres
as a tensor on the camera's device; ``rs_get_intrinsics() -> (intr, K)``;
``get_pcd_from_rgbd(mask) -> PointCloud``; ``stop()``. The synthetic
camera's ``object_mask`` / ``object_masks`` stay numpy, as in the JAX
package.

Cameras take ``device``, default the card (an error when there is none);
``device="cpu"`` renders and filters with the plain versions.
"""
from __future__ import annotations

from typing import Iterable, Optional, Protocol, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..geom3d.camera import Intrinsics, backproject_depth
from ..geom3d.cloud import PointCloud
from ..geom3d.outliers import remove_statistical_outlier
from ..geom3d.sampling import random_sample
from ..render.points import render_shaded
from ..render.raster import render_depth_mesh, shade_depth_image
from ..utils.profiling import traced
from .filters import hole_filling_filter, spatial_filter, temporal_filter

PCD_CAPACITY = 16384  # per-frame cloud budget of get_pcd_from_rgbd


class CameraSource(Protocol):
    def get_rgbd(self): ...
    def rs_get_intrinsics(self): ...
    def get_pcd_from_rgbd(self, mask) -> PointCloud: ...
    def stop(self) -> None: ...


def _depth_to_cloud(depth: torch.Tensor, mask: torch.Tensor, intr: Intrinsics) -> PointCloud:
    """Masked back-projection, a uniform sample of PCD_CAPACITY points and
    statistical outlier removal (20 neighbours, 1.0 sigma). The sample uses
    a generator seeded afresh on every call: the same frame gives the same
    cloud."""
    cloud = backproject_depth(depth, intr, mask=mask, depth_min=1e-6)
    gen = torch.Generator(device=depth.device).manual_seed(0)
    cloud = random_sample(cloud, PCD_CAPACITY, gen)
    return remove_statistical_outlier(cloud, nb_neighbors=20, std_ratio=1.0)


class _BaseCamera:
    """The shared depth -> cloud path."""

    intrinsics: Intrinsics
    device: torch.device
    color: Optional[np.ndarray] = None
    depth: Optional[torch.Tensor] = None  # metres, filtered, on the device

    def rs_get_intrinsics(self):
        return self.intrinsics, self.intrinsics.K

    @traced("camera.cloud")
    def get_pcd_from_rgbd(self, mask) -> PointCloud:
        if self.depth is None:
            raise RuntimeError("call get_rgbd() before get_pcd_from_rgbd()")
        m = torch.as_tensor(np.asarray(mask) if not torch.is_tensor(mask) else mask,
                            device=self.depth.device)
        return _depth_to_cloud(self.depth, m, self.intrinsics)

    def stop(self) -> None:
        pass

    def _condition(self, d: torch.Tensor) -> torch.Tensor:
        """The RealSense post-processing chain: spatial, temporal against
        the previous frame, hole filling."""
        d = spatial_filter(d)
        if self._prev is not None:
            d = temporal_filter(d, self._prev)
        self._prev = d
        return hole_filling_filter(d)


class ReplayCamera(_BaseCamera):
    """Replays recorded frames ``[(color (H, W, 3) uint8 BGR, depth (H, W)
    float32 metres), ...]``, with the live camera's depth conditioning
    unless ``filter_depth=False``; loops when exhausted if ``loop``."""

    def __init__(self, frames: Sequence, intrinsics: Intrinsics, filter_depth: bool = True,
                 loop: bool = True, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.frames = list(frames)
        if not self.frames:
            raise ValueError("ReplayCamera needs at least one frame")
        self.intrinsics = intrinsics
        self.filter_depth = filter_depth
        self.loop = loop
        self._i = 0
        self._prev = None

    def get_rgbd(self):
        if self._i >= len(self.frames):
            if not self.loop:
                return None
            self._i = 0
        color, depth = self.frames[self._i]
        self._i += 1
        d = torch.as_tensor(np.asarray(depth, np.float32), device=self.device)
        if self.filter_depth:
            d = self._condition(d)
        self.color = np.asarray(color)
        self.depth = d
        return self.color

    @property
    def exhausted(self) -> bool:
        return (not self.loop) and self._i >= len(self.frames)


def _as_mesh_arrays(mesh, device):
    """A TriangleMesh or a (vertices, faces) pair of arrays or tensors ->
    device tensors."""
    v, f = (mesh.vertices, mesh.faces) if hasattr(mesh, "vertices") else mesh
    return (torch.as_tensor(v, device=device).to(torch.float32),
            torch.as_tensor(f, device=device).to(torch.int64))


class SyntheticCamera(_BaseCamera):
    """Renders a CAD model along a pose trajectory: a ground-truth-bearing
    camera for tests and benchmarks. Each ``get_rgbd`` renders the next
    pose of ``poses`` and keeps it in ``current_gt``.

    Instruments: by default the point splat (depth) with the headlight
    shader (colour) over ``cad_points`` / ``cad_normals``; ``mesh`` (a
    ``TriangleMesh`` or ``(vertices, faces)``) switches to the exact
    triangle raster (kernel K2 over the full frame) with depth-gradient
    shading; ``depth_fn(T_m2c) -> (H, W)`` depth (e.g. ``camera.analytic``)
    takes precedence over both for single-pose streams.

    ``poses`` yielding stacked ``(N, 4, 4)`` arrays renders N instances
    composited by nearest depth; ``object_masks`` then holds each instance's
    visible silhouette and ``object_mask`` their union. ``instance_geoms``
    ([(points, normals), ...]) / ``instance_meshes`` make instance i render
    entry ``i % len``.

    ``occluder=(x0_px, x1_px, z_m)``: a plate at depth ``z_m`` over columns
    [x0, x1). ``background_depth > 0``: a wall at that depth behind
    everything. ``noise_sigma``: Gaussian depth noise from a numpy generator
    seeded with ``seed``. ``filter_depth``: the RealSense conditioning chain.
    ``object_mask`` is the visible object silhouette (what a perfect
    segmentation model outputs).
    """

    def __init__(
        self,
        cad_points: np.ndarray,
        cad_normals: np.ndarray,
        poses: Iterable[np.ndarray],
        intrinsics: Intrinsics,
        noise_sigma: float = 0.0,
        background_depth: float = 0.0,
        occluder: Optional[tuple] = None,
        seed: int = 0,
        filter_depth: bool = False,
        instance_geoms: Optional[list] = None,
        mesh=None,
        instance_meshes: Optional[list] = None,
        depth_fn=None,
        device: str | torch.device = "cuda",
    ):
        self.device = dev = resolve_device(device)
        self.intrinsics = intrinsics
        as_f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
        self._pts = as_f32(cad_points)
        self._nrm = as_f32(cad_normals)
        self._valid = torch.ones(len(cad_points), dtype=torch.bool, device=dev)
        self._inst = None
        if instance_geoms is not None:
            self._inst = [(as_f32(p), as_f32(n), torch.ones(len(p), dtype=torch.bool, device=dev))
                          for p, n in instance_geoms]
        self._mesh = _as_mesh_arrays(mesh, dev) if mesh is not None else None
        self._depth_fn = depth_fn
        self._inst_mesh = ([_as_mesh_arrays(m, dev) for m in instance_meshes]
                           if instance_meshes is not None else None)
        self._poses = iter(poses)
        self._noise = noise_sigma
        self._bg = background_depth
        if occluder is not None:
            x0, x1, z = occluder
            if not (0 <= x0 < x1 <= intrinsics.width) or z <= 0:
                raise ValueError(f"bad occluder {occluder!r}")
        self._occluder = occluder
        self.object_mask: Optional[np.ndarray] = None
        self.object_masks: Optional[np.ndarray] = None  # (N, H, W)
        self.frames_served = 0  # camera-frame clock
        self._rng = np.random.default_rng(seed)
        self.filter_depth = filter_depth
        self._prev: Optional[torch.Tensor] = None
        self.current_gt: Optional[np.ndarray] = None

    def _render_mesh(self, mesh_arrays, T):
        """One exact-raster frame: depth and gradient-shaded colour, numpy."""
        v, f = mesh_arrays
        d = render_depth_mesh(v, f, torch.as_tensor(T, device=self.device), self.intrinsics,
                              near=0.01, far=10.0)
        return d.cpu().numpy(), shade_depth_image(d, self.intrinsics).cpu().numpy()

    def _render_splat(self, geom, T):
        pts, nrm, val = geom
        d, rgb = render_shaded(pts, nrm, val, torch.as_tensor(T, device=self.device),
                               self.intrinsics, near=0.01, far=10.0)
        return d.cpu().numpy(), rgb.cpu().numpy()

    def get_rgbd(self):
        try:
            T = next(self._poses)
        except StopIteration:
            return None
        self.frames_served += 1
        T = np.asarray(T, np.float32)
        self.current_gt = T
        if T.ndim == 2:
            if self._depth_fn is not None:
                d = np.asarray(self._depth_fn(T), np.float32)
                rgb = np.where((d > 0)[..., None], np.float32(0.6), np.float32(1.0))
            elif self._mesh is not None:
                d, rgb = self._render_mesh(self._mesh, T)
            else:
                d, rgb = self._render_splat((self._pts, self._nrm, self._valid), T)
            return self._finish_frame(d, rgb, (d > 0)[None])
        # multi-instance composite: nearest-depth merge of per-instance
        # renders; an instance's visible mask is the pixels it wins
        depths, rgbs = [], []
        for i, Ti in enumerate(T):
            if self._inst_mesh is not None or self._mesh is not None:
                m = (self._inst_mesh[i % len(self._inst_mesh)] if self._inst_mesh is not None
                     else self._mesh)
                di, ri = self._render_mesh(m, Ti)
            else:
                geom = (self._inst[i % len(self._inst)] if self._inst
                        else (self._pts, self._nrm, self._valid))
                di, ri = self._render_splat(geom, Ti)
            depths.append(di)
            rgbs.append(ri)
        D = np.stack(depths)  # (N, H, W)
        Z = np.where(D > 0, D, np.inf)
        zmin = Z.min(0)
        d = np.where(np.isinf(zmin), 0.0, zmin).astype(np.float32)
        visible = (D > 0) & (Z <= zmin[None] + 1e-6)
        rgb = np.ones_like(rgbs[0])  # white background
        for i in range(len(T)):
            rgb = np.where(visible[i][..., None], rgbs[i], rgb)
        return self._finish_frame(d, rgb, visible)

    def _finish_frame(self, d, rgb, visible):
        """The occluder / background / noise / filter tail; ``visible`` is
        the (N, H, W) stack of per-instance visible silhouettes."""
        if self._occluder is not None:
            x0, x1, z = self._occluder
            stripe = np.zeros_like(d, bool)
            stripe[:, int(x0):int(x1)] = True
            covers = stripe & ((d <= 0) | (d > z))
            d = np.where(covers, np.float32(z), d)
            rgb = np.where(covers[..., None], np.float32(0.5), rgb)
            visible = visible & ~covers[None]
        self.object_masks = visible
        self.object_mask = visible.any(0)
        if self._bg > 0:
            d = np.where(d == 0, self._bg, d)
        if self._noise > 0:
            d = np.where(d > 0, d + self._rng.normal(0, self._noise, d.shape), d)
        dt = torch.as_tensor(np.asarray(d, np.float32), device=self.device)
        if self.filter_depth:
            dt = self._condition(dt)
        self.depth = dt
        self.color = np.ascontiguousarray((np.asarray(rgb)[..., ::-1] * 255).astype(np.uint8))
        return self.color


class RealSenseCamera(_BaseCamera):
    """A live Intel RealSense camera. Needs ``pyrealsense2`` and a connected
    device; raises at construction otherwise."""

    def __init__(self, width: int = 640, height: int = 480, fps: int = 30,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        try:
            import pyrealsense2 as rs
        except ImportError as e:
            raise RuntimeError(
                "pyrealsense2 is not available; use ReplayCamera/SyntheticCamera") from e
        ctx = rs.context()
        if len(ctx.devices) == 0:
            raise RuntimeError("No Intel RealSense device connected.")
        self._rs = rs
        self.pipe = rs.pipeline()
        cfg = rs.config()
        cfg.enable_stream(rs.stream.depth, width, height, rs.format.z16, fps)
        cfg.enable_stream(rs.stream.color, width, height, rs.format.bgr8, fps)
        self.profile = self.pipe.start(cfg)
        self.align = rs.align(rs.stream.color)
        self.depth_scale = self.profile.get_device().first_depth_sensor().get_depth_scale()
        intr = self.profile.get_stream(rs.stream.color).as_video_stream_profile().get_intrinsics()
        self.intrinsics = Intrinsics(fx=intr.fx, fy=intr.fy, cx=intr.ppx, cy=intr.ppy,
                                     width=intr.width, height=intr.height)
        self._prev = None

    def get_rgbd(self):
        frameset = self.align.process(self.pipe.wait_for_frames())
        depth_frame = frameset.get_depth_frame()
        color_frame = frameset.get_color_frame()
        if not depth_frame or not color_frame:
            return None
        raw = np.asanyarray(depth_frame.get_data()).astype(np.float32) * self.depth_scale
        self.depth = self._condition(torch.as_tensor(raw, device=self.device))
        self.color = np.asanyarray(color_frame.get_data())
        return self.color

    def stop(self) -> None:
        self.pipe.stop()
