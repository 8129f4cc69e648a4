"""Synthetic scene generator (counterpart of
``poseestimator_tpu/training/synth.py``): domain-randomised YOLO-seg
datasets and BOP-format scenes straight from CAD models, on the device.

Every instance (labelled objects and unlabelled distractor clutter) is
rendered into a shared z-buffer, so mutual occlusion is exact and each
instance's visible mask is the set of pixels it wins. Objects render as
point splats (``render/points.py``) or, with ``depth_instrument="mesh"``,
through the exact triangle raster: one batched launch of kernel K2 over
the object slots a frame (``render/raster.py::render_depth_mesh_batched``),
shaded from the depth's own gradients; distractors always splat. The host
composes a procedural background, adds noise and a gain, and writes JPEG
images and YOLO-seg labels with a ``dataset.yaml``, and with ``bop=True``
a BOP scene (PNG ``rgb/``, 16-bit ``depth/``, ``mask_visib/``,
``scene_gt.json``, ``scene_camera.json``).

Every random draw is the JAX package's call on the same
``np.random.Generator`` in the same order, so one seed gives the same
scenes. Where several splatted points of one instance win the same pixel,
the highest point index colours it (the JAX package leaves the winner of
duplicate writes unspecified).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..geom3d.camera import Intrinsics
from ..geom3d.se3 import transform_points
from ..models.yolo.contours import contour_area
from ..models.yolo.masks import masks_to_polygons
from ..render.mesh import TriangleMesh, decimate_to_faces, pad_faces
from ..render.points import render_depth
from ..render.raster import depth_lambert, render_depth_mesh_batched
from ..utils.draw import circle, rectangle
from ..utils.image import write_image
from ..utils.imgproc import resize_cubic_f32

# ---------------------------------------------------------------------------
# scene rendering (device)
# ---------------------------------------------------------------------------


def _scene_parts(pts, nrm, valid, Ts, colors, light, intr: Intrinsics):
    """Per-instance splat renders before the merge: (K, H, W) depth and
    (K, H, W, 3) rgb. pts / nrm (K, N, 3), valid (K, N), Ts (K, 4, 4),
    colors (K, 3), light (3,) the direction the light shines along."""
    H, W = intr.height, intr.width
    ds, rgbs = [], []
    for p, n, va, T, col in zip(pts, nrm, valid, Ts, colors):
        d = render_depth(p, va, T, intr, near=0.01, far=10.0)
        cam = transform_points(T, p)
        z = cam[:, 2]
        ok = va & (z > 0.01) & (z < 10.0)
        zs = torch.where(ok, z, torch.ones_like(z))
        u = torch.round(intr.fx * cam[:, 0] / zs + intr.cx).clamp(-1, W).to(torch.int64)
        v = torch.round(intr.fy * cam[:, 1] / zs + intr.cy).clamp(-1, H).to(torch.int64)
        in_img = ok & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        flat = torch.where(in_img, v * W + u, torch.full_like(u, H * W))
        won = in_img & (z <= d.reshape(-1)[flat.clamp(max=H * W - 1)] + 1e-4)
        n_cam = n @ T[:3, :3].T
        # two-sided Lambertian with an ambient floor: area-sampled normals
        # of thin shells can face either way
        shade = 0.25 + 0.75 * torch.clamp((n_cam * light[None, :]).sum(1).abs(), 0.0, 1.0)
        owner = torch.full((H * W + 1,), -1, dtype=torch.int64, device=p.device)
        owner.scatter_reduce_(0, torch.where(won, flat, torch.full_like(flat, H * W)),
                              torch.arange(p.shape[0], device=p.device), "amax")
        owner = owner[: H * W]
        img = torch.where((owner >= 0)[:, None], shade[owner.clamp(min=0)][:, None] * col[None, :],
                          torch.zeros((), device=p.device))
        ds.append(d)
        rgbs.append(img.reshape(H, W, 3))
    if not ds:  # no slot (the mesh instrument without distractors)
        return pts.new_zeros((0, H, W)), pts.new_zeros((0, H, W, 3))
    return torch.stack(ds), torch.stack(rgbs)


def _merge(ds, rgbs):
    """Shared z-buffer over (K, H, W) depths: -> (depth (H, W), rgb (H, W,
    3), vis (K, H, W)); the nearest instance wins a pixel, the first on
    ties."""
    dpos = torch.where(ds > 0, ds, torch.full_like(ds, float("inf")))
    combined = dpos.amin(dim=0)
    win = torch.argmin(dpos, dim=0)
    covered = torch.isfinite(combined)
    vis = covered[None] & (win[None] == torch.arange(ds.shape[0], device=ds.device)[:, None, None])
    rgb = torch.gather(rgbs, 0, win[None, :, :, None].expand(1, *rgbs.shape[1:]))[0]
    rgb = torch.where(covered[..., None], rgb, torch.zeros_like(rgb))
    depth = torch.where(covered, combined, torch.zeros_like(combined))
    return depth, rgb, vis


def _scene_render(pts, nrm, valid, Ts, colors, light, intr: Intrinsics):
    """K splatted instances in one scene with exact mutual occlusion:
    (depth (H, W) m, rgb (H, W, 3) in [0, 1], vis (K, H, W) bool)."""
    return _merge(*_scene_parts(pts, nrm, valid, Ts, colors, light, intr))


def _mesh_parts(verts, faces, slot_valid, Ts, colors, intr: Intrinsics):
    """Exact triangle-raster renders of the object slots, one batched K2
    launch: verts (Ko, V, 3) and faces (Ko, F, 3) padded to common
    capacities; an invalid slot's faces are emptied (degenerate) and its
    depth is 0. Colour is shaded from the depth's gradients."""
    faces = torch.where(slot_valid[:, None, None], faces, torch.zeros_like(faces))
    d = render_depth_mesh_batched(verts, faces, Ts, intr, near=0.01, far=10.0)
    d = torch.where(slot_valid[:, None, None], d, torch.zeros_like(d))
    rgbs = []
    for dk, col in zip(d, colors):
        shade = 0.25 + 0.75 * depth_lambert(dk, intr)
        rgbs.append(torch.where((dk > 0)[..., None], shade[..., None] * col[None, None, :],
                                torch.zeros((), device=d.device)))
    return d, torch.stack(rgbs)


# ---------------------------------------------------------------------------
# randomisation helpers (host numpy, the JAX package's draws)
# ---------------------------------------------------------------------------


def _rand_rotation(rng: np.random.Generator) -> np.ndarray:
    """Uniform SO(3) sample via a normalised quaternion."""
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def _place_instance(rng, intr, diag, dist_range=(1.6, 3.2), margin=0.18):
    """Random model -> camera pose: uniform rotation; an anchor pixel inside
    the image margins back-projected at a diagonal-scaled distance."""
    z = float(diag * rng.uniform(*dist_range))
    u = rng.uniform(margin, 1.0 - margin) * intr.width
    v = rng.uniform(margin, 1.0 - margin) * intr.height
    t = np.array([(u - intr.cx) / intr.fx * z, (v - intr.cy) / intr.fy * z, z], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = _rand_rotation(rng)
    T[:3, 3] = t
    return T


def _distractor_cloud(rng: np.random.Generator, n: int, scale: float):
    """Random clutter (an ellipsoid or a box shell): surface samples and
    outward normals about the origin at ~``scale`` extent."""
    half = scale * rng.uniform(0.25, 0.6, size=3).astype(np.float32)
    if rng.random() < 0.5:  # ellipsoid
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
        pts = d * half[None, :]
        nrm = pts / np.maximum(half[None, :] ** 2, 1e-9)  # gradient of the implicit
        nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-9)
    else:  # box shell: a face per point
        face = rng.integers(0, 6, size=n)
        uvw = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
        pts = uvw * half[None, :]
        nrm = np.zeros((n, 3), np.float32)
        ax, sgn = face // 2, np.where(face % 2 == 0, 1.0, -1.0).astype(np.float32)
        pts[np.arange(n), ax] = sgn * half[ax]
        nrm[np.arange(n), ax] = sgn
    return pts.astype(np.float32), nrm.astype(np.float32)


def _procedural_background(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """(H, W, 3) uint8: a linear gradient, low-frequency blotches (a tiny
    random grid, cubic-upsampled) and a few flat rectangles and discs."""
    c0 = rng.uniform(20, 235, size=3)
    c1 = rng.uniform(20, 235, size=3)
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    theta = rng.uniform(0, 2 * np.pi)
    ramp = gx * np.cos(theta) + gy * np.sin(theta)
    ramp = (ramp - ramp.min()) / max(float(np.ptp(ramp)), 1e-6)
    bg = c0[None, None, :] + ramp[..., None] * (c1 - c0)[None, None, :]
    grid = rng.uniform(-30, 30, size=(max(h // 40, 2), max(w // 40, 2), 3))
    bg = bg + resize_cubic_f32(grid.astype(np.float32), w, h)
    for _ in range(int(rng.integers(0, 6))):
        col = rng.uniform(0, 255, size=3).tolist()
        if rng.random() < 0.5:
            p0 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
            p1 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
            rectangle(bg, p0, p1, col)
        else:
            c = (int(rng.integers(0, w)), int(rng.integers(0, h)))
            circle(bg, c, int(rng.integers(4, max(min(h, w) // 4, 5))), col)
    return np.clip(bg, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------


@dataclass
class SynthConfig:
    cad: Sequence[str]  # "name=path.ply" or bare paths (the stem names the class)
    out: str
    n_train: int = 64
    n_val: int = 16
    width: int = 640
    height: int = 480
    fov_deg: float = 60.0  # the template camera's FoV
    max_objects: int = 3  # labelled instances per scene (>= 1)
    max_distractors: int = 2  # unlabelled occluders per scene
    points_per_object: int = 60_000  # splat density (hole-free at 640x480)
    min_visib_px: int = 64  # skip instances occluded below this
    dist_range: tuple = (1.6, 3.2)  # camera distance in object diagonals
    noise_sigma: float = 3.0  # additive pixel noise (uint8 units)
    bop: bool = False  # also write scene_gt/scene_camera/depth/mask_visib
    depth_scale: float = 1.0  # BOP depth_scale (the depth PNG holds mm / depth_scale)
    depth_instrument: str = "splat"  # or "mesh": objects through the exact raster (K2)
    seed: int = 0
    device: str = "cuda"


@dataclass
class SynthObject:
    name: str
    points: np.ndarray  # (N, 3) float32, metres
    normals: np.ndarray
    diag: float
    cls: int
    verts: Optional[np.ndarray] = None  # raster assets: decimated vertices / faces
    faces: Optional[np.ndarray] = None


def load_objects(cad_specs: Sequence[str], n_points: int, seed: int = 0):
    """``name=path`` (or bare path) CAD specs -> sampled surfaces and
    decimated (<= 4096 faces) raster meshes; mm-scale CADs are scaled to
    metres."""
    rng = np.random.default_rng(seed)
    objs = []
    for i, spec in enumerate(cad_specs):
        if "=" in spec:
            name, path = spec.split("=", 1)
        else:
            path = spec
            name = os.path.splitext(os.path.basename(path))[0]
        mesh = TriangleMesh.load(path)
        if np.max(mesh.extent) >= 1.0:
            mesh = mesh.scale(0.001, center=np.zeros(3))
        pts, nrm = mesh.sample_points_uniformly(n_points, rng)
        dec = decimate_to_faces(mesh, 4096)
        objs.append(SynthObject(name=name, points=pts, normals=nrm,
                                diag=float(np.linalg.norm(mesh.extent)), cls=i,
                                verts=np.asarray(dec.vertices, np.float32),
                                faces=np.asarray(dec.faces, np.int32)))
    return objs


def _write_yolo_label(path, entries):
    """entries: list of (cls, polygon (K, 2) normalised)."""
    lines = [f"{cls} " + " ".join(f"{v:.5f}" for v in np.asarray(poly).reshape(-1))
             for cls, poly in entries]
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))


def _visible_polygon(mask: np.ndarray, min_px: int) -> Optional[np.ndarray]:
    """The largest outer border of the visible mask, if its area holds at
    least half the visible pixels (a heavily fragmented mask is too
    occluded to label cleanly)."""
    area = int(mask.sum())
    if area < min_px:
        return None
    polys = masks_to_polygons(mask)
    if not polys or contour_area(polys[0]) < 0.5 * area:
        return None
    return polys[0]


def generate(cfg: SynthConfig, log=print) -> dict:
    """Generate the dataset. Returns a summary (paths, counts, and host
    milliseconds by stage under ``"timing_ms"``)."""
    dev = resolve_device(cfg.device)
    if cfg.depth_instrument not in ("splat", "mesh"):
        raise ValueError(f"depth_instrument {cfg.depth_instrument!r}: 'splat' or 'mesh'")
    objs = load_objects(cfg.cad, cfg.points_per_object, cfg.seed)
    intr = Intrinsics.from_fov(cfg.fov_deg, cfg.width, cfg.height)
    rng = np.random.default_rng(cfg.seed)

    K = cfg.max_objects + cfg.max_distractors
    N = cfg.points_per_object
    pts = np.zeros((K, N, 3), np.float32)
    nrm = np.zeros((K, N, 3), np.float32)
    valid = np.zeros((K, N), bool)
    Ts = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    colors = np.zeros((K, 3), np.float32)

    use_mesh = cfg.depth_instrument == "mesh"
    Ko = cfg.max_objects
    if use_mesh:
        # common capacities: vertices padded with the last vertex, faces
        # with degenerate triples up to a multiple of 256
        v_cap = max(len(o.verts) for o in objs)
        f_cap = -(-max(len(o.faces) for o in objs) // 256) * 256
        obj_verts = {o.cls: np.pad(o.verts, ((0, v_cap - len(o.verts)), (0, 0)), mode="edge")
                     for o in objs}
        obj_faces = {o.cls: pad_faces(o.faces, f_cap) for o in objs}
        vbuf = np.zeros((Ko, v_cap, 3), np.float32)
        fbuf = np.zeros((Ko, f_cap, 3), np.int32)
        slot_ok = np.zeros((Ko,), bool)

    summary = {"out": cfg.out, "classes": {o.cls: o.name for o in objs}, "frames": {},
               "skipped_instances": 0}
    timing = {"render": 0.0, "background": 0.0, "jpeg": 0.0, "png": 0.0}
    bop_gt, bop_cam = {}, {}
    if cfg.bop:
        for d in ("rgb", "depth", "mask_visib"):
            os.makedirs(os.path.join(cfg.out, d), exist_ok=True)
    put = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731

    frame_id = 0
    for split, n_frames in (("train", cfg.n_train), ("val", cfg.n_val)):
        img_dir = os.path.join(cfg.out, split, "images")
        lbl_dir = os.path.join(cfg.out, split, "labels")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(lbl_dir, exist_ok=True)
        written = 0
        for _ in range(n_frames):
            n_obj = int(rng.integers(1, cfg.max_objects + 1))
            n_dis = int(rng.integers(0, cfg.max_distractors + 1))
            valid[:] = False
            cls_of_slot = [-1] * K
            mean_diag = float(np.mean([o.diag for o in objs]))
            if use_mesh:
                slot_ok[:] = False
            for k in range(n_obj):
                o = objs[int(rng.integers(0, len(objs)))]
                pts[k], nrm[k] = o.points, o.normals
                valid[k] = True
                Ts[k] = _place_instance(rng, intr, o.diag, cfg.dist_range)
                colors[k] = rng.uniform(0.15, 1.0, size=3)
                cls_of_slot[k] = o.cls
                if use_mesh:
                    vbuf[k] = obj_verts[o.cls]
                    fbuf[k] = obj_faces[o.cls]
                    slot_ok[k] = True
            for k in range(cfg.max_objects, cfg.max_objects + n_dis):
                dp, dn = _distractor_cloud(rng, N, mean_diag)
                pts[k], nrm[k] = dp, dn
                valid[k] = True
                # distractors sit in the same depth band so they can occlude
                Ts[k] = _place_instance(rng, intr, mean_diag, cfg.dist_range)
                colors[k] = rng.uniform(0.15, 1.0, size=3)
            light = rng.normal(size=3)
            light[2] = abs(light[2]) + 0.5  # bias along the view direction
            light /= np.linalg.norm(light)

            t0 = time.perf_counter()
            light_t = put(light.astype(np.float32))
            if use_mesh:
                # objects through the exact raster, distractors splatted,
                # one shared z-buffer over both stacks
                ds_o, rgb_o = _mesh_parts(put(vbuf), put(fbuf), put(slot_ok), put(Ts[:Ko]),
                                          put(colors[:Ko]), intr)
                ds_d, rgb_d = _scene_parts(put(pts[Ko:]), put(nrm[Ko:]), put(valid[Ko:]),
                                           put(Ts[Ko:]), put(colors[Ko:]), light_t, intr)
                depth, rgb, vis = _merge(torch.cat([ds_o, ds_d]), torch.cat([rgb_o, rgb_d]))
            else:
                depth, rgb, vis = _scene_render(put(pts), put(nrm), put(valid), put(Ts),
                                                put(colors), light_t, intr)
            depth, rgb, vis = depth.cpu().numpy(), rgb.cpu().numpy(), vis.cpu().numpy()
            t1 = time.perf_counter()

            bg = _procedural_background(rng, cfg.height, cfg.width)
            covered = depth > 0
            img = np.where(covered[..., None], rgb * 255.0, bg.astype(np.float32))
            if cfg.noise_sigma > 0:
                img = img + rng.normal(0, cfg.noise_sigma, img.shape)
            gain = rng.uniform(0.85, 1.15)
            img = np.clip(img * gain, 0, 255).astype(np.uint8)
            img_bgr = np.ascontiguousarray(img[..., ::-1])
            t2 = time.perf_counter()
            timing["render"] += (t1 - t0) * 1e3
            timing["background"] += (t2 - t1) * 1e3

            entries, gt_entries, inst_masks = [], [], []
            for k in range(n_obj):
                poly = _visible_polygon(vis[k], cfg.min_visib_px)
                if poly is None:
                    summary["skipped_instances"] += 1
                    continue
                p = poly.astype(np.float32)
                p[:, 0] /= cfg.width
                p[:, 1] /= cfg.height
                entries.append((cls_of_slot[k], np.clip(p, 0.0, 1.0)))
                gt_entries.append({"cam_R_m2c": Ts[k][:3, :3].reshape(-1).tolist(),
                                   "cam_t_m2c": (Ts[k][:3, 3] * 1000.0).tolist(),  # mm
                                   "obj_id": cls_of_slot[k] + 1})
                inst_masks.append(vis[k])
            if not entries:
                continue  # fully occluded draw: the next frame slot

            stem = f"{frame_id:06d}"
            t3 = time.perf_counter()
            write_image(os.path.join(img_dir, f"{stem}.jpg"), img_bgr)
            t4 = time.perf_counter()
            timing["jpeg"] += (t4 - t3) * 1e3
            _write_yolo_label(os.path.join(lbl_dir, f"{stem}.txt"), entries)
            if cfg.bop:
                write_image(os.path.join(cfg.out, "rgb", f"{stem}.png"), img_bgr)
                d16 = np.clip(depth * 1000.0 / cfg.depth_scale, 0, 65535).astype(np.uint16)
                write_image(os.path.join(cfg.out, "depth", f"{stem}.png"), d16)
                for j, m in enumerate(inst_masks):
                    write_image(os.path.join(cfg.out, "mask_visib", f"{stem}_{j:06d}.png"),
                                m.astype(np.uint8) * 255)
                bop_gt[str(frame_id)] = gt_entries
                bop_cam[str(frame_id)] = {
                    "cam_K": [intr.fx, 0.0, intr.cx, 0.0, intr.fy, intr.cy, 0.0, 0.0, 1.0],
                    "depth_scale": cfg.depth_scale}
                timing["png"] += (time.perf_counter() - t4) * 1e3
            written += 1
            frame_id += 1
        summary["frames"][split] = written
        log(f"{split}: {written} frames -> {img_dir}")

    yml = os.path.join(cfg.out, "dataset.yaml")
    with open(yml, "w") as f:
        f.write(f"path: {cfg.out}\ntrain: train\nval: val\nnames:\n")
        for o in objs:
            f.write(f'    {o.cls}: "{o.name}"\n')
    summary["dataset_yaml"] = yml
    summary["timing_ms"] = timing
    if cfg.bop:
        with open(os.path.join(cfg.out, "scene_gt.json"), "w") as f:
            json.dump(bop_gt, f)
        with open(os.path.join(cfg.out, "scene_camera.json"), "w") as f:
            json.dump(bop_cam, f)
        summary["scene_gt"] = os.path.join(cfg.out, "scene_gt.json")
    return summary
