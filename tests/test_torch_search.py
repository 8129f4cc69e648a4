"""Port parity, the template search end to end, on the two scenes of
``tests/test_pipeline.py`` (the L-shape CAD seen from near two template
views by a 128x96 camera: the strict 1e-6 regime).

The CAD and its template database are written by the port; the JAX
package's estimator is built once from those files (the port -> JAX half of
the disk contract, and no JAX template rendering). The search is compared
on the same prepared templates: the port's estimator is built from the JAX
package's voxel clouds and FPFH features (``PoseEstimator.from_prepared``),
so no feature rounding upstream of the search enters. Randomness differs
between the packages, so the poses are held to accuracy: ADD < 0.1 x the
CAD's diagonal against the ground truth and against the JAX package's pose.
The port's own template preparation is held to the JAX package's (equal
voxel clouds, normals where the neighbourhood fixes them, FPFH within 1e-3
on >= 99% of the points from the same normals) and searched end to end as
well."""
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseestimator_tpu import geom3d as g3
from poseestimator_tpu.geom3d.cloud import compact as j_compact
from poseestimator_tpu.geom3d.fpfh import compute_fpfh as j_fpfh
from poseestimator_tpu.geom3d.normals import estimate_normals as j_estimate_normals
from poseestimator_tpu.pipeline import PoseEstimator as JPoseEstimator
from poseestimator_tpu.pipeline.pose_estimator import raster_assets as j_raster_assets
from poseestimator_tpu.pipeline.pose_estimator import score_pose_candidates as j_score
from poseestimator_tpu.render.raster import render_depth_mesh as j_render
from poseestimator_tpu_torch.geom3d.camera import Intrinsics
from poseestimator_tpu_torch.geom3d.cloud import PointCloud
from poseestimator_tpu_torch.geom3d.fpfh import compute_fpfh
from poseestimator_tpu_torch.geom3d.knn import radius_knn
from poseestimator_tpu_torch.geom3d.normals import estimate_normals
from poseestimator_tpu_torch.pipeline.pose_estimator import PoseEstimator, score_pose_candidates
from poseestimator_tpu_torch.render.mesh import TriangleMesh
from poseestimator_tpu_torch.utils.plyio import write_ply

from helpers import l_shape_mesh
from torch_threads import two_threads  # noqa: F401

J_INTR = g3.Intrinsics.from_fov(60.0, 128, 96)
T_INTR = Intrinsics.from_fov(60.0, 128, 96)
_GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
SCENES = {"near view 11": dict(angle=0.1, dirv=(1.0, 1.0, 1.0), dist=2.0),
          "near view 6": dict(angle=0.25, dirv=(0.0, 1.0, 1.0), dist=2.4)}


def gt_pose(angle, dirv, dist):
    """tests/test_pipeline.py's pose: a camera looking at the object from
    near a template view direction, perturbed by ``angle``."""
    d = np.asarray(dirv, np.float64)
    d = d / np.linalg.norm(d)
    T_gl = np.asarray(g3.look_at(d * dist, [0, 0, 0], [0, 1, 0]))
    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = np.asarray(g3.rot_z(angle) @ g3.rot_x(angle * 0.5))
    return (P @ (_GL_TO_CV @ T_gl)).astype(np.float32)


@pytest.fixture(scope="module")
def estimators(tmp_path_factory):
    d = tmp_path_factory.mktemp("cad")
    mesh = l_shape_mesh()
    cad = str(d / "l.ply")
    write_ply(cad, mesh.vertices, faces=mesh.faces)
    port = PoseEstimator(cad, str(d / "views"), T_INTR, target_points=100, seed=0, device="cpu")
    ref = JPoseEstimator(cad, str(d / "views"), J_INTR, target_points=100, seed=0)
    return port, ref


def observe(ref, T_gt):
    """The exact-raster observation of test_pipeline.py, as numpy."""
    depth = j_render(ref._mesh_v, ref._mesh_f, jnp.asarray(T_gt), J_INTR, near=0.01, far=10.0)
    c = j_compact(g3.backproject_depth(depth, J_INTR, depth_min=0.01, depth_max=10.0), 16384)
    return np.asarray(c.points), np.asarray(c.valid), np.asarray(depth)


def add(H, T, verts):
    return float(np.mean(np.linalg.norm((verts @ H[:3, :3].T + H[:3, 3])
                                        - (verts @ T[:3, :3].T + T[:3, 3]), axis=1)))


def test_port_database_loads_in_jax(estimators):
    port, ref = estimators
    assert port.templates.paths == ref.templates.paths and port.templates.count == 5
    np.testing.assert_array_equal(port.templates.points.numpy(), np.asarray(ref.templates.points))
    np.testing.assert_array_equal(port.templates.valid.numpy(), np.asarray(ref.templates.valid))


def test_raster_assets_match(estimators):
    port, ref = estimators
    jv, jf = j_raster_assets(ref.mesh)
    np.testing.assert_array_equal(port._mesh_v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(port._mesh_f.numpy(), np.asarray(jf))


def test_prepared_templates_match(estimators):
    """Equal voxel clouds; normals equal wherever the neighbourhood fixes
    them; features from the same normals within 1% (relative L1) at every
    point. At a radius of one voxel many template points have fewer than
    three neighbours in general position: there the smallest eigenvalue is
    repeated, and each eigensolver returns its own vector of the plane. One
    pair angle that rounds across a bin edge moves one point's SPFH by a
    count, and the FPFH sum carries that to every point within 5 voxels, so
    the 1e-3 bound of tests/test_torch_features.py holds on most templates
    only."""
    port, ref = estimators
    assert port._search_cap == ref._search_cap
    jv = np.asarray(ref._tpl_valid)
    np.testing.assert_array_equal(port._tpl_valid.numpy(), jv)
    np.testing.assert_allclose(port._tpl_points.numpy(), np.asarray(ref._tpl_points), atol=1e-6)
    vox = ref.voxel_size
    n_fixed = n_close = 0
    for i in range(ref._tpl_points.shape[0]):
        pts, valid = np.array(ref._tpl_points[i]), jv[i]
        jc = j_estimate_normals(g3.cloud.PointCloud(points=jnp.asarray(pts),
                                                    valid=jnp.asarray(valid)),
                                radius=vox, max_nn=30, orient_towards=jnp.zeros(3))
        tc = estimate_normals(PointCloud(torch.from_numpy(pts), torch.from_numpy(valid)),
                              radius=vox, max_nn=30)
        _, idx, nb = radius_knn(torch.from_numpy(pts), torch.from_numpy(valid),
                                torch.from_numpy(pts), torch.from_numpy(valid), vox, 30)
        for k in np.flatnonzero(valid):
            nbrs = pts[idx[k][nb[k]].numpy()].astype(np.float64)
            ev = np.linalg.eigvalsh(np.cov(nbrs.T, bias=True)) if len(nbrs) > 2 else np.zeros(3)
            if ev[1] - ev[0] > 1e-2 * ev[2]:  # a unique smallest eigenvalue
                n_fixed += 1
                assert np.dot(np.asarray(jc.normals[k]), tc.normals[k].numpy()) >= 1 - 1e-5
        jf, _ = j_fpfh(jc, radius=vox * 5.0, max_nn=100)
        tf, _ = compute_fpfh(replace(tc, normals=torch.from_numpy(np.asarray(jc.normals))),
                             radius=vox * 5.0, max_nn=100)
        diff = np.abs(tf.numpy() - np.asarray(jf))[valid]
        rel = diff.sum(-1) / np.abs(np.asarray(jf)[valid]).sum(-1)
        assert rel.max() <= 0.01, np.sort(rel)[-5:]
        n_close += int((diff.max(-1) <= 1e-3).sum())
    assert n_fixed > 0.25 * jv.sum()  # the check is not vacuous
    assert n_close >= 0.8 * jv.sum()


@pytest.mark.parametrize("scene", list(SCENES))
def test_search_matches_reference(estimators, scene):
    port, ref = estimators
    T_gt = gt_pose(**SCENES[scene])
    pts, valid, _ = observe(ref, T_gt)
    H_ref, _ = ref.find_best_template_teaser(g3.cloud.PointCloud(points=jnp.asarray(pts),
                                                                   valid=jnp.asarray(valid)))
    same = PoseEstimator.from_prepared(
        TriangleMesh(vertices=ref.mesh.vertices, faces=ref.mesh.faces), T_INTR,
        np.asarray(ref._tpl_points), np.asarray(ref._tpl_valid), np.asarray(ref._tpl_fpfh),
        target_points=100, seed=1, device="cpu")
    H, src_down, cands = same.find_best_template_candidates(
        PointCloud(torch.from_numpy(pts), torch.from_numpy(valid)))
    verts = ref.mesh.vertices
    diag = float(np.linalg.norm(ref.mesh.extent))
    assert np.isfinite(H).all() and len(cands) == 5
    assert [c[0] for c in cands] == sorted(c[0] for c in cands)
    assert src_down.points.shape == tuple(ref._tpl_points.shape[1:])
    assert add(H, T_gt, verts) < 0.1 * diag, (add(H, T_gt, verts), diag)
    assert add(H, np.asarray(H_ref), verts) < 0.1 * diag
    assert add(np.asarray(H_ref), T_gt, verts) < 0.1 * diag  # the reference itself


def test_port_estimator_end_to_end(estimators):
    """The port's own templates, features and search, mask given."""
    port, ref = estimators
    T_gt = gt_pose(**SCENES["near view 11"])
    pts, valid, depth = observe(ref, T_gt)
    H, _ = port.find_best_template_teaser(PointCloud(torch.from_numpy(pts),
                                                     torch.from_numpy(valid)),
                                          mask=torch.from_numpy(depth > 0))
    diag = float(np.linalg.norm(ref.mesh.extent))
    assert add(H, T_gt, ref.mesh.vertices) < 0.1 * diag


def test_render_at_pose_and_candidate_scores(estimators):
    port, ref = estimators
    T_gt = gt_pose(**SCENES["near view 6"])
    tpl = port.create_template_from_H(T_gt, 100)
    assert int(tpl.count()) == 100
    pts, valid, depth = observe(ref, T_gt)
    d = torch.cdist(tpl.points[tpl.valid], torch.from_numpy(pts[valid])).min(1).values
    assert float(d.mean()) < 0.02  # on the observed surface
    Ts = np.stack([T_gt, gt_pose(0.3, (0.0, 1.0, 1.0), 2.4), gt_pose(0.1, (1.0, 1.0, 1.0), 2.0)])
    mask = depth > 0
    got = score_pose_candidates(port._mesh_v, port._mesh_f, torch.from_numpy(Ts),
                                torch.from_numpy(depth), torch.from_numpy(mask), T_INTR).numpy()
    want = np.asarray(j_score(ref._mesh_v, ref._mesh_f, jnp.asarray(Ts), jnp.asarray(depth),
                              jnp.asarray(mask), J_INTR))
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert got[0] < got[1] and got[0] < got[2]
