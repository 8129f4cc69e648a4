"""The JAX package's template search on ``chip_smoke.py``'s observation (b):
the bench box CAD seen from 0.5 m along the direction of template view 11,
perturbed by 0.1 rad, at 640x480 with its detection mask. Prints the
winning template and the ADD-S against the true pose, the reference result
for the port's search on the card. Runs on the CPU:

    JAX_PLATFORMS=cpu python tools/port_search_reference.py
"""
from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke as cs
    from poseestimator_tpu import geom3d as g3
    from poseestimator_tpu.pipeline import PoseEstimator
    from poseestimator_tpu.render.mesh import pad_faces
    from poseestimator_tpu.render.raster import render_depth_mesh
    from poseestimator_tpu.utils.plyio import write_ply
    from poseestimator_tpu_torch import kernel_cases as kc
    from poseestimator_tpu_torch.geom3d.se3 import look_at

    verts = kc.box_vertices()
    intr = g3.Intrinsics.from_fov(60.0, 640, 480)
    T_b = cs.view_pose((1.0, 1.0, 1.0), 0.5, 0.1, look_at, kc.GL_TO_CV)
    with tempfile.TemporaryDirectory() as tmp:
        cad = os.path.join(tmp, "box.ply")
        write_ply(cad, verts, faces=kc.BOX_FACES)
        est = PoseEstimator(cad, os.path.join(tmp, "views"), intr)
        depth = render_depth_mesh(jnp.asarray(verts), jnp.asarray(pad_faces(kc.BOX_FACES, 256)),
                                  jnp.asarray(T_b), intr, near=0.01, far=5.0)
        cloud = g3.random_sample(
            jax.random.PRNGKey(2),
            g3.backproject_depth(depth, intr, depth_min=0.01, depth_max=5.0), 4096)
        H, _, cands = est.find_best_template_candidates(cloud, mask=np.asarray(depth) > 0)
    pts = cs.box_surface(np.random.default_rng(1), 2000, kc.BOX_HALF).astype(np.float64)
    a = pts @ np.asarray(H, np.float64)[:3, :3].T + np.asarray(H, np.float64)[:3, 3]
    b = pts @ T_b[:3, :3].T.astype(np.float64) + T_b[:3, 3]
    adds = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1)).min(1).mean() * 100.0
    diag = float(np.linalg.norm(verts.max(0) - verts.min(0))) * 100.0
    print(f"JAX package, CPU, observation (b): winner template {cands[0][2]}, "
          f"ADD-S {adds:.4f} cm (0.1 x diag = {0.1 * diag:.3f} cm)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
