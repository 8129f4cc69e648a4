"""Rank bodies of ``tests/test_torch_parallel.py``. ``torch.multiprocessing``
re-imports a rank body's module in every child process, so this module
imports no JAX: each rank runs every sharded path of the port once, on the
inputs the test wrote, and saves what it got for the test to compare."""
import os

import numpy as np
import torch


def run(io_dir: str, world: int) -> None:
    torch.set_num_threads(2)
    from poseestimator_tpu_torch.geom3d.camera import Intrinsics
    from poseestimator_tpu_torch.geom3d.cloud import PointCloud
    from poseestimator_tpu_torch.parallel import (ShardedDetector, make_mesh,
                                                  make_synthetic_search_inputs, replicate,
                                                  shard_along, sharded_chamfer,
                                                  sharded_multi_track, sharded_template_search)
    from poseestimator_tpu_torch.pipeline.detector import Detector
    from poseestimator_tpu_torch.pipeline.pose_estimator import PoseEstimator, search_templates
    from poseestimator_tpu_torch.pipeline.tracking import track_step_batched
    from poseestimator_tpu_torch.training import trainer as T

    inp = torch.load(os.path.join(io_dir, "inputs.pt"), weights_only=False)
    mesh, tmesh = make_mesh("dp"), make_mesh("tp")
    single = world == 1  # the world of one runs most single-device references
    out = {"shape": dict(mesh.shape), "tp_shape": dict(tmesh.shape), "rank": mesh.rank}

    # mesh helpers
    x = torch.arange(24.0).reshape(8, 3)
    out["shard"] = shard_along(mesh, x)
    out["shard_dict"] = shard_along(mesh, {"x": x, "y": [x[:, 0]]})
    out["replicate"] = replicate(mesh, x + mesh.rank)
    sub = make_mesh("dp", n_devices=1)  # rank 0 alone; the others are outside
    out["subgroup"] = None if sub is None else (sub.size, sub.rank)

    # sharded Chamfer
    for name, (a, av, b, bv) in inp["chamfer"].items():
        out[f"chamfer {name}"] = float(sharded_chamfer(mesh, a, av, b, bv))

    # the sharded product search on the synthetic fixture
    fx = make_synthetic_search_inputs(n_tpl=8, C=128, n_cad=1200, device="cpu")
    fx.pop("good_idx"), fx.pop("T_gt")
    out["search"] = sharded_template_search(tmesh, generator=torch.Generator().manual_seed(0),
                                            **fx)

    # PoseEstimator(mesh_devices=) on the L-shape (world 2); the
    # single-device estimator without the final prune (world 1)
    e = inp["estimator"]
    intr = Intrinsics.from_fov(60.0, 128, 96)
    cloud = PointCloud(points=e["points"], valid=e["valid"])
    kw = dict(target_points=100, seed=0, device="cpu")
    if single:
        est = PoseEstimator(e["cad"], e["views"], intr, search_final_topk=0, **kw)
    else:
        est = PoseEstimator(e["cad"], e["views"], intr, mesh_devices=tmesh, **kw)
    H, _, cand = est.find_best_template_candidates(cloud)
    out["estimator"] = (H, [(s, np.asarray(t), i) for s, t, i in cand])

    # sharded multi-object tracking
    t = inp["track"]
    args = (t["mesh_v"], t["mesh_f"], t["masks"], t["depth"], t["Ts"], t["intr"], 0, t["dists"])
    out["track"] = sharded_multi_track(mesh, *args, generator=torch.Generator().manual_seed(0))
    j = inp["track_jax"]
    if not single:  # the JAX package's draws, B = 2, against its 2-device mesh
        out["track jax draws"] = sharded_multi_track(
            mesh, t["mesh_v"], t["mesh_f"], j["masks"], t["depth"], j["Ts"], t["intr"], 0,
            j["dists"], draws=j["draws"])

    # batch-sharded detection serving
    d = inp["detector"]
    det = Detector(d["state_dict"], nc=3, imgsz=64, max_det=8, device="cpu")
    sd = ShardedDetector.from_detector(det, mesh)
    dets, boxes = sd(d["images"], conf=0.001)
    out["detector"] = (dets, boxes)
    if single:
        out["detector single"] = det.predict_batch(d["images"], conf=0.001)
    else:
        try:
            sd(d["images"][:3])
            out["indivisible raised"] = False
        except ValueError as err:
            out["indivisible raised"] = "divisible" in str(err)

    # data-parallel training: two steps, then a one-epoch fit
    cfg = T.TrainConfig(data=inp["dataset"], epochs=1, imgsz=64, batch=4, max_instances=4,
                        warmup_epochs=0.0, workers=0, augment=False, val_map_every=1,
                        project=os.path.join(io_dir, f"runs{world}"), name="dp", device="cpu")
    tr = T.Trainer(cfg, nc=1, mesh=mesh)
    state = tr.init_state()
    steps, batches = [], tr._batches(tr.loader)
    for _ in range(2):
        state, parts = tr._train_step(state, *tr._tensors(next(batches)))
        steps.append({"parts": {k: float(v) for k, v in parts.items()},
                      "lr": tr.last_lr, "mu": [m.clone() for m in state.opt_state["mu"]],
                      "params": {k: v.detach().clone() for k, v in state.params.items()},
                      "ema": {k: v.clone() for k, v in state.ema_params.items()},
                      "stats": {k: v.clone() for k, v in state.batch_stats.items()}})
    out["train"] = steps
    tr = T.Trainer(cfg, nc=1, mesh=mesh)
    saves = []
    orig_save = tr.save
    tr.save = lambda *a, **k: (saves.append(a[1]), orig_save(*a, **k))
    _, history = tr.fit(log=lambda *a: None, tensorboard=False)
    out["fit"] = {"saves": [os.path.basename(p) for p in saves], "history": history}

    # world 2's ranks, otherwise done first, run two single-device references
    if world == 2 and mesh.rank == 0:
        r = track_step_batched(t["mesh_v"], t["mesh_f"], t["masks"], t["depth"], t["Ts"],
                               t["intr"], t["dists"], target_pts=0, icp_pose_tol=5e-5,
                               generator=torch.Generator().manual_seed(0))
        out["track single"] = (r.T, r.fitness, r.rmse, r.cov)
    if world == 2 and mesh.rank == 1:
        r = search_templates(fx["dst_points"], fx["dst_valid"], fx["tpl_points"],
                             fx["tpl_valid"], fx["tpl_fpfh"], fx["cad_points"], fx["cad_valid"],
                             fx["intr"], fx["mask_sil"], True, 0.05,
                             torch.Generator().manual_seed(0), n_final=None,
                             render_kind="points")
        out["search single"] = (r[0], r[4], r[3])

    torch.save(out, os.path.join(io_dir, f"world{world}_rank{mesh.rank}.pt"))
