"""The port stands alone: importing ``poseestimator_tpu_torch`` (every
module, ``parallel`` and the ``compat`` namespace among them) and
``chip_smoke.py`` loads neither ``jax`` nor ``poseestimator_tpu``,
and works with ``jax``, flax, optax, orbax, OpenCV, PIL, PyYAML, imageio and
pyrealsense2 made unimportable; every app builds its parser; the entry
points, the apps, the evaluation harnesses, the detection scripts, the
per-stage profilers and the mosaic A/B, the trainer and generator included,
refuse to run without CUDA unless asked for the CPU. Checked in a
fresh interpreter, since this test process imports both packages."""
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
for m in ("jax", "flax", "optax", "orbax", "cv2", "PIL", "yaml", "imageio", "pyrealsense2"):
    sys.modules[m] = None  # importing any of them now raises ImportError
import poseestimator_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke
from poseestimator_tpu_torch.device import resolve_device
from poseestimator_tpu_torch.models.yolo.model import YOLO11Seg
from poseestimator_tpu_torch.pipeline.tracking import FusedFrame
from poseestimator_tpu_torch.geom3d.camera import Intrinsics
import numpy as np
from poseestimator_tpu_torch.training.synth import SynthConfig, generate
from poseestimator_tpu_torch.training.trainer import TrainConfig, Trainer
from poseestimator_tpu_torch.compat.EstimHelpers import HelpersRealtime
raised = []
for call in (lambda: resolve_device(),
             lambda: FusedFrame(YOLO11Seg(nc=5), np.zeros((8, 3), np.float32),
                                np.zeros((4, 3), np.int32), Intrinsics.from_fov(60, 64, 48)),
             lambda: Trainer(TrainConfig(data="x")),
             lambda: generate(SynthConfig(cad=["x"], out="x")),
             lambda: HelpersRealtime.enforce_upright_pose_y_up(np.eye(4))):
    try:
        call()
        raised.append(False)
    except RuntimeError:
        raised.append(True)
cpu_ok = resolve_device("cpu").type == "cpu"
from poseestimator_tpu_torch.apps import eval_bop, main_image, main_realsense, main_seibersdorf
from poseestimator_tpu_torch.apps import generate as generate_app, train, val
from poseestimator_tpu_torch.apps import (clique_sweep, eval_init, eval_tracking, mirror,
                                          predict, scaling_eval, testrun)
from poseestimator_tpu_torch.apps import ab_mosaic, profile_search, profile_stages
from poseestimator_tpu_torch.camera import record
apps_raised = []
for app, argv in ((main_image, ["--headless"]),
                  (main_realsense, ["--headless", "--source", "synthetic"]),
                  (main_seibersdorf, ["--headless", "--image", "x", "--cloud", "x",
                                      "--calib", "x"]),
                  (eval_bop, ["--scene-dir", "x", "--ply", "x", "--templates", "x"]),
                  (record, ["--out", "x"]),
                  (generate_app, ["--cad", "x", "--out", "x"]),
                  (train, ["--data", "x"]),
                  (val, ["--weights", "x"]),
                  (eval_tracking, ["--frames", "1"]),
                  (eval_init, ["--work-dir", "x"]),
                  (scaling_eval, ["--worlds", "1"]),
                  (clique_sweep, ["--budget", "1"]),
                  (predict, ["--image", "x"]),
                  (testrun, ["--image", "x", "--label", "x", "--save", "x"]),
                  (mirror, ["--image-dir", "x", "--label-dir", "x", "--out-image-dir", "x",
                            "--out-label-dir", "x"]),
                  (profile_stages, ["--frames", "1"]),
                  (profile_search, ["1", "--realistic"]),
                  (ab_mosaic, ["--epochs", "1"])):
    app.build_parser().parse_args(argv) if hasattr(app, "build_parser") else None
    try:
        app.main(argv)
        apps_raised.append(False)
    except RuntimeError as e:
        apps_raised.append("CUDA" in str(e))
from poseestimator_tpu_torch.registration import native
print(json.dumps({"native_touched": native._tried or native._lib is not None,
    "modules": names,
    "jax": sorted(m for m, mod in sys.modules.items() if mod is not None and any(
        m == p or m.startswith(p + ".") for p in ("jax", "flax", "optax", "orbax"))),
    "reference": sorted(m for m in sys.modules if m == "poseestimator_tpu"
                        or m.startswith("poseestimator_tpu.")),
    "raised": raised, "apps_raised": apps_raised, "cpu_ok": cpu_ok}))
"""


def test_port_imports_no_jax_and_needs_cuda_unless_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for m in ("pipeline.tracking", "pipeline.offline", "utils.bop", "apps.eval_bop",
              "registration.native", "apps.main_image", "apps.main_realsense",
              "apps.main_seibersdorf", "camera.record", "utils.jpeg", "utils.image",
              "utils.overlay", "utils.yaml_subset", "utils.config", "utils.profiling",
              "models.yolo.contours", "utils.imgproc", "training.assigner", "training.loss",
              "training.data", "training.trainer", "training.evaluate", "training.synth",
              "apps.generate", "apps.train", "apps.val", "apps.eval_tracking",
              "apps.eval_init", "apps.scaling_eval", "apps.clique_sweep", "apps.predict",
              "apps.testrun", "apps.mirror", "apps._scene", "apps.profile_stages",
              "apps.profile_search", "apps.ab_mosaic", "parallel", "parallel.mesh",
              "parallel.bigcloud", "parallel.registration", "parallel.tracking",
              "parallel.serving", "compat", "compat.main_image", "compat.main_realsense",
              "compat.main_seibersdorf", "compat.EstimHelpers",
              "compat.EstimHelpers.Detector", "compat.EstimHelpers.PoseEstimator",
              "compat.EstimHelpers.RealSenseClass", "compat.EstimHelpers.detection_utils",
              "compat.EstimHelpers.HelpersRealtime", "compat.EstimHelpers.registration_utils",
              "compat.EstimHelpers.template_creation"):
        assert f"poseestimator_tpu_torch.{m}" in res["modules"]
    assert not res["native_touched"]  # importing builds and loads nothing
    assert res["jax"] == [], res["jax"]
    assert res["reference"] == [], res["reference"]
    assert res["cpu_ok"]
    if not torch.cuda.is_available():
        assert res["raised"] == [True] * 5
        assert res["apps_raised"] == [True] * 18


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card the smoke test exits nonzero and prints no result;
    alone in a directory (no port package) it fails the same way."""
    if torch.cuda.is_available():
        return
    for cwd in (REPO, str(tmp_path)):
        if cwd != REPO:
            with open(os.path.join(REPO, "chip_smoke.py")) as src:
                (tmp_path / "chip_smoke.py").write_text(src.read())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
