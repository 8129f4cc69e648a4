"""The port stands alone: importing ``poseestimator_tpu_torch`` (every
module) and ``chip_smoke.py`` loads neither ``jax`` nor ``poseestimator_tpu``,
and the entry points refuse to run without CUDA unless asked for the CPU.
Checked in a fresh interpreter, since this test process imports both."""
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
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
raised = []
for call in (lambda: resolve_device(),
             lambda: FusedFrame(YOLO11Seg(nc=5), np.zeros((8, 3), np.float32),
                                np.zeros((4, 3), np.int32), Intrinsics.from_fov(60, 64, 48))):
    try:
        call()
        raised.append(False)
    except RuntimeError:
        raised.append(True)
cpu_ok = resolve_device("cpu").type == "cpu"
print(json.dumps({
    "modules": names,
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                  or m == "flax" or m.startswith("flax.")),
    "reference": sorted(m for m in sys.modules if m == "poseestimator_tpu"
                        or m.startswith("poseestimator_tpu.")),
    "raised": raised, "cpu_ok": cpu_ok}))
"""


def test_port_imports_no_jax_and_needs_cuda_unless_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "poseestimator_tpu_torch.pipeline.tracking" in res["modules"]
    assert res["jax"] == [], res["jax"]
    assert res["reference"] == [], res["reference"]
    assert res["cpu_ok"]
    if not torch.cuda.is_available():
        assert res["raised"] == [True, True]


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
