"""Port parity, the mosaic A/B: ``apps/ab_mosaic.py`` against the JAX
package's ``tools/ab_mosaic.py``. The flags and defaults are the JAX tool's
(``--device`` in place of ``--cpu``); a tiny run (1 epoch, 4 + 2 images at
64, batch 2) gives the JAX tool's output keys in order, and its two arms'
``TrainConfig``s differ only in ``mosaic`` and ``name``. Training itself is
held to the JAX package in ``tests/test_torch_training.py``."""
import dataclasses
import json

from poseestimator_tpu_torch.apps import ab_mosaic
from torch_threads import two_threads  # noqa: F401

# tools/ab_mosaic.py:30-39, the flags and defaults (--cpu aside)
JAX_DEFAULTS = {"epochs": 60, "train": 48, "val": 16, "imgsz": 320, "batch": 8, "lr0": 2e-3,
                "mosaic": 0.5, "seed": 0, "json_out": ""}
# tools/ab_mosaic.py:95-100 and :105-107, a row's keys and the output's
JAX_ROW_KEYS = ["mosaic", "map50", "map50_95", "train_s"]
JAX_KEYS = ["rows", "map50_delta_on_minus_off", "epochs", "train_images", "imgsz",
            "close_mosaic"]
TINY = ["--epochs", "1", "--train", "4", "--val", "2", "--imgsz", "64", "--batch", "2"]


def test_flags_and_defaults_match_jax():
    args = vars(ab_mosaic.build_parser().parse_args([]))
    assert args.pop("device") == "cuda"
    assert args == JAX_DEFAULTS


def test_tiny_run_gives_jax_keys_and_two_arms(tmp_path):
    out_json = tmp_path / "ab.json"
    out = ab_mosaic.main(["--device", "cpu", *TINY, "--json-out", str(out_json)])
    assert list(out) == JAX_KEYS
    assert list(out["rows"]) == ["off", "on"]
    for name, mosaic in (("off", 0.0), ("on", 0.5)):
        row = out["rows"][name]
        assert list(row) == JAX_ROW_KEYS and row["mosaic"] == mosaic and row["train_s"] > 0.0
        assert 0.0 <= row["map50_95"] <= row["map50"] <= 1.0
    assert out["map50_delta_on_minus_off"] == round(
        out["rows"]["on"]["map50"] - out["rows"]["off"]["map50"], 4)
    assert (out["epochs"], out["train_images"], out["imgsz"], out["close_mosaic"]) == (1, 4, 64, 10)
    assert json.loads(out_json.read_text()) == out
    args = ab_mosaic.build_parser().parse_args(["--device", "cpu", *TINY])
    cfgs = ab_mosaic.arm_configs(args, str(tmp_path / "dataset.yaml"), str(tmp_path / "runs"))
    off, on = (dataclasses.asdict(cfgs[k]) for k in ("off", "on"))
    assert {k for k in off if off[k] != on[k]} == {"mosaic", "name"}
    assert (off["mosaic"], on["mosaic"]) == (0.0, 0.5)
    assert (off["name"], on["name"]) == ("mosaic_off", "mosaic_on")
    assert (off["epochs"], off["imgsz"], off["batch"], off["lr0"], off["patience"],
            off["max_instances"], off["workers"]) == (1, 64, 2, 2e-3, 1, 8, 2)
