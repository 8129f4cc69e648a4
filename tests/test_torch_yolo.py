"""Port parity, detection: flax ``YOLO11Seg(nc=5, scale="n")`` variables
(from ``model.init``, with BatchNorm statistics and biases randomized by a
numpy seed so symmetric defaults cannot hide a mis-mapped axis) carried
across by the port's converter with ``strict=True``; raw heads and
prototypes within atol 2e-4 / rtol 1e-3 (as tests/test_yolo_full_parity.py);
letterbox within 1e-6; decoded boxes within 5e-3 px; identical NMS keep
decisions and identical masks on the same inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseestimator_tpu.models import yolo as Y
from poseestimator_tpu_torch.models.yolo import weights as tweights
from poseestimator_tpu_torch.models.yolo.decode import decode_boxes
from poseestimator_tpu_torch.models.yolo.masks import assemble_masks
from poseestimator_tpu_torch.models.yolo.model import YOLO11Seg
from poseestimator_tpu_torch.models.yolo.nms import nms
from poseestimator_tpu_torch.models.yolo.preprocess import LetterboxMeta, letterbox
from torch_threads import two_threads  # noqa: F401

IMG = 128


def _randomized(variables, seed=0):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x, np.float32)
        if name.endswith("['var']") or name.endswith("['scale']"):
            return rng.uniform(0.5, 1.5, size=x.shape).astype(np.float32)
        if name.endswith("['mean']") or name.endswith("['bias']"):
            return (rng.normal(size=x.shape) * 0.1).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def variables():
    init = jax.jit(lambda x: Y.YOLO11Seg(nc=5, scale="n").init(
        jax.random.PRNGKey(0), x, train=False))
    return _randomized(init(jnp.zeros((1, IMG, IMG, 3))))


@pytest.fixture(scope="module")
def pair(variables):
    tmodel = tweights.load_variables(YOLO11Seg(nc=5, scale="n"), variables).eval()
    img = np.random.default_rng(1).uniform(0, 1, size=(2, IMG, IMG, 3)).astype(np.float32)
    apply = jax.jit(lambda v, x: Y.YOLO11Seg(nc=5, scale="n").apply(v, x, train=False))
    jraw = apply(variables, jnp.asarray(img))
    with torch.no_grad():
        traw = tmodel(torch.from_numpy(img).permute(0, 3, 1, 2))
    return jraw, traw


def test_converter_is_strict_and_complete(variables):
    sd = tweights.variables_to_state_dict(variables)
    model_keys = set(YOLO11Seg(nc=5, scale="n").state_dict())
    assert set(sd) == model_keys
    bad = dict(variables)
    bad["params"] = dict(variables["params"])
    bad["params"].pop("m23_proto")
    with pytest.raises(RuntimeError):
        tweights.load_variables(YOLO11Seg(nc=5, scale="n"), bad)


def test_raw_heads_and_protos_match(pair):
    jraw, traw = pair
    for key in ("box", "cls", "mc"):
        for lvl in range(3):
            np.testing.assert_allclose(traw[key][lvl].numpy(), np.asarray(jraw[key][lvl]),
                                       atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(traw["proto"].numpy(), np.asarray(jraw["proto"]),
                               atol=2e-4, rtol=1e-3)


def test_decoded_boxes_match(pair):
    jraw, traw = pair
    bj, cj, mj = Y.decode_boxes(jraw)
    bt, ct, mt = decode_boxes(traw)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=5e-3, rtol=1e-3)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=2e-4, rtol=1e-3)


def test_letterbox_matches(rng):
    img = rng.integers(0, 255, size=(120, 160, 3), dtype=np.uint8)
    lj, mj = Y.letterbox(jnp.asarray(img), IMG)
    lt, mt = letterbox(torch.from_numpy(img), IMG)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-6)
    assert (mt.scale, mt.pad_x, mt.pad_y) == (float(mj.scale), float(mj.pad_x), float(mj.pad_y))
    assert (mt.orig_h, mt.orig_w) == (mj.orig_h, mj.orig_w)


@pytest.mark.parametrize("conf,iou", [(0.0, 0.5), (0.3, 0.7)])
def test_nms_decisions_match(pair, conf, iou):
    jraw, _ = pair
    boxes, cls, mc = (np.array(a[0]) for a in Y.decode_boxes(jraw))
    cls = cls.copy()
    cls[:, 0] += np.linspace(0.0, 1.0, len(cls)).astype(np.float32)  # spread scores
    cls = np.clip(cls, 0, 1)
    dj = Y.nms(jnp.asarray(boxes), jnp.asarray(cls), jnp.asarray(mc), conf_thres=conf,
               iou_thres=iou, pre_nms=256, max_det=32)
    dt = nms(torch.from_numpy(boxes), torch.from_numpy(cls), torch.from_numpy(mc),
             conf_thres=conf, iou_thres=iou, pre_nms=256, max_det=32)
    np.testing.assert_array_equal(dt.valid.numpy(), np.asarray(dj.valid))
    assert int(dt.count()) > 1
    np.testing.assert_array_equal(dt.boxes.numpy(), np.asarray(dj.boxes))
    np.testing.assert_array_equal(dt.classes.numpy(), np.asarray(dj.classes))
    np.testing.assert_array_equal(dt.coeffs.numpy(), np.asarray(dj.coeffs))


def test_assemble_masks_match():
    rng = np.random.default_rng(2)
    proto = rng.normal(size=(32, 32, 32)).astype(np.float32)
    coeffs = rng.normal(size=(4, proto.shape[-1])).astype(np.float32)
    boxes = np.array([[10, 20, 90, 100], [0, 0, 128, 128], [40, 30, 60, 70],
                      [5, 50, 120, 60]], np.float32)
    valid = np.array([True, True, True, False])
    jm = Y.LetterboxMeta(scale=jnp.float32(0.8), pad_x=jnp.float32(0.0),
                         pad_y=jnp.float32(16.0), orig_h=120, orig_w=160)
    tm = LetterboxMeta(scale=float(np.float32(0.8)), pad_x=0.0, pad_y=16.0,
                       orig_h=120, orig_w=160)
    mj = np.asarray(Y.assemble_masks(jnp.asarray(proto), jnp.asarray(coeffs),
                                     jnp.asarray(boxes), jnp.asarray(valid), jm, 120, 160))
    mt = assemble_masks(torch.from_numpy(proto), torch.from_numpy(coeffs),
                        torch.from_numpy(boxes), torch.from_numpy(valid), tm, 120, 160)
    np.testing.assert_array_equal(mt.numpy(), mj)
    assert mj[:3].sum() > 100 and not mj[3].any()
