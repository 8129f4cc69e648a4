"""The port's training stack against the JAX package's on the CPU: the DFL
decode helpers, the flax BatchNorm law of the train-mode forward, the
state-dict <-> flax variables mapping, TAL (seeded and hand-built cases:
a multi-GT conflict, no valid GT, ties), the losses and their gradient,
optax's update laws and schedule, two ``Trainer`` steps from carried
variables (warm-up on: step 1 has lr 0), COCO mAP, and the checkpoint
round trip into the port's ``Detector``.

Carried variables are the port's seeded training init converted to flax
variables (no flax init is compiled); the JAX train step is compiled once,
at imgsz 64, nc 2, batch 2. Port steps run on two intra-op threads."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from test_training import make_synthetic_dataset

from poseestimator_tpu.models.yolo import decode as jdec
from poseestimator_tpu.models.yolo.layers import ConvBNAct
from poseestimator_tpu.models.yolo.model import YOLO11Seg as JYOLO
from poseestimator_tpu.training import assigner as jassign
from poseestimator_tpu.training import evaluate as jeval
from poseestimator_tpu.training import loss as jloss
from poseestimator_tpu.training import trainer as jtrainer

from poseestimator_tpu_torch.models.yolo import decode as pdec
from poseestimator_tpu_torch.models.yolo.model import Conv, YOLO11Seg, init_train_
from poseestimator_tpu_torch.models.yolo.weights import (state_dict_to_variables,
                                                         variables_to_state_dict)
from poseestimator_tpu_torch.pipeline.detector import Detector
from poseestimator_tpu_torch.training import assigner as passign
from poseestimator_tpu_torch.training import evaluate as peval
from poseestimator_tpu_torch.training import loss as ploss
from poseestimator_tpu_torch.training import trainer as ptrainer
from torch_threads import two_threads  # noqa: F401


@pytest.fixture(scope="module")
def carried():
    """(port model in eval mode, flax variables with numpy leaves) of the
    seeded training init, nc 2."""
    m = init_train_(YOLO11Seg(nc=2, scale="n"), torch.Generator().manual_seed(0)).eval()
    return m, state_dict_to_variables(m.state_dict())


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("blobs")), n_images=4, size=96)


def _t(a):
    return torch.from_numpy(np.array(a))


# --- decode, BatchNorm, weights ---------------------------------------------

def test_dfl_helpers_and_decode_match_jax(rng):
    """dfl_expectation, dist2bbox, bbox2dist (clamped) and decode_boxes over
    them: rtol 1e-6."""
    logits = rng.normal(size=(2, 50, 64)).astype(np.float32)
    anchors = rng.uniform(0, 8, (50, 2)).astype(np.float32)
    boxes = rng.uniform(-4, 20, (2, 50, 4)).astype(np.float32)
    np.testing.assert_allclose(pdec.dfl_expectation(_t(logits)).numpy(),
                               np.asarray(jdec.dfl_expectation(jnp.asarray(logits))), rtol=1e-6)
    d = np.abs(rng.normal(size=(2, 50, 4))).astype(np.float32)
    np.testing.assert_allclose(pdec.dist2bbox(_t(d), _t(anchors)).numpy(),
                               np.asarray(jdec.dist2bbox(jnp.asarray(d), jnp.asarray(anchors))),
                               rtol=1e-6)
    np.testing.assert_allclose(pdec.bbox2dist(_t(boxes), _t(anchors)).numpy(),
                               np.asarray(jdec.bbox2dist(jnp.asarray(boxes), jnp.asarray(anchors))),
                               rtol=1e-6)
    raw = {k: tuple(rng.normal(size=(1, s, s, c)).astype(np.float32) for s in (8, 4, 2))
           for k, c in (("box", 64), ("cls", 2), ("mc", 32))}
    pb = pdec.decode_boxes({k: tuple(_t(x) for x in v) for k, v in raw.items()})
    jb = jdec.decode_boxes({k: tuple(jnp.asarray(x) for x in v) for k, v in raw.items()})
    for a, b in zip(pb, jb):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("spatial", [2, 5])
def test_batchnorm_train_step_follows_flax(spatial):
    """One train-mode forward of conv + BN + SiLU: the output and the
    running statistics equal flax's (momentum 0.97, eps 1e-3, the biased
    variance averaged in: nn.BatchNorm2d alone would be n / (n - 1) = 8 / 7
    larger at 2 x 2, batch 2), rtol 1e-5."""
    rng = np.random.default_rng(spatial)
    x = rng.normal(size=(2, spatial, spatial, 4)).astype(np.float32)
    mod = ConvBNAct(8, 3)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    v = jax.tree.map(np.asarray, v)
    y, mut = mod.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    port = Conv(4, 8, 3)
    port.conv.weight.data = _t(np.transpose(v["params"]["conv"]["kernel"], (3, 2, 0, 1)).copy())
    port.train()
    out = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-6)
    bs = mut["batch_stats"]["bn"]
    np.testing.assert_allclose(port.bn.running_mean.numpy(), np.asarray(bs["mean"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(port.bn.running_var.numpy(), np.asarray(bs["var"]), rtol=1e-5)


def test_state_dict_to_variables_is_the_flax_tree(carried):
    """The inverse of ``variables_to_state_dict``: flax's own tree (every
    path and shape of ``model.init``, traced abstractly) and a lossless
    round trip."""
    model, var = carried
    shapes = jax.eval_shape(lambda: JYOLO(nc=2, scale="n").init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=True))
    want = {jax.tree_util.keystr(p): s.shape
            for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {jax.tree_util.keystr(p): a.shape
           for p, a in jax.tree_util.tree_flatten_with_path(var)[0]}
    assert got == want
    back = variables_to_state_dict(var)
    for k, t in model.state_dict().items():
        assert torch.equal(back[k], t), k


# --- TAL -----------------------------------------------------------------------

def _assign_both(cls_prob, pred, anchors, gt, gt_cls, gt_valid):
    j = jax.vmap(lambda cp, pb, gb, gc, gv: jassign.assign(cp, pb, jnp.asarray(anchors), gb, gc,
                                                            gv))(
        jnp.asarray(cls_prob), jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(gt_cls),
        jnp.asarray(gt_valid))
    p = passign.assign(_t(cls_prob), _t(pred), _t(anchors), _t(gt), _t(gt_cls), _t(gt_valid))
    return [np.asarray(a) for a in j], [a.numpy() for a in p]


def _same_assignment(j, p):
    assert np.array_equal(j[0], p[0])
    assert np.array_equal(np.where(j[0], j[1], 0), np.where(p[0], p[1], 0))
    assert np.array_equal(j[1], p[1])
    np.testing.assert_allclose(p[2], j[2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(p[3], j[3], rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assign_matches_jax_seeded(seed):
    """Random predictions near 6 GTs (one invalid) over 336 anchors of the
    three levels of a 64-pixel letterbox: fg and gt_idx exact, scores and
    boxes to 1e-6."""
    rng = np.random.default_rng(seed)
    anchors, stride = jdec.make_anchors([(8, 8), (4, 4), (2, 2)], (8, 16, 32))
    anchors = np.asarray(anchors * stride[:, None])
    A = len(anchors)
    gt = np.sort(rng.uniform(0, 64, (2, 6, 2, 2)), axis=2).transpose(0, 1, 3, 2).reshape(2, 6, 4)
    gt = gt[..., [0, 2, 1, 3]].astype(np.float32)
    gv = np.ones((2, 6), bool)
    gv[:, 5] = False
    gc = rng.integers(0, 3, (2, 6)).astype(np.int32)
    pick = rng.integers(0, 6, (2, A))
    pred = (np.take_along_axis(gt, pick[..., None], 1)
            + rng.normal(0, 3, (2, A, 4))).astype(np.float32)
    cls = rng.random((2, A, 3)).astype(np.float32)
    _same_assignment(*_assign_both(cls, pred, anchors, gt, gc, gv))


def test_assign_hand_built_cases():
    """An anchor inside two GTs goes to the higher metric; no valid GT
    assigns nothing; tied metrics at the k-th value are all kept and a tied
    claim goes to the first GT, as ``jnp.argmax`` takes it."""
    # multi-GT conflict
    anchors = np.array([[10.0, 10.0]], np.float32)
    gts = np.array([[[0.0, 0.0, 20.0, 20.0], [5.0, 5.0, 15.0, 15.0]]], np.float32)
    j, p = _assign_both(np.full((1, 1, 2), 0.5, np.float32),
                        np.array([[[5.0, 5.0, 15.0, 15.0]]], np.float32), anchors, gts,
                        np.array([[0, 1]], np.int32), np.array([[True, True]]))
    _same_assignment(j, p)
    assert p[0][0, 0] and p[1][0, 0] == 1
    # no valid GT
    j, p = _assign_both(np.full((1, 1, 3), 0.5, np.float32), np.zeros((1, 1, 4), np.float32),
                        anchors, np.zeros((1, 2, 4), np.float32), np.zeros((1, 2), np.int32),
                        np.zeros((1, 2), bool))
    _same_assignment(j, p)
    assert not p[0].any() and p[2].sum() == 0
    # ties: 12 anchors with identical predictions inside two identical GTs
    anchors = np.stack([np.arange(12) * 2.0 + 5.0, np.full(12, 10.0)], 1).astype(np.float32)
    gts = np.array([[[0.0, 0.0, 40.0, 20.0], [0.0, 0.0, 40.0, 20.0]]], np.float32)
    pred = np.tile(np.array([[2.0, 2.0, 38.0, 18.0]], np.float32), (1, 12, 1))
    j, p = _assign_both(np.full((1, 12, 2), 0.7, np.float32), pred, anchors, gts,
                        np.array([[0, 1]], np.int32), np.array([[True, True]]))
    _same_assignment(j, p)
    assert p[0].all() and (p[1] == 0).all()


# --- losses ------------------------------------------------------------------

def test_ciou_dfl_bce_match_jax(rng):
    b1 = np.sort(rng.uniform(0, 50, (200, 2, 2)), 1).reshape(200, 4)[:, [0, 2, 1, 3]]
    b2 = np.sort(rng.uniform(0, 50, (200, 2, 2)), 1).reshape(200, 4)[:, [0, 2, 1, 3]]
    b1, b2 = b1.astype(np.float32), b2.astype(np.float32)
    np.testing.assert_allclose(ploss.ciou(_t(b1), _t(b2)).numpy(),
                               np.asarray(jloss.ciou(jnp.asarray(b1), jnp.asarray(b2))),
                               rtol=1e-4, atol=1e-6)
    logits = rng.normal(size=(30, 64)).astype(np.float32)
    target = rng.uniform(0, 14.99, (30, 4)).astype(np.float32)
    np.testing.assert_allclose(ploss._dfl_loss(_t(logits), _t(target)).numpy(),
                               np.asarray(jloss._dfl_loss(jnp.asarray(logits),
                                                          jnp.asarray(target))), rtol=1e-4)
    x = rng.normal(0, 5, 100).astype(np.float32)
    t = rng.random(100).astype(np.float32)
    np.testing.assert_allclose(ploss.bce(_t(x), _t(t)).numpy(),
                               np.asarray(jloss.bce(jnp.asarray(x), jnp.asarray(t))), rtol=1e-4)
    # the CIoU aspect weight carries no gradient (loss.py:49)
    a, b = _t(b1[:5]).requires_grad_(True), _t(b2[:5])
    ploss.ciou(a, b).sum().backward()
    ja = jax.grad(lambda u: jloss.ciou(u, jnp.asarray(b2[:5])).sum())(jnp.asarray(b1[:5]))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ja), rtol=1e-3, atol=1e-6)


@pytest.fixture(scope="module")
def head_batch(carried):
    """Raw head outputs of the carried YOLO11n (eval mode) on a seeded
    batch, and GT: boxes, classes, masks, validity (one padded slot)."""
    model, _ = carried
    rng = np.random.default_rng(5)
    x = rng.random((2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        raw = model(_t(x).permute(0, 3, 1, 2))
    raw = {k: (tuple(t.numpy().copy() for t in v) if isinstance(v, tuple) else v.numpy().copy())
           for k, v in raw.items()}
    gb = np.array([[[8, 8, 40, 40], [20, 10, 60, 50], [0, 0, 0, 0]],
                   [[16, 16, 48, 48], [2, 30, 30, 62], [0, 0, 0, 0]]], np.float32)
    gc = np.array([[0, 1, 0], [1, 0, 0]], np.int32)
    gm = (rng.random((2, 3, 16, 16)) > 0.5).astype(np.float32)
    gv = np.array([[1, 1, 0], [1, 1, 0]], bool)
    return raw, gb, gc, gm, gv


def _jraw(raw):
    return {k: (tuple(jnp.asarray(t) for t in v) if isinstance(v, tuple) else jnp.asarray(v))
            for k, v in raw.items()}


def test_segmentation_loss_and_parts_match_jax(head_batch):
    """Total and parts (box, cls, dfl, seg, n_pos), rtol 1e-4."""
    raw, gb, gc, gm, gv = head_batch
    jt, jp = jloss.segmentation_loss(_jraw(raw), *(jnp.asarray(a) for a in (gb, gc, gm, gv)))
    pt, pp = ploss.segmentation_loss({k: (tuple(_t(t) for t in v) if isinstance(v, tuple)
                                          else _t(v)) for k, v in raw.items()},
                                     *(_t(a) for a in (gb, gc, gm, gv)))
    for k in jp:
        np.testing.assert_allclose(float(pp[k]), float(jp[k]), rtol=1e-4, err_msg=k)
    assert float(pp["n_pos"]) > 1.0  # positives were assigned


def test_loss_gradient_wrt_head_outputs_matches_jax(head_batch):
    """d total / d raw head outputs (every level of box, cls, mc, and the
    protos) against ``jax.grad``, rtol 1e-3 (atol 1e-3 of the leaf's
    largest entry): the TAL targets are constants of the loss on both
    sides."""
    raw, gb, gc, gm, gv = head_batch
    gj = jax.grad(lambda r: jloss.segmentation_loss(r, *(jnp.asarray(a) for a in
                                                         (gb, gc, gm, gv)))[0])(_jraw(raw))
    leaves = {k: (tuple(_t(t).requires_grad_(True) for t in v) if isinstance(v, tuple)
                  else _t(v).requires_grad_(True)) for k, v in raw.items()}
    ploss.segmentation_loss(leaves, *(_t(a) for a in (gb, gc, gm, gv)))[0].backward()
    for k in ("box", "cls", "mc", "proto"):
        js = gj[k] if isinstance(gj[k], tuple) else (gj[k],)
        ps = leaves[k] if isinstance(leaves[k], tuple) else (leaves[k],)
        for a, b in zip(js, ps):
            a = np.asarray(a)
            np.testing.assert_allclose(b.grad.numpy(), a, rtol=1e-3,
                                       atol=1e-3 * max(np.abs(a).max(), 1e-12), err_msg=k)


# --- optimiser ---------------------------------------------------------------

@pytest.mark.parametrize("opt", ["Adam", "AdamW", "SGD"])
def test_optimizer_law_and_schedule_match_optax(opt, tmp_path, dataset):
    """``make_optimizer`` on identical seeded parameters and gradients for 6
    updates through the warm-up boundary (3 steps an epoch, warm-up 1
    epoch): the port's in-place law against the JAX package's optax chain,
    rtol 1e-5; update 0 has lr 0 and leaves the parameters as they were."""
    cfg = jtrainer.TrainConfig(data=dataset, epochs=2, optimizer=opt, lr0=0.01,
                               warmup_epochs=1.0)
    tx = jtrainer.make_optimizer(cfg, 3)
    pt = ptrainer.make_optimizer(ptrainer.TrainConfig(data=dataset, epochs=2, optimizer=opt,
                                                      lr0=0.01, warmup_epochs=1.0), 3)
    rng = np.random.default_rng(6)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jp = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    tp = [_t(p.copy()) for p in params]
    js, ts = tx.init(jp), pt.init(tp)
    for step in range(6):
        g = [rng.normal(size=s).astype(np.float32) for s in shapes]
        upd, js = tx.update({str(i): jnp.asarray(x) for i, x in enumerate(g)}, js, jp)
        jp = optax.apply_updates(jp, upd)
        lr = pt.update(tp, [_t(x) for x in g], ts)
        if step == 0:
            assert lr == 0.0
            for a, b in zip(tp, params):
                assert torch.equal(a, _t(b))
        for i, a in enumerate(tp):
            np.testing.assert_allclose(a.numpy(), np.asarray(jp[str(i)]), rtol=1e-5, atol=1e-7)


def test_training_config_limits(dataset):
    """A bfloat16 ``TrainConfig`` builds a trainer whose model computes in
    bfloat16 over float32 parameters, an unknown dtype raises, and device
    lists raise ``NotImplementedError`` pointing to torchrun and
    ``Trainer(mesh=)``; every JAX ``TrainConfig`` field exists with its
    default, ``device`` aside."""
    tr = ptrainer.Trainer(ptrainer.TrainConfig(data=dataset, dtype="bfloat16", device="cpu"))
    assert tr.model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())
    with pytest.raises(ValueError, match="float16"):
        ptrainer.Trainer(ptrainer.TrainConfig(data=dataset, dtype="float16", device="cpu"))
    with pytest.raises(NotImplementedError, match="torchrun.*mesh="):
        ptrainer.Trainer(ptrainer.TrainConfig(data=dataset, device="0,1"))
    j, p = jtrainer.TrainConfig(data=dataset), ptrainer.TrainConfig(data=dataset)
    assert set(j.__dataclass_fields__) == set(p.__dataclass_fields__)
    for k in j.__dataclass_fields__:
        if k != "device":
            assert getattr(j, k) == getattr(p, k), k


# --- two trainer steps -----------------------------------------------------------

def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(a, b, where=None):
    d = np.abs(a.astype(np.float64) - b)
    if where is not None:
        d = d[where]
    return (d.max() if d.size else 0.0) / max(np.abs(b).max(), 1e-6)


def test_two_trainer_steps_match_jax(carried, dataset, tmp_path):
    """Two steps of the JAX ``Trainer`` and the port's from the carried
    variables on one loader batch (imgsz 64, nc 2, batch 2, Adam, warm-up
    on). Step 1 has lr 0 on both sides: the weights stay bit for bit and
    only the BN statistics move. Per step: the loss parts rtol 1e-4; the
    BN statistics within 5e-4 of each leaf's scale (the train-mode BN over
    2 x 2 maps amplifies float32 rounding: measured 1.3e-4); the gradients
    (Adam's first moment) within 2e-3 of each leaf's scale (measured
    5e-4). After step 2 the weights and the EMA within 1e-5 of each leaf's
    scale at every element whose gradient both sides know to 0.1%: Adam
    moves an element by ~lr sign(g), and an element whose gradient is at
    the rounding level (a BN bias ahead of another BN) gets an arbitrary
    sign in either package."""
    _, var = carried
    kw = dict(data=dataset, epochs=3, imgsz=64, batch=2, max_instances=4, warmup_epochs=1.0,
              project=str(tmp_path), name="steps")
    # one device: the port's trainer is single-device
    jt = jtrainer.Trainer(jtrainer.TrainConfig(**kw), nc=2,
                          mesh=Mesh(np.array(jax.devices()[:1]), ("dp",)))
    params = jax.device_put(var["params"])
    js = jax.device_put(jtrainer.TrainState(  # as ``init_state`` places it: one compile
        params=params, batch_stats=jax.device_put(var["batch_stats"]),
        opt_state=jax.jit(jt.tx.init)(params), step=jnp.int32(0),
        ema_params=jax.device_put(var["params"])), jt.repl_sharding)
    pt = ptrainer.Trainer(ptrainer.TrainConfig(**kw, device="cpu"), nc=2)
    ps = pt.init_state(var)
    batch = next(iter(jt.loader))
    init = _leaves(var["params"])
    for step in range(2):
        js, jparts = jt._train_step(js, *jt._shard(batch))
        ps, pparts = pt._train_step(ps, *pt._tensors(batch))
        for k in jparts:
            np.testing.assert_allclose(float(pparts[k]), float(jparts[k]), rtol=1e-4, err_msg=k)
        pv = state_dict_to_variables({**ps.params, **ps.batch_stats})
        stats_p, stats_j = _leaves(pv["batch_stats"]), _leaves(js.batch_stats)
        for k in stats_j:
            assert _rel(stats_p[k], stats_j[k]) <= 5e-4, k
        names = list(ps.params)
        mu_p = _leaves(state_dict_to_variables(dict(zip(names, ps.opt_state["mu"])))["params"])
        mu_j = _leaves(js.opt_state[0].mu)
        for k in mu_j:
            assert _rel(mu_p[k], mu_j[k]) <= 2e-3, k
        p_p, p_j = _leaves(pv["params"]), _leaves(js.params)
        e_p = _leaves(state_dict_to_variables(ps.ema_params)["params"])
        e_j = _leaves(js.ema_params)
        if step == 0:
            assert pt.last_lr == 0.0
            for k in init:
                assert np.array_equal(p_p[k], init[k]) and np.array_equal(p_j[k], init[k]), k
                assert _rel(e_p[k], e_j[k]) <= 1e-6, k
            continue
        assert pt.last_lr == pytest.approx(0.0005)  # half-way up the 2-step warm-up
        known = total = 0
        for k in mu_j:
            sure = (np.abs(mu_j[k]) > 1e-6) & (np.abs(mu_p[k] - mu_j[k]) <= 1e-3 * np.abs(mu_j[k]))
            known, total = known + sure.sum(), total + sure.size
            assert _rel(p_p[k], p_j[k], sure) <= 1e-5, k
            assert _rel(e_p[k], e_j[k], sure) <= 1e-5, k
            # everywhere else Adam's step is bounded by ~lr
            assert np.abs(p_p[k] - p_j[k]).max() <= 2.5 * 0.0005, k
        assert known / total > 0.5


# --- mAP and checkpoints ---------------------------------------------------------

def test_compute_map_matches_jax():
    """Seeded predictions over 12 images, 3 classes, boxes and masks."""
    rng = np.random.default_rng(7)
    jims, pims = [], []
    for _ in range(12):
        g = int(rng.integers(0, 5))
        gtb = np.sort(rng.uniform(0, 100, (g, 2, 2)), 1).reshape(g, 4)[:, [0, 2, 1, 3]]
        p = int(rng.integers(0, 8))
        pick = rng.integers(0, max(g, 1), p)
        pb = (gtb[pick] + rng.normal(0, 4, (p, 4))) if g else rng.uniform(0, 100, (p, 4))
        kw = dict(pred_boxes=pb, pred_scores=rng.random(p), pred_classes=rng.integers(0, 3, p),
                  gt_boxes=gtb, gt_classes=rng.integers(0, 3, g),
                  pred_masks=rng.random((p, 8, 8)) > 0.5, gt_masks=rng.random((g, 8, 8)) > 0.5)
        jims.append(jeval.ImageEval(**kw))
        pims.append(peval.ImageEval(**kw))
    for masks in (False, True):
        assert peval.compute_map(pims, use_masks=masks) == jeval.compute_map(jims,
                                                                              use_masks=masks)


def test_checkpoint_round_trip_into_detector(dataset, tmp_path):
    """``fit`` for one epoch writes ``last.pt``, ``best.pt`` and
    ``results.json``; a resume continues at the saved epoch with a fresh
    optimiser at step 0 (as the JAX package resumes); ``Detector`` loads
    ``best.pt`` (the EMA weights) and its forward equals the exported
    variables'; ``evaluate_map`` runs on the EMA weights."""
    kw = dict(data=dataset, epochs=1, imgsz=64, batch=2, max_instances=4, augment=False,
              project=str(tmp_path), name="ck", device="cpu", patience=5)
    tr = ptrainer.Trainer(ptrainer.TrainConfig(**kw), nc=1)
    state, hist = tr.fit(log=lambda *a: None, tensorboard=False)
    run = tmp_path / "ck"
    assert {"last.pt", "best.pt", "results.json"} <= set(os.listdir(run))
    assert json.loads((run / "results.json").read_text())[0]["epoch"] == 0
    payload = torch.load(run / "best.pt", weights_only=True)
    assert payload["epoch"] == 1
    exported = tr.export_variables(state)
    for k, v in exported.items():
        assert torch.equal(payload["params"][k], v), k
    det = Detector(str(run / "best.pt"), nc=1, imgsz=64, device="cpu")
    assert det.scale == "n" and det.nc == 1
    ref = YOLO11Seg(nc=1).eval()
    ref.load_state_dict(exported)
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a, b = det.model(x), ref(x)
    assert torch.equal(a["proto"], b["proto"])
    tr2 = ptrainer.Trainer(ptrainer.TrainConfig(**{**kw, "epochs": 2, "resume": True}), nc=1)
    state2, hist2 = tr2.fit(log=lambda *a: None, tensorboard=False)
    assert hist2[0]["epoch"] == 1 and state2.step == len(tr2.loader)
    m = tr2.evaluate_map(state2)
    assert 0.0 <= m["map50"] <= 1.0 and "map50_95" in m


def test_train_app_runs_bfloat16(dataset, tmp_path, monkeypatch):
    """``apps/train.py --dtype bfloat16`` trains an epoch on the CPU: the
    model computes in bfloat16, the loss parts are finite, and the
    checkpoint's weights are float32 and load into a bfloat16
    ``Detector``."""
    from functools import partialmethod

    from poseestimator_tpu_torch.apps import train as train_app

    seen = {}
    fit = ptrainer.Trainer.fit

    def fit_recorded(self, *a, **k):
        seen["dtype"] = self.model.dtype
        state, hist = fit(self, *a, **k)
        seen["hist"] = hist
        return state, hist

    monkeypatch.setattr(ptrainer.Trainer, "fit",
                        partialmethod(fit_recorded, log=lambda *a: None, tensorboard=False))
    assert train_app.main(["--data", dataset, "--epochs", "1", "--imgsz", "64", "--batch", "2",
                           "--dtype", "bfloat16", "--device", "cpu", "--mosaic", "0",
                           "--project", str(tmp_path), "--name", "bf16"]) == 0
    assert seen["dtype"] == torch.bfloat16
    assert all(np.isfinite(v) for k, v in seen["hist"][0].items() if k.startswith("train/"))
    payload = torch.load(tmp_path / "bf16" / "last.pt", weights_only=True)
    assert all(v.dtype == torch.float32 for v in payload["params"].values()
               if v.is_floating_point())
    det = Detector(str(tmp_path / "bf16" / "last.pt"), nc=1, imgsz=64, dtype="bfloat16",
                   device="cpu")
    d, _, _ = det(np.zeros((64, 64, 3), np.uint8), conf=0.0)
    assert d.scores.dtype == torch.float32 and torch.isfinite(d.scores).all()
