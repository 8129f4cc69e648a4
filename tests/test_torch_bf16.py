"""Port parity, the bfloat16 detector and bfloat16 training, on the CPU
against the JAX package's bfloat16 counterparts (``YOLO11Seg(dtype=
jnp.bfloat16)``, ``Detector(dtype="bfloat16")``, ``TrainConfig(dtype=
"bfloat16")``) at a small size (imgsz 128, nc 2).

bfloat16 is not bit-equal across the two packages: XLA and ATen sum a
convolution's products in different orders, the port's SiLU, sigmoid and
softmax round once (torch's fused ops) where XLA's expansions round at
every step, and a rounding flips here and there and travels through the
network. So the conv + BatchNorm law is held to within a bfloat16 ulp, and
the network's heads, its gradients, the detections and a train step to the
bounds stated in each test, each with the gap measured on the CPU beside
it. Where a bound is the JAX package's own bfloat16-to-float32 spread, the
port's bfloat16 result lies within 1x that spread of the float32 result
(it moves no further from float32 than the JAX package's bfloat16 does),
and so within 2x of the JAX package's bfloat16 result; planted faults (a
sign-flipped and a dropped weight gradient) must break those bounds. The
detections' score bound is the JAX package's own bfloat16-to-float32 bound
(``tests/test_batch_predict.py``: max score 0.03)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from test_torch_track_step import (H, J_INTR, T_INTR, W, WIN,  # noqa: F401 (fixtures)
                                   _jax_nn_as_k1, jax_sampler_draws, scene)
from test_torch_training import _leaves, _rel, carried, head_batch  # noqa: F401
from test_training import make_synthetic_dataset
from test_torch_yolo import _randomized

from poseestimator_tpu.models import yolo as Y
from poseestimator_tpu.models.yolo.layers import ConvBNAct
from poseestimator_tpu.pipeline import Detector as JDetector
from poseestimator_tpu.pipeline.tracking import _track_step
from poseestimator_tpu.training import loss as jloss
from poseestimator_tpu.training import trainer as jtrainer
from poseestimator_tpu_torch.models.yolo import decode as pdec
from poseestimator_tpu_torch.models.yolo import masks as pmasks
from poseestimator_tpu_torch.models.yolo import model as pmodel
from poseestimator_tpu_torch.models.yolo import preprocess as pprep
from poseestimator_tpu_torch.models.yolo import weights as tweights
from poseestimator_tpu_torch.models.yolo.weights import state_dict_to_variables
from poseestimator_tpu_torch.pipeline.detector import Detector
from poseestimator_tpu_torch.pipeline.tracking import FusedFrame
from poseestimator_tpu_torch.training import loss as ploss
from poseestimator_tpu_torch.training import trainer as ptrainer
from torch_threads import two_threads  # noqa: F401

BF = jnp.bfloat16
IMG = 128


def _np(a) -> np.ndarray:
    return np.array(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module")
def variables():
    """flax ``YOLO11Seg(nc=2)`` variables with the BatchNorm statistics and
    the biases randomised (class scores then straddle 0.5, so NMS ranks
    real candidates)."""
    init = jax.jit(lambda x: Y.YOLO11Seg(nc=2, scale="n").init(
        jax.random.PRNGKey(0), x, train=False))
    return jax.tree_util.tree_map(np.asarray, _randomized(init(jnp.zeros((1, IMG, IMG, 3)))))


def _block(train: bool, act: bool):
    """One conv + BatchNorm (+ SiLU) block with ``dtype=bfloat16`` on both
    sides, randomised BN parameters and statistics: (flax's output, the
    port's, both as float32 NHWC) and the two sides' running statistics."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, 16, 16, 16)).astype(np.float32)
    mod = ConvBNAct(32, 3, act=act, dtype=BF)
    v = jax.tree_util.tree_map(np.asarray, mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v["params"]["bn"] = {k: rng.uniform(0.5, 1.5, 32).astype(np.float32) for k in ("scale", "bias")}
    v["batch_stats"]["bn"] = {"mean": rng.normal(size=32).astype(np.float32) * 0.1,
                              "var": rng.uniform(0.5, 1.5, 32).astype(np.float32)}
    port = pmodel.Conv(16, 32, 3, act=act)
    port.conv.compute_dtype = torch.bfloat16
    port.conv.weight.data = torch.from_numpy(
        np.transpose(v["params"]["conv"]["kernel"], (3, 2, 0, 1)).copy())
    bn = port.bn
    bn.weight.data, bn.bias.data = (torch.from_numpy(v["params"]["bn"][k]) for k in ("scale", "bias"))
    bn.running_mean.data, bn.running_var.data = (torch.from_numpy(v["batch_stats"]["bn"][k])
                                                 for k in ("mean", "var"))
    port.train(train)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    stats = None
    if train:
        y, mut = mod.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        out = port(xt)
        stats = [(t.numpy(), mut["batch_stats"]["bn"][k])
                 for k, t in (("mean", bn.running_mean), ("var", bn.running_var))]
    else:
        y = mod.apply(v, jnp.asarray(x))
        with torch.no_grad():
            out = port(xt)
    assert out.dtype == torch.bfloat16
    return _np(y), out.detach().permute(0, 2, 3, 1).float().numpy(), stats


@pytest.mark.parametrize("act", [False, True], ids=["conv+bn", "conv+bn+silu"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_block_follows_flax_in_bfloat16(train, act):
    """One conv + BatchNorm (+ SiLU) block with ``dtype=bfloat16`` under
    flax's laws (the conv in bfloat16; the BatchNorm in float32 from the
    bfloat16 input, its batch statistics too in training, rounded once):
    equal to flax's at all but <= 0.5% of the elements (measured: eval 0,
    train 0.34%), every element within one bfloat16 ulp in eval and all but
    <= 0.2% in training (measured 9 of 16384, 17 with the SiLU, the farthest
    5.7 ulps). The SiLU is torch's fused one, rounded once: the reference
    for it is flax's conv + BatchNorm output through a float32 SiLU rounded
    once, held to the same bounds; flax's own block (``jax.nn.silu`` rounds
    after the logistic and after the product) differs at ~40% of the
    elements, each within two ulps in eval (measured 1.27). The running
    statistics within 1e-5."""
    a, b, stats = _block(train, act)
    for p, j in stats or ():
        np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-7)
    if act:
        assert train or np.all(np.abs(a - b) <= 2.0 ** -6 * np.abs(a))
        a = _np(jax.nn.silu(jnp.asarray(_block(train, False)[0])).astype(BF))
    ulp = 2.0 ** -7 * np.maximum(np.abs(a), 2.0 ** -126)
    assert (a != b).mean() <= 5e-3
    # train mode: a few elements near zero move further with the batch
    # statistics' float32 rounding (two-pass variance in the port, as its
    # float32 BN computes it; E[x^2] - E[x]^2 in flax)
    assert (np.abs(a - b) > ulp * 1.01).mean() <= (2e-3 if train else 0.0)


def test_bfloat16_heads_match_jax(variables):
    """The whole network at imgsz 128 in bfloat16: every head and the
    prototypes within 0.01 of the JAX package's bfloat16 (measured 0.0029;
    the JAX package's own bfloat16-to-float32 gap on the class logits
    0.0022), the parameters float32 on the port's side."""
    img = np.random.default_rng(1).uniform(0, 1, size=(2, IMG, IMG, 3)).astype(np.float32)
    jraw = jax.jit(lambda v, x: Y.YOLO11Seg(nc=2, scale="n", dtype=BF).apply(
        v, x, train=False))(variables, jnp.asarray(img))
    tm = tweights.load_variables(pmodel.YOLO11Seg(nc=2, scale="n", dtype=torch.bfloat16),
                                 variables).eval()
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    with torch.no_grad():
        traw = tm(torch.from_numpy(img).permute(0, 3, 1, 2))
    for key in ("box", "cls", "mc", "proto"):
        js = [jraw[key]] if key == "proto" else jraw[key]
        ts = [traw[key]] if key == "proto" else traw[key]
        for a, b in zip(js, ts):
            assert b.dtype == torch.bfloat16
            np.testing.assert_allclose(b.float().numpy(), _np(a), atol=0.01, err_msg=key)


class _Flip(torch.autograd.Function):
    """Identity forward, the gradient's sign flipped (a planted fault)."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return -g


class _Drop(_Flip):
    """Identity forward, the gradient dropped (a planted fault)."""

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


def _plant(monkeypatch, fault):
    """Every conv's bfloat16 kernel cast passes its gradient through
    ``fault`` (``"flip"`` or ``"drop"``; None: no fault)."""
    if fault is None:
        return
    fn = {"flip": _Flip, "drop": _Drop}[fault].apply

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        return self._conv_forward(x.to(dt), fn(self.weight).to(dt),
                                  None if self.bias is None else self.bias.to(dt))

    monkeypatch.setattr(pmodel.Conv2d, "forward", forward)


def _head_list(raw):
    return [raw["proto"]] + [t for k in ("box", "cls", "mc") for t in raw[k]]


def _grad_gap(a: dict, b: dict) -> np.ndarray:
    """(median over leaves of the largest gap relative to the leaf's
    largest entry, the whole gradient's relative L2 gap)."""
    keys = sorted(b)
    va, vb = (np.concatenate([d[k].ravel() for k in keys]).astype(np.float64) for d in (a, b))
    return np.array([np.median([_rel(a[k], b[k]) for k in keys]),
                     np.linalg.norm(va - vb) / np.linalg.norm(vb)])


@pytest.fixture(scope="module")
def grad_case(variables):
    """A smooth loss of the network's outputs (a fixed random weighting of
    every head and the prototypes), BatchNorm on its running statistics, on
    two 128 x 128 images; the JAX package's parameter gradients in float32
    and bfloat16."""
    img = np.random.default_rng(1).uniform(0, 1, size=(2, IMG, IMG, 3)).astype(np.float32)
    shapes = [np.shape(o) for o in _head_list(jax.eval_shape(
        lambda v, x: Y.YOLO11Seg(nc=2, scale="n").apply(v, x, train=False),
        variables, jnp.asarray(img)))]
    rng = np.random.default_rng(2)
    ws = [rng.normal(size=sh).astype(np.float32) for sh in shapes]
    grads = {}
    for dt in (jnp.float32, BF):
        def loss(p, dt=dt):
            raw = Y.YOLO11Seg(nc=2, scale="n", dtype=dt).apply(
                {"params": p, "batch_stats": variables["batch_stats"]}, jnp.asarray(img),
                train=False)
            return sum((o.astype(jnp.float32) * w).sum() for o, w in zip(_head_list(raw), ws))
        grads[jnp.dtype(dt).name] = _leaves(jax.jit(jax.grad(loss))(variables["params"]))
    return img, ws, grads


def _port_grads(variables, img, ws, dtype):
    tm = tweights.load_variables(pmodel.YOLO11Seg(nc=2, scale="n", dtype=dtype), variables).eval()
    out = tm(torch.from_numpy(img).permute(0, 3, 1, 2))
    sum((o.float() * torch.from_numpy(w)).sum() for o, w in zip(_head_list(out), ws)).backward()
    assert all(p.grad.dtype == torch.float32 for p in tm.parameters())
    return _leaves(state_dict_to_variables({k: p.grad for k, p in tm.named_parameters()})["params"])


@pytest.mark.parametrize("fault", [None, "flip", "drop"])
def test_bfloat16_network_gradients_match_jax(variables, grad_case, monkeypatch, fault):
    """The backward through the bfloat16 network into the float32
    parameters (autograd through the casts), on ``grad_case``'s loss. The
    JAX package's own bfloat16 gradient sits 1.5% (median leaf) and 1.6%
    (whole gradient) from its float32 one: that is the spread. The port's
    float32 gradient equals the JAX package's to 1e-4 (measured 1.1e-6); the
    port's bfloat16 gradient lies within 1x the spread of the float32 one
    (measured 0.84x and 0.34x) and so within 2x of the JAX package's
    bfloat16 one (measured 1.1x and 1.0x: most of that distance is the JAX
    package's own rounding). A planted fault in every conv's kernel cast, a
    flipped or a dropped gradient, must fail those bounds (it reads ~2 and
    ~1 relative to the conv kernels' share of the gradient: measured 97x
    and 49x the spread on the whole gradient)."""
    img, ws, jg = grad_case
    p32 = _port_grads(variables, img, ws, torch.float32)
    _plant(monkeypatch, fault)
    p16 = _port_grads(variables, img, ws, torch.bfloat16)
    spread = _grad_gap(jg["bfloat16"], jg["float32"])
    assert np.all(spread < 0.05)
    assert np.all(_grad_gap(p32, jg["float32"]) <= 1e-4)
    within = (np.all(_grad_gap(p16, jg["float32"]) <= spread)
              and np.all(_grad_gap(p16, jg["bfloat16"]) <= 2 * spread))
    assert within == (fault is None)


def test_bfloat16_detector_matches_jax(variables):
    """``Detector(dtype="bfloat16")`` against the JAX package's on three
    96x128 images at conf 0. After NMS: the same count, the sorted scores
    within 0.03, the bound of the JAX package's own bfloat16-to-float32
    test (measured 0.0039), the masks of the same shape; the port's boxes
    and scores leave as float32. This randomised network's scores tie in
    bfloat16 (the best 32 all read 0.5547), so the detection that leads is
    the tie order's choice and detections are not paired by rank. Per
    anchor instead, before NMS, on each side's own letterboxed image: the
    decoded boxes within 1 px (the JAX package's own bfloat16-to-float32
    gap 0.83 px; measured 0.80), the class probabilities within 0.03
    (measured 0.0039); and the masks of the 8 best anchors, each side
    from its own coefficients, boxes and prototypes, differing at <= 1% of
    their pixels (measured 0; these weights' masks are empty, so their
    probabilities before the threshold are held too, within 0.01: measured
    0.002)."""
    jd = JDetector(variables, nc=2, imgsz=IMG, dtype="bfloat16")
    td = Detector(variables, nc=2, imgsz=IMG, dtype="bfloat16", device="cpu")
    jraw = jax.jit(lambda v, x: Y.YOLO11Seg(nc=2, scale="n", dtype=BF).apply(
        v, x[None], train=False))
    rng = np.random.default_rng(0)
    for _ in range(3):
        img = rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)
        dj, mj, bj = jd(img, conf=0.0)
        dt, mt, bt = td(img, conf=0.0)
        assert dt.scores.dtype == torch.float32 and bt.dtype == torch.float32
        assert int(dt.count()) == int(dj.count())
        sj, st = _np(dj.scores), dt.scores.numpy()
        assert np.abs(np.sort(sj) - np.sort(st)).max() <= 0.03
        assert tuple(mt.shape) == np.asarray(mj).shape

        lbj, metaj = Y.letterbox(jnp.asarray(img), IMG)
        rawj = jraw(variables, lbj)
        boxj, clsj, mcj = Y.decode_boxes(rawj)
        lbt, metat = pprep.letterbox(torch.from_numpy(img), IMG)
        with torch.no_grad():
            rawt = td.model(lbt.permute(2, 0, 1)[None])
        boxt, clst, mct = pdec.decode_boxes(rawt)
        np.testing.assert_allclose(boxt.numpy(), _np(boxj), atol=1.0)
        np.testing.assert_allclose(clst.float().numpy(), _np(clsj), atol=0.03)
        top = np.argsort(-_np(clsj)[0].max(-1), kind="stable")[:8]
        ones = np.ones(8, bool)
        mj8 = Y.assemble_masks(rawj["proto"][0], mcj[0][top], boxj[0][top], jnp.asarray(ones),
                               metaj, 96, 128)
        mt8 = pmasks.assemble_masks(rawt["proto"][0], mct[0][top], boxt[0][top],
                                    torch.from_numpy(ones), metat, 96, 128)
        assert (mt8.numpy() != np.asarray(mj8)).mean() <= 0.01
        # this network's masks come out empty: the probabilities before the
        # threshold, at the prototypes' resolution
        pj = jax.nn.sigmoid(jnp.einsum("dn,hwn->dhw", mcj[0][top], rawj["proto"][0]))
        pt = torch.sigmoid(torch.einsum("dn,hwn->dhw", mct[0][top], rawt["proto"][0]))
        np.testing.assert_allclose(pt.float().numpy(), _np(pj), atol=0.01)
    with pytest.raises(ValueError, match="bfloat16"):
        Detector(variables, nc=2, imgsz=IMG, dtype="float16", device="cpu")


def test_bfloat16_fused_frame_matches_jax_composition(scene):  # noqa: F811
    """``FusedFrame`` over a bfloat16 detector against the JAX composition
    of bench.py's ``one_frame`` with ``YOLO11Seg(dtype=bfloat16)`` (as
    ``tests/test_torch_track_step.py`` holds the float32 frame): the same
    detection count and ``ok``, T within 1e-4."""
    verts, faces, T0, T_obs, depth = scene
    sil = depth > 0
    tmodel = pmodel.init_random_(pmodel.YOLO11Seg(nc=5, scale="n"),
                                 torch.Generator().manual_seed(0)).set_dtype("bfloat16")
    variables = state_dict_to_variables(tmodel.state_dict())
    jmodel = Y.YOLO11Seg(nc=5, scale="n", dtype=BF)
    color = np.random.default_rng(0).integers(0, 255, (H, W, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(11)

    @jax.jit
    def detect_mask(variables, frame):
        lb, meta = Y.letterbox(frame, 128)
        raw = jmodel.apply(variables, lb[None], train=False)
        boxes, cls, mc = Y.decode_boxes(raw)
        det = Y.nms(boxes[0], cls[0], mc[0], conf_thres=0.25, iou_thres=0.7,
                    pre_nms=1024, max_det=32)
        mask = Y.assemble_masks(raw["proto"][0], det.coeffs[:1], det.boxes[:1],
                                det.valid[:1], meta, H, W)[0]
        return det.count(), mask

    n_det, mask = detect_mask(variables, jnp.asarray(color))
    mask = mask | jnp.asarray(sil)
    Tj, _, _, _ = _track_step(jnp.asarray(verts), jnp.asarray(faces), mask, jnp.asarray(depth),
                              jnp.asarray(T0), J_INTR, 0, key, icp_dist=jnp.float32(0.01),
                              win_hw=WIN)
    ok_j = bool((n_det > 0) & jnp.any(mask))
    Tj = np.asarray(Tj) if ok_j else T0

    frame = FusedFrame(tmodel, verts, faces, T_INTR, win_hw=WIN, imgsz=128, max_det=32,
                       device="cpu")
    res = frame(torch.from_numpy(color), torch.from_numpy(depth), torch.from_numpy(T0),
                conf=0.25, icp_dist=0.01, mask_union=torch.from_numpy(sil),
                draws=jax_sampler_draws(key, WIN))
    assert int(n_det) > 0
    assert bool(res.ok) == ok_j
    np.testing.assert_allclose(res.T.numpy(), Tj, atol=1e-4)


def test_bfloat16_loss_and_head_gradients_match_jax(head_batch):  # noqa: F811
    """The loss law on bfloat16 head outputs (the same values on both
    sides; JAX's promotion at every mixed op): the total and the parts
    within 1e-3 relative of the JAX package's (measured 6e-7), and
    d total / d head outputs, bfloat16 on both sides, within 5% of each
    leaf's largest entry (measured 1.9%: XLA keeps some cotangents in
    float32 between a bfloat16 op and the float32 dot it feeds, where
    autograd rounds every bfloat16 tensor's gradient)."""
    raw, gb, gc, gm, gv = head_batch
    jraw = {k: (tuple(jnp.asarray(t).astype(BF) for t in v) if isinstance(v, tuple)
                else jnp.asarray(v).astype(BF)) for k, v in raw.items()}
    gt = [jnp.asarray(a) for a in (gb, gc, gm, gv)]
    (_, jp), gj = jax.value_and_grad(lambda r: jloss.segmentation_loss(r, *gt), has_aux=True)(jraw)
    leaves = {k: (tuple(torch.from_numpy(_np(t)).bfloat16().requires_grad_(True) for t in v)
                  if isinstance(v, tuple) else torch.from_numpy(_np(v)).bfloat16().requires_grad_(True))
              for k, v in jraw.items()}
    total, pp = ploss.segmentation_loss(leaves, *(torch.from_numpy(np.asarray(a)) for a in
                                                  (gb, gc, gm, gv)))
    assert total.dtype == torch.float32
    total.backward()
    for k in jp:
        np.testing.assert_allclose(float(pp[k].detach()), float(jp[k]), rtol=1e-3, err_msg=k)
    for k in ("box", "cls", "mc", "proto"):
        js = gj[k] if isinstance(gj[k], tuple) else (gj[k],)
        ps = leaves[k] if isinstance(leaves[k], tuple) else (leaves[k],)
        for a, b in zip(js, ps):
            assert b.grad.dtype == torch.bfloat16
            a = _np(a)
            np.testing.assert_allclose(b.grad.float().numpy(), a,
                                       atol=5e-2 * max(np.abs(a).max(), 1e-12), err_msg=k)


@pytest.fixture(scope="module")
def step_case(carried, tmp_path_factory):  # noqa: F811
    """One train step from the carried variables on one loader batch of
    eight 160-pixel synthetic images (imgsz 128, nc 2, batch 8): the JAX
    package's float32 and bfloat16 steps (loss parts, Adam's first moment,
    the BatchNorm statistics), the batch and the trainer's settings."""
    _, var = carried
    tmp = tmp_path_factory.mktemp("bf16_step")
    kw = dict(data=make_synthetic_dataset(str(tmp / "blobs"), n_images=8, size=160), epochs=3,
              imgsz=IMG, batch=8, max_instances=4, warmup_epochs=1.0, project=str(tmp),
              name="bf16")
    batch, steps = None, {}
    for dtype in ("float32", "bfloat16"):
        jt = jtrainer.Trainer(jtrainer.TrainConfig(**kw, dtype=dtype), nc=2,
                              mesh=Mesh(np.array(jax.devices()[:1]), ("dp",)))
        params = jax.device_put(var["params"])
        js = jax.device_put(jtrainer.TrainState(
            params=params, batch_stats=jax.device_put(var["batch_stats"]),
            opt_state=jax.jit(jt.tx.init)(params), step=jnp.int32(0),
            ema_params=jax.device_put(var["params"])), jt.repl_sharding)
        batch = batch if batch is not None else next(iter(jt.loader))
        js, jparts = jt._train_step(js, *jt._shard(batch))
        steps[dtype] = ({k: float(v) for k, v in jparts.items()},
                        _leaves(js.opt_state[0].mu), _leaves(js.batch_stats))
    return var, kw, batch, steps


def _port_step(var, kw, batch, dtype):
    pt = ptrainer.Trainer(ptrainer.TrainConfig(**kw, dtype=dtype, device="cpu"), nc=2)
    ps = pt.init_state(var)
    ps, parts = pt._train_step(ps, *pt._tensors(batch))
    assert all(p.dtype == torch.float32 for p in ps.params.values())
    assert all(m.dtype == torch.float32 for m in ps.opt_state["mu"])
    assert all(e.dtype == torch.float32 for e in ps.ema_params.values())
    names = list(ps.params)
    return ({k: float(v) for k, v in parts.items()},
            _leaves(state_dict_to_variables(dict(zip(names, ps.opt_state["mu"])))["params"]),
            _leaves(state_dict_to_variables({**ps.params, **ps.batch_stats})["batch_stats"]))


def _step_gap(a, b) -> np.ndarray:
    """(the largest loss part's relative gap, Adam's first moment's and the
    BatchNorm statistics' relative L2 gaps)."""
    (pa, ma, sa), (pb, mb, sb) = a, b

    def l2(x, y):
        keys = sorted(y)
        vx, vy = (np.concatenate([d[k].ravel() for k in keys]).astype(np.float64) for d in (x, y))
        return np.linalg.norm(vx - vy) / np.linalg.norm(vy)

    return np.array([max(abs(pa[k] - pb[k]) / max(abs(pb[k]), 1e-3) for k in pb),
                     l2(ma, mb), l2(sa, sb)])


@pytest.mark.parametrize("fault", [None, "flip", "drop"])
def test_bfloat16_train_step_matches_jax(step_case, monkeypatch, fault):
    """One train step of ``TrainConfig(dtype="bfloat16")`` against the JAX
    package's bfloat16 and float32 steps (``step_case``). The parameters,
    the optimiser state and the EMA stay float32.

    A bfloat16 step moves far from a float32 one in both packages: train-
    mode BatchNorm's backward subtracts the batch means from the incoming
    gradient, which leaves a small residue of a bfloat16-rounded gradient,
    and the TAL targets follow the predictions. The JAX package's own
    bfloat16 step sits 2.6% (loss parts), 68% (Adam's first moment, L2) and
    0.08% (BN statistics, L2) from its float32 step: that is the spread.
    The port's float32 step equals the JAX package's to 1e-2 of it (measured
    4e-4); the port's bfloat16 step differs from it, lies within 1x the
    spread of either float32 step in the loss parts and the first moment
    (measured 0.53x and 0.84x) and within 2x of the JAX package's bfloat16
    step (measured 1.47x, 0.93x, 1.17x), as two bfloat16 steps each within
    the spread of float32 are. The BN statistics' bound from float32 is 2x
    as well (measured 1.10x): the law that computes them is held to 1e-5
    by ``test_block_follows_flax_in_bfloat16``, and here they differ only
    through the bfloat16 conv outputs, which XLA and ATen round apart by
    errors of the same size. A planted fault in every conv's kernel cast, a
    flipped or a dropped gradient, must fail those bounds (its first moment
    reads 2.9x and 1.5x the spread from float32)."""
    var, kw, batch, steps = step_case
    p32 = _port_step(var, kw, batch, "float32")
    _plant(monkeypatch, fault)
    p16 = _port_step(var, kw, batch, "bfloat16")
    assert all(np.isfinite(v) for v in p16[0].values())
    spread = _step_gap(steps["bfloat16"], steps["float32"])
    assert np.all(_step_gap(p32, steps["float32"]) <= 1e-2 * spread)
    assert np.all(_step_gap(p16, p32) > 0)
    from_f32 = spread * np.array([1.0, 1.0, 2.0])
    within = (np.all(_step_gap(p16, steps["float32"]) <= from_f32)
              and np.all(_step_gap(p16, p32) <= from_f32)
              and np.all(_step_gap(p16, steps["bfloat16"]) <= 2 * spread))
    assert within == (fault is None)
