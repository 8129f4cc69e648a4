"""YOLO11-seg trainer (counterpart of ``poseestimator_tpu/training/trainer.py``):
the reference's operating point (epochs 300, imgsz 640, batch 16, Adam lr0
1e-3, patience 10, save + save_json, project/name run dirs, resume) on one
device or data-parallel over a ``parallel.Mesh``, with optax's update laws
reproduced, an EMA of the weights and ``torch.save`` checkpoints.

Data parallelism is the JAX package's single GSPMD program over the global
batch, not DDP's defaults: rank 0 loads each global batch (the single-
device loader's, draw for draw) and scatters the slices; BatchNorm takes
its statistics from the global batch, forward and backward
(``models.yolo.model.BatchNorm2d``); the loss normaliser is the global
batch's, and the per-rank gradients are summed. Weights, optimiser state
and EMA stay replicated and equal on every rank; validation losses are
reduced across ranks and mAP is computed from the gathered predictions;
only rank 0 writes checkpoints, TensorBoard and the JSON. A mesh of one
rank runs the single-device program.

The optimiser is optax's, written out: the learning rate of update t
(counted from 0) is ``join_schedules`` of a linear warm-up from 0 and a
linear decay to ``lr0 lrf``, evaluated in float32 *before* the count
advances, so update 0 has lr 0 (it moves Adam's moments and the BN
statistics, not the weights); Adam with ``eps`` outside the square root;
AdamW with optax's default decay 1e-4 (``weight_decay`` is not read, as in
the JAX package); SGD with Nesterov momentum 0.937. After each update the
EMA takes ``d = decay (1 - exp(-(step + 1) / 2000))`` of itself and 1 - d
of the weights; the BatchNorm statistics are carried raw. Evaluation and
checkpoints use the EMA weights.
"""
from __future__ import annotations

import copy
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.yolo.model import BatchNorm2d, YOLO11Seg, init_train_
from ..models.yolo.weights import variables_to_state_dict
from .data import Batch, DataLoader, DatasetSpec, list_samples, load_dataset_yaml
from .loss import segmentation_loss


@dataclass
class TrainState:
    """Weights and optimiser state of a run. ``params`` and ``batch_stats``
    are the live tensors of the trainer's model (name -> tensor); a step
    updates them in place."""
    params: dict
    batch_stats: dict
    opt_state: dict
    step: int
    ema_params: Optional[dict] = None


@dataclass
class TrainConfig:
    data: str  # dataset.yaml path
    epochs: int = 300
    imgsz: int = 640
    batch: int = 16
    optimizer: str = "Adam"
    lr0: float = 0.001
    lrf: float = 0.01  # final lr fraction (linear decay)
    weight_decay: float = 0.0
    warmup_epochs: float = 3.0
    patience: int = 10
    name: str = "run"
    project: str = "runs"
    exist_ok: bool = True
    resume: bool = False
    save: bool = True
    save_json: bool = True
    device: Any = "cuda"  # the torch device; a list of devices raises (see check_device)
    scale: str = "n"
    dtype: str = "float32"
    ema: bool = True  # keep an EMA of the weights for eval and checkpoints
    ema_decay: float = 0.9999
    val_map_every: int = 0  # compute val mAP every N epochs (0 = off)
    val_map_limit: int = 64  # max val images per mAP pass
    max_instances: int = 32
    seed: int = 0
    workers: int = 4
    augment: bool = True
    mosaic: float = 0.5  # 4-image mosaic probability (0 disables)
    close_mosaic: int = 10  # mosaic off for the final N epochs

    @property
    def run_dir(self) -> str:
        return os.path.join(self.project, self.name)


def check_device(device) -> torch.device:
    """One torch device. Several devices are several processes: run the
    training under ``torchrun --nproc_per_node N`` (the Trainer takes the
    initialised world) or pass ``Trainer(mesh=)``; a device list raises."""
    if isinstance(device, (list, tuple)) or (isinstance(device, str) and "," in device):
        raise NotImplementedError(
            f"device list {device!r}: data-parallel training runs one process per device; "
            "launch with torchrun --nproc_per_node N, or pass Trainer(mesh=parallel.make_mesh())")
    return resolve_device(device)


def make_schedule(cfg: TrainConfig, steps_per_epoch: int):
    """optax ``join_schedules`` of ``linear_schedule(0, lr0, w)`` and
    ``linear_schedule(lr0, lr0 lrf, total - w)`` at boundary w, in float32:
    -> ``lr(count)``."""
    total = max(cfg.epochs * steps_per_epoch, 1)
    warmup = max(int(cfg.warmup_epochs * steps_per_epoch), 1)
    f32 = np.float32

    def linear(init, end, steps, count):
        count = min(max(count, 0), steps)
        frac = f32(1) - f32(count) / f32(steps)
        return f32(f32(init - end) * frac + f32(end))

    def lr(count: int) -> float:
        if count < warmup:
            return float(linear(0.0, cfg.lr0, warmup, count))
        return float(linear(cfg.lr0, cfg.lr0 * cfg.lrf, max(total - warmup, 1), count - warmup))

    return lr


class Optimizer:
    """optax's ``adam``, ``adamw`` (decay 1e-4) or ``sgd`` (momentum 0.937,
    Nesterov) under a schedule, as in-place updates of a list of tensors."""

    B1, B2, EPS, WD, MOMENTUM = 0.9, 0.999, 1e-8, 1e-4, 0.937

    def __init__(self, kind: str, schedule):
        kind = kind.lower()
        if kind not in ("adam", "adamw", "sgd"):
            raise ValueError(f"unknown optimizer {kind!r} (Adam, AdamW or SGD)")
        self.kind, self.schedule = kind, schedule

    def init(self, params: list) -> dict:
        zeros = [torch.zeros_like(p) for p in params]
        if self.kind == "sgd":
            return {"count": 0, "trace": zeros}
        return {"count": 0, "mu": zeros, "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, params: list, grads: list, state: dict) -> float:
        """Apply one update in place; returns the learning rate it used."""
        lr = self.schedule(state["count"])
        state["count"] += 1
        if self.kind == "sgd":
            tr = state["trace"]
            torch._foreach_mul_(tr, self.MOMENTUM)
            torch._foreach_add_(tr, grads)  # trace = g + m trace
            upd = torch._foreach_mul(tr, self.MOMENTUM)
            torch._foreach_add_(upd, grads)  # Nesterov: g + m trace
            torch._foreach_add_(params, upd, alpha=-lr)
            return lr
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, self.B1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.B1)
        torch._foreach_mul_(nu, self.B2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.B2)
        t = np.int32(state["count"])
        bc1 = float(np.float32(1) - np.float32(self.B1) ** t)
        bc2 = float(np.float32(1) - np.float32(self.B2) ** t)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.EPS)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        if self.kind == "adamw":
            torch._foreach_add_(upd, params, alpha=self.WD)
        torch._foreach_add_(params, upd, alpha=-lr)
        return lr


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int) -> Optimizer:
    return Optimizer(cfg.optimizer, make_schedule(cfg, steps_per_epoch))


class Trainer:
    """YOLO11-seg training on ``cfg.device`` (the card by default; ``"cpu"``
    on request), data-parallel over ``mesh`` (a ``parallel.Mesh``; None: the
    initialised world when there is one, else the single device). Under a
    mesh every rank builds the Trainer and runs the same calls; the device
    is the mesh's and ``cfg.batch`` is the global batch."""

    def __init__(self, cfg: TrainConfig, nc: Optional[int] = None, mesh=None):
        if cfg.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype {cfg.dtype!r}: float32 or bfloat16")
        self.cfg = cfg
        if mesh is None and torch.distributed.is_available() \
                and torch.distributed.is_initialized():
            from ..parallel.mesh import make_mesh

            check_device(cfg.device)
            mesh = make_mesh("dp", device=cfg.device)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.rank0 = self.mesh is None or self.mesh.rank == 0
        self.device = check_device(cfg.device) if mesh is None else mesh.device
        if self.mesh is not None and cfg.batch % self.mesh.size:
            raise ValueError(f"batch {cfg.batch} is not divisible by the mesh size "
                             f"{self.mesh.size}")
        self.spec: DatasetSpec = load_dataset_yaml(cfg.data)
        self.nc = nc if nc is not None else max(self.spec.nc, 1)
        # the model computes in cfg.dtype; its parameters, the optimiser,
        # the EMA, the loss and the checkpoints stay float32
        self.model = YOLO11Seg(nc=self.nc, scale=cfg.scale, dtype=cfg.dtype).to(self.device)
        for m in self.model.modules():
            if isinstance(m, BatchNorm2d):
                m.mesh = self.mesh
        self._eval_model = None
        self.train_samples = list_samples(self.spec, "train")
        self.val_samples = list_samples(self.spec, "val") or self.train_samples
        self.loader = DataLoader(self.train_samples, cfg.batch, cfg.imgsz, cfg.max_instances,
                                 shuffle=True, augment=cfg.augment, mosaic=cfg.mosaic,
                                 seed=cfg.seed, workers=cfg.workers)
        self.val_loader = DataLoader(self.val_samples, cfg.batch, cfg.imgsz, cfg.max_instances,
                                     shuffle=False, augment=False, workers=cfg.workers)
        self.tx = make_optimizer(cfg, len(self.loader))
        self.last_lr = None

    # --- state ------------------------------------------------------------
    def _bind(self, opt_state=None, step: int = 0, ema=None) -> TrainState:
        if self.mesh is not None:  # every rank starts from rank 0's weights
            with torch.no_grad():
                for t in self.model.state_dict().values():
                    t.copy_(self.mesh.broadcast(t))
                if ema is not None:
                    ema = {k: self.mesh.broadcast(v) for k, v in ema.items()}
        params = dict(self.model.named_parameters())
        stats = dict(self.model.named_buffers())
        return TrainState(
            params=params, batch_stats=stats,
            opt_state=opt_state if opt_state is not None else self.tx.init(list(params.values())),
            step=step,
            ema_params=ema if ema is not None else (
                {k: p.detach().clone() for k, p in params.items()} if self.cfg.ema else None))

    def init_state(self, variables: Optional[Mapping] = None) -> TrainState:
        """Fresh state: seeded random weights (``init_train_`` from
        ``cfg.seed``), or the given weights (flax variables with numpy
        leaves, or a port state dict)."""
        if variables is None:
            self.model.cpu()
            init_train_(self.model, torch.Generator().manual_seed(self.cfg.seed))
            self.model.to(self.device)
        else:
            sd = variables_to_state_dict(variables) if "params" in variables else variables
            self.model.load_state_dict(sd, strict=True)
        return self._bind()

    # --- steps ------------------------------------------------------------
    def _tensors(self, batch: Optional[Batch]):
        """The step's tensors on this device; under a mesh this rank's slice
        of rank 0's ``batch`` (None on the other ranks)."""
        if self.mesh is not None:
            return self._scatter(batch)
        dev = self.device
        return (torch.from_numpy(np.ascontiguousarray(batch.images)).to(dev).permute(0, 3, 1, 2),
                torch.from_numpy(batch.boxes).to(dev),
                torch.from_numpy(batch.classes.astype(np.int64)).to(dev),
                torch.from_numpy(batch.masks).to(dev),
                torch.from_numpy(batch.inst_valid).to(dev))

    def _scatter(self, batch: Optional[Batch]):
        c, mesh = self.cfg, self.mesh
        B, S, M = c.batch, c.imgsz, c.max_instances
        fields = (("images", (B, S, S, 3), torch.float32), ("boxes", (B, M, 4), torch.float32),
                  ("classes", (B, M), torch.int64),
                  ("masks", (B, M, S // 4, S // 4), torch.float32),
                  ("inst_valid", (B, M), torch.bool))
        out = []
        for name, shape, dtype in fields:
            full = None
            if mesh.rank == 0:
                full = torch.from_numpy(np.ascontiguousarray(getattr(batch, name))).to(dtype)
            out.append(mesh.scatter(full, shape, dtype))
        out[0] = out[0].permute(0, 3, 1, 2)
        return tuple(out)

    def _reduce_parts(self, parts: dict) -> dict:
        """This rank's loss parts -> the global batch's (``n_pos`` is global
        already)."""
        parts = {k: v.detach() for k, v in parts.items()}
        if self.mesh is None:
            return parts
        names = [k for k in parts if k != "n_pos"]
        summed = self.mesh.all_reduce(torch.stack([parts[k] for k in names]))
        return {**dict(zip(names, summed)), "n_pos": parts["n_pos"]}

    def _train_step(self, state: TrainState, images, boxes, classes, masks, inst_valid):
        """One update: forward in train mode (BN statistics move), loss,
        autograd, the optimiser, then the EMA. -> (state, parts). Under a
        mesh: this rank's slice, the global normaliser, the gradients summed
        over ranks."""
        self.model.train()
        params = list(state.params.values())
        out = self.model(images)
        reduce = None if self.mesh is None else self.mesh.all_reduce
        total, parts = segmentation_loss(out, boxes, classes, masks, inst_valid, reduce=reduce)
        grads = torch.autograd.grad(total, params)
        if self.mesh is not None:
            flat = self.mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
            grads = [f.view_as(p) for f, p in zip(flat.split([p.numel() for p in params]), params)]
        self.last_lr = self.tx.update(params, list(grads), state.opt_state)
        if state.ema_params is not None:
            step_f = np.float32(state.step + 1)
            d = float(np.float32(self.cfg.ema_decay)
                      * (np.float32(1) - np.exp(-step_f / np.float32(2000.0))))
            ema = list(state.ema_params.values())
            with torch.no_grad():
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, params, alpha=1.0 - d)
        state.step += 1
        return state, self._reduce_parts(parts)

    def _eval_weights(self, state: TrainState) -> torch.nn.Module:
        """A model in eval mode holding the EMA weights (the raw ones
        without EMA) and the raw BatchNorm statistics."""
        if self._eval_model is None:
            self._eval_model = copy.deepcopy(self.model)
        m = self._eval_model
        src = state.params if state.ema_params is None else state.ema_params
        with torch.no_grad():
            for k, p in m.named_parameters():
                p.copy_(src[k])
            for k, b in m.named_buffers():
                b.copy_(state.batch_stats[k])
        return m.eval()

    @torch.no_grad()
    def _eval_step(self, state: TrainState, images, boxes, classes, masks, inst_valid):
        out = self._eval_weights(state)(images)
        reduce = None if self.mesh is None else self.mesh.all_reduce
        _, parts = segmentation_loss(out, boxes, classes, masks, inst_valid, reduce=reduce)
        return self._reduce_parts(parts)

    def _batches(self, loader):
        """The loader's batches on rank 0; as many Nones on the others."""
        return iter(loader) if self.rank0 else (None for _ in range(len(loader)))

    # --- loops ------------------------------------------------------------
    def train_epoch(self, state: TrainState):
        metrics = []
        for batch in self._batches(self.loader):
            state, parts = self._train_step(state, *self._tensors(batch))
            metrics.append(parts)
        return state, _mean_parts(metrics)

    def evaluate(self, state: TrainState):
        return _mean_parts([self._eval_step(state, *self._tensors(b))
                            for b in self._batches(self.val_loader)])

    def fit(self, state: Optional[TrainState] = None, log=print, tensorboard: bool = True):
        cfg = self.cfg
        if not self.rank0:  # one writer: rank 0 logs and saves
            log, tensorboard = (lambda *a, **k: None), False
            cfg = copy.copy(cfg)
            cfg.save = cfg.save_json = False
        else:
            os.makedirs(cfg.run_dir, exist_ok=True)
        tb = None
        if tensorboard:
            try:  # optional TensorBoard scalars; results.json is always written
                from torch.utils.tensorboard import SummaryWriter

                tb = SummaryWriter(os.path.join(cfg.run_dir, "tb"))
            except Exception:
                tb = None
        start_epoch = 0
        if state is None:
            last = os.path.join(cfg.run_dir, "last.pt")
            if cfg.resume and os.path.exists(last):
                state, start_epoch = self.load(last)
                log(f"resumed from epoch {start_epoch}")
            else:
                state = self.init_state()

        best_val = float("inf")
        bad_epochs = 0
        history = []
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            if cfg.close_mosaic and self.loader.mosaic and epoch >= cfg.epochs - cfg.close_mosaic:
                self.loader.mosaic = 0.0
                log(f"epoch {epoch}: mosaic off (close_mosaic {cfg.close_mosaic})")
            state, train_m = self.train_epoch(state)
            val_m = self.evaluate(state)
            dt = time.time() - t0
            rec = {"epoch": epoch, "time_s": dt,
                   **{f"train/{k}": v for k, v in train_m.items()},
                   **{f"val/{k}": v for k, v in val_m.items()}}
            if cfg.val_map_every and (epoch + 1) % cfg.val_map_every == 0:
                m = self.evaluate_map(state)
                rec["val/map50"] = m["map50"]
                rec["val/map50_95"] = m["map50_95"]
                log(f"  val mAP50 {m['map50']:.4f} mAP50-95 {m['map50_95']:.4f}")
            history.append(rec)
            if tb is not None:
                for k, v in rec.items():
                    if isinstance(v, (int, float)) and k != "epoch":
                        tb.add_scalar(k, v, epoch)
            log(f"epoch {epoch}: train {train_m['total']:.4f} val {val_m['total']:.4f} "
                f"({dt:.1f}s)")
            if cfg.save:
                self.save(state, os.path.join(cfg.run_dir, "last.pt"), epoch + 1)
            if val_m["total"] < best_val - 1e-6:
                best_val = val_m["total"]
                bad_epochs = 0
                if cfg.save:
                    self.save(state, os.path.join(cfg.run_dir, "best.pt"), epoch + 1)
            else:
                bad_epochs += 1
                if bad_epochs >= cfg.patience:
                    log(f"early stopping at epoch {epoch} (patience {cfg.patience})")
                    break
        if tb is not None:
            tb.close()
        if cfg.save_json:
            with open(os.path.join(cfg.run_dir, "results.json"), "w") as f:
                json.dump(history, f, indent=2)
        return state, history

    # --- checkpoints ------------------------------------------------------
    def save(self, state: TrainState, path: str, epoch: int) -> None:
        """``torch.save`` of ``{"params": the EMA weights with the BN
        statistics (what inference loads), "params_raw": the raw weights
        and statistics (what resume loads), "epoch"}``."""
        cpu = lambda d: {k: v.detach().to("cpu").clone() for k, v in d.items()}  # noqa: E731
        raw = {**cpu(state.params), **cpu(state.batch_stats)}
        infer = {**raw, **cpu(state.ema_params)} if state.ema_params is not None else raw
        order = list(self.model.state_dict().keys())
        tmp = path + ".tmp"
        torch.save({"params": {k: infer[k] for k in order},
                    "params_raw": {k: raw[k] for k in order}, "epoch": int(epoch)}, tmp)
        os.replace(tmp, path)

    def load(self, path: str):
        """-> (state, epoch): the raw weights into the model, the EMA from
        the checkpoint's inference weights, a fresh optimiser and step 0 (as
        the JAX package resumes)."""
        payload = torch.load(path, map_location="cpu", weights_only=True)
        raw = payload.get("params_raw", payload["params"])
        self.model.load_state_dict(raw, strict=True)
        ema = None
        if self.cfg.ema:
            names = dict(self.model.named_parameters())
            ema = {k: payload["params"][k].to(self.device).clone() for k in names}
        return self._bind(ema=ema), int(payload["epoch"])

    def export_variables(self, state: TrainState) -> dict:
        """The inference state dict (EMA weights, raw BN statistics) that
        the port's ``Detector`` loads."""
        src = state.params if state.ema_params is None else state.ema_params
        out = {k: v.detach().clone() for k, v in src.items()}
        out.update({k: v.detach().clone() for k, v in state.batch_stats.items()})
        return {k: out[k] for k in self.model.state_dict().keys()}

    def evaluate_map(self, state: TrainState, conf: float = 0.001) -> dict:
        """COCO-style box mAP of the EMA weights on the val split."""
        from ..pipeline.detector import Detector
        from .evaluate import evaluate_detector

        det = getattr(self, "_map_detector", None)
        if det is None:
            det = self._map_detector = Detector(
                self.export_variables(state), nc=self.nc, scale=self.cfg.scale,
                imgsz=self.cfg.imgsz, pre_nms=4096, max_det=300, device=self.device)
        else:
            det.model.load_state_dict(self.export_variables(state), strict=True)
        samples = self.val_samples[: self.cfg.val_map_limit]
        return evaluate_detector(det, samples, imgsz=self.cfg.imgsz, conf=conf, mesh=self.mesh)


def _mean_parts(metrics: list) -> dict:
    keys = metrics[0].keys()
    stacked = {k: torch.stack([m[k].float() for m in metrics]).cpu().numpy() for k in keys}
    return {k: float(np.mean([float(x) for x in v])) for k, v in stacked.items()}


def train(**kwargs):
    """Keyword entry mirroring ultralytics ``model.train(...)``."""
    cfg = TrainConfig(**{k: v for k, v in kwargs.items() if k in TrainConfig.__dataclass_fields__})
    tr = Trainer(cfg)
    state, history = tr.fit()
    return tr, state, history
