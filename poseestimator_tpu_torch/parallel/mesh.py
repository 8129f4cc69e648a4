"""A 1-D device mesh over a ``torch.distributed`` process group
(counterpart of ``poseestimator_tpu/parallel/mesh.py``).

The JAX package is single-controller: one process holds a
``jax.sharding.Mesh``, passes full arrays, and ``shard_map`` slices them.
The port keeps that contract in PyTorch's SPMD idiom: every rank calls the
same function with the same full inputs, computes its slice of the sharded
axis on its own device, and the collectives here hand every rank the full,
replicated result. A ``Mesh`` is that group seen from one rank: its
``axis`` name, ``rank``, ``size``, this rank's ``device`` and ``shape``
(``{axis: size}``, read as ``mesh.shape[axis]`` as in JAX).

Backends are the caller's choice and never switch on their own: NCCL for
CUDA tensors on one card per rank; gloo for CPU ranks, and for several
ranks sharing one card (NCCL refuses two ranks on one GPU). Measured on an
H100 with PyTorch 2.11: gloo takes CUDA tensors for each collective the
mesh uses (``all_reduce``, ``broadcast``, ``all_gather``, ``scatter``) and
moves them through host memory itself, so the mesh hands them over as
they are; the compute stays on the card.

``launch`` starts N ranks with ``torch.multiprocessing.spawn`` and a
``file://`` rendezvous (no TCP port); under ``torchrun`` the group exists
already and ``make_mesh`` takes it.
"""
from __future__ import annotations

import datetime
import os
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device

_RANK_DEVICE: Optional[torch.device] = None  # set by ``launch`` in each rank
# a launched rank's collective fails after waiting this long (a rank that
# died leaves its peers waiting otherwise)
COLLECTIVE_TIMEOUT_S = 600


class Mesh:
    """One rank's view of a 1-D mesh. ``group`` None with ``size`` 1 is a
    world of one: every collective returns its input."""

    def __init__(self, axis: str, rank: int, size: int, device: torch.device,
                 group=None, backend: Optional[str] = None):
        self.axis, self.rank, self.size = axis, rank, size
        self.device = device
        self.group, self.backend = group, backend
        self.shape = {axis: size}

    def __deepcopy__(self, memo):  # a handle: copies of a model share it
        return self

    def __repr__(self) -> str:
        return (f"Mesh(axis={self.axis!r}, rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend})")

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (all of one shape) concatenated along dim 0 in
        rank order: JAX's tiled ``all_gather``."""
        if self.size == 1:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x`` (a new tensor; no gradient)."""
        if self.size == 1:
            return x.clone()
        out = x.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def all_reduce_grad(self, x: torch.Tensor) -> torch.Tensor:
        """``all_reduce`` that autograd differentiates: the gradient of a sum
        over ranks is the sum over ranks of the gradients."""
        if self.size == 1:
            return x
        return _AllReduceSum.apply(x, self)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank (same shape and dtype)."""
        if self.size == 1:
            return x
        out = x.detach().clone().contiguous()
        dist.broadcast(out, src=self._global(0), group=self.group)
        return out

    def scatter(self, x: Optional[torch.Tensor], shape: Sequence[int],
                dtype: torch.dtype) -> torch.Tensor:
        """This rank's slice of dim 0 of rank 0's ``x`` (``shape``: the full
        shape, dim 0 divisible by the size; ``x`` may be None on the other
        ranks). The result lies on this rank's device."""
        shape = tuple(shape)
        check_divisible(shape[0], self.size)
        n = shape[0] // self.size
        if self.size == 1:
            return x.to(self.device)
        out = torch.empty((n,) + shape[1:], dtype=dtype, device=self.device)
        parts = None
        if self.rank == 0:
            parts = [p.contiguous() for p in x.to(self.device).chunk(self.size)]
        dist.scatter(out, parts, src=self._global(0), group=self.group)
        return out

    def gather_objects(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order."""
        if self.size == 1:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def slice_of(self, n: int) -> slice:
        """This rank's rows of an axis of length ``n`` (divisible)."""
        check_divisible(n, self.size)
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def _global(self, rank: int) -> int:
        return rank if self.group is None else dist.get_global_rank(self.group, rank)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g), None


def check_divisible(n: int, size: int, what: str = "axis length") -> None:
    if n % size:
        raise ValueError(f"{what} {n} is not divisible by the mesh size {size}")


def _rank_device(device) -> torch.device:
    """The device of this rank: an explicit one, the launcher's, or for a
    bare ``"cuda"`` the card of ``LOCAL_RANK`` (torchrun's)."""
    if device is None:
        device = _RANK_DEVICE if _RANK_DEVICE is not None else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    return resolve_device(dev)


def make_mesh(axis: str = "dp", n_devices: Optional[int] = None, device=None) -> Optional[Mesh]:
    """A 1-D mesh over the first ``n_devices`` ranks (default: all) of the
    initialised default group, or, where no group is initialised, a world
    of one on ``device`` (default the card). Every rank must call it (a
    subgroup is made collectively); a rank outside the first ``n_devices``
    gets None."""
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise ValueError(f"no process group is initialised: a mesh of {n_devices} "
                             "devices needs ranks (launch, or torchrun)")
        return Mesh(axis, 0, 1, _rank_device(device))
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices {n_devices} outside 1..{world} ranks")
    group = None if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return None
    backend = dist.get_backend()
    dev = _rank_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL mesh needs a CUDA device, not {dev}")
    return Mesh(axis, rank, n, dev, group, backend)


def init_from_env(device="cuda") -> bool:
    """Join the process group that ``torchrun`` describes in the environment
    (``WORLD_SIZE`` > 1 with ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) when
    none is initialised: NCCL for CUDA devices (each rank on the card of its
    ``LOCAL_RANK``), gloo for the CPU. Returns whether a group exists."""
    if dist.is_initialized():
        return True
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    dev = _rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://")
    return True


def shard_along(mesh: Mesh, x):
    """This rank's slice of dim 0 of a tensor, or of each tensor of a
    list / tuple / dict (dim 0 divisible by the mesh size), along the
    mesh's one axis."""
    if isinstance(x, dict):
        return {k: shard_along(mesh, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(shard_along(mesh, v) for v in x)
    return x[mesh.slice_of(x.shape[0])]


def replicate(mesh: Mesh, x):
    """Rank 0's copy of a tensor (or of each tensor of a list / tuple /
    dict) on every rank."""
    if isinstance(x, dict):
        return {k: replicate(mesh, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(replicate(mesh, v) for v in x)
    return mesh.broadcast(x)


def _rank_main(rank: int, fn: Callable, world: int, backend: str, device: str,
               init_file: str, args: tuple) -> None:
    global _RANK_DEVICE
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    _RANK_DEVICE = dev
    os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, nprocs: int, backend: str, device="cuda",
           init_file: Optional[str] = None, args: tuple = (), join: bool = True):
    """Run ``fn(*args)`` in ``nprocs`` new processes joined in one process
    group: ranks 0..nprocs-1 on ``backend`` ("nccl" or "gloo"), each on
    ``device`` ("cpu", "cuda:k" for every rank on card k, or "cuda" for card
    rank % count). ``fn`` must be importable (a module-level function);
    inside it ``make_mesh()`` returns the world. The rendezvous is the file
    ``init_file`` (default: a new temporary one), which must not exist yet.
    Raises when any rank fails; ``join=False`` returns at once with the
    ``torch.multiprocessing`` context, whose ``join()`` then raises so. A
    collective that waits longer than ``COLLECTIVE_TIMEOUT_S`` fails its
    rank."""
    import torch.multiprocessing as mp

    dev = torch.device(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs CUDA devices, not {device!r}")
    if dev.type == "cuda":
        resolve_device(dev)
    if init_file is None:
        init_file = os.path.join(tempfile.mkdtemp(prefix="mesh_"), "rendezvous")
    return mp.spawn(_rank_main, nprocs=nprocs, join=join,
                    args=(fn, nprocs, backend, str(device), init_file, tuple(args)))
