"""Per-problem programs run one at a time or as a batch in lockstep (the
port's counterpart of the JAX package's ``vmap`` over the tracking step and
its ICP loop).

A program is a generator that does its own arithmetic and yields a request
wherever it needs a kernel or the host: ``NNQuery`` (K1), ``Render`` (K2) or
``Continue`` (the one host read of an early-exit loop). ``run`` serves one
program's requests with the unbatched kernels; ``run_batched`` advances B
programs together and serves each round's requests of one kind with one
batched call: one K1 launch for every live program's queries, one K2 launch
for every render, one host read for every loop flag. A program that has
finished drops out, and the others go on, as the members of a vmapped
``while_loop`` that are done keep their state.

Everything else runs per program, on that program's own tensors, with the
code of the unbatched path. So a program's result does not depend on how
many others share its batch: on the card the two batched kernels are bit
for bit their unbatched launches per problem, and no sum, matrix product or
top-k ever sees a batch axis whose size could change its order of
reduction.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .geom3d.camera import Intrinsics
from .geom3d.knn import nearest_neighbor, nearest_neighbor_batched
from .render.raster import render_depth_mesh, render_depth_mesh_batched
from .utils.profiling import host_read, span, strands


@dataclass
class NNQuery:
    """The nearest valid ``data`` point of each valid ``query`` point (K1):
    answered with ``(dist, idx, found)``."""

    query: torch.Tensor
    query_valid: torch.Tensor
    data: torch.Tensor
    data_valid: torch.Tensor

    def serve(self):
        return nearest_neighbor(self.query, self.query_valid, self.data, self.data_valid)

    @staticmethod
    def serve_batch(reqs: list["NNQuery"]) -> list:
        """One batched K1 launch for problems of equal sizes (a batch's
        clouds share the sampler's budget)."""
        fields = ("query", "query_valid", "data", "data_valid")
        d, i, f = nearest_neighbor_batched(
            *(torch.stack([getattr(r, k) for r in reqs]) for k in fields))
        return list(zip(d, i, f))


@dataclass
class Render:
    """Depth of the mesh at pose ``T`` (K2), as ``render_depth_mesh``."""

    vertices: torch.Tensor
    faces: torch.Tensor
    T: torch.Tensor
    intr: Intrinsics
    near: float
    far: float
    origin: Optional[torch.Tensor]
    out_hw: Optional[tuple]

    def serve(self):
        return render_depth_mesh(self.vertices, self.faces, self.T, self.intr, near=self.near,
                                 far=self.far, origin=self.origin, out_hw=self.out_hw)

    @staticmethod
    def serve_batch(reqs: list["Render"]) -> list:
        """One batched K2 launch. The batch shares the camera, the depth
        range and the output size; the mesh is shared or one per problem
        (padded to common sizes by the caller)."""
        r0 = reqs[0]
        for r in reqs:
            if (r.intr, r.near, r.far, r.out_hw, r.origin is None) != (
                    r0.intr, r0.near, r0.far, r0.out_hw, r0.origin is None):
                raise ValueError("a batched render shares its camera, range and window size")
        shared = all(r.vertices is r0.vertices and r.faces is r0.faces for r in reqs)
        verts = r0.vertices if shared else torch.stack([r.vertices for r in reqs])
        faces = r0.faces if shared else torch.stack([r.faces for r in reqs])
        origin = None if r0.origin is None else torch.stack([r.origin for r in reqs])
        depth = render_depth_mesh_batched(verts, faces, torch.stack([r.T for r in reqs]),
                                          r0.intr, near=r0.near, far=r0.far, origin=origin,
                                          out_hw=r0.out_hw)
        return list(depth.unbind(0))


@dataclass
class Continue:
    """Whether an early-exit loop runs another body: ``flag`` is a 0-d bool
    on the device, answered with a Python bool."""

    flag: torch.Tensor

    def serve(self):
        with host_read():
            return bool(self.flag)

    @staticmethod
    def serve_batch(reqs: list["Continue"]) -> list:
        flags = torch.stack([r.flag for r in reqs])
        with host_read():  # one host read
            return flags.tolist()


def run(program):
    """Run one program, serving each request with the unbatched kernels."""
    try:
        req = next(program)
        while True:
            req = program.send(req.serve())
    except StopIteration as stop:
        return stop.value


def run_batched(programs: list) -> list:
    """Run B programs in lockstep: each round serves the pending requests of
    one kind with one batched call. Returns their results in order.

    Traced, the run is a ``batch`` span; each resumption of a program, up
    to its next request, is charged to that program's own innermost span
    (``profiling.Strand``), and a batched call, which serves several
    programs at once, to the ``batch`` span."""
    with span("batch", len(programs)):
        ctx = strands(len(programs))
        results = [None] * len(programs)
        pending = {}
        for i, p in enumerate(programs):
            try:
                with ctx[i]:
                    pending[i] = next(p)
            except StopIteration as stop:
                results[i] = stop.value
        while pending:
            kinds: dict = {}
            for i, req in pending.items():
                kinds.setdefault(type(req), []).append(i)
            for kind, ids in kinds.items():
                answers = kind.serve_batch([pending[i] for i in ids])
                for i, a in zip(ids, answers):
                    try:
                        with ctx[i]:
                            pending[i] = programs[i].send(a)
                    except StopIteration as stop:
                        results[i] = stop.value
                        del pending[i]
        return results
