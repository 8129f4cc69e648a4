"""Spans from the benchmark's own side around the program's kernel layer and
detector, recorded in the traced slice only.

Each counted op (``ops/<op>.py``) names the program functions it counts
(``TARGETS``: a module and an attribute path) and how to keep what a call
needs for its count (``capture``): tensor references and shapes, never a
value read back, so the recording adds no wait for the device. Counting runs
once the slice has closed (``count``)."""
from __future__ import annotations

import importlib
from collections import defaultdict


def _resolve(modname: str, attr: str):
    owner = importlib.import_module(modname)
    *path, last = attr.split(".")
    for p in path:
        owner = getattr(owner, p)
    return owner, last


class Recorder:
    """While entered, every call of an op's targets appends its capture to
    ``calls[op]``."""

    def __init__(self, ops: dict):
        self.ops = ops
        self.calls = defaultdict(list)
        self._saved = []

    def __enter__(self):
        for name, op in self.ops.items():
            for modname, attr in op.TARGETS:
                owner, last = _resolve(modname, attr)
                orig = getattr(owner, last)
                self._saved.append((owner, last, orig))
                setattr(owner, last, self._wrap(name, op, orig))
        return self

    def _wrap(self, name, op, orig):
        calls = self.calls[name]

        def wrapper(*args, **kwargs):
            calls.append(op.capture(*args, **kwargs))
            return orig(*args, **kwargs)

        return wrapper

    def __exit__(self, *exc):
        for owner, last, orig in reversed(self._saved):
            setattr(owner, last, orig)
        self._saved.clear()

    def counted(self) -> dict:
        """{op: [(operations, bytes), ...]} of the recorded calls."""
        return {name: [self.ops[name].count(c) for c in calls]
                for name, calls in self.calls.items()}
