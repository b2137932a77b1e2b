"""Hierarchical wall-clock timing tree (torch counterpart of
hyteg_tpu/core/timing.py).

Reference: waLBerla WcTimingTree as threaded through the framework
(src/hyteg/primitivestorage/PrimitiveStorage.hpp:131, Operator timing wraps,
src/hyteg/dataexport/TimingOutput.hpp). Scopes nest; each node records
count/total/min/max and the tree serializes to JSON. CUDA launches return
before the card has done the work, so a scope that times device work
passes ``sync``: a device (or a tensor on it) whose stream is synchronised
before the clock stops, where the JAX package calls block_until_ready.
"""

from __future__ import annotations

import contextlib
import json
import time

import torch


class TimingNode:
    __slots__ = ("name", "count", "total", "tmin", "tmax", "children")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.tmin = float("inf")
        self.tmax = 0.0
        self.children: dict[str, "TimingNode"] = {}

    def record(self, dt: float):
        self.count += 1
        self.total += dt
        self.tmin = min(self.tmin, dt)
        self.tmax = max(self.tmax, dt)

    def to_dict(self):
        return dict(
            name=self.name, count=self.count, total_s=self.total,
            min_s=(0.0 if self.count == 0 else self.tmin), max_s=self.tmax,
            children=[c.to_dict() for c in self.children.values()],
        )


def synchronize(sync) -> None:
    """Wait for the card's stream: ``sync`` is a device, a device name or
    a tensor; a CPU one needs no wait."""
    dev = sync.device if isinstance(sync, torch.Tensor) else torch.device(sync)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class TimingTree:
    def __init__(self):
        self.root = TimingNode("root")
        self._stack = [self.root]

    @contextlib.contextmanager
    def scope(self, name: str, sync=None):
        parent = self._stack[-1]
        node = parent.children.setdefault(name, TimingNode(name))
        self._stack.append(node)
        t0 = time.perf_counter()
        try:
            yield node
        finally:
            if sync is not None:
                synchronize(sync)
            node.record(time.perf_counter() - t0)
            self._stack.pop()

    def json(self) -> str:
        return json.dumps(self.root.to_dict(), indent=1)

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.json())

    def pretty(self, node=None, indent=0) -> str:
        node = node or self.root
        lines = []
        if node.name != "root":
            lines.append(
                f"{'  ' * indent}{node.name}: n={node.count} "
                f"total={node.total:.4f}s avg={node.total / max(node.count, 1):.4f}s"
            )
            indent += 1
        for c in node.children.values():
            lines.append(self.pretty(c, indent))
        return "\n".join(lines)
