"""Function registry and block functions (torch counterpart of
hyteg_tpu/functions/registry.py).

Reference: src/hyteg/functions/FEFunctionRegistry.hpp:50 (per-space
function stores queried by name / kind, used by VTK output and checkpoint
to enumerate everything attached to a storage) and
src/hyteg/functions/BlockFunction.hpp:39 (a vector of type-erased
sub-functions with joint assign / dot / enumerate: the base of the Stokes
block functions).

Here a BlockFunction is a plain class over its components (tensors or any
object with + / - / scalar *), and the registry stores (name -> kind,
object) pairs for enumeration by IO and checkpoint code. Unlike the JAX
package (ROADMAP C-ref3), ``remove`` of an unknown name raises
``KeyError``, and the per-component ``dots`` are an ordinary attribute.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

import torch


class FEFunctionRegistry:
    """Name -> (kind, function) store with by-kind queries.

    ``kind`` is a free-form space tag ("P1", "P2", "P1Vector", "P0", "DG",
    "N1E1", "EG", ...); the reference keeps one typed store per space, a
    single dict keyed by tag does the same job here."""

    def __init__(self):
        self._by_name: dict[str, tuple[str, Any]] = {}

    def add(self, name: str, kind: str, fn: Any) -> None:
        if name in self._by_name:
            raise ValueError(f"function {name!r} already registered")
        self._by_name[name] = (kind, fn)

    def remove(self, name: str) -> None:
        if name not in self._by_name:
            raise KeyError(f"function {name!r} is not registered")
        del self._by_name[name]

    def get(self, name: str) -> Any:
        return self._by_name[name][1]

    def kind(self, name: str) -> str:
        return self._by_name[name][0]

    def names(self, kind: str | None = None) -> list[str]:
        """All registered names, optionally restricted to one space kind
        (reference: getFunctionNames / forEachFunctionOfType)."""
        return [n for n, (k, _) in self._by_name.items()
                if kind is None or k == kind]

    def items(self, kind: str | None = None) -> Iterable[tuple[str, Any]]:
        for n, (k, f) in self._by_name.items():
            if kind is None or k == kind:
                yield n, f

    def __len__(self) -> int:
        return len(self._by_name)

    def __contains__(self, name: str) -> bool:
        return name in self._by_name


def _children(obj):
    """The sub-objects of a container, in the order jax.tree.leaves walks
    them (dict values by sorted key), or None for a leaf or an opaque
    object."""
    if isinstance(obj, BlockFunction):
        return list(obj.comps)
    if isinstance(obj, (tuple, list)):
        return list(obj)
    if isinstance(obj, dict):
        return [obj[k] for k in sorted(obj)]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    return None


def _is_leaf(obj) -> bool:
    return isinstance(obj, (torch.Tensor, int, float, complex))


def leaves(obj) -> list:
    """Every tensor and number inside ``obj``, depth first: the arrays
    jax.tree.leaves finds in the JAX package's pytrees (a dataclass's
    other fields, such as a function's space, are not leaves)."""
    if _is_leaf(obj):
        return [obj]
    kids = _children(obj)
    return [] if kids is None else [x for k in kids for x in leaves(k)]


def tree_map(fn: Callable, obj):
    """``obj`` with every leaf (tensor or number) replaced by
    ``fn(leaf)``."""
    if _is_leaf(obj):
        return fn(obj)
    if isinstance(obj, BlockFunction):
        return BlockFunction(tuple(tree_map(fn, c) for c in obj.comps),
                             obj.dots)
    if isinstance(obj, (tuple, list)):
        return type(obj)(tree_map(fn, c) for c in obj)
    if isinstance(obj, dict):
        return {k: tree_map(fn, v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


class BlockFunction:
    """A tuple of component functions with joint vector-space operations.

    Components may be tensors or any object supporting + / - / scalar *
    (TaylorHoodVec, a nested BlockFunction, ...). ``dots`` optionally
    carries one dot callable per component for ``dot``; without it, a flat
    elementwise dot over every tensor leaf is taken (reference:
    BlockFunction::dotGlobal, BlockFunction.hpp:225)."""

    def __init__(self, comps, dots: tuple = ()):
        self.comps = tuple(comps)
        self.dots = tuple(dots)
        if self.dots and len(self.dots) != len(self.comps):
            raise ValueError(f"{len(self.dots)} dots for "
                             f"{len(self.comps)} components")

    def __len__(self):
        return len(self.comps)

    def __getitem__(self, idx):
        return self.comps[idx]

    def __add__(self, o: "BlockFunction") -> "BlockFunction":
        return BlockFunction(
            tuple(a + b for a, b in zip(self.comps, o.comps)), self.dots)

    def __sub__(self, o: "BlockFunction") -> "BlockFunction":
        return BlockFunction(
            tuple(a - b for a, b in zip(self.comps, o.comps)), self.dots)

    def __mul__(self, s) -> "BlockFunction":
        return BlockFunction(tuple(s * c for c in self.comps), self.dots)

    __rmul__ = __mul__

    def dot(self, o: "BlockFunction") -> torch.Tensor:
        if self.dots:
            acc = None
            for d, a, b in zip(self.dots, self.comps, o.comps):
                v = torch.as_tensor(d(a, b))
                acc = v if acc is None else acc + v
            return acc
        acc = None
        for a, b in zip(leaves(self.comps), leaves(o.comps)):
            v = torch.sum(torch.as_tensor(a) * torch.as_tensor(b))
            acc = v if acc is None else acc + v
        return torch.zeros(()) if acc is None else acc

    def norm(self) -> torch.Tensor:
        return torch.sqrt(self.dot(self))

    def zeros_like(self) -> "BlockFunction":
        return tree_map(lambda t: torch.zeros_like(torch.as_tensor(t)), self)
