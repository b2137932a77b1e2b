"""Checkpoint / restore of DoF functions with level-aware restoration
(torch counterpart of hyteg_tpu/io/checkpoint.py, same file layout).

Reference: src/hyteg/checkpointrestore/ADIOS2/AdiosCheckpointExporter.hpp:
51-239 (register functions over level ranges, one-shot + continuous
timestep-series checkpoints with user attributes; importer restores per
level and can restore-then-prolongate to a finer level). Checkpoints are
compressed .npz archives keyed ``<name>/level<L>`` plus a JSON header,
byte for byte the JAX package's format, so a file written by either
package restores in the other.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


FORMAT_VERSION = 1


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class CheckpointExporter:
    def __init__(self):
        self._entries = {}  # (name, level) -> array
        self._attrs = {}

    def register(self, name: str, level: int, cells_array) -> None:
        """``cells_array``: a block as a tensor (copied to the host here)
        or a numpy array."""
        self._entries[(name, level)] = _host(cells_array)

    def add_attribute(self, key: str, value) -> None:
        self._attrs[key] = value

    def store(self, directory: str, basename: str, timestep: int | None = None):
        os.makedirs(directory, exist_ok=True)
        suffix = f"_ts{timestep}" if timestep is not None else ""
        path = os.path.join(directory, f"{basename}{suffix}.npz")
        payload = {
            f"{name}/level{level}": arr for (name, level), arr in self._entries.items()
        }
        header = dict(
            version=FORMAT_VERSION,
            attrs=self._attrs,
            entries=[
                dict(name=n, level=l, shape=list(a.shape), dtype=str(a.dtype))
                for (n, l), a in self._entries.items()
            ],
        )
        payload["__header__"] = np.frombuffer(
            json.dumps(header).encode(), dtype=np.uint8
        )
        np.savez_compressed(path, **payload)
        return path


class CheckpointImporter:
    def __init__(self, path: str):
        self._npz = np.load(path)
        self.header = json.loads(bytes(self._npz["__header__"]).decode())
        if self.header["version"] > FORMAT_VERSION:
            raise ValueError(f"{path}: checkpoint format "
                             f"{self.header['version']} is newer than "
                             f"{FORMAT_VERSION}")

    @property
    def attrs(self):
        return self.header["attrs"]

    def levels_of(self, name: str):
        return sorted(
            e["level"] for e in self.header["entries"] if e["name"] == name
        )

    def restore(self, name: str, level: int) -> np.ndarray:
        return self._npz[f"{name}/level{level}"]

    def restore_prolongated(self, name: str, stored_level: int,
                            target_level: int, transfer_factory, *,
                            device) -> torch.Tensor:
        """Restore at stored_level on ``device``, then prolongate to
        target_level using transfers from ``transfer_factory(coarse_level)``
        (e.g. the port's P1Transfer; the reference's TerraNeo
        restart-into-finer-level pattern)."""
        u = torch.as_tensor(self.restore(name, stored_level), device=device)
        for l in range(stored_level, target_level):
            u = transfer_factory(l).prolongate(u)
        return u
