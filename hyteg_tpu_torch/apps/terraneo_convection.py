"""Mantle-convection app (torch counterpart of
apps/terraneo_convection.py; reference: apps/TerraNeo/Origin/Convection.cpp
startSimulation loop + parameters.prm): reads a JSON/TOML config, runs the
coupled Stokes + energy time loop, writes per-step metrics, radial
profiles, continuous checkpoints, a timing-tree JSON and, every
``--vtk-every`` steps, a VTU snapshot of the temperature.

Usage:  python -m hyteg_tpu_torch.apps.terraneo_convection [config.json]
            [--steps N] [--out DIR] [--vtk-every K] [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given. The snapshot
``<out>/convection_ts<step>.vtu`` holds T on its P2 node grid (level + 1):
the JAX package's app writes it at the P2 level, which does not fit that
grid, and adds T again at every snapshot (ROADMAP C-ref20).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from ..core.config import load_config
from ..terraneo import ConvectionParameters, ConvectionSimulation


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("config", nargs="?", default=None)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default="output/terraneo")
    ap.add_argument("--vtk-every", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: torch sees no CUDA device "
                 "(pass --device cpu to run on the CPU)")

    params = ConvectionParameters()
    if args.config:
        cfg = load_config(args.config).as_dict()
        fields = {f.name for f in dataclasses.fields(ConvectionParameters)}
        params = ConvectionParameters(
            **{k: v for k, v in cfg.items() if k in fields})
    os.makedirs(args.out, exist_ok=True)
    if params.checkpoint_every and not params.checkpoint_dir:
        params.checkpoint_dir = args.out

    sim = ConvectionSimulation(params, device=device)
    print(f"domain: dim={sim.dim} rmin={params.rmin} rmax={params.rmax} "
          f"level={params.level} T-dofs={sim.T_space.num_global_dofs()} "
          f"device={device}")

    rows = []
    for k in range(args.steps):
        dt = sim.step()
        prof = sim.temperature_profile()
        vrms = float(np.sqrt(max(
            0.0,
            sum(float(sim.T_space.dot(v, v)) for v in sim.x.vel)
            / sim.T_space.num_global_dofs(),
        )))
        rows.append(dict(step=sim.step_count, time=sim.time, dt=dt,
                         vrms=vrms, t_mean=float(prof.mean.mean())))
        print(f"step {sim.step_count:4d}  t={sim.time:.5f}  dt={dt:.2e}  "
              f"vrms={vrms:.4f}  <T>={rows[-1]['t_mean']:.4f}")
        if args.vtk_every and (k + 1) % args.vtk_every == 0:
            from ..io.vtk import VTKOutput

            vtk = VTKOutput(args.out, "convection", sim.storage)
            vtk.add("T", sim.T_space, sim.T)
            path = vtk.write(sim.T_space.node_space.level,
                             timestep=sim.step_count)
            print("wrote", path)

    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(rows, f, indent=1)
    sim.timing.save(os.path.join(args.out, "timing.json"))
    prof = sim.temperature_profile()
    np.savetxt(os.path.join(args.out, "radial_profile.txt"),
               np.stack([prof.radii, prof.mean, prof.vmin, prof.vmax], 1),
               header="r mean min max")
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
