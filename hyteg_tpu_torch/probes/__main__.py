"""Times the kernel-dissection ladders on the card.

    python -m hyteg_tpu_torch.probes [--shape jax|main|all]

Prints the card's name and power limit, one JSON line per rung and one
``ladder`` summary line per block. Refuses to run without CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import SHAPE_SETS, ladder, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hyteg_tpu_torch.probes",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--shape", choices=(*SHAPE_SETS, "all"), default="all",
                    help="the scripts' own shapes (jax), the port's "
                         "main-path blocks (main), or both (default)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hyteg_tpu_torch.probes: torch sees no CUDA device; the "
              "probes time the card", file=sys.stderr)
        return 1
    from ..core.benchtime import card as smi_card

    card = smi_card()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    names = SHAPE_SETS if args.shape == "all" else (args.shape,)
    for name in names:
        rows = ladder(name, device=device, card=card)
        for row in rows:
            print(json.dumps(row), flush=True)
        for line in summary(rows):
            print(json.dumps({"ladder_summary": line, "card": card}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
