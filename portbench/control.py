"""The control of a cell's check: the plain reference put in the
program's place, one precision down from what the configuration states,
and judged by the same comparisons as a run. It has to come out not
correct. The cell's driver (``drivers/<driver>.py``, named by its mix)
says what the control computes: its ``control(config, mix, seed,
window_steps, device)``.

    python3 portbench/control.py --workload <name> --seed <n> --steps <k>

``--steps`` is the number of window steps to stand in for (a run's own
count at the cell's load). Prints one JSON line of the compared numbers
beside their limits. Runs the reference on the card when there is one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_numbers(root, name: str, seed: int, window_steps: int,
                    device: str, config=None, mix=None):
    """The numbers the check compares, with the control's outputs as the
    program's, each beside its limit."""
    from portbench.lib.manifest import Manifest

    man = Manifest(root)
    cell = man.cell(name)
    config = config or man.config(cell)
    mix = mix or man.traffic(cell)
    limits = man.limits(cell)
    numbers = man.driver(mix).control(config, mix, seed, window_steps,
                                      device)
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    nums = control_numbers(ROOT, args.workload, args.seed, args.steps, device)
    correct = all(c["value"] <= c["limit"] for c in nums.values())
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "steps": args.steps, "correct": correct,
                      "checks": nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
