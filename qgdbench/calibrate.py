"""The two readings each limit of the comparison is set from, at a cell's
own sizes, in one process on the GPU:

    python3 qgdbench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        [--control-seeds 11,12] [--control-solve lu|inverse] [--out FILE]

Each seed is one run of :func:`qgdbench.harness.run_cell` with a window
of one call, judged by the harness's own comparison: for ``--seeds`` the
program (the lower reading), for ``--control-seeds`` the control, the
reference in TF32 put in the program's place (the upper reading). The
program is built once and kept over the seeds, as its captured step
programs are. One JSON line per run (appended to FILE too): the cell,
the seed, the side, ``correct`` and each number compared.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


class Control:
    """The reference computed in TF32 (``solve`` as
    :class:`qgdbench.reference.hermite.Reference` takes it), in the
    program's place: every control vector of every call."""

    def __init__(self, config, traffic, inputs, device, solve="lu"):
        from qgdbench.reference.hermite import Reference

        self.ref = Reference(inputs, int(config["order"]), traffic["nsteps"],
                             config["ridge"], device, precision="tf32",
                             solve=solve)

    def call(self, pcof):
        import torch

        return {k: torch.as_tensor(v, device=pcof.device)
                for k, v in self.ref.evaluate(pcof).items()}

    def stats(self):
        return {}


def _built_once(factory):
    """``factory``, building its object at the first call only."""
    built = []

    def make(*args):
        if not built:
            built.append(factory(*args))
        return built[0]

    return make


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control-solve", default="lu",
                    choices=("lu", "inverse"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != here]
    import torch

    from qgdbench import harness
    from qgdbench.program import Program

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = harness.load_cell(ROOT, args.workload)
    seeds = lambda text: [int(s) for s in text.split(",") if s]
    sides = [("program", _built_once(Program), seeds(args.seeds)),
             (f"control_{args.control_solve}",
              _built_once(lambda *a: Control(*a, solve=args.control_solve)),
              seeds(args.control_seeds))]
    for side, factory, side_seeds in sides:
        for seed in side_seeds:
            t0 = time.perf_counter()
            result, checks = harness.run_cell(spec, seed, 0, False, device,
                                              t0, program_factory=factory)
            text = json.dumps({
                "cell": args.workload, "seed": seed, "side": side,
                "correct": result["correct"], "failed": result["failed"],
                "seconds": time.perf_counter() - t0,
                "checks": {k: c["value"] for k, c in checks.items()}})
            print(text, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
