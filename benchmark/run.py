"""Run one cell of the benchmark of ``tpu2048_torch`` once, on the card of
the machine it starts on, and print its result as the last line of
standard output (one JSON object).

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1> [--control 1]

``--trace 0`` measures the cell's end-to-end metrics over ``--seconds``;
``--trace 1`` profiles a bounded part of the cell's traffic and reports
its per-layer metrics and a breakdown. ``--control 1`` also runs the
control of the comparison (the reference in a lower precision in the
program's place) and prints its numbers. The numbers compared, each with
its limit, end standard error and the result line. A run exits with 2 and
prints no result where there is no card or too few, or where the port is
not in this checkout; with 3 where JAX or the JAX package was loaded.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton",
          "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels"}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # Every build and kernel cache of the run stays in the checkout.
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / sub)
        os.makedirs(os.environ[var], exist_ok=True)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import core, harness

    # One process with one intra-op thread: the host's other cores stay
    # free for the card's launches, which set most cells' pace.
    torch.set_num_threads(1)

    cell = core.Cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run: the cell needs {cell.chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import tpu2048_torch
    except ImportError as err:
        print(f"run: the port is not in this checkout: {err}",
              file=sys.stderr)
        return 2
    if Path(tpu2048_torch.__file__).resolve().parent.parent != ROOT:
        print(f"run: tpu2048_torch comes from {tpu2048_torch.__file__}, not "
              f"from this checkout", file=sys.stderr)
        return 2
    print(f"run: {args.workload} seed {args.seed} on "
          f"{torch.cuda.get_device_name(0)}", file=sys.stderr)
    try:
        line = harness.run_cell(cell, args.seed, args.seconds,
                                bool(args.trace), "cuda", _T0,
                                bool(args.control))
    except harness.ForbiddenModules as err:
        print(f"run: loaded after the window: {', '.join(err.args[0])}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for text in harness.check_lines(line):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
