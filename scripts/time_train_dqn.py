"""Time the port's ``train dqn`` and count the aten ops of its vector step,
for one checkout of the port, so that two checkouts can be held side by
side on one card.

    python scripts/time_train_dqn.py [--root DIR] [--episodes 24] [--cpu]
        [--tag NAME] [--flags "--features 16 --envs 16 ..."]

``--root`` is the root of a checkout of the port (default: the one this
script is in); its ``tpu2048_torch`` is imported, nothing else. The run is
``train dqn --episodes N --seed 0`` at the CLI's defaults (full width,
bf16, 128 envs, batch 64, 100 updates an episode, 16 steps a chunk), as
``chip_smoke.py``'s phase 13 drives it; ``--flags`` adds ``train dqn``
flags (a narrow run on the CPU, say). One JSON line is printed: the
milliseconds of a vector step in each chunk (host clock between two log
rows, so the host loop between chunks is in them), the updates of each
chunk, the aten ops of one vector step without an update and of one with
one update (views included; each launches at most one kernel), and the
card's name and power limit. Compare two checkouts only within one call,
in the order A, B, B, A.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def aten_ops(fn) -> int:
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        fn()
    return count.n


def step_ops(cli, device, base):
    """The aten ops of a vector step with no update (the first, epsilon 1)
    and of one with one update (the second, at epsilon 0.5)."""
    from tpu2048_torch.training import dqn as dtrain

    parser = cli.build_parser()
    out = []
    for flags in ([], ["--epsilon", "0.5", "--updates-per-step", "1"]):
        args = parser.parse_args([*base, "--steps-per-chunk", "1",
                                  *flags])
        config = cli._dqn_config(args)
        state = dtrain.init_loop_state(config, device)
        if flags:
            dtrain.train_chunk(config, state)  # fills the buffer
        before = state.agent.train_steps
        out.append(aten_ops(lambda: dtrain.train_chunk(config, state)))
        if state.agent.train_steps - before != (1 if flags else 0):
            raise SystemExit(f"step with flags {flags}: "
                             f"{state.agent.train_steps - before} updates")
    return out


def card(torch, device) -> str:
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=HERE)
    p.add_argument("--episodes", type=int, default=24)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--tag", default=None)
    p.add_argument("--flags", default="")
    a = p.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import torch

    from tpu2048_torch.cli import main as cli
    from tpu2048_torch.metrics.logging import read_jsonl

    if not a.cpu and not torch.cuda.is_available():
        print("no CUDA device (use --cpu)", file=sys.stderr)
        return 1
    device = torch.device("cpu" if a.cpu else "cuda")
    base = [*(["--cpu"] if a.cpu else []), "train", "dqn", "--seed", "0",
            *a.flags.split()]
    envs = cli._dqn_config(cli.build_parser().parse_args(base)).num_envs
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "train.jsonl")
        rc = cli.main([*base, "--episodes", str(a.episodes), "--log", log])
        if rc:
            return rc
        rows = read_jsonl(log)
    ops = step_ops(cli, device, base)
    prev = 0
    updates = []
    for r in rows:
        updates.append(r["train_steps"] - prev)
        prev = r["train_steps"]
    print(json.dumps({
        "tag": a.tag or os.path.abspath(a.root),
        "package": os.path.dirname(os.path.abspath(cli.__file__)),
        "ms_per_vector_step": [1e3 * envs / r["steps_per_s"] for r in rows],
        "updates_per_chunk": updates,
        "episodes": rows[-1]["episodes"],
        "envs": envs,
        "aten_ops_step": ops[0],
        "aten_ops_step_with_update": ops[1],
        "card": card(torch, device),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
