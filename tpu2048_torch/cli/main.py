"""Command line, the port of :mod:`tpu2048.cli.main` (``eval`` so far).

``python -m tpu2048_torch eval --policy model --params FILE.npz`` plays
greedy-DQN games on the card and prints ``EvalResult.summary()`` as JSON.
``--cpu`` runs on the CPU instead. Flag names are the JAX CLI's; the weights
come from a params ``.npz`` (:mod:`tpu2048_torch.checkpoint.params`) in
place of an Orbax checkpoint directory.
"""

from __future__ import annotations

import argparse
import json
import sys


def cmd_eval(args) -> int:
    if args.policy != "model":
        print(f"--policy {args.policy} is not yet ported", file=sys.stderr)
        return 2
    if not args.params:
        print("--params required for --policy model", file=sys.stderr)
        return 2

    from tpu2048_torch.agents.dqn import DQNConfig
    from tpu2048_torch.checkpoint.params import load_params
    from tpu2048_torch.env.env import EnvConfig
    from tpu2048_torch.env.fast import GeneratorBits
    from tpu2048_torch.eval.evaluate import evaluate, greedy_dqn_policy
    from tpu2048_torch.models.dqn import create_model, load_flax_params
    from tpu2048_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    try:
        params = load_params(args.params)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 2
    config = DQNConfig(features=args.features, hidden=args.hidden,
                       num_blocks=args.blocks, bf16=not args.no_bf16)
    model = load_flax_params(create_model(config, device), params)
    del params
    result = evaluate(
        greedy_dqn_policy(model),
        num_games=args.games,
        bits=GeneratorBits(args.seed, device),
        env_config=EnvConfig(reward="simple", auto_reset=False),
        batch_size=args.eval_batch,
    )
    print(json.dumps(result.summary(), indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu2048_torch",
        description="2048 RL framework, PyTorch/CUDA port of tpu2048",
        allow_abbrev=False,
    )
    sub = p.add_subparsers(dest="command", required=True)
    pe = sub.add_parser("eval", help="batched greedy evaluation",
                        allow_abbrev=False)
    pe.add_argument("--policy", choices=["random", "model", "tabular"],
                    default="random")
    pe.add_argument("--params", type=str, default=None,
                    help="params .npz of the Q-network (flax names)")
    pe.add_argument("--games", type=int, default=512)
    pe.add_argument("--eval-batch", type=int, default=512)
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument("--features", type=int, default=2048)
    pe.add_argument("--hidden", type=int, default=1024)
    pe.add_argument("--blocks", type=int, default=3)
    pe.add_argument("--no-bf16", action="store_true")
    pe.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    pe.set_defaults(fn=cmd_eval)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
