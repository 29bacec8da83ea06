"""Command line, the port of :mod:`tpu2048.cli.main` (``train tabular``,
``eval`` and ``bench`` so far).

``python -m tpu2048_torch train tabular --save q.npz`` trains the tabular
Q-learner on the card and writes its table; ``python -m tpu2048_torch eval
--policy tabular --table q.npz`` or ``--policy model --params FILE.npz``
plays greedy games, ``--policy random`` (the default) random-legal ones on
the rollout kernel, and prints ``EvalResult.summary()`` as JSON; ``python -m
tpu2048_torch bench [--tabular]`` prints one JSON line of throughput
(:mod:`tpu2048_torch.bench`). ``--cpu`` runs on the CPU instead. Flag
names and defaults are the JAX CLI's; the DQN's weights come from a params
``.npz`` (:mod:`tpu2048_torch.checkpoint.params`) in place of an Orbax
checkpoint directory. Flags of parts not yet ported exit with code 2.
"""

from __future__ import annotations

import argparse
import json
import sys


def _not_ported(what: str) -> int:
    print(f"{what} is not yet ported", file=sys.stderr)
    return 2


def cmd_train(args) -> int:
    if args.engine == "lax":
        return _not_ported("--engine lax")
    if args.table_backend != "auto":
        return _not_ported(f"--table-backend {args.table_backend}")
    if args.plot_every:
        return _not_ported("--plot-every")
    if args.watchdog:
        return _not_ported("--watchdog")

    from tpu2048_torch.agents.tabular import TabularConfig
    from tpu2048_torch.env.env import EnvConfig
    from tpu2048_torch.metrics.logging import JSONLLogger
    from tpu2048_torch.training.tabular import TabularTrainConfig, train
    from tpu2048_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    config = TabularTrainConfig(
        agent=TabularConfig(
            learning_rate=args.alpha,
            discount=args.gamma,
            exploration_rate=args.epsilon,
            exploration_min=args.epsilon_min,
            total_epochs=max(args.episodes // args.batch, 1),
            capacity_log2=args.capacity_log2,
        ),
        env=EnvConfig(reward=args.reward),
        batch_size=args.batch,
        total_episodes=args.episodes,
        steps_per_chunk=args.steps_per_chunk,
        engine=args.engine,
        seed=args.seed,
    )
    logger = JSONLLogger(args.log)
    try:
        train(config, device, log_fn=logger.log, save_path=args.save)
    finally:
        logger.close()
    return 0


def _model_policy(args, device):
    from tpu2048_torch.agents.dqn import DQNConfig
    from tpu2048_torch.checkpoint.params import load_params
    from tpu2048_torch.eval.evaluate import greedy_dqn_policy
    from tpu2048_torch.models.dqn import create_model, load_flax_params

    params = load_params(args.params)
    config = DQNConfig(features=args.features, hidden=args.hidden,
                       num_blocks=args.blocks, bf16=not args.no_bf16)
    return greedy_dqn_policy(
        load_flax_params(create_model(config, device), params))


def _tabular_policy(args, device):
    from tpu2048_torch.agents.tabular import load_qtable
    from tpu2048_torch.eval.evaluate import greedy_tabular_policy

    return greedy_tabular_policy(load_qtable(args.table, device))


def cmd_eval(args) -> int:
    if args.policy == "model" and not args.params:
        print("--params required for --policy model", file=sys.stderr)
        return 2
    if args.policy == "tabular" and not args.table:
        print("--table required for --policy tabular", file=sys.stderr)
        return 2

    from tpu2048_torch.env.env import EnvConfig
    from tpu2048_torch.env.fast import GeneratorBits, PhiloxBits
    from tpu2048_torch.eval.evaluate import evaluate, random_legal_policy
    from tpu2048_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    if args.policy == "random":
        # The rollout kernel draws the random policy's bits in-kernel.
        policy, bits = random_legal_policy(), PhiloxBits(args.seed, device)
    else:
        make = _model_policy if args.policy == "model" else _tabular_policy
        try:
            policy = make(args, device)
        except FileNotFoundError as e:
            print(e, file=sys.stderr)
            return 2
        bits = GeneratorBits(args.seed, device)
    result = evaluate(
        policy,
        num_games=args.games,
        bits=bits,
        env_config=EnvConfig(reward=args.reward, auto_reset=False),
        batch_size=args.eval_batch,
    )
    print(json.dumps(result.summary(), indent=2))
    return 0


def cmd_bench(args) -> int:
    for flag, on in (("--learner", args.learner),
                     ("--train-loop", args.train_loop),
                     ("--scale", args.scale)):
        if on:
            return _not_ported(flag)
    from tpu2048_torch import bench

    device = "cpu" if args.cpu else None
    if args.tabular:
        bench.tabular_main(batch=args.batch or 4096, device=device)
    else:
        bench.main(batch=args.batch or 65536, steps=args.steps,
                   device=device)
    return 0


def _add_tabular_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--episodes", type=int, default=200_000,
                   help="total training episodes (reference: 200k games)")
    p.add_argument("--alpha", type=float, default=0.1, help="learning rate")
    p.add_argument("--gamma", type=float, default=0.9, help="discount factor")
    p.add_argument("--epsilon", type=float, default=1.0,
                   help="initial exploration rate")
    p.add_argument("--epsilon-min", type=float, default=0.01)
    p.add_argument("--batch", type=int, default=1024, help="parallel envs")
    p.add_argument("--capacity-log2", type=int, default=25,
                   help="Q-table slots = 2**N")
    p.add_argument("--reward", choices=["shaped", "simple"], default="shaped")
    p.add_argument("--engine", choices=["auto", "fast", "lax"], default="auto",
                   help="actor engine: fast = the env-step kernel; lax is "
                        "not yet ported")
    p.add_argument("--table-backend",
                   choices=["auto", "pallas", "interpret", "xla", "legacy"],
                   default="auto",
                   help="only auto (the packed table on its kernels) is "
                        "ported")
    p.add_argument("--steps-per-chunk", type=int, default=256)
    p.add_argument("--plot-every", type=int, default=0,
                   help="not yet ported")
    p.add_argument("--save", type=str, default=None,
                   help="write the trained Q-table as .npz")
    p.add_argument("--log", type=str, default=None, help="JSONL metrics path")
    p.add_argument("--watchdog", type=float, default=0.0,
                   help="not yet ported")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu2048_torch",
        description="2048 RL framework, PyTorch/CUDA port of tpu2048",
        allow_abbrev=False,
    )
    sub = p.add_subparsers(dest="command", required=True)

    pt = sub.add_parser("train", help="train an agent", allow_abbrev=False)
    st = pt.add_subparsers(dest="algo", required=True)
    ptab = st.add_parser("tabular", help="tabular Q-learning (QLearningBase)",
                         allow_abbrev=False)
    _add_tabular_args(ptab)
    ptab.set_defaults(fn=cmd_train)

    pe = sub.add_parser("eval", help="batched greedy evaluation",
                        allow_abbrev=False)
    pe.add_argument("--policy", choices=["random", "model", "tabular"],
                    default="random")
    pe.add_argument("--params", type=str, default=None,
                    help="params .npz of the Q-network (flax names)")
    pe.add_argument("--table", type=str, default=None,
                    help="Q-table .npz for --policy tabular")
    pe.add_argument("--games", type=int, default=512)
    pe.add_argument("--eval-batch", type=int, default=512)
    pe.add_argument("--reward", choices=["simple", "shaped"],
                    default="simple",
                    help="env regime to evaluate under: simple "
                         "(Deep_QLearning) or shaped (QLearningBase)")
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument("--features", type=int, default=2048)
    pe.add_argument("--hidden", type=int, default=1024)
    pe.add_argument("--blocks", type=int, default=3)
    pe.add_argument("--no-bf16", action="store_true")
    pe.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    pe.set_defaults(fn=cmd_eval)

    pb = sub.add_parser("bench", help="throughput benchmarks",
                        allow_abbrev=False)
    pb.add_argument("--batch", type=int, default=None,
                    help="parallel envs (default 65536; 4096 with "
                         "--tabular)")
    pb.add_argument("--steps", type=int, default=256,
                    help="env steps of the timed run (16 a launch)")
    pb.add_argument("--tabular", action="store_true",
                    help="benchmark the tabular training chunk's env "
                         "steps/s (shaped env + hashed Q-table)")
    pb.add_argument("--learner", action="store_true", help="not yet ported")
    pb.add_argument("--train-loop", action="store_true",
                    help="not yet ported")
    pb.add_argument("--scale", type=str, default=None, help="not yet ported")
    pb.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    pb.set_defaults(fn=cmd_bench)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
