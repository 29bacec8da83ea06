"""Command line, the port of :mod:`tpu2048.cli.main` (``train tabular``,
``train dqn``, ``eval``, ``demo``, ``gui``, ``bench``, ``plot`` and
``analyze``).

``python -m tpu2048_torch train tabular --save q.npz`` trains the tabular
Q-learner on the card and writes its table; ``python -m tpu2048_torch train
dqn --checkpoint-dir DIR`` trains the DQN and checkpoints its whole loop
state there (``--resume`` continues it). ``python -m tpu2048_torch eval
--policy tabular --table q.npz``, ``--policy model --checkpoint-dir DIR
[--step N | --named NAME]`` or ``--policy model --params FILE.npz`` plays
greedy games, ``--policy random`` (the default) random-legal ones on the
rollout kernel, and prints ``EvalResult.summary()`` as JSON; ``--engine
lax`` plays (and trains) on the classic env instead of the env kernels.
``python -m tpu2048_torch demo --mode manual|random|model`` plays one game
in the terminal and ``gui`` in a Tk window, each printing its stats as
JSON. ``python -m tpu2048_torch bench [--tabular | --learner |
--train-loop]`` prints one JSON line of throughput
(:mod:`tpu2048_torch.bench`), ``bench --scale 1,2,...`` one a rank count.
``train dqn --replay-shards S`` shards the run's envs and replay in one
process; ``--data-parallel D --model-parallel M`` runs a ``(D, M)`` grid of
D x M ranks of a process group (:mod:`tpu2048_torch.parallel`; M > 1
slices the networks over each data row's M ranks), spawned here or, with
``--coordinator``, ``--num-processes`` and ``--process-id``, one a
process. ``plot --log m.jsonl --out m.png`` draws the training plot and
``analyze --log m.jsonl`` prints the run's milestones. ``--cpu``, before or
after the subcommand, runs on the CPU instead. Flag names and defaults are
the JAX CLI's; checkpoints are the port's own torch files
(:mod:`tpu2048_torch.checkpoint.ckpt`), which resume at any ``--data-parallel``
and ``--model-parallel``, and a params ``.npz``
(:mod:`tpu2048_torch.checkpoint.params`) carries weights from the JAX
package.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib.util
import json
import os
import sys


def _no_matplotlib(what: str) -> int:
    """Exit code 2 with a message naming the package when matplotlib is
    absent, else 0: checked before any training starts."""
    if importlib.util.find_spec("matplotlib") is not None:
        return 0
    print(f"{what} needs the matplotlib package, which is not installed",
          file=sys.stderr)
    return 2


def _plot_every(args, log_fn):
    """``log_fn`` extended, under ``--plot-every N``, to redraw
    ``<log>.png`` from the whole JSONL file (a resumed run's history
    included) each time N more episodes have ended. Without ``--log`` the
    flag is ignored with a warning, as the JAX CLI does."""
    if not args.plot_every:
        return log_fn
    if not args.log:
        print("--plot-every requires --log (plots render from the JSONL "
              "rows); ignoring", file=sys.stderr)
        return log_fn
    from tpu2048_torch.metrics.logging import plot_from_jsonl

    out_png = os.path.splitext(args.log)[0] + ".png"
    last_plot = [0]

    def plotting_log_fn(row):
        log_fn(row)
        if row.get("episodes", 0) >= last_plot[0] + args.plot_every:
            last_plot[0] = row["episodes"]
            plot_from_jsonl(args.log, out_png)

    return plotting_log_fn


def _plot_refusal(args) -> int:
    """Exit 2 when ``--plot-every`` would draw and matplotlib is absent."""
    if args.plot_every and args.log:
        return _no_matplotlib("--plot-every")
    return 0


def _save_run_config(args, directory: str) -> None:
    """Persist the model- and env-shaping flags next to the checkpoints, so
    that eval and a resume rebuild the same state without repeating them.
    The file is written beside its place and renamed into it: the other
    ranks of a resumed group read it meanwhile."""
    keys = [
        "gamma", "epsilon", "epsilon_min", "epsilon_decay", "batch", "envs",
        "updates_per_step", "updates_per_episode", "max_updates_per_step",
        "memory_size", "per_alpha", "no_dedup",
        "no_terminal_bonus", "features", "hidden", "blocks", "no_bf16",
        "steps_per_chunk", "replay_shards", "alpha", "engine", "seed",
    ]
    payload = {k: getattr(args, k) for k in keys if hasattr(args, k)}
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "config.json")
    with open(path + ".tmp", "w") as fh:
        json.dump(payload, fh, indent=2)
    os.replace(path + ".tmp", path)


def _user_specified(args, dest: str) -> bool:
    """True if the flag for ``dest`` appeared on the command line (as
    ``--flag`` or ``--flag=value``) in the argv the parser consumed."""
    flag = "--" + dest.replace("_", "-")
    return any(a == flag or a.startswith(flag + "=") for a in args._argv)


def _load_run_config(args, directory: str):
    """Overlay a saved config.json (if present) onto the CLI args; flags
    the user passed explicitly win over the saved config."""
    path = os.path.join(directory, "config.json")
    if not os.path.isfile(path):
        return args
    with open(path) as fh:
        payload = json.load(fh)
    for k, v in payload.items():
        if not _user_specified(args, k):
            setattr(args, k, v)
    return args


def _restore_config(args, directory: str):
    """The train config of a run restored from ``directory``: the saved
    loop state's env state (classic or fast) follows the engine in the
    run's config.json, whatever this invocation's ``--engine``. A
    config.json without an ``engine`` key means lax: such runs stepped the
    classic env (the JAX CLI's rule)."""
    cfg = _dqn_config(args)
    path = os.path.join(directory, "config.json")
    if os.path.isfile(path):
        with open(path) as fh:
            saved = json.load(fh).get("engine", "lax")
        if saved and saved != cfg.engine:
            cfg = dataclasses.replace(cfg, engine=saved)
    return cfg


def cmd_train(args) -> int:
    rc = _plot_refusal(args)
    if rc:
        return rc

    from tpu2048_torch.agents.tabular import TabularConfig
    from tpu2048_torch.env.env import EnvConfig
    from tpu2048_torch.metrics.logging import JSONLLogger
    from tpu2048_torch.training.tabular import (TabularTrainConfig,
                                                resolve_table_backend, train)
    from tpu2048_torch.utils.device import resolve_device

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
        table_backend=args.table_backend,
        watchdog_timeout=args.watchdog,
        seed=args.seed,
    )
    try:
        resolve_table_backend(config)
    except ValueError as e:  # xla and interpret: JAX's backends
        print(f"--table-backend: {e}", file=sys.stderr)
        return 2
    device = resolve_device("cpu" if args.cpu else None)
    logger = JSONLLogger(args.log)
    try:
        train(config, device, log_fn=_plot_every(args, logger.log),
              save_path=args.save)
    finally:
        logger.close()
    return 0


def _dqn_refusal(args) -> int:
    """Exit 2 for what cannot run: a process group whose flags disagree,
    replay shards that do not follow the data-parallel ranks; and
    ``--plot-every`` without matplotlib. ``--replay-shards`` 1 is raised to
    ``--data-parallel`` (one shard a data row), as the JAX CLI does, before
    anything is saved."""
    dp = args.data_parallel
    if args.coordinator:
        if args.num_processes is None or args.process_id is None:
            print("--coordinator needs --num-processes and --process-id",
                  file=sys.stderr)
            return 2
        if dp * args.model_parallel != args.num_processes:
            print(f"--data-parallel {dp} x --model-parallel "
                  f"{args.model_parallel} must equal --num-processes "
                  f"{args.num_processes} (one rank a process)",
                  file=sys.stderr)
            return 2
    elif args.num_processes is not None or args.process_id is not None:
        print("--num-processes and --process-id need --coordinator",
              file=sys.stderr)
        return 2
    if dp > 1 and args.replay_shards % dp:
        if args.replay_shards != 1:
            print(f"--replay-shards {args.replay_shards} must be a multiple "
                  f"of --data-parallel {dp}", file=sys.stderr)
            return 2
        # One replay shard a rank keeps transitions on their rank.
        args.replay_shards = dp
    return _plot_refusal(args)


def _dqn_config(args):
    from tpu2048_torch.agents.dqn import DQNConfig
    from tpu2048_torch.env.env import SIMPLE, EnvConfig
    from tpu2048_torch.training.dqn import DQNTrainConfig

    return DQNTrainConfig(
        agent=DQNConfig(
            gamma=args.gamma,
            epsilon=args.epsilon,
            epsilon_min=args.epsilon_min,
            epsilon_decay=args.epsilon_decay,
            batch_size=args.batch,
            memory_size=args.memory_size,
            alpha=args.per_alpha,
            learning_rate=args.alpha,
            dedup=not args.no_dedup,
            features=args.features,
            hidden=args.hidden,
            num_blocks=args.blocks,
            bf16=not args.no_bf16,
        ),
        env=EnvConfig(reward=SIMPLE,
                      terminal_bonus=not args.no_terminal_bonus),
        num_envs=args.envs,
        engine=args.engine,
        updates_per_step=args.updates_per_step,
        updates_per_episode=args.updates_per_episode,
        max_updates_per_step=args.max_updates_per_step,
        train_batch=args.batch,
        steps_per_chunk=args.steps_per_chunk,
        replay_shards=args.replay_shards,
        model_parallel=args.model_parallel,
        checkpoint_episodes=args.checkpoint_every,
        rollback=args.rollback,
        rollback_store=args.rollback_store,
        rollback_block=args.rollback_block,
        rollback_drop=args.rollback_drop,
        prune_on_resume=args.prune_on_resume,
        trace_env0=bool(args.debug_csv),
        watchdog_timeout=args.watchdog,
        stop_at_tile=args.stop_at_tile,
        seed=args.seed,
    )


def cmd_train_dqn(args) -> int:
    rc = _dqn_refusal(args)
    if rc:
        return rc
    from tpu2048_torch.parallel import mesh
    from tpu2048_torch.parallel.testkit import spawn_ranks

    if args.resume and args.checkpoint_dir:
        # A resumed run keeps the shapes and the engine it was started
        # with.
        args = _load_run_config(args, args.checkpoint_dir)
        args.engine = _restore_config(args, args.checkpoint_dir).engine
    primary = not args.coordinator or args.process_id == 0
    if args.checkpoint_dir and primary:
        _save_run_config(args, args.checkpoint_dir)
    device = "cpu" if args.cpu else None
    if args.coordinator:
        # This process is one rank; logging waits for the group (rank 0
        # alone writes).
        mesh.distributed_init(args.coordinator, args.num_processes,
                              args.process_id, device=device)
        try:
            return _train_dqn_rank(args)
        finally:
            mesh.destroy()
    ranks = args.data_parallel * args.model_parallel
    if ranks > 1:
        if not args.cpu and _cards() < ranks:
            print(f"--data-parallel {args.data_parallel} x --model-parallel "
                  f"{args.model_parallel} needs one card a rank; this "
                  f"machine has {_cards()} (gloo ranks: --cpu)",
                  file=sys.stderr)
            return 2
        return max(spawn_ranks(ranks, functools.partial(
            _train_dqn_rank, args), device=device))
    return _train_dqn_rank(args)


def _cards() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _train_dqn_rank(args) -> int:
    """``train dqn`` on this process: the single process, or one rank of a
    process group (its device is the group's)."""
    from tpu2048_torch.checkpoint.ckpt import CheckpointManager
    from tpu2048_torch.metrics.logging import CSVLogger, JSONLLogger
    from tpu2048_torch.parallel import mesh
    from tpu2048_torch.training.dqn import (init_loop_state, train,
                                            warm_start_state)

    device = mesh.local_device("cpu" if args.cpu else None)
    mgr = CheckpointManager(args.checkpoint_dir) if args.checkpoint_dir \
        else None
    config = _dqn_config(args)
    state = None
    # A run that resumes from its own checkpoints carries its lineage in
    # them: the warm start is skipped then.
    own = args.resume and mgr is not None and mgr.latest_step() is not None
    if args.warm_start and not own:
        state = init_loop_state(config, device)
        try:
            warm_start_state(state, args.warm_start,
                             named=args.warm_start_named,
                             step=args.warm_start_step)
        except FileNotFoundError as e:
            # A missing source never fixes itself: exit 2, the code a
            # supervisor treats as permanent.
            print(f"error: --warm-start: {e}", file=sys.stderr)
            return 2
    logger = JSONLLogger(args.log)
    trace_logger = None
    if args.debug_csv:
        # The reference driver's header (mainDQL:137).
        trace_logger = CSVLogger(
            args.debug_csv,
            ["Episode", "Action", "Legal Moves", "Reward", "Total Reward",
             "State", "Done", "Ho salvato", "Mosse"])
    try:
        train(config, args.episodes, device,
              log_fn=_plot_every(args, logger.log) if logger.enabled
              else logger.log, state=state,
              ckpt_manager=mgr, resume=args.resume,
              trace_fn=trace_logger.log if trace_logger else None)
    finally:
        logger.close()
        if trace_logger:
            trace_logger.close()
    return 0


def _model_policy(args, device):
    from tpu2048_torch.agents.dqn import DQNConfig
    from tpu2048_torch.checkpoint.ckpt import restore_params_only
    from tpu2048_torch.checkpoint.params import load_params
    from tpu2048_torch.eval.evaluate import greedy_dqn_policy
    from tpu2048_torch.models.dqn import create_model, load_flax_params

    if args.checkpoint_dir:
        args = _load_run_config(args, args.checkpoint_dir)
    config = DQNConfig(features=args.features, hidden=args.hidden,
                       num_blocks=args.blocks, bf16=not args.no_bf16)
    if not args.checkpoint_dir:
        return greedy_dqn_policy(load_flax_params(
            create_model(config, device), load_params(args.params)))
    _, model = restore_params_only(args.checkpoint_dir, args.step, config,
                                   named=args.named, device=device)
    if model is None:
        raise FileNotFoundError(
            f"no checkpoint found in {args.checkpoint_dir}")
    return greedy_dqn_policy(model)


def _tabular_policy(args, device):
    from tpu2048_torch.agents.tabular import load_qtable
    from tpu2048_torch.eval.evaluate import greedy_tabular_policy

    return greedy_tabular_policy(load_qtable(args.table, device))


def cmd_eval(args) -> int:
    if args.policy == "model" and not (args.params or args.checkpoint_dir):
        print("--checkpoint-dir or --params required for --policy model",
              file=sys.stderr)
        return 2
    if args.policy == "tabular" and not args.table:
        print("--table required for --policy tabular", file=sys.stderr)
        return 2

    from tpu2048_torch.env.env import EnvConfig, GeneratorSpawns
    from tpu2048_torch.env.fast import (GeneratorBits, PhiloxBits,
                                        resolve_engine)
    from tpu2048_torch.eval.evaluate import evaluate, random_legal_policy
    from tpu2048_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    if args.policy != "random":
        make = _model_policy if args.policy == "model" else _tabular_policy
        try:
            # A --checkpoint-dir's config.json gives the engine too, unless
            # --engine is given.
            policy = make(args, device)
        except FileNotFoundError as e:
            print(e, file=sys.stderr)
            return 2
    env_config = EnvConfig(reward=args.reward, auto_reset=False)
    engine = resolve_engine(env_config, args.engine, require_auto_reset=False)
    if engine == "lax":
        # The classic env's spawns; the random policy draws per step from
        # the same generator.
        bits = GeneratorSpawns(args.seed, device)
        if args.policy == "random":
            policy = random_legal_policy(bits.generator)
    elif args.policy == "random":
        # The rollout kernel draws the random policy's bits in-kernel.
        policy, bits = random_legal_policy(), PhiloxBits(args.seed, device)
    else:
        bits = GeneratorBits(args.seed, device)
    result = evaluate(
        policy,
        num_games=args.games,
        bits=bits,
        env_config=env_config,
        batch_size=args.eval_batch,
        engine=engine,
    )
    print(json.dumps(result.summary(), indent=2))
    return 0


def _demo_policy(args, device):
    """The greedy policy of demo and gui model mode (a Q-table with
    ``--table``, else a DQN as ``eval --policy model`` loads it); None in
    the other modes."""
    if args.mode != "model":
        return None
    if args.table:
        return _tabular_policy(args, device)
    return _model_policy(args, device)


def _play(args, run) -> int:
    if args.mode == "model" and not (args.table or args.checkpoint_dir
                                     or args.params):
        print("--mode model requires --checkpoint-dir or --params (a "
              "trained DQN) or --table (a trained tabular Q-table)",
              file=sys.stderr)
        return 2
    from tpu2048_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    try:
        policy = _demo_policy(args, device)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 2
    print(json.dumps(run(args, policy, device)))
    return 0


def cmd_demo(args) -> int:
    from tpu2048_torch.eval.demo import play

    return _play(args, lambda a, policy, device: play(
        mode=a.mode, policy=policy, delay=a.delay, seed=a.seed,
        device=device))


def cmd_gui(args) -> int:
    from tpu2048_torch.eval.gui import run_gui

    return _play(args, lambda a, policy, device: run_gui(
        mode=a.mode, policy=policy, delay_ms=int(a.delay * 1000),
        seed=a.seed, device=device))


def cmd_plot(args) -> int:
    rc = _no_matplotlib("plot")
    if rc:
        return rc
    from tpu2048_torch.metrics.logging import plot_from_jsonl

    plot_from_jsonl(args.log, args.out)
    print(f"wrote {args.out}")
    return 0


def cmd_analyze(args) -> int:
    from tpu2048_torch.metrics.analyze import main as analyze_main

    analyze_main(args.log)
    return 0


def cmd_bench(args) -> int:
    from tpu2048_torch import bench

    device = "cpu" if args.cpu else None
    if args.scale:
        counts = [int(x) for x in args.scale.split(",")]
        if not args.cpu and max(counts) > _cards():
            print(f"--scale {args.scale} needs one card a rank; this "
                  f"machine has {_cards()} (gloo ranks: --cpu)",
                  file=sys.stderr)
            return 2
        bench.scale_main(counts, device=device)
    elif args.learner:
        bench.learner_main(batch=args.train_batch, updates=args.updates,
                           device=device)
    elif args.train_loop:
        bench.train_loop_main(envs=args.envs, device=device)
    elif args.tabular:
        from tpu2048_torch.training.tabular import (TabularTrainConfig,
                                                    resolve_table_backend)

        try:
            resolve_table_backend(
                TabularTrainConfig(table_backend=args.table_backend))
        except ValueError as e:  # xla and interpret: JAX's backends
            print(f"--table-backend: {e}", file=sys.stderr)
            return 2
        bench.tabular_main(batch=args.batch or 4096, device=device,
                           table_backend=args.table_backend)
    elif args.rollout_k < 1 or args.steps % args.rollout_k:
        print(f"--steps {args.steps} is not a whole number of "
              f"--rollout-k {args.rollout_k} windows", file=sys.stderr)
        return 2
    else:
        bench.main(batch=args.batch or 65536, steps=args.steps,
                   rollout_k=args.rollout_k, device=device)
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
                   help="actor engine: fast = the env-step kernel, lax = "
                        "the classic op-by-op env; auto picks fast "
                        "whenever the env semantics allow")
    p.add_argument("--table-backend",
                   choices=["auto", "pallas", "interpret", "xla", "legacy"],
                   default="auto",
                   help="Q-table backend: the packed table on its bucket "
                        "kernels (auto, or its alias pallas) or the "
                        "two-array table (legacy); xla and interpret name "
                        "JAX backends and exit 2")
    p.add_argument("--steps-per-chunk", type=int, default=256)
    p.add_argument("--plot-every", type=int, default=0,
                   help="redraw the 3-panel training plot <log>.png every "
                        "N episodes (reference: 10, mainDQL:270; needs "
                        "--log; 0 = off)")
    p.add_argument("--save", type=str, default=None,
                   help="write the trained Q-table as .npz")
    p.add_argument("--log", type=str, default=None, help="JSONL metrics path")
    p.add_argument("--watchdog", type=float, default=0.0,
                   help="exit 70 if no training chunk completes within N "
                        "seconds (a hang becomes a restartable crash; "
                        "0 = off)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")


def _add_dqn_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--episodes", type=int, default=2000)
    p.add_argument("--alpha", type=float, default=5e-5,
                   help="learning rate (Adam)")
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--epsilon", type=float, default=0.9)
    p.add_argument("--epsilon-min", type=float, default=0.001)
    p.add_argument("--epsilon-decay", type=float, default=0.9999)
    p.add_argument("--batch", type=int, default=64,
                   help="learner batch size (reference: 64)")
    p.add_argument("--envs", type=int, default=128, help="parallel envs")
    p.add_argument("--updates-per-step", type=int, default=None,
                   help="FIXED learner updates per vector env step "
                        "(ablation mode; default: the reference's "
                        "updates-per-episode debt schedule)")
    p.add_argument("--updates-per-episode", type=int, default=100,
                   help="learner updates owed per completed episode "
                        "(reference: 100 replay calls at episode end, "
                        "mainDQL:225)")
    p.add_argument("--max-updates-per-step", type=int, default=512,
                   help="cap on debt drained per vector step")
    p.add_argument("--memory-size", type=int, default=50_000)
    p.add_argument("--per-alpha", type=float, default=0.0,
                   help="priority exponent (0 = uniform, reference default)")
    p.add_argument("--no-dedup", action="store_true",
                   help="disable the 2-back transition dedup")
    p.add_argument("--no-terminal-bonus", action="store_true")
    p.add_argument("--features", type=int, default=2048)
    p.add_argument("--hidden", type=int, default=1024)
    p.add_argument("--blocks", type=int, default=3)
    p.add_argument("--no-bf16", action="store_true")
    p.add_argument("--engine", choices=["auto", "fast", "lax"], default="auto",
                   help="actor engine: fast = the env-step kernel, lax = "
                        "the classic op-by-op env; auto picks fast "
                        "whenever the env semantics allow")
    p.add_argument("--steps-per-chunk", type=int, default=16)
    p.add_argument("--replay-shards", type=int, default=1,
                   help="split envs, replay and the learner batch into N "
                        "shards (raised to --data-parallel)")
    p.add_argument("--data-parallel", type=int, default=1,
                   help="shard envs/replay/batch over N data rows of ranks: "
                        "without --coordinator, local ranks (a card each; "
                        "gloo ranks with --cpu)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="tensor parallelism: slice the conv and dense "
                        "layers' output channels over M ranks a data row")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of rank 0: this process is rank "
                        "--process-id of --num-processes "
                        "(torch.distributed; NCCL, gloo with --cpu)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--checkpoint-every", type=int, default=100,
                   help="full state save every N episodes (mainDQL:324)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint")
    p.add_argument("--prune-on-resume", type=int, default=0,
                   help="drop N worst episodes from replay after resume "
                        "(reference load_memory pruned 99)")
    p.add_argument("--warm-start", type=str, default=None, metavar="DIR",
                   help="checkpoint dir of ANOTHER run to warm-start from: "
                        "carries network/target/optimizer/epsilon/replay, "
                        "resets envs + episode counters + metrics "
                        "(mainDQL:124-139). With --resume, an existing "
                        "checkpoint in --checkpoint-dir takes precedence.")
    p.add_argument("--warm-start-named", type=str, default=None,
                   metavar="NAME",
                   help="named checkpoint inside --warm-start (e.g. "
                        "tile_1024_ep7520); default = latest step")
    p.add_argument("--warm-start-step", type=int, default=None,
                   help="step checkpoint inside --warm-start "
                        "(default = latest)")
    p.add_argument("--rollback", action="store_true",
                   help="enable the block rollback-on-regression policy")
    p.add_argument("--rollback-store", choices=["memory", "disk"],
                   default="memory",
                   help="block checkpoints in device memory (default) or "
                        "as named checkpoints on disk")
    p.add_argument("--rollback-block", type=int, default=20,
                   help="episodes per rollback comparison block "
                        "(reference BLOCK_SIZE, mainDQL:109)")
    p.add_argument("--rollback-drop", type=float, default=50.0,
                   help="avg final-max-tile drop vs the previous block "
                        "that triggers a restore (mainDQL:287)")
    p.add_argument("--plot-every", type=int, default=0,
                   help="redraw the 3-panel training plot <log>.png every "
                        "N episodes (reference: 10, mainDQL:270; needs "
                        "--log; 0 = off)")
    p.add_argument("--stop-at-tile", type=int, default=0,
                   help="stop the run once best_tile reaches this value "
                        "(0 = full episode budget)")
    p.add_argument("--debug-csv", type=str, default=None,
                   help="per-step CSV trace of env 0 (reference debug log)")
    p.add_argument("--watchdog", type=float, default=0.0,
                   help="exit 70 if no training chunk completes within N "
                        "seconds (a hang becomes a restartable crash; pair "
                        "with --resume supervision; 0 = off)")
    p.add_argument("--log", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu2048_torch",
        description="2048 RL framework, PyTorch/CUDA port of tpu2048",
        allow_abbrev=False,
    )
    # The JAX CLI takes --cpu here, before the subcommand; the port takes
    # it after the subcommand too (a subparser's default would overwrite a
    # shared dest, hence its own).
    p.add_argument("--cpu", dest="cpu_first", action="store_true",
                   help="run on the CPU instead of the card")
    sub = p.add_subparsers(dest="command", required=True)

    pt = sub.add_parser("train", help="train an agent", allow_abbrev=False)
    st = pt.add_subparsers(dest="algo", required=True)
    ptab = st.add_parser("tabular", help="tabular Q-learning (QLearningBase)",
                         allow_abbrev=False)
    _add_tabular_args(ptab)
    ptab.set_defaults(fn=cmd_train)
    pdqn = st.add_parser("dqn", help="DQN (Deep_QLearning)",
                         allow_abbrev=False)
    _add_dqn_args(pdqn)
    pdqn.set_defaults(fn=cmd_train_dqn)

    pe = sub.add_parser("eval", help="batched greedy evaluation",
                        allow_abbrev=False)
    pe.add_argument("--policy", choices=["random", "model", "tabular"],
                    default="random")
    pe.add_argument("--params", type=str, default=None,
                    help="params .npz of the Q-network (flax names)")
    pe.add_argument("--checkpoint-dir", type=str, default=None,
                    help="a train dqn checkpoint directory; its "
                         "config.json gives the network's widths")
    pe.add_argument("--step", type=int, default=None,
                    help="step checkpoint to play (default: the latest)")
    pe.add_argument("--named", type=str, default=None,
                    help="load a NAMED checkpoint (milestone tile_*, "
                         "block_checkpoint) instead of a step")
    pe.add_argument("--table", type=str, default=None,
                    help="Q-table .npz for --policy tabular")
    pe.add_argument("--games", type=int, default=512)
    pe.add_argument("--eval-batch", type=int, default=512)
    pe.add_argument("--reward", choices=["simple", "shaped"],
                    default="simple",
                    help="env regime to evaluate under: simple "
                         "(Deep_QLearning) or shaped (QLearningBase)")
    pe.add_argument("--engine", choices=["auto", "fast", "lax"],
                    default="auto",
                    help="rollout engine: fast = the env kernels, lax = the "
                         "classic op-by-op env; with --checkpoint-dir the "
                         "run's config.json gives it unless this is set")
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument("--features", type=int, default=2048)
    pe.add_argument("--hidden", type=int, default=1024)
    pe.add_argument("--blocks", type=int, default=3)
    pe.add_argument("--no-bf16", action="store_true")
    pe.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    pe.set_defaults(fn=cmd_eval)

    for name, fn, help_ in (
            ("demo", cmd_demo, "terminal play: manual/random/model"),
            ("gui", cmd_gui, "Tkinter play: manual/random/model")):
        pd = sub.add_parser(name, help=help_, allow_abbrev=False)
        _add_dqn_args(pd)
        pd.add_argument("--table", type=str, default=None,
                        help="play a trained tabular Q-table instead of a "
                             "DQN")
        pd.add_argument("--params", type=str, default=None,
                        help="params .npz of the Q-network (flax names)")
        pd.add_argument("--mode", choices=["manual", "random", "model"],
                        default="manual")
        pd.add_argument("--delay", type=float, default=0.5,
                        help="seconds between autoplay moves")
        pd.add_argument("--step", type=int, default=None)
        pd.add_argument("--named", type=str, default=None,
                        help="load a NAMED checkpoint (e.g. a tile_* "
                             "milestone)")
        pd.set_defaults(fn=fn)

    pb = sub.add_parser("bench", help="throughput benchmarks",
                        allow_abbrev=False)
    pb.add_argument("--batch", type=int, default=None,
                    help="parallel envs (default 65536; 4096 with "
                         "--tabular)")
    pb.add_argument("--steps", type=int, default=256,
                    help="env steps of the timed run (--rollout-k a "
                         "launch)")
    pb.add_argument("--rollout-k", type=int, default=16,
                    help="env steps a rollout-kernel launch (1 = the "
                         "single-step fast_step path, one step-kernel "
                         "launch a step)")
    pb.add_argument("--tabular", action="store_true",
                    help="benchmark the tabular training chunk's env "
                         "steps/s (shaped env + hashed Q-table)")
    pb.add_argument("--table-backend", type=str, default="auto",
                    choices=["auto", "pallas", "interpret", "xla", "legacy"],
                    help="--tabular Q-table: auto/pallas = the packed table "
                         "on the bucket kernels, legacy = the two-array "
                         "table (xla and interpret are JAX's and exit 2)")
    pb.add_argument("--learner", action="store_true",
                    help="benchmark DQN learner updates/s (full-size CNN) "
                         "instead of env steps/s")
    pb.add_argument("--train-loop", action="store_true",
                    help="benchmark the DQN training chunk's actor-side "
                         "env steps/s (full-size CNN policy)")
    pb.add_argument("--train-batch", type=int, default=64,
                    help="learner batch for --learner")
    pb.add_argument("--updates", type=int, default=200,
                    help="timed updates for --learner")
    pb.add_argument("--envs", type=int, default=128,
                    help="env count for --train-loop")
    pb.add_argument("--scale", type=str, default=None,
                    help="data-parallel scaling of the DQN training chunk "
                         "over comma-separated rank counts, e.g. 1,2,4 (a "
                         "card a rank; gloo ranks with --cpu)")
    pb.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    pb.set_defaults(fn=cmd_bench)

    pp = sub.add_parser("plot", help="render training plots from JSONL logs",
                        allow_abbrev=False)
    pp.add_argument("--log", type=str, required=True)
    pp.add_argument("--out", type=str, required=True)
    pp.set_defaults(fn=cmd_plot)

    pa = sub.add_parser("analyze",
                        help="milestone timings + win stats from a "
                             "metrics.jsonl (reference-comparable numbers)",
                        allow_abbrev=False)
    pa.add_argument("--log", type=str, required=True)
    pa.set_defaults(fn=cmd_analyze)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # The consumed argv, so that "did the user pass this flag" checks work
    # for programmatic main([...]) calls too.
    args._argv = list(sys.argv[1:] if argv is None else argv)
    args.cpu = getattr(args, "cpu", False) or args.cpu_first
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
