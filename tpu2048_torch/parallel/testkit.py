"""Distributed test rig, the port of :mod:`tpu2048.parallel.testkit` and of
the root ``__graft_entry__.py``'s ``dryrun_multichip``.

:func:`run_chunks` drives the real DQN training chunk (fast engine, sharded
replay, learner updates) at a tiny width and returns a digest that does not
depend on how the shards and the networks are spread: the same config run
by one process holding all ``dp`` shards and the whole networks, or by a
``(dp, mp)`` grid of ranks of a process group (each data row holding one
shard, each model rank its slices), gives the same integers and parameters
within float32 reduction order. :func:`spawn_ranks` starts ranks of a
process group on this machine (``torch.multiprocessing``, a free local
port), which the tests, the CLI's ``--data-parallel N``, ``bench --scale``
and ``chip_smoke.py`` use; :func:`dryrun_multichip` runs one chunk over n
of them, ``(n/2, 2)`` on an even n > 1 as JAX's does.
"""

from __future__ import annotations

import dataclasses
import functools
import pickle
import queue as queue_module
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import torch

from tpu2048_torch.parallel import mesh

# A tiny but complete config: the whole train path (env step, replay
# insert, dedup, learner updates, target net) at toy sizes.
CONFIG_KW: Dict[str, Any] = dict(
    features=16, hidden=32, num_blocks=1, envs_per_dp=8, batch_per_dp=8,
    steps_per_chunk=2, memory_per_dp=64, seed=0,
)
# A rank that has not reported within this long fails the spawn.
SPAWN_TIMEOUT_S = 900.0


def chunk_config(dp: int, *, features: int, hidden: int, num_blocks: int,
                 envs_per_dp: int, batch_per_dp: int, steps_per_chunk: int,
                 memory_per_dp: int, seed: int):
    """The DQN train config of :func:`run_chunks` over ``dp`` shards:
    float32, no dropout, epsilon 0.5 (explore and exploit lanes), one
    update a step, one replay shard a data row."""
    from tpu2048_torch.agents.dqn import DQNConfig  # noqa: PLC0415
    from tpu2048_torch.env.env import SIMPLE, EnvConfig  # noqa: PLC0415
    from tpu2048_torch.training.dqn import DQNTrainConfig  # noqa: PLC0415

    return DQNTrainConfig(
        agent=DQNConfig(features=features, hidden=hidden,
                        num_blocks=num_blocks, bf16=False, dropout=0.0,
                        memory_size=memory_per_dp * dp, epsilon=0.5),
        env=EnvConfig(reward=SIMPLE, terminal_bonus=True),
        num_envs=envs_per_dp * dp,
        updates_per_step=1,
        train_batch=batch_per_dp * dp,
        steps_per_chunk=steps_per_chunk,
        replay_shards=dp,
        seed=seed,
    )


def run_chunks(n_devices: int, model_parallel: int, chunks: int, *,
               device=None, params: bool = False, config=None,
               **config_kw) -> Dict[str, Any]:
    """``chunks`` training chunks of :func:`chunk_config` (``config_kw``,
    e.g. :data:`CONFIG_KW`) over ``n_devices // model_parallel`` shards, or
    of ``config`` (at ``model_parallel``) when given: in a process group of
    ``n_devices`` ranks each data row runs its shard and each model rank its
    slices, without one this process runs them all with the whole networks.
    Returns JAX's digest (``env_steps``, ``episodes``, ``eps``,
    ``param_sum``, ``loss_sum``) with ``train_steps``, this process's
    step-kernel ``launches`` and the chunks' ``seconds`` (the device
    synchronised), and with ``params`` the online network's whole
    parameters (on the CPU)."""
    from tpu2048_torch.models.dqn import whole_state_dict  # noqa: PLC0415
    from tpu2048_torch.ops import step_kernel as sk  # noqa: PLC0415
    from tpu2048_torch.training import dqn as dtrain  # noqa: PLC0415

    dp = n_devices // model_parallel
    grid = mesh.MeshConfig(dp, model_parallel)
    if mesh.is_initialized():
        mesh.create_mesh(grid)
        if mesh.world_size() != n_devices:
            raise ValueError(f"{mesh.world_size()} ranks for a {dp}x"
                             f"{model_parallel} grid")
    else:
        mesh.create_mesh(grid, n_devices)
    config = dataclasses.replace(
        config or chunk_config(dp, **config_kw),
        model_parallel=model_parallel if mesh.is_initialized() else 1)
    before = sk.fused_env_step.launches
    device = mesh.local_device(device)
    state = dtrain.init_loop_state(config, device)
    eps = None
    t0 = time.perf_counter()
    for _ in range(chunks):
        state, eps = dtrain.train_chunk(config, state)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    whole = whole_state_dict(state.agent.model)
    param_sum = sum(p.detach().abs().sum(dtype=torch.float32)
                    for p in whole.values())
    digest = {
        "env_steps": state.env_steps,
        "episodes": state.episodes_done,
        "eps": float(eps),
        "param_sum": float(param_sum),
        "loss_sum": float(state.loss_sum),
        "train_steps": state.agent.train_steps,
        "launches": sk.fused_env_step.launches - before,
        "seconds": seconds,
    }
    if params:
        digest["params"] = {k: v.detach().cpu() for k, v in whole.items()}
    return digest


def train_rank(config, total_episodes: int, device=None,
               checkpoint_dir: Optional[str] = None, resume: bool = False,
               log: Optional[str] = None) -> List[dict]:
    """:func:`tpu2048_torch.training.dqn.train` on this rank, with a
    checkpoint directory and a JSONL log (rank 0 writes it); returns the
    rows."""
    from tpu2048_torch.checkpoint.ckpt import CheckpointManager  # noqa
    from tpu2048_torch.metrics.logging import JSONLLogger  # noqa: PLC0415
    from tpu2048_torch.training.dqn import train  # noqa: PLC0415

    mgr = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
    logger = JSONLLogger(log, echo=False)
    try:
        return train(config, total_episodes, mesh.local_device(device),
                     log_fn=logger.log, ckpt_manager=mgr, resume=resume)
    finally:
        logger.close()


def free_port() -> int:
    """A TCP port free on this machine's loopback now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, port: int, backend, device,
               results) -> None:
    try:
        mesh.distributed_init(f"127.0.0.1:{port}", world, rank,
                              backend=backend, device=device)
        # Pickled here: a tensor put as it is would be shared through a
        # file descriptor that dies with this process.
        results.put((rank, True, pickle.dumps(fn())))
    except BaseException:  # noqa: BLE001 (reported to the parent)
        results.put((rank, False, traceback.format_exc()))
    finally:
        mesh.destroy()


def spawn_ranks(n: int, fn: Callable[[], Any], backend: Optional[str] = None,
                device=None, timeout_s: float = SPAWN_TIMEOUT_S) -> List[Any]:
    """Run ``fn()`` (picklable) on ``n`` new ranks of a process group on
    this machine and return their results by rank.

    Each rank joins at a free local port with
    :func:`tpu2048_torch.parallel.mesh.distributed_init` (``backend`` and
    ``device`` as it takes them: NCCL a card each, gloo on the CPU, or gloo
    on the card when named). Raises, and kills the ranks left, when a rank
    raises or exits, or when ``timeout_s`` passes before every rank has
    reported."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, n, port, backend,
                                                  device, results))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    done: Dict[int, Any] = {}
    try:
        while len(done) < n:
            try:
                r, ok, value = results.get(timeout=1.0)
            except queue_module.Empty:
                for r, p in enumerate(procs):
                    if r not in done and p.exitcode is not None:
                        raise RuntimeError(
                            f"rank {r} exited with {p.exitcode} before "
                            "reporting") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(f"ranks {sorted(set(range(n)) - set(done))} "
                                       f"did not finish in {timeout_s} s"
                                       ) from None
                continue
            if not ok:
                raise RuntimeError(f"rank {r} of {n} failed:\n{value}")
            done[r] = pickle.loads(value)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        bad = [(r, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited with {bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
    return [done[r] for r in range(n)]


def dryrun_multichip(n_devices: int, device=None) -> Dict[str, Any]:
    """One training chunk over ``n_devices`` ranks at the tiny width
    (:data:`CONFIG_KW`), on a ``(n/2, 2)`` grid when n is even and above 1,
    as JAX's dry run does, else ``(n, 1)``: envs, dedup lanes and replay
    shards a data row, the networks sliced over each row's model ranks,
    gradients averaged over the data group. On the card it needs
    ``n_devices`` cards (NCCL, one a rank) and raises otherwise;
    ``device="cpu"`` runs gloo ranks. Returns rank 0's digest."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) on the card "
                               f"needs {n_devices} cards, this machine has "
                               f"{have}")
    mp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    dp = n_devices // mp
    kw = dict(CONFIG_KW)
    digests = spawn_ranks(n_devices, functools.partial(
        run_chunks, n_devices, mp, 1, **kw), device=device)
    d = digests[0]
    steps = kw["envs_per_dp"] * dp * kw["steps_per_chunk"]
    if d["env_steps"] != steps:
        raise RuntimeError(f"dryrun_multichip({n_devices}): env_steps "
                           f"{d['env_steps']}, expected {steps}")
    print(f"dryrun_multichip({n_devices}): mesh=({dp}, {mp}) "
          f"env_steps={d['env_steps']} episodes={d['episodes']} "
          f"eps={d['eps']:.3f} OK", flush=True)
    return d
