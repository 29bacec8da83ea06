"""Ranks, what each owns, and the collectives of data-parallel training, the
port of :mod:`tpu2048.parallel.mesh`.

JAX runs one SPMD program over a ``(data, model)`` device mesh and lets XLA
insert the gradient all-reduce. The port runs one process a rank under
``torch.distributed``: NCCL between cards, gloo on the CPU (or, when the
caller names it, between ranks that share one card). Each rank holds its
lanes of the envs, its dedup lanes and its replay shards, and a replica of
the agent; each learner update averages the gradients over the ranks with
one ``all_reduce`` before Adam. The host's decisions (update counts, the
learning-rate hook, the periodic operations) are taken from counts reduced
over the ranks, so that every rank takes the same ones.

Ownership (``data_sharding`` and ``dqn_loop_sharding`` in JAX, here plain
rules, :func:`rank_layout`): with R ranks, S replay shards and B envs, rank
r owns shards ``[r S/R, (r+1) S/R)`` and their lanes ``[r B/R, (r+1)
B/R)``; shard s owns lanes ``[s B/S, (s+1) B/S)``, its replay shard and
``train_batch/S`` samples an update. The agent, the schedule's counters and
the loss sums are replicated.

Without a process group every function here is the single process's: rank
0 of 1, and the collectives do nothing. Tensor parallelism
(``model_parallel > 1``) is not yet ported.
"""

from __future__ import annotations

import dataclasses
import datetime
import warnings
from typing import Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from tpu2048_torch.utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
# A rank that dies leaves the others in a collective: they give up after this
# long (a full-width checkpoint between two collectives takes seconds).
DEFAULT_TIMEOUT_S = 600.0

_DEVICE: Optional[torch.device] = None  # this rank's device, set at init


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data_parallel: int = -1  # -1 = all remaining ranks
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` grid of ranks (JAX's ``Mesh`` of devices)."""

    ranks: Tuple[Tuple[int, ...], ...]

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.ranks), MODEL_AXIS: len(self.ranks[0])}


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_primary_host() -> bool:
    """Rank 0 (or no process group): the one that logs and writes the
    replicated part of a checkpoint."""
    return rank() == 0


def rank_device(device=None, rank_: Optional[int] = None) -> torch.device:
    """The device of rank ``rank_`` (default: this one) on ``device``'s type
    (``cuda`` unless another is named): ``cuda:rank % cards`` (raises
    without CUDA), or the CPU."""
    device = resolve_device(device)
    if device.type != "cuda":
        return device
    r = rank() if rank_ is None else rank_
    return torch.device("cuda", r % torch.cuda.device_count())


def local_device(device=None) -> torch.device:
    """This rank's device: the one :func:`distributed_init` set, else
    ``resolve_device(device)``."""
    return _DEVICE if _DEVICE is not None else resolve_device(device)


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``, over TCP at ``coordinator_address`` (``host:port``);
    returns this rank's device. Without an address, nothing is joined and
    the single process's device is returned.

    ``device`` (``cuda`` unless another is named) is the ranks' device type:
    on CUDA the rank runs on card ``process_id % cards`` (set before the
    group starts) and the backend is NCCL; on the CPU it is gloo. An
    explicit ``backend="gloo"`` on CUDA is how ranks share one card (NCCL
    refuses two ranks on one device); no other backend is chosen for the
    caller. A collective that waits ``timeout_s`` fails. On the card, rank
    0 builds the step kernel's library before the others load it.
    """
    global _DEVICE
    if coordinator_address is None:
        return local_device(device)
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id")
    dev = rank_device(device, process_id)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    _DEVICE = dev
    if dev.type == "cpu":
        # Ranks on the CPU share its cores: with every rank on all of them,
        # threads that wait for each other across ranks slow a step by an
        # order of magnitude.
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // num_processes))
    if dev.type == "cuda":
        if process_id == 0:
            from tpu2048_torch.ops.step_kernel import LIBRARY  # noqa: PLC0415

            LIBRARY.build()
        barrier()
    return dev


def destroy() -> None:
    """Leave the process group, if this process is in one."""
    global _DEVICE
    if is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


def barrier() -> None:
    if not is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[local_device().index])
    else:
        dist.barrier()


def all_reduce(tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``tensor`` reduced in place over the ranks (``"sum"`` or ``"max"``);
    returns it. Without a process group, ``tensor`` as it is."""
    if is_initialized():
        dist.all_reduce(tensor, {"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op])
    return tensor


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers onto every rank, in place."""
    if not is_initialized():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src)


@torch.no_grad()
def average_gradients(params: Iterable[torch.nn.Parameter],
                      loss: torch.Tensor) -> torch.Tensor:
    """Average the parameters' gradients and ``loss`` over the ranks with
    one ``all_reduce`` of one flat bucket, in place; returns the mean loss.
    With equal batches a rank this is the gradient of the global batch's
    mean loss, JAX's ``psum`` / R. On one rank every value is unchanged,
    bit for bit."""
    grads = [p.grad for p in params]
    bucket = torch.cat([g.reshape(-1) for g in grads]
                       + [loss.detach().reshape(1).to(grads[0].dtype)])
    dist.all_reduce(bucket)
    bucket.div_(dist.get_world_size())
    views = torch.split(bucket, [g.numel() for g in grads] + [1])
    for g, v in zip(grads, views):
        g.copy_(v.view_as(g))
    return views[-1][0].to(loss.dtype)


def create_mesh(config: MeshConfig = MeshConfig(),
                n_ranks: Optional[int] = None) -> Mesh:
    """A ``(data, model)`` grid over ``n_ranks`` ranks (default: the process
    group's); raises when it needs more ranks than there are, warns when it
    leaves some idle, as JAX's ``create_mesh`` does for devices."""
    n = world_size() if n_ranks is None else n_ranks
    mp = max(config.model_parallel, 1)
    if mp > 1:
        raise NotImplementedError(
            "tensor parallelism (model_parallel > 1) is not yet ported")
    dp = config.data_parallel if config.data_parallel > 0 else n // mp
    if dp * mp > n:
        raise ValueError(
            f"mesh {dp}x{mp} needs {dp * mp} ranks, only {n} available")
    if dp * mp != n:
        warnings.warn(f"mesh {dp}x{mp} uses only {dp * mp} of {n} ranks; "
                      "the rest sit idle", stacklevel=2)
    return Mesh(tuple(tuple(range(d * mp, (d + 1) * mp)) for d in range(dp)))


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """What rank ``rank`` of ``world`` owns: replay shards ``shards``, their
    envs ``lanes`` (a slice of the global batch) and ``batch`` learner
    samples an update."""

    rank: int
    world: int
    shards: range
    lanes: slice
    batch: int

    @property
    def num_envs(self) -> int:
        return self.lanes.stop - self.lanes.start


class ShardedSource:
    """A draw source over lane shards: shard s draws for lanes ``[s B/S,
    (s+1) B/S)`` from its own source (one keyed by the shard), and a draw
    of the shards' lanes is theirs side by side. A rank holds the sources of
    its shards alone, so its lanes draw what they draw in one process with
    every shard."""

    def __init__(self, sources):
        self.sources = list(sources)

    @property
    def generators(self):
        return [src.generator for src in self.sources]

    def per_shard(self, batch: int) -> int:
        """Each shard's part of ``batch`` lanes; raises when it does not
        divide."""
        s = len(self.sources)
        if batch % s:
            raise ValueError(f"{batch} lanes not divisible by {s} shards")
        return batch // s


def rank_layout(num_envs: int, train_batch: int, replay_shards: int,
                rank_: Optional[int] = None,
                world: Optional[int] = None) -> RankLayout:
    """The layout of rank ``rank_`` of ``world`` (default: this process in
    its group) for a run of ``num_envs`` envs, a learner batch of
    ``train_batch`` and ``replay_shards`` shards; raises when they do not
    divide."""
    r = rank() if rank_ is None else rank_
    w = world_size() if world is None else world
    s = replay_shards
    for what, n, of, d in (("replay shards", s, "ranks", w),
                           ("envs", num_envs, "replay shards", s),
                           ("learner batch", train_batch, "replay shards", s)):
        if n % d:
            raise ValueError(f"{what} ({n}) must be a multiple of {of} "
                             f"({d})")
    per = s // w
    lanes = num_envs // w
    return RankLayout(rank=r, world=w, shards=range(r * per, (r + 1) * per),
                      lanes=slice(r * lanes, (r + 1) * lanes),
                      batch=train_batch // w)
