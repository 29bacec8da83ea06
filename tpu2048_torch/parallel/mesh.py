"""Ranks, what each owns, and the collectives of data- and tensor-parallel
training, the port of :mod:`tpu2048.parallel.mesh`.

JAX runs one SPMD program over a ``(data, model)`` device mesh and lets XLA
insert the collectives. The port runs one process a rank under
``torch.distributed``: NCCL between cards, gloo on the CPU (or, when the
caller names it, between ranks that share one card). The ranks form a
``(D, M)`` grid, laid row-major as JAX's ``create_mesh`` lays devices: rank
r sits at data index ``r // M`` and model index ``r % M``. A data row's M
ranks form its **model group**, one model index across the D rows its
**data group** (:func:`create_mesh` makes both).

Data parallel (``data_sharding`` and ``dqn_loop_sharding`` in JAX, here
plain rules, :func:`rank_layout`): with S replay shards and B envs, data
index d owns shards ``[d S/D, (d+1) S/D)`` and their lanes ``[d B/D,
(d+1) B/D)``; shard s owns lanes ``[s B/S, (s+1) B/S)``, its replay shard
and ``train_batch/S`` samples an update. Each learner update averages the
gradients over the data group with one ``all_reduce`` before Adam, and the
host's decisions (update counts, the learning-rate hook, the periodic
operations) are taken from counts reduced over it, so that every rank takes
the same ones.

Tensor parallel (``param_partition_spec``): each conv and dense layer
whose output channels divide by M is sliced on them over the model group,
the head never; the model ranks of a row run the same lanes, as XLA runs an
array replicated over the ``model`` axis, and meet in Megatron's pair of
autograd functions (:func:`copy_to_model_group`,
:func:`gather_from_model_group`) around each sliced layer.

Without a process group every function here is the single process's: rank
0 of 1, and the collectives do nothing.
"""

from __future__ import annotations

import dataclasses
import datetime
import warnings
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from tpu2048_torch.metrics.profiling import annotate
from tpu2048_torch.utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
# A rank that dies leaves the others in a collective: they give up after this
# long (a full-width checkpoint between two collectives takes seconds).
DEFAULT_TIMEOUT_S = 600.0

_DEVICE: Optional[torch.device] = None  # this rank's device, set at init
# The process group's grids: (D, M) -> (the model group of each data row,
# the data group of each model index), made once (every rank makes every
# group, in one order), dropped by destroy().
_GROUPS: Dict[Tuple[int, int], Tuple[List[Any], List[Any]]] = {}


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


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """This rank's model group: ``size`` ranks, each holding one slice of
    every sliced layer, this rank's slice ``index``; ``group`` is the
    process group."""

    group: Any
    size: int
    index: int


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
    _GROUPS.clear()


def barrier() -> None:
    if not is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[local_device().index])
    else:
        dist.barrier()


def all_reduce(tensor: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``tensor`` reduced in place over the ranks of ``group`` (``"sum"`` or
    ``"max"``); returns it. With ``group`` None (no process group, or one
    data row), ``tensor`` as it is."""
    if group is not None:
        dist.all_reduce(tensor, {"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op], group=group)
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
                      loss: torch.Tensor, group=None) -> torch.Tensor:
    """Average the parameters' gradients and ``loss`` over the ranks of
    ``group`` (default: every rank) with one ``all_reduce`` of one flat
    bucket, in place; returns the mean loss. With equal batches a rank this
    is the gradient of the global batch's mean loss, JAX's ``psum`` / D. On
    one rank every value is unchanged, bit for bit. The all-reduce is the
    profiler span ``learner.allreduce``."""
    grads = [p.grad for p in params]
    bucket = torch.cat([g.reshape(-1) for g in grads]
                       + [loss.detach().reshape(1).to(grads[0].dtype)])
    with annotate("learner.allreduce"):
        dist.all_reduce(bucket, group=group)
    bucket.div_(dist.get_world_size(group))
    views = torch.split(bucket, [g.numel() for g in grads] + [1])
    for g, v in zip(grads, views):
        g.copy_(v.view_as(g))
    return views[-1][0].to(loss.dtype)


def create_mesh(config: MeshConfig = MeshConfig(),
                n_ranks: Optional[int] = None) -> Mesh:
    """A ``(data, model)`` grid over ``n_ranks`` ranks (default: the process
    group's), rank r at ``(r // M, r % M)``; raises when it needs more ranks
    than there are, warns when it leaves some idle, as JAX's
    ``create_mesh`` does for devices."""
    n = world_size() if n_ranks is None else n_ranks
    mp = max(config.model_parallel, 1)
    dp = config.data_parallel if config.data_parallel > 0 else n // mp
    if dp * mp > n:
        raise ValueError(
            f"mesh {dp}x{mp} needs {dp * mp} ranks, only {n} available")
    if dp * mp != n:
        warnings.warn(f"mesh {dp}x{mp} uses only {dp * mp} of {n} ranks; "
                      "the rest sit idle", stacklevel=2)
    return Mesh(tuple(tuple(range(d * mp, (d + 1) * mp)) for d in range(dp)))


def grid_groups(dp: int, mp: int) -> Tuple[Optional[ModelGroup], Any]:
    """This rank's model group and data group on the process group's
    ``(dp, mp)`` grid: ``(None, the world)`` at ``mp == 1``, else its row's
    :class:`ModelGroup` and its column's process group (None when ``dp ==
    1``: nothing to reduce). The first call for a grid makes every group of
    it, on every rank in the same order, as ``dist.new_group`` needs."""
    if mp == 1:
        return None, dist.group.WORLD
    if (dp, mp) not in _GROUPS:
        mesh = create_mesh(MeshConfig(dp, mp))
        _GROUPS[dp, mp] = (
            [dist.new_group(list(row)) for row in mesh.ranks],
            [dist.new_group(list(col)) for col in zip(*mesh.ranks)]
            if dp > 1 else [None] * mp)
    rows, cols = _GROUPS[dp, mp]
    d, m = divmod(rank(), mp)
    return ModelGroup(rows[d], mp, m), cols[m]


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """What a rank owns: its place ``(data_index, model_index)`` on the
    ``(dp, mp)`` grid, replay shards ``shards``, their envs ``lanes`` (a
    slice of the global batch) and ``batch`` learner samples an update, all
    its data row's. In a process group, ``model`` is its
    :class:`ModelGroup` (None at ``mp == 1``) and ``data_group`` the
    process group its counts and gradients are reduced over (None: nothing
    to reduce)."""

    shards: range
    lanes: slice
    batch: int
    data_index: int
    model_index: int
    dp: int
    mp: int
    model: Optional[ModelGroup] = dataclasses.field(default=None,
                                                    compare=False)
    data_group: Any = dataclasses.field(default=None, compare=False)

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
                rank_: Optional[int] = None, world: Optional[int] = None, *,
                model_parallel: int = 1) -> RankLayout:
    """The layout of rank ``rank_`` of ``world`` (default: this process in
    its group, with its groups) for a run of ``num_envs`` envs, a learner
    batch of ``train_batch``, ``replay_shards`` shards and model groups of
    ``model_parallel`` ranks; raises when they do not divide."""
    r = rank() if rank_ is None else rank_
    w = world_size() if world is None else world
    mp, s = model_parallel, replay_shards
    if w % mp:
        raise ValueError(f"{w} ranks do not form model groups of {mp}")
    dp = w // mp
    for what, n, of, d in (("replay shards", s, "data-parallel ranks", dp),
                           ("envs", num_envs, "replay shards", s),
                           ("learner batch", train_batch, "replay shards", s)):
        if n % d:
            raise ValueError(f"{what} ({n}) must be a multiple of {of} "
                             f"({d})")
    d, m = divmod(r, mp)
    model = data_group = None
    if rank_ is None and world is None and is_initialized():
        model, data_group = grid_groups(dp, mp)
    per = s // dp
    lanes = num_envs // dp
    return RankLayout(shards=range(d * per, (d + 1) * per),
                      lanes=slice(d * lanes, (d + 1) * lanes),
                      batch=train_batch // dp, data_index=d, model_index=m,
                      dp=dp, mp=mp, model=model, data_group=data_group)


def param_partition_spec(module: torch.nn.Module, model_parallel: int
                         ) -> Dict[str, Optional[int]]:
    """Tensor-parallel slicing of a whole (unsliced) module's parameters,
    the port of JAX's ``param_partition_spec``: ``{name: 0}`` for a
    parameter sliced on its output-channel axis over the model group,
    ``{name: None}`` for one every model rank holds whole. A parameter is
    sliced when that axis's size is a multiple of ``model_parallel`` (> 1);
    the head (``head.*``) never is. Torch keeps that axis first (conv
    weights ``(out, in, kh, kw)``, linear ``(out, in)``), flax last."""
    return {name: 0 if (model_parallel > 1 and not name.startswith("head.")
                        and p.shape[0] % model_parallel == 0) else None
            for name, p in module.named_parameters()}


def _all_gather(x: torch.Tensor, group: ModelGroup) -> List[torch.Tensor]:
    """Every model rank's ``x``, by index. Gathered as bytes, so that any
    dtype goes through any backend."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group.size)]
    dist.all_gather([p.view(torch.uint8) for p in parts],
                    x.view(torch.uint8), group=group.group)
    return parts


def slice_rows(x: torch.Tensor, group: ModelGroup) -> torch.Tensor:
    """This model rank's slice of a whole tensor's rows (axis 0), a view."""
    return x.chunk(group.size)[group.index]


@torch.no_grad()
def gather_rows(x: torch.Tensor, group: ModelGroup) -> torch.Tensor:
    """The whole tensor of which every model rank holds a slice of rows
    (axis 0), in index order: the inverse of :func:`slice_rows`."""
    return torch.cat(_all_gather(x, group))


class _CopyToModelGroup(torch.autograd.Function):
    """The input of a sliced layer: the identity going forward; going back,
    the sum over the model group of each slice's input gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        total = grad.to(torch.float32, copy=True)
        dist.all_reduce(total, group=ctx.group.group)
        return total.to(grad.dtype), None


class _GatherFromModelGroup(torch.autograd.Function):
    """The output of a sliced layer: every model rank's channels gathered in
    the whole layer's order going forward; going back, this rank's slice of
    the gradient. The channel axis (1) holds ``blocks`` blocks (a conv
    block's kernels), each sliced over the group: a rank's output is
    ``[block 0's slice, block 1's slice, ...]`` and the whole one block
    after block, each in rank order."""

    @staticmethod
    def forward(ctx, x, group, blocks):
        ctx.group, ctx.blocks = group, blocks
        b, c, rest = x.shape[0], x.shape[1], x.shape[2:]
        y = torch.stack(_all_gather(x, group)).view(
            group.size, b, blocks, c // blocks, *rest)
        return y.transpose(0, 1).transpose(1, 2).reshape(
            b, group.size * c, *rest)

    @staticmethod
    def backward(ctx, grad):
        group, b, rest = ctx.group, grad.shape[0], grad.shape[2:]
        mine = grad.reshape(b, ctx.blocks, group.size, -1, *rest)[
            :, :, group.index]
        return mine.reshape(b, -1, *rest), None, None


def copy_to_model_group(x: torch.Tensor, group: ModelGroup) -> torch.Tensor:
    """The input of a sliced layer (:class:`_CopyToModelGroup`). Only in
    front of a sliced layer: a whole layer's input gradient is already the
    same on every model rank, and a sum would multiply it by the group's
    size."""
    return _CopyToModelGroup.apply(x, group)


def gather_from_model_group(x: torch.Tensor, group: ModelGroup,
                            blocks: int = 1) -> torch.Tensor:
    """A sliced layer's whole output (:class:`_GatherFromModelGroup`)."""
    return _GatherFromModelGroup.apply(x, group, blocks)
