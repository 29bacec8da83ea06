"""Checkpoint / resume: the whole DQN loop state in the port's own torch
files, the port of :mod:`tpu2048.checkpoint.ckpt` (which writes Orbax).

A checkpoint is one ``state.pt`` written by ``torch.save``: the loop state's
``state_dict()`` (:class:`tpu2048_torch.training.dqn.DQNLoopState`), with
both networks, Adam's state, the learning rate, the replay buffer, the dedup
caches, the env state, every generator's state, the schedule counters and
the running metric sums, so that a restored run continues bit for bit.
Files are written beside their place and renamed into it, so a stopped
save leaves the previous checkpoint whole.

Layout of the directory: ``steps/<episode>/state.pt`` (the newest
``max_to_keep`` are kept) and ``named/<name>/state.pt`` (milestone tiers
``tile_<tile>_ep<episode>`` and the rollback ``block_checkpoint``).

Data parallel (:mod:`tpu2048_torch.parallel.mesh`), every rank saves
together. Rank r > 0 writes its own part (the state's ``rank_part()``),
``rank<r>.pt`` in the same directory: its lanes' env state and dedup caches, its replay shards, its
generators (env, draws, dropout) and its running sums. After a barrier rank
0 writes ``state.pt``, its whole state with the replicated agent and
counters, last: a step counts (``all_steps``) only once it is complete. A
rank reads ``state.pt`` and its own part. A checkpoint is resumed at the
world size and shard count that wrote it (the loop state checks them).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional

import torch

from tpu2048_torch.parallel import mesh

STATE_FILE = "state.pt"


def _rank_file(rank: int) -> str:
    return STATE_FILE if rank == 0 else f"rank{rank}.pt"


def _write(path: str, payload: Dict, name: str = STATE_FILE) -> None:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, name + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, name))


def _read(path: str, mmap: bool = False, name: str = STATE_FILE) -> Dict:
    return torch.load(os.path.join(path, name), map_location="cpu",
                      weights_only=True, mmap=mmap)


def _save(path: str, state: Any) -> None:
    """Every rank's part of ``state`` into ``path`` (rank r > 0's
    ``state.rank_part()``), rank 0's ``state.state_dict()`` last."""
    rank = mesh.rank()
    if rank:
        _write(path, state.rank_part(), _rank_file(rank))
    mesh.barrier()
    if rank == 0:
        _write(path, state.state_dict())
    mesh.barrier()


def _load(path: str) -> Dict:
    """This rank's payload from ``path``: ``state.pt``, overlaid on a rank
    r > 0 with its own part (``state.pt`` is mapped, so only its
    replicated part is read there)."""
    rank = mesh.rank()
    if rank == 0:
        return _read(path)
    payload = dict(_read(path, mmap=True))
    name = _rank_file(rank)
    if not os.path.isfile(os.path.join(path, name)):
        raise ValueError(f"{path} holds no part of rank {rank}: it was "
                         f"written by {payload.get('world', 1)} rank(s)")
    payload.update(_read(path, name=name))
    return payload


class CheckpointManager:
    """Step-tagged and named checkpoints over one directory, which is made
    only when a checkpoint is written: reading creates nothing."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    # -- step-tagged (save_agent_state, Dqn8:410-440) -----------------------

    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, "steps", str(int(step)))

    def save(self, step: int, state: Any) -> None:
        """Write ``state.state_dict()`` as step ``step`` (every rank of a
        process group calls it); rank 0 drops the oldest steps beyond
        ``max_to_keep``."""
        _save(self._step_path(step), state)
        steps = self.all_steps()
        if self.max_to_keep is not None and mesh.is_primary_host():
            for old in steps[:-self.max_to_keep]:
                shutil.rmtree(self._step_path(old))

    def read(self, step: int) -> Dict:
        """This rank's payload of step ``step``, on the CPU."""
        return _load(self._step_path(step))

    def restore(self, step: int, state: Any) -> Any:
        """Load step ``step`` into ``state`` (in place); returns it."""
        state.load_state_dict(self.read(step))
        return state

    def all_steps(self) -> List[int]:
        root = os.path.join(self.directory, "steps")
        if not os.path.isdir(root):
            return []
        return sorted(int(d) for d in os.listdir(root) if d.isdigit()
                      and os.path.isfile(os.path.join(root, d, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- named (save_agent_state_checkpoint, Dqn8:506-584) ------------------

    def _named_path(self, name: str) -> str:
        return os.path.join(self.directory, "named", name)

    def save_named(self, name: str, state: Any) -> None:
        """Write ``state`` as ``name``, replacing an earlier one (named
        checkpoints roll, as the reference's block_checkpoint does)."""
        _save(self._named_path(name), state)

    def read_named(self, name: str) -> Dict:
        return _load(self._named_path(name))

    def restore_named(self, name: str, state: Any) -> Any:
        state.load_state_dict(self.read_named(name))
        return state

    def has_named(self, name: str) -> bool:
        return os.path.isfile(os.path.join(self._named_path(name),
                                           STATE_FILE))

    def named(self) -> List[str]:
        root = os.path.join(self.directory, "named")
        if not os.path.isdir(root):
            return []
        return sorted(n for n in os.listdir(root) if self.has_named(n))


def restore_params_only(directory: str, step: Optional[int], config,
                        named: Optional[str] = None, device=None):
    """The online network of a checkpoint, built from ``config`` (a
    DQNConfig) on ``device`` (``cuda`` unless another is named).

    The file is mapped, not read, so only the network's bytes are paged in
    (a step checkpoint also holds the target network, Adam's state and the
    replay buffer). ``named`` selects a named checkpoint (milestone tiers,
    ``block_checkpoint``) in place of a step; with neither, the latest
    step. Returns ``(step_or_name, module)``, or ``(None, None)`` when the
    directory holds no step; raises FileNotFoundError for a missing name.
    """
    from tpu2048_torch.models.dqn import create_model  # noqa: PLC0415

    mgr = CheckpointManager(directory)
    if named is not None:
        if not mgr.has_named(named):
            raise FileNotFoundError(
                f"no named checkpoint {named!r} in {directory} "
                f"(available: {mgr.named()})")
        payload, tag = _read(mgr._named_path(named), mmap=True), named
    else:
        tag = mgr.latest_step() if step is None else step
        if tag is None:
            return None, None
        if tag not in mgr.all_steps():
            raise FileNotFoundError(f"no step {tag} in {directory}")
        payload = _read(mgr._step_path(tag), mmap=True)
    module = create_model(config, device)
    module.load_state_dict(payload["agent"]["model"])
    return tag, module.eval()
