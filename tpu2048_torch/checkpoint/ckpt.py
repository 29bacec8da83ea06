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

Over the ranks of a process group (:mod:`tpu2048_torch.parallel.mesh`)
every rank saves together, and the files are keyed by replay shard. Model
index 0 of data row d > 0 writes its row's part (the state's
``rank_part()``), ``rank<d>.pt`` in the same directory: its lanes' env
state and dedup caches, its replay shards, its generators (each shard's env
and draws, the row's dropout) and its running sums, with the shards it
holds (``shards``). After a barrier rank 0 writes ``state.pt`` last, data
row 0's whole state with the agent and the counters: a step counts
(``all_steps``) only once it is complete. The agent in ``state.pt`` is
whole, a sliced one gathered over row 0's model group before the write, so
``restore_params_only``, ``eval --checkpoint-dir`` and ``--warm-start``
read any run's weights, and a run at any model-parallel size slices what it
reads.

A rank reads ``state.pt`` (mapped) and every part, and assembles its
payload for its own shards from the parts that hold them
(:func:`tpu2048_torch.training.dqn.shard_payload`): a checkpoint resumes at
any data- or model-parallel size that divides its shard count, as JAX's
restore puts global arrays on any mesh. Another shard count or env count
raises, as changed global shapes do there. Part d of a checkpoint written
by D data rows holds shards ``[d S/D, (d+1) S/D)``; the data-parallel
checkpoints before tensor parallelism have that layout, one part a rank.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional

import torch

from tpu2048_torch.parallel import mesh

STATE_FILE = "state.pt"


def _part_file(data_index: int) -> str:
    return STATE_FILE if data_index == 0 else f"rank{data_index}.pt"


def _write(path: str, payload: Dict, name: str = STATE_FILE) -> None:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, name + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, name))


def _read(path: str, mmap: bool = False, name: str = STATE_FILE) -> Dict:
    return torch.load(os.path.join(path, name), map_location="cpu",
                      weights_only=True, mmap=mmap)


def _save(path: str, state: Any) -> None:
    """``state`` into ``path`` from every rank: data row 0's ranks gather
    the agent (``state.state_dict()``, which rank 0 writes last), model
    index 0 of each other row writes its ``state.rank_part()``."""
    layout = state.layout
    payload = None
    if layout.data_index == 0:
        payload = state.state_dict()
    elif layout.model_index == 0:
        _write(path, state.rank_part(), _part_file(layout.data_index))
    mesh.barrier()
    if mesh.rank() == 0:
        _write(path, payload)
    mesh.barrier()


def _load(path: str, shards: Optional[range] = None) -> Dict:
    """The payload of the data row that owns ``shards`` (default: every
    shard of the checkpoint), assembled from ``state.pt`` and the parts,
    each mapped, so that only what is used is read. Raises ValueError when
    the checkpoint has no such shards."""
    from tpu2048_torch.training.dqn import shard_payload  # noqa: PLC0415

    head = _read(path, mmap=True)
    world, total = head.get("world", 1), head.get("replay_shards", 1)
    shards = range(total) if shards is None else shards
    if shards.stop > total:
        raise ValueError(f"{path} holds {total} replay shard(s), this run "
                         f"reads shards {shards.start}-{shards.stop - 1}")
    parts = []
    for d in range(world):
        held = range(d * total // world, (d + 1) * total // world)
        part = head if d == 0 else _read(path, True, _part_file(d))
        if list(part.get("shards", (held.start, held.stop))) != [
                held.start, held.stop]:
            raise ValueError(f"{path}: part {d} holds shards "
                             f"{part['shards']}, not {held}")
        parts.append((held, part))
    return shard_payload(head, parts, shards)


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

    def read(self, step: int, shards: Optional[range] = None) -> Dict:
        """The payload of step ``step`` for the data row that owns
        ``shards`` (default: every shard), on the CPU."""
        return _load(self._step_path(step), shards)

    def restore(self, step: int, state: Any) -> Any:
        """Load step ``step`` into ``state`` (in place, for its rank's
        shards); returns it."""
        state.load_state_dict(self.read(step, state.layout.shards))
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

    def read_named(self, name: str, shards: Optional[range] = None) -> Dict:
        return _load(self._named_path(name), shards)

    def restore_named(self, name: str, state: Any) -> Any:
        state.load_state_dict(self.read_named(name, state.layout.shards))
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
