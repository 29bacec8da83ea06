"""Checkpoints keyed by replay shard, resumed at another data-parallel
size (JAX's restore onto another mesh, ``tpu2048/checkpoint/ckpt.py``).

Two gloo ranks train a run of 4 replay shards and checkpoint it (``state.pt``
and ``rank1.pt``, two shards each). One process holding all four shards and
four ranks holding one each resume it: just after the restore
``host_sums`` reads the writers' totals (data row 0 takes them, the others
start at zero), and the rows from there equal a straight one-process run's:
integers equal, the float sums' means within ``LOSS_RTOL``
(``tests/test_torch_parallel.py``). The same checkpoint in the layout before
parts named their shards (no ``shards`` key) resumes alike; another shard
count raises.

Float32, dropout 0 (a resharded row's dropout generator is keyed afresh),
features 16, hidden 32, one block.
"""

import dataclasses
import functools
import shutil

import pytest

from test_torch_parallel import LOOP, LOSS_RTOL, assert_rows_agree, spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tpu2048_torch.checkpoint import ckpt
from tpu2048_torch.checkpoint.ckpt import CheckpointManager
from tpu2048_torch.parallel import mesh
from tpu2048_torch.training import dqn as ttrain

SHARDS4 = dataclasses.replace(LOOP, replay_shards=4)
EPISODES = 4


def write_rank(config, episodes, directory):
    """Train to ``episodes`` with checkpoints; the rows and the host sums
    at the end, which the last checkpoint holds."""
    state = ttrain.init_loop_state(config, mesh.local_device("cpu"))
    rows = ttrain.train(config, episodes, state.device, state=state,
                        ckpt_manager=CheckpointManager(directory))
    return rows, ttrain.host_sums(state)


def resume_rank(config, episodes, directory):
    """Restore the latest checkpoint of ``directory``; the host sums just
    after it and the rows of training on to ``episodes``."""
    state = ttrain.init_loop_state(config, mesh.local_device("cpu"))
    mgr = CheckpointManager(directory)
    mgr.restore(mgr.latest_step(), state)
    return (ttrain.host_sums(state),
            ttrain.train(config, episodes, state.device, state=state))


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("reshard") / "ck")
    ranks = spawn(functools.partial(write_rank, SHARDS4, EPISODES, ck))
    rows, sums = ranks[0]
    assert ranks[1][1] == sums
    last = rows[-1]["episodes"]
    straight = ttrain.train(SHARDS4, last + 3, "cpu")
    assert_rows_agree(rows, straight[:len(rows)])
    return ck, rows, sums, straight[len(rows):]


def copy_of(written, tmp_path, unnamed_shards=False):
    """A copy of the written checkpoint; in the layout before parts named
    their shards, with ``shards`` taken out of every file."""
    directory = str(tmp_path / "copy")
    shutil.copytree(written[0], directory)
    if unnamed_shards:
        mgr = CheckpointManager(directory)
        for step in mgr.all_steps():
            path = mgr._step_path(step)
            for name in (ckpt.STATE_FILE, "rank1.pt"):
                payload = dict(ckpt._read(path, name=name))
                del payload["shards"]
                ckpt._write(path, payload, name)
    return directory


def assert_sums_agree(got, want):
    for k, v in want.items():
        if isinstance(v, float) and k not in ("loss",):
            assert got[k] == pytest.approx(v, rel=LOSS_RTOL), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("layout", ["by_shard", "unnamed_shards"])
def test_two_ranks_resume_in_one_process(layout, written, tmp_path):
    directory = copy_of(written, tmp_path,
                        unnamed_shards=layout == "unnamed_shards")
    last = written[1][-1]["episodes"]
    sums, rows = resume_rank(SHARDS4, last + 3, directory)
    assert_sums_agree(sums, written[2])
    assert_rows_agree(rows, written[3])


def test_two_ranks_resume_at_four_ranks(written, tmp_path):
    directory = copy_of(written, tmp_path)
    last = written[1][-1]["episodes"]
    ranks = spawn(functools.partial(resume_rank, SHARDS4, last + 3,
                                    directory), n=4)
    for sums, rows in ranks:
        assert_sums_agree(sums, written[2])
        assert_rows_agree(rows, written[3])
    # The last of the four holds one shard, 8 of the 32 envs, no sums and
    # no dropout generator of its own.
    payload = CheckpointManager(directory).read(last, range(3, 4))
    assert payload["dedup"]["saved_count"].shape == (8,)
    assert payload["env_state"]["boards"].shape == (16, 8)
    assert float(payload["sum_return"]) == 0.0
    assert payload["learner_generator"] is None


@pytest.mark.parametrize("shards", [2, 8])
def test_another_shard_count_raises(shards, written, tmp_path):
    directory = copy_of(written, tmp_path)
    with pytest.raises(ValueError, match="replay shard"):
        ttrain.train(dataclasses.replace(SHARDS4, replay_shards=shards),
                     100, "cpu", ckpt_manager=CheckpointManager(directory),
                     resume=True)
