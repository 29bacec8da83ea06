"""The n-tuple network, its kernels' plain versions, the TD(0) agent, the
lane trainer, ``train ntuple`` and the greedy eval policy, held on the CPU
to the plain reference ``tests/ntuple_reference.py`` on seeded random
weights.

The port and the reference sum a board's lookups in different orders, so
values agree to float32 rounding: 1e-4 of the larger of 1 and the value
here, since random weights of either sign cancel and a sum's rounding
follows its terms, not the sum. A greedy choice is compared where the
reference's two best moves lie further apart than ten times that (most
lanes; equal rewards of mirrored moves make the rest). The weights the
reference and the port update agree to the same rounding.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import ntuple_reference as ref
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)
from tpu2048_torch.agents import ntuple as agent
from tpu2048_torch.cli.main import main as cli_main
from tpu2048_torch.env import fast as fastlib
from tpu2048_torch.eval import evaluate as ev
from tpu2048_torch.models import ntuple as model
from tpu2048_torch.ops import ntuple_kernel as nk
from tpu2048_torch.ops.step_kernel import to_cell_major
from tpu2048_torch.training import ntuple as ntrain

TINY = ((0, 1, 2), (4, 5, 9))
REL = 1e-4
ROOT = Path(__file__).resolve().parent.parent


def random_net(patterns, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    k = len(patterns[0])
    w = torch.randn((len(patterns), 16 ** k), generator=g) * scale
    return model.NTupleNetwork(patterns, weights=w)


def random_boards(n, seed, empty_below=4, top=12):
    g = torch.Generator().manual_seed(seed)
    b = torch.randint(0, top, (n, 16), generator=g)
    b[b < empty_below] = 0
    return b


def cell_major(boards):
    return to_cell_major(boards.to(torch.int8).view(-1, 4, 4))


def gap(got, want):
    got, want = got.double(), want.double()
    same = torch.isinf(want) & (got == want)
    d = torch.where(same, 0.0, (got - want).abs() / want.abs().clamp_min(1))
    return float(d.max()) if d.numel() else 0.0


def clear_lanes(out):
    """Lanes whose best two moves (by the reference) lie further apart
    than the rounding of a value."""
    q = torch.where(out["legal"], out["rewards"].float() + out["values"],
                    -torch.inf)
    top = q.topk(2, dim=0).values
    return (top[0] - top[1]) / top[0].abs().clamp_min(1) > 10 * REL


def lanes(n, seed):
    g = torch.Generator().manual_seed(seed + 1)
    prev = random_boards(n, seed + 2, empty_below=5)
    return (prev, torch.rand(n, generator=g) < 0.8,
            torch.rand(n, generator=g) < 0.2)


def assert_afterstates_match(out, want, check_actions=True):
    assert torch.equal(out.after.permute(0, 2, 1).long(), want["after"])
    assert torch.equal(out.reward.long(), want["rewards"])
    assert torch.equal(out.legal, want["legal"])
    assert gap(out.values, want["values"]) < REL
    assert gap(out.v_prev, want["v_prev"]) < REL
    if check_actions:
        clear = clear_lanes(want)
        assert clear.float().mean() > 0.5
        assert torch.equal(out.action.long()[clear], want["greedy"][clear])


# -- the network -----------------------------------------------------------

def test_index_maps_are_the_patterns_under_the_eight_symmetries():
    maps = model.index_maps(model.PATTERNS_4X6)
    assert maps.shape == (32, 6)
    assert sorted(map(tuple, model.symmetries().tolist())) == sorted(
        map(tuple, ref.SYMMETRIES))
    for p, cells in enumerate(model.PATTERNS_4X6):
        got = sorted(map(tuple, maps[8 * p:8 * p + 8].tolist()))
        want = sorted(tuple(c) for q, c in ref.lookups(model.PATTERNS_4X6)
                      if q == p)
        assert got == want
    assert list(maps[0]) == list(model.PATTERNS_4X6[0])  # identity first


@pytest.mark.parametrize("patterns", [TINY, model.PATTERNS_4X6],
                         ids=["tiny", "4x6"])
def test_a_board_and_its_transforms_have_one_value(patterns):
    net = random_net(patterns, 3)
    boards = random_boards(64, 4)
    values = torch.stack([net.value(boards[:, s])
                          for s in ref.SYMMETRIES])
    assert gap(values, values[0].expand_as(values)) < REL
    want = ref.value(net.weights.view(-1), patterns, boards)
    assert gap(net.value(boards), want) < REL


def test_network_checks_and_round_trip(tmp_path):
    for bad in ((), ((0, 1), (2,)), ((0, 0, 1),), ((0, 16),),
                (tuple(range(8)),)):
        with pytest.raises(ValueError):
            model.NTupleNetwork(bad)
    with pytest.raises(ValueError):
        model.NTupleNetwork(TINY, weights=torch.zeros(2, 16))
    net = random_net(TINY, 5)
    net.save(tmp_path / "n.npz")
    back = model.NTupleNetwork.load(tmp_path / "n.npz")
    assert back.patterns == net.patterns
    assert torch.equal(back.weights, net.weights)
    assert net.counts is None  # the kernel's scratch exists on the card


# -- the kernels' plain versions against the reference -------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_afterstate_values_tiny_patterns_many_lanes(seed):
    net = random_net(TINY, 10 + seed)
    n = 4096
    boards = random_boards(n, 20 + seed)
    prev, pv, pt = lanes(n, 30 + seed)
    out = nk.afterstate_values(cell_major(boards), cell_major(prev), pv, pt,
                               net.weights, net.maps)
    want = ref.td_step(net.weights.view(-1).clone(), TINY, boards, prev, pv,
                       pt, 0.1)
    assert_afterstates_match(out, want)
    same = out.action.long() == want["greedy"]
    w = ref.td_step(net.weights.view(-1).clone(), TINY, boards, prev, pv, pt,
                    0.1, action=out.action.long())
    assert gap(out.target, w["target"]) < REL
    assert torch.equal(out.chosen.T.long(), w["chosen"])
    assert torch.equal(out.chosen.T.long()[same], want["chosen"][same])


def test_afterstate_values_published_set_few_lanes():
    net = random_net(model.PATTERNS_4X6, 7)
    n = 48
    boards = random_boards(n, 8)
    prev, pv, pt = lanes(n, 9)
    out = nk.afterstate_values(cell_major(boards), cell_major(prev), pv, pt,
                               net.weights, net.maps)
    flat = net.weights.view(-1)
    values = torch.stack([ref.value(flat, model.PATTERNS_4X6, a)
                          for a in ref.afterstates(boards)[0]])
    after, rewards, legal = ref.afterstates(boards)
    values = torch.where(legal, values, -torch.inf)
    greedy, _ = ref.greedy(rewards, values, legal)
    want = dict(after=after, rewards=rewards, legal=legal, values=values,
                greedy=greedy,
                v_prev=torch.where(pv, ref.value(flat, model.PATTERNS_4X6,
                                                 prev), 0.0))
    assert_afterstates_match(out, want)


def test_no_legal_move_and_ties():
    """A board with no legal move chooses 0 with a target of 0; equal
    values go to the lowest action."""
    net = model.NTupleNetwork(TINY)  # zero weights: every value 0
    full = torch.tensor([[1, 2, 1, 2, 2, 1, 2, 1] * 2])
    line = torch.tensor([[1, 1, 0, 0] + [0] * 12])  # left and right tie
    boards = torch.cat([full, line])
    prev = torch.zeros_like(boards)
    pv = torch.tensor([True, True])
    pt = torch.tensor([False, False])
    out = nk.afterstate_values(cell_major(boards), cell_major(prev), pv, pt,
                               net.weights, net.maps)
    assert out.legal[:, 0].tolist() == [False] * 4
    assert out.action.tolist() == [0, 0]
    assert out.target[0] == 0 and out.target[1] == 4
    want = ref.td_step(net.weights.view(-1).clone(), TINY, boards, prev, pv,
                       pt, 0.1)
    assert want["greedy"].tolist() == [0, 0]
    assert want["target"].tolist() == [0.0, 4.0]


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_td_step_with_collisions(seed):
    """Many lanes on few boards: most weights are hit by several lanes in
    one step, and the update averages them; reads come before writes."""
    net = random_net(TINY, 40 + seed)
    few = random_boards(6, 50 + seed)
    g = torch.Generator().manual_seed(seed)
    n = 512
    prev = few[torch.randint(0, 6, (n,), generator=g)]
    boards = random_boards(n, 60 + seed)
    pv = torch.rand(n, generator=g) < 0.9
    pt = torch.rand(n, generator=g) < 0.2
    out = nk.afterstate_values(cell_major(boards), cell_major(prev), pv, pt,
                               net.weights, net.maps)
    want_w = net.weights.view(-1).clone()
    want = ref.td_step(want_w, TINY, boards, prev, pv, pt, 0.1,
                       action=out.action.long())
    got = nk.td_update_(net.weights, None, net.maps, cell_major(prev), pv,
                        out.v_prev, out.target, 0.1)
    assert got is net.weights
    written = want["written"]
    hits = torch.cat([ref.index(prev[pv], p, c, 3)
                      for p, c in ref.lookups(TINY)])
    assert int(torch.bincount(hits).max()) > 20  # collisions
    assert gap(net.weights.view(-1)[written], want_w[written]) < REL
    assert torch.equal(net.weights.view(-1)[~written], want_w[~written])


def test_the_update_averages_where_a_sum_would_not():
    """Lanes on one board pull its weights by one lane's update, not by
    the lanes' sum."""
    net = model.NTupleNetwork(TINY)
    n = 100
    prev = random_boards(1, 3).expand(n, 16)
    target = torch.full((n,), 32.0)
    nk.td_update_(net.weights, None, net.maps, cell_major(prev),
                  torch.ones(n, dtype=torch.bool), torch.zeros(n), target,
                  0.5)
    assert abs(float(net.value(prev[:1])) - 0.5 * 32.0) < 1e-4


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    net = random_net(TINY, 1)
    b = cell_major(random_boards(8, 2))
    flags = torch.zeros(8, dtype=torch.bool)
    with pytest.raises(ValueError):
        nk.afterstate_values(b.to(torch.int32), b, flags, flags,
                             net.weights, net.maps)
    with pytest.raises(ValueError):
        nk.afterstate_values(b, b, flags[:4], flags, net.weights, net.maps)
    with pytest.raises(ValueError):
        nk.afterstate_values(b, b, flags, flags, net.weights.double(),
                             net.maps)
    with pytest.raises(ValueError):
        nk.td_update_(net.weights, None, net.maps.long(), b, flags,
                      torch.zeros(8), torch.zeros(8), 0.1)
    nine = model.NTupleNetwork([(i,) for i in range(9)])
    with pytest.raises(ValueError):  # 72 lookups: over the kernel's 64
        nk.afterstate_values(b, b, flags, flags, nine.weights, nine.maps)


def test_build_name_hashes_the_files_a_source_includes(tmp_path):
    from tpu2048_torch.ops._build import CudaLibrary

    assert [p.name for p in nk.LIBRARY.sources()] == ["ntuple_kernel.cu",
                                                      "step_kernel.cu"]
    (tmp_path / "a.cu").write_text('#include <cstdint>\n#include "b.cu"\n')
    (tmp_path / "b.cu").write_text('  # include "c.cu"\n#include "a.cu"\n')
    (tmp_path / "c.cu").write_text("int c;\n")
    lib = CudaLibrary(str(tmp_path / "a.cu"), lambda _: None)
    assert [p.name for p in lib.sources()] == ["a.cu", "b.cu", "c.cu"]
    before = lib.path()
    (tmp_path / "c.cu").write_text("int c2;\n")
    assert lib.path() != before
    assert lib.path().name.startswith("a-")


# -- the trainer -----------------------------------------------------------

def config(lanes=64, steps=8, patterns=TINY):
    return ntrain.NTupleTrainConfig(
        agent=agent.NTupleConfig(patterns=patterns, alpha=0.1),
        batch_size=lanes, steps_per_chunk=steps, total_episodes=8)


def test_chunk_teacher_forced_against_the_reference():
    """Each step of a chunk, from the trainer's state before it: values,
    actions, the weights it wrote and the kept afterstates."""
    cfg = config(lanes=128)
    net = random_net(TINY, 70, scale=20.0)
    bits = fastlib.GeneratorBits(71, "cpu")
    st = ntrain.init_train_state(cfg, bits)
    ends = 0
    for step in range(40):
        before = net.weights.view(-1).clone()
        boards = st.env_state.boards.T.long()
        prev = st.lanes.prev_after.T.long()
        pv, pt = st.lanes.prev_valid, st.lanes.prev_terminal
        st2 = ntrain.train_step(cfg, net, st, bits)
        want = ref.td_step(before, TINY, boards, prev, pv, pt, 0.1,
                           action=st2.actions.long())
        assert gap(st2.values, want["values"]) < REL
        assert gap(st2.v_prev, want["v_prev"]) < REL
        clear = clear_lanes(want)
        assert torch.equal(st2.actions.long()[clear],
                           want["greedy"][clear])
        written = want["written"] | (net.weights.view(-1) != before)
        assert gap(net.weights.view(-1)[written], before[written]) < REL
        assert torch.equal(st2.lanes.prev_after.T.long(), want["chosen"])
        assert bool(st2.lanes.prev_valid.all())
        ends += int(st2.lanes.prev_terminal.sum())
        st = st2
    assert ends > 0  # games ended, and the next step's targets were 0
    assert int(st.env_steps) == 40 * 128
    assert int(st.episodes_done) == ends


def test_chunks_run_eager_off_the_card():
    cfg = config()
    net = model.NTupleNetwork(TINY)
    bits = fastlib.GeneratorBits(1, "cpu")
    assert ntrain.eager_reason(net, bits) == "device"

    class Proxy(fastlib.GeneratorBits):
        pass

    assert ntrain.eager_reason(net, Proxy(1, "cpu")) == "sources"
    before = (ntrain.train_chunk.eager_steps, ntrain.train_chunk.graph_steps,
              ntrain.train_chunk.captures)
    st = ntrain.init_train_state(cfg, bits)
    st = ntrain.train_chunk(cfg, net, st, bits)
    assert (ntrain.train_chunk.eager_steps - before[0],
            ntrain.train_chunk.graph_steps - before[1],
            ntrain.train_chunk.captures - before[2]) == (8, 0, 0)
    # A chunk is its steps: the same seeds by hand give the same state.
    net2, bits2 = model.NTupleNetwork(TINY), fastlib.GeneratorBits(1, "cpu")
    st2 = ntrain.init_train_state(cfg, bits2)
    for _ in range(8):
        st2 = ntrain.train_step(cfg, net2, st2, bits2)
    assert torch.equal(st.env_state.boards, st2.env_state.boards)
    assert torch.allclose(net.weights, net2.weights)


def test_train_learns_and_saves(tmp_path):
    cfg = dataclasses.replace(config(lanes=32, steps=32), total_episodes=32)
    rows = []
    ntrain.train(cfg, "cpu", log_fn=rows.append,
                 save_path=str(tmp_path / "w.npz"))
    assert rows and rows[-1]["episodes"] >= 32
    assert rows[-1]["env_steps"] == len(rows) * 32 * 32
    saved = model.NTupleNetwork.load(str(tmp_path / "w.npz"))
    assert saved.patterns == TINY and bool(saved.weights.abs().sum() > 0)


def test_train_ntuple_and_eval_from_the_command_line(tmp_path, capsys):
    path = str(tmp_path / "w.npz")
    assert cli_main(["train", "ntuple", "--cpu", "--lanes", "8",
                     "--episodes", "2", "--steps-per-chunk", "64",
                     "--save", path, "--log",
                     str(tmp_path / "m.jsonl")]) == 0
    assert Path(path).exists() and (tmp_path / "m.jsonl").read_text()
    capsys.readouterr()
    assert cli_main(["eval", "--policy", "ntuple", "--weights", path,
                     "--cpu", "--games", "4", "--eval-batch", "4"]) == 0
    out = capsys.readouterr().out
    assert '"num_games": 4' in out or '"games": 4' in out
    assert cli_main(["eval", "--policy", "ntuple", "--cpu"]) == 2


def test_greedy_eval_policy_is_the_reference_choice():
    net = random_net(TINY, 80, scale=10.0)
    policy = ev.greedy_ntuple_policy(net)
    boards = random_boards(256, 81)
    legal = torch.stack([(a != boards).any(1)
                         for a in ref.afterstates(boards)[0]]).T
    got = policy(boards.to(torch.int8).view(-1, 4, 4), legal)
    assert got.dtype == torch.int32
    want = ref.td_step(net.weights.view(-1).clone(), TINY, boards, boards,
                       torch.zeros(256, dtype=torch.bool),
                       torch.zeros(256, dtype=torch.bool), 0.1)
    clear = clear_lanes(want)
    assert torch.equal(got.long()[clear], want["greedy"][clear])
    result = ev.evaluate(policy, num_games=8, bits=fastlib.GeneratorBits(
        3, "cpu"), env_config=ev.EnvConfig(auto_reset=False), batch_size=8,
        max_steps=2000, engine="fast")
    assert len(result.scores) == 8 and result.lengths.min() > 0


# -- the reference itself --------------------------------------------------

def test_benchmark_reference_is_this_reference():
    ours = Path(ref.__file__).read_bytes()
    theirs = (ROOT / "benchmark" / "reference" / "ntuple.py").read_bytes()
    assert ours == theirs


def test_reference_imports_only_torch():
    text = Path(ref.__file__).read_text()
    imports = [line for line in text.splitlines()
               if line.startswith(("import ", "from "))]
    assert imports == ["from __future__ import annotations", "import torch"]


def test_reference_slide_is_the_game():
    """The reference's slide against the four-line rules written out:
    merges nearest the wall first, a merged tile does not merge again."""
    cases = {(1, 1, 1, 1): ((2, 2, 0, 0), 8), (0, 2, 2, 2): ((3, 2, 0, 0), 8),
             (3, 0, 3, 3): ((4, 3, 0, 0), 16), (1, 2, 3, 4): ((1, 2, 3, 4), 0),
             (0, 0, 0, 5): ((5, 0, 0, 0), 0), (2, 2, 3, 3): ((3, 4, 0, 0), 24)}
    lines = torch.tensor(list(cases))
    out, reward = ref.slide_left(lines)
    assert out.tolist() == [list(v[0]) for v in cases.values()]
    assert reward.tolist() == [v[1] for v in cases.values()]
    assert np.array_equal(ref.afterstates(torch.zeros(1, 16, dtype=torch.int64)
                                          )[2].numpy(), np.zeros((4, 1), bool))
