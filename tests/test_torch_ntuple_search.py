"""Depth-D expectimax over the n-tuple network: the search kernels' plain
version (``ops/ntuple_kernel.py::search_values`` on CPU tensors, depths 2
and 3), the agent's ``expectimax_actions``, the eval policy (depth 1 is the
greedy policy) and ``eval --search-depth``, held on the CPU to the plain
reference ``tests/expectimax_reference.py`` on seeded random weights at 4
patterns of 4 cells (65,536 weights a pattern).

The port and the reference sum a board's lookups, and a chance node's
children, in different orders, so values agree to float32 rounding: 1e-4
of the larger of 1 and the value, as ``test_torch_ntuple.py`` holds the
afterstate values (random weights of either sign cancel, and a sum's
rounding follows its terms, not the sum; the readings here are under 2e-6).
An action is compared where the reference's two best moves lie further
apart than ten times that; elsewhere it must lie within that of the best
(the mirrored moves of a two-tile board tie exactly). Integer results
(legality, the leaves counted) are exact.

The ``card`` case holds the kernels to the plain version on a CUDA card and
skips without one. This file imports nothing of JAX, so it runs on the
machine with the card: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_ntuple_search.py -m card``.
"""

from pathlib import Path

import pytest
import torch

import expectimax_reference as xref
import ntuple_reference as ref
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)
from tpu2048_torch.agents import ntuple as agent
from tpu2048_torch.cli.main import main as cli_main
from tpu2048_torch.env import fast as fastlib
from tpu2048_torch.eval import evaluate as ev
from tpu2048_torch.models import ntuple as model
from tpu2048_torch.ops import ntuple_kernel as nk
from tpu2048_torch.ops.step_kernel import to_cell_major

SMALL = ((0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 4, 5), (1, 2, 5, 6))
REL = 1e-4
ROOT = Path(__file__).resolve().parent.parent
# A board whose left move leaves cell 3 empty; a 2 there leaves no legal
# move, so a chance child below the root is terminal (M = 0).
DEAD_CHILD = [5, 8, 0, 6, 8, 1, 4, 5, 6, 4, 2, 8, 7, 5, 7, 6]


def random_net(patterns, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    k = len(patterns[0])
    w = torch.randn((len(patterns), 16 ** k), generator=g) * scale
    return model.NTupleNetwork(patterns, weights=w)


def _random(n, seed, top, empty_below):
    g = torch.Generator().manual_seed(seed)
    b = torch.randint(1, top, (n, 16), generator=g)
    b[torch.randint(0, top, (n, 16), generator=g) < empty_below] = 0
    return b


def _with_empties(n, seed, empties):
    """Random boards of tiles 1-11 with exactly ``empties`` empty cells."""
    g = torch.Generator().manual_seed(seed)
    b = torch.randint(1, 12, (n, 16), generator=g)
    for row in b:
        row[torch.randperm(16, generator=g)[:empties]] = 0
    return b


def _merge_only(n, seed):
    """Full boards (no empty cell) on which a move is legal: it merges."""
    g = torch.Generator().manual_seed(seed)
    b = torch.randint(1, 14, (n, 16), generator=g)
    b[:, 1] = b[:, 0]
    return b


BOARDS = {
    "one_empty": lambda: _with_empties(6, 1, 1),
    "fourteen_empty": lambda: _with_empties(3, 2, 14),
    "dead_child": lambda: torch.cat([torch.tensor([DEAD_CHILD]),
                                     _with_empties(3, 3, 2)]),
    "merge_only": lambda: _merge_only(6, 4),
    "mixed": lambda: _random(8, 5, 12, 4),
}


def cell_major(boards):
    return to_cell_major(boards.to(torch.int8).view(-1, 4, 4))


def gap(got, want):
    got, want = got.double(), want.double()
    same = torch.isinf(want) & (got == want)
    d = torch.where(same, 0.0, (got - want).abs() / want.abs().clamp_min(1))
    return float(d.max()) if d.numel() else 0.0


def clear_roots(values):
    """Roots whose two best moves (by the reference) lie further apart than
    the rounding of a value."""
    top = values.topk(2, dim=0).values
    return (top[0] - top[1]) / top[0].abs().clamp_min(1) > 10 * REL


def assert_choices(action, values, want):
    """Each chosen move lies within the rounding of the reference's best
    (two-tile boards tie mirrored moves exactly), and is the reference's
    where its two best moves lie apart."""
    action = action.long()
    best = values.max(0).values
    chosen = values.gather(0, action[None])[0]
    assert bool((chosen >= best - 10 * REL * best.abs().clamp_min(1)).all())
    clear = clear_roots(values)
    assert torch.equal(action[clear], want[clear])


def leaves_of(fn):
    counter = nk.leaf_counter("cpu")
    before = int(counter)
    out = fn()
    return out, int(counter) - before


def greedy_values(net, boards):
    """``(4, B)`` ``r + V(after)`` of each move (-inf where illegal) and the
    greedy actions, from the afterstate kernels' plain version: depth 1."""
    flags = torch.zeros(boards.shape[0], dtype=torch.bool)
    out = nk.afterstate_values(cell_major(boards), cell_major(boards), flags,
                               flags, net.weights, net.maps)
    q = torch.where(out.legal, out.reward.float() + out.values, -torch.inf)
    return nk.Search(values=q, action=out.action)


# -- the port against the reference -----------------------------------------

@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("kind", list(BOARDS))
def test_search_matches_the_reference(kind, depth):
    """Depth 1 is the greedy policy's values and the eval policy's actions;
    depths 2 and 3 the search, whose counter counts the reference's
    leaves."""
    net = random_net(SMALL, 10 + depth, scale=10.0)
    boards = BOARDS[kind]()
    want = xref.search(net.weights.view(-1), SMALL, boards, depth)
    if depth == 1:
        out = greedy_values(net, boards)
        b = boards.to(torch.int8).view(-1, 4, 4)
        policy = ev.expectimax_ntuple_policy(net, 1)
        assert torch.equal(policy(b, None), out.action)
    else:
        out, leaves = leaves_of(lambda: nk.search_values(
            cell_major(boards), net.weights, net.maps, depth))
        assert leaves == int(want["leaves"].sum())
        agent_out = agent.expectimax_search(
            net, boards.to(torch.int8).view(-1, 4, 4), depth)
        assert torch.equal(agent_out.values, out.values)
        assert torch.equal(agent_out.action, out.action)
    assert out.values.dtype == torch.float32
    assert torch.equal(torch.isinf(out.values), torch.isinf(want["values"]))
    assert gap(out.values, want["values"]) < REL
    assert_choices(out.action, want["values"], want["action"])
    assert out.action.dtype == torch.int32


def test_the_boards_show_what_they_are_for():
    """The dead child's tree holds a terminal chance node; the merge-only
    boards have no empty cell and a legal move; depth 3 on a near-empty
    board reaches the most leaves a tree can have below 4 x 30 x 4 x 30 x 4."""
    after, _, legal = ref.afterstates(torch.tensor([DEAD_CHILD]))
    child = after[0, 0].clone()
    assert bool(legal[0, 0]) and int((child == 0).sum()) == 1
    child[child == 0] = 1
    assert not ref.afterstates(child[None])[2].any()
    full = BOARDS["merge_only"]()
    assert bool((full != 0).all()) and bool(
        ref.afterstates(full)[2].any(0).all())
    few = BOARDS["fourteen_empty"]()
    assert int((few == 0).sum(1).min()) == 14
    leaves = xref.search(torch.zeros(4 * 16 ** 4), SMALL, few[:1], 3)
    assert 30_000 < int(leaves["leaves"][0]) <= 4 * 30 * 4 * 30 * 4


def test_depth_one_is_the_greedy_policy_bit_for_bit():
    """Depth 1 is the greedy policy itself, not a search that repeats it."""
    net = random_net(SMALL, 20, scale=10.0)
    boards = _random(256, 21, 12, 4).to(torch.int8).view(-1, 4, 4)
    one = ev.expectimax_ntuple_policy(net, 1)
    greedy = ev.greedy_ntuple_policy(net)
    assert one.fn is greedy.fn and one.params is net
    assert torch.equal(one(boards, None), agent.greedy_actions(net, boards))
    with pytest.raises(ValueError):
        agent.expectimax_actions(net, boards, 1)


def test_search_refuses_what_the_kernels_do_not_take():
    net = random_net(SMALL, 1)
    b = cell_major(_random(4, 2, 12, 4))
    for depth in (0, 1, 4):
        with pytest.raises(ValueError):
            nk.search_values(b, net.weights, net.maps, depth)
    with pytest.raises(ValueError):
        nk.search_values(b.to(torch.int32), net.weights, net.maps, 2)
    with pytest.raises(ValueError):
        nk.search_values(b, net.weights.double(), net.maps, 2)
    for depth in (0, 4):
        with pytest.raises(ValueError):
            ev.expectimax_ntuple_policy(net, depth)


# -- the normal path ----------------------------------------------------------

def _games(policy, seed=3):
    return ev.evaluate(policy, num_games=4, bits=fastlib.GeneratorBits(
        seed, "cpu"), env_config=ev.EnvConfig(auto_reset=False), batch_size=4,
        max_steps=40, engine="fast")


def test_eval_plays_the_search_and_depth_one_plays_greedy():
    net = random_net(SMALL, 30, scale=10.0)
    greedy = _games(ev.greedy_ntuple_policy(net))
    one = _games(ev.expectimax_ntuple_policy(net, 1))
    for field in ("scores", "max_tiles", "lengths", "action_counts"):
        assert (getattr(one, field) == getattr(greedy, field)).all()
    calls = []
    policy = ev.expectimax_ntuple_policy(net, 2)
    fn = policy.fn

    def recorded(params, boards, legal):
        actions = fn(params, boards, legal)
        calls.append((boards.reshape(-1, 16).long(), actions))
        return actions

    policy.fn = recorded
    two, leaves = leaves_of(lambda: _games(policy))
    assert two.lengths.min() > 0 and leaves > 0
    boards = torch.cat([b for b, _ in calls[:4]])
    actions = torch.cat([a for _, a in calls[:4]])
    want = xref.search(net.weights.view(-1), SMALL, boards, 2)
    assert_choices(actions, want["values"], want["action"])


def test_eval_search_depth_from_the_command_line(tmp_path, capsys):
    path = str(tmp_path / "w.npz")
    random_net(SMALL, 40, scale=10.0).save(path)
    args = ["eval", "--policy", "ntuple", "--weights", path, "--cpu",
            "--games", "4", "--eval-batch", "4"]
    assert cli_main(args + ["--search-depth", "2"]) == 0
    assert '"games": 4' in capsys.readouterr().out
    assert cli_main(args + ["--search-depth", "4"]) == 2
    assert cli_main(["eval", "--policy", "random", "--cpu",
                     "--search-depth", "2"]) == 2


# -- the reference itself ---------------------------------------------------

def test_reference_imports_only_torch_and_the_ntuple_reference():
    text = Path(xref.__file__).read_text()
    imports = [line for line in text.splitlines()
               if line.startswith(("import ", "from "))]
    assert imports == ["from __future__ import annotations", "import torch",
                       "import ntuple_reference as ref"]


def test_benchmark_reference_is_this_reference():
    """The benchmark's copy differs in its import of the n-tuple reference
    alone (the two n-tuple references are one file)."""
    ours = Path(xref.__file__).read_text().splitlines()
    theirs = (ROOT / "benchmark" / "reference" / "ntuple_expectimax.py"
              ).read_text().splitlines()
    differ = [(a, b) for a, b in zip(ours, theirs) if a != b]
    assert len(ours) == len(theirs)
    assert differ == [("import ntuple_reference as ref",
                       "from benchmark.reference import ntuple as ref")]


def test_reference_chance_nodes_weigh_the_spawn_law():
    """One empty cell, depth 2, zero weights: only merge scores count."""
    board = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 4, 5, 6, 7, 0]])
    out = xref.search(torch.zeros(4 * 16 ** 4), SMALL, board, 2)
    # Right leaves cell 12 empty: a 2 lets up and down merge (4 points), a
    # 4 leaves no move; down leaves cell 3 empty, and both children die.
    assert out["values"][2, 0] == pytest.approx(0.9 * 4)
    assert out["values"][3, 0] == 0.0
    assert out["leaves"].tolist() == [2]
    half = xref.search(torch.zeros(4 * 16 ** 4), SMALL, board, 2,
                       spawns=((1, 0.5), (2, 0.5)))
    assert half["values"][2, 0] == pytest.approx(0.5 * 4)


# -- the kernels on the card ------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_kernels_match_the_plain_version_on_the_card(depth):
    """Depths 2 and 3: the kernels against their plain version on the same
    card tensors. Depth 1: the eval policy is the greedy one, and the
    kernels refuse it."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(depth)
    net = model.NTupleNetwork(model.PATTERNS_4X6, dev)
    net.weights.normal_(generator=g).mul_(10.0)
    roots = _random(256, 7 + depth, 12, 4)
    boards = cell_major(roots).to(dev)
    if depth == 1:
        b = roots.to(torch.int8).view(-1, 4, 4).to(dev)
        assert torch.equal(ev.expectimax_ntuple_policy(net, 1)(b, None),
                           agent.greedy_actions(net, b))
        with pytest.raises(ValueError):
            nk.search_values(boards, net.weights, net.maps, 1)
        return
    counter = nk.leaf_counter(dev)
    before = int(counter)
    launches = nk.search_values.launches
    out = nk.search_values(boards, net.weights, net.maps, depth)
    leaves = int(counter) - before
    assert nk.search_values.launches - launches == 2
    plain, plain_leaves = nk.plain_search_values(boards, net.weights,
                                                 net.maps, depth)
    assert leaves == plain_leaves
    assert gap(out.values, plain.values) < REL
    assert_choices(out.action, plain.values, plain.action.long())
