"""The cell added with the expectimax configuration,
``ntuple_eval_expectimax``, at test sizes on the CPU (two patterns of three cells, depth 2, a small
fill): it comes out correct against the plain reference, and the control
and each fault planted in the reference come out not correct. The
reference is held to a board computed by hand, the work counts to a
brute-force recursion, and the two readers to hand counts on a synthetic
trace."""

import json
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import core, harness
from benchmark.counts import search_work as W
from benchmark.counts import peaks
from benchmark.reference import ntuple as nref
from benchmark.reference import ntuple_expectimax as xref
from benchmark.tests import tiny
from benchmark.trace import Summary

SEED = 2**31 + 2603
CELL = "ntuple_eval_expectimax"
SIZES = {
    ("configs", "ntuple_4x6_expectimax3"): dict(
        patterns=[[0, 1, 2], [4, 5, 6]], depth=2),
    ("traffic", "eval_ntuple_expectimax_512"): dict(
        games=8, batch=8, max_steps=64, check_steps=2,
        fill=dict(lanes=64, steps_per_chunk=16, warm_lane_steps=64 * 16 * 20,
                  check_steps=1)),
    # A traced call of 32 steps, every step counted.
    ("workloads", CELL): dict(q_positions=32, value_steps=24,
                              trace=dict(steps=31, chunks=2, chunk_steps=16)),
}
# One empty cell (cell 15). Right and down are legal, each with no merge.
# Right leaves cell 12 empty: a 2 there lets up and down merge two 2s (4
# points each), a 4 there leaves no legal move. Down leaves cell 3 empty,
# and either tile there leaves no legal move.
HAND = [1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 4, 5, 6, 7, 0]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make(tmp_path_factory.mktemp("bench"))
    for (kind, name), changes in SIZES.items():
        path = root / "benchmark" / kind / f"{name}.json"
        data = json.loads(path.read_text())
        data.update(changes)
        path.write_text(json.dumps(data))
    return root


def _run(root, trace=False, control=False, seconds=0.3):
    return harness.run_cell(core.Cell(CELL, root), SEED, seconds, trace,
                            "cpu", control=control)


def _fails(checks):
    return not core.passes([(k, c["value"], c["limit"])
                            for k, c in checks.items()])


@pytest.mark.parametrize("c", [0.0, 0.25])
def test_reference_on_a_board_computed_by_hand(c):
    """Every weight ``c``: V is 16 c (two patterns under 8 symmetries).
    Right: 0.9 * (4 + 16 c) + 0.1 * 0; down: 0 (both children dead)."""
    patterns = [[0, 1, 2], [4, 5, 6]]
    weights = torch.full((2 * 16 ** 3,), c)
    out = xref.search(weights, patterns, torch.tensor([HAND]), 2)
    v = out["values"][:, 0]
    assert torch.isinf(v[0]) and torch.isinf(v[1]) and v[0] < 0
    assert float(v[2]) == pytest.approx(0.9 * (4 + 16 * c), rel=1e-6)
    assert float(v[3]) == 0.0
    assert out["action"].tolist() == [2] and out["leaves"].tolist() == [2]


# -- the work counts --------------------------------------------------------

def _slide(line):
    tiles = [x for x in line if x]
    out, score, i = [], 0, 0
    while i < len(tiles):
        if i + 1 < len(tiles) and tiles[i] == tiles[i + 1]:
            out.append(tiles[i] + 1)
            score += 2 ** (tiles[i] + 1)
            i += 2
        else:
            out.append(tiles[i])
            i += 1
    return out + [0] * (4 - len(out)), score


def _after(board, d):
    out = list(board)
    for cells in nref.LINES[d]:
        moved, _ = _slide([board[c] for c in cells])
        for c, x in zip(cells, moved):
            out[c] = x
    return out


def _brute(board, depth):
    """Every leaf afterstate of one board's tree, by recursion."""
    found = []
    for d in range(4):
        after = _after(board, d)
        if after == board:
            continue
        if depth == 1:
            found.append(tuple(after))
            continue
        for cell in range(16):
            if after[cell] == 0:
                for tile in (1, 2):
                    child = list(after)
                    child[cell] = tile
                    found += _brute(child, depth - 1)
    return found


BOARDS = [HAND, [1, 1, 0, 0] + [0] * 12,
          [5, 8, 0, 6, 8, 1, 4, 5, 6, 4, 2, 8, 7, 5, 7, 6],
          [2, 2, 3, 3, 0, 1, 0, 4, 1, 0, 0, 5, 6, 7, 0, 9]]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_leaf_counts_against_a_brute_force_recursion(depth):
    boards = BOARDS if depth < 3 else BOARDS[:1] + BOARDS[2:]
    roots = torch.tensor(boards)
    patterns = [[0, 1, 2], [4, 5, 6]]
    work = W.step_work(roots, patterns, depth, roots_per_block=2)
    found = [_brute(b, depth) for b in boards]
    assert work["leaves"] == sum(len(f) for f in found)
    assert work["distinct_leaves"] == sum(len(set(f)) for f in found)
    read = {int(i) for f in found for leaf in set(f)
            for p, cells in nref.lookups(patterns)
            for i in nref.index(torch.tensor([leaf]), p, cells, 3)}
    assert work["distinct_weights"] == len(read)
    want = xref.search(torch.zeros(2 * 16 ** 3), patterns, roots, depth)
    assert want["leaves"].tolist() == [len(f) for f in found]


def test_least_time_names_its_term():
    assert W.least_s(3.35e12, 0) == (1.0, "bytes")
    assert W.least_s(0, 33.5e12) == (1.0, "operations")
    assert W.search_bytes(10, 100) == 10 * 36 + 400
    assert W.search_ops(7, 32) == 224
    name = ("(anonymous namespace)::expectimax_unit_kernel(signed char "
            "const*, float const*)")
    assert W.is_search(name) and W.is_search("expectimax_root_kernel(int)")
    assert not W.is_search("afterstate_kernel(int)")


def _event(name, start, end, device=DeviceType.CPU):
    return SimpleNamespace(name=name, id=0, thread=1, device_type=device,
                           is_user_annotation=False,
                           time_range=SimpleNamespace(start=start, end=end))


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_search_readers_on_a_synthetic_trace():
    """Two steps of two search kernels each; the roofline times the counted
    step (the second) alone, the leaves' reader all four."""
    unit = "expectimax_unit_kernel(signed char const*)"
    root = "(anonymous namespace)::expectimax_root_kernel(int)"
    events = [_event(unit, 50, 70, DeviceType.CUDA),
              _event(root, 70, 75, DeviceType.CUDA),
              _event(unit, 0, 30, DeviceType.CUDA),
              _event(root, 30, 40, DeviceType.CUDA),
              _event("afterstate_kernel(int)", 80, 90, DeviceType.CUDA)]
    counts = dict(plain_s=0.5, plain_pace=2, pace=2, search_leaves=4000,
                  search_steps=[1], search_bytes=10 ** 6,
                  search_ops=10 ** 8)
    s = Summary(_Prof(events), 1.0, (), counts)
    roofline = core.load_module(core.BENCH / "metrics"
                                / "search.leaf_roofline.py").read
    per_leaf = core.load_module(core.BENCH / "metrics"
                                / "search.ns_per_leaf.py").read
    least = max(10 ** 6 / peaks.HBM_BYTES_PER_S, 10 ** 8 / 33.5e12)
    assert roofline(s) == pytest.approx(100 * least / 25e-6)
    assert per_leaf(s) == pytest.approx(65e-6 * 1e9 / 4000)
    other = Summary(_Prof(events), 1.0, (), dict(plain_s=0.5, plain_pace=2,
                                                 pace=2))
    assert roofline(other) is None and per_leaf(other) is None
    # A kernel missing from the trace: the steps cannot be told apart.
    short = Summary(_Prof(events[1:]), 1.0, (), counts)
    assert roofline(short) is None


@pytest.mark.parametrize("n, chunks, size, want", [
    (10, 2, 8, list(range(10))),
    (100, 3, 4, [0, 1, 2, 3, 48, 49, 50, 51, 96, 97, 98, 99]),
    (4032, 4, 32, None)])
def test_counted_steps_spread_over_the_call(n, chunks, size, want):
    spread = core.load_module(core.BENCH / "drivers"
                              / "eval_ntuple_search.py")._spread
    got = spread(n, chunks, size)
    if want is not None:
        assert got == want
    assert len(got) == min(n, chunks * size) == len(set(got))
    assert got[0] == 0 and got[-1] == n - 1


# -- the cell ---------------------------------------------------------------

def test_cell_is_correct_and_its_control_and_faults_are_not(root):
    line = _run(root, control=True)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"env_steps_per_s", "setup_s"}
    assert 0 < line["window"]["live_share"] <= 1
    assert line["window"]["leaves"] > 0
    assert _fails(line["control"]), line["control"]
    for key in ("fault.p4_half", "fault.shallow"):
        assert _fails(line[key]), (key, line[key])
    assert line["fault.shallow"]["leaf_mismatch"]["value"] > 0


def test_traced_run_is_correct_and_counts_the_trees(root):
    line = _run(root, trace=True)
    assert line["correct"], line["checks"]
    window = line["window"]
    assert window["counted_steps"] == window["steps"] == 32
    assert window["program_leaves"] == window["enumerated_leaves"] > 0
    assert 0 < window["distinct_leaves"] <= window["enumerated_leaves"]
    assert window["roofline_bound"] in ("bytes", "operations")
    # The CPU has no card: the device metrics read nothing.
    assert line["metrics"] == {}


def test_games_cut_short_stand_as_their_last_step_left_them(root):
    """A traced call's 32 steps end no game: each lane's result is the
    board after its last step, whose largest tile the last step may have
    made (48 lanes, so that some did)."""
    path = root / "benchmark" / "traffic" / "eval_ntuple_expectimax_512.json"
    saved = path.read_text()
    path.write_text(json.dumps(dict(json.loads(saved), games=48, batch=48)))
    try:
        line = _run(root, trace=True)
    finally:
        path.write_text(saved)
    assert line["window"]["live_share"] == 1.0
    assert line["correct"], line["checks"]


def _stale_action(monkeypatch):
    from tpu2048_torch.agents import ntuple as agent

    search = agent.expectimax_actions

    def broken(net, boards, depth):
        return (search(net, boards, depth) + 1) % 4

    monkeypatch.setattr(agent, "expectimax_actions", broken)


def _greedy_in_place(monkeypatch):
    from tpu2048_torch.agents import ntuple as agent

    monkeypatch.setattr(agent, "expectimax_actions",
                        lambda net, boards, depth: agent.greedy_actions(
                            net, boards))


def _leaves_uncounted(monkeypatch):
    from tpu2048_torch.ops import ntuple_kernel as nk

    search = nk.search_values

    def broken(boards, weights, maps, depth):
        before = nk.leaf_counter(boards.device).clone()
        out = search(boards, weights, maps, depth)
        nk.leaf_counter(boards.device).copy_(before)
        return out

    monkeypatch.setattr(nk, "search_values", broken)


def _values_off_on_the_timed_path(monkeypatch):
    """The search's values are off where it runs at the traffic's batch
    (8 lanes), and right on other batches."""
    from tpu2048_torch.ops import ntuple_kernel as nk

    search = nk.search_values

    def broken(boards, weights, maps, depth):
        out = search(boards, weights, maps, depth)
        if boards.shape[1] == 8:
            out = nk.Search(values=out.values * 1.01, action=out.action)
        return out

    monkeypatch.setattr(nk, "search_values", broken)


def _fill_left_still(monkeypatch):
    from tpu2048_torch.ops import ntuple_kernel as nk

    monkeypatch.setattr(nk, "td_update_", lambda *args, **kw: None)


@pytest.mark.parametrize("fault", [_stale_action, _greedy_in_place,
                                   _leaves_uncounted,
                                   _values_off_on_the_timed_path,
                                   _fill_left_still],
                         ids=lambda f: f.__name__[1:])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    line = _run(root)
    assert not line["correct"], line["checks"]


def test_a_port_without_the_search_fails_before_the_fill(root, monkeypatch):
    from tpu2048_torch.eval import evaluate as ev
    from tpu2048_torch.training import ntuple as ntrain

    monkeypatch.delattr(ev, "expectimax_ntuple_policy")
    monkeypatch.setattr(ntrain, "train_chunk", None)  # the fill never runs
    with pytest.raises(ImportError):
        _run(root)
