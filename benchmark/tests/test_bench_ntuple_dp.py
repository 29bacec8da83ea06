"""The two cells added with the n-tuple configuration, at test sizes on the
CPU: ``ntuple_train`` (the 4x6-tuple trainer, at two patterns of three
cells) and ``dqn_train_dp4`` (four gloo ranks on the CPU in place of four
cards). Each comes out correct against the plain reference; the control,
each fault planted in the reference and each fault of the timed path come
out not correct. The byte counts of the n-tuple kernels and the four new
readers are held to hand counts on synthetic traces."""

import json
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import core, harness
from benchmark.counts import ntuple_bytes as N
from benchmark.counts import peaks
from benchmark.tests import tiny
from benchmark.trace import Summary

SEED = 2**31 + 1201
SIZES = {
    ("configs", "ntuple_4x6_td"): dict(patterns=[[0, 1, 2], [4, 5, 6]]),
    ("traffic", "train_ntuple_8192"): dict(
        lanes=64, steps_per_chunk=16, warm_lane_steps=64 * 16 * 20,
        check_steps=8),
    ("workloads", "ntuple_train"): dict(trace=dict(steps=4)),
    ("traffic", "train_dqn_dp4"): dict(
        envs_per_rank=8, batch_per_rank=8, updates_per_episode=4,
        max_updates_per_step=8, steps_per_chunk=4),
    # The network at test sizes reads larger gaps, as tiny.py says of
    # dqn_train's.
    ("workloads", "dqn_train_dp4"): dict(
        setup_max_chunks=200,
        limits=dict(loss_gap=1e-3, td_gap=0.005, grad_norm_gap=0.3,
                    update_norm_gap=0.6),
        trace=dict(min_vector_steps=2, min_updates=4, max_vector_steps=8)),
}


# ``dqn_train_dp4`` waits outside BENCHMARK.json until its runs spread
# less than half its bound; the tests add it, and the metric that only it
# reports, to their copy.
WAITING = dict(
    workloads=[dict(
        name="dqn_train_dp4", config="dqn_cnn_ref", traffic="train_dqn_dp4",
        chips=4, why="train dqn over 4 ranks of one card each, NCCL")],
    end_to_end=dict(updates_per_s=["dqn_train_dp4"]),
    per_layer=[dict(
        name="dp.allreduce_share", unit="%", better="lower",
        source="device_trace", layer="data parallel: parallel/mesh.py",
        moves="updates_per_s", workloads=["dqn_train_dp4"])])


def _add_waiting(path):
    manifest = json.loads(path.read_text())
    manifest["workloads"] += WAITING["workloads"]
    manifest["per_layer"] += WAITING["per_layer"]
    for metric in manifest["end_to_end"]:
        metric.get("workloads", []).extend(
            WAITING["end_to_end"].get(metric["name"], []))
    path.write_text(json.dumps(manifest))


def _reader(name):
    return core.load_module(core.BENCH / "metrics" / f"{name}.py")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make(tmp_path_factory.mktemp("bench"))
    _add_waiting(root / "BENCHMARK.json")
    for (kind, name), changes in SIZES.items():
        path = root / "benchmark" / kind / f"{name}.json"
        data = json.loads(path.read_text())
        data.update(changes)
        path.write_text(json.dumps(data))
    return root


def _run(root, name, trace=False, control=False, seconds=0.3):
    return harness.run_cell(core.Cell(name, root), SEED, seconds, trace,
                            "cpu", control=control)


def _fails(checks):
    return not core.passes([(k, c["value"], c["limit"])
                            for k, c in checks.items()])


@pytest.mark.parametrize("name", ["ntuple_train", "dqn_train_dp4"])
def test_new_cell_is_correct_and_its_control_and_faults_are_not(root, name):
    line = _run(root, name, control=True)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert _fails(line["control"]), line["control"]
    faults = [k for k in line if k.startswith("fault.")]
    assert faults
    for key in faults:
        assert _fails(line[key]), (key, line[key])


@pytest.mark.parametrize("name", ["ntuple_train", "dqn_train_dp4"])
def test_new_cell_traced_run_is_correct(root, name):
    line = _run(root, name, trace=True)
    assert line["correct"], line["checks"]
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # The CPU has no card: the device metrics read nothing.
    assert line["metrics"] == {}


def _update_left_out(monkeypatch):
    from tpu2048_torch.ops import ntuple_kernel as nk

    monkeypatch.setattr(nk, "td_update_", lambda weights, *a, **k: weights)


def _one_symmetry_left_out(monkeypatch):
    from tpu2048_torch.models import ntuple as model

    maps = model.index_maps

    def seven(patterns):
        m = maps(patterns)
        m[7::8] = m[6::8]  # the last symmetry reads the one before it
        return m

    monkeypatch.setattr(model, "index_maps", seven)


def _terminal_left_out(monkeypatch):
    from tpu2048_torch.ops import ntuple_kernel as nk

    values = nk.afterstate_values

    def broken(boards, prev_after, prev_valid, prev_terminal, *a):
        return values(boards, prev_after, prev_valid,
                      torch.zeros_like(prev_terminal), *a)

    monkeypatch.setattr(nk, "afterstate_values", broken)


def _env_answer_altered(monkeypatch):
    from tpu2048_torch.ops import step_kernel as sk

    step = sk.fused_env_step

    def broken(boards, *args, **kw):
        out = list(step(boards, *args, **kw))
        out[0] = out[0].clone()
        out[0][0, 0] = out[0][0, 0] + 1
        return tuple(out)

    monkeypatch.setattr(sk, "fused_env_step", broken)


FAULTS = [
    ("ntuple_train", _update_left_out),
    ("ntuple_train", _one_symmetry_left_out),
    ("ntuple_train", _terminal_left_out),
    ("ntuple_train", _env_answer_altered),
]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, name, fault):
    fault(monkeypatch)
    line = _run(root, name)
    assert not line["correct"], line["checks"]


def test_ntuple_byte_counts_by_hand():
    # A lane: board and previous afterstate (32), two flags (2), four
    # afterstates (64), rewards, values (32), legality (4), V(prev),
    # action, target (12), the chosen afterstate (16).
    assert N.VALUE_LANE_BYTES == 32 + 2 + 64 + 32 + 4 + 12 + 16
    assert N.value_bytes(10, 30, 10, 32) == 10 * 162 + 40 * 32 * 4
    # Each lane's flag; an updated lane's board, value and target, and
    # 24 bytes a lookup (the weight 8, the count 16).
    assert N.update_bytes(10, 8, 32) == 10 + 8 * (24 + 32 * 24)
    assert N.bound_s(3_350_000_000) == pytest.approx(1e-3)
    name = ("(anonymous namespace)::afterstate_kernel(signed char const*, "
            "signed char const*)")
    assert N.is_value(name) and not N.is_update(name)
    assert N.is_update("td_update_kernel(float*, int*)")
    assert not N.is_value("my_afterstate_kernel(int)")


def _event(name, start, end, device=DeviceType.CPU, annotation=False):
    return SimpleNamespace(name=name, id=0, thread=1, device_type=device,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _summary(events, spans, **counts):
    counts = dict(dict(plain_s=0.5, plain_pace=2, pace=2), **counts)
    return Summary(_Prof(events), 1.0, spans, counts)


def test_ntuple_readers_on_a_synthetic_trace():
    """Two steps: the first eager (a span with three launches), the second
    a replay (one graph launch); the kernels' device times in us."""
    events = [
        _event("ntuple.step", 0, 10, annotation=True),
        _event("cudaLaunchKernel", 1, 1.1),
        _event("cudaLaunchKernel", 2, 2.1),
        _event("cudaMemsetAsync", 3, 3.1),
        _event("ntuple.step", 20, 30, annotation=True),
        _event("cudaGraphLaunch", 21, 22),
        _event("cudaLaunchKernel", 40, 40.1),  # outside the steps
        _event("afterstate_kernel(signed char const*)", 5, 25,
               DeviceType.CUDA),
        _event("(anonymous namespace)::td_update_kernel(float*)", 30, 40,
               DeviceType.CUDA),
    ]
    counts = dict(steps=2, lane_steps=2048, legal_moves=6000,
                  prev_lanes=2048, lookups=32)
    s = _summary(events, ("ntuple.step",), **counts)
    value = N.value_bytes(2048, 6000, 2048, 32) / peaks.HBM_BYTES_PER_S
    update = N.update_bytes(2048, 2048, 32) / peaks.HBM_BYTES_PER_S
    assert _reader("ntuple.value_roofline").read(s) == pytest.approx(
        100 * value / 20e-6)
    assert _reader("ntuple.update_roofline").read(s) == pytest.approx(
        100 * update / 10e-6)
    assert _reader("ntuple.host_launches_per_step").read(s) == 4 / 2
    other = _summary(events, ("ntuple.step",), steps=2, updates=2)
    for name in ("ntuple.value_roofline", "ntuple.update_roofline",
                 "ntuple.host_launches_per_step"):
        assert _reader(name).read(other) is None


def test_allreduce_share_on_a_synthetic_trace():
    events = [
        _event("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)",
               0, 30, DeviceType.CUDA),
        _event("ncclKernel_AllReduce_RING_LL_Sum_long(ncclWork*)", 40, 50,
               DeviceType.CUDA),
        _event("gemm_kernel", 50, 90, DeviceType.CUDA),
    ]
    read = _reader("dp.allreduce_share").read
    # 40 us of NCCL kernels over the untraced part: 0.5 s for the two
    # units of pace it made, and two traced.
    s = _summary(events, (), ranks=4)
    assert read(s) == pytest.approx(100 * 40e-6 / 0.5)
    assert read(_summary(events[2:], (), ranks=4)) is None
    assert read(_summary(events, ())) is None
