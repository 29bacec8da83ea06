"""cuDNN's layout conversions around the DQN network's convolutions, on a
CUDA card (skipped without one).

The network hands every convolution channels-last activations and
channels-last weights (:mod:`tpu2048_torch.models.dqn`), the layout that
cuDNN's kernels compute in, whatever the strides of the boards (the env
hands over a view of its cell-major lanes). So no kernel that converts
between NCHW and NHWC (named ``nchwToNhwc`` or ``nhwcToNchw``) runs in a
greedy forward at batch 512 or in a replayed learner update at batch 64,
both at full width in bf16. The count of such kernels is printed with the
count of all.

This file imports nothing of JAX, so it runs on a machine with the card
and no JAX: ``python -m pytest --noconftest -p no:cacheprovider -s
tests/test_torch_dqn_layout.py``.
"""

import json

import pytest
import torch

from tpu2048_torch import bench
from tpu2048_torch.agents import dqn as dqnlib
from tpu2048_torch.models import dqn as dqn_model
from tpu2048_torch.ops.step_kernel import from_cell_major

CONVERSIONS = ("nchwToNhwc", "nhwcToNchw")


def device_kernels(fn, path):
    """The names of the kernels that one call of ``fn`` ran on the card,
    from the profiler's trace written to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel"]


def greedy_forward(device):
    """A greedy forward at batch 512, as the eval's policy calls it: on
    boards that are a view of the env's cell-major lanes."""
    model = dqn_model.create_model(dqnlib.DQNConfig(), device)
    dqn_model.init_params(model, torch.Generator(device).manual_seed(0))
    model.eval()
    boards = from_cell_major(torch.randint(
        0, 12, (16, 512), dtype=torch.int8,
        generator=torch.Generator(device).manual_seed(1), device=device))

    def forward():
        with torch.inference_mode():
            model(boards)

    forward()
    return forward


def learner_update(device):
    """A learner update at batch 64, replayed from its CUDA graph."""
    state, update = bench.learner_update(dqnlib.DQNConfig(memory_size=4096),
                                         64, device)
    for _ in range(3):
        update()
    assert state.learner.graph_steps > 0, "the update did not replay"
    return update


@pytest.mark.card
@pytest.mark.parametrize("path", [greedy_forward, learner_update],
                         ids=["greedy_forward_512", "learner_update_64"])
def test_no_layout_conversion_runs_around_a_convolution(path, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    names = device_kernels(path(torch.device("cuda")),
                           tmp_path / "trace.json")
    conversions = [n for n in names if any(c in n for c in CONVERSIONS)]
    print(f"{path.__name__}: {len(names)} kernels, {len(conversions)} "
          f"layout conversions")
    assert names, "the profiler saw no kernel"
    assert conversions == []
