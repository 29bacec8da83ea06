"""The n-tuple trainer's replayed steps against its eager steps on a CUDA
card.

``train_chunk`` replays one captured step where the bit source is exactly
the production generator; a subclass of it runs the same draws eagerly.
The TD update adds with float atomics, whose order, and so the last bit of
a sum, changes from run to run, so two runs drift apart by rounding and
then by near-tied choices. Each step is therefore held from one state:
before it, the eager side takes the replayed side's weights, lanes and
generator state; then the two sides' boards, actions, values and lanes
must be equal, and their weights equal to float32 rounding.

The test needs a card and skips without one. This file imports nothing of
JAX, so it runs on a machine with the card and no JAX:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_ntuple_graph.py``.
"""

import dataclasses

import pytest
import torch

from tpu2048_torch.agents import ntuple as agent
from tpu2048_torch.env import fast as fastlib
from tpu2048_torch.models.ntuple import PATTERNS_4X6, NTupleNetwork
from tpu2048_torch.ops import ntuple_kernel as nk
from tpu2048_torch.training import ntuple as ntrain

B, STEPS, SEED = 1024, 6, 9


class EagerBits(fastlib.GeneratorBits):
    """The production source under another type: its chunks run eager."""


@pytest.mark.card
def test_replayed_steps_equal_eager_steps():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    dev = torch.device("cuda")
    cfg = ntrain.NTupleTrainConfig(
        agent=agent.NTupleConfig(patterns=PATTERNS_4X6), batch_size=B,
        steps_per_chunk=2)
    one = dataclasses.replace(cfg, steps_per_chunk=1)
    g = torch.Generator(device=dev).manual_seed(SEED)
    net = NTupleNetwork(PATTERNS_4X6, dev)
    net.weights.normal_(generator=g).mul_(100.0)
    twin = NTupleNetwork(PATTERNS_4X6, dev)
    bits, eager_bits = (fastlib.GeneratorBits(SEED, dev),
                        EagerBits(SEED, dev))
    assert ntrain.eager_reason(twin, eager_bits) == "sources"
    st = ntrain.init_train_state(cfg, bits)
    captures = ntrain.train_chunk.captures
    st = ntrain.train_chunk(cfg, net, st, bits)  # one eager step, a capture
    assert ntrain.train_chunk.captures == captures + 1
    launches = (nk.afterstate_values.launches, nk.td_update_.launches)
    for _ in range(STEPS):
        twin.weights.copy_(net.weights)
        eager_bits.generator.set_state(bits.generator.get_state())
        start = dataclasses.replace(st)
        replayed = ntrain.train_chunk(one, net, st, bits)
        eager = ntrain.train_step(one, twin, start, eager_bits)
        for name in ("values", "v_prev", "actions", "episodes_done",
                     "env_steps", "sum_score", "best_tile"):
            assert torch.equal(getattr(replayed, name), getattr(eager, name))
        for part in ("env_state", "lanes"):
            a, b = getattr(replayed, part), getattr(eager, part)
            for f in dataclasses.fields(a):
                assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f
        scale = net.weights.abs().clamp_min(1)
        assert float(((net.weights - twin.weights).abs() / scale).max()) \
            < 1e-5
        assert torch.equal(bits.generator.get_state(),
                           eager_bits.generator.get_state())
        st = replayed
    # A replay counts its kernels' launches as the eager step does.
    assert nk.afterstate_values.launches - launches[0] == 2 * STEPS
    assert nk.td_update_.launches - launches[1] == 2 * 3 * STEPS
    assert int(net.counts.count_nonzero()) == 0
