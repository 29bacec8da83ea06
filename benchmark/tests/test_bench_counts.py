"""The yardstick's arithmetic against hand counts."""

import pytest

from benchmark.counts import flops, peaks, step_ops, table_bytes

FULL = dict(features=2048, hidden=1024, num_blocks=3, actions=4)


def test_forward_flops_at_full_width():
    assert flops.dqn_forward(FULL) == 2_088_247_296


def test_update_flops_are_four_forwards_a_board():
    assert flops.dqn_update(FULL, 64) == 4 * 64 * 2_088_247_296


@pytest.mark.parametrize("features,hidden,blocks", [(16, 32, 1), (64, 8, 2)])
def test_forward_flops_by_hand(features, hidden, blocks):
    cfg = dict(features=features, hidden=hidden, num_blocks=blocks,
               actions=4)
    conv = 0
    for i in range(blocks):
        cin = 16 if i == 0 else features
        conv += sum(2 * 16 * k * k * cin * (features // 4)
                    for k in (1, 2, 3, 4))
    assert flops.dqn_forward(cfg) == (conv + 2 * 16 * features * hidden
                                      + 2 * hidden * 4)


def test_step_kernel_ops():
    assert step_ops.step_kernel_ops(10, 7, 2, False) == (
        10 * 916 + 7 * 116 + 2 * 76)
    assert step_ops.step_kernel_ops(10, 0, 0, True) == 10 * (916 + 352)


def test_bucket_bytes_match_the_kernel_table():
    # PERF.md's bound of a 1024-row gather: 3.14e-4 ms at 3.35e12 B/s.
    ms = table_bytes.bucket_call_bytes(1024) / peaks.HBM_BYTES_PER_S * 1e3
    assert ms == pytest.approx(3.14e-4, rel=0.01)


def test_integer_peak_of_an_h100():
    assert peaks.int_ops_per_s(132, 1.98e9) == pytest.approx(1.673e13,
                                                             rel=1e-3)
