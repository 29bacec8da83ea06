"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full power limit of 700 W), and the card's 32-bit integer
rate: compute capability 9.0 issues 64 integer adds, compares, logic
operations and shifts a clock on each SM (CUDA C++ Programming Guide,
throughput of arithmetic instructions)."""

from __future__ import annotations

import subprocess

BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
INT32_RESULTS_PER_CLOCK_PER_SM = 64


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return float(out.splitlines()[0].split()[0]) * 1e6


def int_ops_per_s(sm_count: int, clock_hz: float) -> float:
    """32-bit integer operations a second: 1.67e13 on an H100 SXM's 132
    SMs at 1,980 MHz."""
    return INT32_RESULTS_PER_CLOCK_PER_SM * sm_count * clock_hz
