"""Start-up check of the PyTorch/CUDA port (``tpu2048_torch``) on one GPU.

Run from the root of the repository, on a machine with one CUDA card and
the CUDA toolkit::

    python3 chip_smoke.py

Every phase is fatal on failure; without a card, or outside the repository,
it exits non-zero and prints no result. ``python3 chip_smoke.py
--table-timing ROOT`` runs only phase 9 on the table kernels of the checkout
at ``ROOT`` (for example an unpacked parent commit), and ``python3
chip_smoke.py --step-timing ROOT`` only phase 5 on its step kernel and
phase 12's rows and host split on its rollout kernel, so that two versions
can be timed in one run on one card. ``python3 chip_smoke.py --ntuple``
runs phases 1, 2 and 21 alone, ``--search`` phases 1, 2 and 22.

1. The card's name, power limit and maximum SM clock, the torch and CUDA
   versions, and the 32-bit integer peak that the bounds use.
2. Build the kernels from ``tpu2048_torch/csrc`` with nvcc (sm_90a), one
   nvcc for each source, started together; print the seconds and ptxas's
   resource usage.
3. Hold the kernel against ``plain_env_step`` on the card: B in {1, 128,
   512, 1000, 4096, 65536}, simple and shaped modes, every emit-flag
   combination, 32-step trajectories fed back into themselves, actions that
   include -1 and the out-of-range 4, 7 and 100, bits that include 0,
   0x7FFFFFFF, 0x80000000 and 0xFFFFFFFF; then once on a side stream. Every
   output must be equal.
4. The main path: ``tpu2048_torch.cli.main(["eval", "--policy", "model",
   ...])`` in process, 512 games at batch 512, on a seeded full-width
   Q-network (features 2048, hidden 1024, 3 blocks, bf16). The kernel's
   launch count must equal the batched steps played. Then: the bf16
   Q-values of 64 boards on the card against the same weights in float32 on
   the CPU; and a small greedy evaluation on the card against the same one
   on the CPU, on the same bits, which must agree exactly.
5. Time the step kernel at B=512 (the greedy eval path's shape) and
   B=65536, in shaped mode at B=1024 and 4096 (the tabular path's and
   ``bench --tabular``'s calls), and at B=128 with both emits (``train
   dqn``'s call): eager (CUDA events over back-to-back calls), device
   only (replayed from a CUDA graph), the host time of a call (10,000 calls,
   no synchronise) and one plain call, beside the least time the card could
   take for the same work; each row's outputs held equal to the plain
   version's. Then the launch floor: an empty kernel at the step kernel's
   geometry, launched through the same ctypes path, eager, from a graph and
   on the host; and at B=512 the split of a call's host time (checks, C
   entry, stream lookup, allocation, carving of the outputs).
6. Hold the table kernels (bucket gather, bucket scatter) against their
   plain versions on the card, on the full (2**21 + 1, 128) table filled
   from a seeded generator: B in {1, 5, 33, 1000, 1024, 4096, 65536} (1000
   ends in a ragged stage; 4096 is ``bench --tabular``'s batch), bucket
   indices that include 0 and NB - 1, and repeated writes to the trash row.
   Rows [0, NB) must be equal (the trash row is write-only, its write order
   free), and the scatter must write in place. Then both once on a side
   stream (the wrappers launch on PyTorch's current stream).
7. The tabular main path: ``tpu2048_torch.cli.main(["train", "tabular",
   ...])`` in process at the ``train tabular`` defaults (capacity 2**25,
   batch 1024, 256 steps a chunk, shaped reward, fast engine) for at least
   two chunks. Gathers must equal 2 x env steps, scatters and step kernels
   1 x env steps, and every step after the first must replay the one
   captured step. Prints the rows, the step time, the ``q_states`` scan
   time and the peak memory.
8. A narrow trainer on the card against the same trainer on the CPU, on the
   same explicit bits and draws, with the card's chunk run under
   ``torch.cuda.set_sync_debug_mode("error")`` (a chunk never waits for the
   device): integer state equal, Q within ``Q_RTOL``. Then a narrow table
   trained on the card is saved and ``eval --policy tabular`` plays it on
   the card.
9. Time the table kernels at B=1024 (the path's shape), 4096 (``bench
   --tabular``'s) and 65536: eager, device only (replayed from a CUDA
   graph), plain version, and the PyTorch call that computes the same
   function (``index_select``, ``index_copy_``) eager and from a CUDA
   graph, beside the bound. At 1024 and 4096 also the host time of a call
   (10,000 calls, no synchronise) of the wrapper and of the PyTorch call,
   and at 1024 its split: the C entry alone, the stream lookup, the
   output's allocation.
10. Hold the rollout kernel, in both layouts (four threads a lane and one),
    against ``plain_env_rollout`` on the card: B in {1, 512, 1000, 4096,
    65536} and the layout threshold's neighbours (threshold - 1, threshold,
    threshold + 1), k in {1, 16}, simple with and without the
    terminal bonus and shaped (stall limit 3) with and without
    ``reset_shaping``, each with and without the eval latches; mid-game
    lanes, a fifth of them latched, dead boards (plain, with a 2048, with
    two 1024s), the edge bit patterns; two windows fed back. Every output
    must be equal, the float32 return bit for bit. Then Philox mode, in
    both layouts and through the wrapper, against external mode fed
    ``philox_rows`` and the plain version, at k=16 over
    two launches, for each argument set that phase 11's calls make (bench:
    B=65536, bonus on, no latches; random eval: 512 games simple and shaped
    and 65536 simple, with latches; each at its seed, from the step after
    the reset's row), and with stall limit 3 over a step counter that
    crosses 2**32.
11. The rollout path through ``tpu2048_torch.cli.main``, every count set to
    0 before each call and read after it: ``eval --policy random`` (512
    games, simple, twice, and shaped; 65536 games), whose rollout launches
    must equal the windows played, with no other kernel, a max-tile mode of
    64 or 128 and action counts summing to the game lengths, and one warm
    512-game eval under ``torch.profiler``; ``bench`` at
    its defaults (65536 lanes, 256 steps, Philox); ``bench --rollout-k 1``
    at the same defaults (one step-kernel launch a step, generator bits),
    its totals at B=4096 over 32 steps against ``plain_env_step`` on the
    card fed the same rows, and its device time a step under
    ``torch.profiler``; and ``bench --tabular`` (batch 4096, capacity 2**24,
    1 + 4 chunks of 256 steps) with ``--table-backend auto`` and
    ``legacy``, with the step, gather and scatter launches each must make.
12. Time the rollout kernel (k=16) at B=65536 with Philox and with external
    bits, and with latches at B=512, 4096, 16384, 20480, 24576, 32768 and
    65536, in both layouts: eager, device only, the host time of the
    wrapper's call (10,000 calls, no synchronise) in the layout it picks,
    one plain call, and the bound from the work these inputs need; each
    layout's outputs held equal to the plain call's. Then at B=512 with
    latches the split of a call's host time (checks, C entry, stream
    lookup, allocation, carving).
13. The DQN main path: ``tpu2048_torch.cli.main(["train", "dqn", ...])``
    in process at the ``train dqn`` defaults (full width: features 2048,
    hidden 1024, 3 blocks, bf16; 128 envs, learner batch 64, the update
    debt of 100 updates an episode, 16 steps a chunk), with a checkpoint
    directory; only ``--episodes`` is cut, to at least 3 chunks and 1,000
    updates. The step kernel's launches must equal the vector steps played
    (no other kernel), updates + debt must equal 100 x episodes, the loss
    must be finite. Prints the rows, ms a vector step and updates a step of
    each chunk, and the peak memory. Then the split of one warm vector step
    (restored from the run's checkpoint, 8 fixed updates): the host clock,
    the forward alone, and under torch.profiler the host and device time of
    the trainer's scopes (actor, env step, replay add, learner) and the
    kernels by device time. Then ``--resume`` for one more episode from the
    saved checkpoint, and ``eval --policy model --checkpoint-dir`` on the
    trained weights (64 games), with their launch counts.
14. A narrow DQN trainer (features 32, hidden 32, 1 block, float32, TF32
    off, dropout 0, the head's actions 0.05 apart) on the card against the
    same trainer on the CPU, on the same bits, draws and weights, half the
    lanes on endgame boards, 3 chunks of 16 steps with 4 updates a step:
    the integer state equal (boards, legal masks, the buffer's slots,
    ``ptr``, ``size``, the dedup caches, the counters, ``tile_hist``, the
    sums of integer rewards, the LR), the parameters and losses within the
    stated tolerances.
15. ``bench --learner`` (full-width updates at batch 64: 200 warm, 200
    timed) and ``bench --train-loop`` (128 envs, 64 steps a chunk, 1 warm
    and 8 timed chunks, no updates) through the CLI, with their JSON lines
    and launch counts, and the learner's bound: the larger of its
    operations at the bf16 dense peak and its bytes at the HBM rate.
16. The fused conv (``fused_conv=True``) at full width: its bf16 forward
    against the four-conv forward on the same weights (seed 2048) at batch
    128 and 512, max |dQ| against the bf16 tolerance of the CPU tests and
    the greedy actions where the top-two gap exceeds it, both forwards
    timed in turns; a learner update at batch 64 (``bench --learner``'s) of
    each module in turns: ms an update, and under torch.profiler the
    kernels and device time an update and the device's busy share, beside
    the same work's bound and the fused module's own; phase 14's narrow
    trainer with the fused conv, card against CPU; and `train dqn` through
    the Python API at the CLI's defaults, two chunks with updates, fused
    and four-conv.
17. ``train tabular --table-backend legacy`` through the CLI at the
    defaults (capacity 2**25, batch 1024, shaped), cut to 3 chunks, with
    ``--watchdog`` and ``--log``: step-kernel launches = env steps and no
    table kernel, ms a step beside phase 7's packed table; then a narrow
    legacy trainer on the card against the CPU on the same bits and draws:
    keys, boards, counters and ``dropped`` equal, Q within ``Q_RTOL``.
18. The classic op-by-op env and the lax engine (``tpu2048_torch.env.env``,
    plain ops): ``step`` (``step_with_spawn`` and the auto-reset, through a
    replay source) at B=4096 for 64 steps on the card against the CPU, on
    spawn decisions and fresh boards drawn once on the CPU, in five modes
    (simple, terminal bonus, ``quirk_compat``, shaped, shaped with
    ``reset_shaping_on_reset``): integers equal, shaped rewards within
    2e-6; the aten ops of a step; the production source's spawn
    distribution on the card over 131,072 draws (chi-square at p = 0.001,
    quirk clobber included); then through ``tpu2048_torch.cli.main``:
    ``train tabular --engine lax`` at phase 7's defaults and cut (gathers =
    2 x steps, scatters = steps, no step kernel), ``eval --policy random
    --engine lax`` (512 games, its score mean against phase 11's within
    four standard errors), ``eval --policy model --engine lax`` on phase
    4's weights, ``train dqn --engine lax`` at the defaults cut to 8
    episodes and its ``--resume``, ``demo --mode random`` and ``--mode
    model`` on that run's weights, and a manual ``GameSession`` driven by
    scripted keys; every lax path but the tabular one launches no kernel.
    Each prints its times beside the fast engine's from the same call.
19. Data parallel (``replay/sharded.py``, ``parallel/``): the sharded
    replay (4 shards of 12,500 slots, 600 adds of 128 envs) on the card
    against the CPU, every array equal after adds, a sample, a priority
    update and the prune; ``train dqn --replay-shards 4`` through the CLI
    at full width to its first episode, its ``--resume``, and the same run
    straight through, whose rows the resumed ones must equal bit for bit
    (cuDNN set deterministic for the comparisons), its ms a vector step
    printed chunk by chunk beside phase 13's; ``train dqn --data-parallel
    1 --coordinator ... --num-processes 1 --process-id 0`` (one NCCL rank)
    at full width with one update a step against the run without the
    flags, rows and weights equal bit for bit, and its ``--resume``; the
    one-rank NCCL all-reduce of the full-width gradients against an
    update; two gloo ranks sharing the card against one process with two
    shards (integers equal, parameters within rtol 2e-4 and atol 2e-5, the
    loss sum within rtol 1e-3; rank 0 alone logs); ``bench --scale 1``
    (one NCCL rank) beside phase 15's ``bench --train-loop``. Every path
    runs the step kernel and no other; ranks report their own launches.
20. Tensor parallelism and resharded resume (``parallel/mesh.py``'s
    ``(D, M)`` grid, ``checkpoint/ckpt.py``'s parts by shard): (a) two gloo
    ranks sharing the card train 4 replay shards at phase 19's narrow width
    and checkpoint them; one process resumes them, its step kernel on all
    128 lanes once a vector step, its ``host_sums`` equal the writers'
    just after the restore and its rows equal a straight one-process
    run's; (b) a ``(2, 2)`` grid of four gloo ranks against one process
    with two shards (``run_chunks``; integers equal, parameters within
    rtol 2e-4 and atol 2e-5); (c) at full width (bf16), two gloo ranks as
    one model group: the sliced forward against the whole module's on the
    same weights at batch 64 and 128 (phase 16's bf16 tolerance), ms a
    learner update at batch 64 and its share in the model group's gathers
    and all-reduces, ``train`` at the ``train dqn`` defaults to its first
    episode's updates with a checkpoint, which one process resumes at
    ``model_parallel`` 1 (its Q-values against the ranks' and one chunk).
    Gloo ranks that share one card check correctness; they do not measure
    tensor-parallel speed (every collective goes through the host).
21. The n-tuple network (``ops/ntuple_kernel.py``) at the path's shapes:
    the 4x6-tuple set, 8,192 lanes, random weights over the whole 256 MiB.
    The afterstate kernel against ``plain_afterstate_values`` on the same
    card tensors: afterstates, rewards and legality equal; values,
    ``v_prev`` and targets within ``NT_RTOL`` of max(1, |plain|); actions
    equal but where the plain version's two best moves lie within that
    tolerance, and the chosen afterstates those of the kernel's actions.
    The TD-update kernel against ``plain_td_update_`` on copies of the
    same weights: every weight within ``NT_RTOL``, the counts zero after.
    Both timed (eager by CUDA events, device only from a CUDA graph, one
    plain call) beside their bound, the useful bytes at the HBM rate
    (``benchmark/counts/ntuple_bytes.py``). Then ``train ntuple`` through
    ``tpu2048_torch.cli.main`` at 8,192 lanes, 128 steps a chunk, every
    count set to 0 just before: one afterstate launch, three update
    launches and one step kernel a step, every step after the first a
    replay of one captured step; and ``eval --policy ntuple`` on the saved
    weights, one afterstate launch and one step kernel a batched step.
22. The expectimax search (``ops/ntuple_kernel.py::search_values``,
    ``csrc/expectimax_kernel.cu``) at 512 lanes, the 4x6-tuple set: at
    unit-normal weights over the whole 256 MiB, the kernels against
    ``plain_search_values`` on the same card tensors at depths 2 and 3 on
    early, mid and late boards: leaves counted equal, legality equal,
    values within ``NT_RTOL``, actions equal but at near ties. Then on a
    table trained as the cell ``ntuple_eval_expectimax`` fills it: ``eval
    --policy ntuple --search-depth 3`` through ``tpu2048_torch.cli.main``
    (512 games at batch 512; two search launches and one step kernel a
    batched step, no afterstate launch, the leaf runs derived once for the
    network), and the search timed at the roots of steps 0, 64 and 192 of
    a depth-3 call (eager, device only from a CUDA graph, the host time of
    a call, one plain call) beside its bound
    (``benchmark/counts/search_work.py``).

Then one JSON line describing the seven kernels (the step kernel's launches
counted over phases 4, 11, 13, 16, 17, 19, 20, 21 and 22, the table
kernels' over phases 7, 11 and 18, the n-tuple kernels' over phase 21, the
search's over phase 22), and the result line.

Phase 13's ``train dqn`` also writes env 0's ``--debug-csv`` (the
reference's header, one row a vector step) under ``--watchdog``, and
``analyze`` reads its JSONL through the CLI.
"""

import concurrent.futures
import contextlib
import csv
import dataclasses
import functools
import io
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 2048
EVAL_GAMES = 512
DQN_ENVS = 128  # `train dqn`'s default envs: the DQN path's step batch
TRAJECTORY_STEPS = 32
# The step kernel's card matrix: B=1, the DQN path's 128, the eval path's
# 512, a ragged last block (1000), `bench --tabular`'s 4096 and 65536.
STEP_SIZES = (1, DQN_ENVS, EVAL_GAMES, 1000, 4096, 65536)
# H100 SXM (NVIDIA data sheet): the HBM rate. The kernels' operations are
# 32-bit integer adds, compares, logic and shifts, which compute capability
# 9.0 issues at 64 results a clock an SM (CUDA C++ Programming Guide,
# arithmetic instructions' throughput); int_ops_per_s() takes the SM count
# and the maximum SM clock from the card.
HBM_BYTES_PER_S = 3.35e12
INT32_RESULTS_PER_CLOCK_PER_SM = 64
# 32-bit operations a lane does, counted at source level in
# csrc/step_kernel.cu: legality of 4 directions (352), the chosen merge
# (356), game over (82) and the two maxima (126) on every lane; the legal
# mask of the next board (352) with emit_legal; the random pick (25) where
# the action is < 0, the spawn (116) where the move is valid and the reset
# (76) where the episode ends. The 96 selects that gather a row into
# slide-left order and write it back are the design's cost, not the
# function's work, and are not counted.
OPS_LANE, OPS_LEGAL, OPS_PICK, OPS_SPAWN, OPS_RESET = 916, 352, 25, 116, 76
# The rollout kernel's own work a lane-step, counted the same way in
# csrc/step_kernel.cu: the simple reward, bonus and window and episode sums
# (20), the latches and action counts (20), the stall lanes (10); and one
# Philox4x32-10 call (10 rounds of 2 wide products, 4 xors and 2 key adds:
# 104), once a step and again where the episode ends.
OPS_WINDOW, OPS_LATCH, OPS_STALL, OPS_PHILOX = 20, 20, 10, 104
# The rollout slice's shapes: eval and bench windows of 16 steps; eval at
# the JAX CLI's 512 games and at 65536; the bench's 65536 lanes, 256 steps.
# The card matrix adds B=1 and a ragged last block (1000).
ROLLOUT_K, BENCH_BATCH, BIG_EVAL = 16, 65536, 65536
ROLLOUT_SIZES = (1, EVAL_GAMES, 1000, 4096, BENCH_BATCH)
# Phase 12's rows: (batch, Philox, latches). The bench's call, the same with
# bits from memory, and random eval's at 512, 4096, 16384, 20480, 24576,
# 32768 and 65536 games; the layouts' crossover is read from the latched
# rows.
ROLLOUT_TIMING_CASES = (
    (BENCH_BATCH, True, False), (BENCH_BATCH, False, False),
    (EVAL_GAMES, True, True), (4096, True, True), (16384, True, True),
    (20480, True, True), (24576, True, True), (32768, True, True),
    (BIG_EVAL, True, True))
# Phase 11's check of the single-step bench (`bench --rollout-k 1`): its
# path at this batch and step count against plain_env_step on the card.
SINGLE_STEP_CHECK = (4096, 32)
# Actions outside [-1, 4) that phase 3 mixes in: the step leaves the board.
OUT_OF_RANGE_ACTIONS = (4, 7, 100)
STALL_LIMIT = 3  # small, so that stall cutoffs happen in the card matrix
# bf16 on the card against float32 on the CPU: bf16 keeps 8 bits, so each
# layer's inputs, weights and outputs round by up to 2**-9; over five layers
# the Q-values moved by ~0.5% of max|Q| at full width on the CPU.
Q_BF16_RTOL = 3e-2
# Full width of the tabular slice: the `train tabular` defaults.
TABLE_LOG2, TABLE_BATCH, TABLE_CHUNK = 25, 1024, 256
TABLE_EPISODES = 3072  # ~1 episode a lane a chunk: 2-3 chunks
TABLE_SIZES = (1, 5, 33, 1000, 1024, 4096, 65536)
TABLE_TIMING_SIZES = (TABLE_BATCH, 4096, 65536)
HOST_CALLS = 10_000  # calls a host-time loop
# The step kernel's timed calls: (batch, mode). Greedy eval's B=512 and
# B=65536 in simple mode with emit_legal; the tabular path's B=1024 and
# `bench --tabular`'s 4096 in shaped mode with emit_pre_reset; `train dqn`'s
# B=128 in simple mode with both.
STEP_TIMING_CASES = ((EVAL_GAMES, "simple"), (65536, "simple"),
                     (TABLE_BATCH, "shaped"), (4096, "shaped"),
                     (DQN_ENVS, "dqn"))
# What each mode runs: (shaped, emit_pre_reset, emit_legal).
STEP_MODES = {"simple": (False, False, True), "shaped": (True, True, False),
              "dqn": (False, True, True)}
# The DQN slice: the `train dqn` defaults (128 envs, learner batch 64, an
# update debt of 100 updates an episode drained up to 512 a vector step, 16
# steps a chunk) at full width; only the episodes are cut, to at least 3
# chunks and 1,000 updates. The split adds 8 fixed updates to a warm step.
DQN_EPISODES, DQN_CHUNK = 24, 16
DQN_SPLIT_UPDATES, DQN_EVAL_GAMES = 8, 64
DQN_SCOPES = ("actor", "env_step", "replay_add", "learner")  # training/dqn.py
DQN_ROW_KEYS = {"episodes", "env_steps", "epsilon", "lr", "buffer_size",
                "train_steps", "mean_return", "mean_score", "mean_length",
                "best_tile", "loss", "tile_hist", "steps_per_s",
                "update_debt"}
# Phase 13 also writes env 0's debug CSV, whose header is the reference
# driver's (mainDQL:137), under a watchdog that must not fire.
DEBUG_CSV_HEADER = ["Episode", "Action", "Legal Moves", "Reward",
                    "Total Reward", "State", "Done", "Ho salvato", "Mosse"]
WATCHDOG_S = 900
# H100 SXM (NVIDIA data sheet): dense bf16 tensor-core peak.
BF16_FLOPS_PER_S = 989e12
# The fused conv (phase 16): the forward compared at `train dqn`'s and the
# eval's batch against the bf16 TOL of tests/test_torch_dqn_model.py (of
# max(1, max |Q|)); learner updates a timed turn and under the profiler;
# endgame lanes a chunk of its `train dqn` run (100 updates owed each).
FUSED_Q_BATCHES = (DQN_ENVS, EVAL_GAMES)
DQN_MODEL_BF16_TOL = 1e-2
FUSED_TIMED_UPDATES, FUSED_TRACED_UPDATES = 100, 10
FUSED_ENDGAME_LANES = 4
# Narrow DQN trainer, card against CPU, float32 with TF32 off: the sums of
# cuDNN and of the CPU differ in order. Adam moves a weight by about lr a
# step whatever the gradient's size, so a weight whose gradient is at the
# level of float noise may move the other way on one device. The ATOL
# carries the check: all weights but a LOOSE_SHARE of them agree within
# it. The losses are held relative to their own size.
DQN_NARROW_PARAM_ATOL = 1e-5
DQN_NARROW_LOOSE_SHARE = 1e-3
DQN_NARROW_LOSS_RTOL = 1e-4
# The n-tuple phase (21): `train ntuple`'s lanes and chunk; its games, cut
# to a few chunks; the greedy eval's games on the trained weights. Card
# against plain on the same inputs: each value is a sum of 32 weights in
# another order (the kernel's quads and batches, torch's reduction), so it
# agrees to float32 rounding, 2.4e-6 of max(1, |V|) at unit-normal
# weights; a lookup left out or misread moves it by a weight, ~1.
NT_LANES, NT_CHUNK, NT_EPISODES, NT_EVAL_GAMES = 8192, 128, 16384, 2048
NT_RTOL = 1e-5
# The search phase (22): depth-3 eval's games at batch 512 (the cell
# ntuple_eval_expectimax's); the table's fill as that cell trains it
# (256 chunks of 8,192 lanes x 128 steps: 268,435,456 lane-steps); the
# steps of a depth-3 call whose roots are timed. Card against plain: a
# value is sums of lookups and of chance children in other orders, float32
# rounding as phase 21's.
SEARCH_DEPTH, SEARCH_GAMES, SEARCH_FILL_CHUNKS = 3, 512, 256
SEARCH_TIMING_STEPS = (0, 64, 192)
# Card against CPU, narrow trainer: the shaped reward's log2 and pow may
# round one float32 ulp apart on the two devices, and the TD updates carry
# that on (the CPU tests hold the port to JAX at the same tolerance).
Q_RTOL = 1e-5


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi(query):
    """The first card's line of ``nvidia-smi --query-gpu=QUERY``."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def card_line():
    return nvidia_smi("name,power.limit")


@functools.lru_cache(maxsize=None)
def int_ops_per_s():
    """The card's peak of 32-bit integer operations a second: 64 results a
    clock an SM, times the SMs, times the maximum SM clock that nvidia-smi
    reports (1,980 MHz on an H100 SXM: 1.67e13/s)."""
    import torch

    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_RESULTS_PER_CLOCK_PER_SM * sms * mhz * 1e6


def source_threads(root):
    """The step kernel's threads a block, read from its source under
    ``root``."""
    source = Path(root) / "tpu2048_torch" / "csrc" / "step_kernel.cu"
    match = re.search(r"constexpr int kThreads = (\d+);", source.read_text())
    if not match:
        fail(f"no kThreads in {source}")
    return int(match.group(1))


def edge_bits(gen, b, device):
    """(8, b) int32 bit rows; lanes 0-3 and ~10% of the rest hold the edge
    patterns 0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF (as int32 storage)."""
    import torch

    bits = torch.randint(-(2**31), 2**31, (8, b), dtype=torch.int32,
                         generator=gen, device=device)
    edge = torch.tensor([0, 0x7FFFFFFF, -(2**31), -1], dtype=torch.int32,
                        device=device)
    bits[:, :4] = edge[:b]
    pick = torch.randint(0, 4, (8, b), generator=gen, device=device)
    use = torch.rand((8, b), generator=gen, device=device) < 0.1
    return torch.where(use, edge[pick], bits).contiguous()


def step_actions(gen, b, device):
    """(b,) int32 actions in [-1, 4), ~5% of them out of range (4, 7, 100)."""
    import torch

    actions = torch.randint(-1, 4, (b,), dtype=torch.int32, generator=gen,
                            device=device)
    out = torch.tensor(OUT_OF_RANGE_ACTIONS, dtype=torch.int32, device=device)
    pick = torch.randint(0, len(OUT_OF_RANGE_ACTIONS), (b,), generator=gen,
                         device=device)
    use = torch.rand(b, generator=gen, device=device) < 0.05
    return torch.where(use, out[pick], actions)


def start_boards(gen, b, device):
    """(16, b) int8: sparse boards, and a quarter of full ones."""
    import torch

    x = torch.randint(1, 12, (b, 16), dtype=torch.int8, generator=gen,
                      device=device)
    sparse = torch.rand((b, 16), generator=gen, device=device) < 0.3
    sparse[b // 4:b // 2] = False
    return torch.where(sparse, 0, x).T.contiguous()


def phase_equal(sk, torch, device):
    """Kernel against plain version on the card; returns max |difference|."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    max_err, checks, done_lanes, random_lanes, out_lanes = 0, 0, 0, 0, 0
    cases = itertools.product(STEP_SIZES, (False, True), (False, True),
                              (False, True))
    for b, shaped, pre, legal in cases:
        kw = dict(emit_pre_reset=pre, emit_legal=legal)
        boards_k = boards_p = start_boards(gen, b, device)
        for _ in range(TRAJECTORY_STEPS):
            actions = step_actions(gen, b, device)
            bits = edge_bits(gen, b, device)
            fd = (torch.rand(b, generator=gen, device=device) < 0.05
                  if shaped else None)
            out_k = sk.fused_env_step(boards_k, actions, bits, fd, **kw)
            out_p = sk.plain_env_step(boards_p, actions, bits, fd, **kw)
            if len(out_k) != len(out_p):
                fail(f"output count {len(out_k)} != {len(out_p)}")
            for i, (a, c) in enumerate(zip(out_k, out_p)):
                if a.dtype != c.dtype or a.shape != c.shape:
                    fail(f"output {i}: {a.dtype}{tuple(a.shape)} != "
                         f"{c.dtype}{tuple(c.shape)}")
                err = (a.to(torch.int64) - c.to(torch.int64)).abs().max()
                max_err = max(max_err, int(err))
                checks += 1
            if max_err:
                fail(f"kernel != plain at B={b} shaped={shaped} pre={pre} "
                     f"legal={legal}: max |diff| {max_err}")
            done_lanes += int(out_k[3].sum())
            random_lanes += int((actions < 0).sum())
            out_lanes += int((actions >= 4).sum())
            boards_k, boards_p = out_k[0], out_p[0]
    # On a side stream, fresh inputs: the wrapper launches on PyTorch's
    # current stream, so the result is ready in stream order.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        actions = step_actions(gen, b, device)
        bits = edge_bits(gen, b, device)
        out_k = sk.fused_env_step(boards_k, actions, bits, fd, **kw)
        out_p = sk.plain_env_step(boards_p, actions, bits, fd, **kw)
        side_ok = all(torch.equal(a, c) for a, c in zip(out_k, out_p))
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    if not side_ok:
        fail(f"step kernel on a side stream at B={b} != plain_env_step")
    if not done_lanes or not random_lanes or not out_lanes:
        fail("the trajectories ended no game or had no random-legal or "
             "out-of-range lane")
    print(f"phase 3: kernel == plain_env_step on the card at B in "
          f"{STEP_SIZES}: {checks} outputs, {done_lanes} episode ends, "
          f"{random_lanes} random-legal lanes, {out_lanes} lanes with an "
          f"action in {OUT_OF_RANGE_ACTIONS}, max |diff| {max_err}; equal on "
          f"a side stream at B={b}")
    return max_err


def tie_free_narrow_params(tdqn, DQNConfig, torch):
    """A narrow float32 model whose head puts the actions 0.05 apart, so
    float32 sum-order differences cannot flip a greedy choice."""
    model = tdqn.init_params(
        tdqn.create_model(DQNConfig(features=32, hidden=16, num_blocks=2,
                                    bf16=False), "cpu"),
        torch.Generator().manual_seed(SEED))
    params = tdqn.to_flax_params(model)
    params["head"]["kernel"] *= 0.02
    params["head"]["bias"][:] = 0.05 * torch.arange(4).numpy()
    return params


def run_cli(cli_main, argv):
    """Run the CLI in process; returns its exit code and parsed summary."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    return rc, json.loads(out.getvalue()) if rc == 0 else None


def full_width_params(torch):
    """Flax-named params of the full-width Q-network (features 2048,
    hidden 1024, 3 blocks), initialised on the CPU from SEED."""
    from tpu2048_torch.agents.dqn import DQNConfig
    from tpu2048_torch.models import dqn as tdqn

    model = tdqn.init_params(tdqn.create_model(DQNConfig(), "cpu"),
                             torch.Generator().manual_seed(SEED))
    return tdqn.to_flax_params(model)


def phase_main_path(sk, torch, device):
    from tpu2048_torch.agents.dqn import DQNConfig
    from tpu2048_torch.checkpoint.params import save_params
    from tpu2048_torch.cli.main import main as cli_main
    from tpu2048_torch.env.fast import ReplayBits
    from tpu2048_torch.eval.evaluate import evaluate, greedy_dqn_policy
    from tpu2048_torch.models import dqn as tdqn

    t0 = time.perf_counter()
    config = DQNConfig()  # features 2048, hidden 1024, 3 blocks, bf16
    params = full_width_params(torch)
    n_params = sum(v.size for g in params.values() for v in g.values())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "params.npz")
        save_params(path, params)
        print(f"phase 4: full-width params ({n_params} parameters) written in "
              f"{time.perf_counter() - t0:.1f} s")
        argv = ["eval", "--policy", "model", "--params", path, "--games",
                str(EVAL_GAMES), "--eval-batch", str(EVAL_GAMES), "--seed",
                str(SEED)]
        sk.fused_env_step.launches = 0
        t0 = time.perf_counter()
        rc, summary = run_cli(cli_main, argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = sk.fused_env_step.launches
        # The same call again: the first pays cuDNN's and the allocator's
        # first-use costs inside its games.
        _, warm = run_cli(cli_main, argv)
    if rc != 0:
        fail(f"cli eval returned {rc}")
    print("phase 4: summary " + json.dumps(summary, sort_keys=True))
    steps = summary["batch_steps"]
    if launches != steps or steps == 0:
        fail(f"{launches} kernel launches for {steps} env steps played")
    fractions = sum(summary["action_fractions"].values())
    if (summary["games"] != EVAL_GAMES
            or summary["env_steps"] != steps * EVAL_GAMES
            or not summary["length_mean"] > 0
            or summary["best_tile"] < 8 or abs(fractions - 1) > 1e-3):
        fail(f"implausible eval summary: {summary}")
    for label, run in (("main path", summary), ("main path again, warm",
                                                warm)):
        secs = run["seconds"]
        print(f"phase 4: {label}: {run['batch_steps']} env steps; "
              f"{EVAL_GAMES / secs:.1f} games/s, "
              f"{run['env_steps'] / secs:.0f} env-steps/s ({secs:.3f} s of "
              f"games, {1e3 * secs / run['batch_steps']:.3f} ms a step)")
    print(f"phase 4: {launches} kernel launches = {steps} env steps; "
          f"{wall:.3f} s in the first CLI call")

    # Full-width bf16 Q on the card against float32 on the CPU.
    gen = torch.Generator().manual_seed(SEED + 1)
    boards = torch.randint(0, 12, (64, 4, 4), dtype=torch.int8, generator=gen)
    boards[torch.rand((64, 4, 4), generator=gen) < 0.3] = 0
    card = tdqn.load_flax_params(tdqn.create_model(config, device),
                                 params).eval()
    with torch.inference_mode():
        q_card = card(boards.to(device)).float().cpu()
        batch = boards.repeat(EVAL_GAMES // 64, 1, 1).to(device)
        forward_ms = elapsed_ms(torch, lambda: card(batch), 20)
    del card
    print(f"phase 4: full-width bf16 forward at batch {EVAL_GAMES} (the "
          f"policy's call in each step): {forward_ms:.3f} ms")
    cpu = tdqn.load_flax_params(
        tdqn.create_model(DQNConfig(bf16=False), "cpu"), params).eval()
    with torch.inference_mode():
        q_cpu = cpu(boards)
    del cpu, params
    if q_card.shape != (64, 4) or not torch.isfinite(q_card).all():
        fail(f"Q on the card: shape {tuple(q_card.shape)}, not all finite")
    q_err = float((q_card - q_cpu).abs().max())
    q_max = float(q_cpu.abs().max())
    print(f"phase 4: full-width Q, bf16 on the card vs float32 on the CPU: "
          f"max |diff| {q_err:.3e}, max |Q| {q_max:.3e}, tolerance "
          f"{Q_BF16_RTOL} x max |Q| = {Q_BF16_RTOL * q_max:.3e}")
    if not q_err <= Q_BF16_RTOL * q_max:
        fail("full-width Q on the card disagrees with the CPU")

    # A small greedy evaluation on the card and on the CPU, same bits.
    narrow = tie_free_narrow_params(tdqn, DQNConfig, torch)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    rows = [torch.randint(-(2**31), 2**31, (8, 64), dtype=torch.int32,
                          generator=gen, device=device) for _ in range(200)]
    results = []
    for dev in (device, torch.device("cpu")):
        model = tdqn.load_flax_params(
            tdqn.create_model(DQNConfig(features=32, hidden=16, num_blocks=2,
                                        bf16=False), dev), narrow)
        results.append(evaluate(greedy_dqn_policy(model), 64,
                                ReplayBits(r.to(dev) for r in rows),
                                batch_size=64, max_steps=128))
    for name in ("scores", "max_tiles", "lengths", "action_counts"):
        a, c = getattr(results[0], name), getattr(results[1], name)
        if a.shape != c.shape or (a != c).any():
            fail(f"narrow eval on the card != on the CPU: {name}")
    print(f"phase 4: narrow greedy eval, card == CPU on the same bits "
          f"({results[0].batch_steps} steps, score mean "
          f"{results[0].scores.mean():.1f})")
    return launches, warm


def elapsed_ms(torch, fn, n):
    """Mean ms of ``fn`` over ``n`` back-to-back calls, by CUDA events."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(torch, fn, n):
    """Mean device ms of ``fn`` replayed from a CUDA graph of ``n`` calls:
    the kernel's time without the host's launch overhead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return elapsed_ms(torch, graph.replay, 10) / n


def phase_timing(sk, torch, device, b, mode, threads):
    """The step kernel (``threads`` a block) at batch ``b`` in ``mode``
    (``STEP_MODES``): the eval path's call (simple mode, emit_legal, greedy
    actions), the tabular path's (shaped mode with 5% forced ends,
    emit_pre_reset, explicit actions) or the DQN path's (simple mode, both
    emits). Kernel eager, its graph-replayed device time, its host time a
    call, the plain version, and the bound from the bytes and operations
    these inputs need. The kernel's outputs must equal the plain
    version's."""
    shaped, pre, legal = STEP_MODES[mode]
    gen = torch.Generator(device=device).manual_seed(SEED + b)
    boards = start_boards(gen, b, device)
    actions = torch.randint(0, 4, (b,), dtype=torch.int32, generator=gen,
                            device=device)
    bits = torch.randint(-(2**31), 2**31, (8, b), dtype=torch.int32,
                         generator=gen, device=device)
    force_done = (torch.rand(b, generator=gen, device=device) < 0.05
                  if shaped else None)
    kw = dict(emit_pre_reset=pre, emit_legal=legal)

    def kernel():
        return sk.fused_env_step(boards, actions, bits, force_done, **kw)

    def plain():
        return sk.plain_env_step(boards, actions, bits, force_done, **kw)

    out = kernel()
    if not all(torch.equal(a, c) for a, c in zip(out, plain())):
        fail(f"step kernel != plain_env_step in the timed call at B={b}")
    n_rand = int((actions < 0).sum())
    n_moved = int(out[2].sum())
    n_done = int(out[3].sum())
    # Inputs: board, action, [force_done,] and the bit rows a lane needs
    # (row 0 if the action is < 0, rows 2-3 if the move is valid, rows 4-7
    # if the episode ends). Outputs: board, score, valid, done, max, second,
    # [the game-over flag,] [the pre-reset board,] [the legal mask].
    lane_bytes = (16 + 4 + 16 + 4 + 4 + (2 if shaped else 0)
                  + (16 if pre else 0) + (4 if legal else 0))
    n_bytes = b * lane_bytes + 4 * n_rand + 8 * n_moved + 16 * n_done
    n_ops = (b * (OPS_LANE + (OPS_LEGAL if legal else 0))
             + OPS_PICK * n_rand + OPS_SPAWN * n_moved + OPS_RESET * n_done)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / int_ops_per_s() * 1e3
    row = {
        "batch": b,
        "mode": {"simple": "simple, emit_legal",
                 "shaped": "shaped, emit_pre_reset",
                 "dqn": "simple, emit_pre_reset, emit_legal"}[mode],
        "threads": threads,
        "ms": elapsed_ms(torch, kernel, 200),
        "graph_ms": graph_ms(torch, kernel, 20),
        **host_us(torch, {"host_us": kernel}),
        "plain_ms": elapsed_ms(torch, plain, 20),
        "bytes": n_bytes, "ops": n_ops,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    print("phase 5: " + json.dumps(row))
    return row


def phase_launch_floor(sk, torch, b):
    """The least time a launch takes: an empty kernel at the step kernel's
    geometry for batch ``b``, through the same ctypes path (the C entry
    resolved once, the stream from ``torch.accelerator``); eager, from a
    CUDA graph and on the host. None if the checkout's library has no such
    entry."""
    lib = sk.LIBRARY.load()
    if not hasattr(lib, "tpu2048_noop_kernel"):
        print("phase 5: launch floor: not in this library")
        return None
    entry = lib.tpu2048_noop_kernel

    def launch():
        err = entry(b, 0, torch.accelerator.current_stream(0).native_handle)
        if err != 0:
            fail(f"empty kernel launch failed: CUDA error {err}")

    row = {"kernel": "noop_kernel", "batch": b,
           "ms": elapsed_ms(torch, launch, 200),
           "graph_ms": graph_ms(torch, launch, 20),
           **host_us(torch, {"host_us": launch})}
    print("phase 5: launch floor " + json.dumps(row))
    return row


def step_host_split(sk, torch, device, b):
    """Where a step call's host time goes at batch ``b`` (simple mode,
    emit_legal): the whole call, the input checks, the bare C entry
    (ctypes and the launch, arguments made beforehand), the stream lookup,
    the output buffer's allocation and the carving of its views. The rest
    of the call is the difference."""
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    boards = start_boards(gen, b, device)
    actions = torch.randint(0, 4, (b,), dtype=torch.int32, generator=gen,
                            device=device)
    bits = torch.randint(-(2**31), 2**31, (8, b), dtype=torch.int32,
                         generator=gen, device=device)
    n_bytes, _, offsets = sk.output_layout(b, False, False, True)
    buf = boards.new_empty(n_bytes)
    base = buf.data_ptr()
    entry = sk.LIBRARY.load().tpu2048_step_kernel
    args = (boards.data_ptr(), actions.data_ptr(), bits.data_ptr(), None,
            *[None if o is None else base + o for o in offsets], b,
            device.index, torch.accelerator.current_stream(device.index)
            .native_handle)
    split = {"batch": b}
    split.update(host_us(torch, {
        "step_us": lambda: sk.fused_env_step(boards, actions, bits,
                                             emit_legal=True),
        "check_us": lambda: sk._check_step(boards, actions, bits, None),
        "c_entry_us": lambda: entry(*args),
        "accelerator_current_stream_us": (
            lambda: torch.accelerator.current_stream(0).native_handle),
        "new_empty_us": lambda: boards.new_empty(n_bytes),
        "carve_us": lambda: sk.carve_outputs(buf, b, False, False, True),
    }))
    print("phase 5: host split " + json.dumps(split))
    return split


def phase_step_timing(sk, torch, device, root):
    """Phase 5: the step kernel of the checkout at ``root`` at each of
    STEP_TIMING_CASES, and the launch floor; returns the rows."""
    threads = source_threads(root)
    rows = [phase_timing(sk, torch, device, b, mode, threads)
            for b, mode in STEP_TIMING_CASES]
    phase_launch_floor(sk, torch, EVAL_GAMES)
    if hasattr(sk, "carve_outputs"):
        step_host_split(sk, torch, device, EVAL_GAMES)
    return rows


def step_timing_only(torch, root):
    """Phase 5 alone on the step kernel of the checkout at ``root``, then
    phase 12's Philox rollout rows, the bench's call (B=65536) and random
    eval's (with latches, B from 512 to 65536) in each layout the checkout
    has, and the rollout's host split: the kernels share device helpers."""
    root = Path(root).resolve()
    if not (root / "tpu2048_torch" / "csrc" / "step_kernel.cu").is_file():
        fail(f"{root} holds no tpu2048_torch package")
    sys.path.insert(0, str(root))
    from tpu2048_torch.ops import step_kernel as sk

    print(f"phase 5: step kernel of {root} (tpu2048_torch from "
          f"{Path(sk.__file__).parent}), {source_threads(root)} threads a "
          f"block; integer peak {int_ops_per_s():.4g}/s")
    sk.LIBRARY.load()
    device = torch.device("cuda", 0)
    phase_step_timing(sk, torch, device, root)
    phase_rollout_timings(sk, torch, device,
                          [c for c in ROLLOUT_TIMING_CASES if c[1]])


def phase_build(sk, tk):
    """Both sources at once, one nvcc each; then load both."""
    libs = (("step kernel", sk.LIBRARY), ("table kernels", tk.LIBRARY))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        for future in [pool.submit(lib.build) for _, lib in libs]:
            future.result()
    for name, lib in libs:
        lib.load()
    print(f"phase 2: kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, lib in libs:
        for line in lib.path().with_suffix(".log").read_text().splitlines():
            print(f"phase 2: nvcc, {name}: {line.strip()}")


def int_diff(torch, a, b):
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def phase_table_equal(tk, torch, device):
    """Gather and scatter against their plain versions on the full table;
    returns the max |difference| of each."""
    nb = (1 << TABLE_LOG2) // tk.BUCKET
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    data = torch.randint(-(2**31), 2**31, (nb + 1, tk.ROW), dtype=torch.int32,
                         generator=gen, device=device)
    mirror = data.clone()
    gather_err = scatter_err = 0
    for b in TABLE_SIZES:
        buckets = torch.randint(0, nb, (b,), dtype=torch.int32, generator=gen,
                                device=device)
        buckets[0] = 0
        buckets[-1] = nb - 1
        got = tk.bucket_gather(data, buckets)
        want = tk.plain_bucket_gather(data, buckets)
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"gather at B={b}: {got.dtype}{tuple(got.shape)} != "
                 f"{want.dtype}{tuple(want.shape)}")
        gather_err = max(gather_err, int_diff(torch, got, want))

        # Distinct real buckets, 0 and NB - 1 among them, and a quarter of
        # the entries on the trash row, in shuffled order.
        n_real = b - b // 4
        real = torch.randperm(nb - 2, generator=gen, device=device)[:n_real] + 1
        real[0] = 0
        real[-1] = nb - 1 if n_real > 1 else 0
        ids = torch.cat([real, torch.full((b // 4,), nb, device=device)])
        ids = ids[torch.randperm(b, generator=gen, device=device)]
        ids = ids.to(torch.int32).contiguous()
        rows = torch.randint(-(2**31), 2**31, (b, tk.BUCKET, tk.WIDTH),
                             dtype=torch.int32, generator=gen, device=device)
        ptr = data.data_ptr()
        out = tk.bucket_scatter_(data, ids, rows)
        tk.plain_bucket_scatter_(mirror, ids, rows)
        if out is not data or data.data_ptr() != ptr:
            fail(f"scatter at B={b} did not write in place")
        written = ids < nb
        scatter_err = max(
            scatter_err,
            int_diff(torch, data[ids[written].long()],
                     rows.view(b, tk.ROW)[written]))
        if not torch.equal(data[:-1], mirror[:-1]):
            fail(f"scatter at B={b}: rows [0, NB) differ from the plain "
                 f"version")
        if gather_err or scatter_err:
            fail(f"table kernels != plain at B={b}: gather {gather_err}, "
                 f"scatter {scatter_err}")
    # On a side stream, fresh rows: the wrappers launch on PyTorch's
    # current stream, so each result is ready in stream order.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rows = torch.randint(-(2**31), 2**31, (b, tk.BUCKET, tk.WIDTH),
                             dtype=torch.int32, generator=gen, device=device)
        got = tk.bucket_gather(data, buckets)
        tk.bucket_scatter_(data, ids, rows)
        side_ok = (torch.equal(got, tk.plain_bucket_gather(mirror, buckets))
                   and torch.equal(data[ids[written].long()],
                                   rows.view(b, tk.ROW)[written]))
    torch.cuda.current_stream().wait_stream(side)
    if not side_ok:
        fail(f"table kernels on a side stream at B={b} != plain versions")
    torch.cuda.synchronize()
    print(f"phase 6: bucket_gather and bucket_scatter_ == plain versions on "
          f"the ({nb + 1}, {tk.ROW}) table at B in {TABLE_SIZES}: rows "
          f"[0, NB) equal, scatter in place, and on a side stream at "
          f"B={TABLE_SIZES[-1]}; max |diff| {gather_err} / {scatter_err}")
    return gather_err, scatter_err


ROW_KEYS = {"episodes", "env_steps", "epsilon", "mean_return", "mean_score",
            "mean_length", "best_tile", "q_states", "dropped_updates",
            "action_counts", "steps_per_s"}


def profile_train_steps(torch, device, steps):
    """Warm full-width train steps: the step time on the host clock, and
    under torch.profiler the device time of each kernel; prints the
    device's busy share of a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu2048_torch.agents.tabular import TabularConfig
    from tpu2048_torch.training import tabular as ttrain

    def config(n):
        return ttrain.TabularTrainConfig(
            agent=TabularConfig(capacity_log2=TABLE_LOG2),
            batch_size=TABLE_BATCH, steps_per_chunk=n)

    bits, draws = ttrain.sources(1, device)
    state = ttrain.init_train_state(config(steps), bits)
    state, _ = ttrain.train_chunk(config(steps), state, bits, draws)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = ttrain.train_chunk(config(steps), state, bits, draws)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):  # the tracer's own start-up
        state, _ = ttrain.train_chunk(config(2), state, bits, draws)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        state, _ = ttrain.train_chunk(config(steps), state, bits, draws)
        torch.cuda.synchronize()
    # A span around a graph's launch also shows as device time: only the
    # device's own operations count.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    print(f"phase 7: {steps} warm full-width steps: {step_ms:.3f} ms a step; "
          f"under the profiler {device_ms:.4f} ms of device time a step in "
          f"{sum(e.count for e in kernels) / steps:.0f} kernels of "
          f"{len(kernels)} names: the device is busy "
          f"{100 * device_ms / step_ms:.1f}% of a step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"phase 7:   {e.self_device_time_total / 1e3 / steps:.4f} ms, "
              f"{e.count / steps:.0f} a step: {e.key[:100]}")


def phase_tabular(sk, tk, torch, device):
    """The tabular main path through the CLI; returns the launch counts."""
    from tpu2048_torch.agents.tabular_fast import packed_init
    from tpu2048_torch.cli.main import main as cli_main
    from tpu2048_torch.metrics.logging import read_jsonl
    from tpu2048_torch.training.tabular import train_chunk

    modes = ("eager_steps", "graph_steps", "captures")
    before = [getattr(train_chunk, m) for m in modes]
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "train.jsonl")
        argv = ["train", "tabular", "--batch", str(TABLE_BATCH),
                "--capacity-log2", str(TABLE_LOG2), "--episodes",
                str(TABLE_EPISODES), "--steps-per-chunk", str(TABLE_CHUNK),
                "--seed", "0", "--log", log]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sk.fused_env_step.launches = 0
        tk.bucket_gather.launches = 0
        tk.bucket_scatter_.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"step": sk.fused_env_step.launches,
                    "gather": tk.bucket_gather.launches,
                    "scatter": tk.bucket_scatter_.launches}
        rows = read_jsonl(log) if rc == 0 else []
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        fail(f"cli train tabular returned {rc}")
    for row in rows:
        print("phase 7: row " + json.dumps(row))
    steps = rows[-1]["env_steps"] // TABLE_BATCH if rows else 0
    if len(rows) < 2 or steps != len(rows) * TABLE_CHUNK:
        fail(f"{len(rows)} chunks, {steps} env steps")
    if (launches["step"] != steps or launches["scatter"] != steps
            or launches["gather"] != 2 * steps):
        fail(f"launches {launches} for {steps} env steps")
    graph = dict(zip(modes, [getattr(train_chunk, m) - b
                             for m, b in zip(modes, before)]))
    if graph != {"eager_steps": 1, "graph_steps": steps - 1, "captures": 1}:
        fail(f"train tabular: {graph} for {steps} env steps")
    for row in rows:
        if (set(row) != ROW_KEYS or not row["q_states"] > 0
                or not 0 <= row["epsilon"] <= 1
                or sum(row["action_counts"]) != row["env_steps"]
                or not all(map(lambda v: v == v, (row["mean_return"],
                                                  row["mean_score"])))):
            fail(f"implausible row {row}")
    print(f"phase 7: {launches} launches for {steps} env steps (gathers = 2 "
          f"x steps, scatters = step kernels = steps); {graph}; {wall:.3f} "
          f"s for the CLI call; peak device memory {peak} bytes")
    for i, row in enumerate(rows):
        print(f"phase 7: chunk {i + 1}: "
              f"{1e3 * TABLE_BATCH / row['steps_per_s']:.3f} ms a step, "
              f"{row['steps_per_s']:.0f} env-steps/s")

    packed = packed_init(TABLE_LOG2, device)
    scan_ms = elapsed_ms(torch, lambda: packed.occupied.sum(), 10)
    print(f"phase 7: q_states scan of the full table (once a chunk): "
          f"{scan_ms:.3f} ms")
    del packed
    profile_train_steps(torch, device, 16)
    return launches, rows


def phase_narrow(sk, tk, torch, device):
    """A narrow trainer on the card and on the CPU on the same bits and
    draws; then save a table on the card and evaluate it there."""
    from tpu2048_torch.agents import tabular as ttab
    from tpu2048_torch.agents import tabular_fast as tabf
    from tpu2048_torch.cli.main import main as cli_main
    from tpu2048_torch.env import fast as tfast
    from tpu2048_torch.training import tabular as ttrain

    b, log2, steps = 256, 14, 64
    config = ttrain.TabularTrainConfig(
        agent=ttab.TabularConfig(capacity_log2=log2), batch_size=b,
        steps_per_chunk=steps)
    gen = torch.Generator().manual_seed(SEED + 8)
    bits = [torch.randint(-(2**31), 2**31, (8, b), dtype=torch.int32,
                          generator=gen) for _ in range(steps + 1)]
    # Explore draws below 0.5 < epsilon: every action is the drawn one, so
    # no choice hinges on a float Q that the two devices round apart.
    draws = [(torch.rand(b, generator=gen) * 0.5,
              torch.randint(0, 4, (b,), dtype=torch.int32, generator=gen))
             for _ in range(steps)]
    states = []
    for dev in (device, torch.device("cpu")):
        replay = tfast.ReplayBits([x.to(dev) for x in bits])
        replay_draws = tabf.ReplayDraws([(u.to(dev), a.to(dev))
                                         for u, a in draws])
        state = ttrain.init_train_state(config, replay)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                state, _ = ttrain.train_chunk(config, state, replay,
                                              replay_draws)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        else:
            state, _ = ttrain.train_chunk(config, state, replay,
                                          replay_draws)
        states.append(state)
    card, cpu = states
    data_k, data_c = card.table.data.cpu()[:-1], cpu.table.data[:-1]
    for word in (0, 1):
        if not torch.equal(data_k[:, word::8], data_c[:, word::8]):
            fail(f"narrow trainer: key word {word}, card != CPU")
    for name in ("boards", "score", "episode_steps", "prev_max",
                 "consec_action", "consec_count"):
        if not torch.equal(getattr(card.env_state, name).cpu(),
                           getattr(cpu.env_state, name)):
            fail(f"narrow trainer: {name}, card != CPU")
    for name in ("episodes_done", "env_steps", "best_tile", "action_counts"):
        if not torch.equal(getattr(card, name).cpu(), getattr(cpu, name)):
            fail(f"narrow trainer: {name}, card != CPU")
    if int(card.table.dropped) != int(cpu.table.dropped):
        fail("narrow trainer: dropped, card != CPU")
    q_k = torch.stack([data_k[:, 2 + j::8] for j in range(4)]).view(
        torch.float32)
    q_c = torch.stack([data_c[:, 2 + j::8] for j in range(4)]).view(
        torch.float32)
    q_err = float(((q_k - q_c).abs() / q_c.abs().clamp_min(1)).max())
    q_words = int((q_k != q_c).sum())
    if not q_err <= Q_RTOL or not torch.isfinite(q_k).all():
        fail(f"narrow trainer: Q card vs CPU {q_err:.3e} > {Q_RTOL}")
    print(f"phase 8: narrow trainer (B={b}, capacity 2**{log2}, {steps} "
          f"steps), card == CPU on the integer state; Q within "
          f"{q_err:.3e} of max(1, |Q|) (tolerance {Q_RTOL}), "
          f"{q_words} of {q_c.numel()} Q words differ; "
          f"{int(card.episodes_done)} episodes, "
          f"{int(card.table.occupied.sum())} states; the card's chunk made "
          f"no host sync")

    with tempfile.TemporaryDirectory() as tmp:
        table = os.path.join(tmp, "q.npz")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_main(["train", "tabular", "--batch", str(b),
                           "--capacity-log2", str(log2), "--episodes",
                           str(b), "--steps-per-chunk", str(steps),
                           "--save", table, "--seed", "1"])
        if rc != 0 or not os.path.isfile(table):
            fail(f"narrow train --save returned {rc}")
        before = tk.bucket_gather.launches
        rc, summary = run_cli(cli_main, [
            "eval", "--policy", "tabular", "--table", table, "--games",
            str(b), "--eval-batch", str(b), "--reward", "shaped"])
    if rc != 0:
        fail(f"cli eval --policy tabular returned {rc}")
    gathers = tk.bucket_gather.launches - before
    if (summary["games"] != b or gathers != summary["batch_steps"]
            or not summary["length_mean"] > 0):
        fail(f"eval --policy tabular: {gathers} gathers, {summary}")
    print(f"phase 8: eval --policy tabular on the card, a table the port "
          f"saved: {summary['games']} games, score mean "
          f"{summary['score_mean']:.1f}, best tile {summary['best_tile']}, "
          f"{gathers} gathers = {summary['batch_steps']} steps")


def host_us(torch, fns, n=HOST_CALLS, rounds=10):
    """Mean host microseconds a call of each function of the dict ``fns``,
    over ``n`` calls each with no synchronise, taken in ``rounds`` turns so
    that a drift of the shared host's speed falls on all of them alike:
    the caller's thread's cost, as long as the device keeps up."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    total = dict.fromkeys(fns, 0.0)
    for _ in range(rounds):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(n // rounds):
                fn()
            total[name] += time.perf_counter() - t0
        torch.cuda.synchronize()
    return {name: t * 1e6 / (n // rounds * rounds)
            for name, t in total.items()}


def phase_table_timing(tk, torch, data, b):
    """Both kernels at batch ``b`` on the full table: eager, device only,
    plain version, the PyTorch call for the same function eager and from a
    CUDA graph, and the bound; where the call is host-bound (b <= 4096) the
    host time of the wrapper and of the PyTorch call. Every call reads other
    buckets (256 MB of rows in all), so the rows come from device memory,
    not the 50 MB L2, as on the path."""
    nb = data.shape[0] - 1
    gen = torch.Generator(device=data.device).manual_seed(SEED + b)
    n_sets = max(8, (256 << 20) // (b * tk.ROW * 4))
    idx = [torch.randint(0, nb, (b,), dtype=torch.int32, generator=gen,
                         device=data.device) for _ in range(n_sets)]
    ids = [torch.randperm(nb, generator=gen, device=data.device)[:b].to(
        torch.int32) for _ in range(n_sets)]
    idx64 = [i.long() for i in idx]
    ids64 = [i.long() for i in ids]
    rows = torch.randint(-(2**31), 2**31, (b, tk.ROW), dtype=torch.int32,
                         generator=gen, device=data.device)

    def cycling(fn, sets):
        it = itertools.cycle(sets)
        return lambda: fn(next(it))

    calls = {
        "bucket_gather": (
            cycling(lambda i: tk.bucket_gather(data, i), idx),
            cycling(lambda i: tk.plain_bucket_gather(data, i), idx),
            cycling(lambda i: torch.index_select(data, 0, i), idx64)),
        "bucket_scatter": (
            cycling(lambda i: tk.bucket_scatter_(data, i, rows), ids),
            cycling(lambda i: tk.plain_bucket_scatter_(data, i, rows), ids),
            cycling(lambda i: data.index_copy_(0, i, rows), ids64)),
    }
    n_bytes = b * tk.ROW * 4 * 2 + b * 4  # rows in, rows out, indices
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    n_graph = min(n_sets, 256)
    out = {}
    for name, (kernel, plain, library) in calls.items():
        row = {
            "kernel": name, "batch": b,
            "ms": elapsed_ms(torch, kernel, n_sets),
            "graph_ms": graph_ms(torch, kernel, n_graph),
            "plain_ms": elapsed_ms(torch, plain, n_sets),
            "library_ms": elapsed_ms(torch, library, n_sets),
            "library_graph_ms": graph_ms(torch, library, n_graph),
            "bytes": n_bytes, "bound_ms": bound_ms, "bound_by": "bytes",
        }
        if b <= 4096:
            row.update(host_us(torch, {"host_us": kernel,
                                       "library_host_us": library}))
        print("phase 9: " + json.dumps(row))
        out[name] = row
    return out


def table_host_split(tk, torch, data, b):
    """Where a wrapper call's host time goes at batch ``b``: the whole call,
    the bare C entry (ctypes, launch and all, arguments made beforehand), the
    stream lookup (``torch.cuda``'s, which builds a stream object, and
    ``torch.accelerator``'s) and the gather's output allocation, beside the
    PyTorch call. The C entries are those of the loaded library; the rest of the
    wrapper is the difference."""
    nb = data.shape[0] - 1
    gen = torch.Generator(device=data.device).manual_seed(SEED + 9)
    idx = torch.randint(0, nb, (b,), dtype=torch.int32, generator=gen,
                        device=data.device)
    ids = torch.randperm(nb, generator=gen, device=data.device)[:b].to(
        torch.int32)
    rows = torch.randint(-(2**31), 2**31, (b, tk.ROW), dtype=torch.int32,
                         generator=gen, device=data.device)
    out = torch.empty((b, tk.ROW), dtype=torch.int32, device=data.device)
    lib = tk.LIBRARY.load()
    stream = torch.cuda.current_stream(0).cuda_stream
    gather_c, scatter_c = (lib.tpu2048_bucket_gather,
                           lib.tpu2048_bucket_scatter)
    args = (data.data_ptr(), idx.data_ptr(), out.data_ptr(), data.shape[0],
            b, 0, stream)
    sargs = (data.data_ptr(), ids.data_ptr(), rows.data_ptr(), data.shape[0],
             b, 0, stream)
    idx64, ids64 = idx.long(), ids.long()
    split = {"batch": b}
    split.update(host_us(torch, {
        "gather_us": lambda: tk.bucket_gather(data, idx),
        "index_select_us": lambda: torch.index_select(data, 0, idx64),
        "gather_c_entry_us": lambda: gather_c(*args),
        "scatter_us": lambda: tk.bucket_scatter_(data, ids, rows),
        "index_copy_us": lambda: data.index_copy_(0, ids64, rows),
        "scatter_c_entry_us": lambda: scatter_c(*sargs),
        "cuda_current_stream_us": (
            lambda: torch.cuda.current_stream(0).cuda_stream),
        "accelerator_current_stream_us": (
            lambda: torch.accelerator.current_stream(0).native_handle),
        "new_empty_us": lambda: data.new_empty(b, tk.BUCKET, tk.WIDTH),
    }))
    print("phase 9: host split " + json.dumps(split))
    return split


def table_timing_only(torch, root):
    """Phase 9 alone on the table kernels of the checkout at ``root``."""
    root = Path(root).resolve()
    if not (root / "tpu2048_torch" / "csrc" / "table_kernel.cu").is_file():
        fail(f"{root} holds no tpu2048_torch package")
    sys.path.insert(0, str(root))
    from tpu2048_torch.ops import table_kernel as tk

    print(f"phase 9: table kernels of {root} (tpu2048_torch from "
          f"{Path(tk.__file__).parent})")
    tk.LIBRARY.load()
    data = torch.zeros(((1 << TABLE_LOG2) // tk.BUCKET + 1, tk.ROW),
                       dtype=torch.int32, device=torch.device("cuda", 0))
    for b in TABLE_TIMING_SIZES:
        phase_table_timing(tk, torch, data, b)
    table_host_split(tk, torch, data, TABLE_BATCH)


def edge_boards(torch, b, device):
    """start_boards with dead boards (no legal move) at lanes b//2 onward:
    plain, holding a 2048, holding two 1024s, and full but for one hole."""
    checker = torch.tensor([1, 2, 1, 2, 2, 1, 2, 1] * 2, dtype=torch.int8,
                           device=device)
    patterns = [checker.clone() for _ in range(4)]
    patterns[1][6] = 11
    patterns[2][0] = patterns[2][15] = 10
    patterns[3][5] = 0
    gen = torch.Generator(device=device).manual_seed(SEED + b)
    boards = start_boards(gen, b, device)
    for j, lane in enumerate(range(b // 2, min(b, b // 2 + 32))):
        boards[:, lane] = patterns[j % 4]
    return boards


def rollout_state(torch, gen, b, device, latch, shaped):
    """Episode lanes mid-game, latch lanes with a fifth already latched, and
    stall lanes mid-count."""
    def ints(lo, hi, shape=(b,), dtype=torch.int32):
        return torch.randint(lo, hi, shape, dtype=dtype, generator=gen,
                             device=device)

    lanes = (edge_boards(torch, b, device), ints(0, 5000), ints(0, 500),
             ints(-100, 5000).to(torch.float32))
    latch_state = None
    if latch:
        latched = (torch.rand(b, generator=gen, device=device)
                   < 0.2).to(torch.int8)
        latch_state = (latched, ints(0, 5000) * latched,
                       ints(1, 500) * latched,
                       ints(1, 12, dtype=torch.int8) * latched,
                       ints(0, 300, (4, b)))
    stall_state = (ints(-1, 4), ints(0, STALL_LIMIT + 1)) if shaped else None
    return lanes, latch_state, stall_state


def spread(outs):
    """The rollout's outputs with the latch and stall tuples spread out."""
    return [x for o in outs for x in (o if isinstance(o, tuple) else (o,))]


def rollout_diff(torch, got, want, what):
    """Max |difference| of two rollouts' outputs; fails unless every output
    is equal (float32 by bit pattern)."""
    got, want = spread(got), spread(want)
    if len(got) != len(want):
        fail(f"rollout at {what}: {len(got)} outputs != {len(want)}")
    err = 0
    for i, (a, c) in enumerate(zip(got, want)):
        if a.dtype != c.dtype or a.shape != c.shape:
            fail(f"rollout at {what}: output {i} {a.dtype}{tuple(a.shape)} "
                 f"!= {c.dtype}{tuple(c.shape)}")
        if a.dtype == torch.float32:
            same = torch.equal(a.view(torch.int32), c.view(torch.int32))
            diff = float((a - c).abs().max())
        else:
            diff = int_diff(torch, a, c)
            same = diff == 0
        if not same:
            fail(f"rollout kernel != plain at {what}: output {i}, max |diff| "
                 f"{diff}")
        err = max(err, diff)
    return err


def rollout_layouts(sk, b):
    """(threads a lane, whether the wrapper picks it) of each rollout layout
    of the checkout at batch ``b``, the wrapper's first. A checkout without
    ``rollout_geometry`` has one layout, one thread a lane."""
    if not hasattr(sk, "rollout_geometry"):
        return [(1, True)]
    picked = sk.rollout_geometry(b)[0]
    return [(picked, True)] + [(n, False) for n in (1, sk.QUAD_THREADS)
                               if n != picked]


def rollout_call(sk, device, lane_threads, picked, *args, **kw):
    """A function that launches the rollout on ``args`` through the wrapper
    (``picked``) or at ``lane_threads`` threads a lane."""
    if picked:
        return lambda: sk.fused_env_rollout(*args, **kw)
    b = args[0].shape[1]
    return lambda: sk.launch_rollout(lane_threads, b, device.index, *args,
                                     **kw)


def layout_name(lane_threads):
    return "quad" if lane_threads > 1 else "thread"


def phase_rollout_equal(sk, torch, device):
    """Both layouts of the rollout kernel against plain_env_rollout on the
    card, external bits, two windows each fed back: B in ROLLOUT_SIZES and
    the layout threshold's neighbours, k in {1, 16}, simple with and
    without the bonus and shaped with and without reset_shaping, each with
    and without latches. Then Philox mode, both layouts and the wrapper,
    against external rows from philox_rows and the plain version, over two
    launches whose step counter turns over its high word. Returns max
    |difference|."""
    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    modes = [(bonus, latch, False, False) for bonus in (False, True)
             for latch in (False, True)]
    modes += [(True, latch, True, reset) for reset in (False, True)
              for latch in (False, True)]
    edge = sk.QUAD_BATCH
    sizes = sorted(set(ROLLOUT_SIZES) | {edge - 1, edge, edge + 1})
    max_err, compared, dones = 0, 0, 0
    windows = dict.fromkeys((1, sk.QUAD_THREADS), 0)
    for b, k in itertools.product(sizes, (1, ROLLOUT_K)):
        for bonus, latch, shaped, reset in modes:
            kw = dict(terminal_bonus=bonus, stall_limit=STALL_LIMIT,
                      reset_shaping=reset)
            lanes, latch_state, stall_state = rollout_state(
                torch, gen, b, device, latch, shaped)
            for _ in range(2):
                bits = torch.cat([edge_bits(gen, b, device)
                                  for _ in range(k)])
                args = (*lanes, k, bits, latch_state, stall_state)
                want = sk.plain_env_rollout(*args, **kw)
                for lane_threads in windows:
                    what = (f"B={b} k={k} bonus={bonus} latch={latch} "
                            f"shaped={shaped} reset_shaping={reset} "
                            f"layout={layout_name(lane_threads)}")
                    got = sk.launch_rollout(lane_threads, b, device.index,
                                            *args, **kw)
                    max_err = max(max_err,
                                  rollout_diff(torch, got, want, what))
                    compared += len(spread(got))
                    windows[lane_threads] += 1
                dones += int(want[5].sum())
                lanes = want[:4]
                latch_state = want[6] if latch else None
                stall_state = want[-1] if shaped else None
    torch.cuda.synchronize()
    if not dones:
        fail("the rollout matrix ended no episode")
    per_layout = ", ".join(f"{n} windows in the {layout_name(t)} layout"
                           for t, n in windows.items())
    print(f"phase 10: rollout kernel == plain_env_rollout on the card, "
          f"external bits, B in {tuple(sizes)}: {per_layout}, {compared} "
          f"outputs, {dones} episode ends, max |diff| {max_err}")

    cases = philox_cases()
    for label, b, config, latch, seed, step0 in cases:
        kw = dict(terminal_bonus=config.terminal_bonus,
                  stall_limit=config.stall_force_done,
                  reset_shaping=config.reset_shaping)
        lanes, latch_state, stall_state = rollout_state(
            torch, gen, b, device, latch, config.shaped)
        for step in (step0, step0 + ROLLOUT_K):
            args = (*lanes, ROLLOUT_K, None, latch_state, stall_state)
            src = dict(seed=seed, step=step)
            want = sk.plain_env_rollout(*args, **src, **kw)
            rows = sk.philox_rows(seed, step, ROLLOUT_K, b, device)
            ext = sk.fused_env_rollout(*lanes, ROLLOUT_K, rows, latch_state,
                                       stall_state, **kw)
            got = sk.fused_env_rollout(*args, **src, **kw)
            what = f"Philox, {label}, B={b} step={step}"
            max_err = max(max_err, rollout_diff(torch, ext, want, what),
                          rollout_diff(torch, got, want, what))
            for lane_threads in windows:
                layout = sk.launch_rollout(lane_threads, b, device.index,
                                           *args, **src, **kw)
                max_err = max(max_err, rollout_diff(
                    torch, layout, want,
                    f"{what} layout={layout_name(lane_threads)}"))
            lanes = want[:4]
            latch_state = want[6] if latch else None
            stall_state = want[-1] if config.shaped else None
    torch.cuda.synchronize()
    print(f"phase 10: Philox mode (wrapper and both layouts) == external "
          f"mode fed philox_rows == plain version at k={ROLLOUT_K}, two "
          f"launches each: "
          f"{'; '.join(f'{c[0]} (B={c[1]})' for c in cases)}: max |diff| "
          f"{max_err}")
    return max_err


def philox_cases():
    """Philox-mode argument sets: (label, B, fast config, latches, seed,
    first step). First those of phase 11's calls, from the step after the
    reset's row: ``bench`` (its env, seed 0) and ``eval --policy random``
    (the CLI's env for each reward, seed SEED). Then stall limit 3 in both
    rewards over a step counter that crosses 2**32."""
    from tpu2048_torch import bench
    from tpu2048_torch.env.env import EnvConfig
    from tpu2048_torch.env.fast import FastEnvConfig, for_env

    def eval_env(reward):
        return for_env(EnvConfig(reward=reward, auto_reset=False))

    cross = 2**32 - 8
    return [
        ("bench", BENCH_BATCH, bench.ROLLOUT_ENV, False, 0, 1),
        ("eval simple", EVAL_GAMES, eval_env("simple"), True, SEED, 1),
        ("eval shaped", EVAL_GAMES, eval_env("shaped"), True, SEED, 1),
        ("eval simple", BIG_EVAL, eval_env("simple"), True, SEED, 1),
        ("simple across 2**32", BENCH_BATCH, FastEnvConfig(), True,
         2**40 + SEED, cross),
        ("shaped, stall limit 3, across 2**32", BENCH_BATCH,
         FastEnvConfig(shaped=True, stall_force_done=STALL_LIMIT), True,
         2**40 + SEED, cross),
    ]


def zero_counts(sk, tk):
    for fn in (sk.fused_env_step, sk.fused_env_rollout, tk.bucket_gather,
               tk.bucket_scatter_):
        fn.launches = 0


def read_counts(sk, tk, torch):
    torch.cuda.synchronize()
    return {"step": sk.fused_env_step.launches,
            "rollout": sk.fused_env_rollout.launches,
            "gather": tk.bucket_gather.launches,
            "scatter": tk.bucket_scatter_.launches}


def run_path(sk, tk, torch, cli_main, argv):
    """One CLI call with every count set to 0 just before and read just
    after; returns its exit code, its stdout and the counts."""
    zero_counts(sk, tk)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    counts = read_counts(sk, tk, torch)
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"cli {' '.join(argv)} returned {rc}")
    return out.getvalue(), counts, wall


def profile_random_eval(torch):
    """One warm random eval of EVAL_GAMES games under torch.profiler: the
    device's busy share of the call and its kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu2048_torch.env.env import EnvConfig
    from tpu2048_torch.env.fast import PhiloxBits
    from tpu2048_torch.eval.evaluate import evaluate, random_legal_policy

    def run():
        result = evaluate(random_legal_policy(), EVAL_GAMES,
                          PhiloxBits(SEED, torch.device("cuda", 0)),
                          env_config=EnvConfig(reward="simple",
                                               auto_reset=False),
                          batch_size=EVAL_GAMES)
        torch.cuda.synchronize()
        return result

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):  # the tracer's own start-up
        run()
    with profile(activities=activities) as prof:
        result = run()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    call_ms = 1e3 * result.seconds
    print(f"phase 11: random eval under the profiler, {EVAL_GAMES} games: "
          f"{call_ms:.3f} ms, {device_ms:.4f} ms of device time in "
          f"{sum(e.count for e in kernels)} kernels of {len(kernels)} names: "
          f"the device is busy {100 * device_ms / call_ms:.1f}% of the call")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"phase 11:   {e.self_device_time_total / 1e3:.4f} ms, "
              f"{e.count} calls: {e.key[:100]}")


@contextlib.contextmanager
def plain_step_kernel(sk):
    """``fused_env_step`` replaced by ``plain_env_step`` for the body (the
    fast env calls it through the module)."""
    kernel = sk.fused_env_step
    sk.fused_env_step = sk.plain_env_step
    try:
        yield
    finally:
        sk.fused_env_step = kernel


def single_step_check(sk, torch, bench):
    """``bench.main(rollout_k=1)`` at SINGLE_STEP_CHECK against the same
    steps through ``plain_env_step`` on the card, fed the generator's rows
    (the reset's, the warm steps', the timed steps') through ReplayBits:
    the timed run's reward and episode totals must be equal."""
    from tpu2048_torch.env.fast import (GeneratorBits, ReplayBits,
                                        fast_reset, fast_step)

    b, steps = SINGLE_STEP_CHECK
    device = torch.device("cuda")
    with contextlib.redirect_stdout(io.StringIO()):
        row = bench.main(batch=b, steps=steps, rollout_k=1)
    source = GeneratorBits(0, device)
    bits = ReplayBits([source(b) for _ in range(1 + 2 * steps)])
    with plain_step_kernel(sk):
        state = fast_reset(bits, b, bench.ROLLOUT_ENV)
        for _ in range(2):  # the warm run, then the timed one
            reward = torch.zeros((), dtype=torch.float32, device=device)
            dones = torch.zeros((), dtype=torch.int64, device=device)
            for _ in range(steps):
                state, ts = fast_step(bench.ROLLOUT_ENV, state, bits)
                reward += ts.reward.sum(dtype=torch.float32)
                dones += ts.done.sum()
    want = (float(reward), int(dones))
    if (row["launches"] != steps or (row["reward"], row["episodes"]) != want
            or not want[1] > 0):
        fail(f"bench --rollout-k 1 at B={b}, {steps} steps: {row} against "
             f"plain_env_step's reward and episodes {want}")
    print(f"phase 11: bench --rollout-k 1 at B={b}, {steps} steps == "
          f"plain_env_step on the card from the same generator rows: "
          f"reward {want[0]!r}, {want[1]} episodes, {row['launches']} "
          f"step-kernel launches")


def profile_single_step(torch, bench, row):
    """One more single-step bench at ``row``'s shape under torch.profiler:
    the device time a step beside the unprofiled row's time a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b, steps = row["batch"], row["steps"]
    with contextlib.redirect_stdout(io.StringIO()):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            bench.main(batch=b, steps=steps, rollout_k=1)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    # Warm and timed runs: 2 x steps steps.
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    step_ms = 1e3 * row["seconds"] / steps
    device_step = device_ms / (2 * steps)
    print(f"phase 11: bench --rollout-k 1 under the profiler, B={b}: "
          f"{device_step:.4f} ms of device time a step in "
          f"{sum(e.count for e in kernels) / (2 * steps):.1f} kernels; the "
          f"unprofiled step takes {step_ms:.4f} ms: the device is busy "
          f"{100 * device_step / step_ms:.1f}% of it")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"phase 11:   {e.self_device_time_total / 1e3 / (2 * steps):.5f}"
              f" ms a step, {e.count} calls: {e.key[:100]}")


def phase_rollout_path(sk, tk, torch):
    """The rollout slice's path through the CLI: random eval (512 games,
    simple and shaped; 65536 games), bench, bench --rollout-k 1 and bench
    --tabular on both tables. Returns each kernel's launches over the
    path's CLI calls and the random evals' summaries."""
    from tpu2048_torch import bench
    from tpu2048_torch.cli.main import main as cli_main

    launches = dict.fromkeys(("step", "rollout", "gather", "scatter"), 0)

    def count(counts):
        for name in launches:
            launches[name] += counts[name]

    summaries = {}
    evals = [("simple", EVAL_GAMES), ("simple, warm", EVAL_GAMES),
             ("shaped", EVAL_GAMES), ("simple", BIG_EVAL)]
    for label, games in evals:
        argv = ["eval", "--policy", "random", "--games", str(games),
                "--eval-batch", str(games), "--seed", str(SEED)]
        if label == "shaped":
            argv += ["--reward", "shaped"]
        text, counts, wall = run_path(sk, tk, torch, cli_main, argv)
        summary = json.loads(text)
        windows = summary["batch_steps"] // ROLLOUT_K
        tiles = summary["max_tile_distribution"]
        mode_tile = int(max(tiles, key=lambda t: tiles[t]))
        total_length = round(summary["length_mean"] * games)
        if (counts["rollout"] != windows or windows == 0
                or counts["step"] or counts["gather"] or counts["scatter"]):
            fail(f"random eval ({label}, {games} games): {counts} launches "
                 f"for {windows} windows")
        if (summary["games"] != games or mode_tile not in (64, 128)
                or sum(summary["action_counts"].values()) != total_length
                or summary["env_steps"] != summary["batch_steps"] * games):
            fail(f"implausible random eval ({label}): {summary}")
        count(counts)
        summaries[label, games] = summary
        secs = summary["seconds"]
        print(f"phase 11: eval --policy random, {label}, {games} games: "
              f"{windows} rollout launches = {summary['batch_steps']} steps / "
              f"{ROLLOUT_K}, no other kernel; {games / secs:.1f} games/s, "
              f"{summary['env_steps'] / secs:.0f} env-steps/s ({secs:.4f} s "
              f"of games, {wall:.3f} s for the CLI call); score mean "
              f"{summary['score_mean']:.1f}, length mean "
              f"{summary['length_mean']:.1f}, max tiles {tiles}")

    profile_random_eval(torch)

    text, counts, wall = run_path(sk, tk, torch, cli_main, ["bench"])
    row = json.loads(text)
    windows = row["steps"] // ROLLOUT_K
    if (row["launches"] != windows or counts["rollout"] != 2 * windows
            or counts["step"] or row["batch"] != BENCH_BATCH
            or row["bits"] != "philox" or "vs_baseline" in row
            or not row["env_steps_per_s"] > 0 or not row["episodes"] > 0):
        fail(f"bench: {row}, launches {counts}")
    count(counts)
    print(f"phase 11: bench: {json.dumps(row)}; {counts['rollout']} "
          f"rollout launches (warm-up and timed run), {wall:.3f} s for the "
          f"CLI call")

    text, counts, wall = run_path(sk, tk, torch, cli_main,
                                  ["bench", "--rollout-k", "1"])
    single = json.loads(text)
    if (single["launches"] != single["steps"] or single["rollout_k"] != 1
            or counts["step"] != 2 * single["steps"]
            or single["batch"] != BENCH_BATCH
            or single["bits"] != "generator" or counts["rollout"]
            or counts["gather"] or counts["scatter"]
            or not single["env_steps_per_s"] > 0
            or not single["episodes"] > 0):
        fail(f"bench --rollout-k 1: {single}, launches {counts}")
    count(counts)
    print(f"phase 11: bench --rollout-k 1: {json.dumps(single)}; "
          f"{counts['step']} step-kernel launches (warm-up and timed run), "
          f"no other kernel; {wall:.3f} s for the CLI call; "
          f"{single['env_steps_per_s'] / row['env_steps_per_s']:.4f}x the "
          f"K={ROLLOUT_K} rollout bench's env-steps/s")
    single_step_check(sk, torch, bench)
    profile_single_step(torch, bench, single)

    # One warm chunk and the timed ones.
    steps = (1 + bench.TABULAR_TIMED_CHUNKS) * bench.TABULAR_STEPS_PER_CHUNK
    tabs = {}
    for backend, resolved, tables in (("auto", "packed", 1),
                                      ("legacy", "legacy", 0)):
        argv = ["bench", "--tabular", "--table-backend", backend]
        text, counts, wall = run_path(sk, tk, torch, cli_main, argv)
        tab = json.loads(text)
        if (tab["batch"] != 4096 or tab["table_backend"] != resolved
                or tab["capacity_log2"] != bench.TABULAR_CAPACITY_LOG2
                or counts["step"] != steps
                or counts["scatter"] != tables * steps
                or counts["gather"] != 2 * tables * steps
                or counts["rollout"] or not tab["env_steps_per_s"] > 0):
            fail(f"bench --tabular --table-backend {backend}: {tab}, "
                 f"launches {counts}")
        count(counts)
        tabs[resolved] = tab
        print(f"phase 11: bench --tabular --table-backend {backend}: "
              f"{json.dumps(tab)}; launches {counts} for {steps} steps; "
              f"{wall:.3f} s for the CLI call")
    print(f"phase 11: bench --tabular, legacy against packed in this call: "
          f"{tabs['legacy']['ms_per_step'] / tabs['packed']['ms_per_step']:.3f}"
          f"x the ms a step")
    return launches, summaries


def rollout_work(sk, lanes, k, bits):
    """Lane-steps that move and that end an episode in this window, by
    stepping the plain version with the same bits."""
    from tpu2048_torch.ops import board as board_ops

    boards = lanes[0]
    moved = done = 0
    for it in range(k):
        rows = bits[8 * it:8 * it + 8]
        legal = board_ops.legal_moves_mask(sk.from_cell_major(boards))
        action = sk.rand_legal_action(legal, rows[0])
        boards, _, valid, ended = sk.plain_env_step(boards, action, rows)[:4]
        moved += int(valid.sum())
        done += int(ended.sum())
    return moved, done


def phase_rollout_timing(sk, torch, device, b, philox, latch):
    """One rollout window of ROLLOUT_K steps at batch ``b`` (simple, bonus
    on), in each layout of the checkout: eager and graph-replayed kernel
    time, one plain call, the bound from the bytes and operations this
    window needs, and in the layout the wrapper picks the host time of its
    call. Each layout's outputs must equal the plain call's. Returns the
    rows, the wrapper's first."""
    gen = torch.Generator(device=device).manual_seed(SEED + 20 + b)
    lanes, latch_state, _ = rollout_state(torch, gen, b, device, latch,
                                          False)
    lanes = (start_boards(gen, b, device),) + lanes[1:]
    k, seed, step = ROLLOUT_K, SEED, 0
    rows = sk.philox_rows(seed, step, k, b, device)
    src = dict(seed=seed, step=step) if philox else {}
    args = (*lanes, k, None if philox else rows, latch_state)

    moved, done = rollout_work(sk, lanes, k, rows)
    lane_steps = b * k
    # Each input read once and each output written once: board, score,
    # steps, return in (28 B) and out with the two window sums (36 B); the
    # latch lanes (26 B) in and out; external bits as each lane-step needs
    # them (row 0, rows 2-3 where it moves, rows 4-7 where it ends).
    n_bytes = b * (28 + 36 + (52 if latch else 0))
    if not philox:
        n_bytes += 4 * lane_steps + 8 * moved + 16 * done
    n_ops = (lane_steps * (OPS_LANE + OPS_PICK + OPS_WINDOW
                           + (OPS_LATCH if latch else 0))
             + OPS_SPAWN * moved + OPS_RESET * done)
    if philox:
        n_ops += OPS_PHILOX * (lane_steps + done)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / int_ops_per_s() * 1e3
    t0 = time.perf_counter()
    want = sk.plain_env_rollout(*args, **src)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    out = []
    for lane_threads, picked in rollout_layouts(sk, b):
        kernel = rollout_call(sk, device, lane_threads, picked, *args, **src)
        rollout_diff(torch, kernel(), want,
                     f"the timed call at B={b} layout "
                     f"{layout_name(lane_threads)}")
        row = {
            "kernel": "rollout_kernel", "batch": b, "k": k,
            "bits": "philox" if philox else "external", "latch": latch,
            "layout": layout_name(lane_threads),
            "lane_threads": lane_threads, "picked": picked,
            "ms": elapsed_ms(torch, kernel, 100),
            "graph_ms": graph_ms(torch, kernel, 10),
            **(host_us(torch, {"host_us": kernel}) if picked else {}),
            "plain_ms": plain_ms,
            "moved_lane_steps": moved, "done_lane_steps": done,
            "bytes": n_bytes, "ops": n_ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        row["graph_env_steps_per_s"] = lane_steps / (row["graph_ms"] / 1e3)
        print("phase 12: " + json.dumps(row))
        out.append(row)
    return out


def rollout_host_split(sk, torch, device, b):
    """Where a rollout call's host time goes at batch ``b`` (random eval's
    call: Philox, latches): the whole call, and the parts of its launch
    path that the checkout has. With the one-allocation path: the input
    checks, the bare C entry (ctypes and the launch, arguments made
    beforehand), the stream lookup, the output buffer's allocation and the
    carving of its views. Before it: the library lookup, torch.cuda's
    stream lookup and the 11 separate outputs."""
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    lanes, latch_state, _ = rollout_state(torch, gen, b, device, True, False)
    src = dict(seed=SEED, step=0)
    args = (*lanes, ROLLOUT_K, None, latch_state)
    fns = {"rollout_us": lambda: sk.fused_env_rollout(*args, **src)}
    if hasattr(sk, "launch_rollout"):
        n_bytes, *_, offsets = sk.rollout_output_layout(b, True, False)
        buf = lanes[0].new_empty(n_bytes)
        base = buf.data_ptr()
        entry = sk.LIBRARY.load().tpu2048_rollout_kernel
        ptrs = [t.data_ptr() for t in lanes] + [None, None, None] + [
            t.data_ptr() for t in latch_state]
        c_args = (*ptrs, *[None if o is None else base + o for o in offsets],
                  ROLLOUT_K, True, 100, False, SEED, 0, b,
                  sk.rollout_geometry(b)[0], device.index,
                  torch.accelerator.current_stream(device.index)
                  .native_handle)
        fns.update({
            "check_us": lambda: sk._check_rollout(*args, None, SEED, 0),
            "c_entry_us": lambda: entry(*c_args),
            "accelerator_current_stream_us": (
                lambda: torch.accelerator.current_stream(0).native_handle),
            "new_empty_us": lambda: lanes[0].new_empty(n_bytes),
            "carve_us": lambda: sk.carve_rollout_outputs(buf, b, True,
                                                         False),
        })
    else:
        outs = [*lanes, lanes[1], lanes[1], *latch_state]
        fns.update({
            "library_load_us": sk.LIBRARY.load,
            "cuda_current_stream_us": (
                lambda: torch.cuda.current_stream(device).cuda_stream),
            "empty_like_x11_us": (
                lambda: [torch.empty_like(t) for t in outs]),
        })
    split = {"batch": b, **host_us(torch, fns)}
    print("phase 12: host split " + json.dumps(split))
    return split


def phase_rollout_timings(sk, torch, device, cases):
    """Phase 12 at each (batch, Philox, latches) of ``cases``, then the
    host split at random eval's call; returns the rows of the first case."""
    rows = [phase_rollout_timing(sk, torch, device, b, philox, latch)
            for b, philox, latch in cases]
    rollout_host_split(sk, torch, device, EVAL_GAMES)
    return rows[0]


def dqn_forward_flops(features, hidden, blocks, fused=False):
    """Multiply-add operations x 2 of one board through the Q-network:
    each block's four convolutions over the 16 cells of the SAME-padded
    board (k*k taps each, ``features / 4`` filters), the dense layer and the
    head. ``fused``: the fused block's own work, one 4x4 convolution (16
    taps) for all ``features`` filters, the zero-embedded taps included."""
    taps = 4 * 16 if fused else sum(k * k for k in (1, 2, 3, 4))
    conv = sum(2 * 16 * taps * (16 if i == 0 else features) * (features // 4)
               for i in range(blocks))
    return conv + 2 * 16 * features * hidden + 2 * hidden * 4


def learner_bound_ms(n_params, batch, features, hidden, blocks, fused=False):
    """The least time of one update on the card: the larger of its
    operations at the bf16 dense peak (a train forward, a backward of twice
    its work, and a target forward; ``fused``: of the fused module) and its
    bytes at the HBM rate (the float32 parameters, target parameters and
    Adam's two moments read once; the parameters and moments written
    once)."""
    ops = 4 * batch * dqn_forward_flops(features, hidden, blocks, fused)
    bytes_moved = 4 * n_params * 7
    return (max(ops / BF16_FLOPS_PER_S, bytes_moved / HBM_BYTES_PER_S) * 1e3,
            ops, bytes_moved)


def profile_dqn_step(torch, device, ck):
    """Warm vector steps of the trainer restored from the main path's last
    checkpoint, at the `train dqn` defaults and ``DQN_SPLIT_UPDATES`` fixed
    updates a step: the host clock of a step, the forward alone, and one
    step under torch.profiler split by the trainer's scopes (actor, env
    step, replay add, learner) on the host and on the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu2048_torch.checkpoint.ckpt import CheckpointManager
    from tpu2048_torch.ops.step_kernel import from_cell_major
    from tpu2048_torch.training import dqn as dtrain

    config = dtrain.DQNTrainConfig(steps_per_chunk=1,
                                   updates_per_step=DQN_SPLIT_UPDATES,
                                   seed=SEED)
    state = dtrain.init_loop_state(config, device)
    mgr = CheckpointManager(ck)
    mgr.restore(mgr.latest_step(), state)
    for _ in range(3):
        dtrain.train_chunk(config, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        dtrain.train_chunk(config, state)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 10
    boards = from_cell_major(state.env_state.boards)
    model = state.agent.model.eval()
    with torch.no_grad():
        forward_ms = elapsed_ms(torch, lambda: model(boards), 20)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):  # the tracer's own start-up
        dtrain.train_chunk(config, state)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        dtrain.train_chunk(config, state)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    # Each kernel's time goes to the host op that launched it, and that op
    # to the scope whose host range holds its start: the scopes' device
    # times are the kernels they launched, not their spans on the device.
    events = prof.events()
    ranges = {scope: [(e.time_range.start, e.time_range.end) for e in events
                      if e.name == scope and e.device_type == DeviceType.CPU]
              for scope in DQN_SCOPES}
    split = {scope: [sum(b - a for a, b in r) / 1e3, 0.0]
             for scope, r in ranges.items()}
    by_name = {}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        t = e.time_range.start
        for k in e.kernels:
            total, count = by_name.get(k.name, (0.0, 0))
            by_name[k.name] = (total + k.duration / 1e3, count + 1)
        for scope, r in ranges.items():
            if any(a <= t <= b for a, b in r):
                split[scope][1] += sum(k.duration for k in e.kernels) / 1e3
    if not by_name:
        # No kernel attached to a host op: take the device's kernels from
        # the averages, leaving out the scopes' and the optimizer's ranges
        # on the device; the scopes' device times are then not measured.
        print("phase 13: the trace attaches no kernel to a host op; device "
              "time by scope: not measured")
        by_name = {e.key: (e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and e.key not in DQN_SCOPES
                   and not e.key.startswith("Optimizer.")}
    device_ms = sum(total for total, _ in by_name.values())
    n_kernels = sum(count for _, count in by_name.values())
    print(f"phase 13: split of one warm vector step ({DQN_ENVS} envs, "
          f"{DQN_SPLIT_UPDATES} updates of batch 64, full width): "
          f"{step_ms:.3f} ms a step on the host clock (10 steps); the "
          f"forward alone at batch {DQN_ENVS} {forward_ms:.3f} ms (CUDA "
          f"events); under the profiler {traced_ms:.3f} ms, "
          f"{device_ms:.3f} ms of device time in {n_kernels} kernels: the "
          f"device is busy {100 * device_ms / traced_ms:.1f}% of the step")
    for scope, (host, dev) in split.items():
        per = (f"; per update {host / DQN_SPLIT_UPDATES:.3f} ms host, "
               f"{dev / DQN_SPLIT_UPDATES:.3f} ms device"
               if scope == "learner" else "")
        print(f"phase 13:   {scope}: {host:.3f} ms host, "
              f"{dev:.3f} ms of kernels{per}")
    for name, (total, count) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][0])[:12]:
        print(f"phase 13:   {total:.4f} ms, {count} calls: {name[:100]}")
    return split, forward_ms


def phase_dqn_path(sk, tk, torch, device):
    """The DQN main path through the CLI at full width: `train dqn`, then
    `--resume` and `eval --policy model --checkpoint-dir`. Returns the step
    kernel's launches in the `train dqn` call."""
    from tpu2048_torch.cli.main import main as cli_main
    from tpu2048_torch.metrics.logging import read_jsonl

    with tempfile.TemporaryDirectory() as tmp:
        ck, log = os.path.join(tmp, "ck"), os.path.join(tmp, "train.jsonl")
        trace = os.path.join(tmp, "trace.csv")
        argv = ["train", "dqn", "--episodes", str(DQN_EPISODES),
                "--checkpoint-dir", ck, "--log", log, "--seed", str(SEED),
                "--debug-csv", trace, "--watchdog", str(WATCHDOG_S)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, counts, wall = run_path(sk, tk, torch, cli_main, argv)
        peak = torch.cuda.max_memory_allocated()
        rows = read_jsonl(log)
        for row in rows:
            print("phase 13: row " + json.dumps(row))
        last = rows[-1] if rows else {}
        steps = last.get("env_steps", 0) // DQN_ENVS
        if (len(rows) < 3 or steps != len(rows) * DQN_CHUNK
                or counts["step"] != steps or counts["rollout"]
                or counts["gather"] or counts["scatter"]):
            fail(f"train dqn: {len(rows)} chunks, {steps} vector steps, "
                 f"launches {counts}")
        if (last["train_steps"] + last["update_debt"]
                != 100 * last["episodes"] or last["train_steps"] < 1000
                or not math.isfinite(last["loss"])
                or any(set(r) != DQN_ROW_KEYS for r in rows)
                or sum(last["tile_hist"]) != last["episodes"]):
            fail(f"train dqn: implausible last row {last}")
        print(f"phase 13: train dqn, full width, {DQN_ENVS} envs, batch 64, "
              f"{DQN_EPISODES} episodes: {counts['step']} step-kernel "
              f"launches = {steps} vector steps, no other kernel; "
              f"{last['train_steps']} updates + {last['update_debt']} owed "
              f"= 100 x {last['episodes']} episodes; {wall:.3f} s for the "
              f"CLI call; peak device memory {peak} bytes")
        prev_updates = 0
        for i, row in enumerate(rows):
            upd = (row["train_steps"] - prev_updates) / DQN_CHUNK
            prev_updates = row["train_steps"]
            print(f"phase 13: chunk {i + 1}: "
                  f"{1e3 * DQN_ENVS / row['steps_per_s']:.3f} ms a vector "
                  f"step, {upd:.2f} updates a step, {row['steps_per_s']:.0f} "
                  f"env-steps/s")
        with open(trace, newline="") as fh:
            lines = list(csv.reader(fh))
        if lines[:1] != [DEBUG_CSV_HEADER] or len(lines) != 1 + steps:
            fail(f"train dqn --debug-csv: header {lines[:1]}, "
                 f"{len(lines) - 1} rows for {steps} vector steps")
        ends = sum(row[6] == "True" for row in lines[1:])
        print(f"phase 13: --debug-csv: the reference's header and "
              f"{len(lines) - 1} rows = {steps} vector steps (env 0 ended "
              f"{ends} episode(s)); --watchdog {WATCHDOG_S} never fired")
        rc, summary = run_cli(cli_main, ["analyze", "--log", log])
        if (rc != 0 or summary["episodes"] != last["episodes"]
                or summary["train_steps"] != last["train_steps"]
                or summary["best_tile"] != last["best_tile"]):
            fail(f"analyze of the run's JSONL: {summary}")
        print("phase 13: analyze of the run's JSONL: " + json.dumps(
            {k: summary[k] for k in ("episodes", "env_steps", "best_tile",
                                     "train_steps", "late_mean_score",
                                     "final_tile_distribution")}))
        profile_dqn_step(torch, device, ck)

        text, rcounts, rwall = run_path(sk, tk, torch, cli_main, [
            "train", "dqn", "--episodes", str(last["episodes"] + 1),
            "--checkpoint-dir", ck, "--resume", "--log", log])
        resumed = read_jsonl(log)[len(rows):]
        if (not resumed or resumed[0]["env_steps"]
                != last["env_steps"] + DQN_ENVS * DQN_CHUNK
                or rcounts["step"] != DQN_CHUNK * len(resumed)
                or resumed[-1]["episodes"] <= last["episodes"]):
            fail(f"train dqn --resume: rows {resumed}, launches {rcounts}")
        print(f"phase 13: --resume: {len(resumed)} chunk(s) from episode "
              f"{last['episodes']}, env_steps {resumed[0]['env_steps']}, "
              f"{rcounts['step']} step-kernel launches; {rwall:.3f} s for "
              f"the CLI call (the restore of the whole loop state "
              f"included)")

        text, ecounts, ewall = run_path(sk, tk, torch, cli_main, [
            "eval", "--policy", "model", "--checkpoint-dir", ck, "--games",
            str(DQN_EVAL_GAMES), "--eval-batch", str(DQN_EVAL_GAMES)])
        summary = json.loads(text)
        if (summary["games"] != DQN_EVAL_GAMES
                or ecounts["step"] != summary["batch_steps"]
                or not summary["length_mean"] > 0):
            fail(f"eval --checkpoint-dir: {summary}, launches {ecounts}")
        print(f"phase 13: eval --policy model --checkpoint-dir, the trained "
              f"weights: {summary['games']} games, score mean "
              f"{summary['score_mean']:.1f}, best tile "
              f"{summary['best_tile']}, {ecounts['step']} step-kernel "
              f"launches = {summary['batch_steps']} steps; {ewall:.3f} s "
              f"for the CLI call")
    return counts["step"], rows


def endgame_boards(gen, n):
    """(n, 4, 4) int8 dense boards with one empty cell; a third hold a 2048
    and a third two 1024s, so that games end within a few steps."""
    import torch

    boards = torch.randint(1, 9, (n, 16), dtype=torch.int8, generator=gen)
    third = n // 3
    boards[:third, 5] = 11
    boards[third:2 * third, 0] = 10
    boards[third:2 * third, 15] = 10
    boards[torch.arange(n), torch.randint(0, 16, (n,), generator=gen)] = 0
    return boards.view(n, 4, 4)


class HostDraws:
    """The port's GeneratorDraws on the CPU, its select draws moved to
    ``device``: the same draws for a trainer on the card and on the CPU."""

    def __init__(self, seed, device):
        from tpu2048_torch.agents.dqn import GeneratorDraws

        self.source = GeneratorDraws(seed, "cpu")
        self.device = device

    def select(self, b):
        return tuple(x.to(self.device) for x in self.source.select(b))

    def indices(self, buffer, batch, alpha):
        return self.source.indices(buffer, batch, alpha)


def phase_dqn_narrow(torch, device, fused=False):
    """A narrow DQN trainer on the card and on the CPU, on the same bits,
    draws and weights: integer state equal, parameters and losses within
    the stated tolerances (phase 14; with ``fused``, the fused conv in
    phase 16)."""
    label = "phase 16" if fused else "phase 14"
    from tpu2048_torch.agents.dqn import DQNConfig, current_lr
    from tpu2048_torch.env import fast as tfast
    from tpu2048_torch.ops.board import legal_moves_mask
    from tpu2048_torch.ops.step_kernel import from_cell_major, to_cell_major
    from tpu2048_torch.training import dqn as dtrain

    b, steps, chunks, updates = 256, 16, 3, 4
    agent = DQNConfig(features=32, hidden=32, num_blocks=1, bf16=False,
                      dropout=0.0, memory_size=2048, fused_conv=fused)
    config = dtrain.DQNTrainConfig(agent=agent, num_envs=b, train_batch=32,
                                   steps_per_chunk=steps,
                                   updates_per_step=updates, seed=SEED)
    gen = torch.Generator().manual_seed(SEED + 9)
    bits = [torch.randint(-(2**31), 2**31, (8, b), dtype=torch.int32,
                          generator=gen) for _ in range(steps * chunks + 1)]
    endgame = endgame_boards(gen, b - b // 2)
    weights = None
    states = []
    for dev in (device, torch.device("cpu")):
        st = dtrain.init_loop_state(config, dev)
        if weights is None:
            # The head's actions 0.05 apart, as tie_free_narrow_params
            # makes them: float32 sum order cannot flip a greedy choice.
            with torch.no_grad():
                st.agent.model.head.weight.mul_(0.02)
                st.agent.model.head.bias.copy_(0.05 * torch.arange(4))
            weights = {k: v.detach().cpu().clone() for k, v in
                       st.agent.model.state_dict().items()}
        st.agent.model.load_state_dict(weights)
        st.agent.target.load_state_dict(weights)
        replay = tfast.ReplayBits([x.to(dev) for x in bits])
        st.env_state = tfast.fast_reset(replay, b, dtrain.fast_config(config))
        # Half the lanes on dense endgame boards, so that episodes end (with
        # terminal bonuses and LR triggers) within the chunks.
        late = torch.cat([from_cell_major(st.env_state.boards[:, :b // 2]),
                          endgame.to(dev)])
        st.env_state.boards = to_cell_major(late)
        st.env_state.legal = legal_moves_mask(late)
        st.bits, st.draws = replay, HostDraws(SEED + 10, dev)
        for _ in range(chunks):
            dtrain.train_chunk(config, st)
        states.append(st)
    card, cpu = states

    def same(a, c, what):
        if not torch.equal(a.cpu(), c):
            fail(f"{label}: narrow DQN trainer: {what}, card != CPU")

    for name in ("boards", "legal", "score", "episode_steps",
                 "episode_return"):
        same(getattr(card.env_state, name), getattr(cpu.env_state, name),
             name)
    for name in ("s", "ns", "saved_count", "last_saved"):
        same(getattr(card.dedup, name), getattr(cpu.dedup, name),
             f"dedup {name}")
    for name in ("boards", "next_boards", "actions", "rewards", "dones",
                 "priorities", "ptr", "size", "max_priority"):
        a, c = getattr(card.buffer, name), getattr(cpu.buffer, name)
        same(a[:agent.memory_size] if a.dim() else a,
             c[:agent.memory_size] if c.dim() else c, f"buffer {name}")
    for name in ("best_tile", "tile_hist", "sum_return", "sum_score",
                 "sum_length", "sum_final_tile"):
        same(getattr(card, name), getattr(cpu, name), name)
    for name in dtrain.DQNLoopState.COUNTERS:
        if getattr(card, name) != getattr(cpu, name):
            fail(f"{label}: narrow DQN trainer: {name}, card != CPU")
    if (card.agent.train_steps != cpu.agent.train_steps
            or card.agent.step_counter != cpu.agent.step_counter
            or current_lr(card.agent) != current_lr(cpu.agent)
            or card.agent.train_steps != updates * steps * chunks
            or card.episodes_done < b // 4
            or not current_lr(card.agent) < agent.learning_rate):
        fail(f"{label}: narrow DQN trainer: agent counters or LR, "
             "card != CPU")
    diffs = torch.cat([(p.detach().cpu() - q.detach()).abs().flatten()
                       for p, q in zip(card.agent.model.parameters(),
                                       cpu.agent.model.parameters())])
    loose = int((diffs > DQN_NARROW_PARAM_ATOL).sum())
    loss_err = max(
        abs(float(getattr(card, k)) - float(getattr(cpu, k)))
        / max(abs(float(getattr(cpu, k))), 1e-30)
        for k in ("loss_sum", "last_loss"))
    if (loose > diffs.numel() * DQN_NARROW_LOOSE_SHARE
            or loss_err > DQN_NARROW_LOSS_RTOL
            or not math.isfinite(float(card.loss_sum))):
        fail(f"{label}: narrow DQN trainer: parameters {loose} of "
             f"{diffs.numel()} "
             f"beyond {DQN_NARROW_PARAM_ATOL}, max {float(diffs.max()):.3e};"
             f" loss {loss_err:.3e}")
    print(f"{label}: narrow DQN trainer (B={b}, features 32, hidden 32, 1 "
          f"block, {'fused conv, ' if fused else ''}float32, TF32 off; "
          f"{chunks} chunks of {steps} steps, "
          f"{updates} updates a step), card == CPU on the integer state "
          f"({card.episodes_done} episodes, buffer {int(card.buffer.size)}, "
          f"{card.agent.train_steps} updates, LR {current_lr(card.agent)}); "
          f"parameters: max |diff| "
          f"{float(diffs.max()):.3e}, {loose} of {diffs.numel()} beyond "
          f"{DQN_NARROW_PARAM_ATOL} (at most {DQN_NARROW_LOOSE_SHARE:.1%}); "
          f"losses within {loss_err:.3e} of |loss| (tolerance "
          f"{DQN_NARROW_LOSS_RTOL})")


def phase_dqn_benches(sk, tk, torch):
    """`bench --learner` and `bench --train-loop` through the CLI."""
    from tpu2048_torch.agents.dqn import DQNConfig
    from tpu2048_torch.cli.main import main as cli_main
    from tpu2048_torch.models import dqn as tdqn

    full = DQNConfig()  # the reference's widths: 2048, 1024, 3 blocks
    n_params = tdqn.param_count(tdqn.create_model(full, "meta"))

    text, counts, wall = run_path(sk, tk, torch, cli_main,
                                  ["bench", "--learner"])
    learner = json.loads(text.strip().splitlines()[-1])
    bound, ops, bytes_moved = learner_bound_ms(
        n_params, 64, full.features, full.hidden, full.num_blocks)
    if (learner["metric"] != "dqn_updates_per_s_per_chip"
            or not learner["value"] > 0 or learner["batch"] != 64
            or learner["features"] != full.features or any(counts.values())
            or not math.isfinite(learner["loss"])):
        fail(f"bench --learner: {learner}, launches {counts}")
    print(f"phase 15: bench --learner: {json.dumps(learner)}; "
          f"{wall:.3f} s for the CLI call; bound {bound:.4f} ms an update "
          f"({ops:.4g} operations at {BF16_FLOPS_PER_S:.3g}/s, "
          f"{bytes_moved:.4g} bytes at {HBM_BYTES_PER_S:.3g}/s): "
          f"{learner['ms_per_update'] / bound:.2f}x the bound")

    text, counts, wall = run_path(sk, tk, torch, cli_main,
                                  ["bench", "--train-loop"])
    loop = json.loads(text.strip().splitlines()[-1])
    steps = loop["steps_per_chunk"] * loop["chunks"]
    if (loop["metric"] != "train_loop_env_steps_per_s_per_chip"
            or not loop["value"] > 0 or loop["envs"] != DQN_ENVS
            or loop["launches"] != steps
            or counts["step"] != steps + loop["steps_per_chunk"]
            or counts["rollout"] or counts["gather"] or counts["scatter"]):
        fail(f"bench --train-loop: {loop}, launches {counts}")
    print(f"phase 15: bench --train-loop: {json.dumps(loop)}; "
          f"{counts['step']} step-kernel launches (warm chunk and timed); "
          f"{wall:.3f} s for the CLI call")
    return learner, loop


def fused_pair(torch, device):
    """The full-width bf16 Q-network with weights from ``SEED``, as the
    four-convolution module and as the fused one on the same weights."""
    from tpu2048_torch.agents.dqn import DQNConfig
    from tpu2048_torch.models import dqn as tdqn

    four = tdqn.init_params(tdqn.create_model(DQNConfig(), device),
                            torch.Generator(device=device).manual_seed(SEED))
    fused = tdqn.create_model(DQNConfig(fused_conv=True), device)
    fused.load_state_dict(four.state_dict())
    return four.eval(), fused.eval()


def phase_fused_forward(torch, device):
    """The fused forward against the four-conv forward at full width on the
    same boards, at ``train dqn``'s and the eval's batch, and both timed
    eagerly in turns (four, fused, fused, four)."""
    four, fused = fused_pair(torch, device)
    gen = torch.Generator().manual_seed(SEED + 12)
    for b in FUSED_Q_BATCHES:
        boards = torch.randint(0, 12, (b, 4, 4), dtype=torch.int8,
                               generator=gen)
        boards[torch.rand((b, 4, 4), generator=gen) < 0.3] = 0
        boards = boards.to(device)
        with torch.inference_mode():
            q4, qf = four(boards).float(), fused(boards).float()
            times = {"four": [], "fused": []}
            for name in ("four", "fused", "fused", "four"):
                model = four if name == "four" else fused
                times[name].append(elapsed_ms(torch, lambda: model(boards),
                                              50))
        err = float((qf - q4).abs().max())
        tol = DQN_MODEL_BF16_TOL * max(1.0, float(q4.abs().max()))
        top2 = q4.topk(2, dim=1).values
        sure = (top2[:, 0] - top2[:, 1]) > tol
        agree = (qf.argmax(1) == q4.argmax(1))[sure]
        if (not torch.isfinite(qf).all() or not err <= tol
                or not bool(agree.all())):
            fail(f"fused forward at batch {b}: max |dQ| {err:.3e} against "
                 f"{tol:.3e}, greedy agreement {int(agree.sum())} of "
                 f"{int(sure.sum())}")
        print(f"phase 16: fused vs four-conv forward, full width, bf16, "
              f"batch {b}: max |dQ| {err:.3e} (tolerance {tol:.3e} = "
              f"{DQN_MODEL_BF16_TOL} x max(1, max |Q|)); greedy actions "
              f"agree on {int(agree.sum())} of {int(sure.sum())} boards "
              f"whose top-two gap exceeds it (of {b}); eager forward "
              f"four-conv {fmt_ms(times['four'])} ms, fused "
              f"{fmt_ms(times['fused'])} ms (CUDA events, 50 calls, in "
              f"turns)")
    del four, fused
    torch.cuda.empty_cache()


def fmt_ms(values):
    return ", ".join(f"{v:.4f}" for v in values)


def phase_fused_learner(torch, device):
    """One learner update at batch 64 as `bench --learner` runs it, with the
    four-conv and the fused module, in one call and in turns: ms an update
    (host clock between synchronisations), and under torch.profiler the
    kernels and the device time an update, the device's busy share, and
    both bounds. Returns the rows."""
    from tpu2048_torch import bench
    from tpu2048_torch.agents.dqn import DQNConfig
    from tpu2048_torch.metrics import profiling
    from tpu2048_torch.models import dqn as tdqn
    from torch.autograd import DeviceType

    full = DQNConfig()
    n_params = tdqn.param_count(tdqn.create_model(full, "meta"))
    updates = {
        name: bench.learner_update(DQNConfig(memory_size=4096,
                                             fused_conv=fused), 64, device)[1]
        for name, fused in (("four", False), ("fused", True))}
    ms = {"four": [], "fused": []}
    for name in ("four", "fused", "fused", "four"):
        ms[name].append(1e3 * profiling.time_fn(
            updates[name], iters=FUSED_TIMED_UPDATES, warmup=20))
    rows = {}
    for name, update in updates.items():
        with tempfile.TemporaryDirectory() as tmp:
            with profiling.trace(tmp) as prof:
                for _ in range(FUSED_TRACED_UPDATES):
                    loss = update()
                torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not e.key.startswith("Optimizer.")]
        n = sum(e.count for e in kernels) / FUSED_TRACED_UPDATES
        dev_ms = (sum(e.self_device_time_total for e in kernels) / 1e3
                  / FUSED_TRACED_UPDATES)
        bound, ops, moved = learner_bound_ms(
            n_params, 64, full.features, full.hidden, full.num_blocks,
            fused=name == "fused")
        best = min(ms[name])
        rows[name] = dict(ms=ms[name], kernels=n, device_ms=dev_ms,
                          busy=dev_ms / best, bound=bound, ops=ops,
                          loss=float(loss))
        if not math.isfinite(float(loss)) or not n > 0:
            fail(f"learner update, {name}: loss {float(loss)}, {n} kernels")
        print(f"phase 16: learner update at batch 64, {name}: "
              f"{fmt_ms(ms[name])} ms an update ({FUSED_TIMED_UPDATES} "
              f"updates a turn, in turns); under torch.profiler "
              f"{n:.0f} kernels and {dev_ms:.3f} ms of device time an "
              f"update: the device busy {100 * dev_ms / best:.1f}% of the "
              f"fastest turn; bound {bound:.4f} ms ({ops:.4g} operations "
              f"at {BF16_FLOPS_PER_S:.3g}/s, {moved:.4g} bytes at "
              f"{HBM_BYTES_PER_S:.3g}/s): {best / bound:.2f}x")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"phase 16:   {name}: "
                  f"{e.self_device_time_total / 1e3 / FUSED_TRACED_UPDATES:.4f}"
                  f" ms, {e.count / FUSED_TRACED_UPDATES:.0f} an update: "
                  f"{e.key[:100]}")
    print(f"phase 16: the same work's bound is the four-conv module's, "
          f"{rows['four']['bound']:.4f} ms; the fused module's own "
          f"operations bound it at {rows['fused']['bound']:.4f} ms; fused "
          f"/ four-conv ms an update: "
          f"{min(ms['fused']) / min(ms['four']):.3f}")
    del updates
    torch.cuda.empty_cache()
    return rows


def phase_fused_train(sk, tk, torch, device):
    """`train dqn` cut in depth through the Python API, at the CLI's
    defaults with ``fused_conv=True`` and, for comparison, without: two
    chunks, each after ``FUSED_ENDGAME_LANES`` lanes were put on endgame
    boards so that their episodes end and the debt brings updates into
    both chunks. Returns the fused run's step-kernel launches."""
    from tpu2048_torch.agents.dqn import DQNConfig
    from tpu2048_torch.ops.board import legal_moves_mask
    from tpu2048_torch.ops.step_kernel import from_cell_major, to_cell_major
    from tpu2048_torch.training import dqn as dtrain

    fused_launches = 0
    for fused in (False, True):
        config = dtrain.DQNTrainConfig(agent=DQNConfig(fused_conv=fused),
                                       seed=SEED)
        state = dtrain.init_loop_state(config, device)
        gen = torch.Generator().manual_seed(SEED + 11)
        chunks = []
        for _ in range(2):
            boards = from_cell_major(state.env_state.boards).clone()
            boards[:FUSED_ENDGAME_LANES] = endgame_boards(
                gen, FUSED_ENDGAME_LANES).to(device)
            state.env_state.boards = to_cell_major(boards)
            state.env_state.legal = legal_moves_mask(boards)
            before = state.agent.train_steps
            zero_counts(sk, tk)
            t0 = time.perf_counter()
            dtrain.train_chunk(config, state)
            counts = read_counts(sk, tk, torch)
            wall = time.perf_counter() - t0
            upd = state.agent.train_steps - before
            if (counts["step"] != DQN_CHUNK or upd == 0
                    or counts["gather"] or counts["scatter"]
                    or counts["rollout"]):
                fail(f"train dqn, fused {fused}: launches {counts}, {upd} "
                     f"updates")
            chunks.append((1e3 * wall / DQN_CHUNK, upd))
            if fused:
                fused_launches += counts["step"]
        loss = float(state.last_loss)
        if not math.isfinite(loss):
            fail(f"train dqn, fused {fused}: loss {loss}")
        print(f"phase 16: train dqn through the Python API, full width, "
              f"{'fused conv' if fused else 'four-conv'}: "
              + "; ".join(f"chunk {i + 1}: {ms:.3f} ms a vector step, "
                          f"{upd} updates ({ms * DQN_CHUNK / upd:.3f} ms of "
                          f"the chunk an update)"
                          for i, (ms, upd) in enumerate(chunks))
              + f"; {DQN_CHUNK} step-kernel launches a chunk; last loss "
              f"{loss:.4g}, {state.episodes_done} episodes")
        del state
        torch.cuda.empty_cache()
    return fused_launches


def phase_legacy(sk, tk, torch, device, packed_rows):
    """`train tabular --table-backend legacy` through the CLI at the
    defaults (capacity 2**25, batch 1024, shaped), cut to 3 chunks, with
    --watchdog and --log, beside phase 7's packed rows; returns the step
    kernel's launches."""
    from tpu2048_torch.cli.main import main as cli_main
    from tpu2048_torch.metrics.logging import read_jsonl

    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "legacy.jsonl")
        argv = ["train", "tabular", "--table-backend", "legacy", "--batch",
                str(TABLE_BATCH), "--capacity-log2", str(TABLE_LOG2),
                "--episodes", str(TABLE_EPISODES), "--steps-per-chunk",
                str(TABLE_CHUNK), "--seed", "0", "--log", log, "--watchdog",
                str(WATCHDOG_S)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, counts, wall = run_path(sk, tk, torch, cli_main, argv)
        rows = read_jsonl(log)
    peak = torch.cuda.max_memory_allocated()
    for row in rows:
        print("phase 17: row " + json.dumps(row))
    steps = rows[-1]["env_steps"] // TABLE_BATCH if rows else 0
    if (len(rows) < 2 or steps != len(rows) * TABLE_CHUNK
            or counts["step"] != steps or counts["gather"]
            or counts["scatter"] or counts["rollout"]):
        fail(f"legacy: {len(rows)} chunks, {steps} steps, launches {counts}")
    for row in rows:
        if (set(row) != ROW_KEYS or not row["q_states"] > 0
                or sum(row["action_counts"]) != row["env_steps"]):
            fail(f"legacy: implausible row {row}")
    print(f"phase 17: train tabular --table-backend legacy, capacity "
          f"2**{TABLE_LOG2} ({(24 << TABLE_LOG2) >> 20} MiB of keys and Q), "
          f"batch {TABLE_BATCH}, "
          f"shaped: {counts['step']} step-kernel launches = {steps} env "
          f"steps, no table kernel; --watchdog {WATCHDOG_S} never fired; "
          f"{wall:.3f} s for the CLI call; peak device memory {peak} bytes")
    for i, row in enumerate(rows):
        packed = packed_rows[i] if i < len(packed_rows) else None
        beside = (f"; packed (phase 7): "
                  f"{1e3 * TABLE_BATCH / packed['steps_per_s']:.3f} ms a "
                  f"step, {packed['steps_per_s']:.0f} env-steps/s"
                  if packed else "")
        print(f"phase 17: chunk {i + 1}: legacy "
              f"{1e3 * TABLE_BATCH / row['steps_per_s']:.3f} ms a step, "
              f"{row['steps_per_s']:.0f} env-steps/s{beside}")
    return counts["step"]


def phase_legacy_narrow(torch, device):
    """A narrow legacy-table trainer on the card and on the CPU on the same
    bits and draws: keys, boards and ``dropped`` equal, Q within
    ``Q_RTOL``."""
    from tpu2048_torch.agents import tabular as ttab
    from tpu2048_torch.agents import tabular_fast as tabf
    from tpu2048_torch.env import fast as tfast
    from tpu2048_torch.training import tabular as ttrain

    b, log2, steps = 256, 14, 64
    config = ttrain.TabularTrainConfig(
        agent=ttab.TabularConfig(capacity_log2=log2), batch_size=b,
        steps_per_chunk=steps, table_backend="legacy")
    gen = torch.Generator().manual_seed(SEED + 13)
    bits = [torch.randint(-(2**31), 2**31, (8, b), dtype=torch.int32,
                          generator=gen) for _ in range(steps + 1)]
    # Explore draws below 0.5 < epsilon: every action is the drawn one.
    draws = [(torch.rand(b, generator=gen) * 0.5,
              torch.randint(0, 4, (b,), dtype=torch.int32, generator=gen))
             for _ in range(steps)]
    states = []
    for dev in (device, torch.device("cpu")):
        replay = tfast.ReplayBits([x.to(dev) for x in bits])
        state = ttrain.init_train_state(config, replay)
        state, _ = ttrain.train_chunk(
            config, state, replay,
            tabf.ReplayDraws([(u.to(dev), a.to(dev)) for u, a in draws]))
        states.append(state)
    card, cpu = states
    for name in ("key_lo", "key_hi", "dropped"):
        if not torch.equal(getattr(card.table, name).cpu(),
                           getattr(cpu.table, name)):
            fail(f"narrow legacy trainer: {name}, card != CPU")
    for name in ("boards", "score", "episode_steps", "prev_max",
                 "consec_action", "consec_count"):
        if not torch.equal(getattr(card.env_state, name).cpu(),
                           getattr(cpu.env_state, name)):
            fail(f"narrow legacy trainer: {name}, card != CPU")
    for name in ("episodes_done", "env_steps", "best_tile", "action_counts"):
        if not torch.equal(getattr(card, name).cpu(), getattr(cpu, name)):
            fail(f"narrow legacy trainer: {name}, card != CPU")
    q_k, q_c = card.table.q.cpu(), cpu.table.q
    q_err = float(((q_k - q_c).abs() / q_c.abs().clamp_min(1)).max())
    q_words = int((q_k.view(torch.int32) != q_c.view(torch.int32)).sum())
    if not q_err <= Q_RTOL or not torch.isfinite(q_k).all():
        fail(f"narrow legacy trainer: Q card vs CPU {q_err:.3e} > {Q_RTOL}")
    print(f"phase 17: narrow legacy trainer (B={b}, capacity 2**{log2}, "
          f"{steps} steps), card == CPU on keys, boards, counters and "
          f"dropped ({int(card.table.dropped)}); Q within {q_err:.3e} of "
          f"max(1, |Q|) (tolerance {Q_RTOL}), {q_words} of {q_c.numel()} Q "
          f"words differ; {int(card.episodes_done)} episodes, "
          f"{int(card.table.occupied.sum())} states")


# Phase 18, the classic env card against CPU: each mode of the env (the
# shaped ones with stall limits 3 and 8, so that stall penalties and the
# stall force-done happen), at B=4096 for 64 steps, on the same spawn
# decisions and fresh boards drawn once on the CPU.
LAX_BATCH, LAX_STEPS = 4096, 64
LAX_STALL = dict(max_consecutive_actions=3, stall_force_done=8)
LAX_MODES = {
    "simple": dict(reward="simple"),
    "simple, terminal bonus": dict(reward="simple", terminal_bonus=True),
    "simple, quirk_compat": dict(reward="simple", quirk_compat=True),
    "shaped": dict(reward="shaped", **LAX_STALL),
    "shaped, reset_shaping_on_reset": dict(
        reward="shaped", reset_shaping_on_reset=True, **LAX_STALL),
}
# tests/test_torch_rewards.py: the shaped reward's log2 and pow may round
# one float32 ulp apart on two devices; the episode returns sum 64 of them.
LAX_REWARD_RTOL, LAX_RETURN_RTOL = 2e-6, 4e-5
# The spawn distribution: draws on the card's generator; chi-square at
# p = 0.001 over the 8 empties of the probe board (7 degrees of freedom)
# and over the value's two outcomes (1).
LAX_DRAWS = 131072
CHI2_7, CHI2_1 = 24.32, 10.83
# Full but playable: every row merges left, so LEFT (and, in quirk mode,
# the probe of an illegal UP) leaves 8 empties in columns 2-3.
CLOBBER_VALUES = [[2, 2, 4, 4], [8, 8, 16, 16], [32, 32, 64, 64],
                  [128, 128, 2, 2]]
PROBE_VALUES = [[4, 8, 0, 0], [16, 32, 0, 0], [64, 128, 0, 0],
                [256, 4, 0, 0]]
# The lax DQN run: `train dqn`'s defaults at full width, cut to 8 episodes;
# the demo's scripted manual keys, cycled.
LAX_DQN_EPISODES = 8
DEMO_KEYS = ("a", "s", "d", "s", "x", "w")
DEMO_MANUAL_MOVES = 200


def lax_boards(torch, b):
    """(b, 4, 4) int8 on the CPU: phase 10's sparse, full and dead boards,
    a quarter of dense endgame boards and one clobber board."""
    from tpu2048_torch.ops import board as board_ops

    boards = edge_boards(torch, b, "cpu").T.reshape(b, 4, 4).contiguous()
    gen = torch.Generator().manual_seed(SEED + 18)
    boards[b // 4:b // 2] = endgame_boards(gen, b // 4)
    boards[b // 4 - 1] = board_ops.values_to_exponents(CLOBBER_VALUES)
    return boards


def lax_equal(torch, name, got, want, rtol):
    """Card against CPU: integers and bools equal, floats within ``rtol``
    of max(1, |x|) (0: equal)."""
    got = got.cpu()
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{name}: {got.dtype} {tuple(got.shape)} on the card, "
             f"{want.dtype} {tuple(want.shape)} on the CPU")
    if not want.is_floating_point():
        if not torch.equal(got, want):
            fail(f"{name}: the card's differs from the CPU's")
        return 0.0
    err = float(((got.double() - want.double()).abs()
                 / want.double().abs().clamp_min(1.0)).max())
    if not err <= rtol:
        fail(f"{name}: relative error {err:.3e} above {rtol}")
    return err


def aten_ops(fn):
    """How many aten ops ``fn()`` dispatches (views included): each
    launches at most one kernel."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        fn()
    return count.n


def phase_lax_env(torch, device):
    """The classic env's step (``step`` through a replay source, so that
    every lane runs ``step_with_spawn`` and the auto-reset) on the card
    against the CPU, in every mode."""
    from tpu2048_torch.env import env as envlib

    b = LAX_BATCH
    gen = torch.Generator().manual_seed(SEED + 19)
    start = lax_boards(torch, b)
    actions, spawns, fresh = [], [], []
    for t in range(LAX_STEPS):
        # Runs of one action, so that the stall counters climb.
        a = torch.randint(0, 4, (b,), dtype=torch.int32, generator=gen)
        actions.append(torch.where(torch.rand(b, generator=gen) < 0.7,
                                   t // 4 % 4, a).to(torch.int32))
        spawns.append((torch.randint(0, 6, (b,), dtype=torch.int32,
                                     generator=gen),
                       torch.randint(1, 3, (b,), dtype=torch.int8,
                                     generator=gen)))
        fresh.append(envlib.GeneratorSpawns(SEED + t, "cpu").fresh(b))
    ts_ints = ("obs", "done", "max_number", "valid", "merge_score",
               "legal_mask", "episode_steps")
    from tpu2048_torch.ops import board as board_ops

    on_card = start.to(device)
    source = envlib.GeneratorSpawns(SEED, device)
    print(f"phase 18: aten ops of the classic step's parts on the card: "
          f"move_all {aten_ops(lambda: board_ops.move_all(on_card))}, the "
          f"fresh boards {aten_ops(lambda: source.fresh(b))}, a spawn draw "
          f"{aten_ops(lambda: source.spawn(on_card))}")
    for label, mode in LAX_MODES.items():
        config = envlib.EnvConfig(**mode)
        shaped = config.reward == "shaped"
        states = []
        for dev in (device, torch.device("cpu")):
            source = envlib.ReplaySpawns(
                [(i.to(dev), v.to(dev)) for i, v in spawns],
                [start.to(dev)] + [f.to(dev) for f in fresh])
            states.append((envlib.reset(config, source, b), source))
        t0 = time.perf_counter()
        card_s = cpu_s = 0.0
        max_err, dones = 0.0, 0
        for t in range(LAX_STEPS):
            t1 = time.perf_counter()
            card_state, card_ts = envlib.step(config, states[0][0],
                                              actions[t].to(device),
                                              states[0][1])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            cpu_state, cpu_ts = envlib.step(config, states[1][0],
                                            actions[t], states[1][1])
            t3 = time.perf_counter()
            card_s, cpu_s = card_s + t2 - t1, cpu_s + t3 - t2
            for f in ts_ints:
                lax_equal(torch, f"{label}, step {t}, {f}",
                          getattr(card_ts, f), getattr(cpu_ts, f), 0.0)
            max_err = max(max_err, lax_equal(
                torch, f"{label}, step {t}, reward", card_ts.reward,
                cpu_ts.reward, LAX_REWARD_RTOL if shaped else 0.0))
            for f in ("board", "score", "move_score", "prev_max",
                      "consec_action", "consec_count", "episode_steps",
                      "done", "last_consec_penalty"):
                lax_equal(torch, f"{label}, step {t}, state {f}",
                          getattr(card_state, f), getattr(cpu_state, f), 0.0)
            lax_equal(torch, f"{label}, step {t}, episode_return",
                      card_state.episode_return, cpu_state.episode_return,
                      LAX_RETURN_RTOL if shaped else 0.0)
            dones += int(cpu_ts.done.sum())
            states = [(card_state, states[0][1]), (cpu_state, states[1][1])]
        if dones == 0:
            fail(f"{label}: no episode ended in {LAX_STEPS} steps")
        source = envlib.GeneratorSpawns(SEED, device)
        action = actions[0].to(device)
        ops = aten_ops(lambda: envlib.step(config, states[0][0], action,
                                           source))
        print(f"phase 18: classic env, {label}, B={b}, {LAX_STEPS} steps "
              f"(step_with_spawn and the auto-reset): card == CPU on every "
              f"integer output and state field, reward max relative error "
              f"{max_err:.3e} (limit "
              f"{LAX_REWARD_RTOL if shaped else 0.0}); {dones} episode "
              f"ends; {1e3 * card_s / LAX_STEPS:.3f} ms a step on the card "
              f"(eager, synchronised; {ops} aten ops a step), "
              f"{1e3 * cpu_s / LAX_STEPS:.3f} ms on the CPU; "
              f"{time.perf_counter() - t0:.1f} s")


def chi2(counts, probs):
    n = sum(counts)
    return sum((c - n * p) ** 2 / (n * p) for c, p in zip(counts, probs))


def phase_lax_spawns(torch, device):
    """The production source's draws on the card: the spawn cell uniform
    over the empties of the board it lands on (the quirk probe board, and
    a plain LEFT move's board), the value a 2 with p = 0.9; fresh boards
    of two tiles."""
    from tpu2048_torch.env import env as envlib
    from tpu2048_torch.ops import board as board_ops

    n = LAX_DRAWS
    board = board_ops.values_to_exponents(CLOBBER_VALUES).to(device)
    probe = board_ops.values_to_exponents(PROBE_VALUES).to(device)
    cases = (("quirk clobber (illegal UP)", dict(quirk_compat=True), 1),
             ("simple, LEFT", {}, 0))
    for label, mode, action in cases:
        config = envlib.EnvConfig(reward="simple", auto_reset=False, **mode)
        source = envlib.GeneratorSpawns(SEED + action, device)
        state = envlib.reset(config, source, n)
        state.board = board.expand(n, 4, 4).contiguous()
        _, ts = envlib.step(config, state,
                            torch.full((n,), action, dtype=torch.int32,
                                       device=device), source)
        diff = ts.obs != probe
        if not bool((diff.flatten(1).sum(1) == 1).all()):
            fail(f"spawns, {label}: not exactly one new tile a lane")
        lane, rows, cols = diff.nonzero(as_tuple=True)
        if not bool((cols >= 2).all()):
            fail(f"spawns, {label}: a tile outside the probe's empties")
        cells = torch.bincount(rows * 2 + (cols - 2), minlength=8).tolist()
        twos = int((ts.obs[lane, rows, cols] == 1).sum())
        c_cells = chi2(cells, [1 / 8] * 8)
        c_val = chi2([twos, n - twos], [0.9, 0.1])
        if not (c_cells < CHI2_7 and c_val < CHI2_1):
            fail(f"spawns, {label}: cells {cells} (chi2 {c_cells:.2f}), "
                 f"twos {twos} of {n} (chi2 {c_val:.2f})")
        print(f"phase 18: {n} spawns on the card, {label}: cells {cells}, "
              f"chi2 {c_cells:.2f} < {CHI2_7} (7 dof, p=0.001); "
              f"{twos / n:.4f} twos, chi2 {c_val:.2f} < {CHI2_1}")
    fresh = envlib.GeneratorSpawns(SEED, device).fresh(n)
    tiles = (fresh != 0).flatten(1).sum(1)
    if not bool((tiles == 2).all()):
        fail("fresh boards on the card without exactly two tiles")
    print(f"phase 18: {n} fresh boards on the card: two tiles each")


def lax_run(sk, tk, torch, cli_main, argv, label):
    """``run_path`` for a lax-engine call that must launch no kernel."""
    text, counts, wall = run_path(sk, tk, torch, cli_main, argv)
    if any(counts.values()):
        fail(f"{label}: launches {counts}, expected none")
    return text, wall


def two_sample(label, a, b, games):
    """Means within four standard errors of their difference."""
    se = math.sqrt(a["score_std"] ** 2 / games + b["score_std"] ** 2 / games)
    diff = abs(a["score_mean"] - b["score_mean"])
    if not diff < 4 * se:
        fail(f"{label}: score means {a['score_mean']:.1f} and "
             f"{b['score_mean']:.1f} differ by {diff:.1f} > 4 x {se:.1f}")
    return diff, se


def phase_lax_paths(sk, tk, torch, device, earlier):
    """The lax engine through ``tpu2048_torch.cli.main`` at full width;
    returns the table kernels' launches."""
    from tpu2048_torch.checkpoint.params import save_params
    from tpu2048_torch.cli.main import main as cli_main
    from tpu2048_torch.eval.demo import play
    from tpu2048_torch.metrics.logging import read_jsonl

    launches = {"gather": 0, "scatter": 0}
    with tempfile.TemporaryDirectory() as tmp:
        # train tabular --engine lax at the defaults, cut as phase 7 is.
        log = os.path.join(tmp, "tabular.jsonl")
        _, counts, wall = run_path(sk, tk, torch, cli_main, [
            "train", "tabular", "--engine", "lax", "--batch",
            str(TABLE_BATCH), "--capacity-log2", str(TABLE_LOG2),
            "--episodes", str(TABLE_EPISODES), "--steps-per-chunk",
            str(TABLE_CHUNK), "--seed", "0", "--log", log])
        rows = read_jsonl(log)
        steps = rows[-1]["env_steps"] // TABLE_BATCH if rows else 0
        if (len(rows) < 2 or steps != len(rows) * TABLE_CHUNK
                or counts["gather"] != 2 * steps
                or counts["scatter"] != steps or counts["step"]
                or counts["rollout"]
                or any(sum(r["action_counts"]) != r["env_steps"]
                       or not r["q_states"] > 0 for r in rows)):
            fail(f"train tabular --engine lax: {len(rows)} chunks, {steps} "
                 f"steps, launches {counts}")
        launches["gather"] += counts["gather"]
        launches["scatter"] += counts["scatter"]
        for row in rows:
            print("phase 18: train tabular --engine lax, row "
                  + json.dumps(row))
        print(f"phase 18: train tabular --engine lax, capacity "
              f"2**{TABLE_LOG2}, batch {TABLE_BATCH}, shaped: launches "
              f"{counts} for {steps} env steps (gathers = 2 x steps, "
              f"scatters = steps, no step kernel); {wall:.3f} s for the CLI "
              f"call")
        packed = earlier["packed_rows"]
        for i, row in enumerate(rows):
            beside = (f"; fast engine (phase 7): "
                      f"{1e3 * TABLE_BATCH / packed[i]['steps_per_s']:.3f} "
                      f"ms a step" if i < len(packed) else "")
            print(f"phase 18: chunk {i + 1}: lax "
                  f"{1e3 * TABLE_BATCH / row['steps_per_s']:.3f} ms a step, "
                  f"{row['steps_per_s']:.0f} env-steps/s{beside}")

        # eval --policy random --engine lax beside phase 11's fast eval.
        text, wall = lax_run(sk, tk, torch, cli_main, [
            "eval", "--policy", "random", "--engine", "lax", "--games",
            str(EVAL_GAMES), "--eval-batch", str(EVAL_GAMES), "--seed",
            str(SEED)], "eval --policy random --engine lax")
        lax = json.loads(text)
        fast = earlier["random_fast"]["simple, warm", EVAL_GAMES]
        if (lax["games"] != EVAL_GAMES
                or sum(lax["action_counts"].values())
                != round(lax["length_mean"] * EVAL_GAMES)):
            fail(f"eval --policy random --engine lax: {lax}")
        diff, se = two_sample("random eval, lax vs fast", lax, fast,
                              EVAL_GAMES)
        for name, run in (("lax", lax), ("fast (phase 11)", fast)):
            secs = run["seconds"]
            print(f"phase 18: eval --policy random, {name}, {EVAL_GAMES} "
                  f"games: {EVAL_GAMES / secs:.1f} games/s, "
                  f"{1e3 * secs / run['batch_steps']:.3f} ms a step; score "
                  f"mean {run['score_mean']:.1f} (std "
                  f"{run['score_std']:.1f}), length mean "
                  f"{run['length_mean']:.1f}, max tiles "
                  f"{run['max_tile_distribution']}")
        print(f"phase 18: random eval, lax vs fast: score means differ by "
              f"{diff:.1f} < 4 x {se:.1f} (standard error of the "
              f"difference); lax: no kernel launched; {wall:.3f} s for the "
              f"CLI call")

        # eval --policy model --engine lax with phase 4's seeded weights.
        path = os.path.join(tmp, "params.npz")
        save_params(path, full_width_params(torch))
        text, wall = lax_run(sk, tk, torch, cli_main, [
            "eval", "--policy", "model", "--params", path, "--engine", "lax",
            "--games", str(EVAL_GAMES), "--eval-batch", str(EVAL_GAMES),
            "--seed", str(SEED)], "eval --policy model --engine lax")
        lax = json.loads(text)
        if lax["games"] != EVAL_GAMES or not lax["length_mean"] > 0:
            fail(f"eval --policy model --engine lax: {lax}")
        for name, run in (("lax", lax), ("fast (phase 4, warm)",
                                         earlier["greedy_fast"])):
            secs = run["seconds"]
            print(f"phase 18: eval --policy model, full width, {name}: "
                  f"{EVAL_GAMES / secs:.1f} games/s, "
                  f"{1e3 * secs / run['batch_steps']:.3f} ms a step "
                  f"({run['batch_steps']} steps), score mean "
                  f"{run['score_mean']:.1f}")
        print(f"phase 18: eval --policy model --engine lax: no kernel "
              f"launched; {wall:.3f} s for the CLI call")

        # train dqn --engine lax at the defaults, then --resume.
        ck, log = os.path.join(tmp, "ck"), os.path.join(tmp, "dqn.jsonl")
        _, wall = lax_run(sk, tk, torch, cli_main, [
            "train", "dqn", "--engine", "lax", "--episodes",
            str(LAX_DQN_EPISODES), "--checkpoint-dir", ck, "--log", log,
            "--seed", str(SEED)], "train dqn --engine lax")
        rows = read_jsonl(log)
        last = rows[-1] if rows else {}
        if (not rows or last["episodes"] < LAX_DQN_EPISODES
                or last["train_steps"] + last["update_debt"]
                != 100 * last["episodes"]
                or not math.isfinite(last["loss"])
                or sum(last["tile_hist"]) != last["episodes"]):
            fail(f"train dqn --engine lax: rows {rows}")
        for row in rows:
            print("phase 18: train dqn --engine lax, row " + json.dumps(row))
        fast_rows = earlier["dqn_rows"]
        for i, row in enumerate(rows):
            beside = (f"; fast engine (phase 13): "
                      f"{1e3 * DQN_ENVS / fast_rows[i]['steps_per_s']:.3f} "
                      f"ms" if i < len(fast_rows) else "")
            print(f"phase 18: chunk {i + 1}: lax "
                  f"{1e3 * DQN_ENVS / row['steps_per_s']:.3f} ms a vector "
                  f"step{beside}")
        print(f"phase 18: train dqn --engine lax, full width, "
              f"{LAX_DQN_EPISODES} episodes: {last['train_steps']} updates "
              f"+ {last['update_debt']} owed = 100 x {last['episodes']} "
              f"episodes, no kernel launched; {wall:.3f} s for the CLI call")
        _, wall = lax_run(sk, tk, torch, cli_main, [
            "train", "dqn", "--episodes", str(last["episodes"] + 1),
            "--checkpoint-dir", ck, "--resume", "--log", log],
            "train dqn --resume (lax)")
        resumed = read_jsonl(log)[len(rows):]
        if (not resumed or resumed[0]["env_steps"]
                != last["env_steps"] + DQN_ENVS * DQN_CHUNK
                or resumed[-1]["episodes"] <= last["episodes"]):
            fail(f"train dqn --resume (lax): rows {resumed}")
        print(f"phase 18: train dqn --resume on the lax run: "
              f"{len(resumed)} chunk(s) from episode {last['episodes']}, "
              f"{1e3 * DQN_ENVS / resumed[0]['steps_per_s']:.3f} ms a vector "
              f"step; {wall:.3f} s for the CLI call (the restore included)")

        # demo: random, and model mode on the lax run's weights.
        for mode, extra in (("random", []),
                            ("model", ["--checkpoint-dir", ck])):
            text, wall = lax_run(sk, tk, torch, cli_main, [
                "demo", "--mode", mode, "--delay", "0", "--seed",
                str(SEED), *extra], f"demo --mode {mode}")
            stats = json.loads(text.strip().splitlines()[-1])
            if "GAME OVER" not in text or not stats["moves"] > 0:
                fail(f"demo --mode {mode}: {stats}")
            print(f"phase 18: demo --mode {mode} --delay 0: stats "
                  f"{json.dumps(stats)}; {1e3 * wall / stats['moves']:.3f} "
                  f"ms a move ({wall:.3f} s for the CLI call)")

    # A manual session on the card, driven by scripted keys.
    keys = itertools.chain(
        itertools.islice(itertools.cycle(DEMO_KEYS),
                         DEMO_MANUAL_MOVES * len(DEMO_KEYS) // 5), ["q"])
    out = io.StringIO()
    zero_counts(sk, tk)
    t0 = time.perf_counter()
    stats = play(mode="manual", seed=SEED, out=out,
                 input_fn=lambda: next(keys))
    wall = time.perf_counter() - t0
    if any(read_counts(sk, tk, torch).values()) or not stats["moves"] > 0:
        fail(f"manual session: {stats}")
    print(f"phase 18: GameSession(mode='manual') on the card, scripted "
          f"keys through play(input_fn=...): stats {json.dumps(stats)}, "
          f"{'game over' if 'GAME OVER' in out.getvalue() else 'quit'}; "
          f"{1e3 * wall / stats['moves']:.3f} ms a move")
    return launches


def phase_lax(sk, tk, torch, device, earlier):
    """Phase 18, the classic env and the lax engine; returns the table
    kernels' launches in its CLI paths."""
    t0 = time.perf_counter()
    phase_lax_env(torch, device)
    phase_lax_spawns(torch, device)
    launches = phase_lax_paths(sk, tk, torch, device, earlier)
    print(f"phase 18: {time.perf_counter() - t0:.1f} s of wall time")
    return launches


PAR_SHARDS = 4  # `train dqn --replay-shards`'s count on the card
PAR_CAPACITY = 50_000  # the `train dqn` default memory, split 4 ways
PAR_ADDS, PAR_PRUNE = 600, 2  # the shards' rings wrap at ~520 adds
PAR_NCCL_UPDATES = 1  # `--updates-per-step` of the one-rank NCCL runs
PAR_ALLREDUCE_CALLS = 20
PAR_GLOO_CHUNKS = 3
# The two-rank gloo run: CONFIG_KW's widths with more envs and steps, so
# that its 2 x 3 x 16 vector steps end episodes and fill the shards.
PAR_GLOO_KW = dict(features=16, hidden=32, num_blocks=1, envs_per_dp=64,
                   batch_per_dp=32, steps_per_chunk=16, memory_per_dp=1024,
                   seed=SEED)
PAR_PARAM_RTOL, PAR_PARAM_ATOL, PAR_LOSS_RTOL = 2e-4, 2e-5, 1e-3  # JAX's


def gloo_rank(config, chunks, log_dir):
    """One rank of phase 19's two gloo ranks on the card: a probe row
    through ``JSONLLogger`` (rank 0 alone may write it), then
    ``run_chunks`` with the parameters."""
    from tpu2048_torch.metrics.logging import JSONLLogger
    from tpu2048_torch.parallel import mesh
    from tpu2048_torch.parallel.testkit import run_chunks

    logger = JSONLLogger(os.path.join(log_dir, f"log_{mesh.rank()}.jsonl"),
                         echo=False)
    logger.log({"rank": mesh.rank()})
    logger.close()
    return run_chunks(config.replay_shards, 1, chunks, params=True,
                      config=config)


def sharded_replay_equal(torch, device):
    """Phase 19 (a): the sharded buffer on the card against the CPU, on the
    same transitions, masks, sample indices and TD errors."""
    from tpu2048_torch.replay import sharded as rs

    gen = torch.Generator().manual_seed(SEED)
    bufs = {d: rs.sharded_init(PAR_CAPACITY, PAR_SHARDS, d)
            for d in ("cpu", device)}
    per = DQN_ENVS // PAR_SHARDS
    for _ in range(PAR_ADDS):
        tr = (torch.randint(0, 12, (DQN_ENVS, 4, 4), generator=gen,
                            dtype=torch.int8),
              torch.randint(0, 4, (DQN_ENVS,), generator=gen),
              torch.randint(-10, 100, (DQN_ENVS,), generator=gen).float(),
              torch.rand(DQN_ENVS, generator=gen) < 0.02,
              torch.randint(0, 12, (DQN_ENVS, 4, 4), generator=gen,
                            dtype=torch.int8),
              torch.rand(DQN_ENVS, generator=gen) < 0.8)
        for d, buf in bufs.items():
            rs.sharded_add(buf, *(x.to(d) for x in tr))
    sizes = rs.shard_sizes(bufs["cpu"])
    idx = torch.stack([torch.randint(0, int(n), (64 // PAR_SHARDS,),
                                     generator=gen) for n in sizes])
    td = torch.randn(64, generator=gen)
    out = {}
    for d, buf in bufs.items():
        batch, _, w = rs.sharded_sample(buf, 64, 0.0, 1.0, idx.to(d))
        rs.sharded_update_priorities(buf, idx.to(d), td.to(d))
        out[d] = (batch, w, rs.sharded_prune(buf, PAR_PRUNE))
    for k in out["cpu"][0]:
        if not torch.equal(out[device][0][k].cpu(), out["cpu"][0][k]):
            fail(f"phase 19: sharded sample {k}: card differs from CPU")
    c = PAR_CAPACITY // PAR_SHARDS
    for name in ("boards", "next_boards", "actions", "rewards", "dones",
                 "priorities", "max_priority", "ptr", "size"):
        for what, a, b in (("after priorities", bufs[device], bufs["cpu"]),
                           ("after the prune", out[device][2],
                            out["cpu"][2])):
            # Each shard's last row is its trash row: write-only, its
            # write order free.
            a, b = getattr(a, name).cpu(), getattr(b, name)
            if a.dim() > 1:
                a, b = a[:, :c], b[:, :c]
            if not torch.equal(a, b):
                fail(f"phase 19: sharded replay {name} {what}: card "
                     "differs from CPU")
    pruned = rs.shard_sizes(out["cpu"][2]).tolist()
    print(f"phase 19: sharded replay, {PAR_SHARDS} shards of "
          f"{PAR_CAPACITY // PAR_SHARDS} slots, {PAR_ADDS} adds of "
          f"{DQN_ENVS} envs ({per} a shard, rings wrapped): add, sample "
          f"(64 at alpha 0), priorities and the prune of {PAR_PRUNE} "
          f"episodes a shard equal on the card and the CPU (sizes "
          f"{sizes.tolist()} -> {pruned})")


def rows_after(rows, episodes):
    return [{k: v for k, v in r.items() if k != "steps_per_s"}
            for r in rows if r["episodes"] > episodes]


def step_ms(rows):
    return [1e3 * DQN_ENVS / r["steps_per_s"] for r in rows]


def parallel_shards_cli(sk, tk, torch, cli_main, read_jsonl, tmp,
                        dqn_rows):
    """Phase 19 (b): `train dqn --replay-shards 4` at full width through
    the CLI to its first episode, its `--resume`, and the same run straight
    through, which the resumed rows must equal bit for bit."""
    ck, log = os.path.join(tmp, "shards"), os.path.join(tmp, "shards.jsonl")
    flags = ["train", "dqn", "--replay-shards", str(PAR_SHARDS), "--seed",
             str(SEED)]
    _, counts, wall = run_path(sk, tk, torch, cli_main, flags + [
        "--episodes", "1", "--checkpoint-dir", ck, "--log", log])
    rows = read_jsonl(log)
    last = rows[-1]
    steps = last["env_steps"] // DQN_ENVS
    if (counts["step"] != steps or counts["rollout"] or counts["gather"]
            or counts["scatter"] or not math.isfinite(last["loss"])
            or last["train_steps"] + last["update_debt"]
            != 100 * last["episodes"]):
        fail(f"train dqn --replay-shards: rows {rows}, launches {counts}")
    _, rcounts, rwall = run_path(sk, tk, torch, cli_main, [
        "train", "dqn", "--episodes", str(last["episodes"] + 1),
        "--checkpoint-dir", ck, "--resume", "--log", log])
    resumed = read_jsonl(log)[len(rows):]
    straight = os.path.join(tmp, "straight.jsonl")
    _, scounts, swall = run_path(sk, tk, torch, cli_main, flags + [
        "--episodes", str(last["episodes"] + 1), "--log", straight])
    want = rows_after(read_jsonl(straight), last["episodes"])
    if (not resumed or rows_after(resumed, last["episodes"]) != want
            or resumed[0]["env_steps"] != last["env_steps"]
            + DQN_ENVS * DQN_CHUNK
            or rcounts["step"] != DQN_CHUNK * len(resumed)):
        fail(f"train dqn --replay-shards --resume: {resumed} against the "
             f"straight run's {want}, launches {rcounts}")
    print(f"phase 19: train dqn --replay-shards {PAR_SHARDS}, full width, "
          f"{DQN_ENVS} envs, batch 64: {len(rows)} chunks to episode "
          f"{last['episodes']}, {counts['step']} step-kernel launches = "
          f"{steps} vector steps; {last['train_steps']} updates + "
          f"{last['update_debt']} owed; {wall:.3f} s; --resume: "
          f"{len(resumed)} chunk(s), {rcounts['step']} launches, its rows "
          f"equal the straight run's ({len(want)} rows, loss "
          f"{resumed[-1]['loss']!r}) bit for bit; {rwall:.3f} s")
    for label, rs in (("--replay-shards 4", rows + resumed),
                      ("phase 13 (1 shard)", dqn_rows)):
        prev = 0
        for i, (row, ms) in enumerate(zip(rs, step_ms(rs))):
            upd = (row["train_steps"] - prev) / DQN_CHUNK
            prev = row["train_steps"]
            print(f"phase 19:   {label} chunk {i + 1}: {ms:.3f} ms a vector "
                  f"step, {upd:.2f} updates a step")
    return counts["step"] + rcounts["step"] + scounts["step"]


def allreduce_share(torch, device):
    """Phase 19 (c): in a one-rank NCCL group, the gradient all-reduce of
    the full-width network (one flat bucket) beside a learner update at
    batch 64, by CUDA events: the all-reduce's share of an update, which
    runs it after its backward."""
    from tpu2048_torch import bench
    from tpu2048_torch.agents.dqn import DQNConfig
    from tpu2048_torch.parallel import mesh
    from tpu2048_torch.parallel.testkit import free_port

    mesh.distributed_init(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        state, update = bench.learner_update(DQNConfig(memory_size=4096), 64,
                                             device)
        update()
        params = list(state.model.parameters())
        loss = torch.zeros((), device=device)
        ar_ms = elapsed_ms(torch, lambda: mesh.average_gradients(params,
                                                                 loss),
                           PAR_ALLREDUCE_CALLS)
        update_ms = elapsed_ms(torch, update, PAR_ALLREDUCE_CALLS)
    finally:
        mesh.destroy()
    grad_bytes = sum(p.numel() * p.element_size() for p in params)
    print(f"phase 19: one-rank NCCL all-reduce of the full-width gradients "
          f"({grad_bytes} bytes in one bucket, with its copies in and "
          f"out): {ar_ms:.4f} ms (CUDA events, {PAR_ALLREDUCE_CALLS} "
          f"calls); an update at batch 64 {update_ms:.3f} ms without it: "
          f"the all-reduce is {100 * ar_ms / (update_ms + ar_ms):.1f}% of "
          f"an update with it")
    return ar_ms, update_ms


def parallel_nccl(sk, tk, torch, cli_main, read_jsonl, tmp):
    """Phase 19 (c): `train dqn --data-parallel 1 --coordinator ...` (one
    NCCL rank) at full width against the same run without the flags, bit
    for bit, then its `--resume` from the rank's checkpoint."""
    from tpu2048_torch.checkpoint.ckpt import CheckpointManager
    from tpu2048_torch.parallel.testkit import free_port

    base = ["train", "dqn", "--episodes", "1", "--updates-per-step",
            str(PAR_NCCL_UPDATES), "--seed", str(SEED)]
    runs = {}
    for name, extra in (("nccl", ["--data-parallel", "1", "--coordinator",
                                  f"127.0.0.1:{free_port()}",
                                  "--num-processes", "1", "--process-id",
                                  "0"]),
                        ("plain", [])):
        ck, log = os.path.join(tmp, name), os.path.join(tmp, name + ".jsonl")
        _, counts, wall = run_path(sk, tk, torch, cli_main, base + extra + [
            "--checkpoint-dir", ck, "--log", log])
        rows = read_jsonl(log)
        mgr = CheckpointManager(ck)
        payload = mgr.read(mgr.latest_step())
        runs[name] = (rows, counts, wall, payload, ck, extra)
    (rows, counts, wall, payload, ck, extra) = runs["nccl"]
    prow, pcounts, pwall, ppayload = runs["plain"][:4]
    model, pmodel = payload["agent"]["model"], ppayload["agent"]["model"]
    steps = rows[-1]["env_steps"] // DQN_ENVS
    if (rows_after(rows, -1) != rows_after(prow, -1)
            or any(not torch.equal(model[k], pmodel[k]) for k in pmodel)
            or payload["world"] != 1 or counts["step"] != steps
            or pcounts["step"] != steps):
        fail(f"one NCCL rank against no group: rows {rows} / {prow}, "
             f"launches {counts} / {pcounts}")
    _, rcounts, rwall = run_path(sk, tk, torch, cli_main, base[:2] + [
        "--episodes", str(rows[-1]["episodes"] + 1), "--data-parallel",
        "1", "--coordinator", f"127.0.0.1:{free_port()}",
        "--num-processes", "1", "--process-id", "0", "--checkpoint-dir",
        ck, "--resume", "--log", os.path.join(tmp, "nccl.jsonl")])
    resumed = read_jsonl(os.path.join(tmp, "nccl.jsonl"))[len(rows):]
    if (not resumed or resumed[0]["env_steps"]
            != rows[-1]["env_steps"] + DQN_ENVS * DQN_CHUNK
            or rcounts["step"] != DQN_CHUNK * len(resumed)):
        fail(f"one NCCL rank --resume: {resumed}, launches {rcounts}")
    ms, pms = step_ms(rows), step_ms(prow)
    print(f"phase 19: train dqn --data-parallel 1 --coordinator (one NCCL "
          f"rank), full width, --updates-per-step {PAR_NCCL_UPDATES}: "
          f"{len(rows)} chunks to episode {rows[-1]['episodes']}, "
          f"{counts['step']} step-kernel launches; rows and the "
          f"checkpoint's weights equal the run without the flags bit for "
          f"bit; {wall:.3f} s against {pwall:.3f} s; ms a vector step "
          f"(chunks with updates) {fmt_ms(ms[1:])} against "
          f"{fmt_ms(pms[1:])}; --resume from the rank's checkpoint: "
          f"{len(resumed)} chunk(s), {rcounts['step']} launches, "
          f"{rwall:.3f} s")
    return counts["step"] + pcounts["step"] + rcounts["step"]


def parallel_gloo(torch, device, tmp):
    """Phase 19 (d): two gloo ranks sharing the card against one process on
    the card with two replay shards."""
    from tpu2048_torch.parallel.testkit import chunk_config, run_chunks
    from tpu2048_torch.parallel.testkit import spawn_ranks

    config = chunk_config(2, **PAR_GLOO_KW)
    t0 = time.perf_counter()
    ranks = spawn_ranks(2, functools.partial(gloo_rank, config,
                                             PAR_GLOO_CHUNKS, tmp),
                        backend="gloo", device="cuda")
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = run_chunks(2, 1, PAR_GLOO_CHUNKS, params=True, config=config,
                     device=device)
    one_wall = time.perf_counter() - t0
    got = ranks[0]
    worst = 0.0
    for k, w in one["params"].items():
        g = got["params"][k].to(w.device)
        if not torch.allclose(g, w, rtol=PAR_PARAM_RTOL,
                              atol=PAR_PARAM_ATOL):
            fail(f"phase 19: two gloo ranks, parameter {k} differs beyond "
                 f"rtol {PAR_PARAM_RTOL}, atol {PAR_PARAM_ATOL}")
        worst = max(worst, (g - w).abs().max().item())
    if (any(got[k] != one[k] for k in ("env_steps", "episodes",
                                       "train_steps", "eps"))
            or any(r[k] != got[k] for r in ranks
                   for k in ("env_steps", "episodes", "train_steps"))
            or abs(got["loss_sum"] - one["loss_sum"])
            > PAR_LOSS_RTOL * abs(one["loss_sum"])
            or not (os.path.exists(os.path.join(tmp, "log_0.jsonl"))
                    and not os.path.exists(os.path.join(tmp, "log_1.jsonl")))
            or not all(r["launches"] > 0 for r in ranks)):
        digest = [{k: v for k, v in r.items() if k != "params"}
                  for r in ranks + [one]]
        fail(f"phase 19: two gloo ranks {digest[:2]} against one process "
             f"{digest[2]}")
    steps = config.steps_per_chunk * PAR_GLOO_CHUNKS
    print(f"phase 19: two gloo ranks sharing the card (features "
          f"{config.agent.features}, float32, dropout 0, {config.num_envs} "
          f"envs, batch {config.train_batch}, 2 shards, {steps} vector "
          f"steps): integers equal one process with 2 shards (env_steps "
          f"{got['env_steps']}, episodes {got['episodes']}, updates "
          f"{got['train_steps']}), parameters within {worst:.3g} (rtol "
          f"{PAR_PARAM_RTOL}, atol {PAR_PARAM_ATOL}), loss sum "
          f"{got['loss_sum']!r} against {one['loss_sum']!r}; rank 0 alone "
          f"wrote its log row; step-kernel launches {[r['launches'] for r in ranks]} "
          f"on the ranks, {one['launches']} in one process; ms a vector "
          f"step (host clock over the chunks, synchronised) "
          f"{fmt_ms([1e3 * r['seconds'] / steps for r in ranks])} on the "
          f"ranks against {1e3 * one['seconds'] / steps:.4f} in one "
          f"process; {wall:.3f} s for the ranks' call (spawn and start "
          f"included), {one_wall:.3f} s for one process's")
    return sum(r["launches"] for r in ranks) + one["launches"]


def parallel_scale(sk, tk, torch, cli_main, loop_row):
    """Phase 19 (e): `bench --scale 1` on the card (one NCCL rank)."""
    text, counts, wall = run_path(sk, tk, torch, cli_main,
                                  ["bench", "--scale", "1"])
    row = json.loads(text.strip().splitlines()[-1])
    if (row["metric"] != "dp_scaling_env_steps_per_s_per_device"
            or row["devices"] != 1 or not row["value"] > 0
            or row.get("simulated") or any(counts.values())
            or row["launches"] != [row["steps_per_chunk"] * row["chunks"]]
            or row["warm_launches"] != [row["steps_per_chunk"]]):
        fail(f"bench --scale 1: {row}")
    print(f"phase 19: bench --scale 1: {json.dumps(row)}; {wall:.3f} s for "
          f"the CLI call (the rank's start included); beside bench "
          f"--train-loop (phase 15): {loop_row['value']:.1f} env-steps/s, "
          f"{loop_row['ms_per_step']:.3f} ms a step")
    # The rank's counter, read around its warm chunk and its timed ones.
    return row["warm_launches"][0] + row["launches"][0]


def phase_parallel(sk, tk, torch, device, dqn_rows, loop_row):
    """Phase 19, data parallel; returns the step kernel's launches in its
    paths (the ranks' own counts included)."""
    from tpu2048_torch.cli.main import main as cli_main
    from tpu2048_torch.metrics.logging import read_jsonl

    t0 = time.perf_counter()
    sharded_replay_equal(torch, device)
    launches = 0
    deterministic = torch.backends.cudnn.deterministic
    # Two runs compared bit for bit need the same cuDNN algorithms.
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            launches += parallel_shards_cli(sk, tk, torch, cli_main,
                                            read_jsonl, tmp, dqn_rows)
        with tempfile.TemporaryDirectory() as tmp:
            launches += parallel_nccl(sk, tk, torch, cli_main, read_jsonl,
                                      tmp)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    allreduce_share(torch, device)
    with tempfile.TemporaryDirectory() as tmp:
        launches += parallel_gloo(torch, device, tmp)
    launches += parallel_scale(sk, tk, torch, cli_main, loop_row)
    print(f"phase 19: {time.perf_counter() - t0:.1f} s of wall time")
    return launches


TP_SHARDS = 4  # phase 20 (a): the shards two gloo ranks write
TP_MORE_EPISODES = 2  # episodes the resume and the straight run go on for
TP_Q_BATCHES = (64, DQN_ENVS)  # the learner's and the actor's batch
TP_TIMED_UPDATES = 10
TP_FLOAT_KEYS = ("loss", "mean_return", "mean_score", "mean_length")


def rows_agree(got, want, rtol=PAR_LOSS_RTOL):
    """Rows of two runs agree: every key equal but the float sums' means
    (within ``rtol``) and ``steps_per_s``."""
    if len(got) != len(want):
        return False
    for a, b in zip(want, got):
        for k in a:
            if k in TP_FLOAT_KEYS:
                if abs(b[k] - a[k]) > rtol * max(abs(a[k]), 1e-12):
                    return False
            elif k != "steps_per_s" and b[k] != a[k]:
                return False
    return True


def sums_agree(got, want):
    return all(abs(got[k] - v) <= PAR_LOSS_RTOL * abs(v)
               if isinstance(v, float) else got[k] == v
               for k, v in want.items())


def tp_launches(fn):
    """``fn()`` and the step kernel's launches in it, on this process."""
    from tpu2048_torch.ops import step_kernel as sk

    before = sk.fused_env_step.launches
    out = fn()
    return out, sk.fused_env_step.launches - before


def reshard_writer(config, episodes, directory):
    """Phase 20 (a), a rank: train to ``episodes`` with checkpoints; its
    rows, host sums at the end (the last checkpoint's) and launches."""
    from tpu2048_torch.checkpoint.ckpt import CheckpointManager
    from tpu2048_torch.parallel import mesh
    from tpu2048_torch.training import dqn as dtrain

    def run():
        state = dtrain.init_loop_state(config, mesh.local_device())
        rows = dtrain.train(config, episodes, state.device, state=state,
                            ckpt_manager=CheckpointManager(directory))
        return rows, dtrain.host_sums(state)

    (rows, sums), launches = tp_launches(run)
    return rows, sums, launches


def tp_reshard(torch, device, tmp):
    """Phase 20 (a): two gloo ranks write 4 shards; one process on the card
    resumes them and goes on as a straight run does."""
    from tpu2048_torch.checkpoint.ckpt import CheckpointManager
    from tpu2048_torch.parallel.testkit import chunk_config, spawn_ranks
    from tpu2048_torch.training import dqn as dtrain

    config = dataclasses.replace(chunk_config(2, **PAR_GLOO_KW),
                                 replay_shards=TP_SHARDS)
    t0 = time.perf_counter()
    ranks = spawn_ranks(2, functools.partial(reshard_writer, config, 1, tmp),
                        backend="gloo", device="cuda")
    wall = time.perf_counter() - t0
    rows, sums, _ = ranks[0]
    last = rows[-1]["episodes"]
    total = last + TP_MORE_EPISODES
    mgr = CheckpointManager(tmp)
    names = sorted(os.listdir(os.path.join(tmp, "steps", str(last))))
    state = dtrain.init_loop_state(config, device)
    t0 = time.perf_counter()
    mgr.restore(mgr.latest_step(), state)
    restore_s = time.perf_counter() - t0
    restored = dtrain.host_sums(state)
    resumed, launches = tp_launches(
        lambda: dtrain.train(config, total, device, state=state))
    straight, straight_launches = tp_launches(
        lambda: dtrain.train(config, total, device))
    steps = config.steps_per_chunk * len(resumed)
    if (names != ["rank1.pt", "state.pt"] or ranks[1][1] != sums
            or not sums_agree(restored, sums)
            or not rows_agree(rows, straight[:len(rows)])
            or not rows_agree(resumed, straight[len(rows):])
            or launches != steps or not resumed):
        fail(f"phase 20 (a): files {names}; sums {sums} / {restored}; "
             f"written {rows}, resumed {resumed} against the straight run "
             f"{straight}; launches {launches} for {steps} vector steps")
    print(f"phase 20 (a): two gloo ranks sharing the card wrote "
          f"{TP_SHARDS} replay shards (features {config.agent.features}, "
          f"float32, dropout 0, {config.num_envs} envs, batch "
          f"{config.train_batch}) to episode {last} in {len(rows)} chunks "
          f"({wall:.3f} s, spawn included; files {names}); one process "
          f"restored all 4 shards in {restore_s:.3f} s, host_sums equal the "
          f"writers' (episodes {restored['ep']}, buffer {restored['size']}, "
          f"best {restored['best']}), and ran {len(resumed)} chunk(s) to "
          f"episode {resumed[-1]['episodes']} with {launches} step-kernel "
          f"launches on all {config.num_envs} lanes ({steps} vector steps); "
          f"its rows equal the straight one-process run's (integers equal, "
          f"means within rtol {PAR_LOSS_RTOL})")
    return sum(r[2] for r in ranks) + launches + straight_launches


def tp_grid(torch, device):
    """Phase 20 (b): a (2, 2) grid of four gloo ranks sharing the card
    against one process with two shards."""
    from tpu2048_torch.parallel.testkit import (chunk_config, run_chunks,
                                                spawn_ranks)

    config = chunk_config(2, **PAR_GLOO_KW)
    t0 = time.perf_counter()
    ranks = spawn_ranks(4, functools.partial(
        run_chunks, 4, 2, PAR_GLOO_CHUNKS, params=True, config=config),
        backend="gloo", device="cuda")
    wall = time.perf_counter() - t0
    one = run_chunks(4, 2, PAR_GLOO_CHUNKS, params=True, config=config,
                     device=device)
    worst = 0.0
    for got in ranks:
        for k, w in one["params"].items():
            g = got["params"][k].to(w.device)
            if not torch.allclose(g, w, rtol=PAR_PARAM_RTOL,
                                  atol=PAR_PARAM_ATOL):
                fail(f"phase 20 (b): (2, 2) grid, parameter {k} differs "
                     f"beyond rtol {PAR_PARAM_RTOL}, atol {PAR_PARAM_ATOL}")
            worst = max(worst, (g - w).abs().max().item())
        if (any(got[k] != one[k] for k in ("env_steps", "episodes",
                                           "train_steps", "eps"))
                or abs(got["loss_sum"] - one["loss_sum"])
                > PAR_LOSS_RTOL * abs(one["loss_sum"])
                or not got["launches"] > 0):
            digest = [{k: v for k, v in r.items() if k != "params"}
                      for r in ranks + [one]]
            fail(f"phase 20 (b): (2, 2) grid {digest[:4]} against one "
                 f"process {digest[4]}")
    steps = config.steps_per_chunk * PAR_GLOO_CHUNKS
    print(f"phase 20 (b): a (2, 2) grid of four gloo ranks sharing the card "
          f"(features {config.agent.features}, float32, dropout 0, "
          f"{config.num_envs} envs, batch {config.train_batch}, 2 shards, "
          f"the networks sliced over each row's 2 ranks, {steps} vector "
          f"steps): integers equal one process with 2 shards (env_steps "
          f"{one['env_steps']}, episodes {one['episodes']}, updates "
          f"{one['train_steps']}) on every rank, parameters within "
          f"{worst:.3g}, loss sums {[r['loss_sum'] for r in ranks]} against "
          f"{one['loss_sum']!r}; step-kernel launches "
          f"{[r['launches'] for r in ranks]} on the ranks, "
          f"{one['launches']} in one process; ms a vector step "
          f"{fmt_ms([1e3 * r['seconds'] / steps for r in ranks])} on the "
          f"ranks against {1e3 * one['seconds'] / steps:.4f} in one "
          f"process; {wall:.3f} s for the ranks' call")
    return sum(r["launches"] for r in ranks) + one["launches"]


def tp_boards(torch, b, device):
    gen = torch.Generator().manual_seed(SEED + 20 + b)
    boards = torch.randint(0, 12, (b, 4, 4), dtype=torch.int8, generator=gen)
    boards[torch.rand((b, 4, 4), generator=gen) < 0.3] = 0
    return boards.to(device)


def tp_timed_update(torch, state, cfg, device):
    """ms of one learner update at batch 64 on a sliced agent, and of the
    model group's gathers and all-reduces in it: host clock around
    ``TP_TIMED_UPDATES`` updates, the device synchronised, each collective
    timed between two synchronisations (gloo copies through the host)."""
    import torch.distributed as dist

    from tpu2048_torch.agents import dqn as tdqn
    from tpu2048_torch.parallel import mesh

    gen = torch.Generator().manual_seed(SEED + 21)
    b = 64
    batch = {"board": tp_boards(torch, b, device),
             "action": torch.randint(0, 4, (b,), generator=gen).to(device),
             "reward": torch.randn(b, generator=gen).to(device),
             "done": (torch.rand(b, generator=gen) < 0.1).to(device),
             "next_board": tp_boards(torch, b, device)}
    tdqn.train_step(cfg, state, batch)
    spent = {"gather": 0.0, "all_reduce": 0.0}
    calls = {"gather": 0, "all_reduce": 0}

    def timed(name, fn):
        def wrapper(*args, **kw):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize(device)
            spent[name] += time.perf_counter() - t0
            calls[name] += 1
            return out
        return wrapper

    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(TP_TIMED_UPDATES):
        tdqn.train_step(cfg, state, batch)
    torch.cuda.synchronize(device)
    plain = (time.perf_counter() - t0) / TP_TIMED_UPDATES
    gather, all_reduce = mesh._all_gather, dist.all_reduce
    mesh._all_gather = timed("gather", gather)
    dist.all_reduce = timed("all_reduce", all_reduce)
    try:
        for _ in range(TP_TIMED_UPDATES):
            tdqn.train_step(cfg, state, batch)
    finally:
        mesh._all_gather, dist.all_reduce = gather, all_reduce
    n = TP_TIMED_UPDATES
    return dict(update_ms=1e3 * plain,
                gather_ms=1e3 * spent["gather"] / n,
                all_reduce_ms=1e3 * spent["all_reduce"] / n,
                gathers=calls["gather"] / n,
                all_reduces=calls["all_reduce"] / n)


def tp_full_rank(directory):
    """Phase 20 (c), a rank of one model group of two at full width: the
    sliced forward against the whole module's, the timed update, then
    ``train`` at the ``train dqn`` defaults with a checkpoint. Returns the
    numbers, the rows, the Q-values of the check boards after training and
    the launches."""
    import torch

    from tpu2048_torch.agents import dqn as tdqn
    from tpu2048_torch.checkpoint.ckpt import CheckpointManager
    from tpu2048_torch.parallel import mesh
    from tpu2048_torch.training import dqn as dtrain

    device = mesh.local_device()
    cfg = tdqn.DQNConfig()
    model_group, _ = mesh.grid_groups(1, 2)
    sliced = tdqn.create_train_state(cfg, device, SEED, model_group)
    whole = tdqn.create_train_state(cfg, device, SEED)
    forward = []
    for b in TP_Q_BATCHES:
        boards = tp_boards(torch, b, device)
        sliced.model.eval()
        with torch.no_grad():
            qs, qw = sliced.model(boards), whole.model.eval()(boards)
        tol = DQN_MODEL_BF16_TOL * max(1.0, float(qw.abs().max()))
        forward.append(dict(batch=b, err=float((qs - qw).abs().max()),
                            tol=tol, finite=bool(torch.isfinite(qs).all())))
    del whole
    timing = tp_timed_update(torch, sliced, cfg, device)
    del sliced
    torch.cuda.empty_cache()
    config = dtrain.DQNTrainConfig(model_parallel=2, seed=SEED)

    def run():
        state = dtrain.init_loop_state(config, device)
        rows = dtrain.train(config, 1, device, state=state,
                            ckpt_manager=CheckpointManager(directory))
        state.agent.model.eval()
        with torch.no_grad():
            q = state.agent.model(tp_boards(torch, DQN_ENVS, device))
        return rows, q.cpu()

    (rows, q), launches = tp_launches(run)
    return dict(forward=forward, timing=timing, rows=rows, q=q,
                launches=launches)


def tp_full_width(torch, device, tmp):
    """Phase 20 (c): M = 2 at full width on two gloo ranks sharing the
    card, and the resume of their checkpoint in one process at M = 1."""
    from tpu2048_torch.checkpoint.ckpt import CheckpointManager
    from tpu2048_torch.parallel.testkit import spawn_ranks
    from tpu2048_torch.training import dqn as dtrain

    t0 = time.perf_counter()
    ranks = spawn_ranks(2, functools.partial(tp_full_rank, tmp),
                        backend="gloo", device="cuda")
    wall = time.perf_counter() - t0
    got = ranks[0]
    for r in ranks:
        for f in r["forward"]:
            if not (f["finite"] and f["err"] <= f["tol"]):
                fail(f"phase 20 (c): sliced forward at batch {f['batch']}: "
                     f"max |dQ| {f['err']:.3e} against {f['tol']:.3e}")
    rows = got["rows"]
    last = rows[-1]
    if (not rows_agree(ranks[1]["rows"], rows)
            or not torch.equal(ranks[1]["q"], got["q"])
            or last["train_steps"] + last["update_debt"]
            != 100 * last["episodes"] or not last["train_steps"] > 0
            or not math.isfinite(last["loss"])):
        fail(f"phase 20 (c): M = 2 train rows {rows} / {ranks[1]['rows']}")
    config = dtrain.DQNTrainConfig(seed=SEED)
    state = dtrain.init_loop_state(config, device)
    mgr = CheckpointManager(tmp)
    t0 = time.perf_counter()
    mgr.restore(mgr.latest_step(), state)
    restore_s = time.perf_counter() - t0
    state.agent.model.eval()
    with torch.no_grad():
        q = state.agent.model(tp_boards(torch, DQN_ENVS, device)).cpu()
    err = float((q - got["q"]).abs().max())
    tol = DQN_MODEL_BF16_TOL * max(1.0, float(got["q"].abs().max()))
    (_, eps), launches = tp_launches(
        lambda: dtrain.train_chunk(config, state))
    if (not err <= tol or launches != config.steps_per_chunk
            or state.agent.train_steps < last["train_steps"]):
        fail(f"phase 20 (c): the M = 1 resume: max |dQ| {err:.3e} against "
             f"{tol:.3e}, {launches} launches, {state.agent.train_steps} "
             "updates")
    t = got["timing"]
    share = (t["gather_ms"] + t["all_reduce_ms"]) / t["update_ms"]
    for f in got["forward"]:
        print(f"phase 20 (c): M = 2 at full width (bf16), two gloo ranks "
              f"sharing the card: sliced forward at batch {f['batch']} "
              f"against the whole module on the same weights: max |dQ| "
              f"{f['err']:.3e} (tolerance {f['tol']:.3e}, phase 16's)")
    print(f"phase 20 (c): a learner update at batch 64 on the sliced agent: "
          f"{t['update_ms']:.3f} ms (host clock, {TP_TIMED_UPDATES} "
          f"updates); in a timed turn its {t['gathers']:.0f} gathers take "
          f"{t['gather_ms']:.3f} ms and its {t['all_reduces']:.0f} "
          f"all-reduces {t['all_reduce_ms']:.3f} ms an update, "
          f"{100 * share:.1f}% of an untimed update (each collective "
          f"between two synchronisations; gloo through the host)")
    prev = 0
    for i, row in enumerate(rows):
        upd = row["train_steps"] - prev
        prev = row["train_steps"]
        ms = 1e3 * config.num_envs * config.steps_per_chunk / row[
            "steps_per_s"]
        print(f"phase 20 (c):   train, M = 2, chunk {i + 1}: {ms:.1f} ms, "
              f"{upd} updates"
              + (f", {(ms - rows_ms_plain(rows)) / upd:.1f} ms an update"
                 if upd else ""))
    print(f"phase 20 (c): train at the train dqn defaults, M = 2: "
          f"{len(rows)} chunks to episode {last['episodes']}, "
          f"{last['train_steps']} updates + {last['update_debt']} owed, "
          f"step-kernel launches {[r['launches'] for r in ranks]} on the "
          f"ranks; {wall:.3f} s for the ranks' call; the checkpoint (agent "
          f"gathered whole) restored in one process at M = 1 in "
          f"{restore_s:.3f} s: its Q-values on {DQN_ENVS} boards within "
          f"{err:.3e} of the ranks' (tolerance {tol:.3e}), one chunk with "
          f"{launches} launches")
    return sum(r["launches"] for r in ranks) + launches


def rows_ms_plain(rows):
    """ms of a chunk without updates: the mean of the chunks that took
    none (the actor, the env and the replay alone)."""
    ms, prev = [], 0
    for row in rows:
        if row["train_steps"] == prev:
            ms.append(1e3 * DQN_ENVS * DQN_CHUNK / row["steps_per_s"])
        prev = row["train_steps"]
    return sum(ms) / max(len(ms), 1)


def phase_tensor_parallel(torch, device):
    """Phase 20, tensor parallelism and resharded resume; returns the step
    kernel's launches in its paths (the ranks' own counts included)."""
    t0 = time.perf_counter()
    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        launches += tp_reshard(torch, device, tmp)
    launches += tp_grid(torch, device)
    with tempfile.TemporaryDirectory() as tmp:
        launches += tp_full_width(torch, device, tmp)
    print(f"phase 20: {time.perf_counter() - t0:.1f} s of wall time")
    return launches


def nt_gap(torch, got, want):
    """The largest |got - want| / max(1, |want|)."""
    return float(((got - want).abs() / want.abs().clamp_min(1)).max())


def nt_boards(torch, gen, b, device, empty_below):
    """``(16, b)`` cell-major boards of exponents 0-12, those below
    ``empty_below`` emptied, so that most lanes have a legal move."""
    from tpu2048_torch.ops.step_kernel import to_cell_major

    e = torch.randint(0, 13, (b, 16), generator=gen, device=device)
    e[e < empty_below] = 0
    return to_cell_major(e.to(torch.int8).view(b, 4, 4))


def ntuple_equal(nk, net, torch, device):
    """Phase 21's checks of both kernels against their plain versions;
    returns the inputs, the plain outputs and the largest gaps."""
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    net.weights.normal_(generator=gen)
    b = NT_LANES
    boards = nt_boards(torch, gen, b, device, 4)
    prev = nt_boards(torch, gen, b, device, 5)
    valid = torch.rand(b, generator=gen, device=device) < 0.9
    terminal = torch.rand(b, generator=gen, device=device) < 0.1
    args = (boards, prev, valid, terminal, net.weights, net.maps)
    got = nk.afterstate_values(*args)
    want = nk.plain_afterstate_values(*args)
    for name in ("after", "reward", "legal"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            fail(f"afterstate kernel: {name} != plain at B={b}")
    legal = want.legal
    if not torch.equal(torch.isfinite(got.values), legal):
        fail("afterstate kernel: -inf where a move is legal, or a value "
             "where it is not")
    value_gap = max(nt_gap(torch, got.values[legal], want.values[legal]),
                    nt_gap(torch, got.v_prev, want.v_prev),
                    nt_gap(torch, got.target, want.target))
    if value_gap > NT_RTOL:
        fail(f"afterstate kernel: values {value_gap:.3g} from plain, over "
             f"{NT_RTOL}")
    q = torch.where(legal, want.reward.to(torch.float32) + want.values,
                    -torch.inf)
    top = q.topk(2, 0).values
    near = (top[0] - top[1]) <= 2 * NT_RTOL * top[0].abs().clamp_min(1)
    differ = got.action != want.action
    if bool((differ & ~near).any()):
        fail(f"afterstate kernel: {int((differ & ~near).sum())} actions "
             "differ where the two best moves are apart")
    lanes = torch.arange(b, device=device)
    chosen = want.after[got.action.long(), :, lanes].T
    if not torch.equal(got.chosen, chosen):
        fail("afterstate kernel: the chosen afterstates are not those of "
             "its actions")
    kernel_w, plain_w = net.weights.clone(), net.weights.clone()
    nk.td_update_(kernel_w, net.counts, net.maps, prev, valid, want.v_prev,
                  want.target, 0.1)
    nk.plain_td_update_(plain_w, net.maps, prev, valid, want.v_prev,
                        want.target, 0.1)
    lut_gap = nt_gap(torch, kernel_w, plain_w)
    written = [int((w != net.weights).sum()) for w in (kernel_w, plain_w)]
    if lut_gap > NT_RTOL or net.counts.count_nonzero():
        fail(f"TD-update kernel: weights {lut_gap:.3g} from plain (limit "
             f"{NT_RTOL}), {int(net.counts.count_nonzero())} counts left")
    print(f"phase 21: n-tuple kernels at B={b}, 4x6 set, unit-normal "
          f"weights: afterstates, rewards, legality equal; values "
          f"{value_gap:.3g} of max(1, |V|) from plain; {int(differ.sum())} "
          f"actions differ, all near ties ({int(near.sum())} lanes within "
          f"{2 * NT_RTOL:g}); update {lut_gap:.3g} from plain, weights "
          f"written {written[0]} (kernel), {written[1]} (plain); counts "
          "zero after")
    return args, want, value_gap, lut_gap


def ntuple_timing(nk, net, torch, args, want):
    """Both kernels at phase 21's inputs: eager, device only, plain, and
    the bound; returns a row each."""
    from benchmark.counts import ntuple_bytes as nb

    boards, prev, valid, terminal, weights, maps = args
    b, lookups = boards.shape[1], maps.shape[0]
    legal, n_prev = int(want.legal.sum()), int(valid.sum())
    scratch = weights.clone()
    calls = {
        "afterstate_kernel": (
            lambda: nk.afterstate_values(*args),
            lambda: nk.plain_afterstate_values(*args),
            nb.value_bytes(b, legal, n_prev, lookups)),
        "td_update_kernel": (
            lambda: nk.td_update_(scratch, net.counts, maps, prev, valid,
                                  want.v_prev, want.target, 0.1),
            lambda: nk.plain_td_update_(scratch, maps, prev, valid,
                                        want.v_prev, want.target, 0.1),
            nb.update_bytes(b, n_prev, lookups)),
    }
    rows = {}
    for name, (fn, plain, n_bytes) in calls.items():
        ms = elapsed_ms(torch, fn, 50)
        dev = graph_ms(torch, fn, 20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        rows[name] = dict(ms=ms, graph_ms=dev, plain_ms=plain_ms,
                          bound_ms=bound, bound_by="bytes")
        print(f"phase 21: {name} at B={b}: {ms:.5f} ms eager, {dev:.5f} ms "
              f"device (graph), plain {plain_ms:.3f} ms; bound "
              f"{bound:.3g} ms ({n_bytes} useful bytes at the HBM rate, "
              f"{100 * bound / dev:.2f}% of it)")
    return rows


def ntuple_counts(sk, nk, torch):
    torch.cuda.synchronize()
    return {"value": nk.afterstate_values.launches,
            "update": nk.td_update_.launches,
            "step": sk.fused_env_step.launches}


def ntuple_path(sk, nk, torch):
    """``train ntuple`` and ``eval --policy ntuple`` through the CLI;
    returns each kernel's launches over both."""
    from tpu2048_torch.cli.main import main as cli_main
    from tpu2048_torch.metrics.logging import read_jsonl
    from tpu2048_torch.training import ntuple as ntrain

    with tempfile.TemporaryDirectory() as tmp:
        weights, log = f"{tmp}/nt.npz", f"{tmp}/nt.jsonl"
        for fn in (nk.afterstate_values, nk.td_update_, sk.fused_env_step):
            fn.launches = 0
        chunk = ntrain.train_chunk
        modes = ("eager_steps", "graph_steps", "captures")
        before = [getattr(chunk, m) for m in modes]
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli_main(["train", "ntuple", "--lanes", str(NT_LANES),
                           "--steps-per-chunk", str(NT_CHUNK),
                           "--episodes", str(NT_EPISODES),
                           "--seed", str(SEED), "--save", weights,
                           "--log", log])
        train = ntuple_counts(sk, nk, torch)
        wall = time.perf_counter() - t0
        if rc != 0:
            fail(f"train ntuple returned {rc}")
        rows = read_jsonl(log)
        steps = rows[-1]["env_steps"] // NT_LANES
        graph = {m: getattr(chunk, m) - n for m, n in zip(modes, before)}
        if train != {"value": steps, "update": 3 * steps, "step": steps}:
            fail(f"train ntuple: launches {train} in {steps} steps")
        if graph != {"eager_steps": 1, "graph_steps": steps - 1,
                     "captures": 1}:
            fail(f"train ntuple: {graph} in {steps} steps")
        print(f"phase 21: train ntuple, {NT_LANES} lanes, {NT_CHUNK} steps "
              f"a chunk: {rows[-1]['episodes']} games in {steps} steps, "
              f"{len(rows)} chunks, {wall:.2f} s with the build and the "
              f"capture; launches {train}; {graph}; last chunk "
              f"{rows[-1]['steps_per_s']:.4g} env-steps/s, mean score "
              f"{rows[-1]['mean_score']:.1f}, best tile "
              f"{rows[-1]['best_tile']}")
        for fn in (nk.afterstate_values, nk.td_update_, sk.fused_env_step):
            fn.launches = 0
        rc, summary = run_cli(cli_main, [
            "eval", "--policy", "ntuple", "--weights", weights,
            "--games", str(NT_EVAL_GAMES), "--eval-batch",
            str(NT_EVAL_GAMES), "--seed", str(SEED)])
        evals = ntuple_counts(sk, nk, torch)
        if rc != 0:
            fail(f"eval --policy ntuple returned {rc}")
        n = summary["batch_steps"]
        if evals != {"value": n, "update": 0, "step": n}:
            fail(f"eval --policy ntuple: launches {evals} in {n} steps")
        print(f"phase 21: eval --policy ntuple, {summary['games']} games: "
              f"mean score {summary['score_mean']:.1f}, 2048 in "
              f"{100 * summary['win_rate_2048']:.1f}%, launches {evals} in "
              f"{n} batched steps, {summary['seconds']:.2f} s")
    return {k: train[k] + evals[k] for k in train}


def phase_ntuple(sk, torch, device):
    """Phase 21; returns the launches and a kernels-line entry each."""
    from tpu2048_torch.models.ntuple import NTupleNetwork
    from tpu2048_torch.ops import ntuple_kernel as nk

    t0 = time.perf_counter()
    nk.LIBRARY.load()
    print(f"phase 21: n-tuple kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in nk.LIBRARY.path().with_suffix(".log").read_text() \
            .splitlines():
        print(f"phase 21: nvcc, n-tuple kernels: {line.strip()}")
    net = NTupleNetwork(device=device)
    args, want, value_gap, lut_gap = ntuple_equal(nk, net, torch, device)
    rows = ntuple_timing(nk, net, torch, args, want)
    del net, args, want
    torch.cuda.synchronize()
    launches = ntuple_path(sk, nk, torch)
    entries = [
        dict(name=name, route="cuda",
             source="tpu2048_torch/csrc/ntuple_kernel.cu", replaces=None,
             launches=launches[key], max_rel_err=err, **rows[name],
             library_ms=None, library_graph_ms=None)
        for name, key, err in (("afterstate_kernel", "value", value_gap),
                               ("td_update_kernel", "update", lut_gap))]
    return launches["step"], entries


def search_equal(nk, net, torch, device):
    """Phase 22's checks of the search kernels against the plain version at
    unit-normal weights; returns the largest value gap."""
    gen = torch.Generator(device=device).manual_seed(SEED + 22)
    net.weights.normal_(generator=gen)
    b, worst = SEARCH_GAMES, 0.0
    counter = nk.leaf_counter(device)
    for name, empty_below in (("early", 9), ("mid", 4), ("late", 2)):
        boards = nt_boards(torch, gen, b, device, empty_below)
        for depth in (2, 3):
            before = int(counter)
            got = nk.search_values(boards, net.weights, net.maps, depth)
            leaves = int(counter) - before
            want, plain_leaves = nk.plain_search_values(
                boards, net.weights, net.maps, depth)
            legal = torch.isfinite(want.values)
            if leaves != plain_leaves:
                fail(f"search: {leaves} leaves, plain {plain_leaves} "
                     f"({name}, depth {depth})")
            if not torch.equal(torch.isfinite(got.values), legal):
                fail(f"search: -inf where a move is legal, or a value where "
                     f"it is not ({name}, depth {depth})")
            gap = nt_gap(torch, got.values[legal], want.values[legal])
            top = want.values.topk(2, 0).values
            near = (top[0] - top[1]) <= 2 * NT_RTOL * top[0].abs().clamp_min(
                1)
            differ = got.action != want.action
            if gap > NT_RTOL or bool((differ & ~near).any()):
                fail(f"search: values {gap:.3g} from plain (limit "
                     f"{NT_RTOL}), {int((differ & ~near).sum())} actions "
                     f"apart from near ties ({name}, depth {depth})")
            worst = max(worst, gap)
            print(f"phase 22: search at B={b}, {name} boards, depth "
                  f"{depth}: {leaves} leaves = plain's; values {gap:.3g} of "
                  f"max(1, |v|) from plain; {int(differ.sum())} actions "
                  f"differ, all near ties")
    return worst


def search_table(torch, device):
    """The 4x6-tuple network trained from zero as the cell fills its
    table."""
    from tpu2048_torch.env import fast as fastlib
    from tpu2048_torch.models.ntuple import NTupleNetwork
    from tpu2048_torch.training import ntuple as ntrain

    config = ntrain.NTupleTrainConfig(batch_size=NT_LANES,
                                      steps_per_chunk=NT_CHUNK)
    net = NTupleNetwork(device=device)
    bits = fastlib.GeneratorBits(SEED + 22, device)
    st = ntrain.init_train_state(config, bits)
    t0 = time.perf_counter()
    for _ in range(SEARCH_FILL_CHUNKS):
        st = ntrain.train_chunk(config, net, st, bits)
    torch.cuda.synchronize()
    print(f"phase 22: table filled by {SEARCH_FILL_CHUNKS} chunks of "
          f"{NT_LANES} lanes x {NT_CHUNK} steps in "
          f"{time.perf_counter() - t0:.2f} s: {int(st.episodes_done)} games, "
          f"best tile {int(st.best_tile)}, "
          f"{int(net.weights.count_nonzero())} weights touched")
    return net


def search_path(sk, nk, torch, net):
    """``eval --policy ntuple --search-depth 3`` through the CLI on the
    trained table; returns the step kernel's and the search's launches."""
    from tpu2048_torch.cli.main import main as cli_main

    with tempfile.TemporaryDirectory() as tmp:
        weights = f"{tmp}/nt.npz"
        net.save(weights)
        for fn in (nk.afterstate_values, nk.search_values,
                   sk.fused_env_step):
            fn.launches = 0
        nk.leaf_runs.derivations = 0
        rc, summary = run_cli(cli_main, [
            "eval", "--policy", "ntuple", "--weights", weights,
            "--search-depth", str(SEARCH_DEPTH), "--games",
            str(SEARCH_GAMES), "--eval-batch", str(SEARCH_GAMES), "--seed",
            str(SEED)])
    if rc != 0:
        fail(f"eval --policy ntuple --search-depth {SEARCH_DEPTH} returned "
             f"{rc}")
    n = summary["batch_steps"]
    launches = dict(search=nk.search_values.launches,
                    step=sk.fused_env_step.launches,
                    value=nk.afterstate_values.launches)
    if launches != dict(search=2 * n, step=n, value=0):
        fail(f"eval --search-depth {SEARCH_DEPTH}: launches {launches} in "
             f"{n} steps")
    derivations = nk.leaf_runs.derivations
    if derivations != 1:
        fail(f"eval --search-depth {SEARCH_DEPTH}: the leaf runs derived "
             f"{derivations} times for one network")
    print(f"phase 22: eval --policy ntuple --search-depth {SEARCH_DEPTH}, "
          f"{summary['games']} games: mean score {summary['score_mean']:.1f}"
          f", 2048 in {100 * summary['win_rate_2048']:.1f}%, best tile "
          f"{summary['best_tile']}, mean length {summary['length_mean']:.1f}"
          f"; launches {launches} in {n} batched steps, leaf runs "
          f"derived {derivations} time(s), "
          f"{summary['seconds']:.2f} s ({1e3 * summary['seconds'] / n:.3f} "
          "ms a step)")
    return launches["step"], launches["search"]


def search_timing(nk, net, torch):
    """The search at the roots of some steps of a depth-3 call: eager,
    device only, host time a call, one plain call, the bound; returns the
    rows."""
    from benchmark.counts import search_work
    from tpu2048_torch.env import fast as fastlib
    from tpu2048_torch.eval import evaluate as ev
    from tpu2048_torch.ops.step_kernel import to_cell_major

    search = ev.expectimax_ntuple_policy(net, SEARCH_DEPTH)
    roots = []

    def recorded(params, boards, legal):
        roots.append(boards)
        return search(boards, legal)

    ev.evaluate(ev.Policy(fn=recorded), SEARCH_GAMES,
                fastlib.GeneratorBits(SEED + 1, net.device),
                batch_size=SEARCH_GAMES, max_steps=max(SEARCH_TIMING_STEPS),
                engine="fast")
    counter = nk.leaf_counter(net.device)
    patterns = [list(p) for p in net.patterns]
    rows = []
    for step in SEARCH_TIMING_STEPS:
        if step >= len(roots):
            continue
        boards = to_cell_major(roots[step].to(torch.int8))

        def fn():
            return nk.search_values(boards, net.weights, net.maps,
                                    SEARCH_DEPTH)

        before = int(counter)
        fn()
        leaves = int(counter) - before
        ms = elapsed_ms(torch, fn, 20)
        dev = graph_ms(torch, fn, 10)
        host = host_us(torch, {"search": fn}, n=200)["search"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nk.plain_search_values(boards, net.weights, net.maps, SEARCH_DEPTH)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        work = search_work.step_work(
            roots[step].reshape(-1, 16).to(torch.int64), patterns,
            SEARCH_DEPTH)
        n_bytes = search_work.search_bytes(SEARCH_GAMES,
                                           work["distinct_weights"])
        n_ops = search_work.search_ops(work["distinct_leaves"],
                                       net.lookups)
        least, term = search_work.least_s(n_bytes, n_ops)
        if work["leaves"] != leaves:
            fail(f"search: counter {leaves} leaves, enumeration "
                 f"{work['leaves']} at step {step}")
        row = dict(step=step, leaves=leaves, ms=ms, graph_ms=dev,
                   host_us=host, plain_ms=plain_ms, bound_ms=least * 1e3,
                   bound_by=term, ns_per_leaf=dev * 1e6 / leaves,
                   distinct_leaves=work["distinct_leaves"],
                   distinct_weights=work["distinct_weights"])
        rows.append(row)
        print(f"phase 22: search at step {step}'s {SEARCH_GAMES} roots, "
              f"depth {SEARCH_DEPTH}, trained table: {leaves} leaves "
              f"({work['distinct_leaves']} distinct in their trees, "
              f"{work['distinct_weights']} distinct weights); {ms:.4f} ms "
              f"eager, {dev:.4f} ms device (graph), host {host:.1f} us a "
              f"call, plain {plain_ms:.1f} ms; {row['ns_per_leaf']:.4f} ns "
              f"a leaf; bound {least * 1e3:.4g} ms ({term}, "
              f"{100 * least * 1e3 / dev:.2f}% of it)")
    return rows


def phase_search(sk, torch, device):
    """Phase 22; returns the step kernel's launches and the kernels-line
    entry."""
    from tpu2048_torch.models.ntuple import NTupleNetwork
    from tpu2048_torch.ops import ntuple_kernel as nk

    t0 = time.perf_counter()
    nk.SEARCH_LIBRARY.load()
    print(f"phase 22: search kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in nk.SEARCH_LIBRARY.path().with_suffix(".log").read_text() \
            .splitlines():
        if any(word in line for word in ("expectimax", "Used", "spill")):
            print(f"phase 22: nvcc, search kernels: {line.strip()}")
    net = NTupleNetwork(device=device)
    gap = search_equal(nk, net, torch, device)
    del net
    net = search_table(torch, device)
    step_launches, launches = search_path(sk, nk, torch, net)
    rows = search_timing(nk, net, torch)
    row = rows[0]
    entry = dict(name="expectimax_search", route="cuda",
                 source="tpu2048_torch/csrc/expectimax_kernel.cu",
                 replaces=None, launches=launches, max_rel_err=gap,
                 ms=row["ms"], graph_ms=row["graph_ms"],
                 host_us=row["host_us"], plain_ms=row["plain_ms"],
                 bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                 library_ms=None, library_graph_ms=None)
    return step_launches, entry


def search_only(torch):
    """Phases 1, 2 (the search source) and 22 alone."""
    sys.path.insert(0, str(REPO))
    from tpu2048_torch.ops import step_kernel as sk

    device = torch.device("cuda", 0)
    print(f"phase 1: card: {card_line()}")
    print(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    sk.LIBRARY.load()
    _, entry = phase_search(sk, torch, device)
    print(json.dumps({"kernels": [entry]}))


def ntuple_only(torch):
    """Phases 1, 2 (the n-tuple source) and 21 alone."""
    sys.path.insert(0, str(REPO))
    from tpu2048_torch.ops import step_kernel as sk

    device = torch.device("cuda", 0)
    print(f"phase 1: card: {card_line()}")
    print(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    sk.LIBRARY.load()
    _, entries = phase_ntuple(sk, torch, device)
    print(json.dumps({"kernels": entries}))


def main():
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not installed: {e}")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    usage = ("usage: chip_smoke.py [--table-timing ROOT | --step-timing "
             "ROOT | --ntuple | --search]")
    timing = {"--table-timing": table_timing_only,
              "--step-timing": step_timing_only}
    only = {"--ntuple": ntuple_only, "--search": search_only}
    if len(sys.argv) == 2 and sys.argv[1] in only:
        only[sys.argv[1]](torch)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:2] and sys.argv[1] in timing:
        if len(sys.argv) != 3:
            fail(usage)
        print(f"card: {card_line()}")
        timing[sys.argv[1]](torch, sys.argv[2])
        return
    if sys.argv[1:]:
        fail(usage)
    if not (REPO / "tpu2048_torch" / "csrc" / "step_kernel.cu").is_file():
        fail(f"{REPO} holds no tpu2048_torch package: run from the repository")
    sys.path.insert(0, str(REPO))
    from tpu2048_torch.ops import step_kernel as sk
    from tpu2048_torch.ops import table_kernel as tk

    device = torch.device("cuda", 0)
    card = card_line()
    print(f"phase 1: card: {card}")
    print(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    print(f"phase 1: max SM clock {nvidia_smi('clocks.max.sm')}, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs: "
          f"32-bit integer peak {INT32_RESULTS_PER_CLOCK_PER_SM} a clock an "
          f"SM = {int_ops_per_s():.4g} operations/s")

    phase_build(sk, tk)
    max_err = phase_equal(sk, torch, device)
    launches, greedy_fast = phase_main_path(sk, torch, device)
    main_row = phase_step_timing(sk, torch, device, REPO)[0]
    gather_err, scatter_err = phase_table_equal(tk, torch, device)
    table_launches, packed_rows = phase_tabular(sk, tk, torch, device)
    phase_narrow(sk, tk, torch, device)
    data = torch.zeros(((1 << TABLE_LOG2) // tk.BUCKET + 1, tk.ROW),
                       dtype=torch.int32, device=device)
    table_rows = phase_table_timing(tk, torch, data, TABLE_BATCH)
    for b in TABLE_TIMING_SIZES[1:]:
        phase_table_timing(tk, torch, data, b)
    table_host_split(tk, torch, data, TABLE_BATCH)
    del data
    torch.cuda.synchronize()
    rollout_err = phase_rollout_equal(sk, torch, device)
    path_launches, random_fast = phase_rollout_path(sk, tk, torch)
    rollout_row = phase_rollout_timings(sk, torch, device,
                                        ROLLOUT_TIMING_CASES)[0]
    dqn_launches, dqn_rows = phase_dqn_path(sk, tk, torch, device)
    phase_dqn_narrow(torch, device)
    _, loop_row = phase_dqn_benches(sk, tk, torch)
    phase_fused_forward(torch, device)
    phase_fused_learner(torch, device)
    phase_dqn_narrow(torch, device, fused=True)
    fused_launches = phase_fused_train(sk, tk, torch, device)
    legacy_launches = phase_legacy(sk, tk, torch, device, packed_rows)
    phase_legacy_narrow(torch, device)
    lax_launches = phase_lax(sk, tk, torch, device, dict(
        packed_rows=packed_rows, random_fast=random_fast,
        greedy_fast=greedy_fast, dqn_rows=dqn_rows))
    parallel_launches = phase_parallel(sk, tk, torch, device, dqn_rows,
                                       loop_row)
    tensor_launches = phase_tensor_parallel(torch, device)
    ntuple_launches, ntuple_entries = phase_ntuple(sk, torch, device)
    search_launches, search_entry = phase_search(sk, torch, device)

    def table_entry(name, line, launches, err):
        row = table_rows[name]
        return {
            "name": name, "route": "cuda",
            "source": "tpu2048_torch/csrc/table_kernel.cu",
            "replaces": f"tpu2048/ops/table_kernel.py:{line}",
            "launches": launches, "max_abs_err": err, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library_graph_ms": row["library_graph_ms"],
        }

    print(f"card: {card}")
    print(json.dumps({"kernels": [
        {
            "name": "step_kernel",
            "route": "cuda",
            "source": "tpu2048_torch/csrc/step_kernel.cu",
            "replaces": "tpu2048/ops/pallas_step.py:308",
            "launches": launches + path_launches["step"] + dqn_launches
            + fused_launches + legacy_launches + parallel_launches
            + tensor_launches + ntuple_launches + search_launches,
            "max_abs_err": max_err,
            "ms": main_row["ms"],
            "graph_ms": main_row["graph_ms"],
            "host_us": main_row["host_us"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": None,
            "library_graph_ms": None,
        },
        table_entry("bucket_gather", 65,
                    table_launches["gather"] + path_launches["gather"]
                    + lax_launches["gather"], gather_err),
        table_entry("bucket_scatter", 112,
                    table_launches["scatter"] + path_launches["scatter"]
                    + lax_launches["scatter"], scatter_err),
        {
            "name": "rollout_kernel",
            "route": "cuda",
            "source": "tpu2048_torch/csrc/step_kernel.cu",
            "replaces": "tpu2048/ops/pallas_step.py:497",
            "launches": path_launches["rollout"],
            "max_abs_err": rollout_err,
            "ms": rollout_row["ms"],
            "graph_ms": rollout_row["graph_ms"],
            "host_us": rollout_row["host_us"],
            "plain_ms": rollout_row["plain_ms"],
            "bound_ms": rollout_row["bound_ms"],
            "bound_by": rollout_row["bound_by"],
            "library_ms": None,
            "library_graph_ms": None,
        },
        *ntuple_entries,
        search_entry,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
