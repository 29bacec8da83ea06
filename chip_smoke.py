"""Start-up check of the PyTorch/CUDA port (``tpu2048_torch``) on one GPU.

Run from the root of the repository, on a machine with one CUDA card and
the CUDA toolkit::

    python3 chip_smoke.py

Every phase is fatal on failure; without a card, or outside the repository,
it exits non-zero and prints no result.

1. The card's name and power limit, and the torch and CUDA versions.
2. Build the kernels from ``tpu2048_torch/csrc`` with nvcc (sm_90a), one
   nvcc for each source, started together; print the seconds and ptxas's
   resource usage.
3. Hold the kernel against ``plain_env_step`` on the card: B in {512, 1000,
   65536}, simple and shaped modes, every emit-flag combination, 32-step
   trajectories fed back into themselves, actions that include -1, bits that
   include 0, 0x7FFFFFFF, 0x80000000 and 0xFFFFFFFF. Every output must be
   equal.
4. The main path: ``tpu2048_torch.cli.main(["eval", "--policy", "model",
   ...])`` in process, 512 games at batch 512, on a seeded full-width
   Q-network (features 2048, hidden 1024, 3 blocks, bf16). The kernel's
   launch count must equal the batched steps played. Then: the bf16
   Q-values of 64 boards on the card against the same weights in float32 on
   the CPU; and a small greedy evaluation on the card against the same one
   on the CPU, on the same bits, which must agree exactly.
5. Time the kernel and its plain version with CUDA events at B=512 (the
   main path's shape) and B=65536, beside the least time the card could
   take for the same work.
6. Hold the table kernels (bucket gather, bucket scatter) against their
   plain versions on the card, on the full (2**21 + 1, 128) table filled
   from a seeded generator: B in {1, 5, 33, 1024, 65536}, bucket indices
   that include 0 and NB - 1, and repeated writes to the trash row. Rows
   [0, NB) must be equal (the trash row is write-only, its write order
   free), and the scatter must write in place.
7. The tabular main path: ``tpu2048_torch.cli.main(["train", "tabular",
   ...])`` in process at the ``train tabular`` defaults (capacity 2**25,
   batch 1024, 256 steps a chunk, shaped reward, fast engine) for at least
   two chunks. Gathers must equal 2 x env steps, scatters and step kernels
   1 x env steps. Prints the rows, the step time, the ``q_states`` scan
   time and the peak memory.
8. A narrow trainer on the card against the same trainer on the CPU, on the
   same explicit bits and draws, with the card's chunk run under
   ``torch.cuda.set_sync_debug_mode("error")`` (a chunk never waits for the
   device): integer state equal, Q within ``Q_RTOL``. Then a narrow table
   trained on the card is saved and ``eval --policy tabular`` plays it on
   the card.
9. Time the table kernels at B=1024 (the path's shape) and B=65536: eager,
   device only, plain version, and the PyTorch call that computes the same
   function (``index_select``, ``index_copy_``), beside the bound.
10. One JSON line describing the kernels, then the result line.
"""

import concurrent.futures
import contextlib
import io
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 2048
EVAL_GAMES = 512
TRAJECTORY_STEPS = 32
# H100 SXM (NVIDIA data sheet): HBM rate, and the float32 rate outside the
# tensor cores, taken as the peak of the kernel's 32-bit integer operations.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# 32-bit operations a lane does, counted at source level in
# csrc/step_kernel.cu: legality of 4 directions (352), the chosen merge
# (356), game over (82) and the two maxima (126) on every lane; the legal
# mask of the next board (352) with emit_legal; the random pick (25) where
# the action is < 0, the spawn (116) where the move is valid and the reset
# (76) where the episode ends.
OPS_LANE, OPS_LEGAL, OPS_PICK, OPS_SPAWN, OPS_RESET = 916, 352, 25, 116, 76
# bf16 on the card against float32 on the CPU: bf16 keeps 8 bits, so each
# layer's inputs, weights and outputs round by up to 2**-9; over five layers
# the Q-values moved by ~0.5% of max|Q| at full width on the CPU.
Q_BF16_RTOL = 3e-2
# Full width of the tabular slice: the `train tabular` defaults.
TABLE_LOG2, TABLE_BATCH, TABLE_CHUNK = 25, 1024, 256
TABLE_EPISODES = 3072  # ~1 episode a lane a chunk: 2-3 chunks
TABLE_SIZES = (1, 5, 33, 1024, 65536)
# Card against CPU, narrow trainer: the shaped reward's log2 and pow may
# round one float32 ulp apart on the two devices, and the TD updates carry
# that on (the CPU tests hold the port to JAX at the same tolerance).
Q_RTOL = 1e-5


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def edge_bits(gen, b, device):
    """(8, b) int32 bit rows; lanes 0-3 and ~10% of the rest hold the edge
    patterns 0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF (as int32 storage)."""
    import torch

    bits = torch.randint(-(2**31), 2**31, (8, b), dtype=torch.int32,
                         generator=gen, device=device)
    edge = torch.tensor([0, 0x7FFFFFFF, -(2**31), -1], dtype=torch.int32,
                        device=device)
    bits[:, :4] = edge
    pick = torch.randint(0, 4, (8, b), generator=gen, device=device)
    use = torch.rand((8, b), generator=gen, device=device) < 0.1
    return torch.where(use, edge[pick], bits).contiguous()


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
    max_err, checks, done_lanes, random_lanes = 0, 0, 0, 0
    cases = itertools.product((512, 1000, 65536), (False, True),
                              (False, True), (False, True))
    for b, shaped, pre, legal in cases:
        kw = dict(emit_pre_reset=pre, emit_legal=legal)
        boards_k = boards_p = start_boards(gen, b, device)
        for _ in range(TRAJECTORY_STEPS):
            actions = torch.randint(-1, 4, (b,), dtype=torch.int32,
                                    generator=gen, device=device)
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
            boards_k, boards_p = out_k[0], out_p[0]
    torch.cuda.synchronize()
    if not done_lanes or not random_lanes:
        fail("the trajectories ended no game or had no random-legal lane")
    print(f"phase 3: kernel == plain_env_step on the card: {checks} outputs, "
          f"{done_lanes} episode ends, {random_lanes} random-legal lanes, "
          f"max |diff| {max_err}")
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


def phase_main_path(sk, torch, device):
    from tpu2048_torch.agents.dqn import DQNConfig
    from tpu2048_torch.checkpoint.params import save_params
    from tpu2048_torch.cli.main import main as cli_main
    from tpu2048_torch.env.fast import ReplayBits
    from tpu2048_torch.eval.evaluate import evaluate, greedy_dqn_policy
    from tpu2048_torch.models import dqn as tdqn

    t0 = time.perf_counter()
    config = DQNConfig()  # features 2048, hidden 1024, 3 blocks, bf16
    model = tdqn.init_params(tdqn.create_model(config, "cpu"),
                             torch.Generator().manual_seed(SEED))
    params = tdqn.to_flax_params(model)
    del model
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
    return launches


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


def phase_timing(sk, torch, device, b):
    """The main path's call (simple mode, emit_legal, greedy actions) at
    batch ``b``: kernel, its graph-replayed device time, plain version, and
    the bound from the bytes and operations these inputs need."""
    gen = torch.Generator(device=device).manual_seed(SEED + b)
    boards = start_boards(gen, b, device)
    actions = torch.randint(0, 4, (b,), dtype=torch.int32, generator=gen,
                            device=device)
    bits = torch.randint(-(2**31), 2**31, (8, b), dtype=torch.int32,
                         generator=gen, device=device)

    def kernel():
        return sk.fused_env_step(boards, actions, bits, emit_legal=True)

    def plain():
        return sk.plain_env_step(boards, actions, bits, emit_legal=True)

    out = kernel()
    n_rand = int((actions < 0).sum())
    n_moved = int(out[2].sum())
    n_done = int(out[3].sum())
    # Inputs: board, action, and the bit rows a lane needs (row 0 if the
    # action is < 0, rows 2-3 if the move is valid, rows 4-7 if the episode
    # ends). Outputs: board, score, valid, done, max, second, legal mask.
    n_bytes = (b * (16 + 4) + 4 * n_rand + 8 * n_moved + 16 * n_done
               + b * (16 + 4 + 1 + 1 + 1 + 1 + 4))
    n_ops = (b * (OPS_LANE + OPS_LEGAL) + OPS_PICK * n_rand
             + OPS_SPAWN * n_moved + OPS_RESET * n_done)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / ALU_OPS_PER_S * 1e3
    row = {
        "batch": b,
        "ms": elapsed_ms(torch, kernel, 200),
        "graph_ms": graph_ms(torch, kernel, 20),
        "plain_ms": elapsed_ms(torch, plain, 20),
        "bytes": n_bytes, "ops": n_ops,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    print("phase 5: " + json.dumps(row))
    return row


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
    torch.cuda.synchronize()
    print(f"phase 6: bucket_gather and bucket_scatter_ == plain versions on "
          f"the ({nb + 1}, {tk.ROW}) table at B in {TABLE_SIZES}: rows "
          f"[0, NB) equal, scatter in place; max |diff| {gather_err} / "
          f"{scatter_err}")
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
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
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
    for row in rows:
        if (set(row) != ROW_KEYS or not row["q_states"] > 0
                or not 0 <= row["epsilon"] <= 1
                or sum(row["action_counts"]) != row["env_steps"]
                or not all(map(lambda v: v == v, (row["mean_return"],
                                                  row["mean_score"])))):
            fail(f"implausible row {row}")
    print(f"phase 7: {launches} launches for {steps} env steps (gathers = 2 "
          f"x steps, scatters = step kernels = steps); {wall:.3f} s for "
          f"the CLI call; peak device memory {peak} bytes")
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


def phase_table_timing(tk, torch, data, b):
    """Both kernels at batch ``b`` on the full table: eager, device only,
    plain version, the PyTorch call for the same function, and the bound.
    Every call reads other buckets (256 MB of rows in all), so the rows
    come from device memory, not the 50 MB L2, as on the path."""
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
    out = {}
    for name, (kernel, plain, library) in calls.items():
        row = {
            "kernel": name, "batch": b,
            "ms": elapsed_ms(torch, kernel, n_sets),
            "graph_ms": graph_ms(torch, kernel, min(n_sets, 256)),
            "plain_ms": elapsed_ms(torch, plain, n_sets),
            "library_ms": elapsed_ms(torch, library, n_sets),
            "bytes": n_bytes, "bound_ms": bound_ms, "bound_by": "bytes",
        }
        print("phase 9: " + json.dumps(row))
        out[name] = row
    return out


def main():
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not installed: {e}")
    if not torch.cuda.is_available():
        fail("no CUDA device")
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

    phase_build(sk, tk)
    max_err = phase_equal(sk, torch, device)
    launches = phase_main_path(sk, torch, device)
    main_row = phase_timing(sk, torch, device, EVAL_GAMES)
    phase_timing(sk, torch, device, 65536)
    gather_err, scatter_err = phase_table_equal(tk, torch, device)
    table_launches, _ = phase_tabular(sk, tk, torch, device)
    phase_narrow(sk, tk, torch, device)
    data = torch.zeros(((1 << TABLE_LOG2) // tk.BUCKET + 1, tk.ROW),
                       dtype=torch.int32, device=device)
    table_rows = phase_table_timing(tk, torch, data, TABLE_BATCH)
    phase_table_timing(tk, torch, data, 65536)
    del data
    torch.cuda.synchronize()

    def table_entry(name, line, launches, err):
        row = table_rows[name]
        return {
            "name": name, "route": "cuda",
            "source": "tpu2048_torch/csrc/table_kernel.cu",
            "replaces": f"tpu2048/ops/table_kernel.py:{line}",
            "launches": launches, "max_abs_err": err, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        }

    print(f"card: {card}")
    print(json.dumps({"kernels": [
        {
            "name": "step_kernel",
            "route": "cuda",
            "source": "tpu2048_torch/csrc/step_kernel.cu",
            "replaces": "tpu2048/ops/pallas_step.py:308",
            "launches": launches,
            "max_abs_err": max_err,
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": None,
        },
        table_entry("bucket_gather", 65, table_launches["gather"],
                    gather_err),
        table_entry("bucket_scatter", 112, table_launches["scatter"],
                    scatter_err),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
