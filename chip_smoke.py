"""Start-up check of the PyTorch/CUDA port (``tpu2048_torch``) on one GPU.

Run from the root of the repository, on a machine with one CUDA card and
the CUDA toolkit::

    python3 chip_smoke.py

Every phase is fatal on failure; without a card, or outside the repository,
it exits non-zero and prints no result.

1. The card's name and power limit, and the torch and CUDA versions.
2. Build the env-step kernel from ``tpu2048_torch/csrc`` with nvcc
   (sm_90a); print the seconds and ptxas's resource usage.
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
6. One JSON line describing the kernel, then the result line.
"""

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

    device = torch.device("cuda", 0)
    card = card_line()
    print(f"phase 1: card: {card}")
    print(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    sk.build_library()
    print(f"phase 2: step kernel built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in sk.library_path().with_suffix(".log").read_text().splitlines():
        print(f"phase 2: nvcc: {line.strip()}")

    max_err = phase_equal(sk, torch, device)
    launches = phase_main_path(sk, torch, device)
    main_row = phase_timing(sk, torch, device, EVAL_GAMES)
    phase_timing(sk, torch, device, 65536)
    torch.cuda.synchronize()

    print(f"card: {card}")
    print(json.dumps({"kernels": [{
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
