"""Where the DQN network's device time goes on a CUDA card, by kernel and by
the operator and operands that launched it.

At full width in bf16 (``DQNConfig()``, seed-0 weights) it runs a greedy
forward (eval mode, ``torch.inference_mode``, as ``eval/evaluate.py``'s
greedy policy calls it, on boards that are a view of cell-major lanes, as
the env hands them over) at batch 512, 128 and 1, and one learner update at
batch 64 (``bench.learner_update``): replayed from its CUDA graph, and
eager (an identity ``grad_reduce`` keeps it so), where each kernel can be
traced to the operator that launched it. For each it prints one JSON row:
the device time a call (CUDA events over ``--calls`` calls), the host's
time to enqueue a call, the kernels a call by name (count, microseconds),
cuDNN's layout conversions a call (kernels named ``nchwToNhwc`` or
``nhwcToNchw``), and, for the eager calls, each kernel's innermost operator
with the shapes and strides of its first two inputs.

``--root`` names the checkout whose ``tpu2048_torch`` is imported, so that
two checkouts are held against each other in one run on one card:

    python scripts/profile_dqn_layout.py --root PARENT_CHECKOUT
    python scripts/profile_dqn_layout.py --root . --out profile.jsonl
"""

import argparse
import collections
import json
import os
import sys
import tempfile
import time

CONVERSIONS = ("nchwToNhwc", "nhwcToNchw")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _innermost_ops(trace):
    """Each device event of a chrome trace with the innermost CPU operator
    that was open on the launching thread when its launch was issued."""
    events = trace["traceEvents"]
    ops = collections.defaultdict(list)
    launches = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") == "cpu_op":
            ops[e["tid"]].append(e)
        elif e.get("cat") == "cuda_runtime":
            launches[e["args"].get("correlation")] = e
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        launch = launches.get(e["args"].get("correlation"))
        op = None
        if launch is not None:
            t = launch["ts"]
            open_ops = [o for o in ops[launch["tid"]]
                        if o["ts"] <= t <= o["ts"] + o["dur"]]
            if open_ops:
                op = max(open_ops, key=lambda o: o["ts"])
        yield e, launch, op


def profiled(torch, fn, calls, with_ops):
    """Kernels of ``calls`` calls of ``fn`` under the profiler, a call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=with_ops) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    kernels = collections.defaultdict(lambda: [0, 0.0])
    operands = collections.defaultdict(lambda: [0, 0.0])
    for e, launch, op in _innermost_ops(trace):
        name = e["name"][:90]
        kernels[name][0] += 1
        kernels[name][1] += e["dur"]
        if with_ops:
            where = "graph replay" if op is None else "%s %s %s" % (
                op["name"], op["args"].get("Input Dims", [])[:2],
                op["args"].get("Input Strides", [])[:2])
            operands[(name, where)][0] += 1
            operands[(name, where)][1] += e["dur"]

    def rows(table):
        return sorted(([*(k if isinstance(k, tuple) else (k,)),
                        n / calls, us / calls]
                       for k, (n, us) in table.items()),
                      key=lambda r: -r[-1])

    out = {"kernels": rows(kernels),
           "kernels_per_call": sum(n for n, _ in kernels.values()) / calls,
           "busy_us_per_call": sum(us for _, us in kernels.values()) / calls,
           "conversions_per_call": sum(
               n for k, (n, _) in kernels.items()
               if any(c in k for c in CONVERSIONS)) / calls}
    if with_ops:
        out["operands"] = rows(operands)
    return out


def timed(torch, fn, calls):
    """Device ms a call by CUDA events, and host ms to enqueue a call."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls, 1e3 * host / calls


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=".")
    parser.add_argument("--calls", type=int, default=50)
    parser.add_argument("--out", default=None,
                        help="also append the rows to this JSONL file")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from tpu2048_torch import bench
    from tpu2048_torch.agents import dqn as dqnlib
    from tpu2048_torch.models import dqn as dqn_model
    from tpu2048_torch.ops.step_kernel import from_cell_major

    assert torch.cuda.is_available(), "needs a CUDA card"
    device = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    source = os.path.relpath(dqn_model.__file__)
    rows = []

    def report(row):
        row.update(root=args.root, module=source, card=card)
        rows.append(row)
        print(json.dumps(row), flush=True)

    acfg = dqnlib.DQNConfig(memory_size=4096)
    model = dqn_model.create_model(acfg, device)
    dqn_model.init_params(model, torch.Generator(device).manual_seed(0))
    model.eval()
    gen = torch.Generator(device).manual_seed(1)
    for batch in (512, 128, 1):
        # As the env hands them over: a (B, 4, 4) view of cell-major lanes.
        boards = from_cell_major(torch.randint(
            0, 12, (16, batch), dtype=torch.int8, generator=gen,
            device=device))

        def forward():
            with torch.inference_mode():
                return model(boards)

        for _ in range(5):
            forward()
        device_ms, host_ms = timed(torch, forward, args.calls)
        report(dict(path="greedy_forward", batch=batch, device_ms=device_ms,
                    host_ms=host_ms, **profiled(torch, forward, 5, True)))

    state, update = bench.learner_update(acfg, 64, device)
    for _ in range(5):
        update()
    assert state.learner.graph_steps > 0, "the update did not replay"
    device_ms, host_ms = timed(torch, update, args.calls)
    report(dict(path="learner_replay", batch=64, device_ms=device_ms,
                host_ms=host_ms, **profiled(torch, update, 5, False)))
    train_step = dqnlib.train_step
    dqnlib.train_step = lambda cfg, st, b: train_step(
        cfg, st, b, lambda params, loss: loss)
    try:
        for _ in range(2):
            update()
        device_ms, host_ms = timed(torch, update, args.calls // 5)
        report(dict(path="learner_eager", batch=64, device_ms=device_ms,
                    host_ms=host_ms, **profiled(torch, update, 2, True)))
    finally:
        dqnlib.train_step = train_step
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
