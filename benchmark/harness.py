"""One run of one cell: set-up, the measured or the traced window, the
look for JAX, and the comparison with the plain reference once the
program's state is freed. :func:`run_cell` returns the result line; it
runs on the CPU too, for the tests, and only ``run.py`` prints it."""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import torch

from benchmark import core
from benchmark.counts import peaks
from benchmark.trace import Tracer


PROBE_LAUNCHES = 10_000
PROBE_LOOP = 1_000_000


class ForbiddenModules(RuntimeError):
    pass


def device_line(device: torch.device, chips: int, peak: int) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": int(peak)}


def card_counts(device: torch.device) -> Dict:
    """The card's facts the readers need: its SMs and maximum clock."""
    if device.type != "cuda":
        return {}
    return {"sm_count": torch.cuda.get_device_properties(
        device).multi_processor_count, "sm_clock_hz": peaks.max_sm_clock_hz()}


def host_probe(device: torch.device) -> Dict:
    """The host's speed just now: microseconds a launch of a one-element
    add on ``device`` (no synchronise between launches), and milliseconds
    of a fixed loop of Python. The cells' paths wait on the host, so their
    rates follow these from run to run and from machine to machine."""
    x = torch.zeros(1, device=device)
    core.sync(device)
    t0 = time.perf_counter()
    for _ in range(PROBE_LAUNCHES):
        x.add_(1)
    core.sync(device)
    t1 = time.perf_counter()
    sum(i * i for i in range(PROBE_LOOP))
    t2 = time.perf_counter()
    return {"launch_us": 1e6 * (t1 - t0) / PROBE_LAUNCHES,
            "python_ms": 1e3 * (t2 - t1)}


def run_cell(cell: core.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t0: Optional[float] = None,
             control: bool = False) -> Dict:
    """Run ``cell`` once; return the result line (a dict, ``checks``
    last). ``t0`` is the host clock at the process's start, from which
    set-up counts. With ``control`` the line also holds the control's
    numbers and those of the faults the driver plants in the reference."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    driver = core.load_module(cell.driver_path).Driver(cell, seed, device)
    driver.setup()
    core.sync(device)
    # What set-up and the recordings made moves out of the collector's
    # reach, so that no full collection in the window walks it.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    probes = [host_probe(device)]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    summary = None
    if trace:
        summary = driver.run_traced(Tracer(driver.spans, device))
        summary.counts.update(card_counts(device))
        work = summary.counts["work"]
    else:
        values, work = driver.run(seconds)
    core.sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    probes.append(host_probe(device))
    gc.unfreeze()
    bad = core.forbidden_modules()
    if bad:
        raise ForbiddenModules(bad)
    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = driver.check()
    metrics = {}
    if trace:
        for m in cell.metrics("per_layer"):
            value = cell.reader(m["name"]).read(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values["setup_s"] = setup_s
        for m in cell.metrics("end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": core.passes(checks), "attempted": int(work),
            "failed": sum(1 for _, v, lim in checks if not v <= lim),
            "metrics": metrics,
            "device": device_line(device, cell.chips, peak)}
    if trace:
        line["device"].update(busy_s=summary.busy_s,
                              window_s=summary.window_s)
        if summary.untraced_s:
            line["profiler_cost"] = summary.window_s / summary.untraced_s
        line["breakdown"] = summary.breakdown()
    if hasattr(driver, "window"):
        line["window"] = driver.window
    line["host"] = {k: [p[k] for p in probes] for k in probes[0]}
    if control:
        line["control"] = core.check_line(
            driver.check(quant=cell.config["control"]))
        for fault in getattr(driver, "faults", ()):
            line[f"fault.{fault}"] = core.check_line(driver.check(quant=fault))
    line["checks"] = core.check_line(checks)
    return line


def check_lines(line: Dict) -> List[str]:
    """The numbers compared, one a line, for the end of standard error."""
    out = []
    keys = [k for k in line if k in ("control", "checks")
            or k.startswith("fault.")]
    for key in keys:
        for name, c in line[key].items():
            out.append(f"{key} {name} {c['value']!r} limit {c['limit']!r}")
    return out
