#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1) on any disagreement:

1. Environment: Python, torch and CUDA versions, and the card's name and
   power limit from ``nvidia-smi``.
2. Kernels: builds the moscore CUDA extension from ``src/`` and holds
   ``moscore_cuda`` and ``moscore_hoisted_cuda`` against their plain
   PyTorch versions on the card: P = 5 (paper fleet), 200 and 1024
   (synthetic fleets from a seeded ``torch.Generator``), G = 5, W = 4096,
   (delta, gamma) in {(20, 0.5), (10, 0.25)}, random integer queues, a
   fleet of duplicated pairs (ties), health-masked windows, and the
   largest P the wrappers accept (W = 64). Choices and final queues must
   be equal. Times each kernel per window at W = 4096 and at the paper
   deployment's shape (P = 5, W = 64), and the plain versions at
   P = 1024.
3. Paper deployment: ``ServingPlane.build(Scenario(n_users=15),
   window=64).run(2048)`` on the card through the hoisted kernel
   (``auto``) and through the unhoisted one (``cuda``); both must give the
   records of the same plane on the CPU.
4. Scale: a 1024-pair synthetic fleet, 10^5 streams, W = 4096,
   ``run(65536)`` with ``auto`` and with the plain ``hoisted`` scan on the
   card; the routed pairs and estimated groups must be equal.

Phases 3 and 4 are the main path: the kernels' launch counts are set to
zero before them and read after, and a kernel launched no time there
fails the run. The script prints one JSON line of kernel results, the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``. Without
a CUDA device, or without the repository beside it, it exits non-zero and
prints no result."""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; see PERF.md): HBM bytes/s and dense
# float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# dependent float32 issue latency assumed by the serial floor (cycles)
DEP_CYCLES = 4

W = 4096
PAIRS = (5, 200, 1024)
DELTA_GAMMA = ((20.0, 0.5), (10.0, 0.25))
TIMED_LAUNCHES = 20
PAPER_USERS, PAPER_WINDOW, PAPER_REQUESTS = 15, 64, 2048
SCALE_PAIRS, SCALE_USERS, SCALE_WINDOW, SCALE_REQUESTS = \
    1024, 100_000, 4096, 65_536
RECORDS = ("pair", "g_est", "g_true", "latency", "energy", "map")
KERNELS = ("moscore_cuda", "moscore_hoisted_cuda")


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> list[float]:
    """Per-call device times (ms) of ``reps`` calls, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def window_inputs(prof, gen, delta, *, w=W, health=None):
    """One w-request window on ``prof``'s device: both kernels' inputs."""
    from repro_torch.core.policies import mo_precompute

    dev = prof.device
    gs = torch.randint(0, prof.n_groups, (w,), generator=gen, device=dev,
                       dtype=torch.int32)
    q0 = torch.randint(0, 8, (prof.n_pairs,), generator=gen,
                       device=dev).float()
    feas, En = mo_precompute(prof.T, prof.E, prof.mAP, delta=delta,
                             health=health)
    t = lambda x: x.t().contiguous()
    return dict(Tt=t(prof.T), Et=t(prof.E), Mt=t(prof.mAP), Ent=t(En),
                Ft=t(feas), gs=gs, q0=q0)


def window_calls(x, delta, gamma):
    """``{kernel: (kernel call, plain call)}`` on one window."""
    from repro_torch.core.policies import mo_scan_hoisted
    from repro_torch.kernels.moscore import (moscore_cuda,
                                             moscore_hoisted_cuda,
                                             ref_moscore_route)

    return {
        "moscore_cuda": (
            lambda: moscore_cuda(x["Tt"], x["Et"], x["Mt"], x["gs"],
                                 x["q0"], delta=delta, gamma=gamma),
            lambda: ref_moscore_route(x["Tt"].t(), x["Et"].t(),
                                      x["Mt"].t(), x["gs"], x["q0"],
                                      delta=delta, gamma=gamma)),
        "moscore_hoisted_cuda": (
            lambda: moscore_hoisted_cuda(x["Tt"], x["Ent"], x["Ft"],
                                         x["gs"], x["q0"], gamma=gamma),
            lambda: mo_scan_hoisted(x["Tt"], x["Ent"], x["Ft"], x["gs"],
                                    x["q0"], gamma=gamma)),
    }


def bound(name, x):
    """Least time (ms) for one window on an H100 SXM: the largest of the
    bytes (each input read once, each output written once) over HBM
    bandwidth, the float32 operations this window's data needs over the
    float32 peak, and the serial floor of the W dependent steps (their
    reduction trees' dependent operations at DEP_CYCLES each). The floor
    is a bound by operations too, so it reports ``bound_by="operations"``;
    the three terms are kept beside it."""
    G, P = x["Tt"].shape
    W = x["gs"].shape[0]
    n_feas = x["Ft"].long().sum(dim=1)[x["gs"].long()]   # feasible per step
    tables = (4 + 4 + 1) * G * P if name == "moscore_hoisted_cuda" \
        else 3 * 4 * G * P
    n_bytes = tables + 4 * W + 4 * P + 4 * W + 4 * P
    if name == "moscore_hoisted_cuda":
        # per pair: argmin compare; per feasible pair: L (2), min/max (2),
        # Ln (2), J (3)
        ops = int((P + 9 * n_feas).sum())
    else:
        # per pair: max, bar compare, argmin compare; per feasible pair:
        # L (2), four min/max, Ln (2), En (2), J (3)
        ops = int((3 * P + 13 * n_feas).sum())
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    # each step's min/max tree and argmin tree over P, DEP_CYCLES apiece
    serial_ms = W * 2 * math.ceil(math.log2(P)) * DEP_CYCLES \
        / (sm_mhz * 1e6) * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms, serial_ms),
                bound_by="bytes" if bytes_ms >= max(ops_ms, serial_ms)
                else "operations",
                bytes_ms=bytes_ms, ops_ms=ops_ms, serial_floor_ms=serial_ms)


def kernel_phase(dev):
    from repro_torch.core.profiles import (ProfileTable, paper_fleet,
                                           synthetic_fleet)
    from repro_torch.kernels.moscore.moscore import MAX_PAIRS, extension

    t0 = time.perf_counter()
    extension()
    print(f"build: moscore extension {time.perf_counter() - t0:.1f} s",
          flush=True)
    res = {n: {"us_per_window": {}, "max_abs_err": 0.0} for n in KERNELS}

    def hold(case, calls):
        for n, (kernel, plain) in calls.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            for a, b, what in zip(got, want, ("choices", "q_final")):
                err = float((a.double() - b.double()).abs().max())
                res[n]["max_abs_err"] = max(res[n]["max_abs_err"], err)
                check(torch.equal(a, b), f"{n} {what} differ from the "
                      f"plain version: {case}")

    gen = torch.Generator(device=dev).manual_seed(0)
    fleets = {5: paper_fleet().to(dev)}
    for P in PAIRS[1:]:
        fleets[P] = synthetic_fleet(gen, P)
    for P, prof in fleets.items():
        for i, (delta, gamma) in enumerate(DELTA_GAMMA):
            x = window_inputs(prof, gen, delta)
            calls = window_calls(x, delta, gamma)
            hold(f"P={P} W={W} delta={delta} gamma={gamma}", calls)
            if i:
                continue
            # timed at the serving defaults, delta=20, gamma=0.5
            for n, (kernel, plain) in calls.items():
                ms = statistics.median(cuda_ms(kernel, TIMED_LAUNCHES))
                res[n]["us_per_window"][str(P)] = ms * 1e3
                if P == PAIRS[-1]:
                    res[n].update(bound(n, x), ms=ms, plain_ms=statistics
                                  .median(cuda_ms(plain, 3)))

    # the paper deployment's shape: the 5-pair fleet, 64-request windows
    x = window_inputs(fleets[5], gen, 20.0, w=PAPER_WINDOW)
    calls = window_calls(x, 20.0, 0.5)
    hold(f"P=5 W={PAPER_WINDOW}", calls)
    for n, (kernel, _) in calls.items():
        res[n]["paper_us_per_window"] = statistics.median(
            cuda_ms(kernel, TIMED_LAUNCHES)) * 1e3

    # the largest fleet the wrappers accept: q fills the shared memory
    big = synthetic_fleet(gen, MAX_PAIRS)
    x = window_inputs(big, gen, 20.0, w=PAPER_WINDOW)
    hold(f"P={MAX_PAIRS} W={PAPER_WINDOW}", window_calls(x, 20.0, 0.5))

    # ties: every pair of the 200-pair fleet twice, from empty queues
    twin = fleets[200]
    twin = ProfileTable(*(torch.cat([t, t]) for t in (twin.T, twin.E,
                                                      twin.mAP)))
    x = window_inputs(twin, gen, 20.0)
    x["q0"] = torch.zeros_like(x["q0"])
    hold("duplicated pairs (ties)", window_calls(x, 20.0, 0.5))

    # health-masked windows, random and degraded (no healthy pair clears
    # the last group's bar), through the hoisted kernel
    prof = fleets[1024]
    h = torch.rand((1024,), generator=gen, device=dev) < 0.6
    m = prof.mAP[:, -1]
    for case, mask in (("random health mask", h),
                       ("degraded health mask", h & (m < m.max() - 20.0))):
        x = window_inputs(prof, gen, 20.0, health=mask)
        calls = window_calls(x, 20.0, 0.5)
        hold(case, {"moscore_hoisted_cuda": calls["moscore_hoisted_cuda"]})
    print(json.dumps({"kernel_phase": "ok", "W": W, "pairs": list(PAIRS),
                      "us_per_window": {n: res[n]["us_per_window"]
                                        for n in KERNELS},
                      f"us_per_window_P5_W{PAPER_WINDOW}": {
                          n: res[n]["paper_us_per_window"]
                          for n in KERNELS}}), flush=True)
    return res


def plane_run(scenario, window, n, **kw):
    from repro_torch.serving import ServingPlane

    plane = ServingPlane.build(scenario, window=window, **kw)
    t0 = time.perf_counter()
    recs = plane.run(n)
    wall = time.perf_counter() - t0
    for k in RECORDS:
        check(recs[k].shape == (n,) and np.isfinite(recs[k]).all(),
              f"{k}: shape {recs[k].shape} or non-finite values")
    return plane, recs, wall


def paper_phase():
    from repro_torch.core import Scenario
    from repro_torch.serving import ServingPlane

    sc = Scenario(n_users=PAPER_USERS)
    plane, recs, _ = plane_run(sc, PAPER_WINDOW, PAPER_REQUESTS)
    check(plane.gateway.backend == "cuda_hoisted",
          f"auto resolved to {plane.gateway.backend}")
    _, recs_cuda, _ = plane_run(sc, PAPER_WINDOW, PAPER_REQUESTS,
                                backend="cuda")
    _, recs_cpu, _ = plane_run(sc, PAPER_WINDOW, PAPER_REQUESTS,
                               device="cpu")
    for k in RECORDS:
        check((recs[k] == recs_cuda[k]).all(),
              f"paper deployment: {k} differs between cuda_hoisted and cuda")
        check((recs[k] == recs_cpu[k]).all(),
              f"paper deployment: {k} differs from the CPU plane")
    summary = ServingPlane.summarize(recs)
    print(json.dumps({"paper_deployment": summary,
                      "router_us_per_window_median": statistics.median(
                          recs["router_window_s"]) * 1e6,
                      "requests": PAPER_REQUESTS, "window": PAPER_WINDOW}),
          flush=True)


def scale_phase(dev):
    from repro_torch.core import Scenario, synthetic_fleet

    gen = torch.Generator(device=dev).manual_seed(1)
    sc = Scenario(profile=synthetic_fleet(gen, SCALE_PAIRS),
                  n_users=SCALE_USERS)
    out = {}
    for backend in ("auto", "hoisted"):
        plane, recs, wall = plane_run(sc, SCALE_WINDOW, SCALE_REQUESTS,
                                      backend=backend)
        out[plane.gateway.backend] = (recs, wall)
    check(list(out) == ["cuda_hoisted", "hoisted"],
          f"scale: backends resolved to {list(out)}")
    for k in ("pair", "g_est"):
        check((out["cuda_hoisted"][0][k] == out["hoisted"][0][k]).all(),
              f"scale: {k} differs between cuda_hoisted and hoisted")
    row = {}
    for name, (recs, wall) in out.items():
        row[name] = {
            "router_us_per_window_median": statistics.median(
                recs["router_window_s"]) * 1e6,
            "routed_rps": SCALE_REQUESTS / recs["router_s"],
            "plane_rps": SCALE_REQUESTS / wall}
    print(json.dumps({"scale": row, "pairs": SCALE_PAIRS,
                      "streams": SCALE_USERS, "window": SCALE_WINDOW,
                      "requests": SCALE_REQUESTS}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.moscore import moscore_cuda, moscore_hoisted_cuda

    dev = torch.device("cuda")
    smi = nvidia_smi("name,power.limit")
    print(json.dumps({"python": sys.version.split()[0],
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    res = kernel_phase(dev)

    wrappers = {"moscore_cuda": moscore_cuda,
                "moscore_hoisted_cuda": moscore_hoisted_cuda}
    for w in wrappers.values():
        w.launches = 0
    paper_phase()
    scale_phase(dev)
    launches = {n: w.launches for n, w in wrappers.items()}
    for n, k in launches.items():
        check(k > 0, f"{n} was not launched on the main path")

    replaces = {"moscore_cuda": "src/repro/kernels/moscore/moscore.py:28",
                "moscore_hoisted_cuda":
                    "src/repro/kernels/moscore/moscore.py:60"}
    kernels = []
    for n in wrappers:
        r = res[n]
        kernels.append({
            "name": n, "route": "cuda",
            "source": "src/repro_torch/kernels/moscore/csrc/moscore.cu",
            "replaces": replaces[n], "launches": launches[n],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "bytes_ms": r["bytes_ms"], "ops_ms": r["ops_ms"],
            "serial_floor_ms": r["serial_floor_ms"],
            "shape": {"P": PAIRS[-1], "G": 5, "W": W},
            "us_per_window": r["us_per_window"],
            "paper_us_per_window": r["paper_us_per_window"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
