#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1) on any disagreement:

1. Environment: Python, torch and CUDA versions, and the card's name and
   power limit from ``nvidia-smi``.
2. Kernels: builds the moscore CUDA extension from ``src/`` (and, beside
   it, compiles ``moscore.cu`` alone with ``-Xptxas -v`` for its
   registers, spills and shared memory) and holds ``moscore_cuda`` and
   ``moscore_hoisted_cuda`` against their plain PyTorch versions on the
   card: P = 5 (paper fleet), 200 and 1024 (synthetic fleets from a
   seeded ``torch.Generator``), G = 5, W = 4096, (delta, gamma) in
   {(20, 0.5), (10, 0.25)}, random integer queues, a fleet of duplicated
   pairs (ties), health-masked windows, the P where the hoisted kernel's
   warp layout changes, and the largest P the wrappers accept (W = 64).
   Choices and final queues must be equal. Times each kernel per window
   at W = 4096 and at the paper deployment's shape (P = 5, W = 64) by
   CUDA-graph replay (``ms``; a per-call event pair, ``event_ms``, also
   holds the host's launch), the hoisted kernel in every warp layout it
   is built for at P = 5, 200, 384, 640, 1024, 1536 and 1920, and the
   plain versions at P = 1024 (event pair: they are thousands of launches
   each).
3. Paper deployment: ``ServingPlane.build(Scenario(n_users=15),
   window=64).run(2048)`` on the card through the hoisted kernel
   (``auto``) and through the unhoisted one (``cuda``); both must give the
   records of the same plane on the CPU.
4. Scale: a 1024-pair synthetic fleet, 10^5 streams, W = 4096,
   ``run(65536)`` with ``auto`` and with the plain ``hoisted`` scan on the
   card; the routed pairs and estimated groups must be equal.

5. Attention kernels: builds the attention library (``nvcc``, started
   in the background before phase 2, one process per source; ptxas's
   registers, spills and shared memory for every kernel are printed) and
   holds each kernel against its plain PyTorch version: the bf16
   tensor-core flash kernel and the split-tf32 one (a float32 q against
   float32 or bf16 K/V) at the LM prefill shape (B = 4, H = 32, Sq = 2048,
   Sk = 2560, D = 80, causal), GQA (G = 4, D = 128), ragged non-causal,
   D = 72, 8, 40 with Sq > Sk, and prompt chunks at a query offset into a
   longer cache (D = 8, 72, 80, 128, GQA); the decode partials at the LM
   decode shape (kv_len 2049..2080, one split), GQA over a partial cache
   and wholly masked splits; the fused decode at the card's split count
   and 8, GQA, kv_len = 0 and kv_len inside the first split, with kv_len a
   tensor and one int; bfloat16 at rtol 2e-2 and atol 5e-3, float32 at 1e-5 (the
   least atol each kernel needed is printed). Times each at the LM
   shapes beside its plain version and one PyTorch call for the same
   function (``scaled_dot_product_attention``; timed only): device time
   per call from CUDA-graph replay (``ms``), and the per-call event pair
   (``event_ms``, which also holds the host's launch). The fused decode
   is also timed at 1-8 splits, at B = 4 and at B = 1.
6. LM serving: stablelm-3b at full width and depth in bfloat16, weights
   drawn from ``torch.Generator(device="cuda").manual_seed(0)``, B = 4
   prompts of 2048 tokens into a 2560-slot cache, ``prefill`` then 32
   greedy ``decode_step``s through the kernels: 32 tensor-core flash
   launches and 32 x 32 fused decode launches, and no other attention
   kernel. The same prompts through ``attn_impl="ref"`` on the card, fed
   the kernel path's tokens: the prefill logits and the first decode
   step's must agree within 3e-2 of the largest logit. The same prompts
   prefilled in two chunks of 1024 through ``forward(..., cache_pos=)``
   (2 x 32 tensor-core flash launches, the second at a query offset of
   1024): the last chunk's last-token logits within 3e-2 of the plain
   path's prefill. The same check in float32 at full width with the depth
   cut to 2 layers (a float32 q against the bf16 cache: 2 split-tf32 flash
   and 2 fused decode launches), within 2e-5. Then one of the prompts
   alone through the bf16 path:
   B·KV = 32, so the card's split count is above 1 and the fused decode
   merges its splits in a cluster (32 flash and 32 x 32 fused decode
   launches; its logits within 3e-2 of the plain path's).
   Greedy-token agreement is reported, not gated. Last, a
   prefill and 8 decode steps through the kernels under
   ``torch.profiler``: kernel launches, device busy time and share, and
   the attention kernels' share of it.

Phases 3 and 4 are the moscore main path and phase 6's bf16, two-chunk,
one-prompt and fp32 runs the LM main path: the kernels' launch counts are
set to zero before each and read after, and a kernel of the path
launched no time there, or another number of times than the layers ask,
fails the run. The script
prints one JSON line of kernel results, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside it, it exits non-zero and prints no result."""

from __future__ import annotations

import dataclasses
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; see PERF.md): HBM bytes/s, dense
# float32 outside the tensor cores, dense bf16 and tf32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 494.7e12
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
# the LM serving path: stablelm-3b, B prompts of PROMPT tokens, a MAX_SEQ
# cache, STEPS greedy decode steps
LM_ARCH, LM_BATCH, LM_PROMPT, LM_MAX_SEQ, LM_STEPS = \
    "stablelm-3b", 4, 2048, 2560, 32
LM_KV_LEN = (2049, 2059, 2069, 2080)      # decode check: kv_len per row
# logits through the kernels against the plain path, relative to the
# largest logit: about 2x (bf16) and 6x (fp32, 2 layers) the largest
# errors an H100 has shown (PERF.md)
LM_BF16_BOUND, LM_F32_BOUND, LM_F32_LAYERS = 3e-2, 2e-5, 2
LM_TRACED_STEPS = 8
# one row per attention CUDA kernel: the bf16 tensor-core flash kernel, the
# split-tf32 one (a float32 q), the decode partials and the fused decode
ATT_KERNELS = ("flash_fwd_mma", "flash_fwd_3xtf32", "decode_splits",
               "decode_fused")
# the P where the hoisted moscore kernel is timed in every layout (pairs
# per thread; warps follow): PAIRS, and P at the end or inside each range
# of the default layout's 1, 2 and 4 pairs per thread
HOISTED_LAYOUT_PAIRS = (5, 200, 384, 640, 1024, 1536, 1920)
# the P where the hoisted kernel's warp layout changes
LAYOUT_EDGES = (1, 31, 32, 33, 255, 256, 257, 384, 385, 768, 769, 2048,
                2049)
# each row's wrapper, source and TPU kernel (file:line of its pallas body)
ROWS = {
    "moscore_cuda": ("moscore_cuda", "moscore/csrc/moscore.cu",
                     "src/repro/kernels/moscore/moscore.py:28"),
    "moscore_hoisted_cuda": ("moscore_hoisted_cuda",
                             "moscore/csrc/moscore.cu",
                             "src/repro/kernels/moscore/moscore.py:60"),
    "flash_fwd_mma": ("flash_attention_cuda",
                      "flash_attention/csrc/flash_attention_mma.cu",
                      "src/repro/kernels/flash_attention/"
                      "flash_attention.py:25"),
    "flash_fwd_3xtf32": ("flash_attention_cuda",
                         "flash_attention/csrc/flash_attention_3xtf32.cu",
                         "src/repro/kernels/flash_attention/"
                         "flash_attention.py:25"),
    "decode_splits": ("decode_attention_cuda",
                      "decode_attention/csrc/decode_attention.cu",
                      "src/repro/kernels/decode_attention/"
                      "decode_attention.py:28"),
    "decode_fused": ("decode_attention_fused",
                     "decode_attention/csrc/decode_attention.cu",
                     "src/repro/kernels/decode_attention/"
                     "decode_attention.py:28"),
}


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


def _wrappers():
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_fused)
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.moscore import moscore_cuda, moscore_hoisted_cuda

    return (moscore_cuda, moscore_hoisted_cuda, flash_attention_cuda,
            decode_attention_cuda, decode_attention_fused)


def launch_counts() -> dict:
    """Every kernel row's launch count, as its wrapper keeps it."""
    mo, moh, fa, dec, fused = _wrappers()
    return {"moscore_cuda": mo.launches, "moscore_hoisted_cuda": moh.launches,
            "flash_fwd_mma": fa.kernel_launches["flash_fwd_mma"],
            "flash_fwd_3xtf32": fa.kernel_launches["flash_fwd_3xtf32"],
            "decode_splits": dec.launches, "decode_fused": fused.launches}


def zero_counts() -> None:
    """Set every wrapper's launch counts to 0."""
    wrappers = _wrappers()
    for w in wrappers:
        w.launches = 0
    fa = wrappers[2]
    for k in fa.kernel_launches:
        fa.kernel_launches[k] = 0


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


def hoisted_layouts(x, gamma) -> dict:
    """µs per window of the hoisted kernel in every layout it is built for
    (``"KxW"``: K pairs per thread, W warps), each first held against the
    plain version. Direct extension calls: they count no launch."""
    from repro_torch.core.policies import mo_scan_hoisted
    from repro_torch.kernels.moscore.moscore import (
        HOISTED_PAIRS_PER_THREAD, extension, hoisted_layout)

    P = x["Tt"].shape[1]
    want = mo_scan_hoisted(x["Tt"], x["Ent"], x["Ft"], x["gs"], x["q0"],
                           gamma=gamma)
    out = {}
    for k in HOISTED_PAIRS_PER_THREAD:
        try:
            k, warps = hoisted_layout(P, k)
        except ValueError:          # more warps than a CTA takes
            continue
        ch, qf = torch.empty_like(x["gs"]), torch.empty_like(x["q0"])
        call = lambda: extension().moscore_hoisted( 
            x["Tt"], x["Ent"], x["Ft"], x["gs"], x["q0"], ch, qf, gamma,
            1.0 - gamma, k, warps)
        call()
        torch.cuda.synchronize()
        check(torch.equal(ch, want[0]) and torch.equal(qf, want[1]),
              f"moscore_hoisted_kernel at P={P} in {k} pairs per thread x "
              f"{warps} warps differs from the plain version")
        out[f"{k}x{warps}"] = graph_ms(call, TIMED_LAUNCHES) * 1e3
    return out


def moscore_ptxas() -> list[dict]:
    """Registers, spills and shared memory of the moscore kernels:
    ``moscore.cu`` compiled alone with the extension's flags and
    ``-Xptxas -v`` (the extension's own build keeps ptxas quiet)."""
    from repro_torch.kernels.moscore.moscore import _CSRC, BUILD_DIR, CUDA_FLAGS
    from repro_torch.kernels.nvcc_lib import _nvcc

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj = BUILD_DIR / "moscore_ptxas.o"
    out = subprocess.run([_nvcc(), *CUDA_FLAGS, "-Xptxas", "-v", "-c",
                          str(_CSRC / "moscore.cu"), "-o", str(obj)],
                         capture_output=True, text=True, timeout=900)
    obj.unlink(missing_ok=True)
    check(out.returncode == 0, f"moscore.cu does not compile alone:\n"
                               f"{out.stderr[-4000:]}")
    return ptxas_report(out.stdout + out.stderr)


def kernel_phase(dev):
    from repro_torch.core.profiles import (ProfileTable, paper_fleet,
                                           synthetic_fleet)
    from repro_torch.kernels.moscore.moscore import MAX_PAIRS, extension

    t0 = time.perf_counter()
    extension()
    print(f"build: moscore extension {time.perf_counter() - t0:.1f} s",
          flush=True)
    res = {n: {"us_per_window": {}, "event_us_per_window": {},
               "max_abs_err": 0.0} for n in KERNELS}
    layouts = {}

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
            # timed at the serving defaults, delta=20, gamma=0.5: device
            # time by graph replay, and the per-call event pair
            for n, (kernel, plain) in calls.items():
                ms = graph_ms(kernel, TIMED_LAUNCHES)
                ev = statistics.median(cuda_ms(kernel, TIMED_LAUNCHES))
                res[n]["us_per_window"][str(P)] = ms * 1e3
                res[n]["event_us_per_window"][str(P)] = ev * 1e3
                if P == PAIRS[-1]:
                    res[n].update(bound(n, x), ms=ms, event_ms=ev,
                                  plain_ms=statistics.median(
                                      cuda_ms(plain, 3)))
            if P in HOISTED_LAYOUT_PAIRS:
                layouts[str(P)] = hoisted_layouts(x, gamma)
    for P in HOISTED_LAYOUT_PAIRS:
        if P not in fleets:
            x = window_inputs(synthetic_fleet(gen, P), gen, 20.0)
            layouts[str(P)] = hoisted_layouts(x, 0.5)

    # the paper deployment's shape: the 5-pair fleet, 64-request windows
    x = window_inputs(fleets[5], gen, 20.0, w=PAPER_WINDOW)
    calls = window_calls(x, 20.0, 0.5)
    hold(f"P=5 W={PAPER_WINDOW}", calls)
    for n, (kernel, _) in calls.items():
        res[n]["paper_us_per_window"] = graph_ms(kernel,
                                                 TIMED_LAUNCHES) * 1e3
        res[n]["paper_event_us_per_window"] = statistics.median(
            cuda_ms(kernel, TIMED_LAUNCHES)) * 1e3

    # the P where the hoisted kernel's warp layout changes, and the
    # largest fleet the wrappers accept (q fills the unhoisted kernel's
    # shared memory)
    for P in LAYOUT_EDGES + (MAX_PAIRS,):
        x = window_inputs(synthetic_fleet(gen, P), gen, 20.0,
                          w=4 * PAPER_WINDOW)
        hold(f"P={P} W={4 * PAPER_WINDOW}", window_calls(x, 20.0, 0.5))

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
    res["moscore_hoisted_cuda"]["layouts_us_per_window"] = layouts
    print(json.dumps({"kernel_phase": "ok", "W": W, "pairs": list(PAIRS),
                      "us_per_window": {n: res[n]["us_per_window"]
                                        for n in KERNELS},
                      "event_us_per_window": {
                          n: res[n]["event_us_per_window"] for n in KERNELS},
                      f"us_per_window_P5_W{PAPER_WINDOW}": {
                          n: res[n]["paper_us_per_window"]
                          for n in KERNELS},
                      "hoisted_layouts_us_per_window": layouts}),
          flush=True)
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


# ----------------------------------------------------- attention kernels --

def _close(got, want, rtol, atol) -> tuple[bool, float, float]:
    """``torch.testing.assert_close``'s test, the largest |got - want|, and
    the least atol that would pass at this rtol (the bound's headroom)."""
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    ok = bool((diff <= atol + rtol * want.abs()).all())
    return (ok and bool(torch.isfinite(got).all()), float(diff.max()),
            float((diff - rtol * want.abs()).max()))


def _tol(dtype) -> tuple[float, float]:
    """(rtol, atol) by the output's dtype: both versions compute in float32
    from the same inputs, so float32 differs in the order of sums, bfloat16
    also in its rounding: of the output, and of P before P·V in the
    tensor-core flash kernel, which at a row of few keys where the output
    cancels to near 0 leaves a few 1e-3 that rtol does not cover."""
    return (1e-5, 1e-5) if dtype == torch.float32 else (2e-2, 5e-3)


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def flash_case(gen, b, sq, sk, h, kv, d, qdt, kvdt=None):
    q = _randn(gen, (b, sq, h, d), qdt)
    k = _randn(gen, (b, sk, kv, d), kvdt or qdt)
    v = _randn(gen, (b, sk, kv, d), kvdt or qdt)
    return q, k, v


def graph_ms(fn, reps: int) -> float:
    """Device time (ms) of one call: ``reps`` calls captured in a CUDA
    graph and replayed between two events, three times, median. The host's
    launch overhead, which a per-call event pair also times for a kernel
    of tens of microseconds, is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up off the capture, as
        fn()                            # torch.cuda.graph asks
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    torch.cuda.synchronize()
    return statistics.median(times)


def flash_bound(b, sq, sk, h, kv, d, causal, q_elt, kv_elt, ops_per_s,
                passes=1):
    """Least time (ms): Q and O once, the K/V rows the mask reaches once,
    over HBM bandwidth; 4 flops per (query, key, d) the mask keeps, times
    the products each takes on the kernel's unit (``passes``: 1 for bf16,
    2 or 3 for split tf32), over that unit's peak."""
    n_keys = min(sk, sq) if causal else sk
    n_bytes = q_elt * 2 * b * sq * h * d + kv_elt * 2 * b * n_keys * kv * d
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    ops = 4 * b * h * d * pairs
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = passes * ops / ops_per_s * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_ms=bytes_ms, ops_ms=ops_ms, n_bytes=n_bytes, ops=ops)


def decode_bound(q, k, lens, *, fused: bool, n_splits: int = 1):
    """Least time (ms): q, kv_len, the valid K/V prefix, and what the
    kernel writes (fused: the (B, H, D) output in q's dtype; partials: the
    fp32 partials and LSE) once over HBM bandwidth; 4 flops per valid
    (row, position, d) over the bf16 tensor-core peak."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    valid = int(lens.clamp(0, s).sum())
    out = q.numel() * q.element_size() if fused \
        else 4 * b * kv * n_splits * (h // kv) * (d + 1)
    n_bytes = q.numel() * q.element_size() + 4 * b \
        + 2 * valid * kv * d * k.element_size() + out
    ops = 4 * valid * h * d
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_OPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_ms=bytes_ms, ops_ms=ops_ms, n_bytes=n_bytes, ops=ops)


def ptxas_report(log: str) -> list[dict]:
    """Registers, spills and static shared memory of every kernel in the
    attention library's build log (``nvcc -Xptxas -v``)."""
    rows, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            rows.append({"kernel": name})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            rows[-1].update(spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            rows[-1]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", ln)
            rows[-1]["static_smem_bytes"] = int(s.group(1)) if s else 0
    names = [r["kernel"] for r in rows]
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        for r, n in zip(rows, out.stdout.splitlines()):
            r["kernel"] = n.replace("(anonymous namespace)::", "")
    return rows


def attention_phase(build_s):
    from repro_torch.kernels.decode_attention import (_pick_splits,
                                                      card_splits,
                                                      decode_attention,
                                                      decode_attention_cuda,
                                                      decode_attention_fused,
                                                      ref_decode_fused,
                                                      ref_decode_splits)
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     kernel_for,
                                                     ref_attention)
    from repro_torch.kernels.nvcc_lib import attention_library, library_path

    attention_library()
    log = library_path().with_suffix(".log").read_text()
    print(json.dumps({"build": {"attention_library_s": build_s},
                      "ptxas": ptxas_report(log)}), flush=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(2)
    res = {n: {"max_abs_err": 0.0, "atol_needed": {}, "cases": 0}
           for n in ATT_KERNELS}

    def hold(name, case, got, want):
        for a, w in zip(got, want):
            ok, err, need = _close(a, w, *_tol(a.dtype))
            r, dt = res[name], str(a.dtype)[6:]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["atol_needed"][dt] = max(r["atol_needed"].get(dt, 0.0), need)
            check(ok, f"{name} differs from its plain version: {case} "
                      f"(max abs err {err})")
        res[name]["cases"] += 1

    B, H, D = LM_BATCH, 32, 80
    bf, f32 = torch.bfloat16, torch.float32
    pairs = ((bf, bf), (f32, f32), (f32, bf))
    # flash: the prefill shape, GQA, ragged non-causal, head dims that are
    # no multiple of 16 with Sq > Sk and ragged edges, and causal prompt
    # chunks at a query offset into a longer cache (the second chunk of the
    # LM's two-chunk prefill among them); the bf16 tensor-core kernel takes
    # the bf16 pair, the split-tf32 kernel a float32 q
    flash_cases = [((B, LM_PROMPT, LM_MAX_SEQ, H, H, D), True, 0),
                   ((2, 512, 512, 32, 8, 128), True, 0),
                   ((1, 300, 333, 4, 4, 80), False, 0),
                   ((1, 300, 200, 4, 2, 72), True, 0),
                   ((1, 200, 150, 2, 2, 8), True, 0),
                   ((1, 333, 77, 2, 1, 40), False, 0),
                   ((B, LM_PROMPT // 2, LM_MAX_SEQ, H, H, D), True,
                    LM_PROMPT // 2),
                   ((2, 100, 300, 8, 2, 80), True, 150),
                   ((1, 64, 200, 4, 4, 128), True, 136),
                   ((1, 37, 90, 4, 1, 8), True, 5),
                   ((2, 130, 400, 4, 4, 72), True, 16)]
    for qdt, kvdt in pairs:
        for shape, causal, off in flash_cases:
            q, k, v = flash_case(gen, *shape, qdt, kvdt)
            sc = shape[-1] ** -0.5
            got = flash_attention_cuda(q, k, v, causal=causal, scale=sc,
                                       q_offset=off)
            want = ref_attention(q, k, v, causal=causal, scale=sc,
                                 q_offset=off)
            torch.cuda.synchronize()
            hold(kernel_for(qdt), f"{shape} causal={causal} q_offset={off} "
                                  f"{qdt}/{kvdt}", [got], [want])
            del q, k, v, got, want
    # decode partials: the serving cache at the decode steps' kv_len, GQA
    # over a partial cache, and kv_len = 17 of 2048 in four splits
    ns_tpu = _pick_splits(LM_MAX_SEQ, D)
    dec_cases = [((B, LM_MAX_SEQ, H, H, D), LM_KV_LEN, ns_tpu),
                 ((2, 1024, 32, 8, 128), (700, 1024), 4),
                 ((1, 2048, 2, 1, 64), (17,), 4)]
    # decode fused: the same, plus kv_len = 0 and kv_len inside the first
    # of several splits, at the card's split count and others
    ns_card = card_splits(B * H, LM_MAX_SEQ,
                          torch.cuda.get_device_properties(0)
                          .multi_processor_count)
    fused_cases = [((B, LM_MAX_SEQ, H, H, D), LM_KV_LEN, ns_card),
                   ((B, LM_MAX_SEQ, H, H, D), LM_KV_LEN, 8),
                   ((2, 1024, 32, 8, 128), (700, 1024), 3),
                   ((3, 256, 8, 4, 16), (0, 256, 129), 2),
                   ((2, 2048, 4, 4, 64), (17, 0), 8)]
    for qdt, kvdt in pairs:
        for name, cases in (("decode_splits", dec_cases),
                            ("decode_fused", fused_cases)):
            for (b, s, h, kv, d), lens, ns in cases:
                q = _randn(gen, (b, h, d), qdt)
                k = _randn(gen, (b, s, kv, d), kvdt)
                v = _randn(gen, (b, s, kv, d), kvdt)
                lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
                case = f"{(b, s, h, kv, d)} kv_len={lens} n_splits={ns} " \
                       f"{qdt}/{kvdt}"
                if name == "decode_splits":
                    hold(name, case,
                         decode_attention_cuda(q, k, v, lt, n_splits=ns),
                         ref_decode_splits(q, k, v, lt, n_splits=ns))
                    continue
                hold(name, case,
                     [decode_attention_fused(q, k, v, lt, n_splits=ns)],
                     [ref_decode_fused(q, k, v, lt)])
                # one int for every row, as the LM path passes it
                hold(name, f"{case}, kv_len = {lens[0]} for every row",
                     [decode_attention_fused(q, k, v, lens[0],
                                             n_splits=ns)],
                     [ref_decode_fused(q, k, v, lens[0])])

    # times at the LM path's shapes: kernel, plain version, and the one
    # PyTorch call for the same function (timed here only). ``ms`` is the
    # device time from CUDA-graph replay; ``event_ms`` a per-call event
    # pair, which also holds the host's launch
    def timed(name, kernel, plain, library, plain_reps=TIMED_LAUNCHES):
        r = res[name]
        r["ms"] = graph_ms(kernel, TIMED_LAUNCHES)
        r["event_ms"] = statistics.median(cuda_ms(kernel, TIMED_LAUNCHES))
        r["plain_ms"] = graph_ms(plain, plain_reps)
        r["library_ms"] = graph_ms(library, TIMED_LAUNCHES)

    sc = D ** -0.5
    fb = lambda q_elt, peak, passes=1: flash_bound( 
        B, LM_PROMPT, LM_MAX_SEQ, H, H, D, True, q_elt, 2, peak, passes)
    for name, qdt in (("flash_fwd_mma", bf), ("flash_fwd_3xtf32", f32)):
        # the LM path's pairs: bf16/bf16, and a float32 q against the bf16
        # cache of the fp32 run
        q, k, v = flash_case(gen, B, LM_PROMPT, LM_MAX_SEQ, H, H, D, qdt, bf)
        qt, kt, vt = (x.transpose(1, 2).to(qdt) for x in (q, k, v))
        if qdt == bf:
            res[name].update(fb(2, BF16_OPS_PER_S))
        else:
            # fp32-accurate work on the tf32 tensor cores: 2 products each
            # against the bf16 cache (3 against float32 K/V); beside it the
            # same work on the fp32 pipes
            res[name].update(fb(4, TF32_OPS_PER_S, 2), terms_ms={
                "tf32_x2_bf16_kv": fb(4, TF32_OPS_PER_S, 2)["ops_ms"],
                "tf32_x3_f32_kv": fb(4, TF32_OPS_PER_S, 3)["ops_ms"],
                "f32_fma": fb(4, F32_OPS_PER_S)["ops_ms"]})
        timed(name,
              lambda: flash_attention_cuda(q, k, v, causal=True, scale=sc),
              lambda: ref_attention(q, k, v, causal=True, scale=sc),
              lambda: sdpa(qt, kt, vt, is_causal=True, scale=sc),
              plain_reps=3)
        res[name]["tflop_per_s"] = res[name]["ops"] / res[name]["ms"] / 1e9
        res[name]["shape"] = {"B": B, "H": H, "KV": H, "Sq": LM_PROMPT,
                              "Sk": LM_MAX_SEQ, "D": D, "causal": True,
                              "dtype": f"{str(qdt)[6:]}/bfloat16"}
        del q, k, v, qt, kt, vt
    k = _randn(gen, (B, LM_MAX_SEQ, H, D), bf)
    v = _randn(gen, (B, LM_MAX_SEQ, H, D), bf)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    lt = torch.tensor(LM_KV_LEN, dtype=torch.int32, device="cuda")
    qd = _randn(gen, (B, H, D), bf)
    mask = (torch.arange(LM_MAX_SEQ, device="cuda")[None] < lt[:, None]) \
        [:, None, None, :]
    masked_sdpa = lambda: sdpa(qd[:, :, None], kt, vt, attn_mask=mask,
                               scale=sc)
    res["decode_splits"].update(decode_bound(qd, k, lt, fused=False,
                                             n_splits=ns_tpu))
    timed("decode_splits",
          lambda: decode_attention_cuda(qd, k, v, lt, n_splits=ns_tpu),
          lambda: ref_decode_splits(qd, k, v, lt, n_splits=ns_tpu),
          masked_sdpa)
    res["decode_fused"].update(decode_bound(qd, k, lt, fused=True))
    timed("decode_fused",
          lambda: decode_attention_fused(qd, k, v, lt, n_splits=ns_card),
          lambda: ref_decode_fused(qd, k, v, lt), masked_sdpa)
    res["decode_fused"]["ms_by_splits"] = {
        str(ns): graph_ms(lambda: decode_attention_fused(
            qd, k, v, lt, n_splits=ns), TIMED_LAUNCHES)
        for ns in (1, 2, 3, 4, 5, 6, 8)}
    # one prompt (B·KV = 32 < 132 SMs): the side of ``card_splits`` where
    # it picks a cluster of several splits
    q1, k1, v1 = qd[:1], k[:1], v[:1]
    res["decode_fused"]["batch1_ms_by_splits"] = {
        str(ns): graph_ms(lambda: decode_attention_fused(
            q1, k1, v1, LM_KV_LEN[-1], n_splits=ns), TIMED_LAUNCHES)
        for ns in (1, 2, 4, 8)}
    res["decode_fused"]["batch1_card_splits"] = card_splits(
        H, LM_MAX_SEQ, torch.cuda.get_device_properties(0)
        .multi_processor_count)
    # what the LM path calls: ``decode_attention`` with one int kv_len
    res["decode_fused"]["lm_call_ms"] = graph_ms(
        lambda: decode_attention(qd, k, v, LM_KV_LEN[-1]), TIMED_LAUNCHES)
    for name, ns in (("decode_splits", ns_tpu), ("decode_fused", ns_card)):
        r = res[name]
        r["tb_per_s"] = r["n_bytes"] / r["ms"] / 1e9
        r["shape"] = {"B": B, "H": H, "KV": H, "S": LM_MAX_SEQ, "D": D,
                      "kv_len": list(LM_KV_LEN), "n_splits": ns,
                      "dtype": "bfloat16"}
    print(json.dumps({"attention_phase": "ok",
                      **{n: {k: r[k] for k in ("ms", "event_ms", "plain_ms",
                                                "library_ms", "bound_ms",
                                                "max_abs_err",
                                                "atol_needed", "cases")}
                         for n, r in res.items()},
                      "decode_fused_ms_by_splits":
                          res["decode_fused"]["ms_by_splits"],
                      "decode_fused_batch1_ms_by_splits":
                          res["decode_fused"]["batch1_ms_by_splits"]}),
          flush=True)
    return res


# ------------------------------------------------------------ LM serving --

def serve(cfg, params, prompts, n_steps, attn_impl, forced=None):
    """``prefill`` then ``n_steps`` greedy ``decode_step``s; with
    ``forced`` (B, n_steps) the steps are fed those tokens instead of their
    own argmax. Returns the prefill logits, the first step's logits, the
    argmax after the prefill and each step, and host times (ms)."""
    from repro_torch.models import transformer as T

    b, s = prompts.shape
    caches = T.init_cache(cfg, b, LM_MAX_SEQ, device=prompts.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = T.prefill(cfg, params, prompts, caches,
                               attn_impl=attn_impl)
    tokens = [logits.argmax(-1)]
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    out = {"prefill_logits": logits.float(), "prefill_ms": prefill_ms,
           "step_ms": []}
    for i in range(n_steps):
        tok = (tokens[-1] if forced is None else forced[:, i])[:, None]
        t0 = time.perf_counter()
        logits, caches = T.decode_step(cfg, params, tok, caches, s + i,
                                       attn_impl=attn_impl)
        tokens.append(logits.argmax(-1))
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            out["step_logits"] = logits.float()
        check(bool(torch.isfinite(logits).all()),
              f"{attn_impl}: non-finite logits at decode step {i}")
    check(bool(torch.isfinite(out["prefill_logits"]).all()),
          f"{attn_impl}: non-finite prefill logits")
    out["tokens"] = torch.stack(tokens, dim=1)      # (B, n_steps + 1)
    return out


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _trace_summary(prof, wall_s: float, n: int) -> dict:
    """Per prefill or decode step (``n`` of them traced): host wall time,
    kernel launches and device busy time (the kernels' durations summed:
    one stream, so they do not overlap); the busy share of the wall time
    (the profiler's host overhead is inside it, so this is a lower
    bound), the attention kernels' share of the busy time, and the five
    kernels that take the most device time."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: float(e.self_device_time_total)
    busy = sum(map(dev_us, kernels)) / 1e3
    attn = sum(dev_us(e) for e in kernels
               if "flash_fwd" in e.key or "decode_kernel" in e.key)
    top = sorted(kernels, key=dev_us, reverse=True)[:5]
    return {"wall_ms": wall_s * 1e3 / n,
            "kernel_launches": sum(e.count for e in kernels) / n,
            "device_busy_ms": busy / n, "busy_share": busy / (wall_s * 1e3),
            "attention_share_of_busy": attn / 1e3 / busy,
            "top_kernels": [{"name": e.key[:80], "count": e.count / n,
                             "device_ms": dev_us(e) / 1e3 / n}
                            for e in top]}


def trace_lm(cfg, params, prompts, n_steps):
    """``torch.profiler`` over one prefill and ``n_steps`` decode steps
    through the kernels: where the device time goes, and how much of the
    wall time the device is busy."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    caches = T.init_cache(cfg, LM_BATCH, LM_MAX_SEQ)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, caches = T.prefill(cfg, params, prompts, caches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {"prefill": _trace_summary(prof, wall, 1)}
    tok = logits.argmax(-1, keepdim=True)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n_steps):
            logits, caches = T.decode_step(cfg, params, tok, caches,
                                           LM_PROMPT + i)
            tok = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["decode_step"] = _trace_summary(prof, wall, n_steps)
    return out


def prefill_in_chunks(cfg, params, prompts, n_chunks):
    """The prompts written into the cache in ``n_chunks`` equal chunks
    through ``forward(..., cache_pos=)``: every chunk after the first goes
    to the flash kernel at a query offset. Returns the last token's
    logits, the host time (ms) and the kernels' launch counts."""
    from repro_torch.models import transformer as T

    b, s = prompts.shape
    step = s // n_chunks
    caches = T.init_cache(cfg, b, LM_MAX_SEQ)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, s, step):
        logits, caches = T.forward(cfg, params, prompts[:, lo:lo + step],
                                   caches=caches, cache_pos=lo)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    want = {"flash_fwd_mma": cfg.n_layers * n_chunks, "flash_fwd_3xtf32": 0,
            "decode_splits": 0, "decode_fused": 0}
    for n, w in want.items():
        check(launches[n] == w, f"{n} launched {launches[n]} times in the "
                                f"{n_chunks}-chunk prefill, expected {w}")
    out = logits[:, -1].float()
    check(bool(torch.isfinite(out).all()), "non-finite chunked logits")
    return out, ms, launches


def serve_one_prompt(cfg, params, prompt):
    """The bf16 path at one prompt: B·KV = 32 of 132 SMs, so
    ``card_splits`` cuts each row's cache into several splits and the
    fused kernel merges them in a cluster, once per layer of every step;
    the logits against the plain path as at the serving batch."""
    from repro_torch.kernels.decode_attention import card_splits

    ns = card_splits(cfg.n_kv_heads, LM_MAX_SEQ,
                     torch.cuda.get_device_properties(0)
                     .multi_processor_count)
    check(ns > 1, f"card_splits gives {ns} split at one prompt: the "
                  f"cluster merge is not on this path")
    zero_counts()
    run = serve(cfg, params, prompt, LM_STEPS, "auto")
    launches = launch_counts()
    want = {"flash_fwd_mma": cfg.n_layers, "flash_fwd_3xtf32": 0,
            "decode_splits": 0, "decode_fused": cfg.n_layers * LM_STEPS}
    for n, w in want.items():
        check(launches[n] == w, f"{n} launched {launches[n]} times in the "
                                f"one-prompt prefill and {LM_STEPS} steps, "
                                f"expected {w}")
    ref = serve(cfg, params, prompt, LM_STEPS, "ref",
                forced=run["tokens"][:, :-1])
    rel = {"prefill": _rel(run["prefill_logits"], ref["prefill_logits"]),
           "first_step": _rel(run["step_logits"], ref["step_logits"])}
    check(max(rel.values()) < LM_BF16_BOUND,
          f"one-prompt bf16 logits through the kernels differ from the "
          f"plain path: {rel} (bound {LM_BF16_BOUND})")
    return {"n_splits": ns, "launches": launches,
            "prefill_ms": run["prefill_ms"],
            "decode_ms_per_step_median": statistics.median(run["step_ms"]),
            "plain_decode_ms_per_step_median": statistics.median(
                ref["step_ms"]),
            "rel_err_vs_plain_bf16": rel,
            "greedy_token_agreement": float(
                (ref["tokens"] == run["tokens"]).float().mean())}


def lm_phase():
    from repro_torch.configs import get
    from repro_torch.models import transformer as T

    cfg = get(LM_ARCH).config
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.randint(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(1))
    serve(cfg, params, prompts, 2, "auto")              # warm-up
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    run = serve(cfg, params, prompts, LM_STEPS, "auto")
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    trace = trace_lm(cfg, params, prompts, LM_TRACED_STEPS)
    # the bf16 path: the tensor-core flash kernel once per layer of the
    # prefill, the fused decode kernel once per layer of every step, and
    # nothing else (no float32 flash, no partials and eager combine)
    want = {"flash_fwd_mma": cfg.n_layers, "flash_fwd_3xtf32": 0,
            "decode_splits": 0, "decode_fused": cfg.n_layers * LM_STEPS}
    for n, w in want.items():
        check(launches[n] == w, f"{n} launched {launches[n]} times in the "
                                f"bf16 prefill and {LM_STEPS} steps, "
                                f"expected {w}")
    check(run["tokens"].shape == (LM_BATCH, LM_STEPS + 1)
          and run["prefill_logits"].shape == (LM_BATCH, cfg.vocab_size),
          "LM outputs have the wrong shape")

    ref = serve(cfg, params, prompts, LM_STEPS, "ref",
                forced=run["tokens"][:, :-1])
    rel_prefill = _rel(run["prefill_logits"], ref["prefill_logits"])
    rel_step = _rel(run["step_logits"], ref["step_logits"])
    agree = float((ref["tokens"] == run["tokens"]).float().mean())
    plain_ms = (ref["prefill_ms"], statistics.median(ref["step_ms"]))
    check(rel_prefill < LM_BF16_BOUND and rel_step < LM_BF16_BOUND,
          f"bf16 logits through the kernels differ from the plain path: "
          f"prefill {rel_prefill}, first step {rel_step} "
          f"(bound {LM_BF16_BOUND})")
    # the same prompts in two chunks: the second at a query offset
    chunked, chunked_ms, chunked_launches = prefill_in_chunks(
        cfg, params, prompts, 2)
    rel_chunked = {"vs_plain": _rel(chunked, ref["prefill_logits"]),
                   "vs_one_shot": _rel(chunked, run["prefill_logits"])}
    check(rel_chunked["vs_plain"] < LM_BF16_BOUND,
          f"two-chunk bf16 prefill logits differ from the plain path: "
          f"{rel_chunked['vs_plain']} (bound {LM_BF16_BOUND})")
    del ref, chunked
    one = serve_one_prompt(cfg, params, prompts[:1])
    del params

    cfg32 = dataclasses.replace(cfg, n_layers=LM_F32_LAYERS,
                                dtype="float32")
    p32 = T.init_params(cfg32, torch.Generator(device="cuda").manual_seed(0))
    # the fp32 path: a float32 q against the bf16 cache, so the split-tf32
    # flash kernel and the fused decode kernel, once per layer
    zero_counts()
    k32 = serve(cfg32, p32, prompts, 1, "auto")
    launches32 = launch_counts()
    want = {"flash_fwd_mma": 0, "flash_fwd_3xtf32": LM_F32_LAYERS,
            "decode_splits": 0, "decode_fused": LM_F32_LAYERS}
    for n, w in want.items():
        check(launches32[n] == w, f"{n} launched {launches32[n]} times in "
                                  f"the fp32 prefill and step, expected {w}")
    r32 = serve(cfg32, p32, prompts, 1, "ref", forced=k32["tokens"][:, :-1])
    rel32 = (_rel(k32["prefill_logits"], r32["prefill_logits"]),
             _rel(k32["step_logits"], r32["step_logits"]))
    check(max(rel32) < LM_F32_BOUND,
          f"fp32 logits through the kernels differ from the plain path: "
          f"prefill {rel32[0]}, first step {rel32[1]} "
          f"(bound {LM_F32_BOUND})")
    del p32

    decode_s = sum(run["step_ms"]) / 1e3
    row = {"arch": LM_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "n_params": T.n_params(T.init_params(cfg, device="meta")),
           "dtype": cfg.dtype, "batch": LM_BATCH, "prompt": LM_PROMPT,
           "max_seq": LM_MAX_SEQ, "decode_steps": LM_STEPS,
           "init_s": init_s, "prefill_ms": run["prefill_ms"],
           "prefill_tokens_per_s": LM_BATCH * LM_PROMPT
           / (run["prefill_ms"] / 1e3),
           "decode_ms_per_step_median": statistics.median(run["step_ms"]),
           "decode_tokens_per_s": LM_BATCH * LM_STEPS / decode_s,
           "plain_prefill_ms": plain_ms[0],
           "plain_decode_ms_per_step_median": plain_ms[1],
           "max_memory_allocated_bytes": peak, "launches": launches,
           "launches_fp32_2_layers": launches32,
           "rel_err_vs_plain_bf16": {"prefill": rel_prefill,
                                     "first_step": rel_step},
           "rel_err_vs_plain_fp32_2_layers": {"prefill": rel32[0],
                                              "first_step": rel32[1]},
           "fp32_2_layers_prefill_ms": {"kernels": k32["prefill_ms"],
                                        "plain": r32["prefill_ms"]},
           "greedy_token_agreement": agree, "one_prompt": one,
           "two_chunk_prefill": {"prefill_ms": chunked_ms,
                                 "launches": chunked_launches,
                                 "rel_err_bf16": rel_chunked}}
    print(json.dumps({"lm_serving": row}), flush=True)
    print(json.dumps({"lm_trace": trace}), flush=True)
    return launches, launches32


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    # the build threads below import nothing: two threads importing one
    # package at once can see it half initialised
    import repro_torch.kernels.moscore.moscore  # noqa: F401
    from repro_torch.kernels.nvcc_lib import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi("name,power.limit")
    print(json.dumps({"python": sys.version.split()[0],
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    # the attention library builds (nvcc) while the moscore extension
    # does, and moscore.cu compiles alone beside them for ptxas's report
    with ThreadPoolExecutor(max_workers=2) as pool:
        t0 = time.perf_counter()
        lib = pool.submit(lambda: (build(), time.perf_counter() - t0)[1])
        mo_ptxas = pool.submit(moscore_ptxas)
        res = kernel_phase(dev)
        build_s = lib.result()
        print(json.dumps({"ptxas_moscore": mo_ptxas.result()}), flush=True)

    # each main path is driven with the counts at 0 just before it and
    # read just after: the MO serving path (phases 3-4), then the LM
    # path's bf16 run and its fp32 run
    zero_counts()
    paper_phase()
    scale_phase(dev)
    launches = launch_counts()
    for n in KERNELS:
        check(launches[n] > 0, f"{n} was not launched on the main path")

    res.update(attention_phase(build_s))
    lm_bf16, lm_fp32 = lm_phase()
    paths = {"flash_fwd_mma": ("LM bf16 prefill", lm_bf16),
             "flash_fwd_3xtf32": ("LM fp32 prefill", lm_fp32),
             "decode_fused": ("LM bf16 decode", lm_bf16)}
    for n, (_, counts) in paths.items():
        launches[n] = counts[n]
        check(launches[n] > 0, f"{n} was not launched on the LM path")
    # the partials entry point serves decode_attention_splits and the
    # JAX-layout callers; no main path runs it since the combine moved
    # into the fused launch
    launches["decode_splits"] = lm_bf16["decode_splits"]

    kernels = []
    for n, (wrapper, src, tpu) in ROWS.items():
        r = res[n]
        row = {"name": n, "route": "cuda",
               "source": f"src/repro_torch/kernels/{src}", "replaces": tpu,
               "launches": launches[n], "max_abs_err": r["max_abs_err"],
               "ms": r["ms"], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "library_ms": r.get("library_ms"), "wrapper": wrapper,
               "main_path": paths[n][0] if n in paths
               else ("MO serving" if n in KERNELS else None),
               "bytes_ms": r["bytes_ms"], "ops_ms": r["ops_ms"]}
        if n in KERNELS:
            row.update({k: r[k] for k in (
                "serial_floor_ms", "event_ms", "us_per_window",
                "event_us_per_window", "paper_us_per_window",
                "paper_event_us_per_window")},
                shape={"P": PAIRS[-1], "G": 5, "W": W})
            if n == "moscore_hoisted_cuda":
                row["layouts_us_per_window"] = r["layouts_us_per_window"]
        else:
            row.update({k: r[k] for k in ("shape", "event_ms", "cases",
                                          "atol_needed")
                        + (("tflop_per_s",) if n.startswith("flash")
                           else ("tb_per_s",))})
        if n == "flash_fwd_3xtf32":
            row["bound_terms_ms"] = r["terms_ms"]
        if n == "decode_fused":
            row.update({k: r[k] for k in (
                "ms_by_splits", "batch1_ms_by_splits", "batch1_card_splits",
                "lm_call_ms")})
        kernels.append(row)
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
