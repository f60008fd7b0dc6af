"""The port on the card: each CUDA kernel against its plain PyTorch
version, and the serving plane on the card against the same plane on the
CPU. Results must be EQUAL (no tolerance). Every test here needs a CUDA
device and skips without one; the file imports no JAX, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -o filterwarnings= tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import Scenario, paper_fleet, synthetic_fleet
from repro_torch.core.policies import mo_precompute, mo_scan_hoisted
from repro_torch.core.profiles import ProfileTable
from repro_torch.kernels.moscore import (moscore_cuda, moscore_hoisted_cuda,
                                         moscore_route)
from repro_torch.kernels.moscore.moscore import MAX_PAIRS
from repro_torch.serving import ServingPlane


@pytest.fixture
def cuda_device():
    # decided when the test runs, never at import, so every test worker
    # collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run these tests on the H100")
    return torch.device("cuda")


#: marks a test that runs only on the card
requires_cuda = pytest.mark.usefixtures("cuda_device")
pytestmark = requires_cuda

GRID = [(5, 64, 20.0, 0.5), (5, 256, 20.0, 0.0), (37, 128, 10.0, 1.0),
        (200, 64, 30.0, 0.25), (200, 256, 20.0, 0.33),
        (1024, 4096, 20.0, 0.5)]
RECORDS = ("pair", "g_est", "g_true", "latency", "energy", "map")


def _case(n_pairs, window, dev, ties=False, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    prof = paper_fleet().to(dev) if n_pairs == 5 \
        else synthetic_fleet(gen, n_pairs)
    q0 = torch.randint(0, 4, (n_pairs,), generator=gen, device=dev).float()
    if ties:                            # every pair twice: equal scores
        prof = ProfileTable(*(torch.cat([x, x])
                              for x in (prof.T, prof.E, prof.mAP)))
        q0 = torch.zeros((2 * n_pairs,), device=dev)
    gs = torch.randint(0, prof.n_groups, (window,), generator=gen,
                       device=dev, dtype=torch.int32)
    return prof, gs, q0


def _launches():
    return moscore_cuda.launches, moscore_hoisted_cuda.launches


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n_pairs,window,delta,gamma", GRID)
def test_kernels_equal_plain_versions(n_pairs, window, delta, gamma, ties,
                                      cuda_device):
    prof, gs, q0 = _case(n_pairs, window, cuda_device, ties)
    n0 = _launches()
    for backend, plain in (("cuda", "ref"), ("cuda_hoisted", "hoisted")):
        got = moscore_route(prof.T, prof.E, prof.mAP, gs, q0, delta=delta,
                            gamma=gamma, backend=backend)
        want = moscore_route(prof.T, prof.E, prof.mAP, gs, q0, delta=delta,
                             gamma=gamma, backend=plain)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), backend
    assert _launches() == (n0[0] + 1, n0[1] + 1)


def test_kernels_at_max_pairs_equal_plain_versions(cuda_device):
    """The largest fleet the wrappers accept fits the kernels' shared
    memory: both launch and agree with their plain versions."""
    prof, gs, q0 = _case(MAX_PAIRS, 64, cuda_device)
    n0 = _launches()
    for backend, plain in (("cuda", "ref"), ("cuda_hoisted", "hoisted")):
        got = moscore_route(prof.T, prof.E, prof.mAP, gs, q0,
                            backend=backend)
        want = moscore_route(prof.T, prof.E, prof.mAP, gs, q0,
                             backend=plain)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), backend
    assert _launches() == (n0[0] + 1, n0[1] + 1)


@pytest.mark.parametrize("degraded", [False, True])
def test_health_window_goes_through_hoisted_kernel(degraded, cuda_device):
    prof, gs, q0 = _case(200, 512, cuda_device)
    h = torch.from_numpy(np.random.default_rng(1).random(200) < 0.6)
    h = h.to(cuda_device)
    if degraded:                        # nothing healthy clears the bar
        m = prof.mAP[:, -1]
        h &= m < m.max() - 20.0
    n0 = _launches()
    got = moscore_route(prof.T, prof.E, prof.mAP, gs, q0, backend="cuda",
                        health=h)
    want = moscore_route(prof.T, prof.E, prof.mAP, gs, q0,
                         backend="hoisted", health=h)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert _launches() == (n0[0], n0[1] + 1)


def test_wrappers_check_inputs(cuda_device):
    prof, gs, q0 = _case(37, 16, cuda_device)
    feas, En = mo_precompute(prof.T, prof.E, prof.mAP, delta=20.0)
    Tt, Ent, Ft = (x.t().contiguous() for x in (prof.T, En, feas))
    bad = [
        (Tt.t(), Ent, Ft, gs, q0),                       # not contiguous
        (Tt.double(), Ent, Ft, gs, q0),                  # dtype
        (Tt, Ent[:, :-1].contiguous(), Ft, gs, q0),      # shape
        (Tt, Ent, Ft, gs.long(), q0),                    # gs dtype
        (Tt, Ent, Ft, gs, q0.cpu()),                     # device
    ]
    for args in bad:
        with pytest.raises(ValueError):
            moscore_hoisted_cuda(*args, gamma=0.5)
    with pytest.raises(ValueError):
        moscore_cuda(Tt, Ent, Ft.float(), gs, q0[:-1].contiguous(),
                     delta=20.0, gamma=0.5)
    big = torch.ones((5, MAX_PAIRS + 1), device=cuda_device)
    with pytest.raises(ValueError, match="P <="):          # q too large
        moscore_cuda(big, big, big, gs, big[0].contiguous(), delta=20.0,
                     gamma=0.5)
    for a, b in zip(mo_scan_hoisted(Tt, Ent, Ft, gs, q0, gamma=0.5),
                    moscore_hoisted_cuda(Tt, Ent, Ft.to(torch.uint8), gs,
                                         q0, gamma=0.5)):
        assert torch.equal(a, b)


def test_serving_plane_on_card_equals_cpu(cuda_device):
    """The paper deployment on the card (the hoisted CUDA kernel, one
    launch per window) gives the CPU plane's records exactly."""
    n0 = moscore_hoisted_cuda.launches
    plane = ServingPlane.build(Scenario(n_users=15), window=64)
    assert plane.gateway.backend == "cuda_hoisted"
    got = plane.run(2048)
    assert moscore_hoisted_cuda.launches - n0 == 2048 // 64
    want = ServingPlane.build(Scenario(n_users=15), window=64,
                              device="cpu").run(2048)
    for k in RECORDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
