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
from repro_torch.kernels.moscore.moscore import (HOISTED_MAX_WARPS,
                                                 HOISTED_PAIRS_PER_THREAD,
                                                 MAX_PAIRS, extension,
                                                 hoisted_layout)
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


def _every_layout_equals_plain(Tt, Ent, Ft, gs, q0, gamma):
    """The hoisted kernel through its wrapper, and in every layout it is
    built for that fits P, against ``mo_scan_hoisted``."""
    want = mo_scan_hoisted(Tt, Ent, Ft, gs, q0, gamma=gamma)
    n0 = moscore_hoisted_cuda.launches
    got = moscore_hoisted_cuda(Tt, Ent, Ft, gs, q0, gamma=gamma)
    assert moscore_hoisted_cuda.launches == n0 + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b), "wrapper"
    P = Tt.shape[1]
    for k in HOISTED_PAIRS_PER_THREAD:
        try:
            k, warps = hoisted_layout(P, k)
        except ValueError:              # more warps than one CTA takes
            continue
        ch, qf = torch.empty_like(gs), torch.empty_like(q0)
        extension().moscore_hoisted(Tt, Ent, Ft, gs, q0, ch, qf, gamma,
                                    1.0 - gamma, k, warps)
        torch.cuda.synchronize()
        assert torch.equal(ch, want[0]), (k, warps)
        assert torch.equal(qf, want[1]), (k, warps)


@pytest.mark.parametrize("n_pairs", [1, 31, 32, 33, 255, 256, 257, 1024,
                                     MAX_PAIRS, 384, 385, 768, 769, 2048,
                                     2049])
def test_hoisted_kernel_where_the_warp_layout_changes(n_pairs, cuda_device):
    """P on both sides of one warp (32 pairs at one per lane), of the
    default layout's eight warps (256) and of its second pair per thread,
    the path's 1024 and the largest P: every layout equals the plain
    scan."""
    prof, gs, q0 = _case(n_pairs, 256, cuda_device)
    feas, En = mo_precompute(prof.T, prof.E, prof.mAP, delta=20.0)
    _every_layout_equals_plain(*(x.t().contiguous()
                                 for x in (prof.T, En, feas)), gs, q0, 0.5)


def test_hoisted_launcher_refuses_layouts_it_does_not_cover(cuda_device):
    """The launcher runs every layout ``hoisted_layout`` may pick (the
    most warps of ``HOISTED_MAX_WARPS`` at each K, so the Python table stays
    within the kernel's own limits) and refuses, running no kernel, a K it
    is not built for, a warp more than its limit, and a layout that leaves
    pairs unscanned: the call raises and leaves the outputs untouched."""
    for k in HOISTED_PAIRS_PER_THREAD:
        warps = HOISTED_MAX_WARPS[k]
        P = min(32 * k * warps, MAX_PAIRS)
        prof, gs, q0 = _case(P, 16, cuda_device)
        feas, En = mo_precompute(prof.T, prof.E, prof.mAP, delta=20.0)
        Tt, Ent, Ft = (x.t().contiguous() for x in (prof.T, En, feas))
        want = mo_scan_hoisted(Tt, Ent, Ft, gs, q0, gamma=0.5)

        def run(k, warps):
            ch = torch.full_like(gs, -1)
            qf = torch.full_like(q0, -1.0)
            try:
                extension().moscore_hoisted(Tt, Ent, Ft, gs, q0, ch, qf, 0.5,
                                            0.5, k, warps)
            finally:
                torch.cuda.synchronize()
                run.outputs = ch, qf
            return ch, qf

        got = run(k, warps)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        bad = [(k, warps + 1), (k, 0), (3, 32)]
        if warps > 1:
            bad.append((k, -(-P // (32 * k)) - 1))
        for kk, ww in bad:
            with pytest.raises(RuntimeError, match="invalid configuration"):
                run(kk, ww)
            assert all((x == -1).all() for x in run.outputs), (kk, ww)


def test_hoisted_division_equals_ieee_division(cuda_device):
    """The hoisted kernel's division (``__fdiv_rn``'s fast path with a
    reciprocal per denominator, ``__fdiv_rn`` itself outside exponents of
    +-40) against the card's IEEE division, bit for bit: denominators from
    the scan's 1e-9 floor up, numerators from 0 to the denominator and far
    below it, integers (exact quotients), and operands outside the range."""
    from repro_torch.kernels.moscore.moscore import hoisted_divide

    gen = torch.Generator(device=cuda_device).manual_seed(7)
    n = 1 << 22
    u = lambda: torch.rand(n, generator=gen, device=cuda_device)
    d = torch.exp2(u() * 66 - 30)
    cases = [(d * u(), d), (d * torch.exp2(-u() * 60), d),
             (torch.randint(0, 1 << 24, (n,), generator=gen,
                            device=cuda_device).float(),
              torch.randint(1, 1 << 12, (n,), generator=gen,
                            device=cuda_device).float()),
             (torch.exp2(u() * 200 - 100), torch.exp2(u() * 120 - 60)),
             (torch.zeros(n, device=cuda_device), d)]
    for x, y in cases:
        x, y = x.float(), y.float()
        got = hoisted_divide(x, y)
        assert torch.equal(got.view(torch.int32), (x / y).view(torch.int32))


def test_hoisted_kernel_on_unaligned_tables(cuda_device):
    """Contiguous tables that start one element past an aligned address:
    the kernel reads them pair by pair instead of in vectors, with the
    same result."""
    prof, gs, q0 = _case(1024, 512, cuda_device)
    feas, En = mo_precompute(prof.T, prof.E, prof.mAP, delta=20.0)

    def shifted(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        out = buf[1:].view(x.shape)
        out.copy_(x)
        return out

    tables = [shifted(x.t().contiguous()) for x in (prof.T, En, feas)]
    assert all(t.is_contiguous() and t.data_ptr() % 16 for t in tables)
    _every_layout_equals_plain(*tables, gs, q0, 0.5)


@pytest.mark.parametrize("gamma", [0.0, 1.0, 0.5])
@pytest.mark.parametrize("n_pairs", [40, 300, 1024])
def test_hoisted_kernel_ties_empty_groups_and_zero_latency(n_pairs, gamma,
                                                           cuda_device):
    """Tables made for ties: latencies of a few levels with zeros among
    them, energies of three levels, pairs copied across every warp
    boundary and the first lane boundaries of each layout, a group with
    no feasible pair (every request of it takes pair 0), and gamma 0 and
    1 (energy or latency alone). The first index wins each tie, as in the
    plain scan."""
    rng = np.random.default_rng(n_pairs + int(10 * gamma))
    G = 4
    T = rng.integers(0, 4, (G, n_pairs)).astype(np.float32) * 0.5
    En = rng.integers(0, 3, (G, n_pairs)).astype(np.float32) * 0.5
    F = rng.random((G, n_pairs)) < 0.7
    F[G - 1] = False                    # no feasible pair: choice 0
    q0 = rng.integers(0, 3, n_pairs).astype(np.float32)
    for k in HOISTED_PAIRS_PER_THREAD:  # twins across warp and lane
        for b in [*range(32 * k, n_pairs, 32 * k), k, 3 * k, 5 * k]:
            if b < n_pairs:
                for x in (T, En, F):
                    x[:, b] = x[:, b - 1]
                q0[b] = q0[b - 1]
    gs = rng.integers(0, G, 512).astype(np.int32)
    dev = cuda_device
    args = [torch.from_numpy(x).to(dev) for x in (T, En, F, gs, q0)]
    _every_layout_equals_plain(*args, gamma)
    choices, _ = mo_scan_hoisted(*args, gamma=gamma)
    assert not choices[args[3] == G - 1].any()


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


# ------------------------------------------------- attention kernels, LM --
# Each attention kernel against its plain PyTorch version on the card, by
# the dtype of the output: both compute in float32 from the same input
# values, so a float32 output differs only in the order of the sums (1e-5,
# tests/test_kernels.py::_tol), a bfloat16 one also in its rounding (rtol
# 2e-2 as there; atol 5e-3, below its 2e-2, leaves room for the tensor-core
# flash kernel's bfloat16 P where an output of few keys cancels to near 0).

ATT_DTYPES = {"float32": (torch.float32, torch.float32),
              "bfloat16": (torch.bfloat16, torch.bfloat16),
              "float32-q-bfloat16-kv": (torch.float32, torch.bfloat16)}


def _att_tol(dtype):
    return dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 \
        else dict(rtol=2e-2, atol=5e-3)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


# (b, sq, sk, h, kv, d, causal): square, ragged edges, Sk > Sq (a prompt
# against a longer cache), Sq > Sk, GQA with G = 4, D in {16, 64, 80, 128},
# and head dims that are no multiple of 16 (8, 40, 72: the tensor-core
# kernel zero-pads them) with an Sq that is no multiple of 128 against a
# shorter Sk, causal and not
FLASH_GRID = [
    (1, 128, 128, 2, 2, 64, True),
    (2, 100, 130, 4, 1, 80, True),
    (1, 64, 256, 4, 4, 128, False),
    (2, 257, 300, 8, 2, 80, True),
    (1, 2048, 2560, 2, 2, 80, True),
    (1, 70, 50, 2, 2, 16, True),
    (2, 200, 333, 8, 2, 128, False),
    (1, 200, 150, 2, 2, 8, True),
    (2, 333, 77, 4, 1, 40, False),
    (1, 300, 200, 4, 2, 72, True),
    (1, 130, 129, 2, 2, 72, False),
]


@pytest.mark.parametrize("dtype", list(ATT_DTYPES))
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", FLASH_GRID)
def test_flash_kernel_equals_plain_version(b, sq, sk, h, kv, d, causal,
                                           dtype, cuda_device):
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     ref_attention)

    qdt, kvdt = ATT_DTYPES[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(sq * sk + d)
    q = _randn(gen, (b, h, sq, d), qdt, cuda_device).transpose(1, 2)
    k = _randn(gen, (b, sk, kv, d), kvdt, cuda_device)
    v = _randn(gen, (b, sk, kv, d), kvdt, cuda_device)
    n0 = flash_attention_cuda.launches
    k0 = dict(flash_attention_cuda.kernel_launches)
    got = flash_attention_cuda(q, k, v, causal=causal, scale=d ** -0.5)
    want = ref_attention(q, k, v, causal=causal, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == n0 + 1
    # the bf16 pair runs in bf16, a float32 q on split tf32
    ran = "flash_fwd_mma" if dtype == "bfloat16" else "flash_fwd_3xtf32"
    assert flash_attention_cuda.kernel_launches == {
        n: c + (n == ran) for n, c in k0.items()}
    assert got.dtype == qdt and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **_att_tol(qdt))


# (b, sq, sk, h, kv, d, q_offset): causal prompt chunks at a query offset
# into a longer cache (Sq + q_offset < Sk, the unfilled tail masked), at
# head dims 8, 72, 80 and 128, with and without GQA, offsets inside and
# at the edge of a key tile
OFFSET_GRID = [
    (1, 64, 256, 2, 2, 8, 100),
    (2, 100, 300, 8, 2, 72, 150),
    (2, 257, 600, 4, 4, 80, 64),
    (1, 130, 512, 8, 2, 80, 1),
    (1, 64, 200, 4, 1, 128, 136),
    (1, 1024, 2560, 2, 2, 80, 1024),
]


@pytest.mark.parametrize("dtype", list(ATT_DTYPES))
@pytest.mark.parametrize("b,sq,sk,h,kv,d,q_offset", OFFSET_GRID)
def test_flash_kernel_with_query_offset_equals_plain_version(
        b, sq, sk, h, kv, d, q_offset, dtype, cuda_device):
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     kernel_for,
                                                     ref_attention)

    qdt, kvdt = ATT_DTYPES[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(q_offset + d)
    q = _randn(gen, (b, sq, h, d), qdt, cuda_device)
    k = _randn(gen, (b, sk, kv, d), kvdt, cuda_device)
    v = _randn(gen, (b, sk, kv, d), kvdt, cuda_device)
    k0 = dict(flash_attention_cuda.kernel_launches)
    got = flash_attention_cuda(q, k, v, causal=True, scale=d ** -0.5,
                               q_offset=q_offset)
    want = ref_attention(q, k, v, causal=True, scale=d ** -0.5,
                         q_offset=q_offset)
    torch.cuda.synchronize()
    ran = kernel_for(qdt)
    assert ran == ("flash_fwd_mma" if dtype == "bfloat16"
                   else "flash_fwd_3xtf32")
    assert flash_attention_cuda.kernel_launches == {
        n: c + (n == ran) for n, c in k0.items()}
    torch.testing.assert_close(got.float(), want.float(), **_att_tol(qdt))


# (b, s, h, kv, d, kv_len, n_splits): the stablelm-3b decode shape, GQA
# with G = 4 and D = 128 over a partial cache, kv_len = 17 of 2048 in four
# splits (three wholly masked), and an empty row (kv_len = 0); for the
# fused kernel also kv_len inside the first of 8 partial splits beside an
# empty row, and n_splits = 0: the card's split count (``card_splits``)
# for the fused kernel, ``_pick_splits`` for the partials
DECODE_GRID = [
    (4, 2560, 32, 32, 80, (2049, 2059, 2069, 2080), 1),
    (2, 1024, 32, 8, 128, (700, 1024), 4),
    (1, 2048, 2, 1, 64, (17,), 4),
    (3, 256, 8, 4, 16, (0, 256, 129), 2),
    (2, 2048, 4, 4, 64, (17, 0), 8),
    (4, 2560, 32, 32, 80, (2049, 2059, 2069, 2080), 0),
    (1, 4096, 8, 1, 128, (4000,), 0),
]


@pytest.mark.parametrize("dtype", list(ATT_DTYPES))
@pytest.mark.parametrize("b,s,h,kv,d,kv_len,n_splits", DECODE_GRID)
def test_decode_kernel_equals_plain_version(b, s, h, kv, d, kv_len, n_splits,
                                            dtype, cuda_device):
    from repro_torch.kernels.decode_attention import (
        _pick_splits, decode_attention, decode_attention_cuda,
        decode_attention_fused, ref_decode_attention, ref_decode_splits)

    qdt, kvdt = ATT_DTYPES[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(s + d)
    q = _randn(gen, (b, h, d), qdt, cuda_device)
    k = _randn(gen, (b, s, kv, d), kvdt, cuda_device)
    v = _randn(gen, (b, s, kv, d), kvdt, cuda_device)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=cuda_device)
    ns = n_splits or _pick_splits(s, d)
    n0 = decode_attention_cuda.launches
    o, lse = decode_attention_cuda(q, k, v, lens, n_splits=ns)
    o_w, lse_w = ref_decode_splits(q, k, v, lens, n_splits=ns)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == n0 + 1
    torch.testing.assert_close(o, o_w, **_att_tol(o.dtype))
    torch.testing.assert_close(lse, lse_w, **_att_tol(lse.dtype))
    # on the card the output is one fused launch: no partials, no combine
    f0 = decode_attention_fused.launches
    out = decode_attention(q, k, v, lens, n_splits=n_splits)
    torch.cuda.synchronize()
    assert decode_attention_fused.launches == f0 + 1
    assert decode_attention_cuda.launches == n0 + 1
    assert out.dtype == qdt and out.shape == q.shape
    rows = lens > 0                 # an empty row is NaN in the oracle
    want = ref_decode_attention(q, k, v, lens)
    torch.testing.assert_close(out[rows].float(), want[rows].float(),
                               **_att_tol(qdt))
    assert not out[~rows].any()
    if len(set(kv_len)) == 1:       # one int for every row, as the LM path
        one = decode_attention(q, k, v, kv_len[0], n_splits=n_splits)
        torch.testing.assert_close(one.float(), want.float(),
                                   **_att_tol(qdt))


def test_attention_wrappers_check_inputs(cuda_device):
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_fused)
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = _randn(gen, (1, 8, 4, 64), torch.float32, cuda_device)
    k = _randn(gen, (1, 16, 2, 64), torch.float32, cuda_device)
    bad = [
        (q, k.cpu(), k),                                 # device
        (q.half(), k, k),                                # dtype
        (q, k, k.bfloat16()),                            # k, v differ
        (q[..., :60], k[..., :60], k[..., :60]),         # D % 8
        (q.transpose(1, 3), k, k),                       # D not unit stride
        (q[:, :, :3], k, k),                             # H % KV
    ]
    for args in bad:
        with pytest.raises(ValueError):
            flash_attention_cuda(*args, causal=True, scale=0.125)
    with pytest.raises(ValueError, match="not built"):   # bf16 q, fp32 k/v
        flash_attention_cuda(q.bfloat16(), k, k, causal=True, scale=0.125)
    big = _randn(gen, (1, 8, 2, 136), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(big, big, big, causal=True, scale=0.1)

    qd = _randn(gen, (2, 4, 64), torch.bfloat16, cuda_device)
    kd = _randn(gen, (2, 64, 2, 64), torch.bfloat16, cuda_device)
    lens = torch.tensor([10, 64], dtype=torch.int32, device=cuda_device)
    flat = torch.empty(kd.numel() + 2, dtype=kd.dtype, device=cuda_device)
    shifted = flat[2:].view(kd.shape)                    # 4-byte offset
    bad = [
        ((qd, kd, kd, lens.long()), 1),                  # kv_len dtype
        ((qd, kd, kd, lens), 3),                         # splits
        ((qd, shifted, shifted, lens), 1),               # alignment
        ((_randn(gen, (2, 32, 64), torch.bfloat16, cuda_device), kd, kd,
          lens), 1),                                     # G = 16 > 8
        ((qd.transpose(0, 1).contiguous().transpose(0, 1), kd, kd,
          lens), 1),                                     # q not contiguous
    ]
    for args, ns in bad:
        with pytest.raises(ValueError):
            decode_attention_cuda(*args, n_splits=ns)
    with pytest.raises(ValueError, match="not built"):   # bf16 q, fp32 k/v
        decode_attention_cuda(qd, kd.float(), kd.float(), lens, n_splits=1)
    with pytest.raises(ValueError, match="tensor"):      # int: fused only
        decode_attention_cuda(qd, kd, kd, 10, n_splits=1)
    for ns in (0, 9):                                    # one cluster: 1..8
        with pytest.raises(ValueError, match="cluster"):
            decode_attention_fused(qd, kd, kd, lens, n_splits=ns)
    with pytest.raises(ValueError, match="16-byte"):     # 8-byte offset
        odd = torch.empty(kd.numel() + 4, dtype=kd.dtype,
                          device=cuda_device)[4:].view(kd.shape)
        decode_attention_fused(qd, odd, odd, lens, n_splits=2)
    # the tensor-core flash kernel copies 16-byte pieces of rows
    qb = _randn(gen, (1, 8, 4, 64), torch.bfloat16, cuda_device)
    flat = torch.empty(qb.numel() + 4, dtype=qb.dtype, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_cuda(flat[4:].view(qb.shape), qb[:, :, :2],
                             qb[:, :, :2], causal=True, scale=0.125)


def _lm_models():
    import dataclasses

    from repro_torch.common.configs import LMConfig
    from repro_torch.configs import stablelm_3b

    gqa = LMConfig(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=128, vocab_size=128, dtype="float32")
    return {"stablelm-3b-reduced": stablelm_3b.REDUCED, "gqa": gqa,
            "stablelm-3b-reduced-bf16": dataclasses.replace(
                stablelm_3b.REDUCED, dtype="bfloat16")}


@pytest.mark.parametrize("model", ["stablelm-3b-reduced", "gqa",
                                   "stablelm-3b-reduced-bf16"])
def test_reduced_lm_through_kernels_matches_cpu(model, cuda_device):
    """``prefill`` and three greedy ``decode_step``s on the card go through
    the kernels (one flash launch per layer for the prefill, on the
    kernel the q dtype selects, and one fused decode launch per layer per
    step, no partials) and match the CPU's plain path: 1e-4 relative to
    the largest logit in float32 (cuBLAS and the kernels sum in other
    orders than the CPU), 2e-2 in bfloat16."""
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_fused)
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     kernel_for)
    from repro_torch.models import transformer as T

    cfg = _lm_models()[model]
    tol = 2e-2 if cfg.dtype == "bfloat16" else 1e-4
    params = T.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    on_card = _to(params, cuda_device)
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16)))
    rel = lambda a, b: float((a.float().cpu() - b.float()).abs().max()
                             / b.float().abs().max())
    c_cpu = T.init_cache(cfg, 2, 32, device="cpu")
    c_gpu = T.init_cache(cfg, 2, 32)
    n0 = flash_attention_cuda.launches, decode_attention_fused.launches
    p0 = decode_attention_cuda.launches
    k0 = dict(flash_attention_cuda.kernel_launches)
    l_cpu, c_cpu = T.prefill(cfg, params, tok, c_cpu)
    l_gpu, c_gpu = T.prefill(cfg, on_card, tok.to(cuda_device), c_gpu)
    assert rel(l_gpu, l_cpu) < tol
    for step in range(3):
        nxt = l_cpu.argmax(-1, keepdim=True)
        l_cpu, c_cpu = T.decode_step(cfg, params, nxt, c_cpu, 16 + step)
        l_gpu, c_gpu = T.decode_step(cfg, on_card, nxt.to(cuda_device),
                                     c_gpu, 16 + step)
        assert rel(l_gpu, l_cpu) < tol, step
    assert flash_attention_cuda.launches - n0[0] == cfg.n_layers
    assert decode_attention_fused.launches - n0[1] == 3 * cfg.n_layers
    assert decode_attention_cuda.launches == p0
    ran = kernel_for(on_card["embed"].dtype)
    assert flash_attention_cuda.kernel_launches == {
        n: c + cfg.n_layers * (n == ran) for n, c in k0.items()}
    # two tokens at cache position 19: the flash kernel at a query offset
    l_cpu, _ = T.forward(cfg, params, tok[:, :2], caches=c_cpu,
                         cache_pos=19)
    l_gpu, _ = T.forward(cfg, on_card, tok[:, :2].to(cuda_device),
                         caches=c_gpu, cache_pos=19)
    assert flash_attention_cuda.launches - n0[0] == 2 * cfg.n_layers
    assert rel(l_gpu, l_cpu) < tol


@pytest.mark.parametrize("model", ["stablelm-3b-reduced", "gqa",
                                   "stablelm-3b-reduced-bf16"])
def test_two_chunk_prefill_through_kernels_matches_one_shot(model,
                                                            cuda_device):
    """A 24-token prompt prefilled on the card in chunks of 16 and 8
    through ``forward(..., cache_pos=)``: one flash launch per layer per
    chunk (the second at query offset 16), and its last logits against the
    one-shot ``prefill`` on the card: 3e-2 of the largest logit in
    bfloat16 (the chunk's q and the cache round to bfloat16 at other
    places than the one-shot prompt's), 2e-5 in float32."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import transformer as T

    cfg = _lm_models()[model]
    tol = 3e-2 if cfg.dtype == "bfloat16" else 2e-5
    params = T.init_params(cfg, torch.Generator().manual_seed(4),
                           device="cpu")
    on_card = _to(params, cuda_device)
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 24))).to(cuda_device)
    one, _ = T.prefill(cfg, on_card, tok, T.init_cache(cfg, 2, 40))
    caches = T.init_cache(cfg, 2, 40)
    n0 = flash_attention_cuda.launches
    for lo, hi in ((0, 16), (16, 24)):
        logits, caches = T.forward(cfg, on_card, tok[:, lo:hi],
                                   caches=caches, cache_pos=lo)
    assert flash_attention_cuda.launches - n0 == 2 * cfg.n_layers
    err = (logits[:, -1].float() - one.float()).abs().max() \
        / one.float().abs().max()
    assert float(err) < tol


def test_forward_without_cache_through_flash_kernel(cuda_device):
    """The no-cache forward (causal, as training and scoring run it) goes
    through the flash kernel, one launch per layer, and matches the CPU's
    plain path within 1e-4 of the largest logit (float32)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import transformer as T

    cfg = _lm_models()["gqa"]
    params = T.init_params(cfg, torch.Generator().manual_seed(3),
                           device="cpu")
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 24)))
    want, _ = T.forward(cfg, params, tok)
    n0 = flash_attention_cuda.launches
    got, _ = T.forward(cfg, _to(params, cuda_device), tok.to(cuda_device))
    assert flash_attention_cuda.launches - n0 == cfg.n_layers
    err = (got.cpu() - want).abs().max() / want.abs().max()
    assert float(err) < 1e-4
