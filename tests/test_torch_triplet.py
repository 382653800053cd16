"""The fused triplet loss (``ops/cuda_triplet.py``): its plain versions
against the gather-and-autograd route of ``ops/bpr.py``, the route
``triplet_loss_of`` takes for each input, and, on a card, the kernels against
the plain versions."""

import pytest
import torch

from movie_recommender_system_with_gnns_tpu_torch.ops import bpr, cuda_triplet
from movie_recommender_system_with_gnns_tpu_torch.ops._build import LAUNCHES
from movie_recommender_system_with_gnns_tpu_torch.ops.bpr import (triplet_loss, triplet_loss_of,
                                                                  triplet_rows)
from movie_recommender_system_with_gnns_tpu_torch.ops.sampling import TripletBatch
from movie_recommender_system_with_gnns_tpu_torch.utils import observability as obs

NUM_USERS, NUM_ITEMS = 23, 37   # few rows, so users and items repeat in a batch


def _inputs(b, k, d, masked, seed=0, device="cpu"):
    """Four tables and a batch; ``k`` None gives (B,) negatives. The last
    quarter of the batch is masked when ``masked``."""
    g = torch.Generator().manual_seed(seed)
    tabs = [torch.randn(n, d, generator=g) * s
            for n, s in ((NUM_USERS, 0.3), (NUM_ITEMS, 0.3), (NUM_USERS, 0.1), (NUM_ITEMS, 0.1))]
    user = torch.randint(0, NUM_USERS, (b,), generator=g)
    pos = torch.randint(0, NUM_ITEMS, (b,), generator=g)
    neg = torch.randint(0, NUM_ITEMS, (b,) if k is None else (b, k), generator=g)
    mask = torch.ones(b, dtype=torch.bool)
    if masked:
        mask[3 * b // 4:] = False
    to = lambda t: t.to(device)
    return [to(t) for t in tabs], TripletBatch(to(user), to(pos), to(mask)), to(neg)


def _grads(route, tabs, batch, neg, ct):
    leaves = [t.clone().requires_grad_(True) for t in tabs]
    with torch.enable_grad():
        loss = route(leaves, batch, neg)
        grads = torch.autograd.grad(loss * ct, leaves)
    return loss.detach(), grads


def _gather_route(leaves, batch, neg):
    rows = triplet_rows(leaves[:2], leaves[2:], batch, neg)
    return triplet_loss(rows, batch.mask, "standard", 5e-3)


def _fused_route(leaves, batch, neg):
    return cuda_triplet.triplet_loss_fused(leaves[:2], leaves[2:], batch.user, batch.pos_item,
                                           neg, batch.mask, 5e-3)


CASES = [  # (K, or None for (B,) negatives; d; masked tail; upstream scalar)
    (None, 64, True, 1.0),
    (1, 64, False, 1.0),
    (8, 64, True, 1.0),
    (8, 64, False, 0.25),
    (None, 256, False, 1.0),
    (8, 256, True, 0.37),
]


@pytest.mark.parametrize("k,d,masked,ct", CASES,
                         ids=[f"k{k}-d{d}-{'tail' if m else 'full'}-ct{c}"
                              for k, d, m, c in CASES])
def test_fused_plain_matches_autograd_route(k, d, masked, ct):
    """The plain versions' loss and table gradients (after
    ``sorted_index_add_plain``) against the gather route under autograd:
    equal within float32 rounding (rtol 1e-5, atol 1e-8), since the two sum
    the same terms in another order; an upstream scalar below 1 stands for a
    microbatched chunk's ``w / total_w``."""
    tabs, batch, neg = _inputs(96, k, d, masked)
    l_ref, g_ref = _grads(_gather_route, tabs, batch, neg, ct)
    l_fus, g_fus = _grads(_fused_route, tabs, batch, neg, ct)
    torch.testing.assert_close(l_fus, l_ref, rtol=1e-6, atol=0)
    for a, b in zip(g_fus, g_ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-8)
    assert all(g.abs().max() > 0 for g in g_fus)


def test_triplet_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the kernels' wrappers return their plain versions'
    outputs, bit for bit, and launch nothing."""
    tabs, batch, neg = _inputs(40, 8, 64, True)
    args = (tabs, batch.user, batch.pos_item, neg, batch.mask)
    before = LAUNCHES["triplet_loss"]
    got = cuda_triplet.triplet_fwd(*args, 5e-3)
    want = cuda_triplet.triplet_fwd_plain(*args, 5e-3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    ct = torch.tensor(0.5)
    got = cuda_triplet.triplet_bwd(*args, want[1], want[2], ct, 5e-3)
    plain = cuda_triplet.triplet_bwd_plain(*args, want[1], want[2], ct, 5e-3)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert LAUNCHES["triplet_loss"] == before
    b, k = neg.shape
    assert [tuple(g.shape) for g in got] == [(b, 64), (b, 64), (b * (1 + k), 64),
                                             (b * (1 + k), 64)]
    masked = ~batch.mask
    assert not want[1][masked].any() and not got[0][masked].any()


ROUTES = [  # (device, loss, gradient taken, route)
    ("cpu", "standard", True, "sorted"),
    ("cpu", "standard", False, "plain"),
    ("meta", "standard", True, "fused"),
    ("meta", "reference", True, "sorted"),
    ("meta", "standard", False, "plain"),
]


@pytest.mark.parametrize("device,loss,grad,route", ROUTES,
                         ids=[f"{d}-{l}-{'grad' if g else 'nograd'}" for d, l, g, _ in ROUTES])
def test_triplet_loss_of_route(monkeypatch, device, loss, grad, route):
    """The fused kernels take a gradient of the ``standard`` loss off the
    CPU, counted once as ``triplet.fused``; the ``reference`` loss and CPU
    tensors keep the sorted gather, and without a gradient the rows are
    ``index_select`` gathers."""
    calls = []
    monkeypatch.setattr(bpr, "triplet_loss_fused", lambda *a: calls.append("fused"))
    monkeypatch.setattr(bpr, "triplet_rows",
                        lambda f, t, b, n, sorted_: calls.append("sorted" if sorted_ else "plain"))
    monkeypatch.setattr(bpr, "triplet_loss", lambda *a: None)
    tabs, batch, neg = _inputs(16, 8, 64, True, device=device)
    tabs = [t.requires_grad_(True) for t in tabs]
    obs.clear()
    with obs.tracing(), torch.set_grad_enabled(grad):
        triplet_loss_of(tabs[:2], tabs[2:], batch, neg, loss, 5e-3)
    assert calls == [route]
    assert obs.counts().get("triplet.fused", 0) == (route == "fused")
    obs.clear()


def test_triplet_loss_of_cpu_is_the_gather_route():
    """On the CPU ``triplet_loss_of`` is today's expression, bit for bit,
    loss and gradients."""
    tabs, batch, neg = _inputs(64, 8, 64, True)
    of = lambda leaves, b, n: triplet_loss_of(leaves[:2], leaves[2:], b, n, "standard", 5e-3)
    l_of, g_of = _grads(of, tabs, batch, neg, 1.0)
    l_ref, g_ref = _grads(_gather_route, tabs, batch, neg, 1.0)
    assert torch.equal(l_of, l_ref) and all(torch.equal(a, b) for a, b in zip(g_of, g_ref))


def test_triplet_loss_of_refuses_a_width_the_kernels_lack():
    """A width outside the kernels' templates raises ``ValueError`` at the
    call, before anything is launched (meta tensors stand for the card's)."""
    tabs, batch, neg = _inputs(16, 8, 48, True, device="meta")
    tabs = [t.requires_grad_(True) for t in tabs]
    with pytest.raises(ValueError, match="d=48"):
        triplet_loss_of(tabs[:2], tabs[2:], batch, neg, "standard", 5e-3)


def test_triplet_kernels_match_plain_on_card():
    """On a card: the kernels against the plain versions at a small shape
    with repeated rows, K 8 and K 1, and two calls bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; `python3 chip_smoke.py --triplet-only` "
                    "checks the kernels on the card")
    for k, d in ((8, 256), (None, 64)):
        tabs, batch, neg = _inputs(1000, k, d, True, device="cuda")
        args = (tabs, batch.user, batch.pos_item, neg, batch.mask)
        ct = torch.tensor(0.5, device="cuda")
        want = cuda_triplet.triplet_loss_plain(*args, 5e-3, ct)
        runs = []
        for _ in range(2):
            loss, sig, stats = cuda_triplet.triplet_fwd(*args, 5e-3)
            runs.append((loss, sig) + cuda_triplet.triplet_bwd(*args, sig, stats, ct, 5e-3))
        assert all(torch.equal(a, b) for a, b in zip(*runs))
        for a, b in zip(runs[0], want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-8)
