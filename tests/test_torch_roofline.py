"""The port's row-op roofline (``utils/roofline.py``) against the JAX
package's: every term the two share equal at equal rates, shapes and peaks;
each departure pinned by a hand count."""

import numpy as np
import pytest
import torch

from movie_recommender_system_with_gnns_tpu.utils import roofline as jax_roofline
from movie_recommender_system_with_gnns_tpu_torch.ops.cuda_spmm import ell_schedule
from movie_recommender_system_with_gnns_tpu_torch.utils import roofline

RATES = dict(gather_ns_row=1.0962, segment_ns_row=0.6681, sort_ns_row=1.4416,
             sweep_gbps=839.4)
PEAK_FLOPS, PEAK_HBM = 989e12, 3.35e12
#: train-compact-full's shapes, and a small one
COMPACT = [dict(num_users=162_541, num_items=59_047, d=64, num_layers=3, num_clusters=100,
                u_pad=1792, i_pad=1024, b_pad=38_656),
           dict(num_users=943, num_items=1682, d=16, num_layers=2, num_clusters=4,
                u_pad=320, i_pad=448, b_pad=7168)]
SHARDED = dict(n_pad=221_588, d=64, num_layers=3, steps=16, batch=349_184,
               e_off_directed=3_864_910, ell_chunks=230_117, blk_k=64, blk_p=4608)


def floors(shape, optimizer):
    port = roofline.compact_epoch_floor(
        **shape, rates=roofline.RowOpRates(**RATES), peak_flops=PEAK_FLOPS,
        peak_hbm_bps=PEAK_HBM, optimizer=optimizer)
    jax = jax_roofline.compact_epoch_floor(
        **shape, rates=jax_roofline.RowOpRates(**RATES), peak_flops=PEAK_FLOPS,
        optimizer=optimizer)
    return port, jax


@pytest.mark.parametrize("optimizer", ["adam", "hybrid_adam"])
@pytest.mark.parametrize("shape", COMPACT, ids=["full", "small"])
def test_compact_shared_terms_match_jax(shape, optimizer):
    port, jax = floors(shape, optimizer)
    assert set(jax) | {"floor_bpr_s"} == set(port)
    for key in ("floor_rowop_s", "floor_sweep_s"):
        assert port[key] == pytest.approx(jax[key], rel=1e-12, abs=0)
    # JAX's MXU term less its fused BPR kernel's one-hot FLOPs, by hand
    bpr_flops = 4.0 * shape["b_pad"] * shape["d"] * (2 * shape["u_pad"] + 3 * shape["i_pad"])
    prop = jax["floor_mxu_s"] - shape["num_clusters"] * bpr_flops / PEAK_FLOPS
    assert port["floor_mxu_s"] == pytest.approx(prop, rel=1e-12, abs=0)
    assert port["floor_s"] == pytest.approx(sum(v for k, v in port.items() if k != "floor_s"),
                                            rel=1e-12)


def test_compact_bpr_term_is_the_kernels_bytes():
    """Every triplet valid, every table row named, the negatives outside the
    cluster: the floor's shape count is the count of a real call's inputs."""
    u_pad, i_pad, b, d = 6, 5, 30, 8
    gen = torch.Generator().manual_seed(0)
    ul = torch.arange(b, dtype=torch.int32) % u_pad
    pl = torch.arange(b, dtype=torch.int32) % i_pad
    args = (torch.randn(u_pad, 2 * d, generator=gen), torch.randn(i_pad, 2 * d, generator=gen),
            torch.randn(b, d, generator=gen), ul, pl,
            torch.randint(0, i_pad, (b,), generator=gen, dtype=torch.int32),
            torch.zeros(b, dtype=torch.int32), torch.ones(b, dtype=torch.int32))
    counts = roofline.bpr_tile_counts(*args)
    assert counts == dict(b=b, d=d, valid=b, users_named=u_pad, items_named=i_pad,
                          neg_only=0, u_rows=u_pad, i_rows=i_pad)
    byts = roofline.bpr_tile_bytes(**counts)
    # ids and m (4 B each, 4 per valid triplet), ni rows, the named rows of
    # both tables, gni and both gradient tables, the loss
    assert byts == (4 * b + 16 * b + b * d * 4 + 8 + (u_pad + i_pad) * 2 * d * 4
                    + b * d * 4 + (u_pad + i_pad) * 2 * d * 4 + 4)
    steps = 3
    port = roofline.compact_epoch_floor(
        num_users=40, num_items=30, d=d, num_layers=2, num_clusters=steps, u_pad=u_pad,
        i_pad=i_pad, b_pad=b, rates=roofline.RowOpRates(**RATES), peak_flops=PEAK_FLOPS,
        peak_hbm_bps=PEAK_HBM)
    assert port["floor_bpr_s"] == pytest.approx(steps * byts / PEAK_HBM, rel=1e-12)


def test_bpr_counts_of_masked_and_in_cluster_triplets():
    """A masked triplet names nothing; an in-cluster negative that is no
    valid positive is read as its propagated half alone."""
    u_tab, i_tab, ni = torch.zeros(4, 16), torch.zeros(6, 16), torch.zeros(5, 8)
    ul = torch.tensor([0, 1, 1, 2, 3], dtype=torch.int32)
    pl = torch.tensor([0, 0, 1, 2, 3], dtype=torch.int32)
    loc = torch.tensor([4, 0, 5, 5, 2], dtype=torch.int32)
    inc = torch.tensor([1, 1, 0, 1, 1], dtype=torch.int32)
    m = torch.tensor([1, 1, 1, 1, 0], dtype=torch.int32)
    assert roofline.bpr_tile_counts(u_tab, i_tab, ni, ul, pl, loc, inc, m) == dict(
        b=5, d=8, valid=4, users_named=3, items_named=3, neg_only=2, u_rows=4, i_rows=6)
    assert roofline.bpr_tile_flops(d=8, valid=4) == 30.0 * 8 * 4


def test_hybrid_per_step_user_writes():
    """hybrid_adam writes the step's user rows (table and both moments) at
    every step: 3·u_pad rows a step at the gather rate. JAX's once-an-epoch
    write-back has no counterpart; Adam writes none."""
    shape = COMPACT[0]
    port, jax = floors(shape, "hybrid_adam")
    assert port["floor_epoch_fixed_s"] == pytest.approx(
        100 * 3 * 1792 * 1.0962e-9, rel=1e-12)
    assert jax["floor_epoch_fixed_s"] != pytest.approx(port["floor_epoch_fixed_s"])
    assert floors(shape, "adam")[0]["floor_epoch_fixed_s"] == 0.0


@pytest.mark.parametrize("devices", [(1, 0.0), (4, 450.0)], ids=["one_card", "four"])
def test_sharded_shared_terms_match_jax(devices):
    kw = dict(**SHARDED, peak_flops=PEAK_FLOPS, peak_hbm_gbps=PEAK_HBM / 1e9,
              num_devices=devices[0], ici_gbps=devices[1])
    port = roofline.sharded_epoch_floor(**kw, rates=roofline.RowOpRates(**RATES))
    jax = jax_roofline.sharded_epoch_floor(**kw, rates=jax_roofline.RowOpRates(**RATES))
    assert set(port) == set(jax)
    for key in ("sharded_floor_collective_s", "sharded_floor_block_s",
                "sharded_floor_loss_s"):
        assert port[key] == pytest.approx(jax[key], rel=1e-12, abs=0)
    assert port["sharded_floor_s"] == pytest.approx(
        sum(v for k, v in port.items() if k != "sharded_floor_s"), rel=1e-12)


def test_sharded_remainder_is_the_ell_kernels_bytes():
    """B4 over the remainder, per application: each edge's id and weight, the
    table read once, the work list's rows written once, over the HBM peak.
    At the card's measured rates JAX's gather per edge comes to more than
    the whole measured epoch."""
    port = roofline.sharded_epoch_floor(
        **SHARDED, rates=roofline.RowOpRates(**RATES), peak_flops=PEAK_FLOPS,
        peak_hbm_gbps=PEAK_HBM / 1e9)
    apps = 2 * 3 * 16
    byts = 8 * 3_864_910 + (221_588 + 230_117) * 64 * 4
    assert port["sharded_floor_ell_s"] == pytest.approx(apps * byts / PEAK_HBM, rel=1e-12)
    jax = jax_roofline.sharded_epoch_floor(
        **SHARDED, rates=jax_roofline.RowOpRates(**RATES), peak_flops=PEAK_FLOPS,
        peak_hbm_gbps=PEAK_HBM / 1e9)
    assert jax["sharded_floor_ell_s"] > 40 * port["sharded_floor_ell_s"]


class _Block:
    def __init__(self, node_ids, nbr):
        self.node_ids, self.nbr = np.asarray(node_ids), np.asarray(nbr)
        self.w = np.ones(self.nbr.shape, np.float32)


def test_ell_rows_written_from_a_real_schedule():
    """Rows of the work list's runs plus one scratch row per segment of a
    split row; a bucket's padding row is not scheduled."""
    n = 10                                    # padding id
    narrow = [[1, 2, n, n], [3, n, n, n], [0, 4, 5, 6], [n, n, n, n]]
    hub = list(range(9)) * 8                  # 72 live slots: 3 segments of 32
    wide = [hub + [n] * 8, [n] * 80]
    blocks = [_Block([0, 5, 7, 8], narrow), _Block([9, n], wide)]
    sched = ell_schedule(blocks, n, device="cpu", budget=32)
    assert sched.num_segments == 3 and len(sched.split_rows) == 1
    assert roofline.ell_rows_written(sched) == 4 + 3


def test_diff_time_arithmetic_with_an_injected_clock():
    calls = []

    def make(rep):
        return lambda: calls.append(rep)

    def clock_of(durations):
        ticks = iter(np.cumsum([x for d in durations for x in (0.0, d)]))
        return lambda: float(next(ticks))

    # r2's runs first (as JAX evaluates them), 3 each after the warm-ups
    t = roofline._diff_time(make, (), r1=50, r2=300, device="cpu",
                            clock=clock_of([5.0, 3.0, 4.0, 2.0, 1.0, 1.5]))
    assert t == pytest.approx((3.0 - 1.0) / 250, rel=1e-12)
    assert calls == [300] * 4 + [50] * 4
    t = roofline._diff_time(make, (), r1=50, r2=300, device="cpu",
                            clock=clock_of([1.0, 1.0, 1.0, 2.0, 2.0, 2.0]))
    assert t == 1e-9


def test_measure_rowop_rates_on_the_cpu():
    rates = roofline.measure_rowop_rates(num_rows=300, d=8, batch=128, device="cpu")
    assert isinstance(rates, roofline.RowOpRates)
    assert all(np.isfinite(v) and v > 0 for v in rates)


def test_optimizer_sweep_gbps_on_the_cpu():
    gbps = roofline.optimizer_sweep_gbps(num_rows=300, d=8, device="cpu")
    assert np.isfinite(gbps) and gbps > 0


def test_the_sweep_yardstick_is_one_adam_step():
    """The fused pass the sweep rate is timed on does Adam's work: from zero
    moments, m = 0.1·g, v = 0.001·g², and the bias-corrected step moves p by
    lr·g / (|g| + eps); the carry comes back untouched."""
    gen = torch.Generator().manual_seed(0)
    p, g = torch.randn(50, 8, generator=gen), torch.randn(50, 8, generator=gen)
    m, v, p0 = torch.zeros_like(p), torch.zeros_like(p), p.clone()
    x = torch.tensor(3.0)
    assert roofline._adam_pass(x, p, g, m, v, torch.ones(())) is x
    torch.testing.assert_close(m, 0.1 * g, rtol=1e-6, atol=0)
    torch.testing.assert_close(v, 0.001 * g * g, rtol=1e-6, atol=0)
    torch.testing.assert_close(p, p0 - 1e-3 * g / (g.abs() + 1e-8), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name,peaks", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", (3.35e12, 989e12)),
    ("NVIDIA H100 PCIe", (2.0e12, 756e12)),
    ("NVIDIA H100 NVL", (3.9e12, 835e12)),
    ("NVIDIA H200", (4.8e12, 989e12))])
def test_device_peaks(name, peaks):
    assert roofline.peaks_for(name) == peaks
    assert roofline.device_peaks(name) == (name, peaks[1], peaks[0])
