"""Fused K-epoch windows (``parallel/device_coord.py``) of the port,
held to the JAX package's ``tests/test_device_coord.py`` contract on the
CPU, and to the JAX ``DeviceCoordinator`` itself on the same inputs.

The contract, in priority order:

1. **Host-loop parity, bit-equal, per epoch**: the (K, n) ``repochs``
   history a fused window harvests equals, row for row, what the host
   ``asyncmap`` loop produces on a :class:`SimBackend` under the same
   injected-delay schedule, at every K, in-flight state carried across
   window boundaries included.
2. **Decode identity**: the per-epoch decode equals ``A @ B`` within
   1e-9 relative in f64 across K x {mds, lt} x {0, 1 straggler}, the
   hierarchical batched inner + parity outer path under a straggling
   group, and the mesh reduce-scatter path.
3. **Cross-package**: the same A, B, code and schedule through the JAX
   ``DeviceCoordinator`` and the port's, at K in {1, 4, 16} over
   back-to-back windows: ``repochs`` histories and ``epoch_ends``
   bit-equal, the pool's end state equal, decodes within 1e-9
   relative (f64).
4. **sweep_harvest_k** refusals are named refusals, and its timeline is
   the fused window's.
"""

import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu_torch import (
    AsyncPool,
    SimBackend,
    asyncmap,
    asyncmap_fused,
)
from mpistragglers_jl_tpu_torch.obs import MetricsRegistry
from mpistragglers_jl_tpu_torch.ops.coded_gemm import CodedGemm, LTCodedGemm
from mpistragglers_jl_tpu_torch.ops.hierarchical import HierarchicalCodedGemm
from mpistragglers_jl_tpu_torch.parallel import make_mesh
from mpistragglers_jl_tpu_torch.parallel.device_coord import (
    DeviceCoordinator,
    stage_delays,
)
from mpistragglers_jl_tpu_torch.parallel.fused import PoolMeshCodedGemm
from mpistragglers_jl_tpu_torch.sim import sweep_harvest_k
from mpistragglers_jl_tpu_torch.utils import faults

CPU = [torch.device("cpu")]
N, K_CODE = 8, 6
RNG = np.random.default_rng(7)
A = RNG.standard_normal((K_CODE * 3, 16))
B = RNG.standard_normal((16, 5))


def _straggle(base, slow, extra=30.0):
    """``base`` delays with worker ``slow`` permanently +``extra``s."""

    def fn(w, e):
        return base(w, e) + (extra if w == slow else 0.0)

    return fn


def _host_hist(delay_fn, n, nwait, epochs, payload=B):
    """The reference: the REAL asyncmap loop on SimBackend."""
    be = SimBackend(lambda i, p, e: p, n, delay_fn=delay_fn)
    pool = AsyncPool(n)
    hist = np.empty((epochs, n), dtype=np.int64)
    for e in range(epochs):
        hist[e] = asyncmap(pool, payload, be, nwait=nwait).copy()
    return hist, pool


def _rel(got, want) -> float:
    got = np.asarray(got)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# --------------------------------------------------------------------------
# host-loop parity: bit-equal repochs, epoch for epoch, at every K
# --------------------------------------------------------------------------


@pytest.mark.parametrize("window", [1, 8])
@pytest.mark.parametrize("straggler", [None, 2])
def test_repochs_parity_bit_identical(window, straggler):
    delay = faults.seeded_lognormal(0.01, 0.8, seed=5)
    if straggler is not None:
        delay = _straggle(delay, straggler)
    epochs = 48
    host, host_pool = _host_hist(delay, N, K_CODE, epochs)
    cg = CodedGemm(A, N, K_CODE, dtype=np.float64, devices=CPU)
    try:
        coord = cg.coordinator(delay_fn=delay)
        pool = AsyncPool(N)
        fused = np.concatenate([
            asyncmap_fused(pool, B, coord, epochs=window)
            for _ in range(epochs // window)
        ])
        assert np.array_equal(host, fused)
        assert np.array_equal(host_pool.active, pool.active)
        assert np.array_equal(host_pool.sepochs, pool.sepochs)
        assert np.array_equal(host_pool.repochs, pool.repochs)
        assert pool.epoch == host_pool.epoch
        if straggler is not None:
            assert pool.active[straggler]  # still in flight
            assert pool.repochs[straggler] == 0  # never heard from
    finally:
        cg.backend.shutdown()


def test_parity_with_stale_harvest_and_retask():
    """A finite straggler lands mid-later-epoch: the host loop
    stale-harvests and re-tasks it; the fused window must stamp the
    identical stale epochs (phase-3 re-task semantics)."""
    base = faults.seeded_lognormal(0.005, 0.3, seed=11)

    def delay(w, e):
        return base(w, e) + (0.04 if w == 5 else 0.0)

    epochs = 40
    host, _ = _host_hist(delay, N, K_CODE, epochs)
    stale_rows = np.sum(host[1:, 5] < np.arange(2, epochs + 1))
    assert stale_rows > 0
    cg = CodedGemm(A, N, K_CODE, dtype=np.float64, devices=CPU)
    try:
        coord = cg.coordinator(delay_fn=delay)
        pool = AsyncPool(N)
        fused = np.concatenate([
            asyncmap_fused(pool, B, coord, epochs=8)
            for _ in range(epochs // 8)
        ])
        assert np.array_equal(host, fused)
    finally:
        cg.backend.shutdown()


# --------------------------------------------------------------------------
# decode identity: on-device decode == A @ B at every K x code x straggler
# --------------------------------------------------------------------------


@pytest.mark.parametrize("window", [1, 8])
@pytest.mark.parametrize("code", ["mds", "lt"])
@pytest.mark.parametrize("straggler", [None, 2])
def test_decode_identity(window, code, straggler):
    delay = faults.seeded_lognormal(0.01, 0.6, seed=3)
    if code == "mds":
        g = CodedGemm(A, N, K_CODE, dtype=np.float64, devices=CPU)
        nwait = K_CODE
    else:
        g = LTCodedGemm(A, N, K_CODE, seed=1, dtype=np.float64, devices=CPU)
        nwait = N
    try:
        if straggler is not None:
            if code == "lt":
                # pick a straggler whose complement provably decodes
                straggler = next(
                    w for w in range(N)
                    if g.code.peelable(
                        [g.shard_ids[i] for i in range(N) if i != w]
                    )
                )
            delay = _straggle(delay, straggler)
            nwait = N - 1
        coord = g.coordinator(delay_fn=delay, nwait=nwait)
        pool = AsyncPool(N)
        hist = asyncmap_fused(pool, B, coord, epochs=window)
        dec = np.asarray(coord.last_decoded)
        assert dec.shape[0] == window
        for j in range(window):
            assert _rel(dec[j], A @ B) < 1e-9
        if straggler is not None:
            assert np.all(hist[:, straggler] == 0)
    finally:
        g.backend.shutdown()


def test_per_epoch_staged_payloads():
    """An (epochs, d, c) payload stack stages per-epoch inputs up
    front; each epoch decodes against ITS payload."""
    cg = CodedGemm(A, N, K_CODE, dtype=np.float64, devices=CPU)
    try:
        coord = cg.coordinator()
        pool = AsyncPool(N)
        Bs = RNG.standard_normal((4, 16, 5))
        asyncmap_fused(pool, Bs, coord, epochs=4)
        dec = np.asarray(coord.last_decoded)
        for j in range(4):
            assert _rel(dec[j], A @ Bs[j]) < 1e-9
    finally:
        cg.backend.shutdown()


def test_pool_interop_after_window():
    """Harvest leaves ``pool.results``/``repochs`` consistent enough
    that the HOST decode path decodes the same product from the same
    pool: the two coordination modes share one pool contract."""
    cg = CodedGemm(A, N, K_CODE, dtype=np.float64, devices=CPU)
    try:
        coord = cg.coordinator(
            delay_fn=faults.seeded_lognormal(0.01, 0.5, seed=2)
        )
        pool = AsyncPool(N)
        asyncmap_fused(pool, B, coord, epochs=8)
        assert pool.fresh_indices().size >= K_CODE
        assert _rel(cg.result(pool), A @ B) < 1e-9
    finally:
        cg.backend.shutdown()


# --------------------------------------------------------------------------
# hierarchical: batched inner decode + parity outer, in the window
# --------------------------------------------------------------------------


def _hier_fixture(group_straggle: bool):
    H, ni, ki = 3, 4, 3
    n = H * ni
    rng = np.random.default_rng(9)
    Ah = rng.standard_normal(((H - 1) * ki * 2, 10))
    Bh = rng.standard_normal((10, 4))
    base = faults.seeded_lognormal(0.005, 0.5, seed=9)

    def delay(w, e):
        slow = group_straggle and 4 <= w < 8  # host group 1
        return base(w, e) + (50.0 if slow else 0.0)

    hg = HierarchicalCodedGemm(
        Ah, groups=H, n_inner=ni, k_inner=ki, dtype=np.float64,
        device_backend=False, devices=CPU,
    )
    return hg, Ah, Bh, delay, n


@pytest.mark.parametrize("group_straggle", [False, True])
def test_hierarchical_window(group_straggle):
    """The two-level completion rule, the batched inner decode
    (ops/hierarchical.decode_groups) and the parity-outer
    reconstruction all run inside the window: repochs bit-equal to the
    host loop under ``hg.nwait``, and the decode equals A @ B even with
    a whole host group straggling."""
    hg, Ah, Bh, delay, n = _hier_fixture(group_straggle)
    epochs = 16
    be = SimBackend(hg.work, n, delay_fn=delay)
    pool_h = AsyncPool(n)
    host = np.stack([
        asyncmap(pool_h, Bh, be, nwait=hg.nwait).copy()
        for _ in range(epochs)
    ])
    coord = DeviceCoordinator.for_hierarchical(hg, delay_fn=delay)
    pool = AsyncPool(n)
    fused = np.concatenate([
        asyncmap_fused(pool, Bh, coord, epochs=8)
        for _ in range(epochs // 8)
    ])
    assert np.array_equal(host, fused)
    assert _rel(np.asarray(coord.last_decoded)[-1], Ah @ Bh) < 1e-9
    if group_straggle:
        assert np.all(fused[:, 4:8] == 0)


def test_hierarchical_factory_refusals():
    hg, *_ = _hier_fixture(False)
    with pytest.raises(ValueError, match="int nwait does not apply"):
        DeviceCoordinator(
            torch.stack(hg.blocks),
            decode="hierarchical", groups=hg.H, k_inner=hg.k_inner,
            inner_G=hg._inner_G, nwait=9, device="cpu",
        )
    lt_inner = HierarchicalCodedGemm(
        A[: 2 * 3 * 2], groups=3, n_inner=4, k_inner=3, inner="lt",
        dtype=np.float64, device_backend=False, devices=CPU,
    )
    with pytest.raises(ValueError, match="MDS-inner"):
        DeviceCoordinator.for_hierarchical(lt_inner)


# --------------------------------------------------------------------------
# mesh path: replicated recurrence, reduce-scatter decode, return ring
# --------------------------------------------------------------------------


def test_mesh_window():
    base = faults.seeded_lognormal(0.01, 0.7, seed=3)
    delay = _straggle(base, 2)
    mesh = make_mesh(8, devices=["cpu"] * 8)
    fg = PoolMeshCodedGemm(A, mesh, K_CODE, dtype=np.float64)
    try:
        coord = fg.device_coordinator(delay_fn=delay)
        pool = AsyncPool(N)
        fused = asyncmap_fused(pool, B, coord, epochs=6)
        host, _ = _host_hist(delay, N, K_CODE, 6)
        assert np.array_equal(host, fused)
        # the collectives layout: block j on rank j, blocks >= k zero
        dec = coord.full(np.asarray(coord.last_decoded)[-1])
        assert _rel(dec, A @ B) < 1e-9
        # the final epoch's product returned to every rank over the ring
        assert _rel(coord.last_window["last_full"], A @ B) < 1e-9
        # and the same window on the flat path: same repochs, same blocks
        flat = DeviceCoordinator(
            torch.stack(fg.blocks), decode="mds", G=fg.code.G, k=K_CODE,
            delay_fn=delay, device="cpu")
        flat_hist = asyncmap_fused(AsyncPool(N), B, flat, epochs=6)
        assert np.array_equal(flat_hist, fused)
        for j in range(6):
            assert _rel(coord.full(np.asarray(coord.last_decoded)[j]),
                        np.asarray(flat.last_decoded[j])) < 1e-12
    finally:
        fg.shutdown()


def test_mesh_window_refusals():
    mesh = make_mesh(8, devices=["cpu"] * 8)
    fg = PoolMeshCodedGemm(A, mesh, K_CODE, n_workers=16,
                           dtype=np.float64)
    try:
        with pytest.raises(ValueError, match="one worker per mesh"):
            fg.device_coordinator()
    finally:
        fg.shutdown()
    blocks = np.zeros((8, 3, 4))
    with pytest.raises(ValueError, match="flat MDS"):
        DeviceCoordinator(
            blocks, decode="lt", G=np.ones((8, 6)), k=6, nwait=8,
            mesh=mesh,
        )
    with pytest.raises(ValueError, match="1-D"):
        DeviceCoordinator(
            blocks, decode="mds", G=np.ones((8, 6)), k=6,
            mesh=make_mesh((2, 4), ("a", "w"), devices=["cpu"] * 8),
        )
    with pytest.raises(ValueError, match="one worker per device"):
        DeviceCoordinator(
            np.zeros((4, 3, 4)), decode="mds", G=np.ones((4, 3)), k=3,
            mesh=mesh,
        )


# --------------------------------------------------------------------------
# construction / staging / continuation guards
# --------------------------------------------------------------------------


def test_constructor_refusals():
    blocks = np.zeros((N, 3, 4))
    G = np.ones((N, K_CODE))
    kw = {"device": "cpu"}
    with pytest.raises(ValueError, match="nwait=2 must sit in"):
        DeviceCoordinator(blocks, decode="mds", G=G, k=K_CODE, nwait=2, **kw)
    with pytest.raises(ValueError, match="nwait=9 must sit in"):
        DeviceCoordinator(blocks, decode="mds", G=G, k=K_CODE, nwait=9, **kw)
    with pytest.raises(ValueError, match="unknown decode"):
        DeviceCoordinator(blocks, decode="raptor", G=G, k=K_CODE, **kw)
    with pytest.raises(ValueError, match="needs G and k"):
        DeviceCoordinator(blocks, decode="mds", **kw)
    with pytest.raises(ValueError, match="stack"):
        DeviceCoordinator(np.zeros((N, 3)), decode="mds", G=G, k=K_CODE,
                          **kw)


def test_no_card_raises_instead_of_running_on_the_cpu():
    """Without ``device=`` a window over host blocks runs on the card;
    where there is none it raises rather than falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceCoordinator(np.zeros((N, 3, 4)), decode="mds",
                          G=np.ones((N, K_CODE)), k=K_CODE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1)


def test_run_window_guards():
    cg = CodedGemm(A, N, K_CODE, dtype=np.float64, devices=CPU)
    try:
        coord = cg.coordinator()
        pool = AsyncPool(N)
        with pytest.raises(ValueError, match="epochs must be >= 1"):
            coord.run_window(pool, B, epochs=0)
        with pytest.raises(ValueError, match="laid out for"):
            coord.run_window(AsyncPool(4), B, epochs=1)
        with pytest.raises(ValueError, match="carry 3 epochs"):
            coord.run_window(pool, np.zeros((3, 16, 5)), epochs=2)
        busy = AsyncPool(N)
        busy.active[1] = True
        with pytest.raises(ValueError, match="quiescent"):
            coord.run_window(busy, B, epochs=1)
        # a second coordinator editing the pool mid-sequence is refused
        asyncmap_fused(pool, B, coord, epochs=2)
        pool.sepochs[0] += 1
        with pytest.raises(ValueError, match="diverged"):
            coord.run_window(pool, B, epochs=1)
    finally:
        cg.backend.shutdown()


def test_stage_delays_contract():
    d = stage_delays(lambda w, e: -1.0 if w == 0 else w + e, 3, 5, 2)
    assert d.shape == (2, 3)
    assert d[0, 0] == 0.0  # clamped like SimBackend
    assert d[0, 1] == 6.0 and d[1, 2] == 8.0
    assert np.all(stage_delays(None, 4, 0, 3) == 0.0)


def test_reset_forgets_in_flight_state():
    delay = _straggle(faults.seeded_lognormal(0.01, 0.5, seed=1), 3)
    cg = CodedGemm(A, N, K_CODE, dtype=np.float64, devices=CPU)
    try:
        coord = cg.coordinator(delay_fn=delay)
        pool = AsyncPool(N)
        asyncmap_fused(pool, B, coord, epochs=4)
        assert pool.active[3]
        coord.reset()
        for i in np.flatnonzero(pool.active):
            pool.reset_worker(i)  # the elastic-recovery pair
        hist = asyncmap_fused(pool, B, coord, epochs=2)
        assert hist.shape == (2, N)
        assert pool.epoch == 6
    finally:
        cg.backend.shutdown()


# --------------------------------------------------------------------------
# observability (opt-in contract)
# --------------------------------------------------------------------------


class _SpanLog:
    def __init__(self):
        self.spans = []

    def span(self, name, t0, dur, **kw):
        self.spans.append((name, kw))


def test_obs_wiring():
    reg = MetricsRegistry()
    fl = _SpanLog()
    cg = CodedGemm(A, N, K_CODE, dtype=np.float64, devices=CPU)
    try:
        coord = cg.coordinator(registry=reg, flight=fl)
        pool = AsyncPool(N)
        asyncmap_fused(pool, B, coord, epochs=8)
        asyncmap_fused(pool, B, coord, epochs=8)
        assert reg.counter("devcoord_fused_epochs_total").value == 16
        assert reg.counter("devcoord_harvests_total").value == 2
        assert reg.gauge("devcoord_epochs_per_harvest").value == 8
        assert reg.histogram("devcoord_harvest_seconds").count == 2
        assert len(fl.spans) == 2
        assert fl.spans[0][1]["epochs"] == 8
        dark = cg.coordinator()
        asyncmap_fused(AsyncPool(N), B, dark, epochs=2)
        assert dark._m is None
    finally:
        cg.backend.shutdown()


# --------------------------------------------------------------------------
# cross-package: the JAX DeviceCoordinator on the same inputs
# --------------------------------------------------------------------------


def _both(decode, straggler):
    """(jax coordinator factory, port coordinator factory, the JAX and
    the port workload, delay, n, the host loop's nwait, A, B) for one
    code; the two packages build their codes from the same numpy
    inputs."""
    from mpistragglers_jl_tpu.ops import coded_gemm as jcg
    from mpistragglers_jl_tpu.ops import hierarchical as jh
    from mpistragglers_jl_tpu.parallel import device_coord as jdc

    base = faults.seeded_lognormal(0.01, 0.6, seed=13)
    if decode == "hierarchical":
        rng = np.random.default_rng(21)
        Ah = rng.standard_normal((2 * 3 * 2, 10))
        Bh = rng.standard_normal((10, 4))

        def delay(w, e):
            slow = straggler is not None and 4 <= w < 8
            return base(w, e) + (50.0 if slow else 0.0)

        kw = dict(groups=3, n_inner=4, k_inner=3, dtype=np.float64,
                  device_backend=False)
        jg = jh.HierarchicalCodedGemm(Ah, **kw)
        tg = HierarchicalCodedGemm(Ah, devices=CPU, **kw)
        return (
            lambda: jdc.DeviceCoordinator.for_hierarchical(jg, delay_fn=delay),
            lambda: DeviceCoordinator.for_hierarchical(tg, delay_fn=delay),
            jg, tg, delay, 12, tg.nwait, Ah, Bh,
        )
    delay = base if straggler is None else _straggle(base, straggler)
    if decode == "mds":
        jg = jcg.CodedGemm(A, N, K_CODE, dtype=np.float64)
        tg = CodedGemm(A, N, K_CODE, dtype=np.float64, devices=CPU)
        nwait = K_CODE if straggler is None else N - 1
    else:
        jg = jcg.LTCodedGemm(A, N, K_CODE, seed=1, dtype=np.float64)
        tg = LTCodedGemm(A, N, K_CODE, seed=1, dtype=np.float64,
                         devices=CPU)
        nwait = N if straggler is None else N - 1
    return (
        lambda: jg.coordinator(delay_fn=delay, nwait=nwait),
        lambda: tg.coordinator(delay_fn=delay, nwait=nwait),
        jg, tg, delay, N, nwait, A, B,
    )


@pytest.mark.parametrize("straggler", [None, 6])
@pytest.mark.parametrize("decode", ["mds", "lt", "hierarchical"])
def test_windows_equal_the_jax_coordinator(decode, straggler):
    """K in {1, 4, 16} over 16 epochs of back-to-back windows in both
    packages: the same ``repochs`` history, ``epoch_ends`` and pool end
    state bit for bit (and the host loop's), and every epoch's decode
    within 1e-9 relative of the JAX package's (f64)."""
    from mpistragglers_jl_tpu import AsyncPool as JPool
    from mpistragglers_jl_tpu import asyncmap_fused as j_fused

    j_coord, t_coord, jg, tg, delay, n, nwait, Aw, Bw = _both(
        decode, straggler)
    host, host_pool = _host_hist(delay, n, nwait, 16, payload=Bw)
    try:
        for K in (1, 4, 16):
            jc, tc = j_coord(), t_coord()
            jp, tp = JPool(n), AsyncPool(n)
            for w in range(16 // K):
                jh = j_fused(jp, Bw, jc, epochs=K)
                th = asyncmap_fused(tp, Bw, tc, epochs=K)
                assert np.array_equal(jh, th), (K, w)
                assert np.array_equal(th, host[w * K:(w + 1) * K])
                assert np.array_equal(
                    np.asarray(jc.last_window["epoch_ends"]),
                    tc.last_window["epoch_ends"]), (K, w)
                jd = np.asarray(jc.last_decoded)
                td = np.asarray(tc.last_decoded)
                assert td.shape == jd.shape
                assert _rel(td, jd) < 1e-9, (K, w)
            for f in ("repochs", "sepochs", "active"):
                assert np.array_equal(getattr(jp, f), getattr(tp, f)), f
                assert np.array_equal(getattr(tp, f), getattr(host_pool, f))
            assert jp.epoch == tp.epoch == 16
    finally:
        for g in (jg, tg):
            if g.backend is not None:
                g.backend.shutdown()


# --------------------------------------------------------------------------
# sweep_harvest_k: the K sweep priced on virtual time, refusals by name
# --------------------------------------------------------------------------


def _sweep_delay():
    return faults.seeded_lognormal(0.02, 0.6, seed=4)


def test_sweep_harvest_k_prices_the_amdahl_trade():
    out = sweep_harvest_k(
        _sweep_delay(), n_workers=8, nwait=6, epochs=64,
        k_values=(1, 4, 16, 64),
        host_epoch_s=2e-3, host_harvest_s=4e-3,
    )
    ks = [e["K"] for e in out["entries"]]
    assert ks == [1, 4, 16, 64]
    stale = [e["staleness_s"] for e in out["entries"]]
    assert stale == sorted(stale)
    rates = [e["epochs_per_s"] for e in out["entries"]]
    assert rates == sorted(rates)
    assert out["best"] == 64
    assert out["best_entry"]["overhead_x"] > 1.0
    assert out["entries"][0]["n_harvests"] == 64
    assert out["best_entry"]["n_harvests"] == 1
    assert out["host_loop_epochs_per_s"] > 0


def test_sweep_harvest_k_staleness_refusal_by_message():
    with pytest.raises(
        ValueError, match="violates the staleness bound"
    ):
        sweep_harvest_k(
            _sweep_delay(), n_workers=8, nwait=6, epochs=64,
            k_values=(1, 64), staleness_bound_s=0.2,
        )
    out = sweep_harvest_k(
        _sweep_delay(), n_workers=8, nwait=6, epochs=64,
        k_values=(1, 2), staleness_bound_s=1e6,
    )
    assert out["best"] == 2


def test_sweep_harvest_k_window_refusals_by_message():
    with pytest.raises(
        ValueError, match="must cover at least 1 epoch"
    ):
        sweep_harvest_k(
            _sweep_delay(), n_workers=8, nwait=6, epochs=16,
            k_values=(0, 4),
        )
    with pytest.raises(ValueError, match="exceeds the 16-epoch run"):
        sweep_harvest_k(
            _sweep_delay(), n_workers=8, nwait=6, epochs=16,
            k_values=(4, 32),
        )
    with pytest.raises(ValueError, match="nwait must be in"):
        sweep_harvest_k(
            _sweep_delay(), n_workers=8, nwait=9, epochs=16,
            k_values=(4,),
        )


@pytest.mark.parametrize("K", [4, 16])
def test_sweep_harvest_k_agrees_with_real_windows(K):
    """The sweep's per-K windows are the fused window's: on the same
    schedule, each real window's virtual span equals the sweep's
    window (summed walls against a difference of absolute times, so
    within 1e-12 relative), and the mean and max agree."""
    delay = _sweep_delay()
    out = sweep_harvest_k(delay, n_workers=8, nwait=6, epochs=32,
                          k_values=(K,))
    entry = out["entries"][0]
    cg = CodedGemm(A, N, K_CODE, dtype=np.float64, devices=CPU)
    try:
        coord = cg.coordinator(delay_fn=delay)
        pool = AsyncPool(N)
        spans = []
        for _ in range(32 // K):
            asyncmap_fused(pool, B, coord, epochs=K)
            spans.append(coord.last_window["virtual_s"])
    finally:
        cg.backend.shutdown()
    assert entry["n_harvests"] == len(spans)
    assert np.isclose(entry["window_max_s"], max(spans), rtol=1e-12)
    assert np.isclose(entry["window_mean_s"], np.mean(spans), rtol=1e-12)
    assert np.isclose(out["virtual_s"], sum(spans), rtol=1e-12)
