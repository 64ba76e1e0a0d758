"""The fleet prefix cache in the port (``cache/`` and ``cache=`` on the
port's paged ``ServingScheduler``) against the JAX package, on the CPU.

The contract is ``tests/test_fleet_cache.py:73-418``. Its primitives
(``TestDirectory``, ``TestPageStore``, ``TestPlanner``) run on both
packages' copies with the same inputs and must behave the same. Its
live path (``TestLiveSpillFetch``) runs on the port's schedulers, with
the JAX package's ``generate_ring_dense`` as the oracle over the same
weights: streams served off spilled-then-fetched or peer-fetched pages
are token-equal to it. The simulator's ``SimFleetCache`` cases
(``:419-563``) are ``ROADMAP.md`` Queue 1 item 12b.

Byte parity of the page payload, the cache's wire and storage format:
on one arena content the port's ``_page_payload`` equals the JAX
scheduler's byte for byte (f32 fp and int8), and each package installs
the other's payload bit-exactly. Pages that each package computes from
the same prompt agree within f32 rounding (K/V within 1e-5 absolute,
int8 codes within one step), not bit for bit: the two packages' f32
matmuls round differently.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpistragglers_jl_tpu.cache as jcache
import mpistragglers_jl_tpu_torch.cache as tcache
from mpistragglers_jl_tpu.models.decode import (
    generate_ring_dense as jax_generate,
)
from mpistragglers_jl_tpu.models.serving import (
    ServingScheduler as JaxScheduler,
)
from mpistragglers_jl_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    init_params as jax_init_params,
)
from mpistragglers_jl_tpu.qos import (
    TenantContract as JContract,
    TenantRegistry as JRegistry,
)
from mpistragglers_jl_tpu_torch.cache import FleetPrefixCache
from mpistragglers_jl_tpu_torch.models.serving import (
    ServingScheduler as _Scheduler,
)
from mpistragglers_jl_tpu_torch.models.transformer import (
    TransformerConfig,
    params_from_jax,
)
from mpistragglers_jl_tpu_torch.obs import MetricsRegistry
from mpistragglers_jl_tpu_torch.qos import (
    TenantContract as TContract,
    TenantRegistry as TRegistry,
)

PKGS = [pytest.param((tcache, TContract, TRegistry), id="port"),
        pytest.param((jcache, JContract, JRegistry), id="jax")]

FIELDS = dict(vocab=61, d_model=64, n_heads=8, n_kv_heads=2, n_layers=2,
              d_ff=128, attn_window=6)
KFIELDS = dict(vocab=97, d_model=256, n_heads=2, n_kv_heads=1, n_layers=2,
               d_ff=256, attn_window=128)


def _models(fields, seed):
    jcfg, tcfg = JaxConfig(**fields), TransformerConfig(**fields)
    jp = jax_init_params(jcfg, seed)
    return jcfg, jp, tcfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                           "cpu")


M = _models(FIELDS, 11)
KM = _models(KFIELDS, 31)
RNG = np.random.default_rng(77)

D1 = b"\x01" * 32
D2 = b"\x02" * 32
D3 = b"\x03" * 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompt(n, vocab=61):
    return RNG.integers(1, vocab, size=n).astype(np.int32)


def _oracle(p, n, *, models=M):
    toks = jax_generate(models[1], jnp.asarray(p)[None], n, models[0])
    return [int(t) for t in np.asarray(toks)[0]]


def _drained(sched):
    sched.pool.check()
    assert sched.pool.used == 0 and sched.pool.reserved == 0


# --------------------------------------------------------------------------
# FleetPageDirectory
# --------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
class TestDirectory:
    def test_publish_locate_dram_first(self, pkg):
        d = pkg[0].FleetPageDirectory()
        d.register_replica("a")
        d.register_replica("store")
        d.publish(D1, replica="a", tier="hbm")
        d.publish(D1, replica="store", tier="dram")
        assert d.locate(D1) == [("store", "dram"), ("a", "hbm")]
        assert d.locate(D1, exclude="a") == [("store", "dram")]
        assert D1 in d and d.size == 1
        d.check()

    def test_replica_drop_invalidates_by_generation(self, pkg):
        d = pkg[0].FleetPageDirectory()
        d.register_replica("a")
        d.publish(D1, replica="a", tier="hbm")
        d.drop_replica("a")
        assert d.locate(D1) == []
        assert D1 not in d
        d.register_replica("a")
        d.publish(D2, replica="a", tier="hbm")
        assert d.locate(D2) == [("a", "hbm")]
        assert d.locate(D1) == []
        assert d.generation("a") == 3
        d.check()

    def test_publish_refusals(self, pkg):
        d = pkg[0].FleetPageDirectory()
        with pytest.raises(ValueError, match="register"):
            d.publish(D1, replica="ghost", tier="hbm")
        d.register_replica("a")
        with pytest.raises(ValueError, match="tier"):
            d.publish(D1, replica="a", tier="tape")

    def test_withdraw_notifies_subscribers(self, pkg):
        d = pkg[0].FleetPageDirectory()
        d.register_replica("a")
        seen = []
        d.subscribe(lambda dg, rep, tier: seen.append((dg, rep, tier)))
        d.publish(D1, replica="a", tier="hbm")
        assert d.withdraw(D1, replica="a", tier="hbm")
        assert not d.withdraw(D1, replica="a", tier="hbm")
        assert seen == [(D1, "a", "hbm")]

    def test_lease_lifecycle(self, pkg):
        d = pkg[0].FleetPageDirectory()
        d.register_replica("a")
        d.publish(D1, replica="a", tier="hbm")
        with d.lease(D1, "a", "hbm"):
            assert d.leased(D1)
        assert not d.leased(D1)
        lease = d.lease(D1, "a", "hbm")
        lease.release()
        lease.release()  # idempotent
        assert not d.leased(D1)
        d.check()


def test_directory_books_equal_across_packages():
    """One sequence of membership, publish, withdraw and drop calls:
    both directories answer every lookup alike and end with the same
    stats."""
    books = []
    for mod in (tcache, jcache):
        d = mod.FleetPageDirectory()
        out = []
        for rep in ("r0", "r1", "store"):
            d.register_replica(rep)
        for i, dg in enumerate((D1, D2, D3)):
            d.publish(dg, replica=f"r{i % 2}", tier="hbm")
            d.publish(dg, replica="store", tier="dram")
        d.withdraw(D2, replica="store", tier="dram")
        d.drop_replica("r0")
        for dg in (D1, D2, D3):
            out.append(d.locate(dg))
            out.append(d.locate(dg, exclude="r1"))
        d.check()
        books.append((out, d.stats()))
    assert books[0] == books[1]


# --------------------------------------------------------------------------
# PageStore
# --------------------------------------------------------------------------


def _page(fill, nbytes=64):
    return np.full(nbytes, fill, dtype=np.uint8)


@pytest.mark.parametrize("pkg", PKGS)
class TestPageStore:
    def test_put_get_roundtrip_zero_copy(self, pkg):
        st = pkg[0].PageStore(64, 4)
        assert st.put(D1, _page(7))
        got = st.get(D1)
        assert got is not None and got.nbytes == 64
        np.testing.assert_array_equal(np.asarray(got), _page(7))
        assert st.get(D2) is None
        assert st.put(D1, _page(9))  # present: True, bytes unchanged
        np.testing.assert_array_equal(np.asarray(st.get(D1)), _page(7))
        st.check()
        st.close()

    def test_geometry_mismatch_refused_by_name(self, pkg):
        st = pkg[0].PageStore(64, 2)
        with pytest.raises(ValueError, match="geometry"):
            st.put(D1, _page(0, nbytes=32))
        st.close()

    def test_capacity_eviction_is_oldest_first(self, pkg):
        d = pkg[0].FleetPageDirectory()
        st = pkg[0].PageStore(64, 2, directory=d)
        st.put(D1, _page(1))
        st.put(D2, _page(2))
        st.put(D3, _page(3))
        assert st.get(D1) is None  # oldest went
        assert st.get(D2) is not None and st.get(D3) is not None
        assert d.locate(D1) == []
        assert st.n_evictions == 1
        st.check()
        st.close()

    def test_leased_page_survives_eviction_pressure(self, pkg):
        d = pkg[0].FleetPageDirectory()
        st = pkg[0].PageStore(64, 2, directory=d)
        st.put(D1, _page(1))
        st.put(D2, _page(2))
        with d.lease(D1, st.name, "dram"):
            st.put(D3, _page(3))
            assert st.get(D1) is not None  # leased: kept
            assert st.get(D2) is None      # next-oldest went instead
        st.check()
        st.close()

    def test_evicted_viewed_slot_bytes_survive_readers(self, pkg):
        st = pkg[0].PageStore(64, 1)
        st.put(D1, _page(5))
        view = st.get(D1)
        assert not st.put(D2, _page(6))  # D1 evicted, slot view-pinned
        assert st.n_refused == 1
        np.testing.assert_array_equal(np.asarray(view), _page(5))
        del view
        gc.collect()
        assert st.put(D2, _page(6))  # last reader gone: slot reusable
        np.testing.assert_array_equal(np.asarray(st.get(D2)), _page(6))
        st.check()
        st.close()

    def test_tenant_spill_quota(self, pkg):
        mod, contract, registry = pkg
        qos = registry([
            contract("bulk", spill_pages=1),
            contract("banned", spill_pages=0),
        ])
        st = mod.PageStore(64, 4, qos=qos)
        assert not st.put(D1, _page(1), tenant="banned")
        assert st.n_refused == 1
        assert st.put(D1, _page(1), tenant="bulk")
        assert st.put(D2, _page(2), tenant="bulk")  # evicts own D1
        assert st.tenant_pages("bulk") == 1
        assert st.get(D1) is None and st.get(D2) is not None
        st.check()
        st.close()


# --------------------------------------------------------------------------
# SpillFetchPlanner
# --------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
class TestPlanner:
    def test_price_is_alpha_plus_bytes_over_rate(self, pkg):
        pl = pkg[0].SpillFetchPlanner(spill_gbs=10.0, fetch_gbs=5.0,
                                      alpha_s=1e-5)
        assert pl.price(1 << 20, "spill") == pytest.approx(
            1e-5 + (1 << 20) / 10e9
        )
        assert pl.price(1 << 20, "fetch_peer") == pytest.approx(
            1e-5 + (1 << 20) / 5e9
        )
        with pytest.raises(ValueError, match="kind"):
            pl.price(1, "teleport")

    def test_plan_batches_per_link_at_batch_bytes(self, pkg):
        mod = pkg[0]
        pl = mod.SpillFetchPlanner(batch_bytes=128)
        moves = [
            mod.PageMove(D1, src="r0", dst="store", nbytes=96,
                         kind="spill"),
            mod.PageMove(D2, src="r0", dst="store", nbytes=96,
                         kind="spill"),
            mod.PageMove(D3, src="r1", dst="r0", nbytes=96,
                         kind="fetch_peer"),
        ]
        batches = pl.plan(moves)
        assert [(b["src"], b["dst"], len(b["moves"])) for b in batches] \
            == [("r0", "store", 1), ("r0", "store", 1), ("r1", "r0", 1)]
        assert pl.planned_batches == 3
        for b in batches:
            assert b["seconds"] > 0.0


def test_planner_prices_equal_across_packages():
    moves = [(D1, "r0", "store", 4096, "spill"),
             (D2, "r0", "store", 300_000, "spill"),
             (D3, "store", "r1", 270_336, "fetch_dram"),
             (D1, "r1", "r0", 270_336, "fetch_peer")]
    got = []
    for mod in (tcache, jcache):
        pl = mod.SpillFetchPlanner(batch_bytes=1 << 19)
        plan = pl.plan([mod.PageMove(d, src=s, dst=t, nbytes=n, kind=k)
                        for d, s, t, n, k in moves])
        got.append(([(b["src"], b["dst"], b["nbytes"], b["seconds"])
                     for b in plan], pl.stats()))
    assert got[0] == got[1]


# --------------------------------------------------------------------------
# live path: spill -> fetch parity against the oracle
# --------------------------------------------------------------------------


def _small_sched(hub, *, registry=None):
    """Requests that do not wrap (Tp=4 + max_new=1 + n_inner=1 <= W=6):
    retired prefix pages are registered non-volatile and spill."""
    return _Scheduler(M[3], M[2], slots=2, n_inner=1, prompt_chunk=2,
                      max_prompt=16, page_tokens=2, registry=registry,
                      cache=hub, device="cpu")


class TestLiveSpillFetch:
    def test_spilled_then_fetched_stream_matches_oracle(self):
        hub = FleetPrefixCache(store_pages=8)
        reg_a, reg_b = MetricsRegistry(), MetricsRegistry()
        p = _prompt(4)
        want = _oracle(p, 1)

        a = _small_sched(hub, registry=reg_a)
        ra = a.submit(p, max_new=1)
        a.run()
        assert ra.tokens == want
        _drained(a)
        assert hub.n_spills >= 1
        assert hub.store.pages >= 1

        b = _small_sched(hub, registry=reg_b)
        rb = b.submit(p, max_new=1)
        b.run()
        assert rb.tokens == want
        _drained(b)
        assert hub.n_fetches["dram"] == 1
        assert reg_b.counter(
            "serving_prefix_share_hits_total", tier="dram"
        ).value == 1
        chunks_a = reg_a.counter("serving_prefill_chunks_total").value
        chunks_b = reg_b.counter("serving_prefill_chunks_total").value
        assert chunks_b < chunks_a
        hub.check()
        hub.close()

    def test_fetch_survives_owner_kill_and_respawn(self):
        hub = FleetPrefixCache(store_pages=8)
        p = _prompt(4)
        want = _oracle(p, 1)

        a = _small_sched(hub)
        name_a = a.cache_name
        ra = a.submit(p, max_new=1)
        a.run()
        assert ra.tokens == want
        assert hub.store.pages >= 1

        hub.kill(name_a)  # owner dies; its hbm entries invalidate
        assert name_a not in hub.members()
        assert a.pool.register_hook is None

        b = _small_sched(hub)  # respawn as a fresh member
        rb = b.submit(p, max_new=1)
        b.run()
        assert rb.tokens == want
        assert hub.n_fetches["dram"] == 1
        assert hub.n_fallbacks == 0
        _drained(b)
        hub.check()
        hub.close()

    def test_peer_fetch_over_migration_ring_matches_oracle(self):
        hub = FleetPrefixCache(store_pages=0)  # peer-only fleet

        def mk():
            return _Scheduler(KM[3], KM[2], slots=2, n_inner=4,
                              prompt_chunk=8, max_prompt=64,
                              page_tokens=16, cache=hub, device="cpu")

        a, b = mk(), mk()
        p = RNG.integers(1, 97, size=40).astype(np.int32)
        want_a = _oracle(p, 40, models=KM)
        want_b = _oracle(p, 8, models=KM)

        ra = a.submit(p, max_new=40)
        while not ra.tokens:  # hold A mid-decode: pages stay resident
            a.step()
        rb = b.submit(p, max_new=8)
        b.run()
        a.run()
        assert ra.tokens == want_a
        assert rb.tokens == want_b
        assert hub.n_fetches["peer"] >= 1
        assert hub.n_fetches["dram"] == 0
        assert hub.n_fallbacks == 0
        _drained(a)
        _drained(b)
        hub.check()
        hub.close()

    def test_partitioned_hub_member_falls_back_to_prefill(self):
        hub = FleetPrefixCache(store_pages=8)
        p = _prompt(4)
        want = _oracle(p, 1)
        a = _small_sched(hub)
        a.submit(p, max_new=1)
        a.run()
        assert hub.store.pages >= 1

        b = _small_sched(hub)
        hub.partition(b.cache_name)
        rb = b.submit(p, max_new=1)
        b.run()
        assert rb.tokens == want  # re-prefilled, not served
        assert hub.n_fetches["dram"] == 0
        _drained(b)

        hub.heal(b.cache_name)
        rc = b.submit(p, max_new=1)
        b.run()
        assert rc.tokens == want
        assert hub.n_fetches["dram"] == 1
        _drained(b)
        hub.close()

    def test_empty_fetch_falls_back_to_prefill_for_the_rest(self,
                                                            monkeypatch):
        """A fetch that comes back empty after the plan (the page was
        evicted in between) stops the fetch run: the rest of the prompt
        prefills, the stream equals the oracle, and the fallback is
        counted."""
        hub = FleetPrefixCache(store_pages=8)
        m24 = _models(dict(FIELDS, attn_window=24), 11)

        def mk():
            return _Scheduler(m24[3], m24[2], slots=2, n_inner=1,
                              prompt_chunk=2, max_prompt=16, page_tokens=2,
                              cache=hub, device="cpu")

        p = _prompt(7)
        want = _oracle(p, 1, models=m24)
        a = mk()
        a.submit(p, max_new=1)
        a.run()
        assert hub.store.pages == 3
        b = mk()
        real = hub.fetch
        calls = []

        def fetch(d, **kw):
            calls.append(d)
            if len(calls) == 2:  # the second page vanished
                hub.store._drop(d, "test")
            return real(d, **kw)

        monkeypatch.setattr(hub, "fetch", fetch)
        rb = b.submit(p, max_new=1)
        b.run()
        assert rb.tokens == want
        assert hub.n_fetches["dram"] == 1 and hub.n_fallbacks == 1
        _drained(b)
        hub.check()
        hub.close()

    def test_cache_refused_without_paged_arena(self):
        hub = FleetPrefixCache()
        with pytest.raises(ValueError, match="page"):
            _Scheduler(M[3], M[2], slots=2, cache=hub, device="cpu")

    def test_geometry_drift_refused_at_attach(self):
        hub = FleetPrefixCache(store_pages=4)
        _small_sched(hub)
        with pytest.raises(ValueError, match="geometry"):
            _Scheduler(KM[3], KM[2], slots=2, prompt_chunk=8,
                       max_prompt=64, page_tokens=16, cache=hub,
                       device="cpu")
        hub.close()


# --------------------------------------------------------------------------
# the page payload against the JAX package's
# --------------------------------------------------------------------------


def _pair(quantize_kv):
    kw = dict(slots=2, n_inner=2, prompt_chunk=8, max_prompt=64,
              page_tokens=4, quantize_kv=quantize_kv)
    wide = dict(FIELDS, attn_window=24)
    jcfg, jp, tcfg, tp = _models(wide, 11)
    js = JaxScheduler(jp, jcfg, **kw)
    ts = _Scheduler(tp, tcfg, device="cpu", **kw)
    p = _prompt(13)
    for s in (js, ts):
        s.submit(p, max_new=6)
        s.step()
        s.step()
    assert list(js._pt_host[0]) == list(ts._pt_host[0])
    return js, ts, [int(pid) for pid in ts._pt_host[0][:3]]


@pytest.mark.parametrize("quantize_kv", [False, True], ids=["fp", "int8"])
def test_page_payload_bytes_equal_jax_on_one_arena(quantize_kv):
    """The port's arena holding the JAX arena's bytes gives the JAX
    payload byte for byte, in the reference's order (layer by layer,
    sorted leaves)."""
    js, ts, pids = _pair(quantize_kv)
    assert ts._page_row_bytes() == js._page_row_bytes()
    for cl, jl in zip(ts._caches, js._caches):
        for kk, a in cl.items():
            a.copy_(torch.from_numpy(np.array(jl[kk])))
    for pid in pids:
        jp_ = np.asarray(js._page_payload(pid))
        tp_ = ts._page_payload(pid)
        assert tp_.dtype == np.uint8 and tp_.shape == jp_.shape
        assert tp_.tobytes() == jp_.tobytes()


@pytest.mark.parametrize("quantize_kv", [False, True], ids=["fp", "int8"])
def test_page_payload_installs_bit_exactly_both_ways(quantize_kv):
    """A JAX payload installed into a port page reads back as the same
    bytes, and a port payload installed into a JAX page likewise; the
    install writes only its page."""
    js, ts, pids = _pair(quantize_kv)
    jpay = np.asarray(js._page_payload(pids[0]))
    tpay = ts._page_payload(pids[1])
    others = {pid: ts._page_payload(pid) for pid in pids[1:]}
    ts._install_page_payload(pids[0], jpay)
    assert ts._page_payload(pids[0]).tobytes() == jpay.tobytes()
    for pid, old in others.items():
        assert ts._page_payload(pid).tobytes() == old.tobytes()
    js._install_page_payload(pids[2], tpay)
    assert np.asarray(js._page_payload(pids[2])).tobytes() == tpay.tobytes()
    with pytest.raises(ValueError, match="bytes"):
        ts._install_page_payload(pids[0], jpay[:-1])


@pytest.mark.parametrize("quantize_kv", [False, True], ids=["fp", "int8"])
def test_computed_pages_agree_within_f32_rounding(quantize_kv):
    """Each package's own prefill of the same prompt: K/V within 1e-5
    absolute (f32), int8 codes within one step and scales within 1e-5
    relative."""
    js, ts, pids = _pair(quantize_kv)
    P = 4
    for cl, jl in zip(ts._caches, js._caches):
        for kk, a in cl.items():
            for pid in pids:
                got = a[pid * P:(pid + 1) * P].double().numpy()
                want = np.asarray(jl[kk][pid * P:(pid + 1) * P],
                                  np.float64)
                if kk in ("k_s", "v_s"):
                    np.testing.assert_allclose(got, want, rtol=1e-5)
                elif quantize_kv:
                    assert np.abs(got - want).max() <= 1
                else:
                    np.testing.assert_allclose(got, want, rtol=0,
                                               atol=1e-5)
