"""Page-state migration in the port (``export_page_state`` /
``adopt_page_state`` on the port's paged ``ServingScheduler`` and
``models/disagg.py``) against the JAX package, on the CPU.

The contract is ``tests/test_disagg.py``: its classes
(``TestMigrationParity``, ``TestMigrationContract``,
``TestCancelMidMigration``, ``TestTwoTierRouter``, ``TestSimTwoTier``)
run here on the port, with the JAX
package's ``generate_ring_dense`` as the oracle over the same weights
(carried over with ``params_from_jax``). Then the port's own risks:
the export hands out new tensors (the source's freed pages are reused
before adoption), adoption never writes a page it shares, the
destination's decode ticks go through the paged kernel route (K6's
plain version here), and tickets cross between the two packages both
ways through ``ticket_to_frames`` meta and segment bytes, a bfloat16
leaf included. Tolerance: none. Streams are token-equal and leaf bytes
are identical.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.models import disagg as jdisagg
from mpistragglers_jl_tpu.models.decode import (
    generate_ring_dense as jax_generate,
)
from mpistragglers_jl_tpu.models.router import RequestRouter as JaxRouter
from mpistragglers_jl_tpu.models.serving import (
    ServingScheduler as JaxScheduler,
)
from mpistragglers_jl_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
    init_params as jax_init_params,
)
from mpistragglers_jl_tpu_torch.models import serving as tserving
from mpistragglers_jl_tpu_torch.models.disagg import (
    DecodeReplica,
    MigrationPlanner,
    MigrationRing,
    MigrationRingReader,
    PrefillWorker,
    ticket_from_frames,
    ticket_to_frames,
)
from mpistragglers_jl_tpu_torch.models.serving import (
    PagePoolExhausted,
    ServingScheduler as _Scheduler,
)
from mpistragglers_jl_tpu_torch.models.router import RequestRouter
from mpistragglers_jl_tpu_torch.models.transformer import (
    TransformerConfig,
    params_from_jax,
)
from mpistragglers_jl_tpu_torch.obs import FlightRecorder, MetricsRegistry
from mpistragglers_jl_tpu_torch.sim import (
    SimReplica,
    VirtualClock,
    poisson_arrivals,
    run_router_day,
    sweep_tier_split,
)
from mpistragglers_jl_tpu_torch.utils import prng

# the contract's configs: W=24 (prefix digests still clean at
# migration time) and W=6 (the wrapped edge)
FIELDS = dict(vocab=61, d_model=64, n_heads=8, n_kv_heads=2, n_layers=2,
              d_ff=128, attn_window=24)
FIELDS6 = dict(FIELDS, attn_window=6)
# head_dim 128, W=128: the paged int8 kernel routes at S >= 4
WIDE = dict(vocab=97, d_model=256, n_heads=2, n_kv_heads=1, n_layers=2,
            d_ff=256, attn_window=128)


def _models(fields, seed, dtype=None):
    jcfg = JaxConfig(**fields, **({} if dtype is None
                                  else {"dtype": dtype[0]}))
    tcfg = TransformerConfig(**fields, **({} if dtype is None
                                          else {"dtype": dtype[1]}))
    jp = jax_init_params(jcfg, seed)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


M = _models(FIELDS, 11)
M6 = _models(FIELDS6, 11)
RNG = np.random.default_rng(61)


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


def _oracle(p, n, *, models=M, **kw):
    jcfg, jp = models[0], models[1]
    toks = jax_generate(jp, jnp.asarray(p)[None], n, jcfg, **kw)
    return [int(t) for t in np.asarray(toks)[0]]


def _sched(*, models=M, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("n_inner", 2)
    kw.setdefault("prompt_chunk", 8)
    kw.setdefault("max_prompt", 64)
    kw.setdefault("page_tokens", 4)
    return _Scheduler(models[3], models[2], device="cpu", **kw)


def _drained(*pools):
    for pool in pools:
        pool.check()
        assert pool.used == 0 and pool.reserved == 0


# --------------------------------------------------------------------------
# token-for-token parity (tests/test_disagg.py TestMigrationParity)
# --------------------------------------------------------------------------


class TestMigrationParity:
    @pytest.mark.parametrize("quantize_kv", [False, True],
                             ids=["fp", "int8"])
    def test_migrated_equals_oracle_at_every_offset(self, quantize_kv):
        p = _prompt(7)
        max_new = 10
        want = _oracle(p, max_new, quantize_kv=quantize_kv)
        for off in range(max_new - 1):
            src = _sched(n_inner=1, quantize_kv=quantize_kv)
            dst = _sched(n_inner=1, quantize_kv=quantize_kv)
            r = src.submit(p, max_new=max_new)
            while len(r.tokens) < 1 + off:
                src.step()
            assert not r.finished
            st = src.export_page_state(r)
            assert dst.can_adopt_state(st)
            dst.adopt_page_state(st)
            dst.run()
            assert r.tokens == want, f"offset {off}"
            _drained(src.pool, dst.pool)

    def test_migrated_equals_oracle_mid_decode_batched(self):
        p = _prompt(11)
        src = _sched(n_inner=4)
        dst = _sched(n_inner=3)
        r = src.submit(p, max_new=17)
        src.step()
        src.step()  # admit + one decode tick
        assert len(r.tokens) > 1 and not r.finished
        dst.adopt_page_state(src.export_page_state(r))
        dst.run()
        assert r.tokens == _oracle(p, 17)
        _drained(src.pool, dst.pool)

    def test_sampled_stream_survives_migration(self):
        """The key travels as its two uint32 words: the sampled
        continuation equals the JAX sampled oracle with the same key."""
        p = _prompt(6)
        want = _oracle(p, 12, temperature=0.8, top_k=5,
                       key=jax.random.key(123))
        src = _sched(temperature=0.8, top_k=5)
        dst = _sched(temperature=0.8, top_k=5)
        r = src.submit(p, max_new=12, key=prng.key(123))
        src.step()
        src.step()
        assert not r.finished
        st = src.export_page_state(r)
        assert st["key_data"].dtype == np.uint32
        np.testing.assert_array_equal(
            st["key_data"], np.asarray(jax.random.key_data(
                jax.random.key(123))))
        dst.adopt_page_state(st)
        dst.run()
        assert r.tokens == want
        _drained(src.pool, dst.pool)

    def test_cow_shared_prefix_survives_migration_int8(self):
        planner = MigrationPlanner()
        pw = PrefillWorker(_sched(quantize_kv=True), planner=planner)
        dr = DecodeReplica(_sched(quantize_kv=True), planner=planner)
        sysp = _prompt(8)
        pa = np.concatenate([sysp, _prompt(3)])
        pb = np.concatenate([sysp, _prompt(3)])
        ra = pw.submit(pa, max_new=20)
        rb = pw.submit(pb, max_new=20)
        moved = set()
        while not (ra.finished and rb.finished):
            pw.step()
            for r in list(pw.ready()):
                if r.id not in moved:
                    moved.add(r.id)
                    t = pw.migrate_out(r)
                    assert dr.can_adopt(t)
                    dr.adopt(t)
            dr.step()
        assert ra.tokens == _oracle(pa, 20, quantize_kv=True)
        assert rb.tokens == _oracle(pb, 20, quantize_kv=True)
        assert dr.pool.share_hits > 0, "chain re-registration lost"
        assert dr.pool.cow_copies > 0, "COW never fired on decode tier"
        _drained(pw.pool, dr.pool)

    def test_wrapped_stream_migrates_without_registration(self):
        src = _sched(models=M6, page_tokens=2)
        dst = _sched(models=M6, page_tokens=2)
        p = _prompt(5)
        r = src.submit(p, max_new=16)
        for _ in range(4):
            src.step()
        assert not r.finished
        st = src.export_page_state(r)
        assert st["n_cover"] == 0  # wrapped: nothing registerable
        dst.adopt_page_state(st)
        dst.run()
        assert r.tokens == _oracle(p, 16, models=M6)
        _drained(src.pool, dst.pool)

    def test_frames_roundtrip_parity_and_pins_drain(self):
        pw, dr = PrefillWorker(_sched()), DecodeReplica(_sched())
        p = _prompt(9)
        r = pw.submit(p, max_new=13)
        while not pw.ready():
            pw.step()
        ring = MigrationRing(slot_bytes=1 << 12, slots=8)
        if ring.region is None:  # pragma: no cover - no memfd
            pytest.skip("memfd_create unavailable")
        ticket = pw.migrate_out(r)
        n_moved = ticket.nbytes
        meta = ticket_to_frames(ticket, ring)
        reader = MigrationRingReader(ring)
        rebuilt = ticket_from_frames(meta, ticket.frames, reader)
        assert rebuilt.nbytes == n_moved
        leg = dr.adopt(rebuilt)
        assert leg is not r  # a fresh request object crossed
        assert list(leg.tokens) == list(r.tokens)
        dr.run()
        assert leg.tokens == _oracle(p, 13)
        ticket.release()
        ticket.release()  # idempotent
        del rebuilt
        gc.collect()
        assert ring.pinned == 0
        _drained(pw.pool, dr.pool)
        ring.close()

    # -- the port's own risks ---------------------------------------------

    @pytest.mark.parametrize("quantize_kv", [False, True],
                             ids=["fp", "int8"])
    def test_export_is_fresh_when_source_pages_are_reused(self,
                                                          quantize_kv):
        """The captured view shares no storage with the pool, and the
        source reusing (and overwriting) the freed pages before the
        adoption changes nothing in the migrated stream."""
        src = _sched(slots=1, quantize_kv=quantize_kv)
        dst = _sched(quantize_kv=quantize_kv)
        p = _prompt(10)
        r = src.submit(p, max_new=12)
        src.step()
        src.step()
        st = src.export_page_state(r)
        pool_ptrs = {a.untyped_storage().data_ptr()
                     for cl in src._caches for a in cl.values()}
        before = [{k: a.clone() for k, a in cl.items()} for cl in st["ring"]]
        for cl in st["ring"]:
            for a in cl.values():
                assert a.untyped_storage().data_ptr() not in pool_ptrs
        other = [src.submit(_prompt(n), max_new=14) for n in (13, 9)]
        src.run()  # the freed pages take the new requests' K/V
        assert all(o.finished for o in other)
        for cl, old in zip(st["ring"], before):
            for k, a in cl.items():
                assert torch.equal(a, old[k])
        dst.adopt_page_state(st)
        dst.run()
        assert r.tokens == _oracle(p, 12, quantize_kv=quantize_kv)
        _drained(src.pool, dst.pool)

    def test_adoption_never_writes_a_shared_page(self):
        """A second stream with the same prefix adopts onto the pages
        the first one holds: those pages' bytes are unchanged by the
        adoption, and the first stream equals its oracle."""
        src = _sched(quantize_kv=True)
        dst = _sched(quantize_kv=True)
        sysp = _prompt(8)
        pa = np.concatenate([sysp, _prompt(3)])
        pb = np.concatenate([sysp, _prompt(2)])
        ra = src.submit(pa, max_new=9)
        rb = src.submit(pb, max_new=9)
        while not (ra.tokens and rb.tokens):
            src.step()
        dst.adopt_page_state(src.export_page_state(ra))
        shared = [int(pid) for pid in dst._pt_host[0][:2]]
        snap = [dst._page_payload(pid) for pid in shared]
        dst.adopt_page_state(src.export_page_state(rb))
        assert [int(pid) for pid in dst._pt_host[1][:2]] == shared
        for pid, old in zip(shared, snap):
            np.testing.assert_array_equal(dst._page_payload(pid), old)
        dst.run()
        assert ra.tokens == _oracle(pa, 9, quantize_kv=True)
        assert rb.tokens == _oracle(pb, 9, quantize_kv=True)
        _drained(src.pool, dst.pool)

    def test_destination_decodes_through_the_paged_kernel_route(
            self, monkeypatch):
        """int8 at head_dim 128 and S=4: every decode tick of the
        destination goes through the paged kernel route (K6; its plain
        version on the CPU) and never through the gather route."""
        wm = _models(WIDE, 31)
        kw = dict(models=wm, slots=4, n_inner=4, prompt_chunk=16,
                  max_prompt=64, page_tokens=16, quantize_kv=True)
        src, dst = _sched(**kw), _sched(**kw)
        assert dst.use_kernel
        calls = {"kernel": 0, "gather": 0}
        real_rows, real_gather = (tserving._paged_attention_rows,
                                  tserving._paged_gather)

        def rows(*a, **k):
            calls["kernel"] += 1
            return real_rows(*a, **k)

        def gather(*a, **k):
            calls["gather"] += 1
            return real_gather(*a, **k)

        p = _prompt(40, 97)
        r = src.submit(p, max_new=20)
        while not r.tokens:
            src.step()
        st = src.export_page_state(r)
        monkeypatch.setattr(tserving, "_paged_attention_rows", rows)
        monkeypatch.setattr(tserving, "_paged_gather", gather)
        dst.adopt_page_state(st)
        dst.run()
        assert calls["gather"] == 0
        assert calls["kernel"] == dst.decode_ticks * 4 * 2  # n_inner, layers
        assert r.tokens == _oracle(p, 20, models=wm, quantize_kv=True)
        _drained(src.pool, dst.pool)


# --------------------------------------------------------------------------
# export/adopt contract edges (TestMigrationContract)
# --------------------------------------------------------------------------


class TestMigrationContract:
    def test_export_refuses_nonmigratable(self):
        s = _sched(prompt_chunk=4)
        q = s.submit(_prompt(5), max_new=8)
        with pytest.raises(ValueError, match="must be decoding"):
            s.export_page_state(q)  # still queued
        a = s.submit(_prompt(16), max_new=8)  # 4 chunks
        s.step()
        with pytest.raises(ValueError, match="must be decoding"):
            s.export_page_state(a)  # mid-admission
        s.run()
        with pytest.raises(ValueError, match="must be decoding"):
            s.export_page_state(a)  # finished

    def test_adopt_refuses_geometry_and_config_mismatch(self):
        src = _sched()
        r = src.submit(_prompt(6), max_new=8)
        src.step()
        st = src.export_page_state(r)
        with pytest.raises(ValueError, match="P mismatch"):
            _sched(page_tokens=2).adopt_page_state(dict(st))
        with pytest.raises(ValueError, match="quantize_kv mismatch"):
            _sched(quantize_kv=True).adopt_page_state(dict(st))
        with pytest.raises(ValueError, match="temperature mismatch"):
            _sched(temperature=0.5).adopt_page_state(dict(st))
        dense = _Scheduler(M[3], M[2], slots=2, n_inner=2, prompt_chunk=8,
                           max_prompt=64, device="cpu")
        with pytest.raises(ValueError, match="unpaged"):
            dense.adopt_page_state(dict(st))
        assert dense.can_adopt_state(dict(st)) is False

    def test_can_adopt_state_is_boolean_on_config_mismatch(self):
        src = _sched()
        r = src.submit(_prompt(6), max_new=8)
        src.step()
        st = src.export_page_state(r)
        for dst in (_sched(page_tokens=2), _sched(quantize_kv=True),
                    _sched(temperature=0.5)):
            assert dst.can_adopt_state(dict(st)) is False
            assert dst.could_adopt_state(dict(st)) is False
        ok = _sched()
        assert ok.can_adopt_state(dict(st)) is True
        assert ok.could_adopt_state(dict(st)) is True

    def test_adopt_refused_when_no_slot_or_pages(self):
        src = _sched()
        r = src.submit(_prompt(6), max_new=8)
        src.step()
        st = src.export_page_state(r)
        dst = _sched()
        b1 = dst.submit(_prompt(5), max_new=30)
        b2 = dst.submit(_prompt(5), max_new=30)
        dst.step()
        assert dst.can_adopt_state(st) is False
        with pytest.raises(PagePoolExhausted):
            dst.adopt_page_state(st)
        tiny = _sched(slots=2, cache_pages=7)  # 6 usable pages
        t1 = tiny.submit(_prompt(5), max_new=30)  # holds all 6
        tiny.step()
        assert tiny.pool.free == 0
        assert tiny.can_adopt_state(st) is False
        with pytest.raises(PagePoolExhausted):
            tiny.adopt_page_state(st)
        for sched, reqs in ((dst, (b1, b2)), (tiny, (t1,))):
            for q in reqs:
                sched.cancel(q)
            _drained(sched.pool)

    def test_migration_nbytes_prices_the_held_pages(self):
        s = _sched(quantize_kv=True)
        r = s.submit(_prompt(7), max_new=8)
        assert s.migration_nbytes(r) == 0  # queued
        s.step()
        n_pages = int(np.sum(s._pt_host[0] != 0))
        # int8 K/V (P, Hkv, D) plus f32 scales (P, Hkv), per layer
        per_page = 2 * (2 * 4 * 2 * 8 + 2 * 4 * 2 * 4)
        assert s._page_row_bytes() == per_page
        assert s.migration_nbytes(r) == n_pages * per_page
        planner = MigrationPlanner()
        assert planner.capture(s, r).nbytes == n_pages * per_page


# --------------------------------------------------------------------------
# the handoff edge (TestCancelMidMigration)
# --------------------------------------------------------------------------


class TestCancelMidMigration:
    def test_cancel_mid_migration_drains_both_pools(self):
        planner = MigrationPlanner()
        pw = PrefillWorker(_sched(), planner=planner)
        dr = DecodeReplica(_sched(), planner=planner)
        base_pw, base_dr = pw.pool.free, dr.pool.free
        r = pw.submit(_prompt(5), max_new=10)
        while not pw.ready():
            pw.step()
        ticket = pw.migrate_out(r)
        assert planner.in_flight == 1
        assert pw.cancel(r) is True
        assert r.finished and r.reason == "cancelled"
        assert ticket._released and planner.in_flight == 0
        assert pw.cancel(r) is False  # idempotent
        assert pw.pool.free == base_pw and dr.pool.free == base_dr
        _drained(pw.pool, dr.pool)
        with pytest.raises(ValueError, match="released"):
            dr.adopt(ticket)

    def test_cancel_after_adoption_releases_destination_pages(self):
        planner = MigrationPlanner()
        pw = PrefillWorker(_sched(), planner=planner)
        dr = DecodeReplica(_sched(), planner=planner)
        base_pw, base_dr = pw.pool.free, dr.pool.free
        r = pw.submit(_prompt(5), max_new=10)
        while not pw.ready():
            pw.step()
        ticket = pw.migrate_out(r)
        leg = dr.adopt(ticket)
        assert planner.in_flight == 0
        assert dr.cancel(leg) is True and leg.reason == "cancelled"
        assert dr.cancel(leg) is False
        ticket.release()  # idempotent post-adoption
        assert pw.pool.free == base_pw and dr.pool.free == base_dr
        _drained(pw.pool, dr.pool)

    def test_per_replica_planners_drain_the_capturing_book(self):
        src_p, dst_p = MigrationPlanner(), MigrationPlanner()
        pw = PrefillWorker(_sched(), planner=src_p)
        dr = DecodeReplica(_sched(), planner=dst_p)
        p = _prompt(5)
        r = pw.submit(p, max_new=10)
        while not pw.ready():
            pw.step()
        ticket = pw.migrate_out(r)
        assert src_p.in_flight == 1 and dst_p.in_flight == 0
        leg = dr.adopt(ticket)
        assert src_p.in_flight == 0 and dst_p.in_flight == 0
        dr.run()
        assert list(leg.tokens) == _oracle(p, 10)
        _drained(pw.pool, dr.pool)

    def test_cancel_mid_migration_with_frames_releases_ring(self):
        planner = MigrationPlanner()
        pw = PrefillWorker(_sched(), planner=planner)
        r = pw.submit(_prompt(5), max_new=10)
        while not pw.ready():
            pw.step()
        ring = MigrationRing(slot_bytes=1 << 12, slots=8)
        if ring.region is None:  # pragma: no cover - no memfd
            pytest.skip("memfd_create unavailable")
        ticket = pw.migrate_out(r)
        ticket_to_frames(ticket, ring)
        assert ring.pinned > 0
        assert pw.cancel(r) is True
        gc.collect()
        assert ring.pinned == 0
        _drained(pw.pool)
        ring.close()


# --------------------------------------------------------------------------
# tickets cross between the packages, both ways
# --------------------------------------------------------------------------


def _segments(reader, frames):
    """Every segment of a framed ticket as private bytes."""
    return [bytes(reader.read_segment(f)) for f in frames]


def _reframe(ring, segs):
    return [ring.send_segment(np.frombuffer(b, np.uint8)) for b in segs]


def _jax_sched(models, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("n_inner", 2)
    kw.setdefault("prompt_chunk", 8)
    kw.setdefault("max_prompt", 64)
    kw.setdefault("page_tokens", 4)
    return JaxScheduler(models[1], models[0], **kw)


BF16 = (jnp.bfloat16, torch.bfloat16)


class TestTicketsCrossPackages:
    @pytest.mark.parametrize("quantize_kv", [False, True],
                             ids=["fp", "int8"])
    def test_jax_ticket_continues_on_the_port(self, quantize_kv):
        """A JAX export, framed by the JAX package, read back by the
        port from the meta and the segment bytes, and adopted: the
        stream equals the JAX oracle."""
        p = _prompt(9)
        js = _jax_sched(M, quantize_kv=quantize_kv)
        jr = js.submit(p, max_new=12)
        js.step()
        js.step()
        jt = jdisagg.MigrationTicket(js.export_page_state(jr))
        jring = jdisagg.MigrationRing(slot_bytes=1 << 12, slots=8)
        meta = jdisagg.ticket_to_frames(jt, jring)
        segs = _segments(jdisagg.MigrationRingReader(jring), jt.frames)
        jt.release()
        ring = MigrationRing(slot_bytes=1 << 12, slots=8)
        rebuilt = ticket_from_frames(meta, _reframe(ring, segs),
                                     MigrationRingReader(ring))
        assert rebuilt.nbytes == jt.nbytes
        dst = _sched(quantize_kv=quantize_kv)
        leg = dst.adopt_page_state(rebuilt.state)
        dst.run()
        assert leg.tokens == _oracle(p, 12, quantize_kv=quantize_kv)
        _drained(dst.pool)
        jring.close()
        ring.close()

    @pytest.mark.parametrize("quantize_kv", [False, True],
                             ids=["fp", "int8"])
    def test_port_ticket_continues_on_jax(self, quantize_kv):
        p = _prompt(9)
        src = _sched(quantize_kv=quantize_kv)
        r = src.submit(p, max_new=12)
        src.step()
        src.step()
        t = MigrationPlanner().capture(src, r)
        ring = MigrationRing(slot_bytes=1 << 12, slots=8)
        meta = ticket_to_frames(t, ring)
        segs = _segments(MigrationRingReader(ring), t.frames)
        t.release()
        jring = jdisagg.MigrationRing(slot_bytes=1 << 12, slots=8)
        rebuilt = jdisagg.ticket_from_frames(
            meta, _reframe(jring, segs), jdisagg.MigrationRingReader(jring))
        js = _jax_sched(M, quantize_kv=quantize_kv)
        leg = js.adopt_page_state(rebuilt.state)
        js.run()
        assert leg.tokens == _oracle(p, 12, quantize_kv=quantize_kv)
        js.pool.check()
        ring.close()
        jring.close()

    def test_bf16_ticket_round_trips_through_the_port_bit_exactly(self):
        """A bf16 JAX ticket is adopted by the port, exported again with
        no decode in between, and adopted back by the JAX package: every
        leaf, bf16 included, comes back bit for bit, and the JAX stream
        equals the never-migrated JAX stream."""
        mb = _models(FIELDS, 11, dtype=BF16)
        p = _prompt(9)
        want = _oracle(p, 12, models=mb)
        js = _jax_sched(mb)
        jr = js.submit(p, max_new=12)
        js.step()
        js.step()
        jt = jdisagg.MigrationTicket(js.export_page_state(jr))
        jring = jdisagg.MigrationRing(slot_bytes=1 << 12, slots=16)
        meta = jdisagg.ticket_to_frames(jt, jring)
        assert meta["layers"][0][0][2] == "bfloat16"
        segs = _segments(jdisagg.MigrationRingReader(jring), jt.frames)
        jt.release()
        ring = MigrationRing(slot_bytes=1 << 12, slots=16)
        rebuilt = ticket_from_frames(meta, _reframe(ring, segs),
                                     MigrationRingReader(ring))
        assert rebuilt.state["ring"][0]["k"].dtype == torch.bfloat16
        port = _sched(models=mb)
        leg = port.adopt_page_state(rebuilt.state)
        back = MigrationPlanner().capture(port, leg)
        meta2 = ticket_to_frames(back, ring)
        assert meta2["layers"] == meta["layers"]
        segs2 = _segments(MigrationRingReader(ring), back.frames)
        back.release()
        # the page rows a ticket carries (the rest of W is the null
        # page's, whatever each pool holds there) are bit-equal
        P, n = meta["P"], meta["n_pages"]
        for i, (a, b) in enumerate(zip(segs[2:], segs2[2:])):
            kk, shape, dtype = meta["layers"][i // 2][i % 2]
            row = len(a) // shape[1]
            assert a[:n * P * row] == b[:n * P * row], (i, kk)
        assert segs2[0] == segs[0]  # the prompt
        # a greedy scheduler reads no key: the port's carries zeros
        assert segs2[1] == bytes(8)
        js2 = _jax_sched(mb)
        jleg = js2.adopt_page_state(jdisagg.ticket_from_frames(
            meta2, _reframe(jring, segs2),
            jdisagg.MigrationRingReader(jring)).state)
        js2.run()
        js.run()
        assert jleg.tokens == want
        _drained(port.pool)
        ring.close()
        jring.close()


# --------------------------------------------------------------------------
# the two-tier router (live wrappers)
# --------------------------------------------------------------------------


class TestTwoTierRouter:
    def test_streams_equal_oracle_and_metrics_export(self):
        reg, fl = MetricsRegistry(), FlightRecorder(256)
        planner = MigrationPlanner()
        fleet = [
            PrefillWorker(_sched(), planner=planner),
            PrefillWorker(_sched(), planner=planner),
            DecodeReplica(_sched(), planner=planner),
            DecodeReplica(_sched(), planner=planner),
        ]
        router = RequestRouter(fleet, policy="two_tier",
                               registry=reg, flight=fl)
        reqs = [
            (router.submit(p, max_new=n), p, n)
            for p, n in [(_prompt(9), 12), (_prompt(5), 8),
                         (_prompt(12), 15), (_prompt(9), 6),
                         (_prompt(3), 10)]
        ]
        router.drain()
        for rr, p, n in reqs:
            assert rr.finished
            assert list(rr.tokens) == _oracle(p, n), rr.id
        assert router.n_migrated > 0
        migrated = [rr for rr, _, _ in reqs if rr.migrated]
        assert migrated
        assert all(rr.outcome == "migrated" for rr in migrated)
        snap = reg.snapshot()
        for name in ("disagg_migrations_total",
                     "disagg_migrated_pages_total",
                     "disagg_migrated_bytes_total",
                     "disagg_migration_seconds",
                     "disagg_tier_depth"):
            assert name in snap, name
        total = sum(s["value"] for s in
                    snap["disagg_migrations_total"]["series"])
        assert total == router.n_migrated
        assert any(
            e.get("name") == "kv migrated"
            for e in fl.dump()["traceEvents"]
        )
        for rep in fleet:
            _drained(rep.pool)

    def test_mismatched_decode_tier_bounces_stream_not_crashes(self):
        """A HETEROGENEOUS decode tier (here: a sampling replica in a
        greedy fleet) can never adopt the stream — its config-checked
        can_adopt/could_adopt answer False, never raise, so the router
        step survives the scan, and the bounce path lands the captured
        stream back on the prefill tier instead of parking it forever
        (the source slot freed, the request resident nowhere). The
        stream completes equal to its oracle and both pools drain."""
        planner = MigrationPlanner()
        pw = PrefillWorker(_sched(), planner=planner)
        dr = DecodeReplica(_sched(temperature=0.5), planner=planner)
        router = RequestRouter([pw, dr], policy="two_tier")
        p = _prompt(9)
        rr = router.submit(p, max_new=12)
        router.drain()
        assert rr.finished
        assert list(rr.tokens) == _oracle(p, 12)
        assert router.n_bounced == 1
        assert router.n_migrated == 1 and rr.migrated
        assert rr.replica == 0  # landed back on the prefill worker
        _drained(pw.pool, dr.pool)

    def test_threshold_keeps_streams_local(self):
        """A migration-size threshold below every payload: nothing
        migrates, streams decode where they prefilled, and they still
        equal their oracles (the graceful keep-local path)."""
        fleet = [PrefillWorker(_sched()), DecodeReplica(_sched())]
        router = RequestRouter(fleet, policy="two_tier",
                               migrate_threshold_bytes=1)
        p = _prompt(9)
        rr = router.submit(p, max_new=8)
        router.drain()
        assert list(rr.tokens) == _oracle(p, 8)
        assert router.n_migrated == 0
        assert router.n_kept_local == 1
        assert not rr.migrated and rr.outcome == "ok"

    def test_fresh_submits_land_on_prefill_tier(self):
        fleet = [PrefillWorker(_sched()), DecodeReplica(_sched())]
        router = RequestRouter(fleet, policy="two_tier")
        rr = router.submit(_prompt(5), max_new=4)
        assert rr.replica == 0  # the prefill replica
        router.drain()
        assert rr.finished


# --------------------------------------------------------------------------
# the sim twin (virtual time, numpy-only fast paths)
# --------------------------------------------------------------------------


def _sim_day(two_tier, *, chunk_s=0.01, n=2000, seed=3, thr=None):
    clock = VirtualClock()
    if two_tier:
        fleet = [
            SimReplica(clock, slots=4, n_inner=8, prompt_chunk=64,
                       tier=("prefill" if i < 2 else "decode"),
                       chunk_s=chunk_s)
            for i in range(6)
        ]
        router = RequestRouter(fleet, policy="two_tier", clock=clock,
                               migrate_gbs=5.2,
                               migrate_threshold_bytes=thr)
    else:
        fleet = [
            SimReplica(clock, slots=4, n_inner=8, prompt_chunk=64,
                       chunk_s=chunk_s)
            for i in range(6)
        ]
        router = RequestRouter(fleet, policy="least_loaded",
                               clock=clock)
    rate = 0.315 * 6 * 4 / (5 * 0.02)
    report = run_router_day(router, poisson_arrivals(
        rate, n=n, seed=seed, prompt_len=64, max_new=32,
        long_share=0.12, long_prompt_len=2048, long_max_new=32,
    ))
    return report, router


class TestSimTwoTier:
    def test_disagg_beats_unified_decode_p99_at_equal_chips(self):
        """The ROADMAP acceptance shape on virtual time: under the
        mixed long-prompt/short-chat day at EQUAL chip count, the
        two-tier fleet's decode p99 (per-request mean inter-token gap)
        beats the unified fleet by >= 1.5x — the long-prompt bursts'
        prefill chunks no longer stretch decode ticks."""
        unified, _ = _sim_day(False)
        disagg, router = _sim_day(True)
        assert unified.dropped == 0 and disagg.dropped == 0
        assert router.n_migrated > 0
        ratio = unified.p99_decode_itl() / disagg.p99_decode_itl()
        assert ratio >= 1.5, ratio

    def test_two_tier_day_bit_identical(self):
        """The run_router_day digest contract holds for two-tier days:
        migrations, transfer pricing and adoption are all virtual-time
        deterministic."""
        a, ra = _sim_day(True, n=4000, seed=9)
        b, rb = _sim_day(True, n=4000, seed=9)
        assert a.digest() == b.digest()
        assert ra.n_migrated == rb.n_migrated > 0
        assert ra.migrated_bytes == rb.migrated_bytes > 0

    def test_adopted_request_skips_prefill_and_carries_residency(self):
        clock = VirtualClock()
        src = SimReplica(clock, slots=2, n_inner=4, prompt_chunk=32,
                         tier="prefill", chunk_s=0.002)
        dst = SimReplica(clock, slots=2, n_inner=4, prompt_chunk=32,
                         tier="decode")
        from mpistragglers_jl_tpu_torch.sim import SimPrompt

        p = SimPrompt(64, prefix=7, prefix_len=32)
        r = src.submit(p, max_new=16)
        clock.run_until(src.next_tick_at); src.step()
        clock.run_until(src.next_tick_at); src.step()
        assert r.n_emitted >= 1 and not r.finished
        before = r.n_emitted
        ticket = src.migrate_out(r)
        assert ticket.nbytes > 0 and ticket.pages > 0
        assert src.active == 0  # slot and residency left with it
        assert src.prefix_hits(p) == 0
        adopted = dst.adopt(ticket)
        assert adopted is r  # in-process stream continuity
        clock.run_until(dst.next_tick_at); dst.step()  # admit, no chunks
        assert dst.prefix_hits(p) > 0  # residency transferred
        assert r.n_emitted == before  # admission tick decodes nothing
        clock.run_until(dst.next_tick_at); dst.step()
        assert r.n_emitted > before  # decode resumed next tick
        while not r.finished:
            clock.run_until(dst.next_tick_at); dst.step()
        assert r.n_emitted == 16

    def test_dead_decode_tier_bounces_parked_migration(self):
        """The decode tier dies while transfers are in flight: the
        parked tickets may never land there, so the router bounces
        them back onto the prefill tier — zero drops, the _evacuate
        contract extended to the mid-migration window. Before the
        bounce (and its next_event_at wake), this day read as
        'workload stalled' with the captured streams resident
        nowhere."""
        clock = VirtualClock()
        pre = SimReplica(clock, slots=4, n_inner=8, prompt_chunk=64,
                         tier="prefill", chunk_s=0.002)
        dec = SimReplica(clock, slots=4, n_inner=8, prompt_chunk=64,
                         tier="decode")
        router = RequestRouter([pre, dec], policy="two_tier",
                               clock=clock, migrate_gbs=1e-4)
        # ~65 resident tokens * 4096 B/token at 1e-4 GB/s ≈ 2.7 s of
        # virtual transfer — the kill at t=1 lands mid-flight
        clock.call_at(1.0, dec.kill)
        report = run_router_day(router, poisson_arrivals(
            2.0, n=5, seed=7, prompt_len=64, max_new=16,
        ))
        assert report.dropped == 0
        assert router.n_bounced >= 1
        assert len(router._migrating) == 0

    def test_migrate_out_refuses_nonmigratable(self):
        clock = VirtualClock()
        rep = SimReplica(clock, slots=1, n_inner=4, tier="prefill")
        from mpistragglers_jl_tpu_torch.sim import SimPrompt

        r = rep.submit(SimPrompt(512), max_new=8)
        with pytest.raises(ValueError, match="decoding"):
            rep.migrate_out(r)  # no first token yet

    def test_sweep_tier_split_refusals_and_recommendation(self):
        with pytest.raises(ValueError, match="leaves a tier empty"):
            sweep_tier_split(splits=[(0, 4)])
        with pytest.raises(ValueError, match="offered load"):
            sweep_tier_split(splits=[(2, 2)], load=1.0)
        with pytest.raises(ValueError,
                           match="no split meets the decode-p99 SLO"):
            sweep_tier_split(splits=[(2, 2)], requests=300,
                             decode_p99_slo_s=1e-9)
        out = sweep_tier_split(
            splits=[(2, 4), (3, 3)], requests=600, seed=2,
            long_share=0.12, long_prompt_len=1024, load=0.7,
        )
        assert out["best"] in [((2, 4), None), ((3, 3), None)]
        assert all(e["migrated"] > 0 for e in out["entries"])
        assert all(e["dropped"] == 0 for e in out["entries"])

    def test_sweep_router_policy_refuses_two_tier(self):
        from mpistragglers_jl_tpu_torch.sim import sweep_router_policy

        with pytest.raises(ValueError, match="sweep_tier_split"):
            sweep_router_policy(policies=("two_tier",), requests=10)

    def test_long_mix_never_moves_arrival_times(self):
        """The long-prompt mix rides the same coin draw as the prefix
        share: arrival times are bit-identical at every mix rate, so
        mixed days stay comparable event-for-event."""
        plain = list(poisson_arrivals(5.0, n=500, seed=4))
        mixed = list(poisson_arrivals(
            5.0, n=500, seed=4, long_share=0.3, long_prompt_len=2048,
            long_max_new=8,
        ))
        assert [a.t for a in plain] == [a.t for a in mixed]
        longs = [a for a in mixed if a.prompt.length == 2048]
        assert longs and all(a.max_new == 8 for a in longs)
        assert any(a.prompt.length == 128 for a in mixed)


def _two_tier_live(which):
    """The same five requests through a two_tier router over two
    PrefillWorkers and two DecodeReplicas of package ``which``."""
    if which == "port":
        router_cls = RequestRouter
        pw_cls, dr_cls, planner = PrefillWorker, DecodeReplica, \
            MigrationPlanner()
        mk = _sched
    else:
        router_cls = JaxRouter
        pw_cls, dr_cls = jdisagg.PrefillWorker, jdisagg.DecodeReplica
        planner = jdisagg.MigrationPlanner()

        def mk():
            return JaxScheduler(M[1], M[0], slots=2, n_inner=2,
                                prompt_chunk=8, max_prompt=64,
                                page_tokens=4)
    fleet = [pw_cls(mk(), planner=planner), pw_cls(mk(), planner=planner),
             dr_cls(mk(), planner=planner), dr_cls(mk(), planner=planner)]
    router = router_cls(fleet, policy="two_tier")
    rng = np.random.default_rng(67)
    reqs = [router.submit(rng.integers(1, 61, n).astype(np.int32),
                          max_new=m)
            for n, m in [(9, 12), (5, 8), (12, 15), (9, 6), (3, 10)]]
    router.drain()
    return ([(rr.replica, rr.outcome, rr.migrated,
              [int(t) for t in rr.tokens]) for rr in reqs],
            router.n_migrated, router.n_kept_local, router.migrated_bytes)


def test_two_tier_live_equal_in_both_packages():
    """The port's two_tier router over the port's tier wrappers and the
    JAX package's over its own migrate the same requests to the same
    decode replicas with the same payload bytes, and the streams are
    token-equal (f32, tolerance none)."""
    port, ref = _two_tier_live("port"), _two_tier_live("jax")
    assert port == ref
    assert port[1] > 0
