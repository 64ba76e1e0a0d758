"""Multi-tenant QoS of the port (``qos/`` and ``qos=`` on the port's
``ServingScheduler``) against the JAX package.

The contract is ``tests/test_qos.py``: its registry and DRR units
(``:32-200``) and its scheduler cases (``:242-460``) run here on the
port, on the CPU, its adoption case (``:403``) on the port's page-state
migration included, and its router and sim cases (``:463-792``) on
the port's router, ``SimReplica`` and ``sweep_tenant_weights``; the
flood day gives the same digest and shed counts in both packages. Then
the same tenants, weights, quotas and requests, with the
same parameters, go through the JAX scheduler and the port's, on the
slot ring and on pages: the admission order (tenant, request), the
admission ticks, the cold-page counts and the greedy tokens are equal
(tolerance: none).
"""

import heapq

import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu_torch.qos import (
    DeficitScheduler,
    TenantContract,
    TenantRegistry,
    TokenBucket,
)


# --------------------------------------------------------------------------
# contracts + token buckets (pure)
# --------------------------------------------------------------------------


def test_contract_validation_refuses_by_name():
    with pytest.raises(ValueError, match="SLO class"):
        TenantContract("x", cls="golden")
    with pytest.raises(ValueError, match="weight"):
        TenantContract("x", weight=0.0)
    with pytest.raises(ValueError, match="burst without rate"):
        TenantContract("x", burst=10.0)
    with pytest.raises(ValueError, match="page quota"):
        TenantContract("x", pages=0)
    with pytest.raises(ValueError, match="hedge entitlement"):
        TenantContract("x", hedges=-1)
    reg = TenantRegistry([TenantContract("a")])
    with pytest.raises(ValueError, match="already registered"):
        reg.add(TenantContract("a"))
    with pytest.raises(KeyError, match="unknown tenant 'ghost'"):
        reg.get("ghost")


def test_sheddable_follows_class():
    assert TenantContract("x", cls="batch").sheddable
    assert not TenantContract("x", cls="latency").sheddable
    assert not TenantContract("x", cls="throughput").sheddable


def test_token_bucket_refill_is_pure_in_injected_now():
    b = TokenBucket(10.0, 20.0)
    assert b.take(20, 0.0)          # starts full
    assert not b.take(1, 0.0)       # empty, no time passed
    assert b.take(10, 1.0)          # 10 tokens refilled over 1s
    assert b.level(100.0) == 20.0   # refill caps at burst
    # time never flows backwards through the bucket
    assert b.level(50.0) == 20.0


def test_aggregate_rate_unbounded_when_any_tenant_unlimited():
    reg = TenantRegistry([
        TenantContract("a", rate=10.0), TenantContract("b", rate=5.0),
    ])
    assert reg.aggregate_rate() == 15.0
    reg2 = TenantRegistry([
        TenantContract("a", rate=10.0), TenantContract("b"),
    ])
    assert reg2.aggregate_rate() is None


# --------------------------------------------------------------------------
# DeficitScheduler exactness (pure)
# --------------------------------------------------------------------------


def _drr(weights, **kw):
    reg = TenantRegistry([
        TenantContract(t, weight=w) for t, w in weights.items()
    ])
    return DeficitScheduler(reg, **kw)


def test_weights_two_to_one_admit_exactly_two_to_one():
    """The exactness claim: weights 2:1 over a saturated
    window of uniform requests admit EXACTLY 2:1 — the full pick
    sequence is the weighted rotation a, a, b, ..."""
    drr = _drr({"a": 2.0, "b": 1.0})
    for i in range(12):
        drr.enqueue("a", f"a{i}", 5.0)
        drr.enqueue("b", f"b{i}", 5.0)
    seq = [drr.pick()[0] for _ in range(12)]
    assert seq == ["a", "a", "b"] * 4
    assert seq.count("a") == 2 * seq.count("b")


def test_deficits_carry_while_backlogged():
    """A tenant whose head costs more than one quantum is NOT starved:
    the visit's credit carries and it is served exactly when the
    accumulated deficit covers the cost."""
    drr = _drr({"x": 1.0, "y": 1.0}, quantum_unit=4.0)
    for i in range(3):
        drr.enqueue("x", f"x{i}", 6.0)
        drr.enqueue("y", f"y{i}", 6.0)
    # round 1 grants 4 < 6 to each (deficits carry at 4); round 2
    # grants again: 8 >= 6 serves both, leaving exactly 2
    t, item, c = drr.pick()
    assert (t, item) == ("x", "x0")
    assert drr.deficit("x") == 2.0
    t, item, _ = drr.pick()
    assert (t, item) == ("y", "y0")
    assert drr.deficit("y") == 2.0
    # the carried 2 + one fresh quantum = 6: served with zero credit
    # left — catch-up is exact, never approximate
    assert drr.pick()[1] == "x1"
    assert drr.deficit("x") == 0.0


def test_idle_credit_forfeited_at_reentry_not_at_empty():
    """Credit never survives an idle period — but the forfeit fires
    when the tenant RE-ENTERS the rotation (fresh enqueue onto an
    empty queue), not at the emptying pick, so a restore() of a
    failed pick keeps its exact carry."""
    drr = _drr({"x": 1.0, "y": 1.0}, quantum_unit=100.0)
    drr.enqueue("x", "x0", 1.0)
    drr.enqueue("y", "y0", 1.0)
    assert drr.pick()[0] == "x"
    assert drr.deficit("x") == 99.0  # carried until reentry
    drr.enqueue("x", "x1", 1.0)
    assert drr.deficit("x") == 0.0  # idle time never banks


def test_restore_after_emptying_pick_keeps_carried_credit():
    """The failed-admission contract is exact even when the pick
    emptied the queue: restore() reinstates the pre-pick deficit
    (leftover + refunded cost), so the tenant's catch-up credit never
    silently evaporates on a deferral."""
    drr = _drr({"a": 1.0, "b": 1.0}, quantum_unit=30.0)
    drr.enqueue("a", "a0", 40.0)
    t, item, c = drr.pick()  # two visits accrue 60, serve, 20 left
    assert (t, item) == ("a", "a0") and drr.deficit("a") == 20.0
    drr.restore(t, item, c)
    assert drr.deficit("a") == 60.0  # exactly the pre-pick credit
    # the retry serves from the carry alone, no fresh grant needed
    assert drr.pick()[1] == "a0"
    assert drr.deficit("a") == 20.0


def test_work_conserving_lone_tenant_gets_everything():
    """Idle capacity always serves whoever is queued: a lone
    backlogged tenant is served on every pick regardless of weight."""
    drr = _drr({"x": 0.25, "y": 4.0})
    for i in range(5):
        drr.enqueue("x", i, 100.0)
    assert [drr.pick()[0] for _ in range(5)] == ["x"] * 5
    assert drr.pick() is None


def test_restore_refunds_and_requeues_front():
    drr = _drr({"a": 1.0, "b": 1.0})
    drr.enqueue("a", "a0", 5.0)
    drr.enqueue("a", "a1", 5.0)
    t, item, c = drr.pick()
    assert item == "a0"
    d = drr.deficit("a")
    drr.restore(t, item, c)
    assert drr.deficit("a") == d + c  # charge refunded
    assert drr.total == 2
    assert drr.pick()[1] == "a0"  # front of the queue, not the back


def test_skip_passes_over_tenant_without_charge():
    drr = _drr({"a": 2.0, "b": 1.0})
    drr.enqueue("a", "a0", 5.0)
    drr.enqueue("b", "b0", 5.0)
    t, item, _ = drr.pick(skip={"a"})
    assert (t, item) == ("b", "b0")
    assert drr.backlog("a") == 1
    assert drr.pick()[0] == "a"


def test_unknown_tenant_enqueue_refused_by_name():
    drr = _drr({"a": 1.0})
    with pytest.raises(KeyError, match="unknown tenant 'ghost'"):
        drr.enqueue("ghost", "x", 1.0)


def test_remove_and_clear():
    drr = _drr({"a": 1.0})
    drr.enqueue("a", "a0", 1.0)
    drr.enqueue("a", "a1", 1.0)
    assert drr.remove("a1") and not drr.remove("a1")
    assert drr.total == 1
    drr.clear()
    assert drr.total == 0 and drr.pick() is None


# --------------------------------------------------------------------------
# the scheduler plane (the port's scheduler on the CPU, tiny configs)
# --------------------------------------------------------------------------

from mpistragglers_jl_tpu_torch.models.decode import (  # noqa: E402
    generate_ring_dense,
)
from mpistragglers_jl_tpu_torch.models.serving import (  # noqa: E402
    ServingScheduler as _Scheduler,
)
from mpistragglers_jl_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig,
    init_params,
)

SMALL = dict(vocab=61, d_model=64, n_heads=8, n_kv_heads=2, n_layers=2,
             d_ff=128, attn_window=6)
# wide-window config: horizon Tp + max_new + n_inner fits W=24, so
# requests never wrap and their covered prefix pages are cold-cache
# eligible at retirement (the reclaim scenarios)
WIDE = dict(SMALL, attn_window=24)
CFG = TransformerConfig(**SMALL)
PARAMS = init_params(CFG, seed=11, device="cpu")
WCFG = TransformerConfig(**WIDE)
WPARAMS = init_params(WCFG, seed=13, device="cpu")
RNG = np.random.default_rng(77)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ServingScheduler(*a, **kw):  # noqa: N802  (the contract's name)
    return _Scheduler(*a, device="cpu", **kw)


def _oracle(params, p, n, cfg):
    toks = generate_ring_dense(params, np.asarray(p)[None], n, cfg,
                               device="cpu")
    return [int(t) for t in np.asarray(toks)[0]]


def _prompt(n, vocab=61):
    return RNG.integers(1, vocab, size=n).astype(np.int32)


def _registry(**tenants):
    return TenantRegistry([
        TenantContract(t, **kw) for t, kw in tenants.items()
    ])


def test_scheduler_submit_requires_known_tenant():
    reg = _registry(a={})
    sched = ServingScheduler(PARAMS, CFG, slots=2, n_inner=4,
                             prompt_chunk=8, max_prompt=32, qos=reg)
    with pytest.raises(ValueError, match="needs tenant="):
        sched.submit(_prompt(4), max_new=4)
    with pytest.raises(KeyError, match="unknown tenant 'ghost'"):
        sched.submit(_prompt(4), max_new=4, tenant="ghost")
    with pytest.raises(ValueError, match="at least one TenantContract"):
        ServingScheduler(PARAMS, CFG, slots=2, n_inner=4,
                         prompt_chunk=8, max_prompt=32,
                         qos=TenantRegistry())


def test_qos_streams_match_oracle_token_for_token():
    """Every stream of a mixed-tenant paged qos scheduler equals
    generate_ring_dense."""
    reg = _registry(a=dict(weight=2.0), b=dict(weight=1.0))
    sched = ServingScheduler(PARAMS, CFG, slots=2, n_inner=4,
                             prompt_chunk=8, max_prompt=32,
                             page_tokens=2, qos=reg)
    cases = [(_prompt(3), 9), (_prompt(11), 6), (_prompt(8), 7),
             (_prompt(1), 5), (_prompt(6), 12), (_prompt(9), 4)]
    reqs = [
        sched.submit(p, max_new=n, tenant="a" if i % 2 else "b")
        for i, (p, n) in enumerate(cases)
    ]
    sched.run()
    for req, (p, n) in zip(reqs, cases):
        assert req.tokens == _oracle(PARAMS, p, n, CFG)
    sched.pool.check()


def test_drr_admission_order_two_to_one_on_the_real_scheduler():
    """slots=1 makes admission order observable: uniform queued
    requests from a (weight 2) and b (weight 1) admit a, a, b."""
    reg = _registry(a=dict(weight=2.0), b=dict(weight=1.0))
    sched = ServingScheduler(PARAMS, CFG, slots=1, n_inner=4,
                             prompt_chunk=8, max_prompt=32, qos=reg)
    reqs = []
    for _ in range(6):
        reqs.append(("a", sched.submit(_prompt(4), max_new=4, tenant="a")))
    for _ in range(3):
        reqs.append(("b", sched.submit(_prompt(4), max_new=4, tenant="b")))
    sched.run()
    order = sorted(reqs, key=lambda tr: tr[1].admitted_tick)
    assert [t for t, _ in order] == ["a", "a", "b"] * 3


def test_retired_prefix_pages_go_cold_and_reshare():
    """A retiring request's covered prefix pages stay resident (cold,
    attributed to the tenant) and a later same-prefix admission shares
    them."""
    reg = _registry(a=dict())
    sched = ServingScheduler(WPARAMS, WCFG, slots=2, n_inner=4,
                             prompt_chunk=4, max_prompt=32,
                             page_tokens=4, cache_pages=24, qos=reg)
    p = _prompt(8)  # 2 fully covered pages at P=4
    r1 = sched.submit(p, max_new=4, tenant="a")
    sched.run()
    assert r1.finished
    assert len(sched._cold) == 2
    assert sched._cold_count["a"] == 2
    used_cold = sched.pool.used
    share0 = sched.pool.share_hits
    r2 = sched.submit(p, max_new=4, tenant="a")
    sched.run()
    # the share cap (Tp-1)//P: only the first covered page re-shares
    assert sched.pool.share_hits == share0 + 1
    assert r2.tokens == _oracle(WPARAMS, p, 4, WCFG)
    assert len(sched._cold) == 2 and sched.pool.used == used_cold
    sched.pool.check()


def test_page_quota_defers_tenant_but_never_the_rotation():
    """Tenant b's quota cannot fit two concurrent requests: its second
    request defers while tenant a keeps admitting, and admits once b's
    first retires."""
    reg = _registry(a=dict(weight=1.0), b=dict(weight=1.0, pages=4))
    sched = ServingScheduler(WPARAMS, WCFG, slots=3, n_inner=4,
                             prompt_chunk=4, max_prompt=32,
                             page_tokens=4, cache_pages=32, qos=reg)
    b1 = sched.submit(_prompt(8), max_new=4, tenant="b")
    b2 = sched.submit(_prompt(8, 53), max_new=4, tenant="b")
    a1 = sched.submit(_prompt(8, 47), max_new=4, tenant="a")
    sched.step()
    assert b1.admitted_tick == 1 and a1.admitted_tick == 1
    assert b2.admitted_tick is None
    sched.run()
    assert b2.finished
    assert b2.admitted_tick > 1
    sched.pool.check()


def test_quota_reclaim_never_touches_a_shared_page():
    """Pool pressure evicts COLD refcount-1 pages, never a prefix page a
    live holder pins; then the pool drains to baseline."""
    reg = _registry(a=dict(weight=1.0), c=dict(weight=1.0, pages=12))
    sched = ServingScheduler(WPARAMS, WCFG, slots=4, n_inner=4,
                             prompt_chunk=4, max_prompt=32,
                             page_tokens=4, cache_pages=13, qos=reg)
    shared_prompt = _prompt(8)
    a1 = sched.submit(shared_prompt, max_new=20, tenant="a")
    sched.step()
    a2 = sched.submit(shared_prompt, max_new=20, tenant="a")
    sched.step()
    assert sched.pool.share_hits >= 1
    shared_pids = [int(pid) for pid in sched._pt_host[0][:2]
                   if sched.pool.refcount(int(pid)) > 1]
    assert shared_pids, "the prefix pages must actually be shared"
    for i in range(4):
        sched.submit(_prompt(8, vocab=31 + i), max_new=4, tenant="c")
    for _ in range(40):
        sched.step()
        if all(r.finished for r in (a1, a2)):
            break
    sched.run()
    want = _oracle(WPARAMS, shared_prompt, 20, WCFG)
    assert a1.tokens == want and a2.tokens == want
    sched.pool.check()
    while sched._evict_cold_page():
        pass
    assert sched.pool.used == 0 and sched.pool.reserved == 0
    assert sched._tenant_pages == {} and sched._cold_count == {}
    sched.pool.check()


def test_adoption_reclaims_cold_pages_instead_of_parking():
    """The two-tier liveness contract under qos: an adoption whose
    destination pool is held up by cold pages reclaims them instead of
    refusing (a captured stream is resident nowhere while it waits),
    and the feasibility probe counts that headroom without evicting."""
    reg = _registry(a=dict())
    kw = dict(slots=2, n_inner=4, prompt_chunk=4, max_prompt=32,
              page_tokens=4, qos=reg)
    src = ServingScheduler(WPARAMS, WCFG, cache_pages=24, **kw)
    # destination: 9 usable pages, 4 of them soon cold (2 retired
    # requests x 4 pages each, 2 registered + 2 freed per request)
    dst = ServingScheduler(WPARAMS, WCFG, cache_pages=9, **kw)
    for i in range(2):
        dst.submit(_prompt(8, 41 + i), max_new=4, tenant="a")
        dst.run()
    assert len(dst._cold) == 4 and dst.pool.free < 8
    r = src.submit(_prompt(8, 59), max_new=12, tenant="a")
    for _ in range(3):
        src.step()
    assert r.tokens and not r.finished
    state = src.export_page_state(r)
    cold_before = dict(dst._cold)
    assert dst.can_adopt_state(state)  # reclaim headroom, not a park
    assert dst._cold == cold_before  # the probe evicted nothing
    dst.adopt_page_state(state)  # the adopt itself reclaims
    assert len(dst._cold) < len(cold_before)
    dst.run()
    assert r.finished
    assert r.tokens == _oracle(WPARAMS, state["prompt"], 12, WCFG)
    dst.pool.check()


def test_cancel_returns_quota_everywhere():
    """Cancel at every lifecycle stage returns the tenant's quota:
    queued, mid-admission, decoding."""
    reg = _registry(a=dict(pages=8))
    sched = ServingScheduler(WPARAMS, WCFG, slots=1, n_inner=4,
                             prompt_chunk=4, max_prompt=32,
                             page_tokens=4, cache_pages=24, qos=reg)
    r1 = sched.submit(_prompt(8), max_new=8, tenant="a")
    r2 = sched.submit(_prompt(8, 43), max_new=8, tenant="a")
    assert sched.cancel(r2) and r2.reason == "cancelled"  # queued
    sched.step()
    assert sched.cancel(r1)  # decoding (or mid-admission)
    assert sched._tenant_usage("a") == len(sched._cold)
    while sched._evict_cold_page():
        pass
    assert sched.pool.used == 0
    sched.pool.check()


def test_cancel_mid_admission_returns_quota():
    """A prompt of three chunks is cancelled after its first: the
    committed plan's pages and the tenant's attribution come back."""
    reg = _registry(a=dict(pages=8))
    sched = ServingScheduler(WPARAMS, WCFG, slots=1, n_inner=4,
                             prompt_chunk=4, max_prompt=32,
                             page_tokens=4, cache_pages=24, qos=reg)
    r = sched.submit(_prompt(12), max_new=4, tenant="a")
    sched.step()
    # horizon 12 + 4 + 4 = 20 ring slots: 5 pages of 4
    assert sched._admitting and sched._tenant_usage("a") == 5
    assert sched.cancel(r)
    assert sched._tenant_usage("a") == 0 and sched.pool.used == 0
    sched.pool.check()


def test_qos_series_and_drr_trace_events():
    """The QoS series of ``_ServingObs`` (admissions by tenant and
    class, deficit and quota gauges) and the DRR transitions in the
    request trace."""
    from mpistragglers_jl_tpu_torch.obs import MetricsRegistry, TraceBook

    reg, book = MetricsRegistry(), TraceBook()
    qos = _registry(a=dict(weight=2.0, cls="latency"), b=dict(pages=16))
    sched = ServingScheduler(WPARAMS, WCFG, slots=1, n_inner=4,
                             prompt_chunk=8, max_prompt=32, page_tokens=4,
                             qos=qos, registry=reg, trace=book)
    reqs = [sched.submit(_prompt(6), max_new=3, tenant=t)
            for t in ("a", "b", "a")]
    sched.run()
    snap = reg.snapshot()
    admitted = {(s["labels"]["tenant"], s["labels"]["cls"]): s["value"]
                for s in snap["qos_admitted_total"]["series"]}
    assert admitted == {("a", "latency"): 2, ("b", "throughput"): 1}
    assert {s["labels"]["tenant"] for s in snap["qos_deficit"]["series"]} \
        == {"a", "b"}
    quota = {s["labels"]["tenant"]: s["value"]
             for s in snap["qos_pages_quota_used"]["series"]}
    assert quota == {"a": sched._tenant_usage("a"),
                     "b": sched._tenant_usage("b")}
    kinds = book.kinds(reqs[1].trace)
    assert kinds[0] == "submitted" and "admitted" in kinds
    assert {"drr_queued", "drr_picked"} <= set(kinds), kinds


# --------------------------------------------------------------------------
# across the packages: one QoS setup, both schedulers
# --------------------------------------------------------------------------


def _qos_workload(seed):
    """Three tenants (weights 2, 1, 1; c with a page quota), twelve
    requests of varied prompts and budgets, two sharing one prefix."""
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(1, 61, size=8).astype(np.int32)
    work = []
    for i in range(12):
        tenant = "abc"[i % 3]
        if i in (4, 7):
            p = np.concatenate([sys_prompt, rng.integers(
                1, 61, size=2).astype(np.int32)])
        else:
            p = rng.integers(1, 61, size=int(rng.integers(2, 11))).astype(
                np.int32)
        work.append((tenant, p, int(rng.integers(3, 9))))
    return work


def _admission_spy(sched) -> list:
    """The requests ``sched`` admits, in admission order (several admit
    in one tick, so ``admitted_tick`` alone does not order them)."""
    admitted, real = [], sched._admit_into

    def spy(s, req, plan, retired):
        admitted.append(req)
        return real(s, req, plan, retired)

    sched._admit_into = spy
    return admitted


def _contracts(pkg_qos):
    return pkg_qos.TenantRegistry([
        pkg_qos.TenantContract("a", weight=2.0),
        pkg_qos.TenantContract("b", weight=1.0),
        pkg_qos.TenantContract("c", weight=1.0, pages=8),
    ])


@pytest.mark.parametrize("page_tokens", [None, 4])
def test_admission_order_and_tokens_equal_the_jax_scheduler(page_tokens):
    import jax

    from mpistragglers_jl_tpu import qos as jqos
    from mpistragglers_jl_tpu.models import transformer as jt
    from mpistragglers_jl_tpu.models.serving import (
        ServingScheduler as JaxScheduler,
    )
    from mpistragglers_jl_tpu_torch import qos as tqos
    from mpistragglers_jl_tpu_torch.models.transformer import params_from_jax

    jcfg = jt.TransformerConfig(**WIDE)
    jparams = jt.init_params(jcfg, seed=5)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    kw = dict(slots=2, n_inner=4, prompt_chunk=4, max_prompt=32)
    if page_tokens:
        kw.update(page_tokens=page_tokens, cache_pages=20)
    work = _qos_workload(3)
    out = []
    for sched in (_Scheduler(tparams, WCFG, qos=_contracts(tqos),
                             device="cpu", **kw),
                  JaxScheduler(jparams, jcfg, qos=_contracts(jqos), **kw)):
        admitted = _admission_spy(sched)
        reqs = [(t, i, sched.submit(p, max_new=n, tenant=t))
                for i, (t, p, n) in enumerate(work)]
        index = {id(r): (t, i) for t, i, r in reqs}
        sched.run()
        order = [(*index[id(r)], r.admitted_tick) for r in admitted]
        cold = None
        if page_tokens:
            sched.pool.check()
            cold = (dict(sched._cold_count), sched.pool.share_hits,
                    sched.pool.used)
        out.append((order, [r.tokens for _, _, r in reqs], cold))
    (t_order, t_toks, t_cold), (j_order, j_toks, j_cold) = out
    assert t_order == j_order
    assert t_toks == j_toks
    assert t_cold == j_cold
    # the weighted rotation: a's quantum of 2 admits it first and twice
    assert [t for t, _, _ in t_order[:2]] == ["a", "a"]


# --------------------------------------------------------------------------
# the router + sim plane (numpy-only, virtual time)
# --------------------------------------------------------------------------

from mpistragglers_jl_tpu_torch.models.router import RequestRouter  # noqa: E402
from mpistragglers_jl_tpu_torch.obs import MetricsRegistry  # noqa: E402
from mpistragglers_jl_tpu_torch.obs.flight import FlightRecorder  # noqa: E402
from mpistragglers_jl_tpu_torch.sim import (  # noqa: E402
    SimReplica,
    VirtualClock,
    lognormal_ticks,
    poisson_arrivals,
    run_router_day,
    sweep_tenant_weights,
)

# the flood scenario every headline claim shares: a 4-replica fleet at
# ~70% compliant load, tenant c contracted to ~10% and flooding 10x it
_N_REP, _SLOTS, _NI, _TICK = 4, 4, 8, 0.02
_PLEN, _CHUNK, _MNEW = 96, 64, 32
_AB_RATE, _C_RATE = 70.0, 13.0
_TOK = _PLEN + _MNEW
_EPS_S = 0.05      # pinned isolation epsilon (measured ~0.011)
_UTIL_FLOOR = 0.9  # pinned work-conservation floor (measured ~0.96)


def _flood_registry():
    return TenantRegistry([
        TenantContract("a", cls="latency", weight=4.0, ttft_slo=0.5),
        TenantContract("b", cls="throughput", weight=4.0),
        TenantContract("c", cls="batch", weight=1.0,
                       rate=_C_RATE * _TOK * 1.2,
                       burst=_C_RATE * _TOK * 2.0),
    ])


def _flood_streams(flood: bool):
    """Compliant a+b arrivals are the IDENTICAL stream in both days
    (separate seeded generators merged by time), so the epsilon claim
    compares the same requests under different co-tenant behavior."""
    ab = poisson_arrivals(
        _AB_RATE, n=2100, seed=11, prompt_len=_PLEN, max_new=_MNEW,
        tenants={"a": 0.5, "b": 0.5},
    )
    c = poisson_arrivals(
        _C_RATE * (10 if flood else 1),
        n=3000 if flood else 300, seed=29,
        prompt_len=_PLEN, max_new=_MNEW, tenants={"c": 1.0},
    )
    return heapq.merge(ab, c, key=lambda x: x.t)


def _flood_day(flood: bool, *, qos=True, registry=None, flight=None):
    reg = _flood_registry() if qos else None
    clock = VirtualClock()
    reps = [
        SimReplica(clock, slots=_SLOTS, n_inner=_NI,
                   prompt_chunk=_CHUNK, qos=reg,
                   tick_s=lognormal_ticks(_TICK, 0.2, seed=1009 + i))
        for i in range(_N_REP)
    ]
    router = RequestRouter(reps, policy="least_loaded", clock=clock,
                           qos=reg, registry=registry, flight=flight)
    report = run_router_day(router, _flood_streams(flood))
    util = sum(r.busy_s for r in reps) / (_N_REP * report.virtual_s)
    return report, util, router


def test_tenant_mix_never_moves_arrival_times():
    """The long_share pattern extended: the tenant label rides the
    SAME coin, so arrival times (and prompt classes) are bit-identical
    at every tenant mix, including none."""
    bare = [a.t for a in poisson_arrivals(50, n=400, seed=3)]
    mixed = list(poisson_arrivals(
        50, n=400, seed=3, tenants={"x": 0.6, "y": 0.4}
    ))
    assert bare == [a.t for a in mixed]
    assert {a.tenant for a in mixed} == {"x", "y"}
    with pytest.raises(ValueError, match="sum to 1"):
        list(poisson_arrivals(50, n=4, seed=0,
                              tenants={"x": 0.5, "y": 0.4}))


def test_shed_requests_are_named_and_counted():
    """An over-budget batch tenant's requests come back immediately
    with outcome == "shed": named, counted per tenant+reason in the
    registry, stamped into the flight ring — and never routed."""
    registry = MetricsRegistry()
    flight = FlightRecorder(256)
    report, _, router = _flood_day(
        True, registry=registry, flight=flight
    )
    assert report.n_shed > 500
    assert report.outcomes["shed"] == report.n_shed
    per = report.per_tenant()
    assert per["c"]["shed"] == report.n_shed
    assert per["a"]["shed"] == 0 and per["b"]["shed"] == 0
    shed = [r for r in report.requests if r.outcome == "shed"]
    assert all(r.replica is None and r.tenant == "c" for r in shed)
    prom = registry.to_prometheus()
    assert 'qos_shed_total{reason="budget",tenant="c"}' in prom
    assert 'router_requests_total{' in prom and 'tenant="a"' in prom
    doc = flight.snapshot()
    assert any(
        e.get("name") == "qos shed" for e in doc["traceEvents"]
    ), "shed must stamp a flight instant event"


def test_flood_isolation_epsilon_and_work_conservation_floor():
    """THE acceptance claim: tenant c flooding 10x its token budget
    moves compliant tenants' p99 TTFT by less than the pinned epsilon
    while fleet utilization stays above the work-conservation floor,
    bit-identically across two replays."""
    base, _, _ = _flood_day(False)
    fl1, util, _ = _flood_day(True)
    fl2, _, _ = _flood_day(True)
    assert fl1.digest() == fl2.digest()  # the bit-identity witness
    pb, pf = base.per_tenant(), fl1.per_tenant()
    for t in ("a", "b"):
        shift = abs(pf[t]["p99_ttft_s"] - pb[t]["p99_ttft_s"])
        assert shift < _EPS_S, (
            f"compliant tenant {t} p99 moved {shift * 1e3:.1f}ms "
            f">= the pinned {_EPS_S * 1e3:.0f}ms epsilon"
        )
    assert util >= _UTIL_FLOOR, (
        f"flood-day utilization {util:.3f} under the "
        f"{_UTIL_FLOOR} work-conservation floor"
    )
    assert fl1.dropped == 0


def test_drr_alone_beats_fifo_by_orders_of_magnitude():
    """Even WITHOUT the shed door (no token budgets), the deficit
    rotation bounds the compliant tail: under the same 10x flood,
    FIFO compliant p99 diverges (queues behind c) while DRR holds it
    within a second."""
    reg = TenantRegistry([
        TenantContract("a", weight=4.0),
        TenantContract("b", weight=4.0),
        TenantContract("c", weight=1.0),  # no rate: nothing sheds
    ])

    def day(qos_reg):
        clock = VirtualClock()
        reps = [
            SimReplica(clock, slots=_SLOTS, n_inner=_NI,
                       prompt_chunk=_CHUNK, qos=qos_reg,
                       tick_s=lognormal_ticks(_TICK, 0.2,
                                              seed=1009 + i))
            for i in range(_N_REP)
        ]
        router = RequestRouter(
            reps, policy="least_loaded", clock=clock, qos=qos_reg
        )
        return run_router_day(router, _flood_streams(True))

    drr_day = day(reg)
    fifo_day = day(None)
    for t in ("a", "b"):
        drr_p99 = drr_day.per_tenant()[t]["p99_ttft_s"]
        fifo_p99 = fifo_day.per_tenant()[t]["p99_ttft_s"]
        assert drr_p99 < 1.0 < fifo_p99, (t, drr_p99, fifo_p99)
        assert fifo_p99 / drr_p99 > 10.0


def test_hedge_isolation_entitlement_counted_and_refused():
    """A tenant's hedge_p99 re-dispatches draw from its OWN
    entitlement: outstanding hedge legs never exceed it, dues beyond
    it are refused and counted, and the other tenant's hedges (and
    slots) are untouched."""
    reg = TenantRegistry([
        TenantContract("a", weight=1.0, hedges=1),
        TenantContract("b", weight=1.0),  # unlimited
    ])
    clock = VirtualClock()
    # replica 0 wedged 50x: anything placed there misses the deadline
    reps = [
        SimReplica(clock, slots=2, n_inner=8, prompt_chunk=64,
                   qos=reg, tick_s=1.0 if i == 0 else 0.02)
        for i in range(3)
    ]
    router = RequestRouter(reps, policy="hedge_p99", ttft_slo=0.1,
                           clock=clock, qos=reg)
    rrs = [
        router.submit(96, 8, tenant="a" if i % 2 == 0 else "b")
        for i in range(12)
    ]
    max_out_a = 0
    for _ in range(3000):
        nt = router.next_event_at()
        if nt is None:
            break
        clock.run_until(nt)
        router.step()
        max_out_a = max(max_out_a, router._hedges_out.get("a", 0))
    assert all(r.finished for r in rrs)
    # the entitlement held at every step, and at least one due hedge
    # was refused by it while b's hedges fired freely
    assert max_out_a <= 1
    assert router.n_hedges_refused >= 1
    assert any(r.hedged for r in rrs if r.tenant == "b")
    # refused hedges never became legs: tenant a's extra dispatches
    # are bounded by the entitlement, so b's slots were never squeezed
    assert sum(r.hedged for r in rrs if r.tenant == "a") <= 1


def test_router_submit_requires_known_tenant():
    reg = TenantRegistry([TenantContract("a")])
    clock = VirtualClock()
    reps = [SimReplica(clock, qos=reg)]
    router = RequestRouter(reps, clock=clock, qos=reg)
    with pytest.raises(ValueError, match="needs tenant="):
        router.submit(8, 4)
    with pytest.raises(KeyError, match="unknown tenant 'ghost'"):
        router.submit(8, 4, tenant="ghost")


def test_budget_door_charges_int_prompts_at_full_length():
    """The sim protocol's bare-int prompt means "a prompt of that
    many tokens": the budget door must charge prompt + max_new, not
    np.size(int) == 1 — an undercharge would let a flood through."""
    assert RequestRouter._prompt_tokens(96) == 96
    assert RequestRouter._prompt_tokens(np.int64(96)) == 96
    assert RequestRouter._prompt_tokens(np.arange(7)) == 7
    reg = TenantRegistry([
        TenantContract("c", cls="batch", rate=50.0, burst=104.0),
    ])
    clock = VirtualClock()
    reps = [SimReplica(clock, qos=reg)]
    router = RequestRouter(reps, clock=clock, qos=reg)
    assert router.submit(96, 8, tenant="c").outcome != "shed"
    # the first submit drained the 104-token burst exactly; the next
    # is shed — with the np.size undercharge it would sail through
    assert router.submit(96, 8, tenant="c").outcome == "shed"


def test_non_sheddable_class_is_paced_not_shed():
    """An over-budget latency tenant is never shed: the request
    routes (counted in n_over_budget) and the DRR weight paces it."""
    reg = TenantRegistry([
        TenantContract("a", cls="latency", weight=1.0, rate=100.0,
                       burst=150.0, ttft_slo=1.0),
    ])
    clock = VirtualClock()
    reps = [SimReplica(clock, slots=4, n_inner=8, prompt_chunk=64,
                       qos=reg)]
    router = RequestRouter(reps, clock=clock, qos=reg)
    report = run_router_day(router, poisson_arrivals(
        20.0, n=100, seed=5, prompt_len=64, max_new=16,
        tenants={"a": 1.0},
    ))
    assert report.n_shed == 0
    assert router.n_over_budget > 0
    assert report.outcomes == {"ok": 100}


# --------------------------------------------------------------------------
# sweep_tenant_weights: refusals by name + a working sweep
# --------------------------------------------------------------------------


def _sweep_contracts(lat_slo=2.0, rates=(800.0, 800.0)):
    return [
        TenantContract("lat", cls="latency", weight=1.0,
                       rate=rates[0], ttft_slo=lat_slo),
        TenantContract("bat", cls="batch", weight=1.0, rate=rates[1]),
    ]


def test_sweep_refuses_infeasible_aggregate_budget():
    with pytest.raises(ValueError,
                       match="aggregate token budget.*capacity"):
        sweep_tenant_weights(
            contracts=_sweep_contracts(rates=(50_000.0, 50_000.0)),
            candidates=[{"lat": 1.0, "bat": 1.0}],
            requests=10,
        )


def test_sweep_refuses_latency_class_without_slo():
    contracts = [
        TenantContract("lat", cls="latency", rate=100.0),
        TenantContract("bat", cls="batch", rate=100.0),
    ]
    with pytest.raises(ValueError, match="latency-class tenant "
                                         "'lat' has no ttft_slo"):
        sweep_tenant_weights(
            contracts=contracts,
            candidates=[{"lat": 1.0, "bat": 1.0}], requests=10,
        )


def test_sweep_refuses_unbudgeted_tenant_and_bad_candidates():
    contracts = [
        TenantContract("lat", cls="latency", ttft_slo=1.0),
    ]
    with pytest.raises(ValueError, match="no token budget"):
        sweep_tenant_weights(contracts=contracts,
                             candidates=[{"lat": 1.0}], requests=10)
    with pytest.raises(ValueError, match="must name exactly"):
        sweep_tenant_weights(
            contracts=_sweep_contracts(),
            candidates=[{"lat": 1.0}], requests=10,
        )
    with pytest.raises(ValueError, match="must be > 0"):
        sweep_tenant_weights(
            contracts=_sweep_contracts(),
            candidates=[{"lat": 0.0, "bat": 1.0}], requests=10,
        )


def test_sweep_refuses_when_no_candidate_meets_the_slo():
    with pytest.raises(ValueError,
                       match="no candidate meets every latency"):
        sweep_tenant_weights(
            contracts=_sweep_contracts(lat_slo=1e-6),
            candidates=[{"lat": 1.0, "bat": 1.0}],
            requests=200, seed=0,
        )


def test_sweep_recommends_and_is_deterministic():
    kw = dict(
        contracts=_sweep_contracts(),
        candidates=[{"lat": 1.0, "bat": 1.0},
                    {"lat": 4.0, "bat": 1.0}],
        requests=400, seed=0,
    )
    out1 = sweep_tenant_weights(**kw)
    out2 = sweep_tenant_weights(**kw)
    assert out1["best"] in [c for c in kw["candidates"]]
    assert [e["score"] for e in out1["entries"]] == \
        [e["score"] for e in out2["entries"]]
    assert out1["aggregate_budget_tok_s"] < out1["capacity_tok_s"]


# --------------------------------------------------------------------------
# cross-package: the flood day in both packages
# --------------------------------------------------------------------------


def _xflood(root, flood):
    import importlib

    q = importlib.import_module(root + ".qos")
    sim = importlib.import_module(root + ".sim")
    router_cls = importlib.import_module(root + ".models.router").RequestRouter
    reg = q.TenantRegistry([
        q.TenantContract("a", cls="latency", weight=4.0, ttft_slo=0.5),
        q.TenantContract("b", cls="throughput", weight=4.0),
        q.TenantContract("c", cls="batch", weight=1.0,
                         rate=_C_RATE * _TOK * 1.2,
                         burst=_C_RATE * _TOK * 2.0),
    ])
    clock = sim.VirtualClock()
    reps = [sim.SimReplica(clock, slots=_SLOTS, n_inner=_NI,
                           prompt_chunk=_CHUNK, qos=reg,
                           tick_s=sim.lognormal_ticks(_TICK, 0.2,
                                                      seed=1009 + i))
            for i in range(_N_REP)]
    router = router_cls(reps, policy="least_loaded", clock=clock, qos=reg)
    ab = sim.poisson_arrivals(_AB_RATE, n=700, seed=11, prompt_len=_PLEN,
                              max_new=_MNEW, tenants={"a": 0.5, "b": 0.5})
    c = sim.poisson_arrivals(_C_RATE * (10 if flood else 1),
                             n=1000 if flood else 100, seed=29,
                             prompt_len=_PLEN, max_new=_MNEW,
                             tenants={"c": 1.0})
    rep = sim.run_router_day(router, heapq.merge(ab, c, key=lambda x: x.t))
    return {"digest": rep.digest(), "outcomes": dict(rep.outcomes),
            "shed": dict(rep.shed_reasons),
            "counts": (router.n_shed, router.n_over_budget,
                       router.n_hedges_refused),
            "busy": [r.busy_s for r in reps]}


@pytest.mark.parametrize("flood", [False, True], ids=["calm", "flood"])
def test_flood_day_equal_in_both_packages(flood):
    port = _xflood("mpistragglers_jl_tpu_torch", flood)
    assert port == _xflood("mpistragglers_jl_tpu", flood)
    if flood:
        assert port["outcomes"].get("shed", 0) > 0
