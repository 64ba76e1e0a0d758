"""The port's page-pool allocator (mpistragglers_jl_tpu_torch/models/
paging.py) against the JAX package's ``PagePool``, driven through the
op sequences of tests/test_paging.py and a seeded churn fuzz.

Both pools get every operation; each call must return the same value or
raise the same kind of error, and after it free, used and reserved
counts, refcounts and ``stats()`` must be equal. Digests must be
byte-equal.
"""

import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.models import paging as jp
from mpistragglers_jl_tpu_torch.models import paging as tp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs several test
    processes at once, and timing-sensitive tests elsewhere share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Twin:
    """A JAX-package pool and a port pool driven in lockstep."""

    def __init__(self, n_pages, page_tokens):
        self.j = jp.PagePool(n_pages, page_tokens)
        self.t = tp.PagePool(n_pages, page_tokens)

    def __getattr__(self, name):
        def call(*args, **kw):
            out = []
            for pool in (self.j, self.t):
                try:
                    out.append(("ok", getattr(pool, name)(*args, **kw)))
                except (ValueError, RuntimeError) as e:
                    out.append(("raise", type(e).__name__))
            assert out[0] == out[1], (name, args, kw, out)
            self.check_equal()
            if out[0][0] == "raise":
                raise {"PagePoolExhausted": tp.PagePoolExhausted}.get(
                    out[0][1], ValueError)(out[0][1])
            return out[0][1]

        return call

    def check_equal(self):
        j, t = self.j, self.t
        assert (j.free, j.used, j.reserved) == (t.free, t.used, t.reserved)
        assert j.stats() == t.stats()
        assert [j.refcount(p) for p in range(j.n_pages)] == [
            t.refcount(p) for p in range(t.n_pages)]
        assert [j.is_volatile(p) for p in range(1, j.n_pages)] == [
            t.is_volatile(p) for p in range(1, t.n_pages)]
        t.check()


def test_basic_alloc_free_accounting():
    pool = Twin(8, 4)
    pids = [pool.alloc() for _ in range(7)]
    assert tp.NULL_PAGE not in pids and len(set(pids)) == 7
    with pytest.raises(tp.PagePoolExhausted):
        pool.alloc()
    for pid in pids:
        assert pool.decref(pid)
    assert pool.t.free == 7 and pool.t.used == 0


def test_null_page_is_protected():
    pool = Twin(4, 2)
    with pytest.raises(ValueError):
        pool.incref(tp.NULL_PAGE)
    with pytest.raises(ValueError):
        pool.decref(tp.NULL_PAGE)
    for args in ((1, 2), (4, 0)):
        with pytest.raises(ValueError):
            jp.PagePool(*args)
        with pytest.raises(ValueError):
            tp.PagePool(*args)


def test_refcount_sharing_lifecycle():
    pool = Twin(8, 4)
    pid = pool.alloc()
    pool.register(b"digest-0", pid)
    assert pool.lookup(b"digest-0") == pid
    pool.share(pid, reserve=False)
    assert not pool.decref(pid)
    assert pool.lookup(b"digest-0") == pid
    assert pool.decref(pid)
    assert pool.lookup(b"digest-0") is None


def test_register_is_first_wins_and_note_write_unregisters():
    pool = Twin(8, 4)
    a, b = pool.alloc(), pool.alloc()
    pool.register(b"x", a)
    pool.register(b"x", b)
    pool.register(b"y", a)
    assert pool.lookup(b"x") == a and pool.lookup(b"y") is None
    pool.register(b"z", b, volatile=True)
    pool.note_write(b)
    assert pool.lookup(b"z") is None and pool.is_volatile(b)
    pool.decref(b, wrapper=True)
    pool.decref(a)


def test_wrapper_count_and_stranded_reservations():
    pool = Twin(8, 4)
    pid = pool.alloc()
    pool.register(b"p", pid, volatile=True)
    pool.share(pid, reserve=True)
    pool.decref(pid, wrapper=True)
    assert not pool.share_needs_reserve(pid, False)
    pool.share(pid, reserve=False)
    pool.decref(pid)
    pool.decref(pid)
    pid = pool.alloc()
    pool.register(b"q", pid)
    pool.share(pid, reserve=True, wrapper=True)
    assert pool.is_volatile(pid)
    pool.decref(pid, wrapper=True)
    pool.decref(pid)
    assert pool.t.used == 0 and pool.t.reserved == 0


def test_cow_reservation_and_unstealable_free_pages():
    pool = Twin(4, 2)
    pid = pool.alloc()
    pool.register(b"p", pid, volatile=True)
    pool.share(pid, reserve=pool.share_needs_reserve(pid, False))
    extra = pool.alloc()
    with pytest.raises(tp.PagePoolExhausted):
        pool.alloc()  # the last free page is reserved for the COW
    new = pool.cow_alloc(pid)
    assert new not in (pid, extra, tp.NULL_PAGE)
    for p in (pid, pid, new, extra):
        pool.decref(p)
    assert pool.t.used == 0


@pytest.mark.parametrize("P", [1, 3, 4, 16])
def test_prefix_digests_are_byte_identical(P):
    rng = np.random.default_rng(P)
    for n in (0, 2, 17, 64, 100):
        toks = rng.integers(0, 50_000, n).astype(np.int64)
        for cap in (None, 1, 3):
            assert (tp.prefix_page_digests(toks, P, cap)
                    == jp.prefix_page_digests(toks, P, cap))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_churn_matches_reference(seed):
    """Random admit/share/COW/retire interleavings (tests/test_paging.py
    ``test_fuzz_churn_never_leaks``) on both pools at once: equal state
    after every operation, and both drain to empty."""
    rng = np.random.default_rng(seed)
    pool = Twin(33, 4)
    live: list[tuple[list[int], bool]] = []
    for _ in range(600):
        op = rng.integers(0, 4)
        if op == 0 and pool.can_alloc(3, reserve=0):
            wraps = bool(rng.integers(0, 2))
            live.append(([pool.alloc() for _ in range(3)], wraps))
            pool.register(bytes([rng.integers(0, 6)]), live[-1][0][0],
                          volatile=wraps)
        elif op == 1 and live:
            src = live[rng.integers(0, len(live))][0][0]
            wraps = bool(rng.integers(0, 2))
            need = pool.share_needs_reserve(src, wraps)
            if pool.can_alloc(1, reserve=int(need)):
                pool.share(src, reserve=need, wrapper=wraps)
                live.append(([src, pool.alloc()], wraps))
        elif op == 2 and live:
            pids, wraps = live[rng.integers(0, len(live))]
            if wraps:
                if pool.refcount(pids[0]) > 1:
                    try:
                        new = pool.cow_alloc(pids[0])
                    except tp.PagePoolExhausted:
                        # both pools refused alike: a COW'd page this
                        # model shares onward carries no wrapper count,
                        # so its next COW may find no reservation
                        continue
                    pool.decref(pids[0], wrapper=True)
                    pids[0] = new
                else:
                    pool.note_write(pids[0])
        elif op == 3 and live:
            pids, wraps = live.pop(rng.integers(0, len(live)))
            for pid in pids:
                pool.decref(pid, wrapper=wraps)
    for pids, wraps in live:
        for pid in pids:
            pool.decref(pid, wrapper=wraps)
    assert pool.t.used == 0 and pool.t.free == 32 and pool.t.reserved == 0
