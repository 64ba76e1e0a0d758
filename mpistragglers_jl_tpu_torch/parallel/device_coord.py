"""Device-resident coordination: fused K-epoch windows that take the
host off the epoch hot path.

The port of the JAX package's ``parallel/device_coord.py``. Every epoch
of the host ``asyncmap`` loop (pool.py) re-enters the interpreter:
dispatch bookkeeping, arrival stamping, the decode trigger. This module
inverts the control flow, per the numba-mpi frame (arxiv 2407.13712:
coordination issued from inside compiled code, no interpreter on the
critical path):

* a :class:`DeviceCoordinator` runs **K epochs** of the pool state
  machine as ONE program on the coordinator's device, in which the
  per-shard **arrival masks**, the **fastest-``nwait`` selection** and
  the **MDS / LT / hierarchical decode** all run on the device. On the
  card the program is a loop over device tensors with no host sync,
  captured once per window shape into a ``torch.cuda.CUDAGraph`` and
  replayed per window (the counterpart of one compiled ``lax.scan``
  per window); on the CPU the same loop runs eagerly;
* the host's role collapses to **stage + harvest**: it stages the
  payloads and the window's injected-delay schedule once per window,
  and harvests the ``repochs`` history and the decoded products every
  K epochs;
* the K-epoch harvest cadence is priced on virtual time by
  :func:`~..sim.tune.sweep_harvest_k`.

``repochs`` semantics are preserved **exactly**: the in-window arrival
recurrence performs, step for step and in float64, the arithmetic the
host loop performs against a :class:`~..sim.backend.SimBackend`:

* epoch ``e`` opens at ``T`` (the previous completion time); in-flight
  arrivals ``<= T`` are drained stale (phase 1), every idle worker is
  dispatched at ``T`` (phase 2);
* each worker's *fresh-arrival candidate* is ``T + d[e, w]`` if it was
  just dispatched, else ``a_w + d[e, w]`` (its stale in-flight result
  lands at ``a_w`` and the worker is re-tasked at once, the
  reference's phase-3 stale harvest, src/MPIAsyncPools.jl:177-184);
* the epoch completes at the ``nwait``-th smallest candidate (or, for
  the hierarchical predicate, at the first sorted prefix whose arrived
  group set clears the outer floor); winners are stamped fresh, stale
  arrivals before completion are stamped with their dispatch epoch,
  and everyone else stays in flight **across the window boundary**,
  exactly as the host loop leaves them.

The same IEEE additions and comparisons give the same bits on the card
and on the CPU, so a window's ``repochs`` equal the host loop's bit for
bit on the same schedule (tests/test_torch_device_coord.py). The
per-epoch decode consumes only shards with ``repochs == epoch``,
selected first-k in worker-index order (``fresh_indices`` order).

Fidelity caveats, as in the reference:

* delays are **virtual seconds** staged up front; on real hardware a
  fused window has no per-worker arrival information inside the
  program, so production windows run ``nwait = n`` semantics with a
  zero schedule;
* exact ties between arrival times resolve by worker index here and by
  dispatch order in the host loop;
* ``timeout=``/``DeadWorkerError`` and ``tracer=`` are host-loop
  concerns a fused window cannot express; ``flight=`` records harvest
  spans instead.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .._device import resolve_device
from ..backends.base import DelayFn
from ..ops._batch import (
    _stacked_matmul,
    as_tensor,
    check_precision,
    matmul,
    operand_dtype,
)
from ..ops.coding import _decode, _lu_solve
from ..ops.hierarchical import decode_groups
from ..pool import AsyncPool
from .collectives import reduce_scatter, ring_pass
from .mesh import Mesh, PartitionSpec, from_local, shard

__all__ = ["DeviceCoordinator", "stage_delays"]


def stage_delays(
    delay_fn: DelayFn | None, n: int, epoch0: int, epochs: int
) -> np.ndarray:
    """Host-side staging of the window's injected-delay schedule: the
    (epochs, n) virtual round-trip each (epoch, worker) dispatch would
    pay, ``delay_fn(worker, epoch)`` clamped at 0 exactly like
    :class:`~..sim.backend.SimBackend` clamps it. ``None`` stages
    zeros (the production no-injection schedule)."""
    d = np.zeros((int(epochs), int(n)), dtype=np.float64)
    if delay_fn is not None:
        for j in range(int(epochs)):
            e = int(epoch0) + j
            for w in range(int(n)):
                d[j, w] = max(float(delay_fn(w, e)), 0.0)
    return d


class _GraphWindow:
    """One window shape's program captured into a CUDA graph: static
    input buffers, captured once at the first call, then each call
    copies its inputs in and replays. A failed capture raises; it never
    falls back to the eager loop."""

    def __init__(self, fn, device: torch.device):
        self.fn = fn
        self.device = device
        self.graph = None
        self.static_in = None
        self.static_out = None

    def _capture(self, args) -> None:
        self.static_in = [a.clone() for a in args]
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            # warm-up: the solver and BLAS handles and workspaces exist
            # before capture
            self.fn(*self.static_in)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self.static_out = self.fn(*self.static_in)
        except Exception as e:
            raise RuntimeError(
                "capturing the fused window into a CUDA graph failed; "
                "the window does not fall back to the eager loop"
            ) from e
        self.graph = graph

    def __call__(self, *args):
        if self.graph is None:
            self._capture(args)
        for s, a in zip(self.static_in, args):
            s.copy_(a)
        self.graph.replay()
        return self.static_out


class DeviceCoordinator:
    """Fused K-epoch coordination for a coded-GEMM-style workload.

    Worker ``w`` owns coded block ``blocks[w]`` (an (n, r, d) stack);
    each epoch every worker computes ``blocks[w] @ payload`` (one
    stacked product at the coordinator's precision) and the on-device
    recurrence decides, from the staged delay schedule, which arrivals
    are fresh, which are stale-harvested and re-tasked, and when the
    epoch completes. The per-epoch decode consumes only the fresh mask:

    * ``decode="mds"``: first-k fresh shards in index order, one
      ``k x k`` solve (``ops/coding.py`` ``_decode``);
    * ``decode="lt"``: masked normal equations over ALL fresh rows of
      the 0/1 generator (exact whenever the fresh set has full column
      rank; the host peeling path stays the arbiter for exotic sets);
    * ``decode="hierarchical"``: ALL groups' inner ``k_inner x
      k_inner`` MDS solves as one batched solve
      (:func:`~..ops.hierarchical.decode_groups`), then the rate-(H-1)/H
      parity outer pass reconstructs at most one missing source group;
      completion is the first arrival prefix whose arrived-group set
      clears the outer floor.

    ``mesh=`` (a 1-D pool mesh, one worker per rank) runs the same
    recurrence replicated on every rank's device and decodes by the
    masked weighted combine of parallel/collectives.py: one
    reduce-scatter per epoch places source block j on rank j, and the
    last epoch's blocks ride the ring all-gather back to every rank.
    It runs eagerly; the flat path is the one captured into a graph.

    ``device=`` is where a flat window runs: the blocks' device when
    they are a tensor, else the card (``_device.resolve_device``).
    ``backend=`` (a :class:`~..backends.cuda.CUDADeviceBackend`) routes
    window execution through the backend's multi-epoch dispatch
    (``submit_window``). ``registry=`` / ``flight=`` follow the
    package's opt-in contract: ``devcoord_fused_epochs_total``,
    ``devcoord_harvests_total``, ``devcoord_harvest_seconds`` and
    ``devcoord_epochs_per_harvest``.
    """

    def __init__(
        self,
        blocks,
        *,
        decode: str = "mds",
        G=None,
        k: int | None = None,
        groups: int | None = None,
        k_inner: int | None = None,
        inner_G=None,
        nwait: int | None = None,
        mesh: Mesh | None = None,
        axis: str = "w",
        delay_fn: DelayFn | None = None,
        precision: str = "highest",
        backend=None,
        registry=None,
        flight=None,
        device=None,
    ):
        if isinstance(blocks, (list, tuple)):
            blocks = torch.stack([as_tensor(b) for b in blocks])
        blocks = as_tensor(blocks)
        if blocks.dim() != 3:
            raise ValueError(
                f"blocks must be an (n, rows, d) stack, got "
                f"{tuple(blocks.shape)}"
            )
        self.n = int(blocks.shape[0])
        self.block_rows = int(blocks.shape[1])
        self.decode = str(decode)
        self.precision = check_precision(precision)
        self.delay_fn = delay_fn
        self._backend = backend
        self.mesh = mesh
        self.axis = axis
        n = self.n
        if self.decode in ("mds", "lt"):
            if G is None or k is None:
                raise ValueError(f"decode={decode!r} needs G and k")
            G = np.asarray(as_tensor(G).cpu(), dtype=np.float64)
            if G.shape[0] != n:
                raise ValueError(
                    f"G has {G.shape[0]} rows but the stack holds "
                    f"{n} worker blocks"
                )
            self.k = int(k)
            self.G = G
            if nwait is None:
                nwait = self.k
            if not (self.k <= int(nwait) <= n):
                raise ValueError(
                    f"nwait={nwait} must sit in [k={self.k}, n={n}]: "
                    "fewer than k fresh shards cannot decode, and a "
                    "fused window cannot wait for more workers than "
                    "exist"
                )
            self.nwait = int(nwait)
            self._out_rows = self.k * self.block_rows
        elif self.decode == "hierarchical":
            if groups is None or k_inner is None or inner_G is None:
                raise ValueError(
                    "decode='hierarchical' needs groups, k_inner and "
                    "inner_G"
                )
            self.H = int(groups)
            if self.H < 2 or n % self.H != 0:
                raise ValueError(
                    f"{n} workers do not partition into {groups} "
                    "contiguous groups of >= 1 (parity outer needs "
                    "H >= 2)"
                )
            self.n_inner = n // self.H
            self.k_inner = int(k_inner)
            if not (0 < self.k_inner <= self.n_inner):
                raise ValueError(
                    f"need 0 < k_inner <= n_inner, got k_inner="
                    f"{k_inner}, n_inner={self.n_inner}"
                )
            self.L = self.H - 1  # rate-(H-1)/H parity outer
            inner_G = as_tensor(inner_G)
            if inner_G.shape[0] != self.n_inner:
                raise ValueError(
                    f"inner_G has {inner_G.shape[0]} rows but groups "
                    f"hold {self.n_inner} workers"
                )
            self.inner_G = inner_G
            if nwait is not None:
                raise ValueError(
                    "hierarchical windows complete on the two-level "
                    "predicate (inner floor per group, outer floor "
                    "across groups) — int nwait does not apply"
                )
            self.nwait = None
            self._out_rows = self.L * self.k_inner * self.block_rows
        else:
            raise ValueError(
                f"unknown decode {decode!r}; choose mds | lt | "
                "hierarchical"
            )
        if mesh is not None:
            if self.decode != "mds":
                raise ValueError(
                    "mesh windows implement the flat MDS reduce-scatter "
                    f"decode; decode={decode!r} runs on the mesh=None "
                    "path"
                )
            if len(mesh.axis_names) != 1 or mesh.axis_names[0] != axis:
                raise ValueError(
                    f"device windows need a 1-D ({axis!r},) pool mesh, "
                    f"got {mesh.axis_names}"
                )
            if mesh.shape[axis] != n:
                raise ValueError(
                    f"mesh axis holds {mesh.shape[axis]} devices but "
                    f"the stack holds {n} worker blocks (one worker "
                    "per device)"
                )
            self.devices = mesh.axis_devices(axis)
            self.device = self.devices[0]
            # placed once: worker i's coded block lives on rank i for
            # every window this coordinator ever runs
            op = operand_dtype(blocks.dtype, self.precision)
            self._blocks = shard(blocks.to(op), mesh, PartitionSpec(axis))
        else:
            if device is None and blocks.device.type != "cpu":
                device = blocks.device
            self.device = resolve_device(device)
            self.devices = [self.device]
            self._blocks = blocks.to(
                self.device, operand_dtype(blocks.dtype, self.precision)
            ).contiguous()
        self._consts_on: dict = {}
        self._programs: dict = {}
        # the card's window is a captured CUDA graph; False runs the same
        # loop eagerly on the card (for timing the two against each other)
        self._graph_windows = True
        # cross-window continuation: the in-flight state the host loop
        # would keep in (pool.active, pool.sepochs, backend slots)
        self._carry = None
        self._carry_epoch: int | None = None
        self._carry_T = 0.0  # the carry's clock, kept on the host
        self.last_decoded = None
        self.last_window: dict = {}
        self._m = None
        self._flight = flight
        if registry is not None:
            self._m = {
                "epochs": registry.counter(
                    "devcoord_fused_epochs_total",
                    help="epochs coordinated inside fused device "
                         "windows (no host touch)",
                ),
                "harvests": registry.counter(
                    "devcoord_harvests_total",
                    help="K-epoch windows staged and harvested by the "
                         "host",
                ),
                "harvest_s": registry.histogram(
                    "devcoord_harvest_seconds",
                    help="host wall per stage+run+harvest round trip",
                ),
                "k": registry.gauge(
                    "devcoord_epochs_per_harvest",
                    help="K of the most recent fused window",
                ),
            }

    # -- factories --------------------------------------------------------
    @classmethod
    def for_coded_gemm(cls, cg, *, delay_fn=None, nwait=None, **kw):
        """A coordinator sharing an existing
        :class:`~..ops.coded_gemm.CodedGemm`'s coded blocks and MDS
        generator (and, unless overridden, its backend for window
        submission), on its first device."""
        kw.setdefault("backend", cg.backend)
        kw.setdefault("device", cg.devices[0])
        return cls(
            torch.stack([as_tensor(b).to(cg.devices[0]) for b in cg.blocks]),
            decode="mds", G=cg.code.G, k=cg.k, nwait=nwait,
            delay_fn=delay_fn, precision=cg.precision, **kw,
        )

    @classmethod
    def for_lt_gemm(cls, ltg, *, delay_fn=None, nwait=None, **kw):
        """A coordinator for an :class:`~..ops.coded_gemm.LTCodedGemm`
        window: the 0/1 generator rows of its fixed shard window,
        decoded by masked normal equations."""
        kw.setdefault("backend", ltg.backend)
        kw.setdefault("device", ltg.devices[0])
        return cls(
            torch.stack([b.to(ltg.devices[0]) for b in ltg.blocks]),
            decode="lt",
            G=ltg.code.generator_rows(ltg.shard_ids),
            k=ltg.k, nwait=ltg.n if nwait is None else nwait,
            delay_fn=delay_fn, precision=ltg.precision, **kw,
        )

    @classmethod
    def for_hierarchical(cls, hg, *, delay_fn=None, **kw):
        """A coordinator for a :class:`~..ops.hierarchical.
        HierarchicalCodedGemm` fleet, MDS inner + parity outer only (the
        deployment default): the batched inner decode runs inside the
        window and the outer reconstruction is the on-device
        subtraction chain."""
        if hg.inner != "mds" or hg.outer.kind != "parity":
            raise ValueError(
                "device windows fuse the MDS-inner + parity-outer "
                f"construction; got inner={hg.inner!r} outer="
                f"{hg.outer.kind!r} (run those through the host loop)"
            )
        for g, members in enumerate(hg.group_indices):
            expect = np.arange(
                g * hg.n_inner, (g + 1) * hg.n_inner, dtype=np.int64
            )
            if not np.array_equal(np.asarray(members), expect):
                raise ValueError(
                    "device windows need the contiguous group layout "
                    f"(group {g} holds {list(members)})"
                )
        if hg.backend is not None:
            kw.setdefault("backend", hg.backend)
        kw.setdefault("device", hg.devices[0])
        return cls(
            torch.stack([b.to(hg.devices[0]) for b in hg.blocks]),
            decode="hierarchical", groups=hg.H, k_inner=hg.k_inner,
            inner_G=hg._inner_G, delay_fn=delay_fn,
            precision=hg.precision, **kw,
        )

    # -- the window program -----------------------------------------------
    def _consts(self, dev: torch.device) -> dict:
        """The window's constants on ``dev``, placed once."""
        c = self._consts_on.get(dev)
        if c is None:
            c = {"arange": torch.arange(self.n, device=dev)}
            if self.decode in ("mds", "lt"):
                c["G"] = torch.from_numpy(self.G).to(dev)
            else:
                c["inner_G"] = self.inner_G.to(dev)
                c["r_grid"] = c["arange"].view(-1, 1, 1)
            self._consts_on[dev] = c
        return c

    def _completion_j(self, ranks, c):
        """Index (into the sorted candidate order) of the arrival that
        completes the epoch. Integer ``nwait`` is a static rank; the
        hierarchical rule evaluates the two-level predicate over every
        sorted prefix and takes the first satisfying one (always
        satisfiable: all n arrived clears both floors by
        construction)."""
        if self.nwait is not None:
            return self.nwait - 1
        member_ranks = ranks.view(1, self.H, self.n_inner)
        cnt = (member_ranks <= c["r_grid"]).sum(dim=-1)  # (n, H)
        done = (cnt >= self.k_inner).sum(dim=-1) >= self.L
        return torch.argmax(done.to(torch.int32))  # first True

    def _recurrence(self, c, d_e, e, active, dspe, arr, rep, T):
        """ONE epoch of the pool state machine, no host. The carry
        ``(active, dspe, arr, rep, T)`` is the in-flight state the host
        keeps in (pool.active, pool.sepochs, backend arrival slots,
        pool.repochs, the clock). Selection is by argsort, gather and
        ``torch.where`` only: nothing here waits on the device."""
        # phase 1: drain arrivals at or before the epoch opening
        drain = active & (arr <= T)
        rep = torch.where(drain, dspe, rep)
        # phase 2: dispatch every idle worker at T
        newly = (~active) | drain
        cand = torch.where(newly, T + d_e, arr + d_e)
        order = torch.argsort(cand, stable=True)
        ranks = torch.empty_like(order).scatter_(0, order, c["arange"])
        j_star = self._completion_j(ranks, c)
        if isinstance(j_star, int):
            at = order.narrow(0, j_star, 1)
        else:
            at = order.gather(0, j_star.view(1))
        T_next = cand.gather(0, at).view(())
        winners = ranks <= j_star
        # phase 3: stale harvests before completion re-task; fresh
        # winners stamp the current epoch (overriding any stale stamp
        # their own re-task produced en route)
        late = active & (~drain) & (arr <= T_next)
        rep = torch.where(late & (~winners), dspe, rep)
        rep = torch.where(winners, e, rep)
        dispatched = newly | late
        dspe = torch.where(dispatched, e, dspe)
        arr = torch.where(dispatched, cand, arr)
        return (~winners, dspe, arr, rep, T_next), winners

    def _decode_fresh(self, c, shards, fresh, out) -> None:
        """The per-epoch decode over the on-device arrival mask, written
        into ``out`` (the epoch's (rows, cols) slot): stale shards never
        enter (the host loop's ``fresh_indices`` order included)."""
        if self.decode == "mds":
            sel = torch.argsort((~fresh).to(torch.int32), stable=True)
            sel = sel[: self.k]
            # the k fresh shards are gathered once, with the pivots
            blocks = _lu_solve(c["G"].index_select(0, sel).to(shards.dtype),
                               shards.view(self.n, -1), rows=sel)
        elif self.decode == "lt":
            Gm = c["G"].to(shards.dtype) * fresh.to(shards.dtype)[:, None]
            rhs = torch.einsum("nk,nrc->krc", Gm, shards)
            blocks = _decode(Gm.mT @ Gm, rhs)
        else:
            H, ni, ki, L = self.H, self.n_inner, self.k_inner, self.L
            gmask = fresh.view(H, ni)
            sel = torch.argsort((~gmask).to(torch.int32), dim=-1,
                                stable=True)[:, :ki]  # (H, ki) per group
            G_S = c["inner_G"][sel]  # (H, ki, ki)
            gsh = torch.take_along_dim(
                shards.view(H, ni, *shards.shape[1:]),
                sel[:, :, None, None], dim=1,
            )  # (H, ki, r, c)
            gflat = decode_groups(G_S, gsh).reshape(H, ki * self.block_rows,
                                                    -1)
            arrived = gmask.sum(dim=-1) >= ki  # (H,)
            srcs, parity = gflat[:L], gflat[L]
            recon = parity[None] - (srcs.sum(dim=0)[None] - srcs)
            blocks = torch.where(arrived[:L, None, None], srcs, recon)
        out.view(blocks.shape).copy_(blocks)

    def _flat_window(self, payload, delays, e_arr, active, dspe, arr, rep,
                     T):
        """K epochs on the coordinator's device with no host sync.
        Returns ``(carry, (rep_hist, dec_hist, t_hist), shards_last)``."""
        dev = self.device
        c = self._consts(dev)
        K = delays.shape[0]
        per_epoch = payload.dim() == 3
        rep_hist = torch.empty((K, self.n), dtype=rep.dtype, device=dev)
        t_hist = torch.empty(K, dtype=T.dtype, device=dev)
        dec_hist = shards = None
        for j in range(K):
            shards = _stacked_matmul(
                self._blocks, payload[j] if per_epoch else payload,
                self.precision)
            if dec_hist is None:
                dec_hist = torch.empty(
                    (K, self._out_rows, shards.shape[-1]),
                    dtype=shards.dtype, device=dev)
            (active, dspe, arr, rep, T), fresh = self._recurrence(
                c, delays[j], e_arr[j], active, dspe, arr, rep, T)
            self._decode_fresh(c, shards, fresh, dec_hist[j])
            rep_hist[j].copy_(rep)
            t_hist[j].copy_(T)
        # the last epoch's products are the pool's results at the edge
        return (active, dspe, arr, rep, T), (rep_hist, dec_hist, t_hist), \
            shards

    def _mesh_window(self, payload, delays, e_arr, active, dspe, arr, rep,
                     T):
        """The sharded window: worker shards stay on their ranks, the
        recurrence runs replicated on every rank's device, the decode is
        one masked-weight reduce-scatter per epoch (block j on rank j,
        blocks >= k zero: the collectives layout), and the last epoch's
        blocks return to every rank over the ring."""
        n, k, r = self.n, self.k, self.block_rows
        devs = self.devices
        K = delays.shape[0]
        per_epoch = payload.dim() == 3
        # the replicated operands, once per distinct device
        state, consts, staged = {}, {}, {}
        for dev in dict.fromkeys(devs):
            consts[dev] = self._consts(dev)
            staged[dev] = (payload.to(dev), delays.to(dev), e_arr.to(dev))
            state[dev] = tuple(x.to(dev) for x in
                               (active, dspe, arr, rep, T))
        rep_hist = torch.empty((K, n), dtype=rep.dtype, device=devs[0])
        t_hist = torch.empty(K, dtype=T.dtype, device=devs[0])
        dec_hist = [[] for _ in range(n)]
        shard_w = [None] * n
        for j in range(K):
            weights = {}
            for dev, st in state.items():
                _, d_d, e_d = staged[dev]
                st, fresh = self._recurrence(consts[dev], d_d[j], e_d[j],
                                             *st)
                state[dev] = st
                # rows j < k of W: the k x k inverse over the first-k
                # fresh columns; inv_ex keeps the host off the device
                sel = torch.argsort((~fresh).to(torch.int32),
                                    stable=True)[:k]
                inv = torch.linalg.inv_ex(
                    consts[dev]["G"].index_select(0, sel))[0]
                W = torch.zeros((n, n), dtype=inv.dtype, device=dev)
                W[:k].index_copy_(1, sel, inv)
                weights[dev] = W
            parts = []
            for w, dev in enumerate(devs):
                p_w = staged[dev][0]
                shard_w[w] = matmul(self._blocks.local(w)[0],
                                    p_w[j] if per_epoch else p_w,
                                    self.precision)
                W = weights[dev].to(shard_w[w].dtype)
                parts.append(W[:, w, None, None] * shard_w[w][None])
            for w, blk in enumerate(reduce_scatter(parts, devs)):
                dec_hist[w].append(blk)
            st0 = state[devs[0]]
            rep_hist[j].copy_(st0[3])
            t_hist[j].copy_(st0[4])
        cols = shard_w[0].shape[-1]
        dec = from_local(self.mesh, PartitionSpec(None, self.axis),
                         [torch.stack(h) for h in dec_hist],  # (K, 1, r, c)
                         (K, n, r, cols))
        shards_last = from_local(self.mesh, PartitionSpec(self.axis),
                                 [s[None] for s in shard_w], (n, r, cols))
        # ring all-gather of the final decoded blocks: every rank leaves
        # the window holding the full product
        full = ring_pass([h[-1][0] for h in dec_hist], devs)
        last_full = from_local(
            self.mesh, PartitionSpec(self.axis),
            [f[:k].reshape(1, k * r, cols) for f in full],
            (n, k * r, cols))
        return state[devs[0]], (rep_hist, dec, t_hist), shards_last, \
            last_full

    def _program(self, epochs: int, per_epoch_payload: bool, payload):
        key = (int(epochs), bool(per_epoch_payload), tuple(payload.shape),
               payload.dtype, self._graph_windows)
        prog = self._programs.get(key)
        if prog is None:
            if self.mesh is not None:
                prog = self._mesh_window
            elif self.device.type == "cuda" and self._graph_windows:
                prog = _GraphWindow(self._flat_window, self.device)
            else:
                prog = self._flat_window
            self._programs[key] = prog
        return prog

    # -- host surface: stage + harvest ------------------------------------
    def reset(self) -> None:
        """Forget cross-window in-flight state (the elastic-recovery
        analog of :meth:`~..pool.AsyncPool.reset_worker`: a dropped
        window's dispatches can never complete)."""
        self._carry = None
        self._carry_epoch = None
        self._carry_T = 0.0

    def _initial_carry(self, pool: AsyncPool):
        if (
            self._carry is not None
            and self._carry_epoch == int(pool.epoch)
        ):
            # back-to-back windows, but only if the pool still shows
            # THIS coordinator's end state (interleaving a second
            # coordinator or hand-editing the pool would silently
            # desynchronize the in-flight bookkeeping)
            if not (
                np.array_equal(self._carry[0].cpu().numpy(), pool.active)
                and np.array_equal(self._carry[1].cpu().numpy(),
                                   pool.sepochs)
            ):
                raise ValueError(
                    "pool state diverged from this coordinator's "
                    "in-flight carry (another coordinator or manual "
                    "edits touched the pool mid-sequence); reset() "
                    "the coordinator and quiesce the pool first"
                )
            return self._carry
        if pool.active.any():
            raise ValueError(
                "pool has in-flight host-loop work; a fused window "
                "needs a quiescent pool (waitall first) or "
                "back-to-back fused windows on one coordinator"
            )
        dev = self.device
        return (
            torch.zeros(self.n, dtype=torch.bool, device=dev),
            torch.from_numpy(pool.sepochs.astype(np.int64)).to(dev),
            torch.zeros(self.n, dtype=torch.float64, device=dev),
            torch.from_numpy(pool.repochs.astype(np.int64)).to(dev),
            torch.zeros((), dtype=torch.float64, device=dev),
        )

    def _sync(self) -> None:
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()

    def run_window(
        self,
        pool: AsyncPool,
        sendbuf,
        *,
        epochs: int,
        store_results: bool = True,
    ) -> np.ndarray:
        """Stage + run + harvest one fused K-epoch window. Returns the
        (epochs, n) ``repochs`` HISTORY (row ``j`` is exactly what the
        host loop's epoch ``epoch0 + j`` ``asyncmap`` call would have
        returned) and leaves the pool in the state the host loop would
        have left it in (``epoch``, ``repochs``, ``sepochs``,
        ``active``; workers still in flight at the window edge stay in
        flight for the next window). Decoded per-epoch products land in
        :attr:`last_decoded` (epochs-leading), window diagnostics in
        :attr:`last_window`.

        ``sendbuf``: one (d, cols) payload broadcast to every epoch of
        the window, or an (epochs, d, cols) stack staging per-epoch
        payloads up front.
        """
        epochs = int(epochs)
        if epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {epochs}")
        if pool.n_workers != self.n:
            raise ValueError(
                f"pool has {pool.n_workers} workers but this window "
                f"is laid out for {self.n}"
            )
        t0 = time.perf_counter()
        epoch0 = int(pool.epoch) + 1
        payload = as_tensor(sendbuf)
        per_epoch = payload.dim() == 3
        if per_epoch and payload.shape[0] != epochs:
            raise ValueError(
                f"staged payloads carry {payload.shape[0]} epochs but "
                f"the window runs {epochs}"
            )
        delays = stage_delays(self.delay_fn, self.n, epoch0, epochs)
        e_arr = np.arange(epoch0, epoch0 + epochs, dtype=np.int64)
        carry = self._initial_carry(pool)
        T0 = self._carry_T if carry is self._carry else 0.0
        dev = self.device
        args = (payload.to(dev), torch.from_numpy(delays).to(dev),
                torch.from_numpy(e_arr).to(dev), *carry)
        prog = self._program(epochs, per_epoch, payload)
        if self._backend is not None:
            handle = self._backend.submit_window(
                prog, *args, epoch0=epoch0, epochs=epochs
            )
            outs = handle.harvest()
        else:
            outs = prog(*args)
        self._sync()
        if self.mesh is None:
            carry_out, (rep_hist, dec_hist, t_hist), shards_last = outs
            last_full = None
            if isinstance(prog, _GraphWindow):
                # the graph's outputs are overwritten by its next replay
                dec_hist = dec_hist.clone()
                shards_last = shards_last.clone()
        else:
            carry_out, (rep_hist, dec_hist, t_hist), shards_last, \
                last_full = outs
        self._carry = carry_out
        self._carry_epoch = epoch0 + epochs - 1
        rep_np = rep_hist.cpu().numpy().astype(np.int64)
        # harvest: the pool leaves the window exactly where the host
        # loop would have left it
        pool.epoch = epoch0 + epochs - 1
        pool.repochs[:] = rep_np[-1]
        pool.sepochs[:] = carry_out[1].cpu().numpy()
        pool.active[:] = carry_out[0].cpu().numpy()
        if store_results:
            for i in np.flatnonzero(rep_np[-1] == pool.epoch):
                pool.results[int(i)] = (
                    shards_last[int(i)] if last_full is None
                    else shards_last.local(int(i))[0]
                )
        self.last_decoded = dec_hist
        t_np = t_hist.cpu().numpy()
        self._carry_T = float(t_np[-1])
        self.last_window = {
            "epochs": epochs,
            "epoch0": epoch0,
            "virtual_s": float(t_np[-1] - T0),
            "epoch_ends": t_np,
            "last_full": None if last_full is None
            else last_full.local(0)[0],
        }
        dt = time.perf_counter() - t0
        if self._m is not None:
            self._m["epochs"].inc(epochs)
            self._m["harvests"].inc()
            self._m["harvest_s"].observe(dt)
            self._m["k"].set(epochs)
        if self._flight is not None:
            self._flight.span(
                f"devcoord window {epoch0}+{epochs}",
                t0, dt, track="devcoord",
                epochs=epochs, epoch0=epoch0,
            )
        return rep_np

    def full(self, decoded) -> np.ndarray:
        """Host gather of one epoch's decoded product -> (rows, cols):
        flat windows already emit the stacked source rows; mesh windows
        emit the collectives layout (n, r, c) with blocks >= k zero."""
        if isinstance(decoded, torch.Tensor):
            decoded = decoded.detach().cpu()
        out = np.asarray(decoded)
        if self.mesh is not None and out.ndim == 3:
            return out[: self.k].reshape(-1, out.shape[-1])
        return out
