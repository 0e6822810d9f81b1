"""Multi-process shard host: per-shard worker processes behind the
`ShardedStore` surface, with a zero-copy shared-memory data plane.

In the in-process `ShardedStore` every shard daemon (EC encode,
journal digests, framing) shares ONE interpreter, so aggregate daemon
CPU is GIL-capped.  `ProcessShardedStore` keeps the exact same router
+ 2PC leader machinery (it IS a `ShardedStore`; `_make_shard` is the
only construction hook it overrides) but each shard becomes a worker
PROCESS owning a full `InfiniStore` — its own interpreter, client
daemon, writeback writer, and `SpillJournal` under
`<spill_dir>/shard-<i>/` — over one shared disk-backed COS root.  The
real InfiniStore runs its client<->proxy split as separate processes
over sockets (ports 6378/6379); this is that architecture with the
sockets replaced by something faster.

Data plane (`repro_torch.core.ipc.ShmArena`): each worker gets a request
ring and a response ring in `multiprocessing.shared_memory`.  A PUT
payload is bulk-copied once into the request ring by the caller; the
worker maps a *writable* numpy view over the slot and submits it —
`InfiniStore._snapshot_value` copies writable buffers synchronously at
submission, so the store owns a private copy the moment the RPC is
dispatched and the slot is released immediately (watermarks ride the
control pipe).  No per-chunk pickling, no payload on the pipe.  GET
results travel the response ring the same way, packed by the worker's
daemon callbacks in send order.

Control plane: one duplex `Pipe` per worker carries framed tuples
`(op, rid, payload)` / `("ok"|"val"|"err"|"rel", rid, value)` — invokes,
2PC prepare/commit/abort rounds (prepared batches are held worker-side
and named by their prepare rid), flush barriers, stats snapshots, and
health.  A per-worker reader thread multiplexes the pipe with the
process sentinel (`multiprocessing.connection.wait`), so a SIGKILLed
worker fails its in-flight futures with `ShardWorkerDied` instead of
hanging them, and the survivors keep serving.

Both planes live behind `repro_torch.core.transport.ShardTransport`: the
pipe+arena path above is `LocalTransport` (the default, fastest on one
box), and `transport="tcp"` swaps in `TcpTransport` + the
`repro_torch.core.netshard` worker — framed sockets with heartbeat failure
detection, per-RPC deadlines, epoch-fenced reconnect, and
deterministic `net.*` fault injection (the real InfiniStore's
client<->proxy socket split, made partition-tolerant).

Crash semantics become REAL here: `simulate_crash(shard=i)` sends
SIGKILL, `restart_shard(i)` spawns a fresh worker whose `InfiniStore`
constructor replays the shard's spill journal, and the inherited
`resolve_indoubt` sweep settles any 2PC ticket the kill stranded.
Fault plans serialize into workers (each process owns an independent
deterministic copy; leader sites keep firing in the parent).

Lifecycle hygiene: `close()` runs the close RPC on every worker in
parallel under one shared deadline, then joins each process and
escalates join -> terminate -> kill; a `weakref.finalize` + module
`atexit` hook reaps abandoned stores so no worker process or /dev/shm
segment outlives the parent.  Workers are daemonic besides — the
interpreter will not exit leaving them behind.
"""
from __future__ import annotations

import atexit
import dataclasses
import logging
import os
import shutil
import signal
import tempfile
import threading
import time
import weakref
import itertools
import multiprocessing as mp
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import torch

from repro_torch.obs import FlightRecorder

from .clock import Clock
from .ipc import ArenaBroken, ShmArena, desc_watermark, pack_payload, \
    unpack_payload
from .locks import make_lock
from .payload import as_u8
from .shard import ShardedStore
from .store import InfiniStore, StoreStats
from .transport import (HeartbeatConfig, LocalTransport, ShardTransport,
                        ShardWorkerDied, TcpTransport)
from .writeback import StoreFuture

__all__ = ["ProcessShardedStore", "ShardWorkerDied",
           "DEFAULT_ARENA_BYTES"]

_LOG = logging.getLogger("repro_torch.host")

MB = 1024 * 1024
DEFAULT_ARENA_BYTES = 64 * MB


# ---------------------------------------------------------------------------
# worker process side
# ---------------------------------------------------------------------------

def _swallow(fn, *args):
    try:
        return fn(*args)
    except Exception:                                 # noqa: BLE001
        return None


def _portable_exc(e: BaseException) -> BaseException:
    """Best-effort picklable form of a worker-side exception."""
    import pickle
    try:
        pickle.loads(pickle.dumps(e))
        return e
    except Exception:                                 # noqa: BLE001
        return RuntimeError(f"{type(e).__name__}: {e}")


def _one_thread() -> None:
    """A worker is one shard among several on this host: its CPU tensor
    work runs on one thread, as the JAX package's numpy codec does.
    Intra-op threads in every worker would oversubscribe the cores
    (concurrent prepares on two CPU shards ran several times slower than
    the same work one shard at a time)."""
    torch.set_num_threads(1)


def _warm_device(store: InfiniStore) -> None:
    """On a card, one small encode and a degraded decode through the
    store's codec before the worker reports ready, so that the codec
    kernel's library, its first launches and the copies between host and
    device are loaded at boot. Under the first request instead they hold
    the worker's replies, heartbeats among them, for longer than a tight
    failure detector waits (`HeartbeatConfig(dead_after_s=0.6)`)."""
    if store.device.type != "cuda":
        return
    payload = bytes(range(256)) * 16
    chunks = store.codec.encode(payload)
    survivors = {i: c for i, c in enumerate(chunks) if i != 0}
    assert store.codec.decode(survivors) == payload
    torch.cuda.synchronize(store.device)


def _worker_main(spec: dict) -> None:
    """Entry point of one shard worker process."""
    # the parent handles ^C; an interactive SIGINT must not tear the
    # worker down mid-journal-write before the parent's close sequence
    try:
        signal.signal(signal.SIGINT, signal.SIG_IGN)
    except (ValueError, OSError):                     # pragma: no cover
        pass
    _one_thread()
    conn = spec["conn"]
    send_lock = make_lock("host._worker_main.send_lock")

    def send(msg) -> None:
        with send_lock:
            try:
                # lint: allow(blocking-under-lock): send_lock exists to serialize exactly this pipe write
                conn.send(msg)
            except (OSError, ValueError, BrokenPipeError):
                pass                 # parent gone: nothing left to tell

    req = resp = None
    try:
        req = ShmArena.attach(spec["req_name"], spec["arena_bytes"])
        resp = ShmArena.attach(spec["resp_name"], spec["arena_bytes"])
        store = InfiniStore(spec["cfg"], clock=Clock(),
                            cos_root=spec["cos_root"],
                            seed=spec["seed"], name=spec["name"])
        # benchmarks model COS latency with attributes on the COS
        # object; each worker owns its own COS, so the model is shipped
        # in the spec and applied before "ready"
        for attr, val in spec.get("cos_latency", {}).items():
            setattr(store.cos, attr, val)
        if store.obs is not None:
            # shm workers have no reconnect epochs; pin epoch 1 so
            # flight records are attributable like the TCP worker's
            store.obs.set_epoch(1)
        _warm_device(store)
    except BaseException as e:                        # noqa: BLE001
        send(("err", -1, _portable_exc(e)))
        return
    # "ready" only after construction: journal replay is included, so
    # the parent's restart_shard timing covers the real recovery cost;
    # the store's device rides along so the parent can check where it runs
    send(("ok", -1, (os.getpid(), str(store.device))))
    loop = _WorkerLoop(store, conn, req, resp, send)
    try:
        loop.run()
    finally:
        loop.shutdown()
        for a in (req, resp):
            try:
                a.close()
            except Exception:                         # noqa: BLE001
                pass


class _WorkerLoop:
    """The worker's dispatch loop: recv ops from the pipe, submit them
    to the store's async surface, reply from future callbacks. The loop
    thread NEVER blocks on a store future — a GET callback waiting for
    response-ring space needs the loop alive to process release
    watermarks."""

    def __init__(self, store: InfiniStore, conn, req: ShmArena,
                 resp: ShmArena, send) -> None:
        self.store = store
        self.conn = conn
        self.req = req
        self.resp = resp
        self.send = send
        # blocking ops (flush barriers, gc ticks, close) leave the loop
        self.aux = ThreadPoolExecutor(max_workers=2,
                                      thread_name_prefix="shard-host-aux")
        self.preps: Dict[int, object] = {}   # prepare rid -> prepared
        self.resp_lock = make_lock("host._WorkerLoop.resp_lock")    # resp pack+send = one unit
        self._last_rel = 0

    def run(self) -> None:
        # shutdown must not depend on pipe EOF: the parent sends an
        # explicit "bye" from reap(), and a ppid watchdog catches a
        # parent that died without one (SIGKILLed host) — EOF delivery
        # on the control socket has proven unreliable once the full
        # store (arenas + forkserver) is attached
        ppid = os.getppid()
        while True:
            try:
                if not self.conn.poll(1.0):
                    if os.getppid() != ppid:
                        return       # parent died: exit
                    continue
                msg = self.conn.recv()
            except (EOFError, OSError):
                return               # parent closed (or died): exit
            op, rid, p = msg
            if op == "bye":
                return               # parent is reaping us: exit now
            if op == "release":
                self.resp.release_to(p)
                continue
            try:
                self.dispatch(op, rid, p)
            except BaseException as e:                # noqa: BLE001
                self.send(("err", rid, _portable_exc(e)))

    def shutdown(self) -> None:
        self.aux.shutdown(wait=False)

    # -- request-ring bookkeeping ------------------------------------------

    def _consumed(self, wm: int) -> None:
        """Ack request-ring bytes: by the time an *_async call returned,
        the store snapshot-copied every writable arena view, so the
        parent may reuse the slot. Alloc order == pipe order == dispatch
        order, so the watermark is monotonic."""
        if wm > self._last_rel:
            self._last_rel = wm
            self.send(("rel", 0, wm))

    def _unpack(self, desc):
        """Materialize one request payload descriptor. The shm loop
        maps arena slots; `netshard._NetWorkerLoop` overrides this to
        map frame-offset descriptors instead — dispatch is shared."""
        return unpack_payload(self.req, desc)

    def _unpack_items(self, items_desc):
        return [(k, self._unpack(d)) for k, d in items_desc]

    # -- replies -----------------------------------------------------------

    def _reply_done(self, rid: int, fut: StoreFuture) -> None:
        def cb(f):
            try:
                v = f.result()
            except BaseException as e:                # noqa: BLE001
                self.send(("err", rid, _portable_exc(e)))
                return
            self.send(("ok", rid, v))
        fut.add_done_callback(cb)

    def _pack_result(self, v, since=None):
        """One reply payload's descriptor; `since` is the response
        ring's head when the reply began (several values in one reply)."""
        if v is None:
            return ("n",)
        return pack_payload(self.resp, v, since=since)

    def _reply_value(self, rid: int, fut: StoreFuture) -> None:
        """GET reply: pack the payload into the response ring and send,
        as ONE unit under resp_lock — ring order must equal send order,
        or the parent's monotonic release watermark could free a slot
        whose reply is still in flight."""
        def cb(f):
            try:
                v = f.result()
            except BaseException as e:                # noqa: BLE001
                self.send(("err", rid, _portable_exc(e)))
                return
            try:
                with self.resp_lock:
                    d = self._pack_result(v)
                    self.send(("val", rid, d))
            except BaseException as e:                # noqa: BLE001
                self.send(("err", rid, _portable_exc(e)))
        fut.add_done_callback(cb)

    def _reply_map(self, rid: int, fut: StoreFuture) -> None:
        def cb(f):
            try:
                out = f.result()
            except BaseException as e:                # noqa: BLE001
                self.send(("err", rid, _portable_exc(e)))
                return
            try:
                with self.resp_lock:
                    since = None if self.resp is None else self.resp.head
                    d = {k: self._pack_result(v, since)
                         for k, v in out.items()}
                    self.send(("val", rid, d))
            except BaseException as e:                # noqa: BLE001
                self.send(("err", rid, _portable_exc(e)))
        fut.add_done_callback(cb)

    def _reply_sync(self, rid: int, fn) -> None:
        try:
            self.send(("ok", rid, fn()))
        except BaseException as e:                    # noqa: BLE001
            self.send(("err", rid, _portable_exc(e)))

    # -- dispatch ----------------------------------------------------------

    def dispatch(self, op: str, rid: int, p) -> None:
        # trace envelope: _ShardProxy._rpc wraps the payload when the
        # parent has an ambient span; adopting it here means every span
        # the store opens below stitches into the parent's trace
        if type(p) is tuple and len(p) == 3 and p[0] == "_tctx":
            _, tctx, p = p
            obs = self.store.obs
            if obs is not None:
                with obs.adopt(tctx):
                    self._dispatch(op, rid, p)
                return
        self._dispatch(op, rid, p)

    def _dispatch(self, op: str, rid: int, p) -> None:  # noqa: C901
        store = self.store
        if op == "put":
            key, desc = p
            fut = store.put_async(key, self._unpack(desc))
            self._consumed(desc_watermark([desc]))
            self._reply_done(rid, fut)
        elif op == "put_many":
            items_desc, roc = p
            fut = store.put_many_async(self._unpack_items(items_desc),
                                       raise_on_conflict=roc)
            self._consumed(desc_watermark([d for _, d in items_desc]))
            self._reply_done(rid, fut)
        elif op == "prepare":
            items_desc, roc, ticket = p
            fut = store.prepare_put_many_async(
                self._unpack_items(items_desc), raise_on_conflict=roc,
                ticket=ticket)
            self._consumed(desc_watermark([d for _, d in items_desc]))

            def on_prep(f):
                try:
                    prep = f.result()
                except BaseException as e:            # noqa: BLE001
                    self.send(("err", rid, _portable_exc(e)))
                    return
                self.preps[rid] = prep
                self.send(("ok", rid, rid))   # the handle IS the rid
            fut.add_done_callback(on_prep)
        elif op == "commit2pc":
            prep_rid, ticket = p
            prep = self.preps.pop(prep_rid)   # KeyError -> err -> sweep
            self._reply_done(rid, store.commit_put_many_async(
                prep, ticket=ticket))
        elif op == "abort2pc":
            prep = self.preps.pop(p)
            self._reply_done(rid, store.abort_put_many_async(prep))
        elif op == "get":
            self._reply_value(rid, store.get_async(p))
        elif op == "get_many":
            keys, as_arrays = p
            fut = store.get_many_arrays_async(keys) if as_arrays \
                else store.get_many_async(keys)
            self._reply_map(rid, fut)
        elif op == "flush":
            self.aux.submit(self._reply_sync, rid,
                            lambda: store.flush_writeback(timeout=p))
        elif op == "gc":
            self.aux.submit(self._reply_sync, rid, store.gc_tick)
        elif op == "close":
            self.aux.submit(self._reply_sync, rid,
                            lambda: store.close(flush=p))
        elif op == "indoubt":
            self._reply_done(rid, store.indoubt_tickets_async())
        elif op == "resolve":
            ticket, commit = p
            self._reply_done(rid, store.resolve_indoubt(ticket,
                                                        commit=commit))
        elif op == "stats":
            self._reply_sync(rid, lambda: store.stats.as_dict())
        elif op == "obs":
            self._reply_sync(rid, store.snapshot_metrics)
        elif op == "snapshot":
            self._reply_sync(rid, store.snapshot_metadata)
        elif op == "cos_keys":
            self._reply_sync(rid, lambda: store.cos_keys(p))
        elif op == "balance":
            self._reply_sync(rid, store.balance_count)
        elif op == "ledger":
            self._reply_sync(rid, store.ledger_dollars)
        elif op == "nfuncs":
            self._reply_sync(rid, lambda: store.num_functions(p))
        elif op == "pause_wb":
            self._reply_sync(rid, store.pause_writeback)
        elif op == "resume_wb":
            self._reply_sync(rid, store.resume_writeback)
        else:
            raise ValueError(f"unknown host op {op!r}")


# ---------------------------------------------------------------------------
# parent side: per-worker proxy with the InfiniStore shard surface
# ---------------------------------------------------------------------------

_USE_DEFAULT = object()              # _rpc deadline sentinel


class _ShardProxy:
    """Parent-side handle for one worker, implementing the slice of
    the `InfiniStore` surface that `ShardedStore` (and the conformance
    suite) drives — every call becomes an RPC over a `ShardTransport`
    (pipe + shared-memory rings, or framed TCP with heartbeats and
    epoch fencing; see `repro_torch.core.transport`).

    Locking: `_order_lock` makes (pack payload -> assign rid -> send)
    atomic, which pins staging order == wire order (the shm worker's
    release watermark and the TCP frame offsets both depend on it).
    The transport delivers replies on its reader thread via
    `_on_message`, failure via `_on_down`, recovery via
    `_on_reconnect`, and a periodic `_on_tick` that expires per-RPC
    deadlines."""

    def __init__(self, *, ctx, shard_id: int, cfg, cos_root: str,
                 seed: int, name: str, arena_bytes: int,
                 resources: "_HostResources",
                 boot_timeout_s: float,
                 cos_latency: Optional[dict] = None,
                 transport: str = "shm",
                 heartbeat: Optional[HeartbeatConfig] = None,
                 faults=None,
                 obs=None,
                 on_reconnect=None) -> None:
        self.shard_id = shard_id
        self.name = name
        self._obs = obs              # parent-side plane (may be None)
        self.spill_dir = cfg.spill_dir
        self._order_lock = make_lock("host._ShardProxy._order_lock")
        self._state_lock = make_lock("host._ShardProxy._state_lock")
        self._rids = itertools.count(1)
        self._inflight: Dict[int, tuple] = {}
        self._alive = False
        self._closing = False
        self._expected_death = False
        self._stats_cache = StoreStats()
        self._resources = resources
        # WEAK ref: proxies are pinned by the module-global orphan
        # registry; a bound-method callback would pin the whole store
        # and defeat the abandoned-store finalizer
        self._reconnect_cb = None if on_reconnect is None \
            else weakref.WeakMethod(on_reconnect)
        self.pid: Optional[int] = None
        # the worker's device, from its ready reply
        self.device: Optional[str] = None
        # array GETs come back as tensors on the frontend's device
        self._array_device = torch.device(cfg.device)
        spec = {"cfg": cfg, "cos_root": cos_root, "seed": seed,
                "name": name, "cos_latency": dict(cos_latency or {})}
        if transport == "tcp":
            self._t: ShardTransport = TcpTransport(
                shard_id=shard_id, ctx=ctx, spec=spec,
                hb=heartbeat or HeartbeatConfig(),
                boot_timeout_s=boot_timeout_s, faults=faults,
                seed=seed + shard_id)
        elif transport == "shm":
            self._t = LocalTransport(
                ctx=ctx, shard_id=shard_id, spec=spec,
                arena_bytes=arena_bytes, boot_timeout_s=boot_timeout_s)
        else:
            raise ValueError(f"unknown shard transport {transport!r}")
        self._t.obs = obs            # heartbeat/reconnect instrumentation
        resources.register(self)
        try:
            self.pid = self._t.start(on_message=self._on_message,
                                     on_down=self._on_down,
                                     on_reconnect=self._on_reconnect,
                                     on_tick=self._on_tick)
        except BaseException:
            self.reap()
            raise
        self.device = self._t.device
        self._alive = True

    # -- transport callbacks -----------------------------------------------

    def _on_message(self, msg) -> None:
        kind, rid, val = msg
        with self._state_lock:
            ent = self._inflight.pop(rid, None)
        if ent is None:
            return                   # deadline-expired / failed at down
        fut, post, _op, _dl = ent
        if kind == "err":
            fut.set_exception(val if isinstance(val, BaseException)
                              else RuntimeError(str(val)))
            return
        if kind == "val":
            try:
                v, wm = post(val)
            except BaseException as e:                # noqa: BLE001
                fut.set_exception(e)
                return
            if wm:
                self._t.ack_reply(wm)
            fut._resolve(v)
            return
        fut._resolve(post(val) if post is not None else val)

    def _on_down(self, exc: BaseException) -> None:
        with self._state_lock:
            was_alive = self._alive
            self._alive = False
            pending = list(self._inflight.values())
            self._inflight.clear()
            quiet = self._closing or self._expected_death
        for fut, _post, _op, _dl in pending:
            if not fut.done():
                fut.set_exception(exc)
        if was_alive and not quiet:
            _LOG.warning("shard %d worker (pid %s) unreachable with "
                         "%d RPCs in flight: %s", self.shard_id,
                         self.pid, len(pending), exc)

    def _on_reconnect(self, epoch: int) -> None:
        with self._state_lock:
            if self._closing:
                return
            self._alive = True
        cb = None if self._reconnect_cb is None \
            else self._reconnect_cb()
        if cb is not None:
            cb(self.shard_id, epoch)

    def _on_tick(self) -> None:
        """Expire per-RPC deadlines: a reply lost to a drop or a silent
        partition fails fast instead of waiting for the detector."""
        now = time.monotonic()
        expired = []
        with self._state_lock:
            for rid, (fut, _post, op, dl) in list(self._inflight.items()):
                if dl is not None and now > dl:
                    expired.append((fut, op))
                    del self._inflight[rid]
        for fut, op in expired:
            if not fut.done():
                fut.set_exception(ShardWorkerDied(
                    f"shard {self.shard_id} rpc {op!r} missed its "
                    "reply deadline", shard_id=self.shard_id,
                    epoch=self._t.epoch, op=op))

    # -- RPC plumbing ------------------------------------------------------

    def _rpc(self, op: str, payload=None, *, pack=None, post=None,
             deadline_s=_USE_DEFAULT) -> StoreFuture:
        fut = StoreFuture()
        obs = self._obs
        tctx = obs.ctx() if obs is not None else None
        t0 = time.perf_counter() if obs is not None else 0.0
        with self._order_lock:
            rid = None
            try:
                if pack is not None:
                    payload = pack()
                if tctx is not None:
                    # trace envelope: the worker loop unwraps + adopts
                    # it, stitching worker spans into the parent trace
                    payload = ("_tctx", tctx, payload)
                with self._state_lock:
                    if not self._alive:
                        raise ShardWorkerDied(
                            f"shard {self.shard_id} worker is down",
                            shard_id=self.shard_id,
                            epoch=self._t.epoch, op=op)
                    rid = next(self._rids)
                    dls = self._t.default_rpc_deadline() \
                        if deadline_s is _USE_DEFAULT else deadline_s
                    dl = None if dls is None \
                        else time.monotonic() + dls
                    self._inflight[rid] = (fut, post, op, dl)
                # lint: allow(blocking-under-lock): _order_lock must span staging and send so ring order equals wire order
                self._t.send((op, rid, payload))
            except BaseException as e:
                # failed before the frame left: unstage its payloads
                # (next frame's offsets must start clean) and unregister
                self._t.discard_staged()
                if rid is not None:
                    with self._state_lock:
                        self._inflight.pop(rid, None)
                if isinstance(e, ArenaBroken):
                    raise ShardWorkerDied(
                        str(e), shard_id=self.shard_id,
                        epoch=self._t.epoch, op=op) from e
                raise
        if obs is not None:
            def _timed(_f, obs=obs, t0=t0):
                obs.record("rpc.roundtrip_us",
                           (time.perf_counter() - t0) * 1e6)
            fut.add_done_callback(_timed)
        return fut

    def _pack_items(self, items) -> List[tuple]:
        items = list(items.items()) if isinstance(items, dict) \
            else list(items)
        return [(k, self._t.pack(v)) for k, v in items]

    def _post_value(self, as_array: bool):
        """Reply decoder. An array GET becomes a uint8 tensor on the
        frontend's device, copied out of the ring slot (or the inline
        bytes) here, before the slot is released — as the in-process
        store's `get_array` returns a tensor on its device."""
        dev = self._array_device

        def post(desc):
            if desc[0] == "n":
                return None, 0
            if desc[0] == "i":
                raw = desc[1]
                if as_array:
                    return as_u8(raw).to(dev, copy=True), 0
                return raw, 0
            _, pos, n = desc
            view = self._t.reply_view(pos, n)
            if as_array:
                v = torch.from_numpy(view).to(dev, copy=True)
            else:
                v = bytes(view)
            return v, pos + n
        return post

    def _post_map(self, as_arrays: bool):
        one = self._post_value(as_arrays)

        def post(dmap):
            out, wm = {}, 0
            for k, d in dmap.items():
                v, w = one(d)
                out[k] = v
                wm = max(wm, w)
            return out, wm
        return post

    # -- the shard surface -------------------------------------------------

    def put_async(self, key: str, value) -> StoreFuture:
        return self._rpc(
            "put", pack=lambda: (key, self._t.pack(value)))

    def put(self, key: str, value) -> int:
        return self.put_async(key, value).result()

    def put_many_async(self, items, *,
                       raise_on_conflict: bool = False) -> StoreFuture:
        return self._rpc(
            "put_many",
            pack=lambda: (self._pack_items(items), raise_on_conflict))

    def put_many(self, items, *,
                 raise_on_conflict: bool = False) -> Dict[str, int]:
        return self.put_many_async(
            items, raise_on_conflict=raise_on_conflict).result()

    def prepare_put_many_async(self, items, *,
                               raise_on_conflict: bool = False,
                               ticket: Optional[int] = None
                               ) -> StoreFuture:
        return self._rpc(
            "prepare",
            pack=lambda: (self._pack_items(items), raise_on_conflict,
                          ticket))

    def commit_put_many_async(self, prep, *,
                              ticket: Optional[int] = None) -> StoreFuture:
        return self._rpc("commit2pc", (prep, ticket))

    def abort_put_many_async(self, prep) -> StoreFuture:
        return self._rpc("abort2pc", prep)

    def get_async(self, key: str) -> StoreFuture:
        return self._rpc("get", key, post=self._post_value(False))

    def get(self, key: str) -> Optional[bytes]:
        return self.get_async(key).result()

    def get_array(self, key: str) -> Optional[torch.Tensor]:
        return self._rpc("get", key,
                         post=self._post_value(True)).result()

    def get_many_async(self, keys) -> StoreFuture:
        return self._rpc("get_many", (list(keys), False),
                         post=self._post_map(False))

    def get_many(self, keys) -> Dict[str, Optional[bytes]]:
        return self.get_many_async(keys).result()

    def get_many_arrays_async(self, keys) -> StoreFuture:
        return self._rpc("get_many", (list(keys), True),
                         post=self._post_map(True))

    def get_many_arrays(self, keys) -> Dict[str, Optional[torch.Tensor]]:
        return self.get_many_arrays_async(keys).result()

    def flush_async(self, timeout: Optional[float] = None) -> StoreFuture:
        # barrier op: legitimately outlives any per-RPC deadline
        return self._rpc("flush", timeout, deadline_s=None)

    def flush_writeback(self, timeout: Optional[float] = None) -> bool:
        try:
            return self.flush_async(timeout).result()
        except ConnectionError:
            return False             # dead worker: writes NOT persisted

    def gc_tick(self) -> None:
        try:
            self._rpc("gc", deadline_s=None).result()
        except ConnectionError:
            pass                     # dead shard: restart_shard re-GCs

    def indoubt_tickets(self) -> List[int]:
        return self._rpc("indoubt").result()

    def resolve_indoubt(self, ticket: int, *, commit: bool) -> StoreFuture:
        return self._rpc("resolve", (ticket, commit))

    def cos_keys(self, prefix: str = "") -> List[str]:
        try:
            return self._rpc("cos_keys", prefix).result()
        except ConnectionError:
            return []

    def balance_count(self) -> int:
        try:
            return self._rpc("balance").result()
        except ConnectionError:
            return 0

    def ledger_dollars(self) -> Dict[str, float]:
        try:
            return self._rpc("ledger").result()
        except ConnectionError:
            return {}

    def num_functions(self, state=None) -> int:
        try:
            return self._rpc("nfuncs", state).result()
        except ConnectionError:
            return 0

    def pause_writeback(self) -> None:
        self._rpc("pause_wb").result()

    def resume_writeback(self) -> None:
        self._rpc("resume_wb").result()

    @property
    def stats(self) -> StoreStats:
        try:
            snap = StoreStats(**self._rpc("stats").result())
        except (ConnectionError, TypeError):
            return self._stats_cache  # dead: last known counters
        self._stats_cache = snap
        return snap

    def snapshot_metadata(self):
        try:
            snap = self._rpc("snapshot").result()
        except ConnectionError:
            # DOWN here covers heartbeat timeout and partition, not
            # only process death: the transport refuses the RPC the
            # moment the detector declares the worker unreachable
            return {"mt": {}, "chunk_map": {},
                    "health": {"state": "SHARD_DOWN",
                               "indoubt_tickets": [],
                               "writeback": None, "spill_pending": 0,
                               "transport": self._t.health()},
                    "shard_down": True}
        snap["health"]["transport"] = self._t.health()
        return snap

    def transport_health(self) -> dict:
        """Per-shard transport state: CONNECTED/SUSPECT/DOWN/
        RECONNECTING, current epoch, last-heartbeat age."""
        return self._t.health()

    def transport_stats(self) -> dict:
        """Worker-side fencing counters (TCP only): fenced connects,
        stale acks suppressed, duplicate frames dropped."""
        if self._t.kind != "tcp":
            return {}
        return self._rpc("xstats").result()

    def snapshot_metrics(self) -> dict:
        """The worker's ObsPlane snapshot ({} when the worker is down
        or was built without a plane)."""
        try:
            return self._rpc("obs").result() or {}
        except ConnectionError:
            return {}

    # -- lifecycle ---------------------------------------------------------

    def is_alive(self) -> bool:
        with self._state_lock:
            return self._alive

    def simulate_crash(self) -> Optional[str]:
        """REAL kill: SIGKILL the worker mid-flight. Journal segments
        (and the shared COS root) survive on disk for restart_shard.
        Reconnect is suppressed FIRST — a TCP transport must not burn
        its attempt budget dialing a corpse."""
        with self._state_lock:
            self._expected_death = True
        self._t.suppress_reconnect()
        if self.pid is not None:
            try:
                os.kill(self.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        self._t.join(timeout=30.0)
        return self.spill_dir

    def request_close(self, flush: bool) -> Optional[StoreFuture]:
        with self._state_lock:
            self._closing = True
        self._t.suppress_reconnect()
        try:
            return self._rpc("close", flush, deadline_s=None)
        except ShardWorkerDied:
            return None

    def finish_close(self, fut: Optional[StoreFuture],
                     deadline: float) -> bool:
        ok = False
        if fut is not None:
            try:
                ok = fut.result(
                    timeout=max(0.1, deadline - time.monotonic()))
            except Exception:                         # noqa: BLE001
                ok = False
        self.reap(deadline=deadline)
        return ok

    def close(self, *, flush: bool = True) -> bool:
        deadline = time.monotonic() + 120.0
        return self.finish_close(self.request_close(flush), deadline)

    def reap(self, deadline: Optional[float] = None) -> None:
        """Tear down the worker and every parent-side transport
        resource (pipe + /dev/shm segments, or socket + heartbeat
        threads): escalating join -> terminate -> kill inside the
        transport. Idempotent; safe from finalizers and atexit."""
        with self._state_lock:
            self._closing = True
        self._t.reap(deadline=deadline)
        # fail any straggler futures (idempotent if _on_down already ran)
        self._on_down(ShardWorkerDied(
            f"shard {self.shard_id} worker reaped",
            shard_id=self.shard_id, epoch=self._t.epoch, op="reap"))
        self._resources.unregister(self)


# ---------------------------------------------------------------------------
# orphan reaping: finalizers + atexit
# ---------------------------------------------------------------------------

class _HostResources:
    """The set of live worker proxies of ONE store, shared with its
    `weakref.finalize` callback and the module atexit sweep — neither
    holds a reference back to the store, so an abandoned store is
    collectable and its workers/segments still get reaped."""

    def __init__(self) -> None:
        self._lock = make_lock("host._HostResources._lock")
        self._proxies: List[_ShardProxy] = []

    def register(self, p: _ShardProxy) -> None:
        with self._lock:
            self._proxies.append(p)
        with _REGISTRY_LOCK:
            if self not in _LIVE_RESOURCES:
                _LIVE_RESOURCES.append(self)

    def unregister(self, p: _ShardProxy) -> None:
        with self._lock:
            if p in self._proxies:
                self._proxies.remove(p)
            empty = not self._proxies
        if empty:
            with _REGISTRY_LOCK:
                if self in _LIVE_RESOURCES:
                    _LIVE_RESOURCES.remove(self)

    def reap_all(self) -> None:
        with self._lock:
            proxies = list(self._proxies)
        for p in proxies:
            try:
                p.reap()
            except Exception:                         # noqa: BLE001
                pass


_REGISTRY_LOCK = make_lock("host._REGISTRY_LOCK")
_LIVE_RESOURCES: List[_HostResources] = []


@atexit.register
def _reap_orphans() -> None:         # pragma: no cover - exit path
    with _REGISTRY_LOCK:
        resources = list(_LIVE_RESOURCES)
    for r in resources:
        r.reap_all()


# ---------------------------------------------------------------------------
# spawn context
# ---------------------------------------------------------------------------

# what the forkserver imports before it forks workers: this package's
# modules only, none of which touches CUDA at import (each worker's
# store initialises its own CUDA context after the fork)
FORKSERVER_PRELOAD = ("repro_torch.core.host", "repro_torch.core.netshard")

_CTX_LOCK = make_lock("host._CTX_LOCK")
_CTX = None


def _host_context(method: Optional[str] = None):
    """Process-wide spawn context. Default: forkserver with this module
    preloaded — workers fork from a clean template that already
    imported torch + the store stack (fast respawn, no inherited locks,
    threads or CUDA context), falling back to spawn where forkserver is
    unavailable; never fork, which would copy a CUDA context."""
    global _CTX
    if method == "fork":
        raise ValueError("start_method='fork' would copy the parent's "
                         "CUDA context into the worker; use 'forkserver' "
                         "or 'spawn'")
    if method is not None:
        return mp.get_context(method)
    with _CTX_LOCK:
        if _CTX is None:
            try:
                ctx = mp.get_context("forkserver")
                ctx.set_forkserver_preload(list(FORKSERVER_PRELOAD))
                _start_forkserver()
            except ValueError:                        # pragma: no cover
                ctx = mp.get_context("spawn")
            _CTX = ctx
        return _CTX


def _start_forkserver() -> None:
    """Start the forkserver now, with this package's source root on its
    PYTHONPATH. Python 3.12.3 does not hand the parent's `sys.path` to
    the forkserver, so where the package is found through `sys.path`
    alone the preload fails silently and every worker imports torch
    anew (`restart_shard` took 10.4-11.0 s a worker, 0.7-1.4 s with the
    preload, on an H100 80GB HBM3 at 700 W)."""
    from multiprocessing import forkserver
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join([root] + ([old] if old
                                                          else []))
    try:
        forkserver.ensure_running()
    finally:
        if old is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = old


# ---------------------------------------------------------------------------
# the store front-end
# ---------------------------------------------------------------------------

class ProcessShardedStore(ShardedStore):
    """`ShardedStore` whose shards are worker PROCESSES (module
    docstring). Same router, same 2PC leader, same `StoreFrontend`
    conformance — `_make_shard` swaps the in-process `InfiniStore` for
    a `_ShardProxy` over pipe + shared-memory rings.

    The COS root is forced onto disk (a private tempdir when the caller
    gave none): memory-backed COS cannot be shared across processes.
    The parent keeps its own `COS` over the same root for the 2PC
    leader's journal-less decision stubs, so every durable artifact the
    thread-mode store writes lands in the same places here."""

    def __init__(self, cfg=None, *, num_shards: int = 4,
                 router="hash", range_boundaries=None,
                 clock: Optional[Clock] = None,
                 cos_root: Optional[str] = None, seed: int = 0,
                 arena_bytes: int = DEFAULT_ARENA_BYTES,
                 start_method: Optional[str] = None,
                 boot_timeout_s: float = 120.0,
                 cos_latency: Optional[dict] = None,
                 transport: str = "shm",
                 heartbeat: Optional[HeartbeatConfig] = None):
        self._arena_bytes = int(arena_bytes)
        self._cos_latency = dict(cos_latency or {})
        self._boot_timeout_s = float(boot_timeout_s)
        self._transport_kind = transport
        self._heartbeat = heartbeat
        self._ctx = _host_context(start_method)
        self._cos_root_auto = cos_root is None
        if cos_root is None:
            cos_root = tempfile.mkdtemp(prefix="infinistore-cos-")
        self._cos_root_path = cos_root
        self._host_resources = _HostResources()
        self._finalizer = weakref.finalize(
            self, _HostResources.reap_all, self._host_resources)
        try:
            super().__init__(cfg, num_shards=num_shards, router=router,
                             range_boundaries=range_boundaries,
                             clock=clock, cos_root=cos_root, seed=seed)
        except BaseException:
            self._host_resources.reap_all()
            if self._cos_root_auto:
                shutil.rmtree(cos_root, ignore_errors=True)
            raise
        # the parent's COS view (leader decision stubs, direct reads)
        # follows the same latency model the workers were given
        for attr, val in self._cos_latency.items():
            setattr(self.cos, attr, val)

    # -- construction / restart hooks --------------------------------------

    def _make_shard(self, i: int) -> _ShardProxy:
        scfg = dataclasses.replace(self.cfg,
                                   spill_dir=self._shard_spill_dir(i))
        return _ShardProxy(ctx=self._ctx, shard_id=i, cfg=scfg,
                           cos_root=str(self.cos.root),
                           seed=self._seed + i, name=f"s{i}",
                           arena_bytes=self._arena_bytes,
                           resources=self._host_resources,
                           boot_timeout_s=self._boot_timeout_s,
                           cos_latency=self._cos_latency,
                           transport=self._transport_kind,
                           heartbeat=self._heartbeat,
                           faults=getattr(self.cfg, "faults", None),
                           obs=self.obs,
                           on_reconnect=self._shard_reconnected)

    def _shard_reconnected(self, shard_id: int, epoch: int) -> None:
        """Transport reconnected at a new epoch: any 2PC ticket the
        partition stranded is settled by the inherited sweep. Runs off
        the heartbeat thread — the sweep issues RPCs of its own."""
        if getattr(self, "_closed", False):
            return
        threading.Thread(
            target=lambda: _swallow(self.resolve_indoubt),
            name=f"reconnect-sweep-{shard_id}", daemon=True).start()

    def shard_transport_health(self) -> List[dict]:
        """Per-shard transport state (CONNECTED/SUSPECT/DOWN/
        RECONNECTING), current epoch, last-heartbeat age."""
        return [s.transport_health() for s in self.shards]

    # -- observability fan-in -----------------------------------------------

    def _shard_metric_snapshots(self) -> List[dict]:
        """Each live worker's ObsPlane snapshot (per-process histograms,
        spans, flight events) for `snapshot_metrics()` to merge."""
        return [snap for snap in
                (s.snapshot_metrics() for s in self.shards) if snap]

    def transport_metrics(self) -> dict:
        """Per-shard transport health + worker fencing counters, with
        store-wide totals (stale frames are counted on BOTH ends:
        parent reader and worker server)."""
        per: List[dict] = []
        totals = {"reconnects": 0, "fenced_connects": 0,
                  "stale_acks_suppressed": 0, "dup_frames_dropped": 0,
                  "stale_frames_dropped_client": 0,
                  "stale_frames_dropped_server": 0}
        for s in self.shards:
            h = s.transport_health()
            try:
                x = s.transport_stats()
            except ConnectionError:
                x = {}
            per.append({"shard": s.shard_id, "health": h, "xstats": x})
            totals["reconnects"] += h.get("reconnects") or 0
            totals["stale_frames_dropped_client"] += \
                h.get("stale_frames_dropped") or 0
            totals["fenced_connects"] += x.get("fenced_connects", 0)
            totals["stale_acks_suppressed"] += \
                x.get("stale_acks_suppressed", 0)
            totals["dup_frames_dropped"] += x.get("dup_frames_dropped", 0)
            totals["stale_frames_dropped_server"] += \
                x.get("stale_frames_dropped", 0)
        return {"per_shard": per, "totals": totals}

    def restart_shard(self, i: int) -> _ShardProxy:
        """Respawn shard i's worker: the old process (usually already
        SIGKILLed) is reaped — pipe closed, rings unlinked — and the
        fresh worker's `InfiniStore` replays `<spill>/shard-<i>/`
        before reporting ready; the inherited sweep then settles any
        ticket the kill left in doubt."""
        obs = self.obs
        if obs is not None:
            # recover the dead worker's flight file BEFORE the respawn
            # truncates it: its pre-kill events/spans become forensics
            path = os.path.join(self._shard_spill_dir(i), "flight.bin")
            records = FlightRecorder.read_file(path)
            if records:
                obs.add_forensics(f"shard-{i}", records, shard=i)
        self.shards[i].reap()
        return super().restart_shard(i)

    # -- crash / close -----------------------------------------------------

    def simulate_crash(self, shard: Optional[int] = None):
        out = super().simulate_crash(shard)
        if shard is None:
            # transports are parent-side state, not durable state: a
            # "crashed" store's rings and pipes have no replay value
            for s in self.shards:
                s.reap()
        return out

    def close(self, *, flush: bool = True,
              deadline_s: float = 120.0) -> bool:
        """Parallel close: every worker runs its close RPC (drain
        daemon, flush writeback) concurrently under ONE shared
        deadline, then each process is joined with what remains of it,
        escalating to terminate/kill — one stuck shard cannot hold the
        host hostage."""
        if self._closed:
            return True
        self._closed = True
        deadline = time.monotonic() + deadline_s
        self._leader.shutdown(wait=True)
        # Best-effort in-doubt sweep, BOUNDED: the sweep's RPCs have no
        # deadline of their own, so a wedged worker (stopped, livelocked)
        # must not park close() before the reaping even starts. Run it in
        # a side thread with a slice of the budget — once reap() marks a
        # dead shard, the thread's blocked future fails and it exits.
        sweeper = threading.Thread(
            target=lambda: _swallow(self.resolve_indoubt),
            name="host-close-sweep", daemon=True)
        sweeper.start()
        sweeper.join(timeout=min(30.0, max(0.2, deadline_s / 4.0)))
        reqs = [(s, s.request_close(flush)) for s in self.shards]
        oks = [s.finish_close(f, deadline) for s, f in reqs]
        if self._leader_spill is not None:
            self._leader_spill.close()
        self.cos.shutdown()
        if self._spill_auto:
            shutil.rmtree(self._spill_root, ignore_errors=True)
        if self._cos_root_auto:
            shutil.rmtree(self._cos_root_path, ignore_errors=True)
        self._finalizer.detach()
        return all(oks)

    # -- fan-out overrides tuned for cross-process latency ------------------

    def flush_writeback(self, timeout: Optional[float] = None) -> bool:
        """Parallel barrier: one flush RPC per worker, all draining
        concurrently against the caller's single shared deadline."""
        futs = []
        for s in self.shards:
            try:
                futs.append(s.flush_async(timeout))
            except ShardWorkerDied:
                futs.append(None)
        ok = True
        for f in futs:
            if f is None:
                ok = False
                continue
            try:
                ok = f.result() and ok
            except Exception:                         # noqa: BLE001
                ok = False
        return ok

    def cos_keys(self, prefix: str = "") -> List[str]:
        # a disk COS only lists keys the listing process has touched;
        # the union must include the parent's view (leader decision
        # stubs, pre-existing root contents)
        keys = set(super().cos_keys(prefix))
        keys.update(self.cos.list_keys(prefix))
        return sorted(keys)

    # -- introspection ------------------------------------------------------

    def worker_pids(self) -> List[Optional[int]]:
        return [s.pid for s in self.shards]

    def worker_devices(self) -> List[Optional[str]]:
        """Each worker store's device, as its ready reply gave it."""
        return [s.device for s in self.shards]

    def workers_alive(self) -> List[bool]:
        return [s.is_alive() for s in self.shards]
