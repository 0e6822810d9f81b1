"""Networked shard worker: the TCP peer of `transport.TcpTransport`.

One process owning a full `InfiniStore`, serving the host's RPCs over
framed loopback/LAN sockets instead of pipe + shm rings (the real
InfiniStore's client<->proxy split over ports 6378/6379).  The dispatch
surface is EXACTLY `host._WorkerLoop` — this module only swaps the
byte plane:

- requests arrive as frames whose out-of-band payload section carries
  the bulk bytes; descriptors `("o", off, n)` map to read-only numpy
  views over the frame blob, each copied onto the store's device at
  submission (the store keeps no reference to the frame);
- replies stage `("o", off, n)` payloads per callback thread and flush
  them as one frame under `resp_lock` (pack+send = one unit, exactly
  the ordering contract of the shm response ring).

Robustness contracts served here:

- **Epoch fencing**: a `hello` whose epoch is not strictly newer than
  the adopted one is refused (`fenced` reply, counted) — a stale
  parent socket reappearing after a partition cannot take the shard
  over. Adopting a NEWER epoch closes the previous socket and drops
  its prepared-batch handles: the store-side prepared state stays
  in-doubt and the leader's `resolve_indoubt` sweep settles it.
- **Stale-ack suppression**: every data rid records its arrival epoch;
  a reply whose rid predates the current epoch is swallowed (counted),
  so an RPC issued before a partition can never be acked after it.
- **Rid dedupe**: rids are strictly monotonic per parent, so a frame
  whose rid is <= the highest seen is a duplicate (`net.dup`
  injection, or a retransmitting relay) and is dropped, not re-run.
- A broken connection does NOT exit the process: the worker keeps its
  store hot and waits for the parent to reconnect at a newer epoch.
  Shutdown is the explicit "bye" on the bootstrap pipe (or parent
  death, caught by the ppid watchdog) — same contract as the shm
  worker.

`xstats` (an op the server answers itself) exposes the fencing
counters to tests and the chaos soak.
"""
from __future__ import annotations

import logging
import os
import signal
import socket
import threading
from typing import Dict, Optional

import numpy as np

from .clock import Clock
from .host import (_one_thread, _portable_exc, _swallow, _warm_device,
                   _WorkerLoop)
from .locks import make_lock
from .payload import as_u8, to_bytes
from .store import InfiniStore
from .transport import FrameError, recv_frame, send_frame

__all__ = ["_net_worker_main"]

_LOG = logging.getLogger("repro_torch.netshard")


def _net_worker_main(spec: dict) -> None:
    """Entry point of one networked shard worker process."""
    try:
        signal.signal(signal.SIGINT, signal.SIG_IGN)
    except (ValueError, OSError):                     # pragma: no cover
        pass
    _one_thread()
    conn = spec["conn"]

    def boot_send(msg) -> None:
        try:
            conn.send(msg)
        except (OSError, ValueError, BrokenPipeError):
            pass                     # parent gone: nothing left to tell

    lsock = None
    try:
        store = InfiniStore(spec["cfg"], clock=Clock(),
                            cos_root=spec["cos_root"],
                            seed=spec["seed"], name=spec["name"])
        for attr, val in spec.get("cos_latency", {}).items():
            setattr(store.cos, attr, val)
        _warm_device(store)
        lsock = socket.create_server(("127.0.0.1", 0), backlog=4)
    except BaseException as e:                        # noqa: BLE001
        boot_send(("err", -1, _portable_exc(e)))
        return
    # "ready" only after construction AND bind: journal replay is
    # included, and the reported port is accept()able immediately; the
    # store's device rides along so the parent can check where it runs
    boot_send(("ok", -1, (os.getpid(), lsock.getsockname()[1],
                          str(store.device))))
    server = _NetShardServer(store, lsock, conn)
    try:
        server.run()
    finally:
        server.shutdown()


class _NetWorkerLoop(_WorkerLoop):
    """`_WorkerLoop` over frame descriptors instead of arena slots.
    `run()` is never called — the server's per-connection readers feed
    `dispatch` directly."""

    def __init__(self, store: InfiniStore,
                 server: "_NetShardServer") -> None:
        super().__init__(store, None, None, None, server.reply)
        self.server = server

    def _unpack(self, desc):
        if desc[0] == "o":
            _, off, n = desc
            # a view over the frame blob, copied onto the store's
            # device here: the store keeps its own bytes, not the frame
            view = np.frombuffer(self.server.tls.frame, np.uint8,
                                 count=n, offset=off)
            return as_u8(view).to(self.store.device, copy=True)
        if desc[0] == "i":
            return desc[1]
        raise ValueError(f"unknown net payload descriptor {desc!r}")

    def _pack_result(self, v, since=None):
        if v is None:
            return ("n",)
        # a device tensor crosses as host bytes (one device-to-host copy)
        return self.server.stage(to_bytes(v))


class _NetShardServer:
    """Accept loop + per-connection frame readers for one worker."""

    def __init__(self, store: InfiniStore, lsock: socket.socket,
                 boot_conn) -> None:
        self.store = store
        self.lsock = lsock
        self.boot = boot_conn
        self.loop = _NetWorkerLoop(store, self)
        self.tls = threading.local()     # .frame / .staged / .off
        self.epoch = 0
        self._sock: Optional[socket.socket] = None
        self._lock = make_lock("netshard._NetShardServer._lock")    # sock/epoch/rid bookkeeping
        self._send_lock = make_lock("netshard._NetShardServer._send_lock")
        self._rid_epoch: Dict[int, int] = {}
        self._last_rid = 0
        self.fenced_connects = 0
        self.stale_frames_dropped = 0
        self.stale_acks_suppressed = 0
        self.dup_frames_dropped = 0
        self._stop = False

    # -- accept loop ---------------------------------------------------------

    def run(self) -> None:
        self.lsock.settimeout(0.5)
        ppid = os.getppid()
        while not self._stop:
            try:
                if self.boot.poll(0):
                    op, _rid, _p = self.boot.recv()
                    if op == "bye":
                        return       # parent is reaping us: exit now
            except (EOFError, OSError):
                return               # parent closed (or died): exit
            if os.getppid() != ppid:
                return               # parent died without a bye
            try:
                c, _addr = self.lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self._handshake(c)

    def _handshake(self, c: socket.socket) -> None:
        try:
            c.settimeout(5.0)
            ctrl, _ = recv_frame(c)
            ep, kind, _rid, _val = ctrl
            if kind != "hello":
                raise FrameError(f"expected hello, got {kind!r}")
        except Exception:                             # noqa: BLE001
            _swallow(c.close)
            return
        with self._lock:
            if ep <= self.epoch:
                self.fenced_connects += 1
                fenced = True
            else:
                fenced = False
                old, self._sock = self._sock, c
                self.epoch = ep
        if fenced:
            # a stale incarnation of the parent (or a zombie socket):
            # refuse — it may not take the shard over
            try:
                send_frame(c, (ep, "fenced", 0, None))
            except OSError:
                pass
            _swallow(c.close)
            return
        if old is not None:
            _swallow(old.close)      # fence the superseded connection
        # prepared handles of earlier epochs are unreachable now; the
        # store-side prepared state stays journaled in-doubt and the
        # leader sweep rolls it per the durable decision
        self.loop.preps.clear()
        obs = self.store.obs
        if obs is not None:
            # spans/events recorded from here on belong to this epoch;
            # post-SIGKILL forensics can attribute them across restarts
            obs.set_epoch(ep)
            obs.event("epoch.bump", epoch=ep)
        try:
            c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            c.settimeout(None)
            send_frame(c, (ep, "welcome", 0, os.getpid()))
        except OSError:
            _swallow(c.close)
            return
        threading.Thread(target=self._conn_loop, args=(c, ep),
                         daemon=True,
                         name=f"netshard-rx-e{ep}").start()

    # -- per-connection reader ----------------------------------------------

    def _conn_loop(self, c: socket.socket, ep: int) -> None:
        while True:
            try:
                ctrl, payload = recv_frame(c)
            except Exception:                         # noqa: BLE001
                break                # parent gone: await a reconnect
            with self._lock:
                if ep != self.epoch:
                    break            # fenced while reading
                fep, kind, rid, val = ctrl
                if fep != ep:
                    self.stale_frames_dropped += 1
                    continue
                if kind == "ping":
                    pass             # not a data rid: no dedupe entry
                elif rid <= self._last_rid:
                    self.dup_frames_dropped += 1
                    continue
                else:
                    self._last_rid = rid
                    self._rid_epoch[rid] = ep
            if kind == "ping":
                self._send_frame("pong", rid, None, ())
                continue
            if kind == "xstats":
                self.reply(("ok", rid, self.xstats()))
                continue
            self.tls.frame = payload
            try:
                self.loop.dispatch(kind, rid, val)
            except BaseException as e:                # noqa: BLE001
                self.reply(("err", rid, _portable_exc(e)))

    # -- reply plane ---------------------------------------------------------

    def stage(self, raw: bytes):
        """Stage one reply payload on THIS callback thread; offsets
        reset per frame (the send pops the staging)."""
        tls = self.tls
        staged = getattr(tls, "staged", None)
        if staged is None:
            staged = tls.staged = []
            tls.off = 0
        off = tls.off
        staged.append(raw)
        tls.off += len(raw)
        return ("o", off, len(raw))

    def _pop_staged(self):
        tls = self.tls
        staged = getattr(tls, "staged", None) or []
        tls.staged = []
        tls.off = 0
        return staged

    def reply(self, msg) -> None:
        """The loop's send callable: epoch-fence the ack, then frame it.
        A reply for a rid that arrived under an older epoch is
        SWALLOWED — the parent already failed that RPC when it declared
        the epoch dead, and a late ack must not resurrect it."""
        kind, rid, val = msg
        staged = self._pop_staged()
        if kind != "val":
            staged = []              # discard a failed pack's leftovers
        with self._lock:
            ep = self._rid_epoch.pop(rid, None)
            if ep is not None and ep != self.epoch:
                self.stale_acks_suppressed += 1
                return
        self._send_frame(kind, rid, val, tuple(staged))

    def _send_frame(self, kind: str, rid: int, val, bufs) -> None:
        with self._lock:
            c, ep = self._sock, self.epoch
        if c is None:
            return
        try:
            with self._send_lock:
                # lint: allow(blocking-under-lock): _send_lock's critical section IS the frame pack+send
                send_frame(c, (ep, kind, rid, val), bufs)
        except OSError:
            pass                     # conn broke: parent reconnects

    def xstats(self) -> dict:
        with self._lock:
            return {"epoch": self.epoch,
                    "fenced_connects": self.fenced_connects,
                    "stale_frames_dropped": self.stale_frames_dropped,
                    "stale_acks_suppressed": self.stale_acks_suppressed,
                    "dup_frames_dropped": self.dup_frames_dropped,
                    "preps_held": len(self.loop.preps),
                    "rids_tracked": len(self._rid_epoch)}

    # -- shutdown ------------------------------------------------------------

    def shutdown(self) -> None:
        self._stop = True
        self.loop.shutdown()
        with self._lock:
            c, self._sock = self._sock, None
        if c is not None:
            _swallow(c.close)
        _swallow(self.lsock.close)
