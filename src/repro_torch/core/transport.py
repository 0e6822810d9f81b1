"""Shard transport plane: the host's control/data plane as an interface.

`ProcessShardedStore` (host.py) drives each shard worker through a
`ShardTransport`.  Two implementations:

- `LocalTransport` — the shared-memory path: a duplex `Pipe` control plane plus
  two `ShmArena` shared-memory rings (request/response) for bulk
  payloads, a worker spawned from `host._worker_main`, and the process
  sentinel as the failure detector.  Epoch is fixed at 1 (a pipe cannot
  reconnect; worker death is final until `restart_shard`).

- `TcpTransport` — the networked path (the real InfiniStore runs its
  client<->proxy split over sockets, ports 6378/6379): RPCs and bulk
  payloads ride length-prefixed frames over a TCP connection to a
  `repro_torch.core.netshard` worker.  The process sentinel is replaced by a
  heartbeat failure detector (`HeartbeatConfig`): pings every
  `interval_s`, CONNECTED -> SUSPECT after `suspect_after_s` without a
  pong, -> DOWN after `dead_after_s`.  A DOWN transport fails every
  in-flight RPC with `ShardWorkerDied` and starts a reconnect loop
  (capped exponential backoff, `RetryPolicy.delay` schedule).  Every
  (re)connection carries a monotonically increasing EPOCH: the worker
  fences connections whose epoch is not newer than its current one, and
  suppresses acks for RPCs that arrived under a previous epoch — a
  zombie worker or stale socket reappearing after a partition cannot
  ack RPCs from a previous incarnation.  Per-RPC deadlines
  (`rpc_deadline_s`) fail calls whose reply never arrives (dropped
  frame, silent partition) without waiting for the detector.

Wire format (TCP): `!IIQ` header — magic, control length, payload
length — followed by a pickled control tuple `(epoch, kind, rid, val)`
and an out-of-band payload section of concatenated raw bytes.  Bulk
values never ride the pickle: request descriptors `("o", off, nbytes)`
point into the frame's payload section, mirroring the arena descriptors
`("a", pos, nbytes)` of the shm path ("i" = inline bytes, "n" = None).
Frames are pickled between mutually-trusting processes of ONE host
deployment — do not expose the listener beyond a trusted network.

Deterministic network chaos: `TcpTransport` fires four `FaultPlan`
sites on every outbound frame, keyed `op:<op>:s<shard>` for data and
`hb:s<shard>` for heartbeats —

    site            action       effect
    --------------  -----------  ----------------------------------
    net.delay       "delay"      sleeps the point's latency_s before
                                 the frame is written
    net.partition   "partition"  blackholes BOTH directions for
                                 `HeartbeatConfig.partition_s` (the
                                 triggering frame is lost; reconnect
                                 attempts fail until the heal)
    net.drop        "drop"       the frame is silently dropped
    net.dup         "dup"        the frame is sent twice (the worker
                                 dedupes by monotonic rid)

Schedules that run alongside heartbeats must use `match` filters (e.g.
``match="op:put:"``): an unmatched fire() consumes no hit index, so the
nondeterministic ping stream cannot shift the data-op schedule.
"""
from __future__ import annotations

import logging
import pickle
import socket
import struct
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from .faults import RetryPolicy
from .ipc import ShmArena, pack_payload
from .locks import make_lock
from .payload import to_bytes
# one class for every frontend: the in-process store raises it too, so a
# single `except ShardWorkerDied` matches whichever frontend raised
from .store import ShardWorkerDied

__all__ = [
    "ShardWorkerDied", "HeartbeatConfig", "ShardTransport",
    "LocalTransport", "TcpTransport", "FrameError",
    "CONNECTED", "SUSPECT", "DOWN", "RECONNECTING",
    "send_frame", "recv_frame",
]

_LOG = logging.getLogger("repro_torch.transport")

# transport states (snapshot_metadata()["health"]["transport"]["state"])
CONNECTED = "CONNECTED"
SUSPECT = "SUSPECT"
DOWN = "DOWN"
RECONNECTING = "RECONNECTING"


@dataclass(frozen=True)
class HeartbeatConfig:
    """Failure-detector + reconnect knobs for `TcpTransport`.

    Defaults are deliberately lazy (10s to DOWN): a busy single-core
    box can starve the worker's reply thread for whole seconds, and a
    false DOWN costs a reconnect epoch.  Tests and the chaos soak run
    much hotter (50ms pings, sub-second death)."""
    interval_s: float = 0.5          # ping period
    suspect_after_s: float = 2.0     # no pong for this long -> SUSPECT
    dead_after_s: float = 10.0       # no pong for this long -> DOWN
    connect_timeout_s: float = 10.0  # bound on connect()+hello/welcome
    rpc_deadline_s: Optional[float] = None   # per-RPC reply deadline
    reconnect: bool = True
    reconnect_max_attempts: int = 8
    reconnect_backoff_base_s: float = 0.05
    reconnect_backoff_cap_s: float = 1.0
    partition_s: float = 1.0         # injected net.partition duration


# ---------------------------------------------------------------------------
# TCP framing
# ---------------------------------------------------------------------------

MAGIC = 0x49535452                   # "ISTR"
_HDR = struct.Struct("!IIQ")         # magic, ctrl_len, payload_len


class FrameError(ConnectionError):
    """The TCP stream closed or desynchronized mid-frame."""


def send_frame(sock: socket.socket, ctrl: tuple,
               bufs: Tuple[bytes, ...] = ()) -> None:
    """One frame: header + pickled control tuple + payload section."""
    cb = pickle.dumps(ctrl, protocol=pickle.HIGHEST_PROTOCOL)
    pl = b"".join(bufs)
    sock.sendall(_HDR.pack(MAGIC, len(cb), len(pl)) + cb + pl)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    bufs: List[bytes] = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise FrameError("connection closed mid-frame")
        bufs.append(b)
        n -= len(b)
    return b"".join(bufs)


def recv_frame(sock: socket.socket) -> Tuple[tuple, bytes]:
    """Returns (control tuple, payload bytes)."""
    magic, cl, pl = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if magic != MAGIC:
        raise FrameError(f"bad frame magic {magic:#x}")
    ctrl = pickle.loads(_recv_exact(sock, cl))
    payload = _recv_exact(sock, pl) if pl else b""
    return ctrl, payload


def _close_sock(s: Optional[socket.socket]) -> None:
    if s is None:
        return
    try:
        s.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        s.close()
    except OSError:
        pass


def _reap_process(proc, deadline: Optional[float]) -> None:
    """Escalating join -> terminate -> kill, bounded by `deadline`."""
    if proc is None:
        return
    try:
        if proc.is_alive():
            budget = 10.0 if deadline is None \
                else max(0.5, deadline - time.monotonic())
            proc.join(timeout=budget)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5.0)
            if proc.is_alive():                       # pragma: no cover
                proc.kill()
                proc.join(timeout=5.0)
    except (ValueError, OSError):
        pass                         # never started / already reaped
    try:
        proc.close()
    except (ValueError, AttributeError):
        pass


# ---------------------------------------------------------------------------
# the interface
# ---------------------------------------------------------------------------

class ShardTransport:
    """Control/data plane to ONE shard worker.

    Lifecycle: `start(on_message=..., on_down=..., ...)` boots the
    worker (or connects to one) and returns its pid; `reap(deadline)`
    tears everything down.  Data plane: `pack(value)` stages one bulk
    payload and returns its descriptor (call under the proxy's order
    lock; `send` flushes the staging), `send((op, rid, payload))`
    transmits one RPC, `reply_view`/`ack_reply` service arena-backed
    reply descriptors.  Callbacks: `on_message((kind, rid, val))` for
    every reply, `on_down(exc)` when the worker becomes unreachable,
    `on_reconnect(epoch)` after a successful re-handshake, `on_tick()`
    every detector interval (the proxy expires RPC deadlines there)."""

    kind = "abstract"

    shard_id: int
    epoch: int = 1
    state: str = DOWN
    pid: Optional[int] = None
    # the worker store's device, from its ready reply (None when the
    # transport attached to a worker it did not boot)
    device: Optional[str] = None

    def start(self, *, on_message: Callable, on_down: Callable,
              on_reconnect: Optional[Callable] = None,
              on_tick: Optional[Callable] = None) -> Optional[int]:
        raise NotImplementedError

    def send(self, msg: tuple) -> None:
        raise NotImplementedError

    def pack(self, value):
        raise NotImplementedError

    def discard_staged(self) -> None:
        """Drop payloads staged by `pack` when the RPC failed pre-send
        (keeps the out-of-band offsets of the NEXT frame correct)."""

    def reply_view(self, pos: int, n: int):
        raise NotImplementedError(f"{self.kind} has no reply arena")

    def ack_reply(self, watermark: int) -> None:
        """Acknowledge consumption of arena-backed reply bytes."""

    def default_rpc_deadline(self) -> Optional[float]:
        return None

    def suppress_reconnect(self) -> None:
        """Stop trying to resurrect the connection (expected death)."""

    def join(self, timeout: float) -> None:
        """Wait for an owned worker process to exit."""

    def health(self) -> dict:
        raise NotImplementedError

    def reap(self, deadline: Optional[float] = None) -> None:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# LocalTransport: pipe control plane + ShmArena data plane
# ---------------------------------------------------------------------------

class LocalTransport(ShardTransport):
    """Pipe + shared-memory rings to a `host._worker_main` process on
    this machine.  Failure detection is the process sentinel; there is
    no reconnect (epoch stays 1) — a dead worker is rebuilt by
    `restart_shard`, which replays the shard's journal."""

    kind = "shm"

    def __init__(self, *, ctx, shard_id: int, spec: dict,
                 arena_bytes: int, boot_timeout_s: float) -> None:
        self.shard_id = shard_id
        self.epoch = 1
        self.state = DOWN
        self.pid = None
        self._ctx = ctx
        self._spec = spec
        self._arena_bytes = int(arena_bytes)
        self._boot_timeout_s = float(boot_timeout_s)
        self._send_lock = make_lock("transport.LocalTransport._send_lock")
        self._req: Optional[ShmArena] = None
        self._resp: Optional[ShmArena] = None
        self._since: Optional[int] = None   # ring head at the frame's start
        self._conn = None
        self._proc = None
        self._closing = False
        self._on_message: Optional[Callable] = None
        self._on_down: Optional[Callable] = None

    def start(self, *, on_message, on_down, on_reconnect=None,
              on_tick=None) -> Optional[int]:
        from . import host              # lazy: host imports this module
        self._on_message = on_message
        self._on_down = on_down
        self._req = ShmArena.create(self._arena_bytes,
                                    tag=f"req{self.shard_id}")
        self._resp = ShmArena.create(self._arena_bytes,
                                     tag=f"resp{self.shard_id}")
        parent_conn, child_conn = self._ctx.Pipe()
        self._conn = parent_conn
        spec = dict(self._spec, req_name=self._req.name,
                    resp_name=self._resp.name,
                    arena_bytes=self._arena_bytes, conn=child_conn)
        self._proc = self._ctx.Process(
            target=host._worker_main, args=(spec,), daemon=True,
            name=f"infinistore-shard-{self.shard_id}")
        self._proc.start()
        child_conn.close()
        if not parent_conn.poll(self._boot_timeout_s):
            raise ShardWorkerDied(
                f"shard {self.shard_id} worker failed to boot within "
                f"{self._boot_timeout_s}s", shard_id=self.shard_id,
                epoch=self.epoch, op="boot")
        try:
            kind, _rid, val = parent_conn.recv()
        except (EOFError, OSError) as e:
            raise ShardWorkerDied(
                f"shard {self.shard_id} worker died during boot (spawn "
                "re-imports __main__: guard scripts with "
                "if __name__ == '__main__')", shard_id=self.shard_id,
                epoch=self.epoch, op="boot") from e
        if kind == "err":
            raise val if isinstance(val, BaseException) \
                else ShardWorkerDied(str(val), shard_id=self.shard_id,
                                     epoch=self.epoch, op="boot")
        self.pid, self.device = val
        self.state = CONNECTED
        threading.Thread(target=self._read_loop, daemon=True,
                         name=f"shard-host-rx-{self.shard_id}").start()
        return self.pid

    # -- reader thread -----------------------------------------------------

    def _read_loop(self) -> None:
        from multiprocessing import connection as mpc
        conn, sentinel = self._conn, self._proc.sentinel
        while True:
            try:
                ready = mpc.wait([conn, sentinel])
            except OSError:
                break
            if conn in ready:
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    break
                self._deliver(msg)
            elif sentinel in ready:
                # the process died: drain replies already buffered,
                # then fail what's left
                try:
                    while conn.poll(0):
                        self._deliver(conn.recv())
                except (EOFError, OSError):
                    pass
                break
        self._mark_dead()

    def _deliver(self, msg) -> None:
        kind, _rid, val = msg
        if kind == "rel":                # request-ring watermark ack
            self._req.release_to(val)
            return
        self._on_message(msg)

    def _mark_dead(self) -> None:
        self.state = DOWN
        exc = ShardWorkerDied(
            f"shard {self.shard_id} worker (pid {self.pid}) died",
            shard_id=self.shard_id, epoch=self.epoch)
        if self._req is not None:
            self._req.fail(exc)
        if self._resp is not None:
            self._resp.fail(exc)
        if self._on_down is not None:
            self._on_down(exc)

    # -- data plane ----------------------------------------------------------

    def send(self, msg: tuple) -> None:
        self._since = None               # the staged frame leaves now
        with self._send_lock:
            try:
                # lint: allow(blocking-under-lock): _send_lock's critical section IS the pipe write
                self._conn.send(msg)
            except (OSError, ValueError, BrokenPipeError) as e:
                raise ShardWorkerDied(
                    f"shard {self.shard_id} worker pipe broken",
                    shard_id=self.shard_id, epoch=self.epoch,
                    op=msg[0]) from e

    def pack(self, value):
        # the frame's payloads share the ring with nothing the worker
        # can release before the frame is sent (ipc.ShmArena.fits)
        if self._since is None:
            self._since = self._req.head
        return pack_payload(self._req, value, since=self._since)

    def discard_staged(self) -> None:
        self._since = None

    def reply_view(self, pos: int, n: int):
        return self._resp.view(pos, n)

    def ack_reply(self, watermark: int) -> None:
        with self._send_lock:
            try:
                # lint: allow(blocking-under-lock): release watermark shares the serialized pipe write
                self._conn.send(("release", 0, watermark))
            except (OSError, ValueError, BrokenPipeError):
                pass

    # -- lifecycle -----------------------------------------------------------

    def join(self, timeout: float) -> None:
        if self._proc is not None:
            self._proc.join(timeout=timeout)

    def health(self) -> dict:
        return {"kind": self.kind, "state": self.state,
                "epoch": self.epoch, "last_heartbeat_age_s": None,
                "reconnects": 0, "pid": self.pid, "addr": None}

    def reap(self, deadline: Optional[float] = None) -> None:
        self._closing = True
        # tell the worker to exit BEFORE closing the pipe: recv-EOF
        # delivery is not reliable on this transport, so a healthy
        # worker leaves on the explicit "bye" and the join below
        # returns immediately instead of burning the budget
        if self._conn is not None:
            with self._send_lock:
                try:
                    # lint: allow(blocking-under-lock): final 'bye' shares the serialized pipe write
                    self._conn.send(("bye", 0, None))
                except (OSError, ValueError, BrokenPipeError):
                    pass             # worker already gone
            try:
                self._conn.close()
            except OSError:
                pass
        _reap_process(self._proc, deadline)
        self.state = DOWN
        exc = ShardWorkerDied(
            f"shard {self.shard_id} worker reaped",
            shard_id=self.shard_id, epoch=self.epoch)
        for arena in (self._req, self._resp):
            if arena is not None:
                arena.fail(exc)
                arena.close()        # owner: close + unlink


# ---------------------------------------------------------------------------
# TcpTransport: framed sockets + heartbeat detector + epoch fencing
# ---------------------------------------------------------------------------

class TcpTransport(ShardTransport):
    """Framed RPCs over a loopback/LAN socket to a `netshard` worker
    (module docstring).  `spec` spawns a worker through `ctx`; `addr`
    instead attaches to one that is already listening (tests, off-box
    deployment)."""

    kind = "tcp"

    def __init__(self, *, shard_id: int, ctx=None,
                 spec: Optional[dict] = None,
                 addr: Optional[Tuple[str, int]] = None,
                 hb: Optional[HeartbeatConfig] = None,
                 boot_timeout_s: float = 120.0,
                 faults=None, seed: int = 0) -> None:
        if spec is None and addr is None:
            raise ValueError("TcpTransport needs a worker spec or addr")
        self.shard_id = shard_id
        self.epoch = 0                   # first connect makes it 1
        self.state = DOWN
        self.pid = None
        self.hb = hb or HeartbeatConfig()
        self.reconnects = 0
        self.stale_frames_dropped = 0
        self._ctx = ctx
        self._spec = spec
        self._addr = addr
        self._boot_timeout_s = float(boot_timeout_s)
        self._faults = faults
        # parent-side ObsPlane (attached by _ShardProxy): heartbeat-age
        # samples + SUSPECT/DOWN/reconnect flight events. None = free.
        self.obs = None
        self._backoff = RetryPolicy(
            max_attempts=self.hb.reconnect_max_attempts,
            backoff_base_s=self.hb.reconnect_backoff_base_s,
            backoff_cap_s=self.hb.reconnect_backoff_cap_s, seed=seed)
        self._lock = make_lock("transport.TcpTransport._lock")    # sock/epoch/state/last_pong
        self._send_lock = make_lock("transport.TcpTransport._send_lock")
        self._conn_lock = make_lock("transport.TcpTransport._conn_lock")   # one (re)connect at a time
        self._sock: Optional[socket.socket] = None
        self._last_pong: Optional[float] = None
        self._partition_until = 0.0
        self._out_bufs: List[bytes] = []
        self._out_len = 0
        self._pings = 0
        self._suppress = False
        self._closing = False
        self._boot = None
        self._proc = None
        self._hb_stop = threading.Event()
        self._on_message: Optional[Callable] = None
        self._on_down: Optional[Callable] = None
        self._on_reconnect: Optional[Callable] = None
        self._on_tick: Optional[Callable] = None

    # -- boot ----------------------------------------------------------------

    def start(self, *, on_message, on_down, on_reconnect=None,
              on_tick=None) -> Optional[int]:
        self._on_message = on_message
        self._on_down = on_down
        self._on_reconnect = on_reconnect
        self._on_tick = on_tick
        if self._addr is None:
            from . import netshard      # lazy: netshard imports host
            parent_conn, child_conn = self._ctx.Pipe()
            self._boot = parent_conn
            spec = dict(self._spec, conn=child_conn)
            self._proc = self._ctx.Process(
                target=netshard._net_worker_main, args=(spec,),
                daemon=True,
                name=f"infinistore-netshard-{self.shard_id}")
            self._proc.start()
            child_conn.close()
            if not parent_conn.poll(self._boot_timeout_s):
                raise ShardWorkerDied(
                    f"shard {self.shard_id} net worker failed to boot "
                    f"within {self._boot_timeout_s}s",
                    shard_id=self.shard_id, epoch=0, op="boot")
            try:
                kind, _rid, val = parent_conn.recv()
            except (EOFError, OSError) as e:
                raise ShardWorkerDied(
                    f"shard {self.shard_id} net worker died during "
                    "boot", shard_id=self.shard_id, epoch=0,
                    op="boot") from e
            if kind == "err":
                raise val if isinstance(val, BaseException) \
                    else ShardWorkerDied(str(val),
                                         shard_id=self.shard_id,
                                         epoch=0, op="boot")
            self.pid, port, self.device = val
            self._addr = ("127.0.0.1", port)
        self._connect(self.hb.connect_timeout_s)
        threading.Thread(target=self._hb_loop, daemon=True,
                         name=f"shard-hb-{self.shard_id}").start()
        return self.pid

    # -- connection management ----------------------------------------------

    def _connect(self, timeout: float) -> None:
        """One bounded connect + hello/welcome handshake at epoch+1.
        Every path through here is covered by `timeout` (socket-level),
        so `close()`/`restart_shard` against a half-connected worker
        cannot hang past their own deadline."""
        with self._conn_lock:
            if time.monotonic() < self._partition_until:
                raise ShardWorkerDied(
                    f"shard {self.shard_id} is partitioned",
                    shard_id=self.shard_id, epoch=self.epoch,
                    op="connect")
            ep = self.epoch + 1
            try:
                # lint: allow(blocking-under-lock): _conn_lock serializes connect+handshake; bounded by connect timeout
                s = socket.create_connection(self._addr, timeout=timeout)
            except OSError as e:
                raise ShardWorkerDied(
                    f"shard {self.shard_id} connect to {self._addr} "
                    f"failed: {e}", shard_id=self.shard_id, epoch=ep,
                    op="connect") from e
            try:
                s.settimeout(timeout)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                # lint: allow(blocking-under-lock): handshake frame under _conn_lock; socket timeout bounds it
                send_frame(s, (ep, "hello", 0, None))
                # lint: allow(blocking-under-lock): handshake reply under _conn_lock; socket timeout bounds it
                ctrl, _ = recv_frame(s)
                _fep, kind, _rid, val = ctrl
                if kind != "welcome":
                    raise FrameError(f"handshake rejected: {kind!r}")
                s.settimeout(None)
            except (OSError, FrameError, pickle.PickleError) as e:
                _close_sock(s)
                raise ShardWorkerDied(
                    f"shard {self.shard_id} handshake at epoch {ep} "
                    f"failed: {e}", shard_id=self.shard_id, epoch=ep,
                    op="connect") from e
            if self.pid is None:
                self.pid = val
            with self._lock:
                old, self._sock = self._sock, s
                self.epoch = ep
                self._last_pong = time.monotonic()
                self.state = CONNECTED
            _close_sock(old)
            threading.Thread(target=self._read_loop, args=(s, ep),
                             daemon=True,
                             name=f"shard-rx-{self.shard_id}").start()

    def _read_loop(self, sock: socket.socket, ep: int) -> None:
        while True:
            try:
                ctrl, payload = recv_frame(sock)
            except (OSError, FrameError, pickle.PickleError,
                    EOFError):
                break
            with self._lock:
                current = sock is self._sock
                cur_epoch = self.epoch
            if not current:
                break                    # superseded by a newer epoch
            if time.monotonic() < self._partition_until:
                continue                 # blackhole inbound too
            fep, kind, rid, val = ctrl
            if fep != cur_epoch:
                self.stale_frames_dropped += 1
                continue
            if kind == "pong":
                with self._lock:
                    self._last_pong = time.monotonic()
                continue
            if kind == "val":
                val = _resolve_frame_descs(val, payload)
            self._on_message((kind, rid, val))
        with self._lock:
            current = sock is self._sock
        if current and not self._closing:
            self._declare_down("connection lost")

    def _declare_down(self, why: str) -> None:
        with self._lock:
            if self.state in (DOWN, RECONNECTING):
                return
            self.state = DOWN
            sock, self._sock = self._sock, None
        _close_sock(sock)
        obs = self.obs
        if obs is not None:
            obs.event("transport.down", shard=self.shard_id,
                      epoch=self.epoch, why=why)
        exc = ShardWorkerDied(
            f"shard {self.shard_id} worker unreachable at epoch "
            f"{self.epoch}: {why}", shard_id=self.shard_id,
            epoch=self.epoch)
        if self._on_down is not None:
            self._on_down(exc)
        if self.hb.reconnect and not self._suppress \
                and not self._closing:
            with self._lock:
                self.state = RECONNECTING
            threading.Thread(target=self._reconnect_loop, daemon=True,
                             name=f"shard-reconn-{self.shard_id}"
                             ).start()

    def _reconnect_loop(self) -> None:
        for attempt in range(1, self.hb.reconnect_max_attempts + 1):
            if self._closing or self._suppress:
                break
            time.sleep(self._backoff.delay(attempt))
            if self._closing or self._suppress:
                break
            try:
                self._connect(self.hb.connect_timeout_s)
            except ShardWorkerDied:
                continue
            self.reconnects += 1
            _LOG.info("shard %d reconnected at epoch %d (attempt %d)",
                      self.shard_id, self.epoch, attempt)
            obs = self.obs
            if obs is not None:
                obs.event("transport.reconnect", shard=self.shard_id,
                          epoch=self.epoch, attempt=attempt)
            if self._on_reconnect is not None:
                self._on_reconnect(self.epoch)
            return
        with self._lock:
            if self.state == RECONNECTING:
                self.state = DOWN    # permanent until restart_shard

    # -- heartbeat loop ------------------------------------------------------

    def _hb_loop(self) -> None:
        hb = self.hb
        while not self._hb_stop.wait(hb.interval_s):
            if self._closing:
                break
            if self._on_tick is not None:
                self._on_tick()      # proxy expires RPC deadlines
            with self._lock:
                state = self.state
                last = self._last_pong
            if state in (DOWN, RECONNECTING):
                continue             # the reconnect loop owns recovery
            self._pings += 1
            try:
                self._transmit("ping", self._pings, None, (),
                               f"hb:s{self.shard_id}")
            except ShardWorkerDied:
                pass                 # the reader declares the down
            age = time.monotonic() - (last or 0.0)
            obs = self.obs
            if obs is not None and last is not None:
                obs.record("transport.heartbeat_age_us", age * 1e6)
            if age > hb.dead_after_s:
                self._declare_down(f"heartbeat timeout ({age:.2f}s "
                                   f"since last pong)")
            elif age > hb.suspect_after_s:
                with self._lock:
                    became_suspect = self.state == CONNECTED
                    if became_suspect:
                        self.state = SUSPECT
                if became_suspect and obs is not None:
                    obs.event("transport.suspect", shard=self.shard_id,
                              epoch=self.epoch, age_s=round(age, 3))
            else:
                with self._lock:
                    if self.state == SUSPECT:
                        self.state = CONNECTED

    # -- data plane ----------------------------------------------------------

    def pack(self, value):
        # a device tensor crosses as host bytes (one device-to-host copy)
        raw = to_bytes(value)
        off = self._out_len
        self._out_bufs.append(raw)
        self._out_len += len(raw)
        return ("o", off, len(raw))

    def discard_staged(self) -> None:
        self._out_bufs = []
        self._out_len = 0

    def send(self, msg: tuple) -> None:
        op, rid, payload = msg
        bufs, self._out_bufs, self._out_len = self._out_bufs, [], 0
        self._transmit(op, rid, payload, tuple(bufs),
                       f"op:{op}:s{self.shard_id}")

    def _transmit(self, kind: str, rid: int, val, bufs, key: str) -> None:
        if time.monotonic() < self._partition_until:
            return                   # blackholed: the frame is lost
        f = self._faults
        dup = False
        if f is not None:
            f.fire("net.delay", key)             # latency inside fire()
            if f.fire("net.partition", key) == "partition":
                self._partition_until = \
                    time.monotonic() + self.hb.partition_s
                return               # the triggering frame is lost too
            if f.fire("net.drop", key) == "drop":
                return
            dup = f.fire("net.dup", key) == "dup"
        with self._lock:
            sock, ep = self._sock, self.epoch
        if sock is None:
            raise ShardWorkerDied(
                f"shard {self.shard_id} transport is down",
                shard_id=self.shard_id, epoch=ep, op=kind)
        ctrl = (ep, kind, rid, val)
        try:
            with self._send_lock:
                # lint: allow(blocking-under-lock): _send_lock's critical section IS the frame write
                send_frame(sock, ctrl, bufs)
                if dup:
                    # lint: allow(blocking-under-lock): fault-injected dup frame shares the serialized write
                    send_frame(sock, ctrl, bufs)
        except OSError as e:
            raise ShardWorkerDied(
                f"shard {self.shard_id} socket send failed ({kind}): "
                f"{e}", shard_id=self.shard_id, epoch=ep,
                op=kind) from e

    def default_rpc_deadline(self) -> Optional[float]:
        return self.hb.rpc_deadline_s

    # -- test / chaos hooks --------------------------------------------------

    def _force_partition(self, duration_s: float) -> None:
        """Blackhole both directions for `duration_s` (tests)."""
        self._partition_until = time.monotonic() + duration_s

    # -- lifecycle -----------------------------------------------------------

    def suppress_reconnect(self) -> None:
        self._suppress = True

    def join(self, timeout: float) -> None:
        if self._proc is not None:
            self._proc.join(timeout=timeout)

    def health(self) -> dict:
        with self._lock:
            age = None if self._last_pong is None \
                else max(0.0, time.monotonic() - self._last_pong)
            return {"kind": self.kind, "state": self.state,
                    "epoch": self.epoch,
                    "last_heartbeat_age_s": age,
                    "reconnects": self.reconnects,
                    "stale_frames_dropped": self.stale_frames_dropped,
                    "pid": self.pid, "addr": self._addr}

    def reap(self, deadline: Optional[float] = None) -> None:
        self._closing = True
        self._suppress = True
        self._hb_stop.set()
        if self._boot is not None:
            try:
                self._boot.send(("bye", 0, None))
            except (OSError, ValueError, BrokenPipeError):
                pass
            try:
                self._boot.close()
            except OSError:
                pass
        with self._lock:
            sock, self._sock = self._sock, None
            self.state = DOWN
        _close_sock(sock)
        _reap_process(self._proc, deadline)


def _resolve_frame_descs(val, payload: bytes):
    """Materialize out-of-band reply descriptors `("o", off, n)` against
    the frame's payload section, yielding the inline form the proxy's
    desc handlers already speak.  `val` is one descriptor or a
    {key: descriptor} map (get_many); everything else passes through."""
    def one(d):
        if isinstance(d, tuple) and d and d[0] == "o":
            _, off, n = d
            return ("i", payload[off:off + n])
        return d
    if isinstance(val, dict):
        return {k: one(d) for k, d in val.items()}
    return one(val)
