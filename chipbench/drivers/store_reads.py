"""Read-only traffic against one InfiniStore on the card: a closed loop of
single-key array GETs over a dataset that set-up writes once.

Set-up draws the objects' bytes on the device from the seed, PUTs them
through `put_many` (encode, slabs, spill journal, async writeback to the
in-memory COS), a few objects at a time, and takes a digest of each
before it drops its own copy; it waits for the writeback and reclaims
the slabs that hold the mix's `lose_chunks` of the objects. The window
keeps `in_flight` GETs outstanding through the store's async API; each
one is timed from its issue to the completion of its own device work
(a CUDA event recorded as its future resolves).

Every seed gets the same work: the sizes are fixed quantiles of a
log-uniform law, fixed to popularity ranks, and one cycle of requests
holds each rank its zipfian share; the seed draws the bytes and the
order of the cycle.

The check: every GET of the window and of the warm-up returned a tensor
of its object's length; the digest, taken on the card as it completed,
of every warm-up GET and of a sample of the window's (the same places
in every cycle, so spread over the whole window; see `checked`) equals
the digest of the bytes PUT; the parity chunks that the slabs hold for
a sample of objects (the largest among them) equal the NumPy
reference's encode.
"""
from __future__ import annotations

import queue
import time
from typing import List

import numpy as np

from chipbench.reference import gf256_rs


def object_sizes(mix: dict) -> List[int]:
    """Bytes of the object at each popularity rank: the `objects`
    quantiles of a log-uniform law on [size_min, size_max], dealt to the
    ranks in one fixed order."""
    n = mix["objects"]
    lo, hi = np.log(mix["size_min_bytes"]), np.log(mix["size_max_bytes"])
    q = np.exp(lo + (np.arange(n) + 0.5) / n * (hi - lo))
    order = np.random.default_rng(0).permutation(n)
    return [int(round(q[i])) for i in order]


def zipf_counts(mix: dict) -> np.ndarray:
    """Requests of each rank in one cycle: its zipfian share."""
    n, theta = mix["objects"], mix["zipf_theta"]
    p = 1.0 / np.arange(1, n + 1) ** theta
    p /= p.sum()
    return np.maximum(1, np.round(p * mix["cycle_requests"])).astype(int)


def request_cycle(mix: dict, seed: int) -> np.ndarray:
    """One cycle of ranks to request, in an order drawn from the seed."""
    counts = zipf_counts(mix)
    ranks = np.repeat(np.arange(mix["objects"]), counts)
    return np.random.default_rng(seed).permutation(ranks)


def store_config(run):
    from repro_torch.core.ec import ECConfig
    from repro_torch.core.store import StoreConfig
    c = run.config
    obs = None
    if run.trace:
        from repro_torch.obs import ObsPlane
        obs = ObsPlane(name="chipbench")
    return StoreConfig(
        ec=ECConfig(c["ec"]["k"], c["ec"]["p"]), device=str(run.device),
        function_capacity=c["function_capacity_bytes"],
        fragment_bytes=c["fragment_bytes"],
        enable_recovery=c["enable_recovery"],
        async_writeback=c["async_writeback"],
        spill_dir="auto" if c["spill_journal"] else None,
        spill_fsync=c["spill_fsync"], obs=obs)


def chunk_keys(store, key: str, idx: int) -> List[str]:
    m = store.mt.load(key)
    return [f"{key}|{m.ver}/f{fi}#{idx}" for fi in range(m.num_fragments)]


BLOCK = 4096          # bytes in a row of the digest's word matrix
PUT_GROUP = 8         # objects drawn and PUT together in set-up


def digest_weights(max_bytes: int, device):
    """Position weights 1, 2, ... for every number `digest` sums."""
    import torch
    n = max_bytes // BLOCK + 1 + BLOCK // 4 + BLOCK
    return torch.arange(1, n + 1, dtype=torch.int64, device=device)


def digest(x, weights):
    """One int64 of a flat uint8 tensor's bytes, on its device, the same
    wherever the bytes lie in memory: the whole rows of BLOCK bytes read
    as 32-bit words, the sums mod 2**32 of each row and of each column,
    and the bytes past the last whole row, each weighted by its place.
    A change of one byte changes one row's sum; rows or columns swapped
    change the weighted sum."""
    import torch
    if x.storage_offset() % 4:
        x = x.clone()
    m = x.numel() - x.numel() % BLOCK
    body = x[:m].view(torch.int32).view(-1, BLOCK // 4)
    parts = torch.cat([body.sum(1, dtype=torch.int32),
                       body.sum(0, dtype=torch.int32), x[m:]])
    return (parts * weights[:parts.numel()]).sum()


class Digests:
    """The digests of the GETs' outputs, kept on the device in a table
    made ahead (nothing allocates per GET), with the rank of each."""

    def __init__(self, rows: int, device):
        import torch
        self.table = torch.zeros(rows, dtype=torch.int64, device=device)
        self.ranks: List[int] = []

    def add(self, val, r: int, weights) -> None:
        self.table[len(self.ranks)] = digest(val, weights)
        self.ranks.append(r)

    def values(self) -> np.ndarray:
        return self.table[:len(self.ranks)].cpu().numpy()


def setup(run) -> None:
    import torch
    from repro_torch.core.store import InfiniStore
    mix, c = run.mix, run.config
    scfg = store_config(run)
    store = InfiniStore(scfg, seed=run.seed)
    sizes = object_sizes(mix)
    if sum(sizes) > c["dataset_bytes"]:
        raise RuntimeError(f"the mix's {sum(sizes)} bytes exceed the "
                           f"configuration's dataset_bytes")
    keys = [f"user{r:04d}" for r in range(len(sizes))]
    weights = digest_weights(max(sizes), run.device)
    # the stored parity of a sample of objects, the largest among them,
    # is checked against the reference encode of their bytes
    rng = np.random.default_rng([run.seed, 2])
    largest = int(np.argmax(sizes))
    others = [int(x) for x in rng.choice(len(keys), size=mix[
        "parity_sample"], replace=False) if int(x) != largest]
    picks = [largest] + others[:mix["parity_sample"] - 1]
    gen = torch.Generator(device=run.device)
    gen.manual_seed(run.seed)
    want, host = [], {}
    for g in range(0, len(sizes), PUT_GROUP):
        part = sizes[g:g + PUT_GROUP]
        data = torch.randint(0, 256, (sum(part),), dtype=torch.uint8,
                             device=run.device, generator=gen)
        objects = list(torch.split(data, part))
        vers = store.put_many(list(zip(keys[g:g + PUT_GROUP], objects)))
        if sorted(set(vers.values())) != [1]:
            raise RuntimeError(f"set-up PUTs failed: {vers}")
        want += [digest(o, weights) for o in objects]
        host.update({r: objects[r - g].cpu().numpy() for r in picks
                     if g <= r < g + PUT_GROUP})
        del data, objects
    if not store.flush_writeback(timeout=600.0):
        raise RuntimeError("set-up writeback did not drain")
    # reclaim the functions holding the named chunks of every object
    n = c["ec"]["k"] + c["ec"]["p"]
    dead = sorted({store.chunk_map[ck] for key in keys
                   for idx in mix["lose_chunks"]
                   for ck in chunk_keys(store, key, idx)})
    for fid in dead:
        store.inject_failure(fid)
    per_chunk = {key: [chunk_keys(store, key, idx) for idx in range(n)]
                 for key in keys}
    lost = [sum(store.chunk_map[cks[fi]] in dead for cks in per_chunk[key])
            for key in keys for fi in range(len(per_chunk[key][0]))]
    want_lost = (1, c["ec"]["p"]) if mix["lose_chunks"] else (0, 0)
    if not all(want_lost[0] <= x <= want_lost[1] for x in lost):
        raise RuntimeError(f"chunks lost per fragment {lost}, wanted "
                           f"{want_lost[0]}..{want_lost[1]}")
    # a table row for every GET a window of this length could complete
    # (runs complete under 1,000 a second)
    rows = len(keys) + mix["warm_requests"] + int(run.seconds * 4000)
    run.log.update(store=store, keys=keys, sizes=sizes, obs=scfg.obs,
                   cycle=request_cycle(mix, run.seed), weights=weights,
                   want=torch.stack(want).cpu().numpy(), parity_objects=host,
                   digests=Digests(rows, run.device))


def closed_loop(run, order, until: float, on_done, limit=None) -> None:
    """Keep `in_flight` single-key array GETs outstanding, the keys'
    ranks taken from `order` in turn and round again, until the host
    clock passes `until` or `limit` are issued; then wait for those
    still out. A GET is done when the device work enqueued by the time
    its future resolved has ended (an event recorded then, on the
    default stream that every thread of the store uses). Calls
    on_done(ordinal, rank, issued at, done at, tensor or None) for
    each, in the
    order their futures resolve."""
    import torch
    store, keys = run.log["store"], run.log["keys"]
    depth = run.mix["in_flight"]
    cuda = run.device.type == "cuda"
    resolved = queue.SimpleQueue()
    inflight = {}
    i = 0
    while True:
        now = time.perf_counter()
        while len(inflight) < depth and now < until and \
                (limit is None or i < limit):
            r = int(order[i % len(order)])
            ev = torch.cuda.Event() if cuda else None
            fut = store.get_many_arrays_async([keys[r]])
            inflight[fut] = (i, r, now, ev)

            def note(f, ev=ev):
                if ev is not None:
                    ev.record()
                resolved.put(f)
            fut.add_done_callback(note)
            i += 1
            now = time.perf_counter()
        if not inflight:
            return
        fut = resolved.get()
        j, r, t_issue, ev = inflight.pop(fut)
        if ev is not None:
            ev.synchronize()
        t = time.perf_counter()
        try:
            val = fut.result().get(keys[r])
        except Exception:                            # noqa: BLE001
            val = None
        on_done(j, r, t_issue, t, val)


def checked(mix: dict, seed: int) -> set:
    """Positions in the request cycle whose GET output the window's check
    digests, in every cycle the window runs: the first request of every
    object and `check_extra` more drawn from the seed. A digest costs
    the client host time that the store's daemon would have had, so the
    window digests a sample (the warm-up digests every GET)."""
    cycle = request_cycle(mix, seed)
    first = {}
    for j, r in enumerate(cycle):
        first.setdefault(int(r), j)
    rest = sorted(set(range(len(cycle))) - set(first.values()))
    more = np.random.default_rng([seed, 1]).choice(
        rest, size=min(len(rest), mix["check_extra"]), replace=False)
    return set(first.values()) | {int(j) for j in more}


def _judge(run, recs, sample=None):
    """on_done for closed_loop: a GET's record (done at, seconds, bytes
    returned, ok, rank) goes to `recs`; the digest of its output goes to
    the table where its ordinal's place in the cycle is in `sample`
    (every GET where `sample` is None)."""
    lg = run.log
    sizes, table, weights = lg["sizes"], lg["digests"], lg["weights"]
    n = len(lg["cycle"])

    def done(j, r, t_issue, t, val):
        ok = val is not None and val.numel() == sizes[r]
        recs.append((t, t - t_issue, sizes[r] if ok else 0, ok, r))
        if ok and (sample is None or j % n in sample):
            table.add(val, r, weights)
    return done


def warm(run) -> None:
    """One GET of every object (every size the window asks for, the
    decode matrix of the lost chunks), then `warm_requests` GETs at the
    window's depth, so that the device allocator holds the blocks the
    window's outputs, staging and digests take. They are judged with the
    window's GETs."""
    recs = run.log.setdefault("warm_recs", [])
    done = _judge(run, recs)
    for r, key in enumerate(run.log["keys"]):
        t = time.perf_counter()
        done(r, r, t, t, run.log["store"].get_many_arrays([key])[key])
    closed_loop(run, run.log["cycle"][::-1], float("inf"), done,
                limit=run.mix["warm_requests"])


def window(run) -> None:
    recs = []
    run.log["window_from"] = len(run.log["digests"].ranks)
    closed_loop(run, run.log["cycle"], run.t1,
                _judge(run, recs, checked(run.mix, run.seed)))
    run.log["recs"] = recs
    run.attempted = len(recs)
    run.failed = sum(not rec[3] for rec in recs)


def in_window(run):
    """The GETs that completed inside the measured window."""
    return [r for r in run.log["recs"] if r[0] <= run.t1]


def get_p95_ms(run):
    """95th percentile of the latency of those GETs, in ms."""
    recs = in_window(run)
    if not recs:
        return None
    return float(np.percentile([r[1] for r in recs], 95)) * 1e3


def check(run) -> list:
    lg = run.log
    store, keys = lg["store"], lg["keys"]
    k, p = run.config["ec"]["k"], run.config["ec"]["p"]
    fb = run.config["fragment_bytes"]
    stored = []
    for r in lg["parity_objects"]:
        for idx in range(k, k + p):
            for fi, ck in enumerate(chunk_keys(store, keys[r], idx)):
                fid = store.chunk_map[ck]
                val = store.sms.get(fid).load(ck)
                stored.append((r, fi, idx, None if val is None
                               else val.cpu().numpy()))
    store.close()
    lg["store"] = None
    del store
    window_ok = sum(rec[3] for rec in lg["recs"])
    missing = sum(not rec[3] for rec in lg["recs"] + lg["warm_recs"])
    table = lg["digests"]
    bad = table.values() != lg["want"][table.ranks]
    mismatch = int(bad.sum())
    parity_bad = 0
    enc = {}
    for r, fi, idx, val in stored:
        if (r, fi) not in enc:
            data = lg["parity_objects"][r][fi * fb:(fi + 1) * fb]
            enc[r, fi] = gf256_rs.encode(data, k, p)
        if val is None or not np.array_equal(val, enc[r, fi][idx]):
            parity_bad += 1
    w0 = lg["window_from"]
    run.failed = len(lg["recs"]) - window_ok + int(bad[w0:].sum())
    lg["notes"] = {"gets_compared": len(bad),
                   "window_gets_compared": len(bad) - w0,
                   "parity_chunks_compared": len(stored),
                   "get_p95_ms": get_p95_ms(run)}
    return [("get_missing", missing, 0), ("get_mismatch", mismatch, 0),
            ("parity_mismatch", parity_bad, 0)]
