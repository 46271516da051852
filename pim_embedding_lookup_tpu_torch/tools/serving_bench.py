"""Serving load generator: latency under load for the inference path.

A Poisson stream of requests against the DLRM forward, reporting
throughput and latency percentiles (p50/p95/p99): the serving-side metrics
a recommender deployment cares about.  The counterpart of the JAX
package's ``tools/serving_bench.py`` (the analog of the reference's
PIM-DeepRecSys query generator), with its flags, defaults and JSON keys,
plus ``--device`` and the device keys.

Every dispatch is unique: each arrival carries its own payload from a
``--pool`` of distinct requests, and a per-dispatch ``salt`` adds
``(salt % 977) * 1e-7`` to the dense features, as the JAX tool computes.

Batch aggregation (``--microbatch M`` + ``--max-wait-ms``): up to M queued
requests are stacked into one dispatch, with a deadline that flushes a
partial batch.  A partial flush is padded, by repeating its last request,
up to the smallest batch bucket that fits (1, M/4 for M >= 8, M); padded
rows are computed and dropped, and no sample depends on another, so they
do not change the real rows.  The JAX tool compiles a program per bucket;
the port has nothing to compile, but the first call of each shape still
pays set-up (the allocator's new block sizes, cuBLAS's handles and
workspaces), so each bucket is called once at start-up and that call's
seconds are ``bucket_compile_s``.

Dispatch is asynchronous: a dispatch records a CUDA event after its
sigmoid, ``--inflight N`` keeps up to N events outstanding, a non-blocking
drain polls ``Event.query()`` and a blocking one waits on the oldest.
Latency runs from arrival to the event's completion as the host observes
it (queueing included).  ``--stage arrival`` copies each request to the
card as it arrives, from pinned host memory with ``non_blocking=True`` on a
side stream; the serving stream waits on that copy's event, and the tensors
are marked as used there (``record_stream``), as ``data/prefetch.py``
stages training batches.  ``--stage dispatch`` stacks the requests on the
host and copies them at dispatch.

``--zipf a`` draws power-law ids; ``--routed [--hot-k K]`` serves the big
set through the all-to-all routing path (ROW_HASH; on one process a mesh
of one) with an optional replicated hot-row cache.  ``--capacity-factor``
defaults to the drop-impossible value; a lower one drops, and the drops
are counted.

    python -m pim_embedding_lookup_tpu_torch.tools.serving_bench --hybrid --qps 100 --duration 5
    python -m pim_embedding_lookup_tpu_torch.tools.serving_bench --hybrid --microbatch 8 \\
        --inflight 2 --qps 1000
"""

from __future__ import annotations

import argparse
import json
import time
from collections import deque

import numpy as np
import torch

from ..models import DLRM, quantize_dlrm_embeddings
from ..parallel.hybrid import HybridEmbeddingCollection
from . import common


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="serving_bench")
    ap.add_argument("--config", default="kaggle", choices=list(common.CONFIGS))
    ap.add_argument("--batch", type=int, default=256, help="queries per request")
    ap.add_argument("--pooling", type=int, default=1)
    ap.add_argument("--qps", type=float, default=100.0, help="request arrivals/s")
    ap.add_argument("--duration", type=float, default=10.0, help="seconds")
    ap.add_argument("--hybrid", action="store_true",
                    help="one-hot matmul small-table + gather big-table collection")
    ap.add_argument("--dtype", default="float32", choices=["float32", "int8"],
                    help="int8 = quantize the (hybrid: big-set) embeddings for serving "
                         "(models/quantize.py): the capacity mode's latency under load")
    ap.add_argument("--pool", type=int, default=32,
                    help="distinct pre-generated request payloads (each arrival takes the "
                         "next one)")
    ap.add_argument("--inflight", type=int, default=1,
                    help="max outstanding dispatches (1 = strict serial client)")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="aggregate up to M queued requests into one dispatch")
    ap.add_argument("--max-wait-ms", type=float, default=10.0,
                    help="dispatch a partial batch once the oldest queued request has "
                         "waited this long (the SLA knob)")
    ap.add_argument("--zipf", type=float, default=0.0,
                    help="zipf exponent for skewed ids (0 = uniform)")
    ap.add_argument("--routed", action="store_true",
                    help="route sharded lookups through all_to_all")
    ap.add_argument("--capacity-factor", type=float, default=None,
                    help="routed bucket capacity factor (default: the drop-impossible "
                         "safe_capacity_factor; lower = throughput mode, drops counted)")
    ap.add_argument("--hot-k", type=int, default=0,
                    help="replicate the K hottest rows (routed mode only)")
    ap.add_argument("--canned-payload", action="store_true",
                    help="pre-stage full-microbatch device payloads and reuse them per "
                         "dispatch instead of stacking the queued requests (an A/B knob "
                         "that leaves out the copy to the device; not the real data path)")
    ap.add_argument("--stage", default="arrival", choices=["arrival", "dispatch"],
                    help="when request tensors go to the device: 'arrival' = an "
                         "asynchronous copy as each request arrives, 'dispatch' = host "
                         "stack + copy on the dispatch path")
    ap.add_argument("--seed", type=int, default=0)
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def make_request(rng: np.random.Generator, cfg, batch: int, pooling: int, zipf: float):
    """One request's payload on the host: dense [B, dense_dim] f32 and ids
    [T, B*L] int32, in the JAX tool's draw order."""
    def draw_ids(tb, n):
        if zipf > 1.0:
            return np.minimum(rng.zipf(zipf, size=n) - 1, tb.num_rows - 1)
        return rng.integers(0, tb.num_rows, size=n)

    dense = rng.random((batch, cfg.dense_dim)).astype(np.float32)
    idx = np.stack([draw_ids(tb, batch * pooling) for tb in cfg.tables]).astype(np.int32)
    return dense, idx


def buckets_for(mb: int) -> list[int]:
    """Batch buckets of a microbatch of ``mb``: 1, ~M/4 (for M >= 8), M."""
    return sorted({1, mb} | ({max(2, mb // 4)} if mb >= 8 else set()))


def salt_term(salt: int) -> float:
    """The salt added to the dense features, (salt % 977) * 1e-7 in f32."""
    return float(np.float32(salt % 977) * np.float32(1e-7))


class Server:
    """Dispatches stacked requests through ``serve`` and keeps up to
    ``inflight`` of them outstanding."""

    def __init__(self, model: DLRM, coll, params, *, buckets, device, routed=False,
                 capacity_factor=None, hot_cache=None, inflight: int = 1):
        self.model, self.coll, self.params = model, coll, params
        self.buckets, self.device = list(buckets), device
        self.routed, self.cf, self.hot_cache = routed, capacity_factor, hot_cache
        self.hybrid = isinstance(coll, HybridEmbeddingCollection)
        self.max_inflight = inflight
        self.cuda = device.type == "cuda"
        self.copy_stream = torch.cuda.Stream(device=device) if self.cuda else None
        self.inflight = deque()  # (arrival times of the batch's requests, out, event)
        self.latencies: list[float] = []
        self.requests = self.dispatches = self.padded = 0

    def pooled(self, idx, bd, **stats):
        mask = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
        if not self.routed:
            return self.coll.lookup(self.params, idx, mask, batch_size=bd)
        kw = dict(batch_size=bd, capacity_factor=self.cf, hot_cache=self.hot_cache, **stats)
        if self.hybrid:
            return self.coll.lookup(self.params, idx, mask, routed=True, **kw)
        return self.coll.lookup_routed(self.params, idx, mask, **kw)

    @torch.no_grad()
    def serve(self, dense_parts, idx_parts, salt: int) -> torch.Tensor:
        """Click probabilities [nb*B] of the stacked parts."""
        dense = torch.cat(list(dense_parts)) + salt_term(salt)
        idx = torch.cat(list(idx_parts), dim=1)
        pooled = self.pooled(idx, dense.shape[0])
        return torch.sigmoid(self.model.apply_from_pooled(dense, pooled))

    def stage(self, payload):
        """A request's pinned host tensors -> (dense, ids, copy event) on
        the device, copied on the side stream without waiting (the CPU:
        the tensors themselves)."""
        dense, idx = payload
        if not self.cuda:
            return dense, idx, None
        with torch.cuda.stream(self.copy_stream):
            out = (dense.to(self.device, non_blocking=True),
                   idx.to(self.device, non_blocking=True))
            ready = torch.cuda.Event()
            ready.record(self.copy_stream)
        return (*out, ready)

    def _consume(self, staged):
        """The serving stream waits on each staged copy and holds its tensors."""
        if not self.cuda:
            return
        cur = torch.cuda.current_stream(self.device)
        for dense, idx, ready in staged:
            cur.wait_event(ready)
            dense.record_stream(cur)
            idx.record_stream(cur)

    def dispatch(self, items, *, staged: bool, canned=None) -> torch.Tensor:
        """One dispatch of the queued ``(arrival time, payload)`` items: the
        canned payload, or the items' payloads stacked (staged on the
        device at arrival, or host arrays copied now) and padded with the
        last one up to the smallest bucket that fits.  Returns the
        probabilities of every row, padding included."""
        k = len(items)
        if canned is not None:
            dense, idx = canned[self.dispatches % len(canned)]
            out = self.serve([dense], [idx], self.dispatches)
        else:
            nb = min(x for x in self.buckets if x >= k)
            self.padded += nb - k
            payloads = [p for _, p in items] + [items[-1][1]] * (nb - k)
            if staged:
                self._consume(payloads)
                out = self.serve([p[0] for p in payloads], [p[1] for p in payloads],
                                 self.dispatches)
            else:
                dense = np.concatenate([p[0] for p in payloads])
                idx = np.concatenate([p[1] for p in payloads], axis=1)
                out = self.serve([torch.from_numpy(dense).to(self.device)],
                                 [torch.from_numpy(idx).to(self.device)], self.dispatches)
        done = None
        if self.cuda:
            done = torch.cuda.Event()
            done.record()
        self.inflight.append(([a for a, _ in items], out, done))
        self.dispatches += 1
        return out

    def drain(self, block: bool) -> None:
        """Non-blocking: retire every finished dispatch at the head of the
        queue.  Blocking: wait for the oldest and retire it alone."""
        while self.inflight:
            arrivals, _, done = self.inflight[0]
            if done is not None:
                if not block and not done.query():
                    return
                done.synchronize()
            now = time.perf_counter()
            self.latencies.extend(now - a for a in arrivals)
            self.requests += len(arrivals)
            self.inflight.popleft()
            if block:
                return


def run_load(server: Server, pool, *, qps, duration, microbatch, max_wait_ms, staged,
             canned, rng) -> tuple[float, int]:
    """The open-loop client: Poisson arrivals at ``qps`` for ``duration``
    seconds, each taking the next payload of ``pool``, aggregated into
    dispatches of up to ``microbatch``; arrivals more than a second behind
    are dropped and counted.  Queued requests are served after the
    deadline.  Returns (wall seconds, dropped arrivals)."""
    pending = deque()
    max_wait = max_wait_ms / 1e3
    late_drops = arrivals = 0

    def flush():
        if len(server.inflight) >= server.max_inflight:
            server.drain(block=True)
        server.dispatch([pending.popleft() for _ in range(min(microbatch, len(pending)))],
                        staged=staged, canned=canned)

    start = time.perf_counter()
    next_arrival = start
    while True:
        now = time.perf_counter()
        if now - start >= duration:
            break
        server.drain(block=False)
        while now >= next_arrival:
            if now - next_arrival > 1.0:  # hopelessly behind: count drops
                late_drops += 1
            else:
                payload = pool[arrivals % len(pool)]
                pending.append((next_arrival, server.stage(payload) if staged else payload))
            arrivals += 1
            next_arrival += rng.exponential(1.0 / qps)
        full = len(pending) >= microbatch
        expired = pending and (now - pending[0][0]) >= max_wait
        if not (full or expired):
            time.sleep(min(max(next_arrival - now, 0.0), 0.001))
            continue
        flush()
    while pending:  # arrivals before the deadline are still served and counted
        flush()
    while server.inflight:
        server.drain(block=True)
    return time.perf_counter() - start, late_drops


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev, mesh, policy, joined = common.tool_mesh(args.device, args.routed)
    try:
        return _main(args, dev, mesh, policy)
    finally:
        common.leave(joined)


def _main(args, dev, mesh, policy) -> dict:
    cfg = common.CONFIGS[args.config]()
    model = DLRM(cfg, policy, hybrid=args.hybrid, device=dev, mesh=mesh,
                 generator=torch.Generator(device=dev).manual_seed(args.seed))
    coll, params = model.collection, model.emb_params()
    if args.dtype == "int8":
        coll, params = quantize_dlrm_embeddings(model)
        if args.hybrid:  # serve from the int8 copy only
            model.emb_big = None
        else:
            model.emb = None
    hybrid = isinstance(coll, HybridEmbeddingCollection)
    routed = args.routed and mesh is not None

    rng = np.random.default_rng(args.seed)
    t, b, l = len(cfg.tables), args.batch, args.pooling
    mb = max(1, args.microbatch)
    pool = [make_request(rng, cfg, b, l, args.zipf) for _ in range(args.pool)]
    canned = None
    if args.canned_payload:
        canned = []
        for ci in range(args.pool):
            ps = [pool[(ci + j) % len(pool)] for j in range(mb)]
            canned.append((torch.from_numpy(np.concatenate([p[0] for p in ps])).to(dev),
                           torch.from_numpy(np.concatenate([p[1] for p in ps], axis=1)).to(dev)))
    staged = args.stage == "arrival" and canned is None
    if staged:  # the payloads a staged arrival copies: pinned on the card
        staged_pool = [tuple(torch.from_numpy(a) for a in p) for p in pool]
        if dev.type == "cuda":
            staged_pool = [tuple(a.pin_memory() for a in p) for p in staged_pool]

    hot_cache = hot_hit_rate = None
    if routed and args.hot_k:
        from ..parallel.hotcache import build_hot_cache, hot_ids_from_sample

        target = coll.big if hybrid else coll
        sel = list(coll.big_ids) if hybrid else list(range(t))
        sample = np.concatenate([r[1][sel] for r in pool], axis=1)
        hot_ids = hot_ids_from_sample(target, sample, args.hot_k)
        hot_cache = build_hot_cache(target, params["big"] if hybrid else params, hot_ids)
        # cache hits are served locally and never routed: the hit rate is the
        # share of big-set entries taken off the all-to-all
        offs = np.asarray(target.layout.row_offsets, dtype=np.int64)
        fused = (sample.astype(np.int64) + offs[:, None]).reshape(-1)
        hot_hit_rate = round(float(np.isin(fused, hot_ids).mean()), 4)

    cf = args.capacity_factor  # None: the drop-impossible default
    buckets = buckets_for(mb)
    server = Server(model, coll, params, buckets=buckets, device=dev,
                    routed=routed, capacity_factor=cf, hot_cache=hot_cache,
                    inflight=args.inflight)

    compile_s = {}
    for nb in buckets:  # each bucket's first call pays its shapes' set-up
        if canned is not None and nb != mb:
            continue  # canned dispatches only ever use the full bucket
        t0 = time.perf_counter()
        if canned is not None:
            server.serve([canned[0][0]], [canned[0][1]], 0)
        else:
            reqs = [pool[j % len(pool)] for j in range(nb)]
            server.serve([torch.from_numpy(r[0]).to(dev) for r in reqs],
                         [torch.from_numpy(r[1]).to(dev) for r in reqs], 0)
        common.sync(dev)
        compile_s[nb] = round(time.perf_counter() - t0, 4)

    drops = None
    if routed:  # the routed drop count of this traffic at this cf
        idx_mb = np.concatenate([p[1] for p in pool[:mb]] if mb <= len(pool)
                                else [pool[0][1]] * mb, axis=1)
        with torch.no_grad():
            _, dropped = server.pooled(torch.from_numpy(idx_mb).to(dev), b * mb,
                                       return_stats=True)
        drops = int(dropped)

    wall, late_drops = run_load(server, staged_pool if staged else pool, qps=args.qps, duration=args.duration,
                                microbatch=mb, max_wait_ms=args.max_wait_ms, staged=staged,
                                canned=canned, rng=rng)
    lat_ms = np.asarray(server.latencies) * 1e3
    n_req = server.requests
    result = {
        "requests": n_req,
        "dropped": late_drops,
        "achieved_qps": round(n_req / wall, 1),
        "offered_qps": args.qps,
        "inflight": args.inflight,
        "microbatch": mb,
        "dispatches": server.dispatches,
        "batch": b,
        "dtype": args.dtype,
        "payload": "canned-staged" if canned is not None else (
            "real-arrival-staged" if staged else "real-concat"),
        "buckets": buckets,
        "bucket_compile_s": compile_s,
        "padded_requests": server.padded,
        "zipf": args.zipf,
        "routed": routed,
        "capacity_factor": (cf if cf is not None else (
            coll.big.safe_capacity_factor if hybrid else coll.safe_capacity_factor))
        if routed else None,
        "hot_k": args.hot_k if routed else 0,
        "hot_hit_rate": hot_hit_rate,
        "routed_entry_drops": drops,
        "p50_ms": round(float(np.percentile(lat_ms, 50)), 3),
        "p95_ms": round(float(np.percentile(lat_ms, 95)), 3),
        "p99_ms": round(float(np.percentile(lat_ms, 99)), 3),
        "mean_ms": round(float(lat_ms.mean()), 3),
        "lookups_per_s": round(n_req * b * t / wall, 1),
        **common.device_info(dev),
    }
    if common.primary():
        print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
