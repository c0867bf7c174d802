"""Cluster-routed online inference over the model pool.

Port of the read path of ``feddrift_tpu/platform/serving.py``:

- each request carries a client id; the ``RoutingTable`` maps it to its
  cluster model;
- concurrent requests for DIFFERENT models are coalesced by a
  micro-batching admission queue into ONE forward
  (``core/step.py::ForwardStep``): a padded ``[B, ...]`` batch plus a
  per-row model-index vector, with B drawn from a small static bucket set;
- generations are double-buffered: ``swap`` builds the complete next
  ``(params, routing)`` snapshot on the device, waits until it is there,
  then publishes it with one reference assignment; the dispatcher reads
  the generation ONCE per micro-batch, so no request sees torn params or a
  params/routing skew.

The engine runs on the pool's device. On ``cuda`` the transformer's
attention goes through the hand-written flash kernel, which ``warmup()``
builds before any traffic. Not ported yet: the quality plane, canary,
broker feed, cluster events, ops lane, ``run_open`` and ``load_engine``.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from feddrift_torch import obs
from feddrift_torch.core.step import ForwardStep
from feddrift_torch.obs import spans

log = logging.getLogger("feddrift_torch")

# padded micro-batch sizes the engine serves (power-of-two ladder keeps
# padding waste <= 2x while covering single-request lulls and backlogs)
SERVE_BUCKETS = (1, 2, 4, 8, 16, 32)


class UnknownClientError(ValueError):
    """The request's client id is outside the population or has no
    (surviving) cluster assignment to route to."""


class MalformedRequestError(ValueError):
    """The request body cannot be turned into one example of the model's
    input geometry."""


class EngineOverloaded(RuntimeError):
    """Admission refused: the bounded request queue is full. Carries a
    ``retry_after_s`` hint."""

    def __init__(self, msg: str, retry_after_s: float = 0.05) -> None:
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class EngineStopped(RuntimeError):
    """The engine shut down (or its dispatcher died) while the request was
    queued or in flight."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline expired before dispatch."""


class RoutingTable:
    """Dense client -> model map; ``table[c] == -1`` is unroutable."""

    def __init__(self, table) -> None:
        self.table = np.asarray(table, dtype=np.int64).copy()
        if self.table.ndim != 1:
            raise ValueError(f"routing table must be 1-D, "
                             f"got shape {self.table.shape}")

    @classmethod
    def from_assignment(cls, assignment) -> "RoutingTable":
        return cls(assignment)

    @property
    def population(self) -> int:
        return int(self.table.shape[0])

    def route(self, client: int) -> int:
        c = int(client)
        if not 0 <= c < self.table.shape[0]:
            raise UnknownClientError(
                f"client {c} outside population [0, {self.table.shape[0]})")
        m = int(self.table[c])
        if m < 0:
            raise UnknownClientError(f"client {c} has no cluster assignment")
        return m


class _Generation:
    """One immutable published snapshot: params + routing share a version."""

    __slots__ = ("version", "params", "routing", "num_models")

    def __init__(self, version: int, params, routing: RoutingTable,
                 num_models: int) -> None:
        self.version = version
        self.params = params
        self.routing = routing
        self.num_models = num_models


@dataclass
class ServeResult:
    """One answered request."""
    logits: np.ndarray
    model: int
    version: int
    request_id: int = -1


class _Request:
    __slots__ = ("client", "x", "ctx", "rid", "t0", "ts", "done", "result",
                 "error", "deadline", "abandoned")

    def __init__(self, client: int, x: np.ndarray, ctx: dict,
                 rid: int, deadline: float | None = None) -> None:
        self.client = client
        self.x = x
        self.ctx = ctx
        self.rid = rid
        self.t0 = time.perf_counter()
        self.ts = time.time()
        self.done = threading.Event()
        self.result: ServeResult | None = None
        self.error: Exception | None = None
        self.deadline = deadline
        self.abandoned = False


class InferenceEngine:
    """Micro-batching cluster-routed inference over a ``ModelPool``.

    ``submit()`` is thread-safe and blocking; a dispatcher thread coalesces
    requests into padded bucket batches served by one ``ForwardStep``;
    ``swap()`` publishes new generations without stalling readers.
    """

    def __init__(self, pool, routing: RoutingTable, buckets=SERVE_BUCKETS,
                 max_wait_s: float = 0.002, max_queue: int = 0,
                 name: str | None = None) -> None:
        self.pool = pool
        self.device = pool.device
        self.name = name
        self.max_queue = int(max_queue)
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        self.max_wait_s = float(max_wait_s)
        self.step = ForwardStep(apply_rows=pool.apply_rows)
        # pool.example_input is a sample BATCH; one request carries ONE
        # example: its trailing (per-row) geometry
        example = pool.example_input
        if isinstance(example, torch.Tensor):
            example = example.cpu().numpy()
        example = np.asarray(example)
        if example.ndim < 1:
            raise ValueError("pool.example_input must be a sample batch")
        self._example_shape = example.shape[1:]
        self._example_dtype = example.dtype
        self._gen = _Generation(1, self._place_params(pool.params),
                                routing, pool.num_models)
        self._queue: deque[_Request] = deque()
        self._cond = threading.Condition()
        self._stop = False
        self.failed: BaseException | None = None
        self._thread: threading.Thread | None = None
        self._swap_lock = threading.RLock()
        self._rid = itertools.count(1)

        reg = obs.registry()
        labels = {"replica": name} if name else {}
        self._lat = reg.quantile_sketch("request_latency_seconds_q",
                                        **labels)
        self._served = reg.counter("requests_served", **labels)
        self._batches = reg.counter("serve_batches", **labels)
        self._shed = reg.counter("requests_shed", **labels)
        self._expired = reg.counter("requests_expired", **labels)
        self._abandoned = reg.counter("requests_abandoned", **labels)
        reg.gauge("pool_version").set(self._gen.version)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "InferenceEngine":
        if self._thread is None:
            self._stop = False
            self._thread = threading.Thread(target=self._dispatch_loop,
                                            daemon=True,
                                            name="serve-dispatch")
            self._thread.start()
        return self

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        while self._queue:
            r = self._queue.popleft()
            r.error = EngineStopped("engine stopped with request queued")
            r.done.set()

    def warmup(self) -> None:
        """Build the CUDA kernels (on a CUDA pool) and run the forward once
        for EVERY bucket, so no request waits behind a build or a first
        launch."""
        if self.device.type == "cuda":
            from feddrift_torch.kernels.build import build_all
            build_all()
        gen = self._gen
        for b in self.buckets:
            x = torch.zeros((b,) + self._example_shape,
                            dtype=_torch_dtype(self._example_dtype),
                            device=self.device)
            midx = torch.zeros((b,), dtype=torch.long, device=self.device)
            self.step.forward(gen.params, x, midx)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def version(self) -> int:
        return self._gen.version

    # -- read path ------------------------------------------------------
    def submit(self, client_id, x, timeout: float = 30.0,
               trace: dict | None = None,
               deadline_s: float | None = None) -> ServeResult:
        """Route + answer one request; blocks until its micro-batch lands.

        Raises ``MalformedRequestError`` on bad inputs,
        ``UnknownClientError`` on unroutable clients, ``TimeoutError``
        past ``timeout``, ``EngineOverloaded`` when the bounded queue is
        full, ``EngineStopped`` when the engine shut down underneath the
        request.
        """
        if self.failed is not None:
            raise EngineStopped(f"engine dispatcher died: {self.failed!r}")
        if self._stop:
            raise EngineStopped("engine is shutting down")
        if self._thread is None:
            raise RuntimeError("engine not started (call start())")
        try:
            client = int(client_id)
        except (TypeError, ValueError) as e:
            raise MalformedRequestError(
                f"client id {client_id!r} is not an integer") from e
        try:
            xa = np.asarray(x, dtype=self._example_dtype)
        except (TypeError, ValueError) as e:
            raise MalformedRequestError(
                f"request body is not a {self._example_dtype} array: {e}") \
                from e
        if xa.shape != self._example_shape:
            raise MalformedRequestError(
                f"example shape {xa.shape} != model input "
                f"{self._example_shape}")
        # fast-fail against the current generation; the dispatcher
        # re-routes against ITS generation
        self._gen.routing.route(client)

        ctx = spans.child_of(trace) if trace else spans.new_trace()
        req = _Request(client, xa, ctx, next(self._rid))
        wait = timeout
        if deadline_s is not None:
            req.deadline = req.t0 + float(deadline_s)
            wait = min(wait, float(deadline_s))
        with self._cond:
            if self.max_queue > 0 and len(self._queue) >= self.max_queue:
                self._shed.inc()
                raise EngineOverloaded(
                    f"admission queue full ({self.max_queue} pending)",
                    retry_after_s=max(self.max_wait_s * 2, 0.01))
            self._queue.append(req)
            self._cond.notify()
        if not req.done.wait(wait):
            # mark BEFORE raising: batch formation skips abandoned work
            req.abandoned = True
            if not req.done.is_set():
                raise TimeoutError(
                    f"request for client {client} timed out after {wait}s")
        if req.error is not None:
            raise req.error
        return req.result

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _dispatch_loop(self) -> None:
        max_b = self.buckets[-1]
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait(0.25)
                if self._stop and not self._queue:
                    return
                batch = [self._queue.popleft()]
                # micro-batch window: admit until the largest bucket is
                # full or max_wait_s has passed since the first admit
                deadline = time.perf_counter() + self.max_wait_s
                while len(batch) < max_b:
                    if self._queue:
                        batch.append(self._queue.popleft())
                        continue
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0 or self._stop:
                        break
                    self._cond.wait(remaining)
            try:
                self._serve_batch(batch)
            except Exception as exc:  # noqa: BLE001 — contain the crash
                self._dispatcher_died(exc, batch)
                return

    def _dispatcher_died(self, exc: BaseException,
                         batch: list[_Request]) -> None:
        """Mark the engine dead and fail every in-flight and queued
        request with the explicit replica-death error."""
        self.failed = exc
        log.error("serving: dispatcher died on %r", exc, exc_info=exc)
        err = EngineStopped(f"engine dispatcher died: {exc!r}")
        with self._cond:
            leftovers = list(self._queue)
            self._queue.clear()
        for r in batch + leftovers:
            if not r.done.is_set():
                r.error = err
                r.done.set()
        obs.emit("replica_failed", replica=self.name or "engine",
                 reason="dispatcher_crash", error=repr(exc))
        obs.registry().counter("replica_failures",
                               reason="dispatcher_crash").inc()

    def _serve_batch(self, batch: list[_Request]) -> None:
        gen = self._gen      # ONE reference read: params+routing coherent
        live: list[_Request] = []
        routes: list[int] = []
        now = time.perf_counter()
        for r in batch:
            if r.abandoned:
                self._abandoned.inc()
                r.done.set()
                continue
            if r.deadline is not None and now >= r.deadline:
                self._expired.inc()
                r.error = DeadlineExceededError(
                    f"request for client {r.client} expired "
                    f"{now - r.deadline:.3f}s past its deadline "
                    f"before dispatch")
                r.done.set()
                continue
            try:
                routes.append(gen.routing.route(r.client))
                live.append(r)
            except UnknownClientError as e:
                r.error = e
                r.done.set()
        if not live:
            return
        b = self._bucket_for(len(live))
        xb = np.zeros((b,) + self._example_shape, dtype=self._example_dtype)
        for i, r in enumerate(live):
            xb[i] = r.x
        mb = np.zeros((b,), dtype=np.int64)
        mb[:len(live)] = routes
        logits = self.step.forward(
            gen.params, torch.from_numpy(xb).to(self.device),
            torch.from_numpy(mb).to(self.device))
        out = logits.cpu().numpy()     # the one device->host fetch per batch
        done = time.perf_counter()
        self._batches.inc()
        self._served.inc(len(live))
        for i, r in enumerate(live):
            lat = done - r.t0
            r.result = ServeResult(logits=out[i], model=int(mb[i]),
                                   version=gen.version, request_id=r.rid)
            self._lat.observe(lat)
            spans.record("serve_request", r.ts, lat, cat="serve",
                         client=r.client, model=int(mb[i]), batch=b,
                         version=gen.version, **r.ctx)
            obs.emit("request_served", client=r.client, model=int(mb[i]),
                     version=gen.version, batch=b,
                     latency_ms=round(lat * 1e3, 3))
            r.done.set()

    # -- hot swap -------------------------------------------------------
    def swap(self, params=None, routing: RoutingTable | None = None,
             reason: str = "manual", **evidence) -> int:
        """Publish the next generation (double-buffered): the snapshot is
        built COMPLETELY on the device before the single reference
        assignment makes it visible."""
        with self._swap_lock:
            cur = self._gen
            new_params = cur.params
            if params is not None:
                new_params = self._place_params(params)
            new_routing = routing if routing is not None else cur.routing
            gen = _Generation(cur.version + 1, new_params, new_routing,
                              cur.num_models)
            self._gen = gen
        obs.registry().gauge("pool_version").set(gen.version)
        obs.registry().counter("pool_swaps").inc()
        obs.emit("pool_swapped", version=gen.version, reason=reason,
                 models=gen.num_models, **evidence)
        if routing is not None:
            obs.emit("routing_rebuilt", population=routing.population,
                     build_wall_s=0.0,
                     table_bytes=int(routing.table.nbytes),
                     source="swap", version=gen.version)
            obs.registry().counter("routing_rebuilds").inc()
        return gen.version

    def _place_params(self, params) -> dict[str, torch.Tensor]:
        """A private on-device copy of a pool's params (numpy arrays or
        tensors), complete on the device before it is returned, so a
        later in-place edit of the caller's pool cannot reach a published
        generation."""
        placed = {k: torch.as_tensor(v).to(self.device, copy=True)
                  for k, v in params.items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return placed

    # -- diagnostics ----------------------------------------------------
    def stats(self) -> dict:
        return {"served": int(self._served.value),
                "batches": int(self._batches.value),
                "version": self._gen.version,
                "latency": self._lat.snapshot()}


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros((), dtype=np_dtype)).dtype


class TrafficGenerator:
    """Seeded closed-loop load generator over anything with an
    engine-shaped ``submit``: N workers submit back-to-back. A pure
    function of (seed, clients, num_requests).

    The default ``make_x`` draws ``standard_normal`` cast to the example
    dtype, as the reference does; for a token model that gives ids in
    about [-3, 3], so pass a ``make_x`` that draws real windows."""

    def __init__(self, engine: InferenceEngine, clients, seed: int = 0,
                 concurrency: int = 8, make_x=None) -> None:
        self.engine = engine
        self.clients = [int(c) for c in clients]
        if not self.clients:
            raise ValueError("need at least one client to generate traffic")
        self.seed = int(seed)
        self.concurrency = max(1, int(concurrency))
        shape = engine._example_shape
        dtype = engine._example_dtype
        if make_x is None:
            def make_x(rng):
                return rng.standard_normal(shape).astype(dtype, copy=False)
        self.make_x = make_x

    def run(self, num_requests: int, timeout: float = 30.0) -> dict:
        """Drive ``num_requests`` total; returns rate + latency stats."""
        per = [num_requests // self.concurrency] * self.concurrency
        for i in range(num_requests % self.concurrency):
            per[i] += 1
        lats: list[list[float]] = [[] for _ in range(self.concurrency)]
        errors = [0] * self.concurrency

        def worker(w: int) -> None:
            rng = np.random.RandomState(
                (self.seed * 1_000_003 + w * 7_919 + 1) % (2**31 - 1))
            for _ in range(per[w]):
                c = self.clients[rng.randint(len(self.clients))]
                x = self.make_x(rng)
                t0 = time.perf_counter()
                try:
                    self.engine.submit(c, x, timeout=timeout)
                except Exception:   # noqa: BLE001 — keep the loop closed
                    errors[w] += 1
                    continue
                lats[w].append(time.perf_counter() - t0)

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.concurrency)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        flat = np.asarray([v for ws in lats for v in ws], dtype=np.float64)
        ok = int(flat.size)
        out = {"requests": int(num_requests), "completed": ok,
               "errors": int(sum(errors)),
               "duration_s": round(wall, 4),
               "requests_per_s": round(ok / wall, 2) if wall > 0 else 0.0,
               "concurrency": self.concurrency}
        if ok:
            for q, name in ((50, "p50_ms"), (95, "p95_ms"), (99, "p99_ms")):
                out[name] = round(float(np.percentile(flat, q)) * 1e3, 3)
        return out
