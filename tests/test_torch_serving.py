"""The port's serving read path over a transformer pool (CPU).

Mirrors the invariants of ``tests/test_serving.py`` on the port: routing
follows the table, a mixed-cluster micro-batch equals each request served
alone, every bucket answers, and a swap under concurrent load gives answers
consistent with exactly one generation. The port's ``ForwardStep`` is held
against the reference's on converted parameters (atol 1e-5: float32, sums
in another order).
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from feddrift_torch.config import ExperimentConfig
from feddrift_torch.core.pool import ModelPool
from feddrift_torch.core.step import ForwardStep
from feddrift_torch.data.registry import make_dataset
from feddrift_torch.models.transformer import TransformerLM
from feddrift_torch.platform.serving import (
    SERVE_BUCKETS, EngineStopped, InferenceEngine, MalformedRequestError,
    RoutingTable, TrafficGenerator, UnknownClientError)
from torch_threads import one_intra_op_thread  # noqa: F401

L = 12
KW = dict(vocab_size=90, d_model=32, num_heads=2, num_layers=1, max_len=L)
TABLE = [0, 1, 2, 1, 0, 2, 2, 1]


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    return make_dataset(ExperimentConfig(
        dataset="shakespeare", train_iterations=2, sample_num=8,
        text_seq_len=L, data_dir=str(tmp_path_factory.mktemp("data"))))


@pytest.fixture(scope="module")
def pool(ds):
    return ModelPool.create(TransformerLM(**KW),
                            torch.from_numpy(ds.x[0, 0, :2]), 3, seed=7,
                            identical=False, device="cpu")


def _engine(pool, table=TABLE, **kw):
    kw.setdefault("buckets", (1, 2, 4, 8))
    kw.setdefault("max_wait_s", 0.002)
    return InferenceEngine(pool, RoutingTable(table), **kw)


def _alone(pool, m, x, params=None):
    one = pool.slot(m) if params is None else {k: p[m]
                                               for k, p in params.items()}
    with torch.no_grad():
        return pool.apply(one, torch.from_numpy(x[None]))[0].numpy()


class TestRouting:
    def test_routes_follow_table(self, pool, ds):
        eng = _engine(pool).start()
        try:
            for c, m in enumerate(TABLE):
                r = eng.submit(c, ds.x[c % 10, 1, 0])
                assert r.model == m and r.version == 1
                np.testing.assert_array_equal(
                    r.logits, _alone(pool, m, ds.x[c % 10, 1, 0]))
        finally:
            eng.close()

    def test_out_of_population(self, pool, ds):
        rt = RoutingTable.from_assignment([0, 1, -1])
        assert rt.population == 3 and rt.route(1) == 1
        for c in (3, -1, 2):
            with pytest.raises(UnknownClientError):
                rt.route(c)
        eng = InferenceEngine(pool, rt).start()
        try:
            with pytest.raises(UnknownClientError):
                eng.submit(7, ds.x[0, 0, 0])
        finally:
            eng.close()


class TestBatchParity:
    def test_mixed_cluster_batch_equals_per_request(self, pool, ds):
        eng = _engine(pool, max_wait_s=0.05).start()
        try:
            eng.warmup()
            xs = ds.x[:8, 0, 0]
            batches0 = eng.stats()["batches"]
            with ThreadPoolExecutor(max_workers=8) as ex:
                futs = [ex.submit(eng.submit, c, xs[c]) for c in range(8)]
                results = [f.result(timeout=30) for f in futs]
            # some requests were coalesced into one micro-batch
            assert eng.stats()["batches"] - batches0 < 8
            for c, r in enumerate(results):
                assert r.model == TABLE[c]
                np.testing.assert_array_equal(
                    r.logits, _alone(pool, TABLE[c], xs[c]))
        finally:
            eng.close()

    @pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
    def test_every_bucket_answers(self, pool, ds, n):
        eng = _engine(pool, max_wait_s=0.05).start()
        try:
            eng.warmup()
            served0 = eng.stats()["served"]
            with ThreadPoolExecutor(max_workers=n) as ex:
                futs = [ex.submit(eng.submit, c, ds.x[c, 1, 1])
                        for c in range(n)]
                results = [f.result(timeout=30) for f in futs]
            for c, r in enumerate(results):
                assert r.logits.shape == (90,) and np.isfinite(r.logits).all()
                np.testing.assert_array_equal(
                    r.logits, _alone(pool, TABLE[c], ds.x[c, 1, 1]))
            assert eng.stats()["served"] - served0 == n
        finally:
            eng.close()

    def test_step_buckets_match_one_row(self, pool, ds):
        step = ForwardStep(apply_rows=pool.apply_rows)
        for b in SERVE_BUCKETS:
            x = torch.from_numpy(ds.x[:, 0].reshape(-1, L)[:b].copy())
            midx = torch.arange(b) % 3
            out = step.forward(pool.params, x, midx)
            assert out.shape == (b, 90)
            for i in (0, b - 1):
                np.testing.assert_array_equal(
                    out[i].numpy(), _alone(pool, int(midx[i]), x[i].numpy()))


class TestHotSwap:
    def test_no_torn_params_under_concurrent_load(self, pool, ds):
        table = [0, 1, 0, 1]
        eng = _engine(pool, table).start()
        try:
            eng.warmup()
            params_a = pool.params
            params_b = {k: p + 1.0 for k, p in params_a.items()}
            x = ds.x[0, 0, 0]
            expect = {(tag, m): _alone(pool, m, x, params)
                      for tag, params in (("A", params_a), ("B", params_b))
                      for m in range(2)}
            tag_of = {1: "A"}
            stop = threading.Event()

            def swapper():
                flip = 0
                while not stop.is_set():
                    flip += 1
                    v = eng.swap(params=params_b if flip % 2 else params_a,
                                 reason="test")
                    tag_of[v] = "B" if flip % 2 else "A"

            th = threading.Thread(target=swapper, daemon=True)
            th.start()
            try:
                with ThreadPoolExecutor(max_workers=8) as ex:
                    futs = [ex.submit(eng.submit, c % 4, x)
                            for c in range(120)]
                    results = [f.result(timeout=30) for f in futs]
            finally:
                stop.set()
                th.join(timeout=10)
            assert not th.is_alive()
            assert len({r.version for r in results}) > 1
            for c, r in enumerate(results):
                assert r.model == table[c % 4]
                np.testing.assert_array_equal(
                    r.logits, expect[tag_of[r.version], r.model],
                    err_msg=f"torn read at version {r.version}")
        finally:
            eng.close()

    def test_swap_routing_and_private_copy(self, pool, ds):
        eng = _engine(pool, [0, 1]).start()
        try:
            x = ds.x[0, 0, 0]
            before = eng.submit(0, x)
            v = eng.swap(routing=RoutingTable([2, 2]))
            assert v == eng.version == 2
            r = eng.submit(0, x)
            assert r.model == 2 and r.version == 2
            with torch.no_grad():      # the engine serves its own copy
                pool.params["lm_head/bias"].add_(1.0)
            try:
                eng.swap(routing=RoutingTable([0, 1]))
                np.testing.assert_array_equal(eng.submit(0, x).logits,
                                              before.logits)
            finally:
                with torch.no_grad():
                    pool.params["lm_head/bias"].sub_(1.0)
        finally:
            eng.close()


class TestErrorPaths:
    def test_malformed_and_not_started(self, pool, ds):
        eng = _engine(pool)
        with pytest.raises(RuntimeError):
            eng.submit(0, ds.x[0, 0, 0])
        eng.start()
        try:
            with pytest.raises(MalformedRequestError):
                eng.submit(0, np.zeros(L + 1, np.int32))
            with pytest.raises(MalformedRequestError):
                eng.submit("zero", ds.x[0, 0, 0])
        finally:
            eng.close()
        with pytest.raises(EngineStopped):
            eng.submit(0, ds.x[0, 0, 0])

    def test_dispatcher_crash_fails_requests(self, pool, ds):
        eng = _engine(pool).start()

        def boom(*a, **k):
            raise RuntimeError("boom")
        eng.step.apply_rows = boom
        try:
            with pytest.raises(EngineStopped):
                eng.submit(0, ds.x[0, 0, 0])
            assert eng.failed is not None
        finally:
            eng.close()

    def test_traffic_generator_counts_errors_and_completions(self, pool, ds):
        windows = ds.x.reshape(-1, L)
        eng = _engine(pool).start()
        try:
            eng.warmup()
            out = TrafficGenerator(
                eng, range(len(TABLE)), seed=1, concurrency=4,
                make_x=lambda rng: windows[rng.randint(len(windows))]
            ).run(40)
            assert out["completed"] == out["requests"] == 40
            assert out["errors"] == 0 and out["p99_ms"] >= out["p50_ms"]
            bad = TrafficGenerator(eng, [99], concurrency=2).run(4)
            assert bad["errors"] == 4 and bad["completed"] == 0
        finally:
            eng.close()


class TestTelemetry:
    def test_requests_record_spans_events_and_counters(self, pool, ds):
        from feddrift_torch import obs
        from feddrift_torch.obs import spans
        rec = spans.configure(None)
        eng = _engine(pool).start()
        try:
            served0 = obs.registry().counter("requests_served").value
            parent = spans.new_trace()
            eng.submit(1, ds.x[1, 0, 0], trace=parent)
            eng.swap(routing=RoutingTable(TABLE), reason="test")
        finally:
            eng.close()
            rec.enabled = False
        span = rec.spans("serve_request")[-1]
        assert span["args"]["trace_id"] == parent["trace_id"]
        assert span["args"]["parent_span_id"] == parent["span_id"]
        assert span["args"]["client"] == 1 and span["args"]["model"] == 1
        served = obs.get_bus().events("request_served")[-1]
        assert (served["client"], served["model"], served["version"]) == \
            (1, 1, 1)
        swapped = obs.get_bus().events("pool_swapped")[-1]
        assert swapped["version"] == 2 and swapped["reason"] == "test"
        assert obs.registry().counter("requests_served").value == served0 + 1
        with pytest.raises(ValueError):
            obs.emit("no_such_event")


class TestForwardStepVersusJax:
    def test_matches_jax_forward_step(self, ds):
        import jax
        import jax.numpy as jnp
        from feddrift_tpu.core.pool import ModelPool as JaxPool
        from feddrift_tpu.core.step import ForwardStep as JaxStep
        from feddrift_tpu.models.transformer import TransformerLM as JaxLM
        from feddrift_torch.convert import params_from_jax

        # three distinct models, stacked as the reference pool holds them
        module = JaxLM(attention_impl="blockwise", remat=False, **KW)
        init = jax.jit(module.init)
        slots = [init(jax.random.PRNGKey(s), jnp.zeros((2, L), jnp.int32))
                 ["params"] for s in range(3)]
        stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *slots)
        jpool = JaxPool(module=module, params=stacked,
                        init_params=slots[0], num_models=3)
        x = ds.x[:, 1].reshape(-1, L)[:8]
        midx = np.array([0, 2, 1, 1, 0, 2, 0, 1], np.int32)
        ref = np.asarray(JaxStep(apply_fn=jpool.apply).forward(
            jpool.params, jnp.asarray(x), jnp.asarray(midx)))
        params = params_from_jax(
            {k: np.asarray(v) for k, v in _flatten(jpool.params).items()},
            device="cpu")
        tpool = ModelPool(module=TransformerLM(**KW), params=params,
                          init_params={}, num_models=3)
        out = ForwardStep(apply_rows=tpool.apply_rows).forward(
            params, torch.from_numpy(x), torch.from_numpy(midx)).numpy()
        assert out.shape == ref.shape == (8, 90)
        np.testing.assert_allclose(out, ref, atol=1e-5)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out
