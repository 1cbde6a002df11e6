"""The port's metrics plane, stepper API and HTTP front door on the CPU:
the registry's Prometheus text against the JAX package's, SSE decoding,
the stepper against ``run``, priority admission, cancellation in three
places (mid-decode with a shared prefix, mid-prefill, while waiting),
then the front door over real localhost sockets — streams equal to
``run``'s (with and without the ngram proposer), a client hanging up
mid-stream, 429 and 408 at the door, ``/metrics`` against the report, and
malformed requests. REDUCED h2o-danube-1.8b with the JAX package's
converted W4A16 weights; greedy tokens are also held to JAX's engine.
"""
import asyncio
import dataclasses
import json

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.runtime import frontdoor as jfrontdoor
from repro.runtime import metrics as jmetrics
from repro.runtime.engine import Request as JRequest
from repro.runtime.engine import ServingEngine as JServingEngine

from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve as tserve
from repro_torch.runtime import metrics as rmetrics
from repro_torch.runtime.engine import Request, ServingEngine
from repro_torch.runtime.frontdoor import (FrontDoor, QueueSettings,
                                           sse_decode_tokens)

from torch_parity_helpers import jax_to_numpy

ARCH = "h2o-danube-1.8b"
P, G, B = 8, 6, 2


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH),
                               w4a16_strategy="xla")
    jparams = JT.quantize_params(JT.init_params(jax.random.PRNGKey(0), jcfg),
                                 jcfg, min_size=0)
    cfg = configs.get_reduced(ARCH)
    tparams = from_jax_params(jax_to_numpy(jparams), dtype=cfg.dtype,
                              device="cpu")
    return jcfg, jparams, cfg, tparams


def _engine(weights, **kw):
    _, _, cfg, tparams = weights
    kw.setdefault("page_size", 4)
    kw.setdefault("prefill_chunk", 4)
    kw.setdefault("max_batch", B)
    return ServingEngine(cfg, tparams, max_prompt_len=P, max_new_tokens=G,
                         device="cpu", **kw)


def _prompts(n, *, seed=0, repeat=False):
    """``n`` prompts of P tokens; ``repeat``: each one half-length segment
    tiled twice (so the ngram proposer has something to propose)."""
    rng = np.random.default_rng(seed)
    if repeat:
        seg = rng.integers(0, 512, size=(n, P // 2))
        return [[int(t) for t in np.tile(seg[i], 2)] for i in range(n)]
    toks = rng.integers(0, 512, size=(n, P))
    return [[int(t) for t in toks[i]] for i in range(n)]


def _requests(prompts, **kw):
    return [Request(rid=i, prompt=p, max_new_tokens=G, **kw)
            for i, p in enumerate(prompts)]


def _jax_results(weights, prompts, **kw):
    jcfg, jparams, _, _ = weights
    eng = JServingEngine(jcfg, jparams, max_batch=B, max_prompt_len=P,
                         max_new_tokens=G, page_size=4, prefill_chunk=4,
                         **kw)
    return eng.run([JRequest(rid=i, prompt=p, max_new_tokens=G)
                    for i, p in enumerate(prompts)]).results


# ---------------------------------------------------------------------------
# metrics plane
# ---------------------------------------------------------------------------

def _exercise(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("c_total", "a counter")
    c.inc()
    c.inc(2)
    g = reg.gauge("g_depth")
    g.set(4)
    g.set(1.5)
    h = reg.histogram("h_seconds", "a summary")
    for v in (0.1, 0.2, 0.3, 2.0):
        h.observe(v)
    reg.counter("z_total").inc(0)
    return reg


def test_registry_render_and_snapshot_match_jax():
    got, want = _exercise(rmetrics), _exercise(jmetrics)
    assert got.render() == want.render()
    assert got.snapshot() == want.snapshot()
    assert 'h_seconds{quantile="0.5"} 0.2' in got.render()
    with pytest.raises(ValueError):
        got.gauge("c_total")
    with pytest.raises(ValueError):
        got.counter("c_total").inc(-1)
    vs = [5.0, 1.0, 4.0, 2.0, 3.0]
    for q in (0.01, 0.5, 0.95, 1.0):
        assert rmetrics.nearest_rank(vs, q) == jmetrics.nearest_rank(vs, q)
    assert rmetrics.summarize(vs) == jmetrics.summarize(vs)


def test_sse_decode_tokens_matches_jax():
    payload = (b"HTTP/1.1 200 OK\r\n\r\n"
               b"data: {\"rid\": 0, \"tokens\": [1, 2]}\r\n\r\n"
               b"data: not json\r\n\r\n"
               b"data: {\"rid\": 0, \"tokens\": [3]}\r\n\r\n"
               b"event: done\r\ndata: {\"rid\": 0, \"n\": 3}\r\n\r\n")
    assert sse_decode_tokens(payload) == \
        jfrontdoor.sse_decode_tokens(payload) == [1, 2, 3]


# ---------------------------------------------------------------------------
# stepper API
# ---------------------------------------------------------------------------

def _drive_stepper(eng, reqs):
    eng.start()
    for r in reqs:
        eng.submit(r)
    streamed, order = {}, []
    while eng.has_work():
        ev = eng.step()
        order.extend(ev.admitted)
        for rid, toks in ev.emitted.items():
            streamed.setdefault(rid, []).extend(toks)
    return streamed, order


def test_stepper_matches_run_and_jax(weights):
    prompts = _prompts(3)
    eng = _engine(weights)
    ref = eng.run(_requests(prompts))
    assert ref.results == _jax_results(weights, prompts)
    streamed, _ = _drive_stepper(eng, _requests(prompts))
    assert streamed == ref.results == eng.report.results
    assert eng.report.admitted == 3 and sorted(eng.report.ttft) == [0, 1, 2]
    assert eng.step().worked is False


def test_run_ignores_deadline_and_priority(weights):
    prompts = _prompts(3)
    plain = _engine(weights).run(_requests(prompts))
    tagged = _engine(weights).run(_requests(prompts, deadline_s=0.001,
                                            priority=7))
    assert tagged.results == plain.results and tagged.steps == plain.steps


def test_priority_admission_order_matches_jax(weights):
    jcfg, jparams, _, _ = weights
    prompts = _prompts(3)
    tags = [dict(priority=0), dict(priority=5),
            dict(priority=5, deadline_s=0.5)]
    eng = _engine(weights, max_batch=1, admission="priority")
    _, order = _drive_stepper(eng, [
        Request(rid=i, prompt=p, max_new_tokens=G, **t)
        for i, (p, t) in enumerate(zip(prompts, tags))])
    jeng = JServingEngine(jcfg, jparams, max_batch=1, max_prompt_len=P,
                          max_new_tokens=G, page_size=4, prefill_chunk=4,
                          admission="priority")
    jeng.start()
    for i, (p, t) in enumerate(zip(prompts, tags)):
        jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=G, **t))
    jorder = []
    while jeng.has_work():
        jorder.extend(jeng.step().admitted)
    assert order == jorder == [2, 1, 0]
    with pytest.raises(ValueError, match="admission"):
        _engine(weights, admission="wrong")


def test_submit_before_start_raises(weights):
    with pytest.raises(RuntimeError, match="start"):
        _engine(weights).submit(_requests(_prompts(1))[0])


@pytest.mark.parametrize("where", ["decode_shared", "prefill", "waiting"])
def test_cancel(weights, where):
    """Cancel mid-decode (one of two requests sharing a prompt: the
    survivor's tokens equal a solo run's and JAX's), mid-chunked-prefill,
    or while queued: the allocator ends exactly empty every time."""
    prompts = _prompts(2)
    eng = _engine(weights, prefill_chunk=2 if where == "prefill" else 4)
    if where == "decode_shared":
        ref = eng.run(_requests(prompts[:1]))
        eng.start()
        for rid in (0, 1):
            eng.submit(Request(rid=rid, prompt=prompts[0],
                               max_new_tokens=G))
        streamed, cancelled = {}, False
        while eng.has_work():
            ev = eng.step()
            for rid, toks in ev.emitted.items():
                streamed.setdefault(rid, []).extend(toks)
            if not cancelled and streamed.get(0) and streamed.get(1):
                before = eng.alloc.pages_in_use
                assert eng.cancel(0) is True
                assert eng.alloc.pages_in_use < before
                cancelled = True
        assert cancelled
        assert eng.report.cancelled[0] == streamed[0]
        assert 0 not in eng.report.results
        assert eng.report.results[1] == ref.results[0] \
            == _jax_results(weights, prompts[:1])[0]
        assert eng.cancel(0) is False
    elif where == "prefill":
        eng.start()
        eng.submit(_requests(prompts[:1])[0])
        ev = eng.step()                         # one 2-token chunk in
        assert ev.emitted.get(0) in (None, [])
        assert eng.alloc.pages_in_use > 0
        assert eng.cancel(0) is True
        assert not eng.has_work() and eng.report.cancelled[0] == []
    else:
        eng.start()
        for r in _requests(prompts):
            eng.submit(r)
        assert eng.cancel(1) is True
        assert eng.report.cancelled[1] == []
        assert sorted(eng.drain().results) == [0]
    assert eng.alloc.pages_in_use == 0


# ---------------------------------------------------------------------------
# HTTP front door over real localhost sockets
# ---------------------------------------------------------------------------

async def _raw(port, head, body=b""):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(head + body)
    await writer.drain()
    payload = await reader.read()
    writer.close()
    return payload


async def _post(port, spec):
    body = json.dumps(spec).encode()
    head = (f"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode()
    payload = await _raw(port, head, body)
    return int(payload.split(b" ", 2)[1]), payload


async def _get(port, path):
    payload = await _raw(
        port, f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    return int(payload.split(b" ", 2)[1]), payload


def _run_async(coro, timeout=300):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.mark.parametrize("speculate", [None, "ngram"])
def test_http_streams_match_run(weights, speculate):
    """Concurrent SSE streams equal ``engine.run``'s tokens (and JAX's),
    with and without the ngram proposer."""
    kw = dict(speculate=speculate, spec_k=2) if speculate else {}
    prompts = _prompts(3, repeat=bool(speculate))
    eng = _engine(weights, **kw)
    ref = eng.run(_requests(prompts))
    assert ref.results == _jax_results(weights, prompts, **kw)

    async def main():
        fd = FrontDoor(eng, settings=QueueSettings(queue_depth=8))
        await fd.serve()
        outs = await asyncio.gather(*(
            _post(fd.port, {"prompt": prompts[i], "max_new_tokens": G})
            for i in range(3)))
        return outs, await fd.shutdown()

    outs, report = _run_async(main())
    assert all(status == 200 for status, _ in outs)
    assert [sse_decode_tokens(p) for _, p in outs] == \
        [ref.results[i] for i in range(3)]
    assert eng.alloc.pages_in_use == 0
    assert report.admitted == 3 and not report.cancelled
    if speculate:
        assert report.proposed_tokens > 0


def test_http_cancel_mid_stream(weights):
    """A client hanging up mid-stream has its slot evicted and its pages
    freed while the other streams finish with ``run``'s tokens."""
    prompts = _prompts(3)
    eng = _engine(weights)
    ref = eng.run(_requests(prompts))

    async def canceller(port):
        body = json.dumps({"prompt": prompts[0],
                           "max_new_tokens": G}).encode()
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n").encode()
                     + body)
        await writer.drain()
        await reader.readuntil(b"\r\n\r\n")        # response headers
        await reader.readuntil(b"\r\n\r\n")        # first token event
        writer.close()
        await writer.wait_closed()

    async def main():
        fd = FrontDoor(eng, settings=QueueSettings(queue_depth=8))
        await fd.serve()
        _, *rest = await asyncio.gather(
            canceller(fd.port),
            *(_post(fd.port, {"prompt": prompts[i], "max_new_tokens": G})
              for i in (1, 2)))
        return rest, await fd.shutdown()

    rest, report = _run_async(main())
    assert [sse_decode_tokens(p) for _, p in rest] == [ref.results[1],
                                                       ref.results[2]]
    (crid,) = report.cancelled
    assert crid not in report.results and len(report.cancelled[crid]) < G
    assert eng.alloc.pages_in_use == 0
    assert eng.metrics.get("frontdoor_cancelled_total").value == 1


def test_http_429_and_408_without_touching_engine(weights):
    prompts = _prompts(3)
    eng = _engine(weights)

    async def main():
        fd = FrontDoor(eng, settings=QueueSettings(queue_depth=1))
        await fd.serve(start_driver=False)         # the queue can only fill
        s408, p408 = await _post(fd.port, {
            "prompt": prompts[0], "max_new_tokens": G, "deadline_s": 0})
        slow = asyncio.create_task(_post(fd.port, {
            "prompt": prompts[1], "max_new_tokens": G,
            "deadline_s": 0.05}))
        await asyncio.sleep(0.02)                  # let it enqueue
        s429, _ = await _post(fd.port, {"prompt": prompts[2],
                                        "max_new_tokens": G})
        await asyncio.sleep(0.1)                   # its deadline passes
        assert eng.report.steps == 0 and eng.alloc.pages_in_use == 0
        fd.start_driver()
        s_slow, _ = await slow
        return s408, p408, s429, s_slow, await fd.shutdown()

    s408, p408, s429, s_slow, report = _run_async(main())
    assert (s408, s429, s_slow) == (408, 429, 408)
    assert b"deadline" in p408
    assert report.rejected_429 == 1 and report.rejected_408 == 2
    assert report.steps == 0 and not report.results


def test_http_metrics_agree_with_report(weights):
    prompts = _prompts(3)
    eng = _engine(weights)

    async def main():
        fd = FrontDoor(eng, settings=QueueSettings(queue_depth=8))
        await fd.serve()
        await asyncio.gather(*(
            _post(fd.port, {"prompt": prompts[i], "max_new_tokens": G})
            for i in range(3)))
        status, payload = await _get(fd.port, "/metrics")
        sh, ph = await _get(fd.port, "/healthz")
        return status, payload, sh, ph, await fd.shutdown(), fd.metrics

    status, payload, sh, ph, report, m = _run_async(main())
    assert status == 200 and sh == 200
    assert json.loads(ph.split(b"\r\n\r\n", 1)[1])["ok"] is True
    text = payload.split(b"\r\n\r\n", 1)[1].decode()
    assert "# TYPE engine_queue_depth gauge" in text
    assert f"engine_admitted_total {report.admitted}" in text
    assert f"engine_tokens_total {3 * G}" in text
    assert report.admitted == 3
    assert m.get("frontdoor_rejected_429_total").value == report.rejected_429
    assert m.get("frontdoor_rejected_408_total").value == report.rejected_408
    assert m.get("frontdoor_queue_depth").peak == report.peak_queue_depth
    assert m.get("engine_e2e_seconds").summary() == report.latency_stats()
    assert m.get("engine_ttft_seconds").summary() == report.ttft_stats()
    assert m.get("engine_pages_in_use").value == 0


def test_http_rejects_malformed_requests(weights):
    eng = _engine(weights)
    good = _prompts(1)[0]

    async def main():
        fd = FrontDoor(eng)
        await fd.serve()
        out = {
            "no_prompt": (await _post(fd.port, {}))[0],
            "empty": (await _post(fd.port, {"prompt": []}))[0],
            "non_int": (await _post(fd.port, {"prompt": ["a"]}))[0],
            "too_long": (await _post(
                fd.port, {"prompt": list(range(P + 1))}))[0],
            "bad_gen": (await _post(
                fd.port, {"prompt": good, "max_new_tokens": 0}))[0],
            "embeds": (await _post(
                fd.port, {"prompt": good, "prefix_embeds": [[0.0]]}))[0],
            "lost": (await _get(fd.port, "/nope"))[0],
        }
        return out, await fd.shutdown()

    out, report = _run_async(main())
    assert out == {"no_prompt": 400, "empty": 400, "non_int": 400,
                   "too_long": 400, "bad_gen": 400, "embeds": 400,
                   "lost": 404}
    assert report.steps == 0 and report.admitted == 0


def test_serve_launcher_http_on_cpu():
    """``--http 0``: the launcher's requests through the front door give
    the in-process run's tokens, prompts of variable length included."""
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--requests", "3",
            "--prompt-len", "4:8", "--gen", "4", "--page-size", "4",
            "--device", "cpu"]
    ref = tserve.main(argv)
    rep = tserve.main(argv + ["--http", "0", "--arrival-every", "1"])
    assert rep.results == ref.results and sorted(rep.results) == [0, 1, 2]
    assert {len(r) for r in rep.results.values()} == {4}
    with pytest.raises(ValueError, match="MIN:MAX"):
        tserve.main(["--arch", ARCH, "--reduced", "--prompt-len", "8-4",
                     "--device", "cpu"])
