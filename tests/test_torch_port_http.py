"""The port's HTTP front end and DynamicBatcher, on the CPU: the eight tests
of `tests/test_server_http.py` and the two batcher tests of
`tests/test_serve.py` against `cpg_tpu_torch`, on 127.0.0.1 with an
ephemeral port. The server is an f32 VGG16-BN TaskServer at width 0.125
(one task); answers over HTTP must equal the in-process server's."""

import concurrent.futures
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from cpg_tpu_torch.data.augment import cifar_eval_preprocess as prep
from cpg_tpu_torch.serve import DynamicBatcher, TaskServer
from cpg_tpu_torch.server_http import _as_batch, serve_http
from cpg_tpu_torch.train.sequence import init_state, start_task

torch.set_num_threads(1)
NC = 5


@pytest.fixture(scope="module")
def served():
    g = torch.Generator().manual_seed(0)
    state = init_state("vgg16_bn_cifar", g, 0.125, device="cpu")
    start_task(state, "t1", NC, g)
    state.tasks[1].private["classifier/kernel"] = torch.randn(
        state.tasks[1].private["classifier/kernel"].shape, generator=g)
    srv = TaskServer(state, prep, compute_dtype=torch.float32, min_bucket=8,
                     device="cpu")
    x = np.random.RandomState(1).randint(0, 256, (16, 32, 32, 3)).astype(
        np.uint8)
    httpd = serve_http(srv, port=0)  # ephemeral port
    yield srv, httpd, x
    httpd.shutdown()


def _call(httpd, path, payload=None):
    url = f"http://127.0.0.1:{httpd.server_address[1]}{path}"
    if payload is None:
        req = urllib.request.Request(url)
    else:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_http_predict_matches_inprocess(served):
    srv, httpd, x = served
    got = _call(httpd, "/v1/predict", {"task_id": 1, "inputs": x[:5].tolist()})
    want = srv.predict(1, x[:5])
    np.testing.assert_allclose(np.array(got["logits"]), want, rtol=1e-5,
                               atol=1e-5)
    assert got["top1"] == np.argmax(want, -1).tolist()
    one = _call(httpd, "/v1/predict", {"task_id": 1, "inputs": x[0].tolist()})
    np.testing.assert_allclose(np.array(one["logits"]), want[:1], rtol=1e-5,
                               atol=1e-5)


def test_http_mixed_tasks_and_stats(served):
    srv, httpd, x = served
    out = _call(httpd, "/v1/predict_mixed",
                {"requests": [{"task_id": 1, "input": x[0].tolist()},
                              {"task_id": 1, "input": x[1].tolist()}]})
    want = srv.predict(1, x[:2])
    for i, r in enumerate(out["results"]):
        np.testing.assert_allclose(np.array(r["logits"]), want[i], rtol=1e-5,
                                   atol=1e-5)
    assert _call(httpd, "/v1/tasks")["1"] == {"name": "t1",
                                              "num_classes": NC}
    stats = _call(httpd, "/v1/stats")
    assert stats["requests"] >= 1 and stats["per_task"]["1"] >= 2


def test_http_errors(served):
    _, httpd, _ = served
    with pytest.raises(urllib.error.HTTPError) as e:
        _call(httpd, "/v1/predict", {"task_id": 1, "inputs": [[0, 1]]})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _call(httpd, "/v1/nope", {})
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _call(httpd, "/v1/nope")
    assert e.value.code == 404


def test_http_latency_stats(served):
    _, httpd, x = served
    _call(httpd, "/v1/predict", {"task_id": 1, "inputs": x[:2].tolist()})
    lat = _call(httpd, "/v1/stats")["latency_ms"]
    assert lat["count"] >= 1 and lat["max"] >= lat["avg"] > 0


def test_http_dtype_canonical_per_shape(served):
    """The dtype follows the task's input shape, never the payload: float
    payloads arrive float32, 1-D integer payloads int32 whether or not
    they fit a byte, image integers uint8, and out-of-range pixels are a
    400."""
    srv, httpd, x = served
    xf = x[:2].astype(np.float32) / 255.0
    got = _call(httpd, "/v1/predict", {"task_id": 1, "inputs": xf.tolist()})
    np.testing.assert_allclose(np.array(got["logits"]), srv.predict(1, xf),
                               rtol=1e-5, atol=1e-5)
    lo = _as_batch([[1, 2, 3, 4]], (4,))
    hi = _as_batch([[1, 2, 300, 4]], (4,))
    assert lo.dtype == hi.dtype == np.int32
    assert _as_batch(x[:1].tolist(), x.shape[1:]).dtype == np.uint8
    xi = x[:1].astype(np.int64) + 300
    with pytest.raises(urllib.error.HTTPError) as e:
        _call(httpd, "/v1/predict", {"task_id": 1, "inputs": xi.tolist()})
    assert e.value.code == 400
    assert "uint8" in json.loads(e.value.read())["error"]


def test_http_mixed_rejects_batch_input(served):
    _, httpd, x = served
    with pytest.raises(urllib.error.HTTPError) as e:
        _call(httpd, "/v1/predict_mixed",
              {"requests": [{"task_id": 1, "input": x[:3].tolist()}]})
    assert e.value.code == 400
    assert "ONE example" in json.loads(e.value.read())["error"]


def test_http_stats_count_per_request(served):
    """requests and latency count once per HTTP request; images per item."""
    _, httpd, x = served
    before = _call(httpd, "/v1/stats")
    _call(httpd, "/v1/predict_mixed",
          {"requests": [{"task_id": 1, "input": x[0].tolist()},
                        {"task_id": 1, "input": x[1].tolist()}]})
    after = _call(httpd, "/v1/stats")
    assert after["requests"] == before["requests"] + 1
    assert after["images"] == before["images"] + 2
    assert after["latency_ms"]["count"] == before["latency_ms"]["count"] + 1


def test_http_shutdown_closes_batcher(served):
    """httpd.shutdown() stops the DynamicBatcher's worker threads."""
    srv, _, x = served
    httpd = serve_http(srv, port=0, batch_window_ms=2.0)
    try:
        got = _call(httpd, "/v1/predict", {"task_id": 1,
                                           "inputs": x[0].tolist()})
        np.testing.assert_allclose(np.array(got["logits"]),
                                   srv.predict(1, x[:1]), rtol=1e-5,
                                   atol=1e-5)
        assert httpd.batcher._threads
    finally:
        httpd.shutdown()
    deadline = time.time() + 5
    while time.time() < deadline and any(
            t.is_alive() for t in httpd.batcher._threads.values()):
        time.sleep(0.05)
    assert not any(t.is_alive() for t in httpd.batcher._threads.values())


def test_http_burst_of_clients_is_answered(served):
    """128 client threads at once, 512 requests, each predict held 20 ms:
    every request is answered. With socketserver's default listen backlog
    of 5 the accept queue overflows and the kernel resets connections."""
    srv, _, x = served
    httpd = serve_http(srv, port=0)
    srv.predict = lambda tid, xs: (time.sleep(0.02),
                                   np.zeros((len(xs), NC), np.float32))[1]
    payload = {"task_id": 1, "inputs": x[0].tolist()}
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=128) as ex:
            outs = list(ex.map(
                lambda _: _call(httpd, "/v1/predict", payload), range(512)))
    finally:
        del srv.predict
        httpd.shutdown()
        httpd.server_close()
    assert len(outs) == 512
    assert all(o["logits"] == [[0.0] * NC] for o in outs)


def test_dynamic_batcher_coalesces_and_matches(served):
    """Concurrent single-image submits within the window: logits equal to
    direct predict, in fewer predict calls than requests."""
    srv, _, x = served
    want = srv.predict(1, x[:8])
    calls = []
    real = srv.predict
    srv.predict = lambda tid, xs: (calls.append(len(xs)), real(tid, xs))[1]
    batcher = DynamicBatcher(srv, max_delay_ms=250)
    try:
        batcher.predict(1, x[0])  # start the worker outside the count
        calls.clear()
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
            futs = [ex.submit(batcher.predict, 1, x[i]) for i in range(8)]
            outs = [f.result(timeout=60) for f in futs]
        for i, y in enumerate(outs):
            np.testing.assert_allclose(y[0], want[i], rtol=1e-5, atol=1e-5)
        assert len(calls) < 8, calls
        assert sum(calls) == 8
    finally:
        del srv.predict
        batcher.close()


def test_dynamic_batcher_propagates_errors(served):
    srv, _, x = served
    batcher = DynamicBatcher(srv, max_delay_ms=1)
    try:
        with pytest.raises(KeyError):
            batcher.predict(99, x[0])  # unknown task
        fut = batcher.submit(1, np.zeros((2, 5), np.uint8))  # bad shape
        with pytest.raises(Exception):
            fut.result(timeout=30)
    finally:
        batcher.close()
