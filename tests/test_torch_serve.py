"""The port's scoring daemon (``crossscore_tpu_torch/tasks/serve.py``) on the
CPU: its ``Scorer`` against the JAX package's on one checkpoint (fp32,
dinov2-test, 84x112 synthetic renders, 2 references), against the port's
predict CLI, and its HTTP surface end to end on an ephemeral port through the
port's client: the typed errors, reload, backpressure, the SIGTERM drain with
``/livez``, and local data parallelism over two CPU replicas."""

import http.client
import io
import json
import os
import signal
import threading
import time

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from crossscore_tpu.io.images import image_read_bytes as jax_image_read_bytes
from crossscore_tpu.models import CrossScoreConfig as JaxConfig
from crossscore_tpu.models import CrossScoreNet as JaxNet
from crossscore_tpu.tasks.common import parse_cli as jax_parse_cli
from crossscore_tpu.tasks.serve import Scorer as JaxScorer
from crossscore_tpu_torch.client import ScoreClient, ScoreClientError
from crossscore_tpu_torch.data.records import encode_raw_payload
from crossscore_tpu_torch.data.synthetic import generate
from crossscore_tpu_torch.io.convert import load_into, state_dict_from_jax
from crossscore_tpu_torch.io.images import image_read, image_read_bytes, metric_map_read
from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
from crossscore_tpu_torch.tasks.common import parse_cli
from crossscore_tpu_torch.tasks.predict import main as predict_main
from crossscore_tpu_torch.tasks.serve import Scorer, install_sigterm_drain, main, make_server
from crossscore_tpu_torch.tools.serve_load_bench import run as load_bench

QUERY = "datadir/res_540/s00001/test/ours_1000/renders"
REFS = "datadir/res_540/s00001/train/ours_1000/gt"
COMMON = [
    "trainer.accelerator=cpu",
    "model.backbone.preset=dinov2-test",
    # deterministic first-K sampling: the predict CLI takes the same two
    # (sorted) references the daemon encodes
    "data.neighbour_config.cross=2",
    "data.neighbour_config.deterministic=true",
    f"data.dataset.reference_dir={REFS}",
    "this_main.resize_short_side=84",
    "this_main.serve_max_refs=2",
    "this_main.serve_port=0",
]
PORT = COMMON + ["model.gpu.compute_dtype=float32"]
# fp32, the JAX package against the port on one checkpoint: the per-frame
# mean within 1e-5 and the score map's MAE within 1e-4 (the net's bound,
# tests/test_torch_model.py)
MEAN_TOL, MAP_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The tree (cwd inside it) and two checkpoints in the port's format
    (``model.``-prefixed ``state_dict``): A from seeded JAX parameters
    through ``state_dict_from_jax``, B with A's weights scaled by 1.5."""
    root = tmp_path_factory.mktemp("torch_serve_ws")
    generate(root / "datadir", hw=(84, 112), scenes_per_split={"train": 1, "test": 1})
    old = os.getcwd()
    os.chdir(root)
    jcfg = JaxConfig.from_config(jax_parse_cli("default_predict", COMMON + ["model.tpu.compute_dtype=float32"]))
    q = np.zeros((1, 84, 112, 3), np.float32)
    params = jax.device_get(JaxNet(jcfg).init(jax.random.PRNGKey(0), q, np.stack([q, q], 1))["params"])
    model = load_into(CrossScoreNet(CrossScoreConfig.from_config(parse_cli("default_predict", PORT)), device="cpu"),
                      state_dict_from_jax(params))
    sd = {f"model.{k}": v for k, v in model.state_dict().items()}
    ckpts = {"A": root / "run" / "ckpt" / "a.ckpt", "B": root / "run" / "ckpt" / "b.ckpt"}
    ckpts["A"].parent.mkdir(parents=True)
    torch.save({"state_dict": sd}, ckpts["A"])
    torch.save({"state_dict": {k: v if k.endswith("img_mean_std") else v * 1.5 for k, v in sd.items()}}, ckpts["B"])
    yield root, ckpts
    os.chdir(old)


def _frames():
    return sorted(os.listdir(QUERY))


def _png(arr_u8: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr_u8).save(buf, format="PNG")
    return buf.getvalue()


def _start(cfg_extra, ckpt, devices=None):
    srv, scorer = make_server(parse_cli("default_predict", PORT + [f"trainer.ckpt_path_to_load={ckpt}"] + cfg_extra),
                              devices)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address[:2]
    return srv, scorer, ScoreClient(f"http://{host}:{port}", timeout=120), thread


def _stop(srv, thread):
    if thread.is_alive():
        srv.shutdown()
        thread.join(timeout=30)
    srv.server_close()


@pytest.fixture(scope="module")
def server(ws):
    """The port's daemon (micro-batching up to 4, a 20 ms window) on A."""
    _, ckpts = ws
    srv, scorer, client, thread = _start(["this_main.serve_max_batch=4", "this_main.serve_batch_window_ms=20"],
                                         ckpts["A"])
    yield srv, scorer, client
    _stop(srv, thread)


@pytest.fixture
def fresh(ws):
    """``start(*overrides, devices=None)``: a daemon of its own on A, for
    tests that reload, block or stop it; each is stopped after the test."""
    started = []

    def start(*extra, devices=None):
        started.append(_start(list(extra), ws[1]["A"], devices))
        return started[-1]

    yield start
    for srv, _, _, thread in started:
        _stop(srv, thread)


@pytest.fixture(scope="module")
def jax_scorer(ws):
    _, ckpts = ws
    return JaxScorer(jax_parse_cli("default_predict", COMMON + [
        "model.tpu.compute_dtype=float32", f"trainer.ckpt_path_to_load={ckpts['A']}", "this_main.serve_max_batch=4"]))


def _mae(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).mean())


@pytest.mark.parametrize("case", ["reference_shape", "mixed_aspect", "microbatch"])
def test_scorer_matches_jax(server, jax_scorer, case):
    """The same checkpoint, queries and references through both daemons:
    a reference-shaped query and a mixed-aspect one (84x60 -> 117x84 ->
    trimmed 112x84, against the 6x8 reference grid) over HTTP as PNG bytes
    (JSON mean and ``map=npy``), and a micro-batch of 3 queries in the
    bucket of 4 through each ``_run_device``."""
    _, scorer, client = server
    frames = [np.asarray(Image.open(os.path.join(QUERY, f))) for f in _frames()]
    if case == "microbatch":
        qs = np.stack([scorer._preprocess(f.astype(np.float32) / 255.0) for f in frames])
        assert len(qs) == 3
        want_maps, want_means = jax_scorer._run_device(qs, True)
        got_maps, got_means = scorer._run_device(qs, True)
        assert (84, 112, 4) in scorer.compiled_shapes
        np.testing.assert_allclose(got_means, want_means, rtol=0, atol=MEAN_TOL)
        assert got_maps.shape == want_maps.shape == (3, 84, 112)
        assert _mae(got_maps, want_maps) < MAP_TOL
        return
    body = _png(frames[0] if case == "reference_shape" else np.ascontiguousarray(frames[0][:, :60]))
    want = jax_scorer.score_bytes(body)
    got, got_map = client.score(body), client.score_map(body)
    hw = (84, 112) if case == "reference_shape" else (112, 84)
    assert (got["height"], got["width"]) == (want["height"], want["width"]) == hw
    assert got_map.shape == want["score_map"].shape == hw and got_map.dtype == np.float32
    assert abs(got["mean_score"] - want["mean_score"]) < MEAN_TOL
    assert _mae(got_map, want["score_map"]) < MAP_TOL


def test_daemon_matches_port_predict_cli(ws, server, tmp_path):
    """The daemon's per-frame means and maps against the port's predict CLI
    on the same queries and references (the counterpart of
    tests/test_serve.py's check against tasks.predict): the summary CSV's
    4-decimal means, and the written uint16 maps within one count."""
    _, ckpts = ws
    _, scorer, _ = server
    out = predict_main(PORT + [f"trainer.ckpt_path_to_load={ckpts['A']}", f"data.dataset.query_dir={QUERY}",
                               "data.loader.validation.batch_size=1", "data.loader.validation.num_workers=0",
                               "logger.predict.write.config.vis_img_every_n_steps=-1",
                               "logger.predict.write.config.score_map_colour_mode=gray",
                               "logger.predict.write.flag.image_query=false",
                               "logger.predict.write.flag.image_reference=false",
                               f"logger.predict.out_dir={tmp_path / 'out'}"])
    df = pd.read_csv(next((out / "score_summary").rglob("*.csv"))).sort_values("image_name")
    frames = _frames()
    assert len(df) == len(frames)
    maps = sorted((out / "batch" / "score_map_ref_cross").glob("*.png"))
    for fname, name, want in zip(frames, df["image_name"], df[df.columns[-1]]):
        assert fname.endswith(name)
        res = scorer.score_path(os.path.join(QUERY, fname))
        assert res["mean_score"] == pytest.approx(float(want), abs=5.1e-5)  # %.4f in the CSV
        written = next(p for p in maps if p.name.endswith("_" + fname))
        # the CLI writes SSIM maps in the metric's intrinsic range [-1, 1]
        got = metric_map_read(written, [-1, 1])
        assert np.abs(got - res["score_map"]).max() <= 1.01 / 32767


def test_healthz_and_livez(server, jax_scorer):
    """``/healthz`` carries the JAX daemon's keys (the client and the load
    bench read them); ``/livez`` answers 200."""
    srv, scorer, client = server
    h = client.health()
    assert set(h) == set(jax_scorer.health())
    assert h["status"] == "ok" and h["refs"] == 2 and h["backend"] == "cpu" and h["aot_shapes"] == 0
    assert h["token_shape"] == [2, 48, 64]  # K, 6x8 patches, D of dinov2-test
    assert [84, 112, 4] in h["compiled_shapes"] and h["max_batch"] == 4
    host, port = srv.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=30)
    conn.request("GET", "/livez")
    r = conn.getresponse()
    assert r.status == 200 and json.loads(r.read())["status"] == "alive"


@pytest.mark.parametrize("mode", ["json", "npy", "png"])
def test_score_responses(server, mode):
    """``/score`` as JSON, as ``.npy`` and as a uint16 PNG, against the
    ``Scorer`` called directly on the same file."""
    _, scorer, client = server
    path = os.path.join(QUERY, _frames()[1])
    want = scorer.score_path(path)
    if mode == "json":
        got = client.score(path)
        assert set(got) == {"mean_score", "height", "width", "time_ms"}
        assert got["mean_score"] == pytest.approx(want["mean_score"], abs=1e-6)
    elif mode == "npy":
        np.testing.assert_allclose(client.score_map(path), want["score_map"], atol=1e-6)
    else:
        png = np.asarray(Image.open(io.BytesIO(client.score_map_png(path))))
        assert png.dtype == np.uint16 and png.shape == (84, 112)
        assert np.abs(png / 65535.0 - want["score_map"]).max() <= 1.01 / 65535  # vrange [0, 1]


def test_score_path_keeps_order(server):
    _, scorer, client = server
    paths = [os.path.join(QUERY, f) for f in reversed(_frames())]
    got = client.score_paths(paths)
    assert [r["path"] for r in got] == paths
    for r in got:
        assert r["mean_score"] == pytest.approx(scorer.score_path(r["path"], want_map=False)["mean_score"], abs=1e-6)


def _raw_post(srv, path: str, headers: dict, body: bytes = b""):
    host, port = srv.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=30)
    conn.putrequest("POST", path, skip_accept_encoding=True)
    for k, v in headers.items():
        conn.putheader(k, v)
    conn.endheaders()
    if body:
        conn.send(body)
    r = conn.getresponse()
    return r.status, json.loads(r.read())["error"]


@pytest.mark.parametrize("case", ["non_numeric_length", "negative_length", "too_large", "unknown_path",
                                  "bad_json", "no_paths", "raw_payload"])
def test_bad_requests_are_typed(server, case):
    """Typed 4xx answers: the 413 comes before any of the body is read (none
    is sent), the bad lengths and bodies (a malformed ``CSRT`` raw-tensor
    header among them, as the JAX daemon answers it) give 400s, an unknown
    path 404."""
    srv, _, _ = server
    status, err = {
        "non_numeric_length": lambda: _raw_post(srv, "/score", {"Content-Length": "abc"}),
        "negative_length": lambda: _raw_post(srv, "/score", {"Content-Length": "-5"}),
        "too_large": lambda: _raw_post(srv, "/score", {"Content-Length": str(65 * 1024 * 1024)}),
        "unknown_path": lambda: _raw_post(srv, "/nope", {"Content-Length": "2"}, b"{}"),
        "bad_json": lambda: _raw_post(srv, "/reload", {"Content-Length": "3"}, b"{x}"),
        "no_paths": lambda: _raw_post(srv, "/score_path", {"Content-Length": "2"}, b"{}"),
        "raw_payload": lambda: _raw_post(srv, "/score", {"Content-Length": "8"}, b"CSRT\0\0\0\0"),
    }[case]()
    want = {"non_numeric_length": (400, "BadRequest: non-numeric"), "negative_length": (400, "BadRequest: negative"),
            "too_large": (413, "PayloadTooLarge"), "unknown_path": (404, "unknown path"),
            "bad_json": (400, "JSONDecodeError"), "no_paths": (400, "needs 'path' or 'paths'"),
            "raw_payload": (400, "ValueError: not a CSRT raw-tensor payload")}[case]
    assert status == want[0] and want[1] in err


@pytest.mark.parametrize("kind", ["rgb", "gray", "rgba", "csrt"])
def test_image_read_bytes_matches_jax(kind, tmp_path):
    rng = np.random.default_rng(3)
    shape = {"rgb": (20, 30, 3), "gray": (20, 30), "rgba": (20, 30, 4), "csrt": (20, 30, 3)}[kind]
    body = _png(rng.integers(0, 256, shape, dtype=np.uint8))
    if kind == "csrt":  # a decoded record shard's raw-tensor payload of the PNG
        (tmp_path / "a.png").write_bytes(body)
        body = encode_raw_payload(tmp_path / "a.png")
    got = image_read_bytes(body)
    assert got.shape == (20, 30, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_image_read_bytes(body))


def test_reload_roundtrip_and_failed_reload(ws, fresh):
    """``/reload`` swaps the weights and the reference tokens: B scores
    otherwise, A again gives A's bits; a reload that fails keeps the old
    weights and checkpoint path."""
    _, ckpts = ws
    _, scorer, client, _ = fresh()
    path = os.path.join(QUERY, _frames()[0])
    a = client.score(path)["mean_score"]
    res = client.reload(str(ckpts["B"]))
    assert res["status"] == "reloaded" and res["peak_memory_gib"] is None  # no card: no device peak
    assert client.health()["ckpt"] == str(ckpts["B"])
    b = client.score(path)["mean_score"]
    assert abs(b - a) > 1e-4
    with pytest.raises(ScoreClientError, match="400.*FileNotFoundError"):
        client.reload(str(ckpts["A"].parent / "missing.ckpt"))
    assert client.health()["ckpt"] == str(ckpts["B"]) and client.score(path)["mean_score"] == b
    assert scorer.cfg.trainer.ckpt_path_to_load == str(ckpts["B"])
    scorer.reload(str(ckpts["A"]))
    assert client.score(path)["mean_score"] == a


def test_reload_during_a_storm(ws, fresh):
    """A reload in the middle of concurrent requests: no request fails, and
    each mean is A's or B's."""
    _, ckpts = ws
    _, scorer, client, _ = fresh("this_main.serve_max_batch=4")
    path = os.path.join(QUERY, _frames()[0])
    body = open(path, "rb").read()
    a = client.score(body)["mean_score"]
    scorer.reload(str(ckpts["B"]))
    b = client.score(body)["mean_score"]
    scorer.reload(str(ckpts["A"]))
    means, errors = [], []
    lock = threading.Lock()

    def worker():
        for _ in range(6):
            try:
                m = client.score(body)["mean_score"]
            except Exception as e:  # collected for the assertion below
                with lock:
                    errors.append(repr(e))
                continue
            with lock:
                means.append(m)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    while not means and not errors:
        time.sleep(0.005)
    client.reload(str(ckpts["B"]))
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(means) == 24
    assert all(min(abs(m - a), abs(m - b)) < 1e-5 for m in means)
    assert client.health()["ckpt"] == str(ckpts["B"])


def test_micro_batching_coalesces(fresh):
    """Requests that queue while a dispatch holds the card go out together:
    fewer dispatches than requests, a batch above 1."""
    srv, scorer, client, _ = fresh("this_main.serve_max_batch=4")
    body = open(os.path.join(QUERY, _frames()[0]), "rb").read()
    want = client.score(body)["mean_score"]
    h0 = client.health()
    got = []
    with scorer._lock:  # the dispatch loop blocks on its first batch; the rest queue
        threads = [threading.Thread(target=lambda: got.append(client.score(body)["mean_score"])) for _ in range(4)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while srv.inflight.value < 4 and time.monotonic() < deadline:
            time.sleep(0.005)
        time.sleep(0.5)  # each handler decodes and queues its query
    for t in threads:
        t.join(timeout=60)
    h1 = client.health()
    assert len(got) == 4 and all(abs(m - want) < 1e-6 for m in got)
    assert h1["requests"] - h0["requests"] == 4 and h1["dispatches"] - h0["dispatches"] <= 2
    assert h1["max_batch_seen"] >= 2


def test_backpressure_reaches_the_client(fresh):
    """With the card busy and ``serve_max_queue=1`` full, a request gets the
    typed 503 through the client, and ``/healthz`` counts it."""
    _, scorer, client, _ = fresh("this_main.serve_max_batch=2", "this_main.serve_max_queue=1")
    body = open(os.path.join(QUERY, _frames()[0]), "rb").read()
    results = []

    def one():
        try:
            results.append(client.score(body)["mean_score"])
        except ScoreClientError as e:
            results.append(e)

    with scorer._lock:
        threads = [threading.Thread(target=one) for _ in range(4)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while scorer._rejected.value < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
    for t in threads:
        t.join(timeout=60)
    refused = [r for r in results if isinstance(r, ScoreClientError)]
    assert len(results) == 4 and refused and len(refused) < 4
    assert all("503" in str(e) and "ServerOverloaded" in str(e) for e in refused)
    assert client.health()["rejected_503"] == len(refused)


def test_sigterm_drain_keeps_livez(fresh):
    """SIGTERM with a request in flight (its body half sent): ``/livez``
    answers 200 and ``/healthz`` 503 through the drain, a new request gets
    the typed 503, the accepted one completes with 200, then the accept
    loop exits."""
    old = signal.getsignal(signal.SIGTERM)
    srv, scorer, client, thread = fresh()
    body = open(os.path.join(QUERY, _frames()[0]), "rb").read()
    host, port = srv.server_address[:2]
    try:
        install_sigterm_drain(srv)
        slow = http.client.HTTPConnection(host, port, timeout=60)
        slow.putrequest("POST", "/score", skip_accept_encoding=True)
        slow.putheader("Content-Length", str(len(body)))
        slow.endheaders()
        slow.send(body[:64])
        deadline = time.monotonic() + 30
        while srv.inflight.value < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert srv.inflight.value == 1
        signal.raise_signal(signal.SIGTERM)
        assert srv.draining.is_set()
        probe = http.client.HTTPConnection(host, port, timeout=30)
        probe.request("GET", "/livez")
        r = probe.getresponse()
        assert r.status == 200 and json.loads(r.read())["status"] == "draining"
        probe = http.client.HTTPConnection(host, port, timeout=30)
        probe.request("GET", "/healthz")
        r = probe.getresponse()
        assert r.status == 503 and json.loads(r.read())["status"] == "draining"
        with pytest.raises(ScoreClientError, match="503.*ServerDraining"):
            client.score(body)
        slow.send(body[64:])
        r = slow.getresponse()
        assert r.status == 200
        assert json.loads(r.read())["mean_score"] == pytest.approx(scorer.score(image_read(io.BytesIO(body)),
                                                                                want_map=False)["mean_score"])
        thread.join(timeout=30)
        assert not thread.is_alive() and srv.drain_clean is True
        assert srv.inflight.value == 0 and srv.drain_rejected.value == 1
    finally:
        signal.signal(signal.SIGTERM, old)


def test_local_dp_over_two_cpu_replicas(ws, fresh):
    """Local data parallelism with two CPU replicas: a batch of 3 in the
    bucket of 4 is split 2 + 2 and equals, bit for bit, the one device's
    forwards of the two halves; a reload rebuilds the replicas from the new
    model."""
    _, ckpts = ws
    _, scorer, client, _ = fresh("this_main.serve_max_batch=4", devices=["cpu", "cpu"])
    qs = np.stack([scorer._preprocess(image_read(os.path.join(QUERY, f))) for f in _frames()])

    def one_device():
        padded = torch.from_numpy(np.concatenate([qs, qs[-1:]]))
        halves = [scorer._forward(scorer.model, half, scorer.tokens) for half in padded.chunk(2)]
        return (torch.cat([h[i] for h in halves])[:3].numpy() for i in (0, 1))

    h = client.health()
    assert h["local_devices"] == 2 and h["local_dp_meshes"] == [2]  # the warm-up split buckets 2 and 4
    for _ in range(2):  # A, then B after the reload
        maps, means = scorer._run_device(qs, True)
        want_maps, want_means = one_device()
        np.testing.assert_array_equal(maps, want_maps)
        np.testing.assert_array_equal(means, want_means)
        source, replicas = scorer._placed[2]
        assert source is scorer.model and replicas[0][0] is scorer.model and replicas[1][0] is not scorer.model
        old_entry = scorer._placed[2]
        scorer.reload(str(ckpts["B"]))
        assert scorer._placed == {}
    scorer._run_device(qs, False)
    assert scorer._placed[2] is not old_entry and scorer._placed[2][0] is scorer.model


def test_upload_cast_gives_the_same_bf16_scores(ws):
    """Under bf16 the host-side cast of ``serve_upload_cast`` is the cast the
    model makes first: the same bits."""
    _, ckpts = ws
    base = COMMON + [f"trainer.ckpt_path_to_load={ckpts['A']}"]
    plain = Scorer(parse_cli("default_predict", base))
    cast = Scorer(parse_cli("default_predict", base + ["this_main.serve_upload_cast=true"]))
    assert plain._in_dtype == torch.float32 and cast._in_dtype == torch.bfloat16
    path = os.path.join(QUERY, _frames()[0])
    np.testing.assert_array_equal(cast.score_path(path)["score_map"], plain.score_path(path)["score_map"])


@pytest.mark.parametrize("case", ["no_dir", "empty_dir", "mixed_shapes", "untrimmed_warm_shape", "serve_aot_save",
                                  "serve_aot_load"])
def test_refusals(ws, tmp_path, case):
    """The JAX daemon's errors for the reference dir and the warm shapes, and
    the AOT options, which hold XLA executables."""
    root, ckpts = ws
    extra = {"no_dir": ["data.dataset.reference_dir=null"],
             "empty_dir": [f"data.dataset.reference_dir={tmp_path}"],
             "mixed_shapes": [f"data.dataset.reference_dir={tmp_path}"],
             "untrimmed_warm_shape": ["this_main.serve_warm_shapes=[84x100]"],
             "serve_aot_save": [f"this_main.serve_aot_save={tmp_path / 'x.aot'}"],
             "serve_aot_load": [f"this_main.serve_aot_load={tmp_path / 'x.aot'}"]}[case]
    if case == "mixed_shapes":
        rng = np.random.default_rng(0)
        Image.fromarray(rng.integers(0, 256, (84, 112, 3), dtype=np.uint8)).save(tmp_path / "a.png")
        Image.fromarray(rng.integers(0, 256, (112, 84, 3), dtype=np.uint8)).save(tmp_path / "b.png")
    match = {"no_dir": "requires data.dataset.reference_dir", "empty_dir": "no reference images",
             "mixed_shapes": "share one post-resize shape", "untrimmed_warm_shape": "must be %14-trimmed",
             "serve_aot_save": "AOT artifacts hold XLA executables",
             "serve_aot_load": "AOT artifacts hold XLA executables"}[case]
    with pytest.raises(ValueError, match=match):
        Scorer(parse_cli("default_predict", PORT + [f"trainer.ckpt_path_to_load={ckpts['A']}"] + extra))


def test_load_bench_reports_the_daemon(server):
    """The port's load bench against the daemon: every request answered,
    percentiles in order, the daemon's requests counted (the warm one
    included)."""
    _, _, client = server
    res = load_bench(client.base_url, open(os.path.join(QUERY, _frames()[0]), "rb").read(), workers=3, requests=2)
    assert res["requests_ok"] == 6 and res["errors"] == 0 and res["throughput_rps"] > 0
    lat = res["latency_ms"]
    assert 0 < lat["p50"] <= lat["p95"] <= lat["p99"] <= lat["max"]
    assert res["daemon"]["requests"] == 7 and 1 <= res["daemon"]["dispatches"] <= 7
    assert res["daemon"]["backend"] == "cpu"


def test_main_needs_cuda_unless_told_cpu(ws):
    """The CLI runs on the card unless told ``trainer.accelerator=cpu``."""
    argv = [a for a in PORT if a != "trainer.accelerator=cpu"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
