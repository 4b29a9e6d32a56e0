"""Serving layer: dynamic batcher semantics + the embed service HTTP surface.

The batcher is the online-inference shape (static bucket shapes,
one compile per bucket — see fitclip_tpu/serving/batcher.py); these tests
pin that requests are coalesced, padded rows never leak, backpressure
rejects, and failures fan out without killing the dispatcher.
"""
import io
import json
import threading
import time
from concurrent.futures import wait

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fitclip_tpu.serving import BatchServer
from fitclip_tpu.serving.batcher import ServerClosed, ServerOverloaded

ITEM = (5,)


def _tracking_encode(sleep_s: float = 0.0):
    """A jitted row-wise fn + a log of the batch sizes it was called with."""
    calls = []

    @jax.jit
    def fn(x):
        return jnp.tanh(x) * 2.0 + jnp.arange(x.shape[-1], dtype=x.dtype)

    def encode(x):
        calls.append(x.shape[0])
        if sleep_s:
            time.sleep(sleep_s)
        return fn(x)

    return encode, fn, calls


def test_results_match_unbatched_and_padding_never_leaks():
    encode, fn, calls = _tracking_encode()
    items = [np.random.default_rng(i).normal(size=ITEM).astype(np.float32)
             for i in range(23)]  # odd count: every batch needs padding
    with BatchServer(encode, ITEM, bucket_sizes=(4,), max_wait_ms=20) as srv:
        futures = [srv.submit(it) for it in items]
        outs = [f.result(timeout=30) for f in futures]
    for it, out in zip(items, outs):
        np.testing.assert_allclose(out, np.asarray(fn(it[None]))[0],
                                   rtol=1e-6)
    # Warmup + every dispatch used the static bucket shape.
    assert set(calls) == {4}


def test_coalesces_concurrent_requests():
    encode, _, calls = _tracking_encode()
    srv = BatchServer(encode, ITEM, bucket_sizes=(1, 2, 4, 8, 16),
                      max_wait_ms=50).start()
    try:
        n_warmup = len(calls)
        barrier = threading.Barrier(12)
        futures = [None] * 12

        def client(i):
            barrier.wait()
            futures[i] = srv.submit(np.full(ITEM, i, np.float32))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wait([f for f in futures if f is not None], timeout=30)
        dispatches = len(calls) - n_warmup
        # 12 near-simultaneous requests inside a 50 ms window must share
        # device calls; the bound is loose (threads may straggle) but a
        # per-request dispatch (12 calls) must not happen.
        assert dispatches < 12
        assert srv.stats.batches == dispatches
        assert srv.stats.mean_batch_fill > 0.4
    finally:
        srv.stop()


def test_backpressure_rejects_when_queue_full():
    encode, _, _ = _tracking_encode(sleep_s=0.2)
    srv = BatchServer(encode, ITEM, bucket_sizes=(1,), max_wait_ms=0,
                      queue_size=2).start(warmup=False)
    try:
        with pytest.raises(ServerOverloaded):
            for _ in range(50):  # outrun the 0.2 s/batch dispatcher
                srv.submit(np.zeros(ITEM, np.float32))
    finally:
        srv.stop()
    assert srv.stats.rejected >= 1


def test_error_fans_out_and_server_survives():
    toggle = {"fail": True}

    def encode(x):
        if toggle["fail"]:
            raise RuntimeError("poisoned batch")
        return x * 2

    srv = BatchServer(encode, ITEM, bucket_sizes=(1, 2),
                      max_wait_ms=0).start(warmup=False)
    try:
        bad = srv.submit(np.ones(ITEM, np.float32))
        with pytest.raises(RuntimeError, match="poisoned"):
            bad.result(timeout=10)
        toggle["fail"] = False
        good = srv.submit(np.ones(ITEM, np.float32))
        np.testing.assert_allclose(good.result(timeout=10),
                                   np.full(ITEM, 2.0))
    finally:
        srv.stop()


def test_submit_after_stop_raises():
    encode, _, _ = _tracking_encode()
    srv = BatchServer(encode, ITEM, bucket_sizes=(1,)).start(warmup=False)
    srv.stop()
    with pytest.raises(ServerClosed):
        srv.submit(np.zeros(ITEM, np.float32))


def test_item_shape_validated():
    encode, _, _ = _tracking_encode()
    with BatchServer(encode, ITEM, bucket_sizes=(1,)) as srv:
        with pytest.raises(ValueError, match="shape"):
            srv.submit(np.zeros((7,), np.float32))


@pytest.fixture()
def tiny_text_service(tmp_path):
    from fitclip_tpu.models.clip.load import load_tiny_test_encoder
    from fitclip_tpu.models.clip.tokenizer import write_tiny_test_vocab

    merges, vocab = write_tiny_test_vocab(
        str(tmp_path), ["a", "cat", "video", "of"] * 3)
    loaded = load_tiny_test_encoder(bpe_path=merges, vocab_path=vocab)

    from demo.embed_service import TextEmbedService

    service = TextEmbedService(loaded.encoder, loaded.params,
                               bucket_sizes=(1, 2, 4), max_wait_ms=5).start()
    yield loaded, service
    service.stop()


def test_embed_service_matches_direct_encode(tiny_text_service):
    loaded, service = tiny_text_service
    texts = ["a cat", "video of a cat", "a video"]
    out = service.embed_texts(texts)
    ids = loaded.encoder.get_tokenizer()(texts)
    direct = np.asarray(loaded.encoder.encode_text(loaded.params, ids))
    np.testing.assert_allclose(out, direct, rtol=2e-5, atol=2e-5)


def _write_test_video(path: str, num_frames: int = 12) -> None:
    import cv2

    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 8.0,
                             (64, 48))
    rng = np.random.default_rng(7)
    for _ in range(num_frames):
        writer.write(rng.integers(0, 256, size=(48, 64, 3), dtype=np.uint8))
    writer.release()


@pytest.fixture()
def tiny_video_service(tmp_path):
    from fitclip_tpu.models.clip.load import load_tiny_test_encoder

    from demo.embed_service import VideoEmbedService

    loaded = load_tiny_test_encoder()
    service = VideoEmbedService(loaded.encoder, loaded.params,
                                bucket_sizes=(1, 2), max_wait_ms=5).start()
    yield loaded, service, tmp_path
    service.stop()


def test_video_service_matches_eval_pipeline(tiny_video_service):
    """A served video embedding equals running the eval data pipeline +
    encode_video by hand — the serving path adds no numeric drift."""
    from fitclip_tpu.data.data_module import build_pipeline
    from fitclip_tpu.data.video_reader import VideoReader

    loaded, service, tmp_path = tiny_video_service
    path = str(tmp_path / "clip.avi")
    _write_test_video(path)
    data = open(path, "rb").read()

    out = service.embed_video_bytes(data, fmt="avi")

    pipeline = build_pipeline(loaded.encoder, train=False)
    reader = VideoReader.from_path(path)
    indices = pipeline.sampler(0, len(reader) - 1, fps=reader.get_avg_fps())
    clip = pipeline.transform(reader(indices), None)
    direct = np.asarray(loaded.encoder.encode_video(
        loaded.params, clip[None]))[0]
    np.testing.assert_allclose(out, direct, rtol=2e-5, atol=2e-5)
    assert out.shape == (loaded.encoder.config.embed_dim,)


def test_video_service_short_clip_pads(tiny_video_service):
    """A clip shorter than the encoder's frame count right-pads with zero
    frames (eval collate semantics) instead of crashing the bucket shape."""
    loaded, service, tmp_path = tiny_video_service
    path = str(tmp_path / "short.avi")
    _write_test_video(path, num_frames=2)
    out = service.embed_video_bytes(open(path, "rb").read(), fmt="avi")
    assert out.shape == (loaded.encoder.config.embed_dim,)
    assert np.isfinite(out).all()


def test_quantized_serving_requires_persisted_scales(tmp_path):
    """int8 encoders refuse to serve without offline-calibrated scales, and
    serve correctly (vs the calibrated encoder run by hand) once EMBED_SCALES
    points at the persisted .npz."""
    from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder
    from fitclip_tpu.models.clip.model import CLIPConfig
    from fitclip_tpu.ops.quant import quantize_clip_params, save_act_scales

    from demo.embed_service import VideoEmbedService, prepare_quantized_params

    config = CLIPConfig.tiny_test()
    float_enc = ClipVideoTextEncoder(config, num_frames=2)
    params = float_enc.init_params(jax.random.PRNGKey(0))
    quant_enc = ClipVideoTextEncoder(config, num_frames=2,
                                     dtype=jnp.bfloat16, quantized=True)
    qparams = quantize_clip_params(params)

    with pytest.raises(SystemExit, match="EMBED_SCALES"):
        prepare_quantized_params(quant_enc, qparams, None)

    rng = np.random.default_rng(5)
    video = jnp.asarray(rng.integers(
        0, 256, size=(2, 2, config.vision.image_size,
                      config.vision.image_size, 3)).astype(np.uint8))
    text = jnp.asarray(rng.integers(1, 60, size=(2, 16)).astype(np.int32))
    calibrated = quant_enc.calibrate(qparams, video, text)
    scales_path = str(tmp_path / "scales.npz")
    save_act_scales(scales_path, calibrated)

    served_params = prepare_quantized_params(quant_enc, qparams, scales_path)
    service = VideoEmbedService(quant_enc, served_params, bucket_sizes=(1,),
                                max_wait_ms=0).start()
    try:
        clip = np.asarray(video[0], np.uint8)
        out = service.server.submit(clip).result(timeout=60)
    finally:
        service.stop()
    direct = np.asarray(quant_enc.encode_video(calibrated, video[:1]))[0]
    np.testing.assert_allclose(out, direct, rtol=2e-2, atol=2e-2)


def test_retrieval_index_search_and_endpoint(tiny_text_service, tmp_path,
                                             monkeypatch):
    """/search_videos ranks a predict-dump index by cosine against the
    online-embedded query: the index row built FROM a query's own embedding
    must rank first with score ~1."""
    from demo.embed_service import RetrievalIndex

    import demo.embed_service as es

    loaded, service = tiny_text_service
    texts = ["a cat video", "a video of a dog", "cat piano"]
    embs = service.embed_texts(texts)

    index_path = str(tmp_path / "predictions.npz")
    np.savez(index_path, encoded_videos=embs.astype(np.float32),
             encoded_texts=embs.astype(np.float32),
             video_ids=np.asarray([f"video{i}" for i in range(len(texts))]))
    index = RetrievalIndex(index_path)
    results = index.search(embs[1], top_k=2)
    assert results[0]["video_id"] == "video1"
    assert results[0]["score"] > 0.999
    assert len(results) == 2

    monkeypatch.setattr(es, "_SERVICE", service)
    monkeypatch.setattr(es, "_INDEX", index)

    def call(path, query):
        status_box = {}

        def start_response(status, headers):
            status_box["status"] = status

        environ = {"REQUEST_METHOD": "GET", "PATH_INFO": path,
                   "QUERY_STRING": query, "CONTENT_LENGTH": "0",
                   "wsgi.input": io.BytesIO(b"")}
        chunks = es.application(environ, start_response)
        return status_box["status"], json.loads(b"".join(chunks))

    status, reply = call("/search_videos", "q=a+video+of+a+dog&top_k=2")
    assert status == "200 OK"
    assert reply["results"][0]["video_id"] == "video1"

    status, reply = call("/search_videos", "top_k=2")
    assert status == "400 Bad Request"

    monkeypatch.setattr(es, "_INDEX", None)
    monkeypatch.delenv("EMBED_INDEX", raising=False)
    status, reply = call("/search_videos", "q=cat")
    assert status == "503 Service Unavailable"


def test_embed_service_wsgi_surface(tiny_text_service, tiny_video_service,
                                    monkeypatch):
    import demo.embed_service as es

    _, service = tiny_text_service
    _, video_service, tmp_path = tiny_video_service
    monkeypatch.setattr(es, "_SERVICE", service)
    monkeypatch.setattr(es, "_VIDEO_SERVICE", video_service)

    def call(method, path, payload=None, raw=None, query=""):
        body = (raw if raw is not None else
                json.dumps(payload).encode() if payload is not None else b"")
        status_box = {}

        def start_response(status, headers):
            status_box["status"] = status

        environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
                   "QUERY_STRING": query,
                   "CONTENT_LENGTH": str(len(body)),
                   "wsgi.input": io.BytesIO(body)}
        chunks = es.application(environ, start_response)
        return status_box["status"], json.loads(b"".join(chunks))

    status, reply = call("POST", "/embed_text", {"texts": ["a cat video"]})
    assert status == "200 OK"
    assert len(reply["embeddings"]) == 1
    assert len(reply["embeddings"][0]) == reply["dim"]

    video_path = str(tmp_path / "wsgi.avi")
    _write_test_video(video_path)
    status, reply = call("POST", "/embed_video",
                         raw=open(video_path, "rb").read(), query="format=avi")
    assert status == "200 OK"
    assert len(reply["embedding"]) == reply["dim"]

    status, reply = call("GET", "/health")
    assert status == "200 OK" and reply["status"] == "ok"
    assert reply["video"]["requests"] >= 1

    status, reply = call("POST", "/embed_text", {"texts": "not-a-list"})
    assert status == "400 Bad Request"

    status, reply = call("POST", "/embed_video", raw=b"")
    assert status == "400 Bad Request"

    status, reply = call("POST", "/embed_video", raw=b"not a video")
    assert status == "400 Bad Request"  # decodes zero frames

    status, _ = call("GET", "/nope")
    assert status == "404 Not Found"
