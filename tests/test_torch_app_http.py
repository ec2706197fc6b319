"""The port's HTTP front end (`app_torch.py`): every endpoint against a live
server on 127.0.0.1, a tiny random model on the CPU.

The cases of `tests/test_app_http.py`; concurrent micro-batching is held by
`/stats`'s engine counters after the requests are released together from a
held dispatcher, not by a wall-clock window. The answers are held against
the port's direct calls on the same weights.
"""

import base64
import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import app_torch
import generate_torch
from mmada_tpu_torch.core.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads cost more than they
    save, and their spinning takes cores from the other test workers (the
    JAX app's micro-batching test waits on a 10 ms window); the setting is
    restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def server():
    cfg = load_config(os.path.join(REPO, "configs/tiny_test.yaml"), reader=generate_torch._yaml,
                      overrides=["model.mmada.num_vq_tokens=64",
                                 "dataset.preprocessing.resolution=16"])
    state = app_torch.AppState(cfg, device="cpu")
    httpd = app_torch.make_server(state, 0, "127.0.0.1")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    state.url = f"http://127.0.0.1:{httpd.server_address[1]}"
    yield state
    httpd.shutdown()
    httpd.server_close()
    state.stop_engine()


def get(state, path):
    return json.loads(urllib.request.urlopen(state.url + path, timeout=60).read())


def post(state, path, payload, timeout=300):
    req = urllib.request.Request(state.url + path, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=timeout).read())


def stream(state, path, payload, key):
    req = urllib.request.Request(state.url + path, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    out = []
    with urllib.request.urlopen(req, timeout=300) as resp:
        assert resp.headers.get("Content-Type") == "application/x-ndjson"
        for line in resp:
            if line.strip():
                out.append(json.loads(line)[key])
    return out


def png_b64(seed):
    buf = io.BytesIO()
    Image.fromarray((np.random.default_rng(seed).random((32, 32, 3)) * 255).astype(np.uint8)
                    ).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_health(server):
    assert get(server, "/health") == {"status": "ok"}


def test_generate_equals_the_direct_call(server):
    payload = {"prompt": "hello", "gen_length": 16, "steps": 8, "block_length": 8,
               "temperature": 0.0}
    out = post(server, "/generate", payload)
    ids = server._text_ids("hello")
    direct = server.model.generate(torch.tensor(ids), gen_length=16, steps=8, block_length=8)
    assert out["text"] == server._answer(direct, len(ids[0]))


def test_generate_stepwise(server):
    out = post(server, "/generate_stepwise", {"prompt": "hello", "gen_length": 16, "steps": 8,
                                              "block_length": 8, "temperature": 0.0})
    steps = out["steps"]
    assert len(steps) == 8 and all(len(s) == 16 for s in steps)
    assert all(t["state"] in ("MASK", "GEN") for s in steps for t in s)


def test_t2i_and_stepwise(server):
    out = post(server, "/t2i", {"prompt": "a cat", "timesteps": 2, "guidance_scale": 1.5})
    img = Image.open(io.BytesIO(base64.b64decode(out["image_png_b64"])))
    assert img.size == (16, 16)
    out = post(server, "/t2i_stepwise", {"prompt": "a cat", "timesteps": 2, "guidance_scale": 1.5})
    assert len(out["frames_png_b64"]) == 2


def test_mmu_with_seed(server):
    out = post(server, "/mmu", {"image_png_b64": png_b64(0), "question": "what?",
                                "max_new_tokens": 16, "steps": 8, "block_length": 16, "seed": 3})
    assert isinstance(out["text"], str)


def test_concurrent_generate_micro_batches(server):
    """Four /generate calls queued while the dispatcher is held and released
    together run as ONE batch (the /stats counters), with the sequential
    answer."""
    payload = {"prompt": "hello", "gen_length": 16, "steps": 8, "block_length": 8,
               "temperature": 0.0}
    want = post(server, "/generate", payload)["text"]
    stats0 = get(server, "/stats")["engine"]
    server.engine.pause()
    results = [None] * 4

    def worker(i):
        results[i] = post(server, "/generate", payload)["text"]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    deadline = time.time() + 60
    while get(server, "/stats")["engine"]["requests"] < stats0["requests"] + 4:
        assert time.time() < deadline
        time.sleep(0.01)
    server.engine.resume()
    for t in threads:
        t.join()
    assert results == [want] * 4
    stats1 = get(server, "/stats")["engine"]
    assert stats1["requests"] - stats0["requests"] == 4
    assert stats1["batches"] - stats0["batches"] == 1
    assert stats1["batched_requests"] - stats0["batched_requests"] == 4


def test_unknown_endpoint_404(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        post(server, "/nope", {})
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        get(server, "/nope")
    assert e.value.code == 404


def test_malformed_body_is_500_not_crash(server):
    req = urllib.request.Request(server.url + "/generate", b"{not json",
                                 {"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 500
    test_health(server)


def test_generate_kv_cache_modes(server):
    """kv_cache takes true and "int8" at the socket; with one step a block
    the cache is fresh every step, so the bf16 cache answers as the exact
    sampler; an unknown mode is an error."""
    base = {"prompt": "hi", "gen_length": 16, "steps": 2, "block_length": 8, "temperature": 0.0}
    exact = post(server, "/generate", base)
    cached = post(server, "/generate", {**base, "kv_cache": True})
    int8 = post(server, "/generate", {**base, "kv_cache": "int8"})
    assert isinstance(int8["text"], str)
    assert cached["text"] == exact["text"]
    with pytest.raises(urllib.error.HTTPError):
        post(server, "/generate", {**base, "kv_cache": "quantized"})


def test_generate_segment_steps_at_socket(server):
    """segment_steps goes through the engine's stream (the tiny config turns
    the chunk guard off: 2 blocks of 2 chunks) and answers as the exact
    sampler; with kv_cache too, the cached decode wins."""
    base = {"prompt": "hi", "gen_length": 16, "steps": 8, "block_length": 8, "temperature": 0.0}
    exact = post(server, "/generate", base)
    chunks = get(server, "/stats")["engine"]["chunks"]
    seg = post(server, "/generate", {**base, "segment_steps": 2})
    assert seg["text"] == exact["text"]
    assert get(server, "/stats")["engine"]["chunks"] == chunks + 4
    both = post(server, "/generate", {**base, "segment_steps": 2, "kv_cache": True})
    assert isinstance(both["text"], str)


def test_t2i_segment_timesteps_at_socket(server):
    base = {"prompt": "a cat", "timesteps": 4, "seed": 11}
    mono = post(server, "/t2i", base)
    chunks = get(server, "/stats")["engine"]["chunks"]
    seg = post(server, "/t2i", {**base, "segment_timesteps": 2})
    assert seg["image_png_b64"] == mono["image_png_b64"]
    assert get(server, "/stats")["engine"]["chunks"] == chunks + 2
    both = post(server, "/t2i", {**base, "segment_timesteps": 2, "kv_cache": True})
    assert "image_png_b64" in both


def test_t2i_stepwise_stream_matches_batch(server):
    payload = {"prompt": "a dog", "timesteps": 4, "seed": 7}
    batch = post(server, "/t2i_stepwise", payload)["frames_png_b64"]
    streamed = stream(server, "/t2i_stepwise", {**payload, "stream": True,
                                                "segment_timesteps": 3}, "frame_png_b64")
    assert streamed == batch


def test_generate_stepwise_stream_matches_batch(server):
    payload = {"prompt": "hi", "gen_length": 16, "steps": 8, "block_length": 8,
               "temperature": 1.0, "seed": 5}
    batch = post(server, "/generate_stepwise", payload)["steps"]
    streamed = stream(server, "/generate_stepwise", {**payload, "stream": True,
                                                     "segment_steps": 3}, "step")
    assert streamed == batch
    # the last state is /generate's answer with the same seed (the answer
    # drops non-text ids and decodes the rest)
    last = [t["token"] for t in batch[-1] if t["state"] == "GEN" and not t["token"].startswith("<")]
    text = post(server, "/generate", {**payload})["text"]
    assert "".join(last) == text


def test_stats_model_registry(server):
    out = get(server, "/stats")
    assert out["model"]["layers"] == out["model_layers"]
    assert out["model"]["params"] > 0
    assert out["model"]["quantized_leaves"] == ["bf16"]
    assert out["vq_model_loaded"] is True and out["engine_running"] is True
    assert out["devices"] == ["cpu"]
    assert set(out["engine"]) == {"requests", "batches", "batched_requests", "chunks",
                                  "stream_joins", "cancelled", "chunk_guard_skips"}
    assert out["latency"]["text"]["count"] >= 1


def test_mmu_thinking_prepends_instruction(server, monkeypatch):
    """thinking=true prepends the thinking instruction to the question
    before tokenization."""
    seen = []
    tok = server.tokenizer

    class Spy:
        def __call__(self, texts, **kw):
            seen.extend(texts)
            return tok(texts, **kw)

        def __getattr__(self, name):
            return getattr(tok, name)

    # the real instruction overflows the tiny model's 256-position RoPE table
    monkeypatch.setattr(server, "tokenizer", Spy())
    monkeypatch.setattr(app_torch, "THINK_PREFIX", "THINK:")
    out = post(server, "/mmu", {"image_png_b64": png_b64(1), "question": "what?",
                                "max_new_tokens": 16, "steps": 8, "block_length": 16,
                                "thinking": True})
    assert isinstance(out["text"], str)
    assert any(t.startswith("THINK:") and t.endswith("what?") for t in seen), seen


def test_app_state_serves_through_its_engine(server):
    """An AppState starts its engine when it is built: text, t2i and MMU
    calls made as a library go through it (its counters) and answer as the
    server's endpoints; after `stop_engine` they fail and `status()` says
    the engine is not running."""
    state = app_torch.AppState(server.cfg, device="cpu", loaded=(
        server.model, server.vq_params, server.vq_cfg, server.tokenizer, server.prompting,
        server.vocab))
    kw = dict(gen_length=16, steps=8, block_length=8, temperature=1.0, seed=4)
    pixels = np.random.default_rng(2).uniform(-1, 1, (16, 16, 3)).astype(np.float32)
    try:
        assert state.status()["engine_running"]
        text = post(server, "/generate", {"prompt": "hi", **kw})["text"]
        assert state.generate_text("hi", **kw) == text
        image = state.t2i("a cat", timesteps=2, seed=3)
        assert app_torch.png_b64(image) == post(server, "/t2i", {"prompt": "a cat", "timesteps": 2,
                                                                 "seed": 3})["image_png_b64"]
        mmu = dict(max_new_tokens=16, steps=8, block_length=16)
        assert state.mmu(pixels, "what?", **mmu) == server.mmu(pixels, "what?", **mmu)
        assert state.engine.stats["requests"] == 3
    finally:
        state.stop_engine()
    assert state.status()["engine_running"] is False
    with pytest.raises(RuntimeError):
        state.generate_text("hi", **kw)
