"""HTTP front end of the PyTorch port: text, MMU and t2i requests on the card.

The port's counterpart of `app.py`'s `AppState` and `run_http`: a JSON API on
the standard library's `http.server`, every text, MMU and t2i request served
through the port's `ServingEngine` (`mmada_tpu_torch/serve/engine.py`), which
micro-batches concurrent requests and owns the card; MAGVIT-v2's decode runs
in the caller's thread. Endpoints:

    GET  /health /stats
    POST /generate /generate_stepwise /t2i /t2i_stepwise /mmu

with `app.py`'s request fields (`/generate_stepwise` and `/t2i_stepwise`
stream NDJSON over chunked transfer with `"stream": true`). Run it as

    python app_torch.py config=configs/mmada_demo.yaml \\
        model.mmada.pretrained_model_path=/path/to/MMaDA-8B-Base port=7860

with the command lines' keys (`device=cpu` for the CPU; `host` defaults to
0.0.0.0). The fast-decode knobs default to the family-resolved `serving.*`
values, as in JAX. `AppState` loads through `serve.loader.load_all`, or takes
an already-loaded model (`loaded=`). Not ported: the Gradio panel
(`run_gradio`, ROADMAP A.9). PIL is imported inside the functions that need
it, so the module imports without it.

Over several ranks, as JAX's app serves on a slice,

    torchrun --nproc-per-node 4 app_torch.py config=... parallel.tensor=4

loads the model sharded over the mesh of `parallel.*` (the loader), and rank
0 binds the port and runs the engine's dispatcher while ranks 1..N-1 follow
it over the control channel (`serve/ranks.py`; `serving.control_timeout_s`,
30 by default), running every model call on their shards. The stepwise
demos go through the engine like every other request, so one ordered stream
of calls reaches the model; MAGVIT-v2's encode and decode are not sharded
and run on rank 0 only. A rank that fails a call alone, or falls behind,
fails the requests in flight and stops the server: every rank exits with an
error.
`/health` and `/stats` answer on rank 0.
"""

import base64
import io
import json
import os
import sys
import threading

import numpy as np

from mmada_tpu_torch.core.mesh import CONTROL_TIMEOUT_S
from mmada_tpu_torch.serve.engine import ServingEngine, T2ISettings, TextSettings, partials

THINK_PREFIX = (
    "You should first think about the reasoning process in the mind and "
    "then provide the user with the answer. The reasoning process is "
    "enclosed within <think> </think> tags."
)  # the reference app's thinking-mode instruction

ENDPOINTS = "/health /stats /generate /generate_stepwise /t2i /t2i_stepwise /mmu"


class AppState:
    def __init__(self, cfg, device=None, loaded=None):
        """`loaded`: a `serve.loader.Loaded` to serve instead of loading
        `cfg`'s model again (its weights must lie on `device`)."""
        import torch

        from mmada_tpu_torch.core.device import resolve_device
        from mmada_tpu_torch.serve.loader import load_all, task_serving_defaults

        self.device = resolve_device(device if device is not None else cfg.get("device"))
        if loaded is None:
            loaded = load_all(cfg, self.device)
        (self.model, self.vq_params, self.vq_cfg, self.tokenizer,
         self.prompting, self.vocab) = loaded
        if self.model.device.type != self.device.type:
            raise ValueError(f"model weights are on {self.model.device}, the app serves on "
                             f"{self.device}")
        self._torch = torch
        self.cfg = cfg
        # MAGVIT-v2 runs in the caller's thread (rank 0 only)
        self.lock = threading.Lock()
        # the deployment's fast-decode defaults, family-resolved; request
        # fields override them
        self.serving_defaults = {t: task_serving_defaults(cfg, t) for t in ("text", "mmu", "t2i")}
        # every model call: the batched engine, which owns the card; over a
        # mesh every rank builds it, rank 0 dispatches and the others follow
        self.engine = ServingEngine(
            self.model,
            min_chunk_device_ms=float(self.cfg.get_path("serving.min_chunk_device_ms", 25.0)),
            control_timeout_s=float(self.cfg.get_path("serving.control_timeout_s",
                                                       CONTROL_TIMEOUT_S)),
        )
        if self.engine.leader:
            self.engine.start()

    @property
    def leader(self) -> bool:
        """Rank 0 (or one process): it serves HTTP."""
        return self.engine.leader

    def follow(self) -> int:
        """Ranks 1..N-1: follow rank 0's engine until it stops (`follow`'s
        return code)."""
        return self.engine.follow()

    def stop_engine(self):
        """Stop the engine; every request fails after it."""
        self.engine.stop()

    # ------------------------------------------------------------- tasks
    def _text_ids(self, prompt):
        """Token ids with a leading BOS (every LM training frame starts with
        one; a plain tokenizer never inserts it)."""
        ids = list(self.tokenizer([prompt])["input_ids"][0])
        bos = self.prompting.sp.bos
        if not ids or ids[0] != bos:
            ids = [bos] + ids
        return [ids]

    def _answer(self, out, start):
        answer = np.asarray(out)[0, start:]
        answer = answer[answer < self.vocab.text_vocab_size]
        return self.tokenizer.decode(answer.tolist())

    def _resolve(self, task, **given):
        """Request values over the family's deployment defaults; the cached
        decode wins over segmentation (and for t2i, the guidance interval)."""
        d = self.serving_defaults[task]
        out = {k: (d[k] if v is None else v) for k, v in given.items()}
        if out.get("kv_cache"):
            for k in ("segment_steps", "segment_timesteps"):
                if k in out:
                    out[k] = 0
            if "cfg_interval" in out:
                out["cfg_interval"] = (0.0, 1.0)
        if "cfg_interval" in out and out["cfg_interval"] is None:
            out["cfg_interval"] = (0.0, 1.0)
        return out

    def generate_text(self, prompt, gen_length=128, steps=64, block_length=32,
                      temperature=1.0, cfg_scale=0.0, remasking="low_confidence",
                      thinking=False, seed=0, kv_cache=None, parallel_threshold=None,
                      parallel_warmup_steps=None, cache_refresh_every=None,
                      segment_steps=None):
        k = self._resolve("text", kv_cache=kv_cache, parallel_threshold=parallel_threshold,
                          parallel_warmup_steps=parallel_warmup_steps,
                          cache_refresh_every=cache_refresh_every, segment_steps=segment_steps)
        if thinking:
            prompt = THINK_PREFIX + "\n" + prompt
        ids = self._text_ids(prompt)
        settings = TextSettings(
            gen_length=gen_length, steps=steps, block_length=block_length,
            temperature=temperature, cfg_scale=cfg_scale, remasking=remasking,
            block_kv_cache=k["kv_cache"], parallel_threshold=k["parallel_threshold"],
            parallel_warmup_steps=k["parallel_warmup_steps"],
            cache_refresh_every=k["cache_refresh_every"], segment_steps=k["segment_steps"])
        out = self.engine.submit_text(np.asarray(ids[0]), settings, seed=seed).result()[None]
        return self._answer(out, len(ids[0]))

    def _token_states(self, state):
        mask_id = self.vocab.mask_token_id
        toks = []
        for t in state.tolist():
            if t == mask_id:
                toks.append({"token": "[MASK]", "state": "MASK"})
            elif t < self.vocab.text_vocab_size:
                toks.append({"token": self.tokenizer.decode([t]), "state": "GEN"})
            else:
                toks.append({"token": f"<{t}>", "state": "GEN"})
        return toks

    def generate_text_stepwise(self, prompt, gen_length=128, steps=64, block_length=32,
                               temperature=1.0, cfg_scale=0.0, thinking=False, seed=0):
        """Per-step token states for streaming visualization: one entry per
        denoise step with the answer region's tokens and their state."""
        if thinking:
            prompt = THINK_PREFIX + "\n" + prompt
        ids = self._text_ids(prompt)
        traj = self.engine.submit_text_steps(
            np.asarray(ids[0]), seed=seed, gen_length=gen_length, steps=steps,
            block_length=block_length, temperature=temperature, cfg_scale=cfg_scale).result()
        return [self._token_states(state) for state in traj[:, 0, len(ids[0]):]]

    def generate_text_stepwise_iter(self, prompt, gen_length=128, steps=64, block_length=32,
                                    temperature=1.0, cfg_scale=0.0, thinking=False, seed=0,
                                    segment_steps=1):
        """Incremental stepwise token states: each step's states as soon as
        its chunk of at most `segment_steps` steps has run
        (`segmented_stepwise_run`); step for step `generate_text_stepwise`'s."""
        if thinking:
            prompt = THINK_PREFIX + "\n" + prompt
        ids = self._text_ids(prompt)
        fut = self.engine.submit_text_steps(
            np.asarray(ids[0]), seed=seed, segment_steps=max(1, int(segment_steps)),
            gen_length=gen_length, steps=steps, block_length=block_length,
            temperature=temperature, cfg_scale=cfg_scale)
        for window in partials(fut):   # the engine's chunks; socket writes here
            for state in window[:, 0, len(ids[0]):]:
                yield self._token_states(state)

    def _t2i_frames(self, prompt):
        num_vq = int(self.cfg.get_path("model.mmada.num_vq_tokens", 1024))
        mask_id = self.vocab.mask_token_id
        image_ids = np.full((1, num_vq), mask_id, np.int64)
        input_ids, attn = self.prompting(([prompt], image_ids), "t2i_gen")
        uncond_ids, uncond_attn = self.prompting.t2i_gen_uncond(1, num_vq, mask_id)
        return num_vq, input_ids, attn, uncond_ids, uncond_attn

    def _decode(self, codes):
        """uint8 (H, W, 3) pixels of one image's codes."""
        from mmada_tpu_torch.entry import decode_images

        with self.lock:
            return decode_images(self.vq_params, self.vq_cfg, codes, device=self.device)[0].numpy()

    def t2i(self, prompt, timesteps=15, guidance_scale=3.5, temperature=1.0, seed=0,
            kv_cache=None, cache_refresh_every=None, segment_timesteps=None,
            cfg_interval=None):
        k = self._resolve("t2i", kv_cache=kv_cache, cache_refresh_every=cache_refresh_every,
                          segment_timesteps=segment_timesteps, cfg_interval=cfg_interval)
        num_vq, input_ids, attn, uncond_ids, uncond_attn = self._t2i_frames(prompt)
        settings = T2ISettings(
            timesteps=timesteps, guidance_scale=guidance_scale, temperature=temperature,
            num_vq_tokens=num_vq, block_kv_cache=k["kv_cache"],
            cache_refresh_every=k["cache_refresh_every"],
            segment_timesteps=k["segment_timesteps"], cfg_interval=tuple(k["cfg_interval"]))
        codes = self.engine.submit_t2i(
            np.asarray(input_ids[0]), np.asarray(uncond_ids[0]), settings, seed=seed,
            attention_mask=np.asarray(attn[0]),
            uncond_attention_mask=np.asarray(uncond_attn[0])).result()[None]
        return self._decode(codes)

    def _t2i_steps(self, prompt, timesteps, guidance_scale, temperature, seed, segment=0):
        """The engine's stepwise t2i request for one prompt (a batch of 1)."""
        num_vq, input_ids, attn, uncond_ids, uncond_attn = self._t2i_frames(prompt)
        return self.engine.submit_t2i_steps(
            np.asarray(input_ids[0]), np.asarray(uncond_ids[0]), seed=seed,
            attention_mask=np.asarray(attn[0]), uncond_attention_mask=np.asarray(uncond_attn[0]),
            segment_timesteps=segment, temperature=temperature, timesteps=timesteps,
            guidance_scale=guidance_scale, num_vq_tokens=num_vq)

    def t2i_stepwise(self, prompt, timesteps=15, guidance_scale=3.5, temperature=1.0, seed=0):
        """Each step's decoded frame."""
        trajectory = self._t2i_steps(prompt, timesteps, guidance_scale, temperature,
                                     seed).result()
        return [self._decode(step_codes) for step_codes in trajectory]

    def t2i_stepwise_iter(self, prompt, timesteps=15, guidance_scale=3.5, temperature=1.0,
                          seed=0, segment_timesteps=1):
        """Incremental stepwise frames: each step's image as soon as its
        window of at most `segment_timesteps` steps has run
        (`SegmentedT2IRun`); frame for frame `t2i_stepwise`'s."""
        fut = self._t2i_steps(prompt, timesteps, guidance_scale, temperature, seed,
                              segment=max(1, int(segment_timesteps)))
        for window in partials(fut):
            for step_codes in window:
                yield self._decode(step_codes)

    def status(self) -> dict:
        """The loaded model's identity card and the engine's counters."""
        from mmada_tpu_torch.models.llada import named_leaves

        leaves = [t for _, t in named_leaves(self.model.params)]
        n_params = int(sum(np.prod(t.shape) for t in leaves))
        schemes = {type(t).__name__ for t in leaves if not isinstance(t, self._torch.Tensor)}
        if self.device.type == "cuda":
            devices = [f"cuda:{i} {self._torch.cuda.get_device_name(i)}"
                       for i in range(self._torch.cuda.device_count())]
        else:
            devices = [str(self.device)]
        payload = {
            "model": {
                "layers": self.model.cfg.n_layers,
                "d_model": self.model.cfg.d_model,
                "n_heads": self.model.cfg.n_heads,
                "params": n_params,
                "vocab_size": self.vocab.total_vocab_size,
                "quantized_leaves": sorted(schemes) or ["bf16"],
                "checkpoint": str(self.cfg.get_path("model.mmada.pretrained_model_path",
                                                    "(random init)")),
            },
            "vq_model_loaded": self.vq_params is not None,
            "devices": devices,
            "mesh": None if self.model.mesh is None else dict(zip(
                self.model.mesh.mesh_dim_names, self.model.mesh.shape)),
            "engine_running": self.engine.running,
        }
        with self.engine._stats_lock:
            payload["engine"] = dict(self.engine.stats)
        payload["latency"] = self.engine.latency_stats()
        return payload

    def mmu(self, image_arr, question, max_new_tokens=128, steps=64, block_length=64,
            temperature=0.0, cfg_scale=0.0, remasking="low_confidence", seed=0, kv_cache=None,
            parallel_threshold=None, parallel_warmup_steps=None, cache_refresh_every=None,
            segment_steps=None, thinking=False):
        k = self._resolve("mmu", kv_cache=kv_cache, parallel_threshold=parallel_threshold,
                          parallel_warmup_steps=parallel_warmup_steps,
                          cache_refresh_every=cache_refresh_every, segment_steps=segment_steps)
        if image_arr is None:
            return "(no image provided)"
        from mmada_tpu_torch.models import magvit2

        pixels = self._torch.as_tensor(np.ascontiguousarray(image_arr)[None],
                                       dtype=self._torch.float32).to(self.device)
        with self.lock:
            codes = magvit2.get_code(self.vq_params, self.vq_cfg, pixels).cpu().numpy()
        fused = codes[0] + self.vocab.image_offset
        sp = self.prompting.sp
        if thinking:
            question = THINK_PREFIX + "\n" + question
        text_ids = self.tokenizer([question])["input_ids"][0]
        frame = np.concatenate([[sp.mmu, sp.soi], fused, [sp.eoi, sp.bos], text_ids]
                               ).astype(np.int64)[None]
        settings = TextSettings(
            gen_length=max_new_tokens, steps=steps, block_length=block_length,
            temperature=temperature, cfg_scale=cfg_scale, remasking=remasking,
            block_kv_cache=k["kv_cache"], parallel_threshold=k["parallel_threshold"],
            parallel_warmup_steps=k["parallel_warmup_steps"],
            cache_refresh_every=k["cache_refresh_every"], segment_steps=k["segment_steps"])
        out = self.engine.submit_mmu(frame[0], settings, seed=seed).result()[None]
        return self._answer(out, frame.shape[1])


def png_b64(arr) -> str:
    """A uint8 (H, W, 3) image as the base64 PNG the endpoints send."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def image_from_png_b64(data: str):
    """The PIL image of a base64 PNG, as /mmu reads it."""
    from PIL import Image

    return Image.open(io.BytesIO(base64.b64decode(data)))


def _optional(req, key, cast):
    return cast(req[key]) if key in req else None


def make_server(state: AppState, port: int, host: str = "0.0.0.0"):
    """A `ThreadingHTTPServer` bound to (host, port) that answers the
    endpoints from `state`; `serve_forever()` runs it and `shutdown()` stops
    it (`state.stop_engine()` after)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from mmada_tpu_torch.core.config import parse_cfg_interval, parse_kv_cache

    class Handler(BaseHTTPRequestHandler):
        # chunked transfer (the stepwise streams) is HTTP/1.1; every other
        # reply sends Content-Length, so keep-alive stays correct
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _reply(self, payload, code=200):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _stream(self, items):
            """NDJSON over chunked transfer; once the headers are out, a
            failure ends inside the framing (an error line), never as a
            second response spliced into the body."""
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def emit(obj):
                data = (json.dumps(obj) + "\n").encode()
                self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            try:
                for obj in items:
                    emit(obj)
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True
            except Exception as e:
                try:
                    emit({"error": str(e)})
                    self.wfile.write(b"0\r\n\r\n")
                except Exception:
                    self.close_connection = True

        def do_GET(self):
            if self.path == "/health":
                self._reply({"status": "ok"})
            elif self.path == "/stats":
                st = state.status()
                # the flat keys HTTP clients of the JAX app consume
                st["vocab_size"] = st["model"]["vocab_size"]
                st["model_layers"] = st["model"]["layers"]
                st["d_model"] = st["model"]["d_model"]
                self._reply(st)
            else:
                self._reply({"error": "not found"}, 404)

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                fast_text = dict(
                    kv_cache=_optional(req, "kv_cache", parse_kv_cache),
                    parallel_threshold=_optional(req, "parallel_threshold", float),
                    parallel_warmup_steps=_optional(req, "parallel_warmup_steps", int),
                    cache_refresh_every=_optional(req, "cache_refresh_every", int),
                    segment_steps=_optional(req, "segment_steps", int))
                if self.path == "/generate":
                    text = state.generate_text(
                        req.get("prompt", ""), gen_length=int(req.get("gen_length", 128)),
                        steps=int(req.get("steps", 64)),
                        block_length=int(req.get("block_length", 32)),
                        temperature=float(req.get("temperature", 1.0)),
                        cfg_scale=float(req.get("cfg_scale", 0.0)),
                        remasking=req.get("remasking", "low_confidence"),
                        thinking=bool(req.get("thinking", False)),
                        seed=int(req.get("seed", 0)), **fast_text)
                    self._reply({"text": text})
                elif self.path == "/generate_stepwise":
                    kw = dict(gen_length=int(req.get("gen_length", 128)),
                              steps=int(req.get("steps", 64)),
                              block_length=int(req.get("block_length", 32)),
                              temperature=float(req.get("temperature", 1.0)),
                              cfg_scale=float(req.get("cfg_scale", 0.0)),
                              thinking=bool(req.get("thinking", False)),
                              seed=int(req.get("seed", 0)))
                    if req.get("stream"):
                        self._stream({"step": toks} for toks in state.generate_text_stepwise_iter(
                            req.get("prompt", ""), segment_steps=int(req.get("segment_steps", 1)),
                            **kw))
                        return
                    self._reply({"steps": state.generate_text_stepwise(req.get("prompt", ""),
                                                                       **kw)})
                elif self.path == "/t2i":
                    arr = state.t2i(
                        req.get("prompt", ""), timesteps=int(req.get("timesteps", 15)),
                        guidance_scale=float(req.get("guidance_scale", 3.5)),
                        temperature=float(req.get("temperature", 1.0)),
                        seed=int(req.get("seed", 0)),
                        kv_cache=fast_text["kv_cache"],
                        cache_refresh_every=fast_text["cache_refresh_every"],
                        segment_timesteps=_optional(req, "segment_timesteps", int),
                        cfg_interval=_optional(req, "cfg_interval", parse_cfg_interval))
                    self._reply({"image_png_b64": png_b64(arr)})
                elif self.path == "/t2i_stepwise":
                    kw = dict(timesteps=int(req.get("timesteps", 15)),
                              guidance_scale=float(req.get("guidance_scale", 3.5)),
                              temperature=float(req.get("temperature", 1.0)),
                              seed=int(req.get("seed", 0)))
                    if req.get("stream"):
                        self._stream({"frame_png_b64": png_b64(arr)} for arr in
                                     state.t2i_stepwise_iter(
                                         req.get("prompt", ""),
                                         segment_timesteps=int(req.get("segment_timesteps", 1)),
                                         **kw))
                        return
                    self._reply({"frames_png_b64": [
                        png_b64(arr) for arr in state.t2i_stepwise(req.get("prompt", ""), **kw)]})
                elif self.path == "/mmu":
                    from inference_mmu_torch import image_transform

                    img = image_from_png_b64(req["image_png_b64"])
                    res = int(state.cfg.get_path("dataset.preprocessing.resolution", 512))
                    text = state.mmu(
                        image_transform(img, res), req.get("question", "Describe this image."),
                        thinking=bool(req.get("thinking", False)),
                        max_new_tokens=int(req.get("max_new_tokens", 128)),
                        steps=int(req.get("steps", 64)),
                        block_length=int(req.get("block_length", 64)),
                        temperature=float(req.get("temperature", 0.0)),
                        cfg_scale=float(req.get("cfg_scale", 0.0)),
                        remasking=req.get("remasking", "low_confidence"),
                        seed=int(req.get("seed", 0)), **fast_text)
                    self._reply({"text": text})
                else:
                    self._reply({"error": "unknown endpoint"}, 404)
            except Exception as e:
                self._reply({"error": str(e)}, 500)

    return ThreadingHTTPServer((host, port), Handler)


def run_http(state: AppState, port: int, host: str = "0.0.0.0") -> int:
    """Serve until interrupted or the engine faults (a rank failed alone or
    fell behind: the server shuts down). Returns the exit code: 1 after a
    fault."""
    server = make_server(state, port, host)
    state.engine.on_fault = lambda exc: threading.Thread(target=server.shutdown,
                                                         daemon=True).start()
    mesh = state.model.mesh
    ranks = "" if mesh is None else f", {mesh.mesh.numel()} ranks over mesh {tuple(mesh.shape)}"
    print(f"serving on http://{host}:{port} (endpoints: {ENDPOINTS}{ranks})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        state.stop_engine()
    return 1 if state.engine.fault is not None else 0


def main(argv) -> int:
    """Rank 0 (or the one process) serves HTTP; the other ranks of a
    launcher's run follow its engine."""
    import torch.distributed as dist

    from generate_torch import read_config

    cfg = read_config(argv)
    state = AppState(cfg)
    if not state.leader:
        return state.follow()
    if state.model.mesh is None and dist.is_initialized() and dist.get_rank() > 0:
        return 0   # parallel.serving none: rank 0 serves its whole model alone
    return run_http(state, int(cfg.get("port", 7860)), str(cfg.get("host", "0.0.0.0")))


if __name__ == "__main__":
    code = main(sys.argv[1:])
    sys.stdout.flush()
    sys.stderr.flush()
    # after a fault a thread may wait in a collective a failed rank left
    os._exit(code)
