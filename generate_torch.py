"""Text generation by semi-autoregressive masked diffusion, on the card.

The PyTorch port's counterpart of `generate.py`, with its keys and defaults:

    python generate_torch.py config=configs/mmada_demo.yaml \\
        model.mmada.pretrained_model_path=/path/to/MMaDA-8B-Base \\
        prompt="..." gen_length=512 steps=256 block_length=64

One key more: `device` (the card unless `device=cpu`). A `config=` file is
read with PyYAML; without PyYAML, give every key as a dotted override. The
fast-decode knobs (`kv_cache`, `parallel_threshold`, ...) default to the
family-resolved `serving.text.*` / `serving.*` values
(`serve.loader.task_serving_defaults`); `segment_steps` above 0 runs the
exact sampler in chunks of that many steps (the same tokens; the cached
decode wins when both are set), as `generate.py` does.

`load(cfg)` builds the tokenizer, prompting and model; `run(cfg, loaded)`
returns each prompt's generated ids; `main` prints the answer's text. Under
`torchrun` the loader serves the model sharded or in pipeline stages over
the ranks (`parallel.*`, `serve/loader.py`); every rank computes, rank 0
prints.
"""

import sys

DEFAULT_PROMPT = "What is the capital of France?"


def _yaml(stream):
    import yaml

    return yaml.safe_load(stream)


def read_config(argv):
    from mmada_tpu_torch.core.config import load_config

    return load_config(cli_args=argv, reader=_yaml)


def settings(cfg) -> dict:
    """The sampler's keywords for `entry.serve_text`: the direct keys over the
    family-resolved serving defaults."""
    from mmada_tpu_torch.core.config import parse_kv_cache
    from mmada_tpu_torch.serve.loader import task_serving_defaults

    d = task_serving_defaults(cfg, "text")
    gen_length = int(cfg.get("gen_length", 128))
    kv_cache = parse_kv_cache(cfg.get("kv_cache", d["kv_cache"]))
    return dict(
        gen_length=gen_length,
        steps=int(cfg.get("steps", 128)),
        block_length=int(cfg.get("block_length", gen_length)),
        temperature=float(cfg.get("temperature", 0.0)),
        cfg_scale=float(cfg.get("cfg_scale", 0.0)),
        block_kv_cache=kv_cache,
        parallel_threshold=float(cfg.get("parallel_threshold", d["parallel_threshold"])),
        parallel_warmup_steps=int(cfg.get("parallel_warmup_steps", d["parallel_warmup_steps"])),
        cache_refresh_every=int(cfg.get("cache_refresh_every", d["cache_refresh_every"])),
        # the cached decode wins when both defaults are set
        segment_steps=0 if kv_cache else int(cfg.get("segment_steps", d["segment_steps"])),
        seed=int(cfg.get("seed", 0)),
    )


def chat_text(tokenizer, text: str, chat=True) -> str:
    """`text` through the tokenizer's chat template, where it has one."""
    if chat and hasattr(tokenizer, "apply_chat_template"):
        try:
            return tokenizer.apply_chat_template([{"role": "user", "content": text}],
                                                 add_generation_prompt=True, tokenize=False)
        except Exception:  # a tokenizer whose template is missing or broken
            return text
    return text


def load(cfg):
    """The tokenizer, vocab, prompting and model of `cfg` (no MAGVIT-v2:
    `generate.py` builds none)."""
    from mmada_tpu_torch.serve.loader import (
        Loaded, build_model, build_prompting, build_text_tokenizer, build_vocab)

    tokenizer = build_text_tokenizer(cfg)
    vocab = build_vocab(cfg)
    prompting = build_prompting(cfg, tokenizer, vocab)
    model = build_model(cfg, vocab, cfg.get("device"))
    return Loaded(model, None, None, tokenizer, prompting, vocab)


def run(cfg, loaded, prompts=None):
    """Each prompt's `gen_length` generated ids (fused vocab, on the CPU);
    `prompts` defaults to the config's `prompt`. Prompts whose frames have
    one length share a batch (`entry.serve_text`)."""
    from mmada_tpu_torch.entry import serve_text

    if prompts is None:
        prompts = [cfg.get("prompt", DEFAULT_PROMPT)]
    texts = [chat_text(loaded.tokenizer, p, cfg.get("chat", True)) for p in prompts]
    return serve_text(loaded.model, texts, loaded.tokenizer, device=cfg.get("device"),
                      **settings(cfg))


def answer_text(loaded, ids) -> str:
    """The answer's text: ids outside the text vocab (image or motion codes,
    which a text tokenizer cannot decode) are dropped."""
    return loaded.tokenizer.decode(ids[ids < loaded.vocab.text_vocab_size].tolist())


def main(argv) -> int:
    from mmada_tpu_torch.core.mesh import is_main_process

    cfg = read_config(argv)
    loaded = load(cfg)
    answers = run(cfg, loaded)   # every rank computes (a launcher's ranks)
    if is_main_process():
        for ids in answers:
            print(answer_text(loaded, ids))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
