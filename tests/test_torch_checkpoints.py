"""The port's checkpoint loading, configs and serving defaults against the JAX package.

* `config_from_hf_json` on the Gen-Verse MMaDA-8B field set, and the
  `config.json` the port writes (`hf_config`) against JAX's
  `export_hf_config`.
* `load_pretrained` on fp32 files the tests write (one file, shards with an
  index, `block_groups` keys, tied and untied heads, `pytorch_model.bin`):
  the port's leaves equal JAX's (`params_from_jax` of its tree) and the
  source weights, `np.array_equal`; both packages refuse the same broken
  checkpoints.
* `safetensors_io` against the `safetensors` package: BF16 / F16 / F32 / I8
  (and I32, I64, U8, BOOL) read bit for bit, `__metadata__` skipped, and the
  writer's files read back by the package bit for bit. JAX's reader opens
  files with `framework="np"` and cannot read BF16, so BF16 loads are held
  against the package and the source tensors only.
* `load_magvit2` on a `tiny_vqgan(16)` fused file against JAX's.
* `Config` / `parse_overrides` / `load_config` against JAX's on the repo's
  configs (`_base_`, `${...}`, a topology fragment) and a table of override
  spellings; the strict flag parsers; `task_serving_defaults` for each
  family, with and without `fast_stack`.
* The serve loader's builders: the tokenizer fallback, the quantize branch,
  MAGVIT-v2 from a directory.
"""

import dataclasses
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from safetensors.torch import load_file as st_load_file
from safetensors.torch import save_file as st_save_file

from mmada_tpu.checkpoints import hf_import as jax_hf
from mmada_tpu.checkpoints import magvit_import as jax_magvit_import
from mmada_tpu.checkpoints.manager import export_hf_config as jax_export_hf_config
from mmada_tpu.core import config as jax_config
from mmada_tpu.core.vocab import MMADA_8B as JAX_MMADA_8B
from mmada_tpu.models import magvit2 as jax_magvit2
from mmada_tpu.serve import loader as jax_loader
from mmada_tpu_torch.checkpoints import hf_import, magvit_import, safetensors_io
from mmada_tpu_torch.checkpoints.from_jax import magvit2_from_jax, params_from_jax
from mmada_tpu_torch.core import config
from mmada_tpu_torch.core.precision import FP32
from mmada_tpu_torch.core.vocab import MMADA_8B
from mmada_tpu_torch.entry import quantize
from mmada_tpu_torch.models import llada, magvit2
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.prompting.universal import ByteTokenizer
from mmada_tpu_torch.serve import loader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the config.json of Gen-Verse/MMaDA-8B-Base (LLaDA field names, the fused vocab)
GEN_VERSE = {
    "architectures": ["MMadaModelLM"], "model_type": "mmada", "activation_type": "silu",
    "alibi": False, "alibi_bias_max": 8.0, "attention_dropout": 0.0,
    "attention_layer_norm": False, "attention_layer_norm_with_affine": True,
    "bias_for_layer_norm": False, "block_group_size": 1, "block_type": "llama",
    "codebook_size": 8192, "d_model": 4096, "embedding_dropout": 0.0, "embedding_size": 126464,
    "eos_token_id": 126081, "flash_attention": False, "include_bias": False,
    "include_qkv_bias": False, "init_cutoff_factor": None, "init_device": "meta",
    "init_fn": "mitchell", "init_std": 0.02, "input_emb_norm": False,
    "layer_norm_type": "rms", "layer_norm_with_affine": True, "llm_vocab_size": 126464,
    "mask_token_id": 126336, "max_sequence_length": 4096, "mlp_hidden_size": 12288,
    "mlp_ratio": 4, "multi_query_attention": None, "n_heads": 32, "n_kv_heads": 32,
    "n_layers": 32, "new_vocab_size": 134656, "num_new_special_tokens": 0,
    "num_vq_tokens": 256, "pad_token_id": 126081, "precision": "amp_bf16",
    "residual_dropout": 0.0, "rms_norm_eps": 1e-05, "rope": True,
    "rope_full_precision": True, "rope_theta": 500000.0, "scale_logits": False,
    "vocab_size": 126464, "weight_tying": False,
}


def _asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_config_from_hf_json_matches_jax(tmp_path):
    port = hf_import.config_from_hf_json(GEN_VERSE)
    assert _asdict(port) == _asdict(jax_hf.config_from_hf_json(GEN_VERSE))
    assert port == dataclasses.replace(llada.llada_8b(), n_kv_heads=32)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(GEN_VERSE, f)
    assert hf_import.config_from_hf_json(str(tmp_path)) == port


def test_hf_config_matches_jax_export_and_round_trips(tmp_path):
    cfg = dataclasses.replace(llada.tiny_config(vocab_size=MMADA_8B.total_vocab_size),
                              n_kv_heads=2, attention_layer_norm=True)
    jax_cfg = jax_hf.config_from_hf_json(hf_import.hf_config(cfg))
    jax_export_hf_config(str(tmp_path), jax_cfg, JAX_MMADA_8B)
    with open(tmp_path / "config.json") as f:
        assert hf_import.hf_config(cfg, MMADA_8B) == json.load(f)
    assert hf_import.config_from_hf_json(hf_import.hf_config(cfg, MMADA_8B)) == cfg


# ------------------------------------------------------------ LLaDA weights
def _model(kind: str):
    """(cfg, fp32 params on the CPU) of a small model of each layout."""
    kw = dict(vocab_size=384, d_model=64, n_heads=4, n_layers=3, mlp_hidden_size=96)
    cfg = {
        "untied": llada.tiny_config(**kw),
        "tied": llada.tiny_config(weight_tying=True, **kw),
        "gqa_qk_norm": llada.tiny_config(n_kv_heads=2, attention_layer_norm=True, **kw),
        "sequential_bias": dataclasses.replace(
            llada.tiny_config(block_type="sequential", activation_type="swiglu", **kw),
            include_bias=True),
    }[kind]
    params = llada.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    if "att_proj_bias" in params["blocks"]:  # make the biases tell layers apart
        params["blocks"]["att_proj_bias"].normal_(generator=torch.Generator().manual_seed(4))
    return cfg, params


def _flat(params) -> dict:
    out = {k: v for k, v in params.items() if k != "blocks"}
    out.update({f"blocks.{k}": v for k, v in params["blocks"].items()})
    return out


def _grouped(state: dict, size: int) -> dict:
    """`blocks.{i}` keys as `block_groups.{i // size}.{i % size}`."""
    out = {}
    for key, v in state.items():
        m = hf_import._BLOCK_RE.match(key)
        if m and m.group(1) is not None:
            i = int(m.group(1))
            key = key.replace(f"blocks.{i}.", f"block_groups.{i // size}.{i % size}.")
        out[key] = v
    return out


def _write(tmp_path, state: dict, fmt: str) -> str:
    d = str(tmp_path / fmt)
    os.makedirs(d)
    contiguous = {k: v.contiguous() for k, v in state.items()}
    if fmt == "single":
        st_save_file(contiguous, os.path.join(d, "model.safetensors"), metadata={"format": "pt"})
    elif fmt == "sharded":
        paths = safetensors_io.save_sharded(state, d, max_shard_bytes=200_000)
        assert len(paths) > 2
    else:
        torch.save(contiguous, os.path.join(d, "pytorch_model.bin"))
    return d


def _load_both(d, cfg, block_group_size=1):
    jax_cfg = jax_hf.config_from_hf_json(hf_import.hf_config(cfg))
    jparams = jax_hf.load_pretrained(d, jax_cfg, dtype=jnp.float32,
                                     block_group_size=block_group_size)
    want = params_from_jax(jax.device_get(jparams), cfg, device="cpu")
    got = hf_import.load_pretrained(d, cfg, device="cpu", dtype=torch.float32,
                                    block_group_size=block_group_size)
    return got, want


@pytest.mark.parametrize("kind,fmt,groups", [
    ("untied", "single", 1), ("untied", "sharded", 1), ("untied", "bin", 1),
    ("tied", "single", 1), ("gqa_qk_norm", "sharded", 1), ("sequential_bias", "single", 1),
    ("untied", "single", 3), ("gqa_qk_norm", "sharded", 3),
])
def test_load_pretrained_matches_jax(tmp_path, kind, fmt, groups):
    cfg, params = _model(kind)
    state = hf_import.state_dict_views(params)
    if groups > 1:
        state = _grouped(state, groups)
        assert any("block_groups.0.2." in k for k in state)
    got, want = _load_both(_write(tmp_path, state, fmt), cfg, groups)
    got, want, src = _flat(got), _flat(want), _flat(params)
    assert sorted(got) == sorted(want) == sorted(src)
    for k in got:
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
        assert np.array_equal(got[k].numpy(), want[k].numpy()), k
        assert np.array_equal(got[k].numpy(), src[k].numpy()), k


def test_model_from_pretrained_on_the_cpu(tmp_path):
    cfg, params = _model("untied")
    hf_import.export_pretrained(str(tmp_path), params, cfg)
    model = MMadaModel.from_pretrained(str(tmp_path), MMADA_8B, device="cpu",
                                       dtype=torch.float32, policy=FP32)
    assert model.cfg == cfg and model.policy == FP32 and model.vocab == MMADA_8B
    ids = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(model.forward(ids), llada.forward(params, cfg, ids),
                               rtol=0, atol=0)


def test_from_pretrained_checks_the_policy_before_reading(tmp_path):
    """The card takes an fp32 policy (its fp32 attention kernels, A.17): the
    policy passes, and what fails is reading the missing checkpoint."""
    with pytest.raises(FileNotFoundError, match="config.json"):
        MMadaModel.from_pretrained(str(tmp_path / "missing"), MMADA_8B, device="cuda",
                                   policy=FP32)


def test_bf16_checkpoint_loads_bit_for_bit(tmp_path):
    cfg, params = _model("gqa_qk_norm")
    bf16 = {k: v.to(torch.bfloat16) for k, v in params.items() if k != "blocks"}
    bf16["blocks"] = {k: v.to(torch.bfloat16) for k, v in params["blocks"].items()}
    paths = hf_import.export_pretrained(str(tmp_path), bf16, cfg, max_shard_bytes=100_000)
    lib = {}
    for p in paths:
        lib.update(st_load_file(p))
    views = hf_import.state_dict_views(bf16)
    assert sorted(lib) == sorted(views)
    for k, v in views.items():
        assert lib[k].dtype == torch.bfloat16 and torch.equal(lib[k], v), k
    for dtype in (torch.bfloat16, torch.float32):
        got = _flat(hf_import.load_pretrained(str(tmp_path), cfg, device="cpu", dtype=dtype))
        for k, v in _flat(bf16).items():
            assert got[k].dtype == dtype and torch.equal(got[k], v.to(dtype)), k


@pytest.mark.parametrize("fault", ["missing layer", "missing head", "groups too small",
                                   "groups too large"])
def test_broken_checkpoints_are_refused_as_jax_refuses_them(tmp_path, fault):
    cfg, params = _model("untied")
    state = hf_import.state_dict_views(params)
    groups = 1
    if fault == "missing layer":
        state = {k: v for k, v in state.items() if ".blocks.1.q_proj" not in k}
    elif fault == "missing head":
        del state["model.transformer.ff_out.weight"]
    else:  # 3 layers in groups of 2, read as groups of 1 or 3
        state = _grouped(state, 2)
        groups = 1 if fault == "groups too small" else 3
    d = _write(tmp_path, state, "single")
    jax_cfg = jax_hf.config_from_hf_json(hf_import.hf_config(cfg))
    with pytest.raises((ValueError, IndexError)):
        jax_hf.load_pretrained(d, jax_cfg, dtype=jnp.float32, block_group_size=groups)
    with pytest.raises(ValueError):
        hf_import.load_pretrained(d, cfg, device="cpu", block_group_size=groups)


# -------------------------------------------------------- the file format
def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "bf16": torch.randn(5, 7, generator=g).to(torch.bfloat16),
        "f16": torch.randn(3, 4, generator=g).half(),
        "f32": torch.randn(6, generator=g),
        "i8": torch.randint(-128, 127, (3,), generator=g, dtype=torch.int8),
        "i32": torch.randint(-10**6, 10**6, (2, 2), generator=g, dtype=torch.int32),
        "i64": torch.randint(-10**12, 10**12, (3,), generator=g, dtype=torch.int64),
        "u8": torch.randint(0, 255, (5,), generator=g, dtype=torch.uint8),
        "bool": torch.rand(4, generator=g) > 0.5,
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 3),
    }


def test_reader_matches_the_safetensors_package(tmp_path):
    tensors = _tensors()
    path = str(tmp_path / "x.safetensors")
    st_save_file(tensors, path, metadata={"format": "pt", "note": "metadata is skipped"})
    lib = st_load_file(path)
    got = dict(safetensors_io.iter_safetensors(path))
    assert sorted(got) == sorted(lib) == sorted(tensors)
    for k, v in lib.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and torch.equal(got[k], v), k


def test_writer_round_trips_through_the_safetensors_package(tmp_path):
    tensors = _tensors()
    tensors = {"i8": tensors.pop("i8"), **tensors}
    tensors["transposed"] = torch.arange(12.0).reshape(3, 4).T  # a view: written as its values
    path = str(tmp_path / "x.safetensors")
    n = safetensors_io.save_file(tensors, path, metadata={"format": "pt"})
    assert n == os.path.getsize(path)
    with open(path, "rb") as f:
        assert int.from_bytes(f.read(8), "little") % 8 == 0
    # I8 (3 bytes) first: every later tensor starts at an odd offset
    header, _ = safetensors_io.read_header(path)
    assert header["bf16"]["data_offsets"][0] % 2 == 1
    lib = st_load_file(path)
    for k, v in tensors.items():
        assert lib[k].dtype == v.dtype and torch.equal(lib[k], v), k
        assert torch.equal(dict(safetensors_io.iter_safetensors(path))[k], v), k


def test_sharded_directory_is_read_in_index_order(tmp_path):
    tensors = _tensors()
    paths = safetensors_io.save_sharded(tensors, str(tmp_path), max_shard_bytes=64)
    with open(tmp_path / safetensors_io.INDEX_NAME) as f:
        index = json.load(f)
    assert sorted(index["weight_map"]) == sorted(tensors)
    assert index["metadata"]["total_size"] == sum(t.numel() * t.element_size()
                                                  for t in tensors.values())
    assert safetensors_io.checkpoint_files(str(tmp_path)) == sorted(paths)
    keys = [k for k, _ in safetensors_io.iter_safetensors(str(tmp_path))]
    assert keys == list(tensors)  # shard by shard, each in its bytes' order
    (tmp_path / "stray.safetensors").write_bytes(b"")  # not in the index: not read
    assert len(list(safetensors_io.iter_safetensors(str(tmp_path)))) == len(tensors)


def test_reader_refuses_truncated_and_unknown_files(tmp_path):
    path = str(tmp_path / "x.safetensors")
    safetensors_io.save_file({"a": torch.arange(8.0)}, path)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 4)
    with pytest.raises(ValueError, match="ends inside"):
        list(safetensors_io.iter_file(path))
    header = json.dumps({"a": {"dtype": "F64", "shape": [1], "data_offsets": [0, 8]}}).encode()
    with open(path, "wb") as f:
        f.write(len(header).to_bytes(8, "little") + header + bytes(8))
    with pytest.raises(ValueError, match="F64"):
        list(safetensors_io.iter_file(path))


# -------------------------------------------------------------- MAGVIT-v2
def _tree_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and np.array_equal(a.float().numpy(), b.float().numpy())
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_tree_equal(a[k], b[k]) for k in a)
    return len(a) == len(b) and all(_tree_equal(x, y) for x, y in zip(a, b))


def test_load_magvit2_matches_jax(tmp_path):
    jcfg = jax_magvit2.tiny_vqgan(16)
    cfg = magvit2.tiny_vqgan(16)
    src = magvit2_from_jax(jax.device_get(jax_magvit2.init_magvit2(jax.random.key(5), jcfg)),
                           cfg, device="cpu")
    state = magvit_import.magvit2_state_dict(src)
    assert all(k.startswith(("encoder.", "decoder.")) for k in state)
    st_save_file({k: v.contiguous() for k, v in state.items()},
                 str(tmp_path / "model.safetensors"))
    jgot = jax_magvit_import.load_magvit2(str(tmp_path), jcfg, dtype=jnp.float32)
    want = magvit2_from_jax(jax.device_get(jgot), cfg, device="cpu")
    got = magvit_import.load_magvit2(str(tmp_path), cfg, device="cpu", dtype=torch.float32)
    assert _tree_equal(got, want) and _tree_equal(got, src)
    bf16 = magvit_import.load_magvit2(str(tmp_path), cfg, device="cpu")
    assert _tree_equal(bf16, magvit_import.magvit2_params_from_fused_state(
        {k: v.to(torch.bfloat16) for k, v in state.items()}, cfg, torch.bfloat16, "cpu"))


# ---------------------------------------------------------------- configs
CONFIGS = ["configs/tiny_test.yaml", "configs/mmada_demo.yaml",
           "configs/serving_families.yaml", "configs/mmada_pretraining_stage1.yaml"]
OVERRIDES = ["serving.text.kv_cache=int8", "optimizer.params.learning_rate=5e-5",
             "training.seed=7", "model.mmada.pretrained_model_path=/ckpt/MMaDA-8B-Base",
             "prompt=What is the capital of France?", "cfg_interval=0.2,0.8", "new.key=[1, 2]",
             "device=cpu", "flag"]


@pytest.mark.parametrize("path", CONFIGS)
@pytest.mark.parametrize("topology", [None, "configs/topologies/single_chip.yaml"])
def test_load_config_matches_jax(path, topology, monkeypatch):
    argv = [f"config={path}", *OVERRIDES] + ([f"topology={topology}"] if topology else [])
    monkeypatch.chdir(REPO)
    want = jax_config.load_config(cli_args=argv)
    got = config.load_config(cli_args=argv, reader=yaml.safe_load)
    assert got.to_dict() == want.to_dict()
    assert list(got.flatten()) == list(want.flatten())
    assert got.get_path("lr_scheduler.params.learning_rate") == got.get_path(
        "optimizer.params.learning_rate") == 5e-5


def test_load_config_needs_a_reader_only_for_files():
    cfg = config.load_config(cli_args=["a.b=1", "a.c=${a.b}", "s=x${a.b}y"])
    assert cfg.to_dict() == {"a": {"b": 1, "c": 1}, "s": "x1y"}
    with pytest.raises(ValueError, match="reader"):
        config.load_config(cli_args=["config=configs/tiny_test.yaml"])


def test_config_methods_match_jax():
    data = {"a": {"b": 1, "c": [1, {"d": "${a.b}"}]}, "e": "v${a.b}"}
    got, want = config.Config(data), jax_config.Config(data)
    for cfg in (got, want):
        cfg.set_path("x.y.z", 3)
        cfg.merge({"a": {"f": 2}, "e": "w${x.y.z}"})
        cfg.resolve()
    assert got.to_dict() == want.to_dict() and got.copy().to_dict() == want.to_dict()
    assert got.get_path("a.f") == 2 and got.get_path("a.nope", "dflt") == "dflt"
    assert got.x.y.z == 3 and list(got.flatten()) == list(want.flatten())
    with pytest.raises(KeyError):
        config.Config({"a": "${b.c}"}).resolve()


SPELLINGS = [
    "1", "-3", "+4", "010", "0x1F", "0b101", "1_000", "1:30", "1.5", "-2.25", "5e-5", "1e4",
    "1E+3", "1.0e-4", ".5", "-.5", "1.", "1:30.5", ".inf", "-.inf", "true", "True", "TRUE",
    "tRue", "yes", "no", "on", "off", "y", "null", "Null", "~", "", "None", "abc",
    "a photo of a cat", " spaced ", "'quoted'", '"double"', "'it''s'", '"a\\tb"', "[a, b]",
    "[0.2, 0.8]", "[]", "[1, [2, 3]]", "['x, y', 2]", "[5e-5]", "[true, null, ~]", "[a,b,]",
    "What is the capital of France?", "0.2,0.8", "0.2:0.8", "int8", "a #comment", "#x",
    "configs/tiny_test.yaml", "x=y", "http://host/p", "[a, b", '"unterminated', "*x", "-x",
]


@pytest.mark.parametrize("text", SPELLINGS)
def test_override_spellings_parse_as_jax_parses_them(text):
    got = config.parse_overrides([f"k={text}"])["k"]
    want = jax_config.parse_overrides([f"k={text}"])["k"]
    assert type(got) is type(want)
    assert got == want or (isinstance(got, float) and math.isnan(got) and math.isnan(want))


@pytest.mark.parametrize("text", ["a: b", "{a: 1}", "- x", "[a: b]"])
def test_override_values_that_yaml_reads_as_mappings_raise(text):
    with pytest.raises(ValueError, match="quote"):
        config.parse_overrides([f"k={text}"])
    with pytest.raises(ValueError, match="key=value"):
        config.parse_overrides(["no_equals_sign"])


@pytest.mark.parametrize("name", ["parse_kv_cache", "parse_bool", "parse_cfg_interval",
                                  "parse_remat"])
def test_flag_parsers_match_jax(name):
    values = [True, False, 0, 1, None, "int8", "true", " Yes ", "off", "", "0", "full", "dots",
              "auto", "0.2,0.8", "0.2:0.8", (0.1, 0.5), [0.0, 1.0], "none", "0.8,0.2", "bogus",
              "1,2,3"]
    got_fn, want_fn = getattr(config, name), getattr(jax_config, name)
    for v in values:
        try:
            want = want_fn(v)
        except (ValueError, TypeError) as e:
            with pytest.raises(type(e)):
                got_fn(v)
            continue
        assert got_fn(v) == want, (name, v)


def test_parse_structured_ignores_unknown_keys():
    got = config.parse_structured(magvit2.VQGANConfig, {"ch": 32, "z_channels": 5, "nope": 1})
    assert got == dataclasses.replace(magvit2.VQGANConfig(), ch=32, z_channels=5)


@pytest.mark.parametrize("task", ["text", "mmu", "t2i", "t2m"])
@pytest.mark.parametrize("extra", [[], ["serving.fast_stack=true"],
                                   ["serving.fast_stack=true", "serving.text.kv_cache=false",
                                    "serving.mmu.parallel_warmup_steps=5"],
                                   ["serving.kv_cache=int8", "serving.t2i.fast_stack=yes",
                                    "serving.t2i.cfg_interval=0.2,0.8"],
                                   ["config=configs/serving_families.yaml"]])
def test_task_serving_defaults_match_jax(task, extra, monkeypatch):
    monkeypatch.chdir(REPO)
    want = jax_loader.task_serving_defaults(jax_config.load_config(cli_args=extra), task)
    got = loader.task_serving_defaults(config.load_config(cli_args=extra, reader=yaml.safe_load),
                                       task)
    assert got == want
    assert loader.FAST_STACK_PRESET == jax_loader.FAST_STACK_PRESET


# ------------------------------------------------------------ the builders
def test_tokenizer_falls_back_to_bytes_without_tokenizer_files_or_transformers(tmp_path,
                                                                               monkeypatch):
    cfg_args = [f"model.mmada.pretrained_model_path={tmp_path}"]
    (tmp_path / "config.json").write_text(json.dumps(GEN_VERSE))
    got = loader.build_text_tokenizer(config.load_config(cli_args=cfg_args))
    want = jax_loader.build_text_tokenizer(jax_config.load_config(cli_args=cfg_args))
    assert type(got) is ByteTokenizer and type(want).__name__ == "ByteTokenizer"
    monkeypatch.setitem(sys.modules, "transformers", None)
    assert type(loader.build_text_tokenizer(config.load_config(cli_args=cfg_args))) \
        is ByteTokenizer


def test_prompting_and_vocab_match_jax():
    for argv in (["model.mmada.tiny=true"], ["model.mmada.num_new_special_tokens=3"], []):
        got_cfg, want_cfg = config.load_config(cli_args=argv), jax_config.load_config(
            cli_args=argv)
        vocab, jvocab = loader.build_vocab(got_cfg), jax_loader.build_vocab(want_cfg)
        assert dataclasses.asdict(vocab) == dataclasses.asdict(jvocab)
        sp = loader.build_prompting(got_cfg, ByteTokenizer(), vocab).sp
        jsp = jax_loader.build_prompting(want_cfg, ByteTokenizer(), jvocab).sp
        assert dataclasses.asdict(sp) == dataclasses.asdict(jsp)


def test_build_model_loads_and_quantizes_a_checkpoint(tmp_path):
    cfg, params = _model("untied")
    cfg = dataclasses.replace(cfg, vocab_size=MMADA_8B.total_vocab_size,
                              embedding_size=MMADA_8B.total_vocab_size)
    params = llada.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    hf_import.export_pretrained(str(tmp_path), params, cfg, MMADA_8B)
    argv = [f"model.mmada.pretrained_model_path={tmp_path}", "training.mixed_precision=fp32"]
    model = loader.build_model(config.load_config(cli_args=argv), MMADA_8B, "cpu")
    assert model.cfg == cfg and model.policy == FP32
    assert _tree_equal(model.params, params)
    q = loader.build_model(config.load_config(cli_args=argv + ["model.mmada.quantize=int8"]),
                           MMADA_8B, "cpu")
    want = quantize(model, "int8")
    ids = torch.randint(0, 300, (1, 8), generator=torch.Generator().manual_seed(1))
    assert torch.equal(q.forward(ids), want.forward(ids))


def test_build_vq_model_from_a_directory_tiny_or_random(tmp_path, caplog, monkeypatch):
    vq, vq_cfg = loader.build_vq_model(config.load_config(cli_args=["model.vq_model.tiny=true"]),
                                       "cpu")
    assert vq_cfg == magvit2.tiny_vqgan() and vq["encoder"]["conv_in"]["w"].dtype == torch.float32
    small = magvit2.tiny_vqgan(32)  # the flagship's place, at a test's size
    monkeypatch.setattr(magvit2, "magvit2_default", lambda: small)
    src = magvit2.init_magvit2(small, device="cpu", generator=torch.Generator().manual_seed(2))
    bf16 = magvit_import.magvit2_state_dict(src)
    bf16 = {k: v.to(torch.bfloat16) for k, v in bf16.items()}
    safetensors_io.save_file(bf16, str(tmp_path / "model.safetensors"))
    got, vq_cfg = loader.build_vq_model(
        config.load_config(cli_args=[f"model.vq_model.vq_model_name={tmp_path}"]), "cpu")
    # loaded in fp32 (the port's MAGVIT-v2 computes in fp32): bf16 widened exactly
    assert vq_cfg == small and _tree_equal(got, magvit_import.magvit2_params_from_fused_state(
        bf16, small, torch.float32, "cpu"))
    with caplog.at_level("WARNING"):
        missing = config.load_config(cli_args=[f"model.vq_model.vq_model_path={tmp_path}/no"])
        _, vq_cfg = loader.build_vq_model(missing, "cpu")
    assert vq_cfg == small and "random init" in caplog.text
