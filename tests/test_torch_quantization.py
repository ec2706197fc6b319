"""The port's quantization (int8, W8A8, SmoothQuant, int4 and the W8A8
straight-through training forward) against the JAX package, on the CPU.

* Bit for bit: the int4 packing (packed bytes, scales, dequantised values;
  stacked, per-channel small K), int8 codes and scales, per-token activation
  codes and scales, `w8a8_matmul` (exact int32 sums, then the same fp32
  rescale), and the fp32 `qmatmul`. The bf16 `qmatmul` multiplies a
  bit-identical bf16 weight; its product is held within one bf16 ulp, since
  the two libraries' bf16 matmuls sum in different orders.
* `int4_matmul_reference` (the plain version of kernel B6) against JAX's
  Pallas `int4_matmul(..., interpret=True)`: within one bf16 ulp per element.
* Dispatch: the routing by layout, `multi_matmul`'s shared quantize pass,
  `quantize_llada_params`' structure.
* `llada.forward` on int8, W8A8 and int4 params (fp32, within 2e-4; int4
  through JAX's Pallas kernel in interpret mode), windowed heads; the
  samplers token-exact at T = 0 on int4 and W8A8 weights, but for the W8A8
  t2i sampler, which is held to JAX step by step, teacher forced.
* The STE matmul: forward and gradients (its train step is in
  `test_torch_training.py`; SmoothQuant and `entry.quantize` in
  `test_torch_smoothquant.py`).

The same weights go into both packages through `params_from_jax`.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_tpu.core.vocab import tiny_layout as jax_tiny_layout
from mmada_tpu.models import llada as jax_llada
from mmada_tpu.models.mmada import MMadaModel as JaxMMadaModel
from mmada_tpu.ops import int4_matmul as JI
from mmada_tpu.ops import quantization as JQ
from mmada_tpu_torch import entry
from mmada_tpu_torch.checkpoints.from_jax import params_from_jax
from mmada_tpu_torch.core.vocab import tiny_layout
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.ops import int4_matmul as I
from mmada_tpu_torch.ops import quantization as Q
from mmada_tpu_torch.prompting.universal import SpecialIds



def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 else x.detach().numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _bf16(a: np.ndarray):
    """The same bf16 values in both packages."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).bfloat16()


def assert_within_one_bf16_ulp(got, want):
    """Each entry within one bf16 ulp (at the larger magnitude of the two)."""
    got, want = _np(got).astype(np.float32), _np(want).astype(np.float32)
    _, exp = np.frexp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= np.ldexp(1.0, exp - 8))


def _jax_quantize(params, **kw):
    """JAX's `quantize_llada_params` compiled once (op by op it compiles
    every primitive of the int4 packing: seconds a call), for tests that
    carry JAX's codes across. XLA's compile turns `absmax / 127` into a
    multiply by the reciprocal, so its scales can differ by an ulp from the
    op-by-op run, which is what the loader runs and what the port's
    quantizer is held to."""
    return jax.jit(functools.partial(JQ.quantize_llada_params, **kw))(params)


def _weights(shape, seed=0, std=0.05):
    return (np.random.default_rng(seed).standard_normal(shape) * std).astype(np.float32)


# ---------------------------------------------------------------- bit for bit

@pytest.mark.parametrize("shape", [(512, 384), (3, 256, 128), (64, 128)])
def test_pack_unpack_int4_equals_jax(shape):
    """Packed bytes, scales (groups of 128, or per-channel when K < 128) and
    the dequantised values in fp32 and bf16, bit for bit."""
    w = _weights(shape, 1)
    jp, js = JI.pack_int4(jnp.asarray(w))
    p, s = I.pack_int4(torch.from_numpy(w))
    assert p.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for jdt, dt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(_np(I.unpack_int4(p, s, dt)),
                                      _np(JI.unpack_int4(jp, js, jdt)))
    assert Q.quantize_tensor_int4(torch.from_numpy(w)).shape == shape


def test_pack_int4_odd_k_raises():
    with pytest.raises(ValueError, match="even"):
        I.pack_int4(torch.zeros(63, 128))
    with pytest.raises(ValueError, match="even"):
        JI.pack_int4(jnp.zeros((63, 128)))


@pytest.mark.parametrize("shape", [(64, 96), (3, 40, 24)])
def test_int8_codes_and_activation_codes_equal_jax(shape):
    w = _weights(shape, 2)
    jq, q = JQ.quantize_tensor(jnp.asarray(w)), Q.quantize_tensor(torch.from_numpy(w))
    assert q.values.dtype == torch.int8
    np.testing.assert_array_equal(q.values.numpy(), np.asarray(jq.values))
    np.testing.assert_array_equal(q.scales.numpy(), np.asarray(jq.scales))
    x = np.random.default_rng(3).standard_normal((2, 7, shape[-2])).astype(np.float32) * 3
    jx_q, jx_s = JQ.quantize_activations(jnp.asarray(x))
    x_q, x_s = Q.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(x_q.numpy(), np.asarray(jx_q))
    np.testing.assert_array_equal(x_s.numpy(), np.asarray(jx_s))
    assert Q.quantization_error(torch.from_numpy(w)) == pytest.approx(
        JQ.quantization_error(jnp.asarray(w)), rel=1e-5)
    assert Q.is_quantized(q) and Q.is_quantized(Q.W8A8TrainTensor(values=torch.zeros(2, 2)))
    assert not Q.is_quantized(torch.from_numpy(w))


def test_qmatmul_and_w8a8_matmul_equal_jax():
    """fp32 qmatmul and w8a8_matmul (fp32 and bf16 x) bit for bit; bf16
    qmatmul: the same bf16 weight, the product within one bf16 ulp."""
    w = _weights((512, 384), 4)
    x = np.random.default_rng(5).standard_normal((2, 5, 512)).astype(np.float32)
    jq, q = JQ.quantize_tensor(jnp.asarray(w)), Q.quantize_tensor(torch.from_numpy(w))
    np.testing.assert_array_equal(_np(Q.qmatmul(torch.from_numpy(x), q)),
                                  _np(JQ.qmatmul(jnp.asarray(x), jq)))
    jxb, xb = _bf16(x)
    assert_within_one_bf16_ulp(Q.qmatmul(xb, q), JQ.qmatmul(jxb, jq))
    np.testing.assert_array_equal(
        _np(q.values.to(torch.bfloat16) * q.scales[None].to(torch.bfloat16)),
        _np(jq.values.astype(jnp.bfloat16) * jq.scales[None].astype(jnp.bfloat16)))
    jw8, w8 = JQ._to_w8a8(jq), Q.W8A8Tensor(values=q.values, scales=q.scales)
    for jx_, x_ in ((jnp.asarray(x), torch.from_numpy(x)), (jxb, xb)):
        got = Q.w8a8_matmul(x_, w8)
        assert got.dtype == x_.dtype
        np.testing.assert_array_equal(_np(got), _np(JQ.w8a8_matmul(jx_, jw8)))


@pytest.mark.parametrize("m_shape,k,n,seed", [
    ((2, 5), 512, 384, 10),    # as tests/test_quantization.py's first kernel case
    ((3,), 128, 128, 11),      # K = 128 (one group), ragged M
    ((4,), 2048, 256, 12),     # K = 2048 (JAX's k grid in two tiles)
])
def test_int4_reference_matches_the_pallas_kernel(m_shape, k, n, seed):
    w = _weights((k, n), seed)
    x = np.random.default_rng(seed + 100).standard_normal((*m_shape, k)).astype(np.float32)
    jp, js = JI.pack_int4(jnp.asarray(w))
    p, s = I.pack_int4(torch.from_numpy(w))
    jx, tx = _bf16(x)
    want = JI.int4_matmul(jx, jp, js, interpret=True)
    got = I.int4_matmul(tx, p, s)   # a CPU tensor: the plain version
    assert got.shape == (*m_shape, n) and got.dtype == torch.bfloat16
    assert_within_one_bf16_ulp(got, want)


# ------------------------------------------------------------------ dispatch

def test_int4_dispatch_routes_by_layout(monkeypatch):
    """The kernel layout (K, N multiples of 128, 128-row groups) goes to
    `int4_matmul`; per-channel small K and an N that is not a 128 multiple
    take x @ the dequantised weight, as JAX's dispatch does; all equal
    JAX's `maybe_matmul`."""
    calls = []
    real = Q.int4_matmul
    monkeypatch.setattr(Q, "int4_matmul", lambda *a: calls.append(a[1].shape) or real(*a))
    x = np.random.default_rng(6).standard_normal((4, 256)).astype(np.float32)
    for shape, kernel in (((256, 128), True), ((64, 128), False), ((256, 96), False)):
        w = _weights(shape, 7)
        jq, q = JQ.quantize_tensor_int4(jnp.asarray(w)), Q.quantize_tensor_int4(torch.from_numpy(w))
        jx, tx = _bf16(x[:, :shape[0]])
        before = len(calls)
        got = Q.maybe_matmul(tx, q)
        assert (len(calls) > before) == kernel, shape
        np.testing.assert_array_equal(_np(got), _np(JQ.maybe_matmul(jx, jq)))


def test_multi_matmul_w8a8_equals_one_by_one():
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 6, 64)).astype(np.float32))
    ws = [Q._quantize_w8a8(torch.from_numpy(_weights((64, n), n))) for n in (64, 32, 32)]
    for got, w in zip(Q.multi_matmul(x, ws), ws):
        assert torch.equal(got, Q.w8a8_matmul(x, w))
    plain = [torch.from_numpy(_weights((64, 16), 9))]
    assert torch.equal(Q.multi_matmul(x, plain)[0], x @ plain[0])


def _structure(tree):
    """{key: (class name, shape)}, an array of either package as "array"."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    cls = type(tree).__name__
    return ("array" if cls in ("Tensor", "ndarray") else cls), tuple(tree.shape)


@pytest.mark.parametrize("kw", [{}, dict(activations=True), dict(bits=4),
                                dict(bits=4, quantize_head=False)])
def test_quantize_llada_params_matches_jax_structure(tiny, kw):
    """The same classes and shapes leaf for leaf as JAX's (the int4 shapes
    are the logical (..., K, N)), and the codes carried over equal the
    port's own."""
    jmodel, cfg = tiny
    jparams = jmodel.params
    params = params_from_jax(jax.device_get(jparams), cfg, device="cpu")
    jq = jax.device_get(JQ.quantize_llada_params(jparams, **kw))
    q = Q.quantize_llada_params(params, **kw)
    assert _structure(q) == _structure(jq)
    carried = params_from_jax(jq, cfg, device="cpu")
    for name in Q.QUANT_TARGETS:
        if name in q["blocks"]:
            a, b = q["blocks"][name], carried["blocks"][name]
            for f in dataclasses.fields(a):
                assert torch.equal(getattr(a, f.name), getattr(b, f.name)), name
    assert q["wte"] is params["wte"] and q["blocks"]["attn_norm"] is params["blocks"]["attn_norm"]


def test_quantize_llada_params_refuses_what_jax_refuses():
    params = llada.init_params(llada.tiny_config(), device="cpu")
    with pytest.raises(ValueError, match="activation"):
        Q.quantize_llada_params(params, bits=4, activations=True)
    with pytest.raises(ValueError, match="bits"):
        Q.quantize_llada_params(params, bits=3)


def test_params_from_jax_keeps_int8_and_fp32():
    jcfg = jax_llada.tiny_config(d_model=128, mlp_hidden_size=256)
    jparams = jax_llada.init_params(jax.random.key(1), jcfg)
    cfg = llada.LLaDAConfig(**dataclasses.asdict(jcfg))
    for kw, cls, fields in ((dict(), Q.QuantizedTensor, ("values", "scales")),
                            (dict(activations=True), Q.W8A8Tensor, ("values", "scales")),
                            (dict(bits=4), Q.Int4Tensor, ("packed", "scales"))):
        jq = jax.device_get(_jax_quantize(jparams, **kw))
        p = params_from_jax(jq, cfg, device="cpu", dtype=torch.bfloat16)
        for tree, jtree in ((p["blocks"]["ff_out"], jq["blocks"]["ff_out"]),
                            (p["ff_out"], jq["ff_out"])):
            assert type(tree) is cls
            assert tree.scales.dtype == torch.float32
            assert getattr(tree, fields[0]).dtype == torch.int8
            for f in fields:
                np.testing.assert_array_equal(getattr(tree, f).numpy(), getattr(jtree, f))
        assert p["wte"].dtype == torch.bfloat16


# --------------------------------------------------------------- the forward

@pytest.fixture(scope="module")
def tiny():
    """A 2-layer fp32 model (d_model 128, MLP 256, GQA 4/2) whose vocab (384)
    is a 128 multiple, so that an int4 head takes the kernel layout too, in
    both packages."""
    jvocab = jax_tiny_layout()
    jcfg = dataclasses.replace(
        jax_llada.tiny_config(vocab_size=384, d_model=128, mlp_hidden_size=256, n_kv_heads=2),
        mask_token_id=jvocab.mask_token_id)
    jmodel = JaxMMadaModel(cfg=jcfg, params=jax_llada.init_params(jax.random.key(0), jcfg),
                           vocab=jvocab)
    cfg = llada.LLaDAConfig(**dataclasses.asdict(jcfg))
    return jmodel, cfg


_SCHEMES = {"int8": {}, "w8a8": dict(activations=True), "int4": dict(bits=4)}


def _quantized_pair(tiny, scheme):
    jmodel, cfg = tiny
    # W8A8's forward is checked code for code against JAX's op-by-op run, on
    # the codes of the loader's (op-by-op) quantize
    quant = JQ.quantize_llada_params if scheme == "w8a8" else _jax_quantize
    jq = quant(jmodel.params, **_SCHEMES[scheme])
    model = MMadaModel(cfg=cfg, params=params_from_jax(jax.device_get(jq), cfg, device="cpu"),
                       vocab=tiny_layout())
    return dataclasses.replace(jmodel, params=jq), model


@pytest.mark.parametrize("scheme", list(_SCHEMES))
def test_quantized_forward_matches_jax(tiny, scheme, monkeypatch):
    """Logits within 2e-4 of JAX's; int4 runs JAX's Pallas kernel in
    interpret mode (every matmul has the kernel layout) against the port's
    plain version; a windowed head (the quantized head's columns cut in
    place) equals the slice of the full logits.

    W8A8 rounds each activation to a code per token, so a last-bit
    difference of the fp32 activations at a rounding boundary becomes a
    whole code (1/127 of the token's absmax). XLA's fused compile of the
    layer scan rounds the activations differently in their last bits from
    an op-by-op run, so for W8A8 JAX runs op by op (`jax.disable_jit`), and
    the test also holds the activation codes of every quantized site equal
    in both packages, which is what makes the 2e-4 bar hold."""
    if scheme == "int4":
        monkeypatch.setattr(JQ, "_INTERPRET", True)
    codes = {"jax": [], "port": []}
    if scheme == "w8a8":
        for tag, mod in (("jax", JQ), ("port", Q)):
            real = mod.quantize_activations
            monkeypatch.setattr(mod, "quantize_activations",
                                lambda x, real=real, tag=tag: codes[tag].append(
                                    _np(real(x)[0])) or real(x))
    jmodel, model = _quantized_pair(tiny, scheme)
    ids = np.random.default_rng(20).integers(0, 384, (2, 24))
    window = (128, 256)
    with jax.disable_jit(scheme == "w8a8"):
        want = jax_llada.forward(jmodel.params, jmodel.cfg, jnp.asarray(ids))
    got = llada.forward(model.params, model.cfg, torch.from_numpy(ids))
    assert len(codes["port"]) == len(codes["jax"])
    for a, b in zip(codes["port"], codes["jax"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-4, rtol=0)
    got_win = llada.forward(model.params, model.cfg, torch.from_numpy(ids), logit_window=window)
    assert torch.equal(got_win, got[..., window[0]:window[1]])


def _tiny_special(vocab, cls):
    t = vocab.text_vocab_size
    return cls(soi=t - 20, eoi=t - 19, t2i=t - 18, mmu=t - 17, r2i=t - 16, t2m=t - 15,
               som=t - 14, eom=t - 13, pad=vocab.pad_token_id, bos=vocab.bos_token_id,
               eos=vocab.eos_token_id)


def _jax_prompting(jvocab, max_text_len):
    from mmada_tpu.prompting.universal import ByteTokenizer as JaxByteTokenizer
    from mmada_tpu.prompting.universal import SpecialIds as JaxSpecialIds
    from mmada_tpu.prompting.universal import UniversalPrompting as JaxPrompting

    return JaxPrompting(JaxByteTokenizer(), _tiny_special(jvocab, JaxSpecialIds),
                        max_text_len=max_text_len)


_PROMPTS = ["hello", "world"]
_T2I = dict(temperature=0.0, timesteps=4, guidance_scale=2.0, num_vq_tokens=16)


@pytest.mark.parametrize("scheme", ["int4", "w8a8"])
def test_text_sampler_token_exact_on_quantized_weights(tiny, scheme):
    """serve_text at T = 0 gives JAX's tokens on the same quantized weights
    (JAX's own CPU route for int4: x @ the dequantised weight)."""
    jmodel, model = _quantized_pair(tiny, scheme)
    kw = dict(gen_length=8, steps=4, block_length=8, temperature=0.0)
    answers = entry.serve_text(model, _PROMPTS, device="cpu", **kw)
    for frame, ans in zip(entry.text_frames(model, _PROMPTS), answers):
        want = jmodel.generate(jnp.asarray([frame], jnp.int32), **kw)
        np.testing.assert_array_equal(ans.numpy(), np.asarray(want)[0, len(frame):])


def test_t2i_sampler_token_exact_on_int4_weights(tiny):
    """serve_t2i (greedy, CFG) gives JAX's image codes on the same int4
    weights."""
    jmodel, model = _quantized_pair(tiny, "int4")
    codes = entry.serve_t2i(model, _PROMPTS, special_ids=_tiny_special(model.vocab, SpecialIds),
                            device="cpu", max_text_len=10, greedy=True, **_T2I)
    n, mask_id = _T2I["num_vq_tokens"], jmodel.vocab.mask_token_id
    prompting = _jax_prompting(jmodel.vocab, 10)
    ids, attn = prompting.t2i_gen(_PROMPTS, np.full((2, n), mask_id))
    un_ids, un_attn = prompting.t2i_gen_uncond(2, n, mask_id)
    want = jmodel.t2i_generate(jnp.asarray(ids), uncond_input_ids=jnp.asarray(un_ids),
                               attention_mask=jnp.asarray(attn),
                               uncond_attention_mask=jnp.asarray(un_attn),
                               key=jax.random.key(0), greedy=True, **_T2I)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want))


def _codes_agree_up_to_rounding(port_acts, jax_acts) -> bool:
    """The activation codes of one W8A8 forward in both packages, site by
    site: True if every site's codes are equal. Else, at the first site
    where some differ, every differing code rounds a value within 1e-4 of a
    rounding boundary (a code +- 0.5; past that site the inputs differ by
    that code, so the sites after it are not compared)."""
    assert len(port_acts) == len(jax_acts)
    for x, jx in zip(port_acts, jax_acts):
        got = Q.quantize_activations(torch.from_numpy(x))[0].numpy()
        want = np.asarray(JQ.quantize_activations(jnp.asarray(jx))[0])
        if np.array_equal(got, want):
            continue
        scaled = x / np.maximum(np.abs(x).max(-1, keepdims=True) / 127.0, 1e-12)
        at_boundary = np.abs(np.abs(scaled - np.floor(scaled)) - 0.5) < 1e-4
        assert np.all((got == want) | at_boundary)
        return False
    return True


def test_t2i_sampler_on_w8a8_weights_matches_jax_up_to_code_rounding(tiny, monkeypatch):
    """W8A8 under the greedy t2i sampler, teacher forced. The per-token
    activation codes round fp32 values that the two packages compute with
    different last bits (summation order, the silu), and at these sizes a
    value within a few ulps of a rounding boundary turns up, which sends
    free-running greedy samplers down different paths. So each step is held
    to JAX on the port's own tokens instead:
    * every forward the port's sampler makes (CFG batch, windowed head) is
      rerun by JAX op by op on the same tokens: the activation codes agree
      (`_codes_agree_up_to_rounding`), and where they all agree the logits
      are within 2e-4;
    * JAX's sampler, fed the port's logits at each step, asks for the
      port's tokens at every step and ends on the port's image codes, token
      for token: CFG mixing, the greedy choice and the remasking are
      JAX's."""
    jmodel, model = _quantized_pair(tiny, "w8a8")
    calls = []
    real_forward, real_q, real_jq = llada.forward, Q.quantize_activations, JQ.quantize_activations

    def forward_spy(params, cfg, input_ids, **kw):
        calls.append(dict(ids=input_ids.numpy().copy(), kw=kw, acts=[]))
        out = real_forward(params, cfg, input_ids, **kw)
        calls[-1]["logits"] = out.detach().numpy().copy()
        return out

    def port_spy(x):
        calls[-1]["acts"].append(x.detach().numpy().copy())
        return real_q(x)

    monkeypatch.setattr(llada, "forward", forward_spy)
    monkeypatch.setattr(Q, "quantize_activations", port_spy)
    codes = entry.serve_t2i(model, _PROMPTS, special_ids=_tiny_special(model.vocab, SpecialIds),
                            device="cpu", max_text_len=10, greedy=True, **_T2I)
    monkeypatch.setattr(Q, "quantize_activations", real_q)
    assert codes.shape == (2, _T2I["num_vq_tokens"])
    assert ((codes >= 0) & (codes < model.vocab.image_codebook_size)).all()
    assert len(calls) == _T2I["timesteps"]

    jax_acts = []
    monkeypatch.setattr(JQ, "quantize_activations",
                        lambda x: jax_acts.append(np.asarray(x)) or real_jq(x))
    agreed = 0
    for call in calls:
        jax_acts.clear()
        kw = {k: v for k, v in call["kw"].items() if k in ("logit_window", "logit_positions")}
        with jax.disable_jit():
            want = jax_llada.forward(jmodel.params, jmodel.cfg, jnp.asarray(call["ids"]), **kw)
        assert len(jax_acts) == len(call["acts"]) == 2 * 4 + 1
        if _codes_agree_up_to_rounding(call["acts"], jax_acts):
            np.testing.assert_allclose(call["logits"], _np(want), atol=2e-4, rtol=0)
            agreed += 1
    assert agreed >= 1
    monkeypatch.setattr(JQ, "quantize_activations", real_jq)

    feed = iter(calls)

    def port_logits(tokens, attention_mask):
        call = next(feed)
        np.testing.assert_array_equal(np.asarray(tokens), call["ids"])
        return jnp.asarray(call["logits"])

    monkeypatch.setattr(JaxMMadaModel, "_window_forward_fn", lambda self, n, window: port_logits)
    n, mask_id = _T2I["num_vq_tokens"], jmodel.vocab.mask_token_id
    prompting = _jax_prompting(jmodel.vocab, 10)
    ids, attn = prompting.t2i_gen(_PROMPTS, np.full((2, n), mask_id))
    un_ids, un_attn = prompting.t2i_gen_uncond(2, n, mask_id)
    with jax.disable_jit():
        want = jmodel.t2i_generate(jnp.asarray(ids), uncond_input_ids=jnp.asarray(un_ids),
                                   attention_mask=jnp.asarray(attn),
                                   uncond_attention_mask=jnp.asarray(un_attn),
                                   key=jax.random.key(0), greedy=True, **_T2I)
    assert next(feed, None) is None
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want))


# ---------------------------------------------------------------------- STE

def test_ste_forward_and_gradients_match_jax():
    """The forward equals `w8a8_matmul` bit for bit; the gradients of a loss
    through it are within 1e-5 of `jax.grad` through JAX's STE matmul."""
    x = np.random.default_rng(30).standard_normal((2, 6, 32)).astype(np.float32)
    w = np.random.default_rng(31).standard_normal((32, 48)).astype(np.float32)
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    y = Q.w8a8_ste_matmul(tx, tw)
    assert torch.equal(y.detach(), Q.w8a8_matmul(tx.detach(), Q._quantize_w8a8(tw.detach())))
    gx, gw = torch.autograd.grad((y ** 2).sum(), (tx, tw))
    jgx, jgw = jax.grad(lambda a, b: (JQ.w8a8_ste_matmul(a, b) ** 2).sum(), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(_np(gx), np.asarray(jgx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(gw), np.asarray(jgw), rtol=1e-5, atol=1e-5)
