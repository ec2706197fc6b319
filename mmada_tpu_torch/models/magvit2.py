"""MAGVIT-v2 LFQ image tokenizer (VQGAN encoder / LFQ / decoder).

Counterpart of `mmada_tpu/models/magvit2.py` (the reference
models/modeling_magvitv2.py with the blocks of models/common_modules.py):

  * encoder: conv-in, `len(enc_ch_mult)` levels of ResnetBlocks (+ AttnBlock
    where `_level_plan` places one), stride-2 downsampling padded at the
    bottom and right only, mid block-attn-block, GroupNorm + swish, conv-out
    to `z_channels`, then a 1x1 `quant_conv`;
  * LFQ, lookup-free binary quantization: `sign(z)` in {-1, +1} and the code
    `sum 2^(C-1-i) [z_i > 0]`, channel 0 the most significant bit;
  * decoder: the mirror, with nearest 2x upsampling.

The API is NHWC, as JAX's: pixels `(B, H, W, 3)` in [-1, 1], latents
`(B, h, w, C)`, codes `(B, h*w)` raw (the caller adds the image offset).
Inside, each conv sees its input as an NCHW view of NHWC memory
(channels_last), so no copy is made around it. The convs take any H and W
divisible by 16, whatever `cfg.resolution` says; `cfg.resolution` only
places the attention blocks.

Parameters are nested dicts of tensors, as JAX's pytree: a conv is
`{"w": (O, I, kh, kw), "b": (O,)}` (torch's OIHW: a reference state dict is
kept as it is), a norm `{"w", "b"}`. A conv computes in its input's dtype,
casting its weights to it, so bf16-stored weights (the loaders' default)
compute in fp32 on fp32 pixels. The encode and decode functions run under
`core.precision.exact_fp32_products`: no TF32, whatever the caller's flags.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F

from mmada_tpu_torch.core.device import DeviceLike, resolve_device
from mmada_tpu_torch.core.precision import exact_fp32_products
from mmada_tpu_torch.ops.norms import group_norm

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VQGANConfig:
    """The reference encoder/decoder configs (modeling_magvitv2.py:49-60,
    279-289); encoder and decoder have different ch_mult / num_res_blocks
    in the flagship."""

    ch: int = 128
    enc_ch_mult: Sequence[int] = (1, 2, 2, 4, 4)
    enc_num_res_blocks: Sequence[int] = (4, 3, 4, 3, 4)
    dec_ch_mult: Sequence[int] = (1, 1, 2, 2, 4)
    dec_num_res_blocks: Sequence[int] = (4, 4, 3, 4, 3)
    attn_resolutions: Sequence[int] = (5,)
    in_ch: int = 3
    out_ch: int = 3
    resolution: int = 256
    z_channels: int = 13
    num_groups: int = 32

    @property
    def codebook_size(self) -> int:
        return 2 ** self.z_channels

    @property
    def num_levels(self) -> int:
        return len(self.enc_ch_mult)

    @property
    def downsample_factor(self) -> int:
        return 2 ** (self.num_levels - 1)


def magvit2_default() -> VQGANConfig:
    """The showlab/magvitv2 flagship."""
    return VQGANConfig()


def tiny_vqgan(resolution: int = 16) -> VQGANConfig:
    return VQGANConfig(
        ch=32,
        enc_ch_mult=(1, 2),
        enc_num_res_blocks=(2, 2),
        dec_ch_mult=(1, 2),
        dec_num_res_blocks=(2, 2),
        attn_resolutions=(resolution // 2,),
        resolution=resolution,
        z_channels=5,
        num_groups=32,
    )


# --------------------------------------------------------------------------
# primitives (NHWC in and out)
# --------------------------------------------------------------------------

def swish(x):
    return x * torch.sigmoid(x)


def conv2d(x, p, stride: int = 1, padding: str = "SAME"):
    """NHWC conv with an OIHW kernel + bias, in `x`'s dtype. SAME pads
    kh // 2 on every side (stride 1); VALID pads nothing."""
    w = p["w"].to(x.dtype)
    pad = w.shape[-1] // 2 if padding == "SAME" else 0
    out = F.conv2d(x.permute(0, 3, 1, 2), w, p["b"].to(x.dtype), stride=stride, padding=pad)
    return out.permute(0, 2, 3, 1)


def _norm(x, p, cfg):
    return group_norm(x, p["w"], p["b"], cfg.num_groups)


def _resnet_block(p, cfg, x):
    h = conv2d(swish(_norm(x, p["norm1"], cfg)), p["conv1"])
    h = conv2d(swish(_norm(h, p["norm2"], cfg)), p["conv2"])
    if "nin_shortcut" in p:
        x = conv2d(x, p["nin_shortcut"])
    return x + h


def _attn_block(p, cfg, x):
    """Single-head attention over the spatial positions
    (common_modules.py:168-211): fp32 scores scaled by C^-0.5, fp32 softmax
    cast to v's dtype before the second product."""
    b, h, w, c = x.shape
    hn = _norm(x, p["norm"], cfg)
    q, k, v = (conv2d(hn, p[name]).reshape(b, h * w, c) for name in ("q", "k", "v"))
    scores = torch.matmul(q.float(), k.float().transpose(1, 2)) * (c ** -0.5)
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(attn, v).reshape(b, h, w, c)
    return x + conv2d(out, p["proj_out"])


def _downsample(p, x):
    # pad bottom and right by one (common_modules.py:73-90), stride-2 VALID
    return conv2d(F.pad(x, (0, 0, 0, 1, 0, 1)), p["conv"], stride=2, padding="VALID")


def _upsample(p, x):
    # nearest 2x
    return conv2d(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2), p["conv"])


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _level_plan(cfg: VQGANConfig, ch_mult, encoder: bool):
    """(level, block_in, block_out, curr_res) per level, in the order the
    reference builds them (the decoder's from the top level down)."""
    plans = []
    if encoder:
        curr_res = cfg.resolution
        in_mult = (1,) + tuple(ch_mult)
        for i in range(len(ch_mult)):
            plans.append((i, cfg.ch * in_mult[i], cfg.ch * ch_mult[i], curr_res))
            if i != len(ch_mult) - 1:
                curr_res //= 2
    else:
        curr_res = cfg.resolution // 2 ** (len(ch_mult) - 1)
        block_in = cfg.ch * ch_mult[-1]
        for i in reversed(range(len(ch_mult))):
            plans.append((i, block_in, cfg.ch * ch_mult[i], curr_res))
            block_in = cfg.ch * ch_mult[i]
            if i != 0:
                curr_res *= 2
    return plans


class _Init:
    """Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) conv weights and biases, as
    the JAX init draws them (other values for the same seed), filled in
    place on the device."""

    def __init__(self, device, dtype, generator):
        self.device, self.dtype, self.generator = device, dtype, generator

    def _uniform(self, shape, bound):
        t = torch.empty(shape, dtype=self.dtype, device=self.device)
        return t.uniform_(-bound, bound, generator=self.generator)

    def conv(self, k, cin, cout):
        bound = math.sqrt(1.0 / (k * k * cin))
        return {"w": self._uniform((cout, cin, k, k), bound), "b": self._uniform((cout,), bound)}

    def norm(self, c):
        return {"w": torch.ones(c, dtype=self.dtype, device=self.device),
                "b": torch.zeros(c, dtype=self.dtype, device=self.device)}

    def resnet(self, cin, cout):
        p = {"norm1": self.norm(cin), "conv1": self.conv(3, cin, cout),
             "norm2": self.norm(cout), "conv2": self.conv(3, cout, cout)}
        if cin != cout:
            p["nin_shortcut"] = self.conv(1, cin, cout)
        return p

    def attn(self, c):
        return {"norm": self.norm(c), **{name: self.conv(1, c, c)
                                         for name in ("q", "k", "v", "proj_out")}}

    def levels(self, cfg, ch_mult, num_res_blocks, encoder: bool) -> list:
        out: list = [None] * len(ch_mult)
        for i, block_in, block_out, curr_res in _level_plan(cfg, ch_mult, encoder):
            level: Params = {"block": [], "attn": []}
            cin = block_in
            for _ in range(num_res_blocks[i]):
                level["block"].append(self.resnet(cin, block_out))
                cin = block_out
                if curr_res in cfg.attn_resolutions:
                    level["attn"].append(self.attn(cin))
            if encoder and i != len(ch_mult) - 1:
                level["downsample"] = {"conv": self.conv(3, cin, cin)}
            if not encoder and i != 0:
                level["upsample"] = {"conv": self.conv(3, cin, cin)}
            out[i] = level
        return out

    def mid(self, c):
        return {"block_1": self.resnet(c, c), "attn_1": self.attn(c), "block_2": self.resnet(c, c)}


def init_magvit2(cfg: VQGANConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32) -> Params:
    """Random weights on `device` (the card unless told otherwise);
    `generator` must live on that device."""
    init = _Init(resolve_device(device), dtype, generator)
    enc_top = cfg.ch * cfg.enc_ch_mult[-1]
    encoder = {
        "conv_in": init.conv(3, cfg.in_ch, cfg.ch),
        "down": init.levels(cfg, cfg.enc_ch_mult, cfg.enc_num_res_blocks, encoder=True),
        "mid": init.mid(enc_top),
        "norm_out": init.norm(enc_top),
        "conv_out": init.conv(3, enc_top, cfg.z_channels),
        "quant_conv": init.conv(1, cfg.z_channels, cfg.z_channels),
    }
    dec_top, dec_out = cfg.ch * cfg.dec_ch_mult[-1], cfg.ch * cfg.dec_ch_mult[0]
    decoder = {
        "post_quant_conv": init.conv(1, cfg.z_channels, cfg.z_channels),
        "conv_in": init.conv(3, cfg.z_channels, dec_top),
        "mid": init.mid(dec_top),
        "up": init.levels(cfg, cfg.dec_ch_mult, cfg.dec_num_res_blocks, encoder=False),
        "norm_out": init.norm(dec_out),
        "conv_out": init.conv(3, dec_out, cfg.out_ch),
    }
    return {"encoder": encoder, "decoder": decoder}


def param_count(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    items = params.values() if isinstance(params, dict) else params
    return sum(param_count(p) for p in items)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _mid(p, cfg, h):
    h = _resnet_block(p["block_1"], cfg, h)
    h = _attn_block(p["attn_1"], cfg, h)
    return _resnet_block(p["block_2"], cfg, h)


def _blocks(level, cfg, h, n):
    for j in range(n):
        h = _resnet_block(level["block"][j], cfg, h)
        if level["attn"]:
            h = _attn_block(level["attn"][j], cfg, h)
    return h


@exact_fp32_products()
def encoder_forward(p: Params, cfg: VQGANConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, in_ch) pixels in [-1, 1] -> (B, H/f, W/f, z_channels) latents."""
    h = conv2d(x, p["conv_in"])
    for i in range(cfg.num_levels):
        level = p["down"][i]
        h = _blocks(level, cfg, h, cfg.enc_num_res_blocks[i])
        if i != cfg.num_levels - 1:
            h = _downsample(level["downsample"], h)
    h = _mid(p["mid"], cfg, h)
    h = conv2d(swish(_norm(h, p["norm_out"], cfg)), p["conv_out"])
    return conv2d(h, p["quant_conv"])


@exact_fp32_products()
def decoder_forward(p: Params, cfg: VQGANConfig, z: torch.Tensor) -> torch.Tensor:
    """(B, h, w, z_channels) quantized latents -> (B, H, W, out_ch) pixels."""
    h = conv2d(conv2d(z, p["post_quant_conv"]), p["conv_in"])
    h = _mid(p["mid"], cfg, h)
    for i in reversed(range(len(cfg.dec_ch_mult))):
        level = p["up"][i]
        h = _blocks(level, cfg, h, cfg.dec_num_res_blocks[i])
        if i != 0:
            h = _upsample(level["upsample"], h)
    return conv2d(swish(_norm(h, p["norm_out"], cfg)), p["conv_out"])


# --------------------------------------------------------------------------
# LFQ: lookup-free quantization (deterministic)
# --------------------------------------------------------------------------

def lfq_quantize(z: torch.Tensor) -> torch.Tensor:
    """sign(z): strictly positive -> +1, else -1 (modeling_magvitv2.py:238-241)."""
    return torch.where(z > 0, 1.0, -1.0).to(z.dtype)


def lfq_indices(z: torch.Tensor, z_channels: int) -> torch.Tensor:
    """(B, h, w, C) latents -> (B, h*w) int64 codes; channel 0 is the MSB."""
    powers = 2 ** torch.arange(z_channels - 1, -1, -1, device=z.device)
    return ((z > 0).long() * powers).sum(-1).reshape(z.shape[0], -1)


def lfq_codebook_entry(indices: torch.Tensor, z_channels: int,
                       shape: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """(B, N) codes -> (B, h, w, C) fp32 latents of +-1; (h, w) is square
    from N unless `shape` is given (modeling_magvitv2.py:208-220)."""
    b, n = indices.shape
    if shape is None:
        hw = int(round(math.sqrt(n)))
        shape = (hw, hw)
    shifts = torch.arange(z_channels - 1, -1, -1, device=indices.device)
    bits = (indices.long()[..., None] >> shifts) & 1
    return (bits.float() * 2.0 - 1.0).reshape(b, shape[0], shape[1], z_channels)


def lfq_losses(z: torch.Tensor, beta: float = 0.25) -> dict[str, torch.Tensor]:
    """The LFQ bottleneck's training losses (modeling_magvitv2.py:246-263):
    per-sample binary entropy minus the batch mean-prob entropy, and the
    two-sided commit loss (the straight-through side scaled by beta)."""
    zf = z.float().reshape(-1, z.shape[-1])
    zq = torch.where(zf > 0, 1.0, -1.0)
    logits = torch.stack([-(zf - 1.0).square(), -(zf + 1.0).square()], dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    probs = logp.exp()
    entropy = -(probs * logp).sum(-1).mean()
    mean_prob = probs.mean(0)
    mean_entropy = -(mean_prob * mean_prob.clamp_min(1e-20).log()).sum(-1).mean()
    zq_ste = zf + (zq - zf).detach()
    commit = ((zq.detach() - zf).square().mean()
              + beta * (zq_ste - zf.detach()).square().mean())
    return {"entropy_loss": entropy - mean_entropy, "commit_loss": commit}


# --------------------------------------------------------------------------
# the tokenizer (reference MAGVITv2 wrapper, :402-433)
# --------------------------------------------------------------------------

@torch.no_grad()
def get_code(params: Params, cfg: VQGANConfig, pixels: torch.Tensor) -> torch.Tensor:
    """pixels (B, H, W, C) in [-1, 1] -> codes (B, N) (`MAGVITv2.get_code`)."""
    return lfq_indices(encoder_forward(params["encoder"], cfg, pixels), cfg.z_channels)


@torch.no_grad()
def decode_code(params: Params, cfg: VQGANConfig, codes: torch.Tensor,
                shape: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """codes (B, N) -> pixels (B, H, W, C) (`MAGVITv2.decode_code`)."""
    z = lfq_codebook_entry(codes, cfg.z_channels, shape)
    return decoder_forward(params["decoder"], cfg, z)


@torch.no_grad()
def encode(params: Params, cfg: VQGANConfig, pixels: torch.Tensor):
    """(sign latents, codes) of `pixels`."""
    h = encoder_forward(params["encoder"], cfg, pixels)
    return lfq_quantize(h), lfq_indices(h, cfg.z_channels)
