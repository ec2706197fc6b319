"""Motion VQ-VAE: 1-D conv encoder/decoder and its four codebook variants.

Counterpart of `mmada_tpu/models/motion_vq.py` (the reference motion
tokenizer, motion_vqvae/models/: `Encoder` / `Decoder`, encdec.py:4-66,
stride-2 1-D conv stacks with dilated `Resnet1D` blocks, resnet.py; the
quantizers of quantize_cnn.py). Flagship config: nb_code 512, code_dim 512,
down_t 2 (options/option_vq.py:26-33), so 4 motion frames a token.

The network is `nn.Module`s laid out as the reference's anonymous
`nn.Sequential` stacks, so a reference state dict loads by its own keys
(`checkpoints/motion_import.py`): torch's conv1d is NCT with `(out, in, k)`
weights, the reference's layout. The public layout stays JAX's: pose
features enter as `(B, T, pose_dim)` float32, latents are `(B, t, code_dim)`,
codes `(B, t)`. `Resnet1D` runs its dilations reversed in both encoder and
decoder (the reference's default, resnet.py:71); the decoder's upsampling is
nearest x2 on time (`repeat_interleave`, JAX's `jnp.repeat`).

The codebook state is explicit, as in JAX: `CodebookState` holds the EMA
sums, counts and the initialized flag as tensors, and `quantizer_forward` /
`forward_train` return the new codebook and state (the caller assigns them
back). Random numbers (the tiling noise of `_tile_to`, drawn only when a
batch holds fewer vectors than the codebook) come from a `torch.Generator`,
so they differ from JAX's streams.

Every conv and the distance product run in full fp32 under
`core.precision.exact_fp32_products`, whatever the caller's flags: the codes
are an argmin, which a TF32 product would move.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmada_tpu_torch.core.device import DeviceLike, resolve_device
from mmada_tpu_torch.core.precision import exact_fp32_products


@dataclasses.dataclass(frozen=True)
class MotionVQConfig:
    pose_dim: int = 263            # HumanML3D feature width
    code_dim: int = 512
    nb_code: int = 512
    width: int = 512
    down_t: int = 2
    stride_t: int = 2
    depth: int = 3
    dilation_growth_rate: int = 3
    activation: str = "relu"
    mu: float = 0.99               # EMA decay
    quantizer: str = "ema_reset"
    """'ema_reset' (EMA + dead-code reset, the flagship), 'ema', 'reset'
    (gradient-free, unused codes reseeded) or 'gradient' (optimizer-trained,
    the classic VQ loss; the codebook must be in the optimizer)."""
    beta: float = 1.0              # 'gradient' commitment weight


def tiny_motion_cfg() -> MotionVQConfig:
    return MotionVQConfig(
        pose_dim=8, code_dim=16, nb_code=32, width=16, down_t=2, depth=2,
        dilation_growth_rate=2,
    )


# --------------------------------------------------------------------------
# network (NCT inside; reference layout and keys)
# --------------------------------------------------------------------------

def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "relu":
        return F.relu(x)
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x)
    raise ValueError(name)


class ResConv1DBlock(nn.Module):
    """resnet.py:24-67, norm=None: act -> dilated 3-conv -> act -> 1-conv,
    residual."""

    def __init__(self, width: int, dilation: int, activation: str):
        super().__init__()
        self.activation = activation
        self.conv1 = nn.Conv1d(width, width, 3, padding=dilation, dilation=dilation)
        self.conv2 = nn.Conv1d(width, width, 1)

    def forward(self, x):
        h = self.conv1(_act(self.activation, x))
        return x + self.conv2(_act(self.activation, h))


class Resnet1D(nn.Module):
    def __init__(self, cfg: MotionVQConfig):
        super().__init__()
        dilations = [cfg.dilation_growth_rate ** d for d in range(cfg.depth)][::-1]
        self.model = nn.Sequential(*[ResConv1DBlock(cfg.width, d, cfg.activation)
                                     for d in dilations])

    def forward(self, x):
        return self.model(x)


class _Repeat2(nn.Module):
    """Nearest-neighbour x2 upsampling on time."""

    def forward(self, x):
        return x.repeat_interleave(2, dim=2)


class Encoder(nn.Module):
    def __init__(self, cfg: MotionVQConfig):
        super().__init__()
        filt, pad = cfg.stride_t * 2, cfg.stride_t // 2
        self.model = nn.Sequential(
            nn.Conv1d(cfg.pose_dim, cfg.width, 3, padding=1), nn.ReLU(),
            *[nn.Sequential(nn.Conv1d(cfg.width, cfg.width, filt, stride=cfg.stride_t,
                                      padding=pad), Resnet1D(cfg))
              for _ in range(cfg.down_t)],
            nn.Conv1d(cfg.width, cfg.code_dim, 3, padding=1),
        )

    def forward(self, x):
        return self.model(x)


class Decoder(nn.Module):
    def __init__(self, cfg: MotionVQConfig):
        super().__init__()
        self.model = nn.Sequential(
            nn.Conv1d(cfg.code_dim, cfg.width, 3, padding=1), nn.ReLU(),
            *[nn.Sequential(Resnet1D(cfg), _Repeat2(),
                            nn.Conv1d(cfg.width, cfg.width, 3, padding=1))
              for _ in range(cfg.down_t)],
            nn.Conv1d(cfg.width, cfg.width, 3, padding=1), nn.ReLU(),
            nn.Conv1d(cfg.width, cfg.pose_dim, 3, padding=1),
        )

    def forward(self, x):
        return self.model(x)


class MotionVQ(nn.Module):
    """`HumanVQVAE`'s weights: `encoder`, `decoder` and the `(nb_code,
    code_dim)` codebook (a parameter: the 'gradient' variant trains it; the
    others assign `forward_train`'s update to it)."""

    def __init__(self, cfg: MotionVQConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.codebook = nn.Parameter(torch.zeros(cfg.nb_code, cfg.code_dim))

    @property
    def device(self) -> torch.device:
        return self.codebook.device

    def conv_parameters(self) -> dict[str, torch.Tensor]:
        """The encoder's and decoder's weights by name (what the trainer's
        optimizer updates; the codebook joins them for 'gradient')."""
        return {n: p for n, p in self.named_parameters() if n != "codebook"}


@torch.no_grad()
def init_motion_vq(cfg: MotionVQConfig, device: DeviceLike = None,
                   generator: Optional[torch.Generator] = None) -> MotionVQ:
    """Random weights made on `device` (the card unless told otherwise): each
    conv's weight and bias uniform in +-1/sqrt(k * in), as JAX's
    `_init_conv1d`; the codebook as the variant's reference init (zeros until
    the first batch seeds it for the EMA variants)."""
    device = resolve_device(device)
    vq = MotionVQ(cfg).to(device)
    for m in vq.modules():
        if isinstance(m, nn.Conv1d):
            bound = math.sqrt(1.0 / (m.kernel_size[0] * m.in_channels))
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
    if cfg.quantizer == "gradient":
        vq.codebook.uniform_(-1.0 / cfg.nb_code, 1.0 / cfg.nb_code, generator=generator)
    elif cfg.quantizer == "reset":
        vq.codebook.normal_(generator=generator)
    return vq


@dataclasses.dataclass
class CodebookState:
    """Explicit EMA state (the reference keeps these as module buffers)."""

    code_sum: torch.Tensor     # (nb_code, code_dim)
    code_count: torch.Tensor   # (nb_code,)
    initialized: torch.Tensor  # () bool

    @classmethod
    def create(cls, cfg: MotionVQConfig, device: DeviceLike = None) -> "CodebookState":
        device = resolve_device(device)
        return cls(code_sum=torch.zeros((cfg.nb_code, cfg.code_dim), device=device),
                   code_count=torch.zeros((cfg.nb_code,), device=device),
                   initialized=torch.zeros((), dtype=torch.bool, device=device))


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

@exact_fp32_products()
def encoder_forward(vq: MotionVQ, cfg: MotionVQConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, T, pose_dim) -> (B, T / stride^down_t, code_dim) latents."""
    return vq.encoder(x.transpose(1, 2)).transpose(1, 2)


@exact_fp32_products()
def decoder_forward(vq: MotionVQ, cfg: MotionVQConfig, z: torch.Tensor) -> torch.Tensor:
    """(B, t, code_dim) -> (B, T, pose_dim)."""
    return vq.decoder(z.transpose(1, 2)).transpose(1, 2)


# --------------------------------------------------------------------------
# quantizers (quantize_cnn.py:6-413)
# --------------------------------------------------------------------------

@exact_fp32_products()
def quantize(codebook: torch.Tensor, x_flat: torch.Tensor) -> torch.Tensor:
    """Nearest code by L2: argmin |x|^2 - 2 x W^T + |w|^2 (the first on a
    tie, as jnp.argmin)."""
    dist = ((x_flat ** 2).sum(-1, keepdim=True) - 2.0 * x_flat @ codebook.T
            + (codebook ** 2).sum(-1)[None, :])
    return dist.argmin(dim=-1)


def dequantize(codebook: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    return codebook[codes]


def perplexity_of(codes: torch.Tensor, nb_code: int) -> torch.Tensor:
    counts = torch.bincount(codes.reshape(-1), minlength=nb_code).float()
    prob = counts / counts.sum().clamp(min=1)
    return torch.exp(-(prob * torch.log(prob + 1e-7)).sum())


def _tile_to(generator: Optional[torch.Generator], x_flat: torch.Tensor,
             nb_code: int) -> torch.Tensor:
    """Reference `_tile` (quantize_cnn.py:20-29): batch vectors repeated up to
    nb_code rows, with noise only when tiling is needed (with N >= nb_code
    the seeds are exact batch samples and nothing is drawn)."""
    n, d = x_flat.shape
    if n >= nb_code:
        return x_flat[:nb_code]
    reps = (nb_code + n - 1) // n
    out = x_flat.repeat(reps, 1)[:nb_code]
    noise = torch.randn(out.shape, generator=generator, device=out.device, dtype=out.dtype)
    return out + noise * (0.01 / math.sqrt(d))


def _perplexity(code_count_batch: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    prob = code_count_batch / code_count_batch.sum().clamp(min=1e-12)
    return torch.exp(-(prob * torch.log(prob + eps)).sum())


def _init_codebook(generator, x_flat: torch.Tensor, nb_code: int):
    """First-batch seeding (quantize_cnn.py:31-36): codebook and EMA sums
    from batch vectors, counts at one."""
    seeded = _tile_to(generator, x_flat, nb_code)
    ones = torch.ones((nb_code,), device=x_flat.device)
    return seeded, CodebookState(code_sum=seeded, code_count=ones,
                                 initialized=torch.ones((), dtype=torch.bool,
                                                        device=x_flat.device))


@exact_fp32_products()
def _apply_update(generator, codebook: torch.Tensor, state: CodebookState,
                  x_flat: torch.Tensor, codes: torch.Tensor, cfg: MotionVQConfig):
    """The variant's unconditional update: ema_reset (EMA centres, codes
    whose EMA count is under 1 reseeded, quantize_cnn.py:49-73), ema (EMA
    centres, :344-363), reset (codes used this batch kept, the others
    reseeded, :233-252). Returns (codebook, state, perplexity)."""
    nb_code = codebook.shape[0]
    mu = cfg.mu
    onehot = F.one_hot(codes, nb_code).to(x_flat.dtype)   # (N, K)
    code_sum_batch = onehot.T @ x_flat
    code_count_batch = onehot.sum(dim=0)
    rand = _tile_to(generator, x_flat, nb_code)
    initialized = torch.ones((), dtype=torch.bool, device=x_flat.device)
    if cfg.quantizer == "reset":
        usage = (code_count_batch >= 1.0)[:, None]
        new_codebook = torch.where(usage, codebook, rand)
        new_state = CodebookState(code_sum=state.code_sum, code_count=code_count_batch,
                                  initialized=initialized)
    else:
        code_sum = mu * state.code_sum + (1 - mu) * code_sum_batch
        code_count = mu * state.code_count + (1 - mu) * code_count_batch
        update = code_sum / code_count[:, None].clamp(min=1e-12)
        if cfg.quantizer == "ema":
            new_codebook = update
        else:  # ema_reset
            new_codebook = torch.where((code_count >= 1.0)[:, None], update, rand)
        new_state = CodebookState(code_sum=code_sum, code_count=code_count,
                                  initialized=initialized)
    return new_codebook, new_state, _perplexity(code_count_batch)


@torch.no_grad()
def quantizer_forward(generator, codebook: torch.Tensor, state: CodebookState,
                      x_flat: torch.Tensor, cfg: MotionVQConfig):
    """Training-mode quantizer pass in the reference's order
    (quantize_cnn.py:94-123): seed from the batch if uninitialized ->
    quantize with the (possibly just seeded) codebook -> the variant's update.
    Returns (z_q, codes, new_codebook, new_state, perplexity). Not for
    'gradient' (`gradient_quantizer_losses`)."""
    if cfg.quantizer not in ("ema_reset", "ema", "reset"):
        raise ValueError(f"quantizer_forward does not apply to {cfg.quantizer}")
    x_flat = x_flat.detach()
    if not bool(state.initialized):
        codebook, state = _init_codebook(generator, x_flat, codebook.shape[0])
    codes = quantize(codebook, x_flat)
    z_q = dequantize(codebook, codes)
    new_codebook, new_state, ppl = _apply_update(generator, codebook, state, x_flat, codes, cfg)
    return z_q, codes, new_codebook, new_state, ppl


@torch.no_grad()
def ema_update(generator, codebook: torch.Tensor, state: CodebookState,
               x_flat: torch.Tensor, codes: torch.Tensor, mu: float):
    """One ema_reset update with given codes; seeds from the batch (and
    requantizes) when uninitialized. `quantizer_forward` is the reference's
    full step."""
    cfg = MotionVQConfig(mu=mu, quantizer="ema_reset")
    if not bool(state.initialized):
        codebook, state = _init_codebook(generator, x_flat, codebook.shape[0])
        codes = quantize(codebook, x_flat)
    return _apply_update(generator, codebook, state, x_flat, codes, cfg)


def gradient_quantizer_losses(codebook: torch.Tensor, z_flat: torch.Tensor, beta: float = 1.0):
    """Optimizer-trained quantizer (`Quantizer`, quantize_cnn.py:127-165):
    loss = |z_q - sg(z)|^2 + beta |sg(z_q) - z|^2. Returns (z_q_ste, loss,
    perplexity, codes)."""
    codes = quantize(codebook.detach(), z_flat.detach())
    z_q = codebook[codes]
    loss = (torch.mean((z_q - z_flat.detach()) ** 2)
            + beta * torch.mean((z_q.detach() - z_flat) ** 2))
    z_q_ste = z_flat + (z_q - z_flat).detach()
    onehot_mean = F.one_hot(codes, codebook.shape[0]).float().mean(dim=0)
    perplexity = torch.exp(-(onehot_mean * torch.log(onehot_mean + 1e-10)).sum())
    return z_q_ste, loss, perplexity, codes


# --------------------------------------------------------------------------
# top level (HumanVQVAE, motion_vqvae/models/vqvae.py:6-117)
# --------------------------------------------------------------------------

@torch.no_grad()
def encode(vq: MotionVQ, cfg: MotionVQConfig, motion: torch.Tensor) -> torch.Tensor:
    """(B, T, pose_dim) -> (B, t) motion VQ codes."""
    z = encoder_forward(vq, cfg, motion)
    b, t, d = z.shape
    return quantize(vq.codebook, z.reshape(-1, d)).reshape(b, t)


@torch.no_grad()
def decode(vq: MotionVQ, cfg: MotionVQConfig, codes: torch.Tensor) -> torch.Tensor:
    """(B, t) codes -> (B, T, pose_dim) motion features."""
    return decoder_forward(vq, cfg, dequantize(vq.codebook, codes))


def forward_train(generator, vq: MotionVQ, state: CodebookState, cfg: MotionVQConfig,
                  motion: torch.Tensor):
    """Training forward: (recon, commit_loss, perplexity, new_codebook,
    new_state), straight-through on the bottleneck. For the non-gradient
    variants the codebook and state carry the update (assign them back); for
    'gradient' the codebook is returned as it is and learns through
    commit_loss (the two-term VQ loss) by the optimizer."""
    z = encoder_forward(vq, cfg, motion)
    b, t, d = z.shape
    z_flat = z.reshape(-1, d)
    if cfg.quantizer == "gradient":
        z_ste, commit_loss, perplexity, _ = gradient_quantizer_losses(vq.codebook, z_flat,
                                                                      beta=cfg.beta)
        recon = decoder_forward(vq, cfg, z_ste.reshape(b, t, d))
        return recon, commit_loss, perplexity, vq.codebook.detach(), state
    z_q, _, new_codebook, new_state, perplexity = quantizer_forward(
        generator, vq.codebook.detach(), state, z_flat, cfg)
    commit_loss = torch.mean((z_flat - z_q) ** 2)
    z_ste = z_flat + (z_q - z_flat).detach()
    recon = decoder_forward(vq, cfg, z_ste.reshape(b, t, d))
    return recon, commit_loss, perplexity, new_codebook, new_state


def motion_losses(recon: torch.Tensor, target: torch.Tensor, commit_loss: torch.Tensor,
                  commit_weight: float = 0.02, vel_weight: float = 0.5):
    """Recon + commitment + velocity losses (utils/losses.py:4-28: smooth-l1
    on the features and on the frame-to-frame deltas)."""
    def smooth_l1(a, b):
        d = (a - b).abs()
        return torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean()

    loss_recon = smooth_l1(recon, target)
    loss_vel = smooth_l1(recon[:, 1:] - recon[:, :-1], target[:, 1:] - target[:, :-1])
    total = loss_recon + vel_weight * loss_vel + commit_weight * commit_loss
    return total, {"recon": loss_recon, "vel": loss_vel, "commit": commit_loss}
