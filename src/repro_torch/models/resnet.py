"""Small CIFAR-scale ResNet (the paper's §5.1 model family), the
reference's ``models/resnet.py`` in PyTorch.

Activations are NHWC and conv weights HWIO, as in the reference, so a
reference params tree carries across unchanged
(``repro_torch.convert.params_from_jax``). GroupNorm stands in for
BatchNorm, as in the reference: the model stays a pure function of
(params, batch).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.utils.pytree import tree_map


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 10
    width: int = 16
    blocks_per_stage: int = 3      # 3 -> ResNet-20 family
    groups: int = 8


def _conv_init(gen, kh, kw, cin, cout):
    return torch.randn((kh, kw, cin, cout), generator=gen) / math.sqrt(
        kh * kw * cin)


def _same_pad(size: int, k: int, stride: int):
    """XLA's "SAME" padding of one spatial dim -> (low, high): the output
    has ceil(size / stride) positions and the odd pad goes high, so a
    3x3 stride-2 conv pads (0, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


@contextlib.contextmanager
def float32_convs():
    """cuDNN convolutions in full float32 inside the block: by default
    cuDNN rounds a float32 conv's inputs to TF32 (10-bit mantissas), which
    moves this net's gradients by up to a tenth of a leaf's largest entry
    against the reference's float32 convs. A backward pass must run inside
    the block too."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (N, H, W, Cin), w (kh, kw, Cin, Cout) -> (N, H', W', Cout) with
    XLA's "SAME" padding, through ``F.conv2d`` on NCHW / OIHW."""
    kh, kw = w.shape[:2]
    ph, pw = (_same_pad(x.shape[1], kh, stride),
              _same_pad(x.shape[2], kw, stride))
    xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int) -> torch.Tensor:
    """NHWC GroupNorm in float32: channel c is in group c // (C / groups);
    mean and variance over (H, W, C / groups); eps 1e-5."""
    n, h, w, c = x.shape
    xg = x.reshape(n, h, w, groups, c // groups).to(torch.float32)
    mu = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = ((xg - mu) ** 2).mean(dim=(1, 2, 4), keepdim=True)
    xn = ((xg - mu) * torch.rsqrt(var + 1e-5)).reshape(n, h, w, c)
    return (xn * scale + bias).to(x.dtype)


def _stride(s_i: int, b_i: int) -> int:
    return 2 if (s_i > 0 and b_i == 0) else 1


def init_resnet(gen: torch.Generator, cfg: ResNetConfig,
                device=None) -> dict:
    """Float32 params in the reference's layout, drawn from ``gen`` on the
    CPU (numbers differ from ``jax.random``'s), then moved to ``device``:
    the card unless the caller passes ``device="cpu"``. ``proj`` exists
    only where the block changes stride or width."""
    device = resolve_device(device)
    w = cfg.width
    params = {"stem": {"w": _conv_init(gen, 3, 3, 3, w),
                       "gn_s": torch.ones(w), "gn_b": torch.zeros(w)}}
    stages = []
    cin = w
    for s, cout in enumerate((w, 2 * w, 4 * w)):
        blocks = []
        for b in range(cfg.blocks_per_stage):
            blk = {
                "w1": _conv_init(gen, 3, 3, cin, cout),
                "gn1_s": torch.ones(cout), "gn1_b": torch.zeros(cout),
                "w2": _conv_init(gen, 3, 3, cout, cout),
                "gn2_s": torch.ones(cout), "gn2_b": torch.zeros(cout),
            }
            if _stride(s, b) != 1 or cin != cout:
                blk["proj"] = _conv_init(gen, 1, 1, cin, cout)
            blocks.append(blk)
            cin = cout
        stages.append(blocks)
    params["stages"] = stages
    params["head"] = {"w": torch.randn((cin, cfg.num_classes),
                                       generator=gen) / math.sqrt(cin),
                      "b": torch.zeros(cfg.num_classes)}
    return tree_map(lambda t: t.to(device), params)


def resnet_logits(params, images: torch.Tensor,
                  cfg: ResNetConfig) -> torch.Tensor:
    """images (N, 32, 32, 3) -> logits (N, classes), the convolutions in
    full float32 (:func:`float32_convs`)."""
    with float32_convs():
        return _logits(params, images, cfg)


def _logits(params, images, cfg):
    x = conv(images, params["stem"]["w"])
    x = F.relu(group_norm(x, params["stem"]["gn_s"], params["stem"]["gn_b"],
                          cfg.groups))
    for s_i, blocks in enumerate(params["stages"]):
        for b_i, blk in enumerate(blocks):
            stride = _stride(s_i, b_i)
            h = conv(x, blk["w1"], stride)
            h = F.relu(group_norm(h, blk["gn1_s"], blk["gn1_b"], cfg.groups))
            h = conv(h, blk["w2"])
            h = group_norm(h, blk["gn2_s"], blk["gn2_b"], cfg.groups)
            sc = x if "proj" not in blk else conv(x, blk["proj"], stride)
            x = F.relu(h + sc)
    x = x.mean(dim=(1, 2))
    return x @ params["head"]["w"] + params["head"]["b"]


def resnet_loss(params, batch, cfg: ResNetConfig) -> torch.Tensor:
    """Mean cross entropy: the log-softmax against a one-hot of the
    labels, as the reference computes it."""
    lg = resnet_logits(params, batch["images"], cfg)
    onehot = F.one_hot(batch["labels"].long(), cfg.num_classes).to(lg.dtype)
    return -(F.log_softmax(lg, dim=-1) * onehot).sum(-1).mean()
