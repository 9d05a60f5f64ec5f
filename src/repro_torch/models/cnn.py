"""The paper's TinyML benchmark models in PyTorch: VGG16, ResNet-56
(CIFAR-10), MobileNetV2 (VWW), DS-CNN (GSC keyword spotting).

The port of the JAX package's ``repro/models/cnn.py``, in two roles:

1. **Cycle-model inputs** (Fig. 10): :func:`layer_shapes` lists every
   MAC-bearing layer of the full-size models as ``cycle_model.LayerShape``
   entries (input channels padded to a multiple of 4, depthwise convs as
   per-channel tap streams, 9 taps → 12), exactly as the JAX package.
2. **Runnable models**: ``init_*`` / ``apply_*`` pairs with a ``width``
   multiplier.  Params are nested dicts and lists of tensors; ``apply_*``
   takes NHWC input and returns logits, as the JAX functions do.
   Convolutions are ``torch.nn.functional.conv2d`` (cuDNN on the card),
   which the JAX package leaves to ``lax.conv`` outside any Pallas kernel.
   Normalization is batch-statistics BatchNorm with the population
   variance and no running stats, as in the JAX package.

Layouts: conv weights are stored OIHW (PyTorch's), linear weights
``(K, N)``.  :func:`map_weights` hands its function every conv/fc kernel
in the JAX layout (HWIO, ``(K, N)``), so offline transforms (prune,
quantize) read the same numbers in the same order as the JAX package.
XLA's ``"SAME"`` padding puts the odd pixel at the end at stride 2; it is
padded explicitly here (:func:`same_pad`).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import encoding, pruning
from repro_torch.core.cycle_model import LayerShape
from repro_torch.kernels.dispatch import resolve_device

Params = Dict[str, Any]


def _pad4(c: int) -> int:
    return ((c + 3) // 4) * 4


# ---------------------------------------------------------------------------
# Layouts and primitive layers
# ---------------------------------------------------------------------------

def hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1).contiguous()


def oihw_to_hwio(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 3, 1, 0).contiguous()


def same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: ``out = ceil(size /
    stride)``, the odd pixel (if any) after the input."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           groups: int = 1) -> torch.Tensor:
    """NCHW conv with OIHW weights and XLA ``"SAME"`` padding."""
    (ht, hb), (wl, wr) = (same_pad(x.shape[2], w.shape[2], stride),
                          same_pad(x.shape[3], w.shape[3], stride))
    if (ht, wl) == (hb, wr):
        return F.conv2d(x, w, stride=stride, padding=(ht, wl), groups=groups)
    return F.conv2d(F.pad(x, (wl, wr, ht, hb)), w, stride=stride,
                    groups=groups)


def batchnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Batch-statistics BatchNorm over (N, H, W), population variance."""
    var, mu = torch.var_mean(x, dim=(0, 2, 3), correction=0, keepdim=True)
    xn = (x - mu) * torch.rsqrt(var + eps)
    return xn * p["scale"].view(1, -1, 1, 1) + p["bias"].view(1, -1, 1, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _head(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Global average pool, then the fc layer."""
    return x.mean(dim=(2, 3)) @ p["fc"]["w"] + p["fc"]["b"]


def _init_conv(gen, kh, kw, cin, cout, device) -> torch.Tensor:
    fan_in = kh * kw * cin
    w = torch.randn((kh, kw, cin, cout), generator=gen, device=device,
                    dtype=torch.float32) * math.sqrt(2.0 / fan_in)
    return hwio_to_oihw(w)


def _init_bn(c, device) -> Params:
    return {"scale": torch.ones((c,), device=device),
            "bias": torch.zeros((c,), device=device)}


def _init_fc(gen, k, n, device) -> Params:
    return {"w": torch.randn((k, n), generator=gen, device=device,
                             dtype=torch.float32) / math.sqrt(k),
            "b": torch.zeros((n,), device=device)}


def _generator(seed: int, device) -> Tuple[torch.Generator, torch.device]:
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen, device


# ---------------------------------------------------------------------------
# VGG16 (CIFAR-10 variant)
# ---------------------------------------------------------------------------

VGG16_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"]


def init_vgg16(seed: int = 0, num_classes: int = 10, width: float = 1.0,
               in_ch: int = 3, device="cuda") -> Params:
    gen, device = _generator(seed, device)
    convs, c = [], in_ch
    for v in VGG16_PLAN:
        if v == "M":
            continue
        cout = max(int(v * width), 8)
        convs.append({"w": _init_conv(gen, 3, 3, c, cout, device),
                      "bn": _init_bn(cout, device)})
        c = cout
    return {"convs": convs, "fc": _init_fc(gen, c, num_classes, device)}


def apply_vgg16(p: Params, x: torch.Tensor) -> torch.Tensor:
    x, i = _nchw(x), 0
    for v in VGG16_PLAN:
        if v == "M":
            x = F.max_pool2d(x, 2, 2)
        else:
            layer = p["convs"][i]
            x = F.relu(batchnorm(layer["bn"], conv2d(x, layer["w"])))
            i += 1
    return _head(p, x)


# ---------------------------------------------------------------------------
# ResNet-56 (CIFAR)
# ---------------------------------------------------------------------------

def init_resnet56(seed: int = 0, num_classes: int = 10, width: float = 1.0,
                  n_blocks: int = 9, in_ch: int = 3, device="cuda") -> Params:
    gen, device = _generator(seed, device)
    widths = [max(int(w * width), 8) for w in (16, 32, 64)]
    p: Params = {"stem": {"w": _init_conv(gen, 3, 3, in_ch, widths[0],
                                          device),
                          "bn": _init_bn(widths[0], device)},
                 "stages": []}
    cin = widths[0]
    for s, cout in enumerate(widths):
        blocks = []
        for b in range(n_blocks):
            stride = 2 if (s > 0 and b == 0) else 1
            blk = {"w1": _init_conv(gen, 3, 3, cin, cout, device),
                   "bn1": _init_bn(cout, device),
                   "w2": _init_conv(gen, 3, 3, cout, cout, device),
                   "bn2": _init_bn(cout, device)}
            if stride != 1 or cin != cout:
                blk["proj"] = _init_conv(gen, 1, 1, cin, cout, device)
            blocks.append(blk)
            cin = cout
        p["stages"].append(blocks)
    p["fc"] = _init_fc(gen, cin, num_classes, device)
    return p


def apply_resnet56(p: Params, x: torch.Tensor) -> torch.Tensor:
    x = F.relu(batchnorm(p["stem"]["bn"], conv2d(_nchw(x), p["stem"]["w"])))
    for si, stage in enumerate(p["stages"]):
        for bi, blk in enumerate(stage):
            stride = 2 if (si > 0 and bi == 0) else 1
            h = F.relu(batchnorm(blk["bn1"],
                                 conv2d(x, blk["w1"], stride=stride)))
            h = batchnorm(blk["bn2"], conv2d(h, blk["w2"]))
            sc = conv2d(x, blk["proj"], stride=stride) \
                if "proj" in blk else x
            x = F.relu(h + sc)
    return _head(p, x)


# ---------------------------------------------------------------------------
# MobileNetV2 (VWW: 96×96, 2 classes)
# ---------------------------------------------------------------------------

MBV2_PLAN = [  # (expansion t, out channels c, repeats n, stride s)
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]


def init_mobilenetv2(seed: int = 0, num_classes: int = 2, width: float = 1.0,
                     in_ch: int = 3, device="cuda") -> Params:
    gen, device = _generator(seed, device)

    def ch(c):
        return max(int(c * width), 8)

    def conv_bn(kh, kw, cin, cout):
        return {"w": _init_conv(gen, kh, kw, cin, cout, device),
                "bn": _init_bn(cout, device)}

    p: Params = {"stem": conv_bn(3, 3, in_ch, ch(32)), "blocks": []}
    cin = ch(32)
    for t, c, n, s in MBV2_PLAN:
        for _ in range(n):
            cout, hidden = ch(c), cin * t
            blk: Params = {}
            if t != 1:
                blk["expand"] = conv_bn(1, 1, cin, hidden)
            blk["dw"] = conv_bn(3, 3, 1, hidden)
            blk["project"] = conv_bn(1, 1, hidden, cout)
            p["blocks"].append(blk)
            cin = cout
    p["head"] = conv_bn(1, 1, cin, ch(1280))
    p["fc"] = _init_fc(gen, ch(1280), num_classes, device)
    return p


def apply_mobilenetv2(p: Params, x: torch.Tensor) -> torch.Tensor:
    x = F.relu6(batchnorm(p["stem"]["bn"],
                          conv2d(_nchw(x), p["stem"]["w"], stride=2)))
    strides = [s if i == 0 else 1
               for t, c, n, s in MBV2_PLAN for i in range(n)]
    for blk, stride in zip(p["blocks"], strides):
        h = x
        if "expand" in blk:
            h = F.relu6(batchnorm(blk["expand"]["bn"],
                                  conv2d(h, blk["expand"]["w"])))
        h = F.relu6(batchnorm(blk["dw"]["bn"],
                              conv2d(h, blk["dw"]["w"], stride=stride,
                                     groups=h.shape[1])))
        h = batchnorm(blk["project"]["bn"], conv2d(h, blk["project"]["w"]))
        use_res = stride == 1 and x.shape[1] == h.shape[1]
        x = x + h if use_res else h
    x = F.relu6(batchnorm(p["head"]["bn"], conv2d(x, p["head"]["w"])))
    return _head(p, x)


# ---------------------------------------------------------------------------
# DSCNN (keyword spotting, GSC: 49×10 MFCC input)
# ---------------------------------------------------------------------------

def init_dscnn(seed: int = 0, num_classes: int = 12, width: float = 1.0,
               n_ds_blocks: int = 4, in_ch: int = 1, device="cuda") -> Params:
    gen, device = _generator(seed, device)
    c = max(int(64 * width), 8)

    def conv_bn(kh, kw, cin):
        return {"w": _init_conv(gen, kh, kw, cin, c, device),
                "bn": _init_bn(c, device)}

    p: Params = {"stem": conv_bn(10, 4, in_ch),
                 "blocks": [{"dw": conv_bn(3, 3, 1), "pw": conv_bn(1, 1, c)}
                            for _ in range(n_ds_blocks)]}
    p["fc"] = _init_fc(gen, c, num_classes, device)
    return p


def apply_dscnn(p: Params, x: torch.Tensor) -> torch.Tensor:
    x = F.relu(batchnorm(p["stem"]["bn"],
                         conv2d(_nchw(x), p["stem"]["w"], stride=2)))
    for blk in p["blocks"]:
        x = F.relu(batchnorm(blk["dw"]["bn"],
                             conv2d(x, blk["dw"]["w"], groups=x.shape[1])))
        x = F.relu(batchnorm(blk["pw"]["bn"], conv2d(x, blk["pw"]["w"])))
    return _head(p, x)


# ---------------------------------------------------------------------------
# Registry + cycle-model layer shapes (full-size models, Fig. 10 inputs)
# ---------------------------------------------------------------------------

CNN_ZOO: Dict[str, Tuple[Callable, Callable]] = {
    "vgg16": (init_vgg16, apply_vgg16),
    "resnet56": (init_resnet56, apply_resnet56),
    "mobilenetv2": (init_mobilenetv2, apply_mobilenetv2),
    "dscnn": (init_dscnn, apply_dscnn),
}


def _conv_shape(kh, kw, cin, cout, oh, ow) -> LayerShape:
    return LayerShape("conv", (kh, kw, _pad4(cin), cout), (oh, ow))


def _dw_shape(kh, kw, c, oh, ow) -> LayerShape:
    """Depthwise conv as per-channel tap streams (taps padded to ×4)."""
    return LayerShape("conv", (1, 1, _pad4(kh * kw), c), (oh, ow))


def layer_shapes(model: str) -> List[LayerShape]:
    """MAC-bearing layers of the full-size paper models (input resolutions:
    CIFAR 32², VWW 96², GSC 49×10)."""
    if model == "vgg16":
        out, c, hw = [], 3, 32
        for v in VGG16_PLAN:
            if v == "M":
                hw //= 2
            else:
                out.append(_conv_shape(3, 3, c, v, hw, hw))
                c = v
        out.append(LayerShape("linear", (_pad4(c), 10)))
        return out
    if model == "resnet56":
        out, cin, hw = [_conv_shape(3, 3, 3, 16, 32, 32)], 16, 32
        for s, cout in enumerate((16, 32, 64)):
            for b in range(9):
                stride = 2 if (s > 0 and b == 0) else 1
                hw = hw // stride
                out.append(_conv_shape(3, 3, cin, cout, hw, hw))
                out.append(_conv_shape(3, 3, cout, cout, hw, hw))
                if stride != 1 or cin != cout:
                    out.append(_conv_shape(1, 1, cin, cout, hw, hw))
                cin = cout
        out.append(LayerShape("linear", (64, 10)))
        return out
    if model == "mobilenetv2":
        out, cin, hw = [_conv_shape(3, 3, 3, 32, 48, 48)], 32, 48
        for t, c, n, s in MBV2_PLAN:
            for i in range(n):
                stride = s if i == 0 else 1
                hidden = cin * t
                if t != 1:
                    out.append(_conv_shape(1, 1, cin, hidden, hw, hw))
                hw = hw // stride
                out.append(_dw_shape(3, 3, hidden, hw, hw))
                out.append(_conv_shape(1, 1, hidden, c, hw, hw))
                cin = c
        out.append(_conv_shape(1, 1, cin, 1280, hw, hw))
        out.append(LayerShape("linear", (1280, 2)))
        return out
    if model == "dscnn":
        out = [_conv_shape(10, 4, 1, 64, 25, 5)]
        for _ in range(4):
            out.append(_dw_shape(3, 3, 64, 25, 5))
            out.append(_conv_shape(1, 1, 64, 64, 25, 5))
        out.append(LayerShape("linear", (64, 12)))
        return out
    raise ValueError(f"unknown model {model!r}; one of {list(CNN_ZOO)}")


# ---------------------------------------------------------------------------
# Offline weight transforms (prune / quantize) over a CNN param tree
# ---------------------------------------------------------------------------

def map_weights(params: Any, fn: Callable[[torch.Tensor], torch.Tensor],
                key: str = "") -> Any:
    """Apply ``fn`` to every conv/fc kernel: a leaf of ≥ 2 dims whose key
    starts with ``w``, as in the JAX package (so ResNet-56's ``proj``
    shortcuts are left alone, as there).  ``fn`` sees a conv kernel as
    HWIO and returns it so; norms and biases pass through."""
    if isinstance(params, dict):
        return {k: map_weights(v, fn, k) for k, v in params.items()}
    if isinstance(params, list):
        return [map_weights(v, fn) for v in params]
    if params.dim() < 2 or not key.startswith("w"):
        return params
    if params.dim() == 4:
        return hwio_to_oihw(fn(oihw_to_hwio(params)))
    return fn(params)


def quantize_dequantize(params: Params, bits7: bool) -> Params:
    """Fake-quantize weights through INT8 or INT7 (Table II comparison):
    per output channel over the HWIO-flattened ``(-1, Cout)`` view."""
    quantize = encoding.quantize_int7 if bits7 else encoding.quantize_int8

    def qdq(w: torch.Tensor) -> torch.Tensor:
        q, scale = quantize(w.reshape(-1, w.shape[-1]), axis=0)
        return (q.to(torch.float32) * scale).reshape(w.shape)

    return map_weights(params, qdq)


def prune_combined(params: Params, x_ss: float, x_us: float) -> Params:
    """Combined (CSA) pruning of every conv/fc kernel at one Fig. 10
    operating point: ``pruning.combined`` on the HWIO-flattened ``(K,
    Cout)`` view, with K zero-padded at the end to the block of 4 where it
    is not a multiple (the 27-row stems, the 9-tap depthwise kernels) and
    the padding dropped after."""

    def prune(w: torch.Tensor) -> torch.Tensor:
        flat = w.reshape(-1, w.shape[-1])
        K = flat.shape[0]
        padded = F.pad(flat, (0, 0, 0, _pad4(K) - K))
        pruned, _ = pruning.combined(padded, x_ss=x_ss, x_us=x_us)
        return pruned[:K].reshape(w.shape)

    return map_weights(params, prune)
