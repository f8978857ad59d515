"""YOLOv8-style detector for dynamic-object masking.

Counterpart of ``mlis_tpu/models/yolo.py``. The reference's yolo-orb-slam3
variant runs YOLOv8n (ultralytics) to mask the dynamic COCO classes
{0 person, 1 bicycle, 2 car, 3 motorcycle, 5 bus, 7 truck} with bounding
boxes dilated by 10 pixels before feature extraction:

* the YOLOv8 architecture (CSP backbone with C2f blocks, SPPF, an FPN / PAN
  neck, the decoupled anchor-free head with DFL box regression), nano width
  by default; convolutions pad symmetrically, k // 2 on each side, frozen
  batch norm is a per-channel scale and bias, the FPN's 2x upsample is
  nearest (index i // 2), the head's 1x1 convolutions compute in float32;
* post-processing with fixed budgets: the top ``max_detections`` candidates
  (ties to the lower index, as ``lax.top_k``), one IoU matrix per image and
  greedy suppression in a fixed ``max_detections``-step loop;
* :func:`mask_dynamic_objects` rasterises the dilated boxes of dynamic
  classes as one boolean product over the boxes, (B, H, N) x (B, N, W),
  without the (B, N, H, W) stack.

Module names follow the JAX package's flax tree (``stem.conv``,
``c2f1.m0.cv1``, ``head0_out``...), so :func:`mlis_tpu_torch.weights.
carry_jax_yolo` carries its parameters across. A random initialisation
draws flax's defaults from ``torch.Generator().manual_seed(seed)`` (the
JAX detector draws from ``PRNGKey(seed)``, so the same seed gives other
weights). Everything is plain PyTorch: the JAX package has no Pallas
kernel here either.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mlis_tpu_torch.models.layers import Conv, flax_init_
from mlis_tpu_torch.ops.image import resize_nhwc
from mlis_tpu_torch.ops.knn import topk_lower_index

# COCO ids the reference masks (Dockerfile.yolo-orb-slam3)
DYNAMIC_COCO_CLASSES = (0, 1, 2, 3, 5, 7)


@dataclasses.dataclass(frozen=True)
class YOLOConfig:
    num_classes: int = 80
    width: float = 0.25  # nano
    depth: float = 1.0 / 3.0
    reg_max: int = 16  # DFL bins
    max_detections: int = 64
    score_threshold: float = 0.25
    iou_threshold: float = 0.45
    dtype: torch.dtype = torch.bfloat16

    def ch(self, c: int) -> int:
        return max(8, int(round(c * self.width / 8)) * 8)

    def n(self, d: int) -> int:
        return max(1, int(round(d * self.depth)))

    @staticmethod
    def nano(**kw) -> "YOLOConfig":
        return YOLOConfig(**kw)

    @staticmethod
    def tiny_test(**kw) -> "YOLOConfig":
        kw.setdefault("width", 0.125)
        kw.setdefault("max_detections", 16)
        return YOLOConfig(**kw)


class ConvBNAct(nn.Module):
    """Bias-free k x k conv (stride s, padding k // 2), the folded frozen
    batch norm as a per-channel scale and bias, SiLU. NCHW."""

    def __init__(self, in_ch: int, ch: int, k: int = 3, s: int = 1, dtype=torch.bfloat16):
        super().__init__()
        self.conv = Conv(in_ch, ch, k, stride=s, padding=k // 2, bias=False, dtype=dtype)
        self.bn_scale = nn.Parameter(torch.ones(ch))
        self.bn_bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        x = x * self.bn_scale.to(x.dtype)[:, None, None] + self.bn_bias.to(x.dtype)[:, None, None]
        return F.silu(x)


class Bottleneck(nn.Module):
    def __init__(self, ch: int, shortcut: bool, dtype):
        super().__init__()
        self.shortcut = shortcut
        self.cv1 = ConvBNAct(ch, ch, 3, dtype=dtype)
        self.cv2 = ConvBNAct(ch, ch, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C2f(nn.Module):
    """1x1 conv, split in halves, ``n`` bottlenecks on the second half, every
    intermediate concatenated, 1x1 conv."""

    def __init__(self, in_ch: int, ch: int, n: int, shortcut: bool, dtype):
        super().__init__()
        self.n, self.h = n, ch // 2
        self.cv1 = ConvBNAct(in_ch, ch, 1, dtype=dtype)
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(self.h, shortcut, dtype))
        self.cv2 = ConvBNAct((2 + n) * self.h, ch, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        b = y[:, self.h :]
        outs = [y[:, : self.h], b]
        for i in range(self.n):
            b = getattr(self, f"m{i}")(b)
            outs.append(b)
        return self.cv2(torch.cat(outs, dim=1))


class SPPF(nn.Module):
    """1x1 conv, three chained 5x5 stride-1 max pools (padded with -inf),
    the four maps concatenated, 1x1 conv."""

    def __init__(self, in_ch: int, ch: int, dtype):
        super().__init__()
        self.cv1 = ConvBNAct(in_ch, ch // 2, 1, dtype=dtype)
        self.cv2 = ConvBNAct(4 * (ch // 2), ch, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [self.cv1(x)]
        for _ in range(3):
            outs.append(F.max_pool2d(outs[-1], 5, stride=1, padding=2))
        return self.cv2(torch.cat(outs, dim=1))


class YOLOv8(nn.Module):
    def __init__(self, cfg: YOLOConfig):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg, cfg.dtype
        ch, n = c.ch, c.n
        self.stem = ConvBNAct(3, ch(64), 3, 2, dt)
        self.down1 = ConvBNAct(ch(64), ch(128), 3, 2, dt)
        self.c2f1 = C2f(ch(128), ch(128), n(3), True, dt)
        self.down2 = ConvBNAct(ch(128), ch(256), 3, 2, dt)
        self.c2f2 = C2f(ch(256), ch(256), n(6), True, dt)  # /8
        self.down3 = ConvBNAct(ch(256), ch(512), 3, 2, dt)
        self.c2f3 = C2f(ch(512), ch(512), n(6), True, dt)  # /16
        self.down4 = ConvBNAct(ch(512), ch(1024), 3, 2, dt)
        self.c2f4 = C2f(ch(1024), ch(1024), n(3), True, dt)
        self.sppf = SPPF(ch(1024), ch(1024), dt)  # /32
        self.fpn4 = C2f(ch(1024) + ch(512), ch(512), n(3), False, dt)
        self.fpn3 = C2f(ch(512) + ch(256), ch(256), n(3), False, dt)
        self.pd3 = ConvBNAct(ch(256), ch(256), 3, 2, dt)
        self.pan4 = C2f(ch(256) + ch(512), ch(512), n(3), False, dt)
        self.pd4 = ConvBNAct(ch(512), ch(512), 3, 2, dt)
        self.pan5 = C2f(ch(512) + ch(1024), ch(1024), n(3), False, dt)
        head_out = 4 * c.reg_max + c.num_classes
        for i, f in enumerate((ch(256), ch(512), ch(1024))):
            self.add_module(f"head{i}_1", ConvBNAct(f, f, 3, dtype=dt))
            self.add_module(f"head{i}_out", Conv(f, head_out, 1, dtype=torch.float32))

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        """(B, H, W, 3) float in [0, 1], H and W multiples of 32 -> the raw
        head maps of strides 8, 16, 32, each (B, h, w, 4 reg_max + nc)
        float32."""
        x = images.permute(0, 3, 1, 2).to(self.cfg.dtype)
        x = self.c2f1(self.down1(self.stem(x)))
        p3 = self.c2f2(self.down2(x))
        p4 = self.c2f3(self.down3(p3))
        p5 = self.sppf(self.c2f4(self.down4(p4)))

        def up(t):  # nearest 2x: output index i reads i // 2
            return F.interpolate(t, scale_factor=2, mode="nearest")

        f4 = self.fpn4(torch.cat([up(p5), p4], dim=1))
        f3 = self.fpn3(torch.cat([up(f4), p3], dim=1))
        n4 = self.pan4(torch.cat([self.pd3(f3), f4], dim=1))
        n5 = self.pan5(torch.cat([self.pd4(n4), p5], dim=1))
        outs = []
        for i, f in enumerate((f3, n4, n5)):
            h = getattr(self, f"head{i}_out")(getattr(self, f"head{i}_1")(f))
            outs.append(h.to(torch.float32).permute(0, 2, 3, 1))
        return outs


class Detections(NamedTuple):
    boxes: torch.Tensor  # (B, N, 4) xyxy pixels
    scores: torch.Tensor  # (B, N)
    classes: torch.Tensor  # (B, N) int32
    valid: torch.Tensor  # (B, N) bool


def decode_predictions(raw: Sequence[torch.Tensor], cfg: YOLOConfig,
                       image_hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw head maps -> (boxes xyxy (B, A, 4), class scores (B, A, nc)): the
    DFL expectation of each side's distance (softmax over ``reg_max`` bins)
    from the cell centre, in stride units, and sigmoid class scores."""
    boxes_all, scores_all = [], []
    for r in raw:
        B, h, w, _ = r.shape
        stride = image_hw[0] // h
        reg = r[..., : 4 * cfg.reg_max].reshape(B, h, w, 4, cfg.reg_max)
        bins = torch.arange(cfg.reg_max, dtype=torch.float32, device=r.device)
        dist = (torch.softmax(reg, dim=-1) * bins).sum(-1)  # (B, h, w, 4): l, t, r, b
        cy = (torch.arange(h, dtype=torch.float32, device=r.device) + 0.5)[None, :, None]
        cx = (torch.arange(w, dtype=torch.float32, device=r.device) + 0.5)[None, None, :]
        x1 = (cx - dist[..., 0]) * stride
        y1 = (cy - dist[..., 1]) * stride
        x2 = (cx + dist[..., 2]) * stride
        y2 = (cy + dist[..., 3]) * stride
        boxes_all.append(torch.stack([x1, y1, x2, y2], dim=-1).reshape(B, h * w, 4))
        scores_all.append(torch.sigmoid(r[..., 4 * cfg.reg_max :]).reshape(B, h * w, -1))
    return torch.cat(boxes_all, dim=1), torch.cat(scores_all, dim=1)


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) xyxy -> (..., N, N) IoU."""
    area = ((boxes[..., 2] - boxes[..., 0]).clamp_min(0)
            * (boxes[..., 3] - boxes[..., 1]).clamp_min(0))
    a, b = boxes[..., :, None, :], boxes[..., None, :, :]
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    return inter / (area[..., :, None] + area[..., None, :] - inter).clamp_min(1e-9)


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
              score_threshold: float, iou_threshold: float, max_det: int = 64):
    """Static-shape greedy NMS over the last axis, any leading batch axes:
    the top ``max_det`` candidates by score (ties to the lower index), one
    IoU matrix, then box i of the rank order is kept unless a kept,
    higher-ranked box of its class overlaps it above ``iou_threshold``.
    boxes (..., A, 4), scores (..., A), classes (..., A) -> (boxes, scores,
    classes int32, valid), each (..., max_det)."""
    top_scores, order = topk_lower_index(scores, max_det)
    top_boxes = boxes.gather(-2, order[..., None].expand(*order.shape, 4))
    top_classes = classes.gather(-1, order)
    higher = torch.ones(max_det, max_det, dtype=torch.bool, device=scores.device).tril(-1)
    suppress = ((_iou_matrix(top_boxes) > iou_threshold)
                & (top_classes[..., :, None] == top_classes[..., None, :]) & higher)
    keep = torch.ones_like(top_scores, dtype=torch.bool)
    for i in range(max_det):
        keep[..., i] = ~(suppress[..., i, :] & keep).any(-1)
    return top_boxes, top_scores, top_classes.to(torch.int32), keep & (top_scores > score_threshold)


class YOLODetector:
    """Batched detector: uint8 BGR images -> :class:`Detections` in the
    images' own pixel coordinates, on the device."""

    def __init__(self, cfg: YOLOConfig | None = None, input_size=(544, 736), seed: int = 0,
                 device="cuda"):
        self.cfg = cfg or YOLOConfig.nano()
        self.input_size = tuple(input_size)  # multiples of 32, close to 540x720
        self.device = torch.device(device)
        with torch.random.fork_rng(devices=[]):  # module construction leaves the global RNG be
            self.net = YOLOv8(self.cfg)
        flax_init_(self.net, torch.Generator().manual_seed(int(seed)))
        self.net.to(self.device).eval()

    @torch.no_grad()
    def detect(self, images) -> Detections:
        """(B, H, W, 3) uint8 BGR -> Detections, boxes clamped to the image
        (the DFL distances are unbounded)."""
        cfg = self.cfg
        imgs = torch.as_tensor(images, device=self.device)
        H, W = int(imgs.shape[1]), int(imgs.shape[2])
        ih, iw = self.input_size
        x = resize_nhwc(imgs.to(torch.float32).flip(-1) / 255.0, (ih, iw))
        boxes, cls_scores = decode_predictions(self.net(x), cfg, (ih, iw))
        best = cls_scores.amax(-1)
        cls = cls_scores.argmax(-1)  # the first of tied classes
        b, s, c, v = nms_fixed(boxes, best, cls, cfg.score_threshold, cfg.iou_threshold,
                               cfg.max_detections)
        b = b * torch.tensor([W / iw, H / ih, W / iw, H / ih], dtype=torch.float32,
                             device=self.device)
        hi = torch.tensor([W, H, W, H], dtype=torch.float32, device=self.device)
        return Detections(torch.minimum(b.clamp_min(0.0), hi), s, c, v)


@torch.no_grad()
def mask_dynamic_objects(images: torch.Tensor, boxes: torch.Tensor, classes: torch.Tensor,
                         valid: torch.Tensor, dynamic_classes: Tuple[int, ...] = DYNAMIC_COCO_CLASSES,
                         dilation: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero the pixels inside the dilated boxes of valid dynamic-class
    detections (the reference's bbox mask, dilation 10). images (B, H, W,
    C), boxes (B, N, 4) xyxy, classes and valid (B, N) -> (masked images,
    mask (B, H, W), True where dynamic). The union over boxes is the
    product of the per-box row and column indicators, (B, H, N) x (B, N,
    W): a count of covering boxes, exact in float32 up to 2^24 boxes."""
    B, H, W = images.shape[:3]
    dyn = torch.zeros_like(valid)
    for c in dynamic_classes:
        dyn = dyn | (classes == c)
    active = valid & dyn  # (B, N)
    ys = torch.arange(H, dtype=torch.float32, device=boxes.device)
    xs = torch.arange(W, dtype=torch.float32, device=boxes.device)
    x1, y1 = boxes[..., 0:1] - dilation, boxes[..., 1:2] - dilation
    x2, y2 = boxes[..., 2:3] + dilation, boxes[..., 3:4] + dilation
    in_y = (ys >= y1) & (ys <= y2) & active[..., None]  # (B, N, H)
    in_x = (xs >= x1) & (xs <= x2)  # (B, N, W)
    mask = torch.bmm(in_y.transpose(1, 2).to(torch.float32), in_x.to(torch.float32)) > 0
    return images.masked_fill(mask[..., None], 0), mask


class DynamicObjectFilter:
    """Detector and masker with filtering statistics (they feed
    ``eval.semantic_eval.DynamicFilteringMetrics``)."""

    def __init__(self, detector: YOLODetector | None = None, dilation: int = 10):
        self.detector = detector or YOLODetector()
        self.dilation = dilation
        self.total_frames = 0
        self.frames_with_dynamic = 0
        self.pixels_masked = 0
        self.pixels_total = 0

    @torch.no_grad()
    def filter_batch(self, images):
        """uint8 BGR (B, H, W, 3) -> (masked images, mask (B, H, W),
        Detections), tensors on the detector's device."""
        imgs = torch.as_tensor(images, device=self.detector.device)
        det = self.detector.detect(imgs)
        masked, mask = mask_dynamic_objects(imgs, det.boxes, det.classes, det.valid,
                                            dilation=self.dilation)
        frames, pixels = torch.stack([mask.any(2).any(1).sum(), mask.sum()]).tolist()
        self.total_frames += int(imgs.shape[0])
        self.frames_with_dynamic += int(frames)
        self.pixels_masked += int(pixels)
        self.pixels_total += int(mask.numel())
        return masked, mask, det

    def get_metrics(self):
        from mlis_tpu_torch.eval.semantic_eval import DynamicFilteringMetrics

        return DynamicFilteringMetrics(
            total_frames=self.total_frames,
            frames_with_dynamic_objects=self.frames_with_dynamic,
            total_features_extracted=self.pixels_total,
            features_filtered=self.pixels_masked,
        )
