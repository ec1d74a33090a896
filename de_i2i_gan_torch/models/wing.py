"""FAN, the face-alignment network ('wing'); counterpart of
``de_i2i_gan_tpu/models/wing.py``.

Mirrors stargan-v2/core/wing.py:
  CoordConv      (:131-148)  coordinate (x, y, radius) channels, then a conv
  WingConvBlock  (:151-188)  pre-activation BN block, 1/2 + 1/4 + 1/4 concat
  HourGlass      (:49-89)    the depth-4 recursion, unrolled
  FAN            (:190-246)  stem + one hourglass + heatmap head (98 + 1)
  preprocess_heatmaps (:494-539)  threshold / normalize / shift -> the two
                                  high-pass masks the generator takes
  WingHeatmapper  get_heatmap (:248-261) and the argmax landmarks
  FaceAligner     offline alignment on the host (numpy / scipy)

The modules work in NCHW float32; the heatmapper takes and returns NHWC, as
the JAX package's does. FAN always runs frozen, its BatchNorm on the stored
statistics (eps 1e-5). Its parameter names are the reference checkpoint's
(``load_torch_wing_weights`` copies ``wing.ckpt``; ``downsample.0`` and
``.2`` are ``down_bn`` and ``down_conv``) and their paths the flax tree's
(``train/jax_import.py::load_jax_fan``). In FAN's one hourglass the
coordinate conv gets no boundary heatmap (num_modules=1), so the boundary
channels of the reference's later modules do not exist here, nor in the JAX
package.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from de_i2i_gan_torch.models.vit import resize_bilinear
from de_i2i_gan_torch.nn.blocks import BatchNorm
from de_i2i_gan_torch.nn.layers import Conv2d, avg_pool, upsample_nearest


def _coords(height: int, width: int, with_r: bool) -> np.ndarray:
    """(2 or 3, H, W): row and column in [-1, 1], and the radius / its max."""
    x = np.arange(height, dtype=np.float32)[:, None] * np.ones(
        (1, width), np.float32)
    y = np.ones((height, 1), np.float32) * np.arange(
        width, dtype=np.float32)[None, :]
    x = x / (height - 1) * 2 - 1
    y = y / (width - 1) * 2 - 1
    chans = [x, y]
    if with_r:
        rr = np.sqrt(x ** 2 + y ** 2)
        chans.append(rr / rr.max())
    return np.stack(chans, axis=0)


class CoordConv(nn.Module):
    """JAX :42: x with its coordinate channels, then ``conv``; also returns
    the last two of those channels, as the reference does."""

    def __init__(self, in_features: int, features: int, kernel: int = 1,
                 stride: int = 1, padding: int = 0, with_r: bool = False):
        super().__init__()
        self.with_r = with_r
        self.conv = Conv2d(in_features + (3 if with_r else 2), features,
                           kernel, stride, padding, use_bias=True)
        self._coords = {}  # (h, w, device) -> the channels, made once

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        n, _, h, w = x.shape
        key = (h, w, x.device)
        if key not in self._coords:
            self._coords[key] = torch.from_numpy(
                _coords(h, w, self.with_r)).to(x.device)
        ret = torch.cat([x, self._coords[key].to(x.dtype).expand(n, -1, -1, -1)],
                        dim=1)
        return self.conv(ret), ret[:, -2:]


class WingConvBlock(nn.Module):
    """JAX :75."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        f = features
        self.bn1 = BatchNorm(in_features)
        self.conv1 = Conv2d(in_features, f // 2, 3, padding=1)
        self.bn2 = BatchNorm(f // 2)
        self.conv2 = Conv2d(f // 2, f // 4, 3, padding=1)
        self.bn3 = BatchNorm(f // 4)
        self.conv3 = Conv2d(f // 4, f // 4, 3, padding=1)
        if in_features != f:
            self.down_bn = BatchNorm(in_features)
            self.down_conv = Conv2d(in_features, f, 1)
        else:
            self.down_bn = self.down_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        o1 = self.conv1(F.relu(self.bn1(x)))
        o2 = self.conv2(F.relu(self.bn2(o1)))
        o3 = self.conv3(F.relu(self.bn3(o2)))
        residual = x
        if self.down_conv is not None:
            residual = self.down_conv(F.relu(self.down_bn(x)))
        return torch.cat([o1, o2, o3], dim=1) + residual


class HourGlass(nn.Module):
    """JAX :112: the depth-4 recursion as down and up loops."""

    def __init__(self, depth: int = 4, features: int = 256):
        super().__init__()
        self.depth = depth
        self.coordconv = CoordConv(features, features, with_r=True)
        for level in range(depth, 0, -1):
            setattr(self, f"b1_{level}", WingConvBlock(features, features))
            setattr(self, f"b2_{level}", WingConvBlock(features, features))
        self.b2_plus_1 = WingConvBlock(features, features)
        for level in range(1, depth + 1):
            setattr(self, f"b3_{level}", WingConvBlock(features, features))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x, last_channel = self.coordconv(x)
        ups, inp = {}, x
        for level in range(self.depth, 0, -1):
            ups[level] = getattr(self, f"b1_{level}")(inp)
            inp = getattr(self, f"b2_{level}")(avg_pool(inp))
        out = self.b2_plus_1(inp)
        for level in range(1, self.depth + 1):
            out = upsample_nearest(getattr(self, f"b3_{level}")(out))
            out = ups[level] + out
        return out, last_channel


class FAN(nn.Module):
    """JAX :140 (num_modules=1, as the reference uses). ``forward(x)``: NCHW
    images in [0, 1] -> (heatmaps (N, num_landmarks + 1, H/4, W/4), the
    hourglass's last two coordinate channels)."""

    def __init__(self, num_landmarks: int = 98, end_relu: bool = False):
        super().__init__()
        self.end_relu = end_relu
        self.conv1 = CoordConv(3, 64, kernel=7, stride=2, padding=3,
                               with_r=True)
        self.bn1 = BatchNorm(64)
        self.conv2 = WingConvBlock(64, 128)
        self.conv3 = WingConvBlock(128, 128)
        self.conv4 = WingConvBlock(128, 256)
        self.m0 = HourGlass(4, 256)
        self.top_m_0 = WingConvBlock(256, 256)
        self.conv_last0 = Conv2d(256, 256, 1, use_bias=True)
        self.bn_end0 = BatchNorm(256)
        self.l0 = Conv2d(256, num_landmarks + 1, 1, use_bias=True)
        self.eval()

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x, _ = self.conv1(x)
        x = F.relu(self.bn1(x))
        x = self.conv4(self.conv3(avg_pool(self.conv2(x))))
        ll, boundary = self.m0(x)
        ll = self.conv_last0(self.top_m_0(ll))
        out = self.l0(F.relu(self.bn_end0(ll)))
        if self.end_relu:
            out = F.relu(out)
        return out, boundary


@torch.no_grad()
def init_fan_weights(fan: FAN, generator: torch.Generator) -> FAN:
    """The flax init's scales from ``generator`` (on the FAN's device): conv
    kernels normal with std 1/sqrt(fan_in) (lecun), biases zero, BatchNorm
    scale 1, bias 0, statistics (0, 1)."""
    for mod in fan.modules():
        if isinstance(mod, Conv2d):
            w = mod.weight
            w.copy_(torch.randn(w.shape, generator=generator, device=w.device)
                    / math.sqrt(w[0].numel()))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    return fan


# ------------------------------------------------------------ heatmap post
_INDEX_MAP = {
    "chin": (8, 25), "eyebrows": (33, 51), "eyebrowsedges": (33, 46),
    "nose": (51, 55), "nostrils": (55, 60), "eyes": (60, 76),
    "lipedges": (76, 82), "lipupper": (77, 82), "liplower": (83, 88),
    "lipinner": (88, 96),
}


def _normalize01(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    n, h, w, c = x.shape
    flat = x.reshape(n, h * w, c)
    mx = flat.amax(dim=1, keepdim=True)
    mn = flat.amin(dim=1, keepdim=True)
    return ((flat - mn) / (mx - mn + eps)).reshape(n, h, w, c)


def _shift_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """The rows of NHWC x rolled up by n (down for n < 0; wing.py:459-477)."""
    return x if n == 0 else torch.roll(x, -n, dims=1)


def preprocess_heatmaps(hm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """98-channel NHWC landmark heatmaps -> the two high-pass masks
    (N, H, W, 1) (wing.py:494-539, JAX :197)."""
    sw = hm.shape[1] // 256
    x = _normalize01(torch.where(hm < 0.1, torch.zeros_like(hm), hm))
    ops = {"chin": (0, 3), "eyebrows": (-7 * sw, 2), "nostrils": (8 * sw, 4),
           "lipupper": (-8 * sw, 4), "liplower": (8 * sw, 4),
           "lipinner": (-2 * sw, 3)}
    for part, (shift, power) in ops.items():
        s, e = _INDEX_MAP[part]
        x[..., s:e] = _shift_rows(x[..., s:e], shift) ** power
    # channels 0-7, 25-32, and the eyebrow and lip edges, by slices and
    # single indices (no index tensor to copy to the device)
    x[..., :_INDEX_MAP["chin"][0]] = 0.0
    x[..., _INDEX_MAP["chin"][1]:33] = 0.0
    for c in (*_INDEX_MAP["eyebrowsedges"], *_INDEX_MAP["lipedges"]):
        x[..., c] = 0.0
    s, e = _INDEX_MAP["nose"]
    x[..., s + 1:e] = _shift_rows(x[..., s + 1:e], 4 * sw)
    s, e = _INDEX_MAP["eyes"]
    x[..., s:e] = (_shift_rows(x[..., s:e], -8) ** 3
                   + _shift_rows(x[..., s:e], -24))

    x2 = x.clone()
    for part in ("chin", "eyebrows"):
        s, e = _INDEX_MAP[part]
        x2[..., s:e] = 0.0
    x2[..., _INDEX_MAP["lipedges"][0]:_INDEX_MAP["lipinner"][1]] = 0.0
    m1 = torch.nan_to_num(x.sum(dim=-1, keepdim=True))
    m2 = torch.nan_to_num(x2.sum(dim=-1, keepdim=True))
    return m1.clamp(0, 1), m2.clamp(0, 1)


def landmark_heatmaps(fan: FAN, x: torch.Tensor) -> torch.Tensor:
    """FAN's 98 landmark heatmaps, NHWC (N, 64, 64, 98), of NHWC images in
    [-1, 1] resized to 256^2 first."""
    x01 = resize_bilinear(x.permute(0, 3, 1, 2).float(), 256) * 0.5 + 0.5
    out, _ = fan(x01)
    return out[:, :-1].permute(0, 2, 3, 1)  # the boundary channel dropped


@torch.no_grad()
def fan_masks(fan: FAN, x: torch.Tensor) -> List[torch.Tensor]:
    """get_heatmap (wing.py:248-261): the two NHWC (N, 256, 256, 1) masks
    of NHWC images in [-1, 1], without gradients."""
    hm = landmark_heatmaps(fan, x).permute(0, 3, 1, 2)
    hm = resize_bilinear(hm, 256).permute(0, 2, 3, 1)
    return list(preprocess_heatmaps(hm))


class WingHeatmapper:
    """JAX :235: the frozen FAN -> the generator's masks, and landmarks."""

    def __init__(self, fan: FAN, img_size: int = 256):
        self.fan = fan.eval().requires_grad_(False)
        self.img_size = img_size
        self.device = fan.l0.weight.device

    def get_heatmap(self, x) -> List[torch.Tensor]:
        return fan_masks(self.fan, torch.as_tensor(x, device=self.device))

    @torch.no_grad()
    def get_landmarks(self, x) -> np.ndarray:
        """Argmax landmarks (N, 98, 2) as (x, y) in the input's pixels
        (wing.py:27-46, on the host)."""
        x = torch.as_tensor(x, device=self.device)
        hm = landmark_heatmaps(self.fan, x).float().cpu().numpy()
        nb, h, w, c = hm.shape
        idx = hm.reshape(nb, h * w, c).argmax(axis=1)
        ys, xs = np.divmod(idx, w)
        preds = np.stack([xs, ys], axis=-1).astype(np.float32) + 0.5
        return preds * (x.shape[1] // h)


class FaceAligner:
    """Offline face alignment (JAX :272; wing.py FaceAligner and the align
    helpers :324-420): rotate, scale and translate each face so that its eye
    and mouth landmarks match the CelebA mean landmarks. On the host with
    numpy and scipy; the warp is ``scipy.ndimage.affine_transform`` in place
    of cv2.warpPerspective (the composed transform is affine)."""

    def __init__(self, heatmapper: WingHeatmapper, celeba_mean_path: str,
                 output_size: int = 256):
        self.hm = heatmapper
        mean = np.load(celeba_mean_path)
        self.ref = np.float32(mean["mean"]) * (output_size // 256)
        self.output_size = output_size
        self.xaxis_ref = _landmarks2xaxis(self.ref)

    def _matrix(self, landmarks: np.ndarray) -> np.ndarray:
        t_origin = np.eye(3)
        t_origin[:2, 2] = -landmarks.mean(axis=0)
        xaxis_src = _landmarks2xaxis(landmarks)
        vx = xaxis_src / np.linalg.norm(xaxis_src)
        vy = self.xaxis_ref / np.linalg.norm(self.xaxis_ref)
        c = float(np.dot(vx, vy))
        cross = vx[0] * vy[1] - vx[1] * vy[0]
        s = float(np.sqrt(max(0.0, 1 - c * c)) * np.sign(cross))
        rot = np.asarray(((c, -s, 0), (s, c, 0), (0, 0, 1)))
        scale = np.eye(3)
        scale[0, 0] = scale[1, 1] = _landmarks2scale(landmarks, self.ref)
        t_ref = np.eye(3)
        t_ref[:2, 2] = self.ref.mean(axis=0)
        return t_ref @ scale @ rot @ t_origin

    def align(self, imgs: np.ndarray) -> np.ndarray:
        """imgs: (N, H, W, 3) in [-1, 1] -> the aligned images, same shape."""
        from scipy import ndimage
        lms = self.hm.get_landmarks(np.asarray(imgs, np.float32))
        out = np.empty_like(imgs)
        s = self.output_size
        for i, (img, lm) in enumerate(zip(imgs, lms)):
            inv = np.linalg.inv(self._matrix(lm.astype(np.float32)))
            # scipy maps output to input coordinates by (matrix, offset);
            # the image axes are (y, x), so the 2x2 block is swapped
            a = np.asarray([[inv[1, 1], inv[1, 0]], [inv[0, 1], inv[0, 0]]])
            off = np.asarray([inv[1, 2], inv[0, 2]])
            out[i] = np.stack([
                ndimage.affine_transform(img[..., c], a, offset=off,
                                         output_shape=(s, s), order=1,
                                         mode="reflect")
                for c in range(img.shape[-1])], axis=-1)
        return out


def _landmarks2eyes(lm):
    left = lm[np.asarray(list(range(60, 68)) + [96])]
    right = lm[np.asarray(list(range(68, 76)) + [97])]
    return left.mean(axis=0), right.mean(axis=0)


def _landmarks2xaxis(lm):
    eye_l, eye_r = _landmarks2eyes(lm)
    mouth_l, mouth_r = lm[76], lm[82]
    xp = eye_r - eye_l
    yp = (eye_l + eye_r) * 0.5 - (mouth_l + mouth_r) * 0.5
    rot90 = np.asarray([yp[1], -yp[0]])
    xaxis = xp - rot90
    return xaxis / np.linalg.norm(xaxis)


def _landmarks2scale(x, y):
    xv = x - x.mean(axis=0)
    yv = y - y.mean(axis=0)
    idx = [96, 97, 76, 82]
    return float((np.linalg.norm(yv, axis=1) /
                  np.maximum(np.linalg.norm(xv, axis=1), 1e-8))[idx].mean())


@torch.no_grad()
def load_torch_wing_weights(path, fan: FAN) -> FAN:
    """Fill ``fan`` from the reference's ``wing.ckpt`` (JAX :348): torch's
    layouts, so each tensor copies as it is, under the reference's name
    (``downsample.0`` / ``.2`` for ``down_bn`` / ``down_conv``, which also
    covers ``m0.b2_plus_1``). Every tensor of ``fan`` must be found;
    BatchNorm's ``num_batches_tracked`` is not used."""
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    own = fan.state_dict()
    names = {k: k.replace("down_bn", "downsample.0")
             .replace("down_conv", "downsample.2") for k in own}
    missing = sorted(v for v in names.values() if v not in sd)
    if missing:
        raise KeyError(f"wing checkpoint: missing {missing[:8]}")
    for mine, theirs in names.items():
        if tuple(sd[theirs].shape) != tuple(own[mine].shape):
            raise ValueError(f"{theirs}: shape {tuple(sd[theirs].shape)} "
                             f"does not fit {mine}")
        own[mine].copy_(sd[theirs].to(own[mine].dtype))
    return fan


def wing_state_dict(fan: FAN) -> dict:
    """``fan``'s tensors under the reference checkpoint's names (the inverse
    of ``load_torch_wing_weights``), on the CPU."""
    return {k.replace("down_bn", "downsample.0").replace(
        "down_conv", "downsample.2"): v.detach().cpu().clone()
        for k, v in fan.state_dict().items()}


def make_fan(device, seed: int = 0, wing_ckpt: Optional[str] = None) -> FAN:
    """A frozen FAN on ``device``: weights drawn from ``seed``, or the
    reference's checkpoint when given."""
    fan = FAN().to(device)
    init_fan_weights(fan, torch.Generator(device).manual_seed(seed))
    if wing_ckpt is not None:
        load_torch_wing_weights(wing_ckpt, fan)
    return fan.eval().requires_grad_(False)
