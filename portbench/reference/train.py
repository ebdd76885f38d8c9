"""The self-supervised training step written plainly, in float32.

Monodepth-style stereo losses with the uncertainty head supervised by the
reprojection error (the reference repository's ``TukraUncertaintyLoss``
without the discriminator), and Adam written out:

* the 4-scale pyramid of the stereo pair by align-corners resizes;
* the train-mode forward of ``model.py`` (BatchNorm on the batch);
* each view reconstructed from the other by ``F.grid_sample`` (bilinear,
  zeros padding, ``align_corners=False``) over a grid that shifts x by the
  disparity, and each disparity map from the other view's the same way
  (left-right consistency);
* per scale: weighted SSIM + L1 reconstruction error, L1 consistency,
  edge-aware smoothness over ``2**scale``, and the uncertainty loss (L1 to
  the detached reconstruction error, plus the uncertainty's own warp
  consistency against the disparity, with the reference's weights);
* ``disp_loss + error_loss`` backward, then Adam (bias-corrected moments,
  eps after the square root).

Everything is NCHW.  It imports nothing but torch and ``model.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import model as ref_model

K1 = 0.01 ** 2
K2 = 0.03 ** 2


def absolute(x):
    """|x| with the gradient +1 at 0."""
    return torch.where(x >= 0, x, -x)


def l1(x, y):
    return absolute(x - y).mean()


def pyramid(left, right, scales):
    """NCHW (B, 6, H/2^i, W/2^i) of the NHWC pair, finest first."""
    images = torch.cat([left, right], -1).permute(0, 3, 1, 2).float()
    h, w = images.shape[2:]
    return [ref_model.resize(images, (h >> i, w >> i)) for i in range(scales)]


def warp(source, shift):
    """``source`` (B, C, H, W) sampled at x + ``shift`` (B, H, W, in
    image widths)."""
    b, _, h, w = source.shape
    ys = torch.linspace(0.0, 1.0, h, device=source.device)
    xs = torch.linspace(0.0, 1.0, w, device=source.device)
    gx = 2.0 * (xs[None, None, :] + shift) - 1.0
    gy = (2.0 * ys - 1.0)[None, :, None].expand(b, h, w)
    grid = torch.stack([gx, gy], dim=-1)
    return F.grid_sample(source, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def wssim_error(images, recon, alpha):
    """Per-pixel alpha * DSSIM + (1 - alpha) * L1, averaged per view:
    (B, 2, H, W)."""
    h, w = images.shape[2:]
    l1_err = absolute(images - recon)
    x, y = images, recon
    mu_x, mu_y = F.avg_pool2d(x, 3, 1), F.avg_pool2d(y, 3, 1)
    sigma_x = F.avg_pool2d(x * x, 3, 1) - mu_x * mu_x
    sigma_y = F.avg_pool2d(y * y, 3, 1) - mu_y * mu_y
    sigma_xy = F.avg_pool2d(x * y, 3, 1) - mu_x * mu_y
    ssim = ((2 * mu_x * mu_y + K1) * (2 * sigma_xy + K2)) / (
        (mu_x * mu_x + mu_y * mu_y + K1) * (sigma_x + sigma_y + K2))
    ssim_err = ref_model.resize(torch.clamp((1 - ssim) / 2, 0.0, 1.0), (h, w))
    total = alpha * ssim_err + (1 - alpha) * l1_err
    return torch.cat([total[:, 0:3].mean(1, keepdim=True),
                      total[:, 3:6].mean(1, keepdim=True)], 1)


def _grad_x(t):
    d = t[..., :, :-1] - t[..., :, 1:]
    return torch.cat([d, torch.zeros_like(t[..., :, :1])], -1)


def _grad_y(t):
    d = t[..., :-1, :] - t[..., 1:, :]
    return torch.cat([d, torch.zeros_like(t[..., :1, :])], -2)


def smoothness(disp, images):
    """Edge-aware smoothness of a 2-channel map against the stereo
    images (each view against its own half of the channels)."""
    half = images.shape[1] // 2
    total = 0.0
    for v in range(2):
        d = disp[:, v:v + 1]
        img = images[:, v * half:(v + 1) * half]
        wx = torch.exp(-_grad_x(img).abs().mean(1, keepdim=True))
        wy = torch.exp(-_grad_y(img).abs().mean(1, keepdim=True))
        total = total + absolute(_grad_x(d) * wx) + absolute(_grad_y(d) * wy)
    return total.mean()


def losses(images_pyr, disps, loss: dict):
    """``(disp_loss, error_loss)`` of the NCHW pyramid and the model's
    4-channel maps, finest first."""
    err_cfg = loss.get("error_loss_config") or {}
    if err_cfg.get("loss_type", "l1") != "l1" or err_cfg.get("pooling"):
        raise NotImplementedError("the reference writes the l1, unpooled "
                                  "uncertainty loss")
    reproj = consist = smooth = err_total = 0.0
    for i, (images, pred) in enumerate(zip(images_pyr, disps)):
        d_l, d_r = pred[:, 0:1], pred[:, 1:2]
        shift_l, shift_r = -pred[:, 0], pred[:, 1]
        recon = torch.cat([warp(images[:, 3:6], shift_l),
                           warp(images[:, 0:3], shift_r)], 1)
        lr_l, lr_r = warp(d_r, shift_l), warp(d_l, shift_r)
        error = wssim_error(images, recon, loss["wssim_alpha"])
        reproj = reproj + (error[:, 0] + error[:, 1]).mean()
        consist = consist + l1(d_l, lr_l) + l1(d_r, lr_r)
        smooth = smooth + smoothness(pred[:, 0:2], images) / 2 ** i
        unc = pred[:, 2:4]
        e = l1(unc, error.detach())
        sw = err_cfg.get("smoothness_weight", 1.0)
        if sw > 0:
            e = e + sw * smoothness(unc, images)
        cw = err_cfg.get("consistency_weight", 1.0)
        if cw > 0:
            u_l, u_r = unc[:, 0:1], unc[:, 1:2]
            e = e + cw * (l1(u_l, warp(d_r, -unc[:, 0]))
                          + l1(u_r, warp(d_l, unc[:, 1])))
        err_total = err_total + e
    disp_loss = (reproj * loss["wssim_weight"]
                 + consist * loss["consistency_weight"]
                 + smooth * loss["smoothness_weight"])
    return disp_loss, err_total * loss["predictive_error_weight"]


class Adam:
    """Adam with bias-corrected moments; eps after the square root."""

    def __init__(self, params: dict, betas=(0.9, 0.999), eps=1e-8):
        self.b1, self.b2 = betas
        self.eps = eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            p.sub_(lr * (self.m[k] / c1) / denom)


def train_steps(params: dict, model: dict, graphs, loss: dict, batches,
                lr: float, disp_scale: float, scales: int = 4, prec=None,
                betas=(0.9, 0.999), eps=1e-8) -> dict:
    """Adam steps of the whole model from ``params`` (updated in place: the
    trainable tensors, those that are not BatchNorm statistics), one a
    batch of ``batches`` (``(left, right)`` NHWC pairs).  Returns
    ``losses`` [(disp_loss, error_loss) a step], ``first_grad`` (each
    trainable key's gradient of step 1) and ``start`` (a copy of the
    trainable tensors before step 1)."""
    trainable = {k: v for k, v in params.items()
                 if not k.endswith(("running_mean", "running_var",
                                    "num_batches_tracked"))}
    start = {k: v.detach().clone() for k, v in trainable.items()}
    opt = Adam(trainable, betas, eps)
    out = {"losses": [], "first_grad": None, "start": start}
    for left, right in batches:
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in trainable.items()}
        full = {**params, **leaves}
        images = pyramid(left, right, scales)
        disps = ref_model.forward(full, model, graphs, images[0][:, 0:3],
                                  train=True, prec=prec,
                                  disp_scale=disp_scale)
        disp_loss, err_loss = losses(images, disps, loss)
        grads = torch.autograd.grad(disp_loss + err_loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: (torch.zeros_like(v) if g is None else g)
                 for (k, v), g in zip(leaves.items(), grads)}
        out["losses"].append((disp_loss.item(), err_loss.item()))
        if out["first_grad"] is None:
            out["first_grad"] = {k: g.detach().clone()
                                 for k, g in grads.items()}
        opt.step(trainable, grads, lr)
        del leaves, full, images, disps, disp_loss, err_loss, grads
    return out
