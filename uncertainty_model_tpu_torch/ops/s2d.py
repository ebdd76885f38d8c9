"""Space-to-depth (s2d) rewrites of the serving encoder's early stages (the
port's copy of the JAX package's ``ops/s2d.py``).

For a zero-pad SAME stride-1 conv with odd kernel k, pad p = (k-1)/2,

    y[2m+a, 2n+b, co] = sum_{u,v,ci} w[u,v,ci,co] * x[2m+a-p+u, 2n+b-p+v, ci]

and the s2d input X[q, t, (c,d,ci)] = x[2q+c, 2t+d, ci] turn it into a
stride-1 SAME conv on the half-resolution grid with

    W'[R,S,(c,d,ci),(a,b,co)] = w[2(R-P)+c+p-a, 2(S-P)+d+p-b, ci, co]

(zero where the index leaves [0, k)), P = (p+1)//2, k' = 2P+1: k=7 becomes
5x5 and k=5 becomes 3x3, with four times the channels on each side.  The
transforms are exact rearrangements of the kernel; the functions take and
return HWIO kernels (k, k, Cin, Cout) as the JAX ones do, and the serving
build permutes them to PyTorch's OIHW where ``F.conv2d`` runs them.

Channel order is phase-major: s2d channel ``(c*2 + d) * C + ci``.  The
tensor functions take NHWC; the port's channels_last NCHW tensors pass
through ``permute(0, 2, 3, 1)`` (a free view) and back.
"""

from __future__ import annotations

import torch


def space_to_depth(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/r, W/r, r*r*C), channel ((c*r + d) * C + ci)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // r, w // r, r * r * c)


def depth_to_space(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    b, h, w, c4 = x.shape
    c = c4 // (r * r)
    x = x.reshape(b, h, w, r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * r, w * r, c)


def _gather_taps(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``w`` (k, k, ...) read at rows u[..] and columns u[..] (an index
    table over (k', 2)), zero where an index leaves [0, k):
    returns (k', 2, k', 2, ...)."""
    k = w.shape[0]
    u = u.to(w.device)
    valid = (u >= 0) & (u < k)
    uc = u.clamp(0, k - 1)
    zero = w.new_zeros(())
    rows = torch.where(valid.reshape(*valid.shape, *([1] * (w.ndim - 1))),
                       w[uc], zero)
    mask = valid.reshape(1, 1, *valid.shape, *([1] * (w.ndim - 2)))
    return torch.where(mask, rows[:, :, uc], zero)


def s2d_conv_kernel(w: torch.Tensor) -> torch.Tensor:
    """(k, k, Cin, Cout) SAME stride-1 kernel -> its (k', k', 4Cin, 4Cout)
    space-to-depth form (see the module docstring)."""
    k, _, cin, cout = w.shape
    p = (k - 1) // 2
    big_p = (p + 1) // 2
    kp = 2 * big_p + 1
    # u[R, c, a] = 2*(R-P) + c + p - a: index over (R, c, a) -> (kp, 4)
    grid_r = torch.arange(kp)[:, None, None]
    grid_c = torch.arange(2)[None, :, None]
    grid_a = torch.arange(2)[None, None, :]
    u = (2 * (grid_r - big_p) + grid_c + p - grid_a).reshape(kp, 4)
    t = _gather_taps(w, u)                       # (R, (c,a), S, (d,b), ci, co)
    t = t.reshape(kp, 2, 2, kp, 2, 2, cin, cout)  # (R, c, a, S, d, b, ci, co)
    t = t.permute(0, 3, 1, 4, 6, 2, 5, 7)         # (R, S, c, d, ci, a, b, co)
    return t.reshape(kp, kp, 4 * cin, 4 * cout)


def s2d_bias(bias: torch.Tensor) -> torch.Tensor:
    """Per-channel vector -> its phase-major s2d counterpart."""
    return bias.repeat(4)


def s2d_out_stride2_conv_kernel(w: torch.Tensor):
    """A stride-2 SAME kernel (odd k, pad p) -> the stride-4 kernel that
    writes the output directly in s2d form: W'[u',v',ci,(a,b,c)] =
    w[u'-2a, v'-2b, ci, c], k' = k+2, padding (p, p-1) on each axis (the
    extra trailing tap is never read).  ``F.conv2d`` takes no asymmetric
    padding: pad with ``F.pad`` first.

    Returns ``(kernel (k+2, k+2, Cin, 4Cout), stride 4, padding (p, p-1))``.
    """
    k, _, cin, cout = w.shape
    p = (k - 1) // 2
    kp = k + 2
    u = torch.arange(kp)[:, None] - 2 * torch.arange(2)[None, :]  # (kp, 2)
    t = _gather_taps(w, u)                  # (u', a, v', b, ci, co)
    t = t.permute(0, 2, 4, 1, 3, 5)          # (u', v', ci, a, b, co)
    return t.reshape(kp, kp, cin, 4 * cout), 4, (p, p - 1)


def s2d_in_stride2_conv_kernel(w: torch.Tensor):
    """A stride-2 SAME kernel with EVEN pad p (k = 5, 9, ...) -> the
    stride-1 kernel that reads s2d input and writes the native output:
    k' = p+1 taps per axis, pad p/2.

    Returns ``(kernel (k', k', 4Cin, Cout), stride 1, padding (p/2, p/2))``.
    """
    k, _, cin, cout = w.shape
    p = (k - 1) // 2
    if p % 2:
        raise ValueError(f"the s2d-input transform needs an even pad, not "
                         f"{p} (k={k})")
    kp = p + 1
    u = (2 * (torch.arange(kp)[:, None] - p // 2) + torch.arange(2)[None, :]
         + p)                                # (rho, q)
    t = _gather_taps(w, u)                  # (rho, q, sigma, d, ci, co)
    t = t.permute(0, 2, 1, 3, 4, 5)          # (rho, sigma, q, d, ci, co)
    return t.reshape(kp, kp, 4 * cin, cout), 1, (p // 2, p // 2)


def block_diag_1x1_kernel(w: torch.Tensor) -> torch.Tensor:
    """(1, 1, Cin, Cout) kernel -> its block-diagonal s2d form
    (1, 1, 4Cin, 4Cout): a 1x1 conv acts on each phase block alone."""
    cin, cout = w.shape[2], w.shape[3]
    eye = torch.eye(4, dtype=w.dtype, device=w.device)
    big = torch.einsum("pq,io->piqo", eye, w[0, 0])
    return big.reshape(1, 1, 4 * cin, 4 * cout)
