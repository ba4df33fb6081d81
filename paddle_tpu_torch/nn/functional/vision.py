"""Vision functionals.

Counterpart: paddle_tpu/nn/functional/vision.py, all of it:
`pixel_shuffle` / `pixel_unshuffle` / `channel_shuffle` (NCHW and
NHWC, by the reference's reshapes), `affine_grid` (the base grid in
float64, as the reference's, then the input's dtype) and `grid_sample`
(bilinear or nearest, NCHW; padding "zeros", any other mode clamps to
the border). Both default to `align_corners=True`, as the reference's.
"""
import torch

__all__ = ["pixel_shuffle", "pixel_unshuffle", "channel_shuffle",
           "affine_grid", "grid_sample"]


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        N, C, H, W = x.shape
        oc = C // (r * r)
        out = x.reshape(N, oc, r, r, H, W).permute(0, 1, 4, 2, 5, 3)
        return out.reshape(N, oc, H * r, W * r)
    N, H, W, C = x.shape
    oc = C // (r * r)
    out = x.reshape(N, H, W, r, r, oc).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(N, H * r, W * r, oc)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor
    if data_format == "NCHW":
        N, C, H, W = x.shape
        out = x.reshape(N, C, H // r, r, W // r, r).permute(0, 1, 3, 5, 2, 4)
        return out.reshape(N, C * r * r, H // r, W // r)
    N, H, W, C = x.shape
    out = x.reshape(N, H // r, r, W // r, r, C).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(N, H // r, W // r, C * r * r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    if data_format == "NCHW":
        N, C, H, W = x.shape
        out = x.reshape(N, groups, C // groups, H, W).transpose(1, 2)
        return out.reshape(N, C, H, W)
    N, H, W, C = x.shape
    out = x.reshape(N, H, W, groups, C // groups).transpose(3, 4)
    return out.reshape(N, H, W, C)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()
    N, C, H, W = [int(v) for v in out_shape]
    kw = dict(dtype=torch.float64, device=theta.device)
    if align_corners:
        ys = torch.linspace(-1.0, 1.0, H, **kw)
        xs = torch.linspace(-1.0, 1.0, W, **kw)
    else:
        ys = (torch.arange(H, **kw) * 2 + 1) / H - 1
        xs = (torch.arange(W, **kw) * 2 + 1) / W - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # H, W, 3
    out = torch.einsum("hwk,nik->nhwi", base,
                       theta.float().to(torch.float64))
    return out.to(theta.dtype)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    N, C, H, W = x.shape
    gx, gy = grid[..., 0].float(), grid[..., 1].float()
    if align_corners:
        fx = (gx + 1) * (W - 1) / 2
        fy = (gy + 1) * (H - 1) / 2
    else:
        fx = ((gx + 1) * W - 1) / 2
        fy = ((gy + 1) * H - 1) / 2
    batch = torch.arange(N, device=x.device)[:, None, None]
    planes = x.permute(0, 2, 3, 1)  # N, H, W, C

    def sample(ix, iy):
        vals = planes[batch, iy.clamp(0, H - 1), ix.clamp(0, W - 1)]
        if padding_mode == "zeros":
            inb = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
            vals = torch.where(inb[..., None], vals, torch.zeros(
                (), dtype=vals.dtype, device=vals.device))
        return vals  # N, Hg, Wg, C

    if mode == "nearest":
        out = sample(torch.round(fx).to(torch.int32).long(),
                     torch.round(fy).to(torch.int32).long())
    else:
        x0 = torch.floor(fx).to(torch.int32)
        y0 = torch.floor(fy).to(torch.int32)
        wx = (fx - x0)[..., None]
        wy = (fy - y0)[..., None]
        x0, y0 = x0.long(), y0.long()
        x1, y1 = x0 + 1, y0 + 1
        out = (sample(x0, y0) * (1 - wx) * (1 - wy)
               + sample(x1, y0) * wx * (1 - wy)
               + sample(x0, y1) * (1 - wx) * wy
               + sample(x1, y1) * wx * wy)
    return out.movedim(-1, 1).to(x.dtype)
