"""Extension functionals. Counterpart:
paddle_tpu/nn/functional/extension.py."""
import torch

from ...framework.dtype import convert_dtype

__all__ = ["sequence_mask", "temporal_shift", "diag_embed"]


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """[..., maxlen]: 1 where the position is below x's length. Without
    `maxlen` the longest length (a read back to the host)."""
    ml = int(x.max()) if maxlen is None else int(maxlen)
    r = torch.arange(ml, device=x.device)
    return (r < x[..., None]).to(convert_dtype(dtype))


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM: of each clip's seg_num frames, the first C * shift_ratio
    channels move one frame back, the next as many one frame forward,
    zeros where nothing comes in."""
    if data_format == "NHWC":
        x = x.movedim(-1, 1)
    NT, C, H, W = x.shape
    v = x.reshape(NT // seg_num, seg_num, C, H, W)
    c1, c2 = int(C * shift_ratio), int(C * 2 * shift_ratio)
    back = torch.cat([v[:, 1:, :c1], torch.zeros_like(v[:, :1, :c1])], 1)
    fwd = torch.cat([torch.zeros_like(v[:, :1, c1:c2]), v[:, :-1, c1:c2]],
                    1)
    out = torch.cat([back, fwd, v[:, :, c2:]], 2).reshape(NT, C, H, W)
    return out.movedim(1, -1) if data_format == "NHWC" else out


def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(x, offset, dim1, dim2)
