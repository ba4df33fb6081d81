"""Convolutions.

Counterpart: paddle_tpu/nn/functional/conv.py, all of it: `conv1d` /
`conv2d` / `conv3d` and their transposes, NC... and N...C layouts, on
torch's convolutions (cuDNN on the card). The reference lowers each to
one `lax.conv_general_dilated`; what differs from torch's own calls is
kept here:

- padding (`_padding`): an int, a list of n, a list of 2n
  `[before0, after0, ...]`, pairs (n of them, or n + 2 with the batch
  and channel pairs first), "SAME" or "VALID". "SAME" is lax's: an
  output of ceil(in / stride) and the total padding split with the odd
  element after, whatever the stride. torch's own `padding=` takes
  symmetric pads only (and "same" at stride 1 only), so uneven pads go
  through `F.pad` first;
- the forward convolutions take the amp policy of "conv" (a white-list
  op): under `auto_cast` their input, weight and bias are cast, as the
  reference's `apply_op(op_name="conv")`; the transposes carry no op
  name there and are never cast;
- the bias is added after the product is cast to the input's dtype, so
  a float32 bias meeting a bfloat16 product gives float32, as on the
  reference;
- a transpose takes the weight `[in, out / groups, *k]`; its "SAME"
  padding is Paddle's `UpdatePaddingAndDilation` (from the input's
  size); `output_padding` adds rows after the output as the reference's
  lhs-dilated convolution does, and `output_size` pads zeros after the
  output up to the asked size (never torch's `output_padding` rule).

A float32 convolution on the card runs at the precision
`torch.backends.cudnn.allow_tf32` asks for (True by default: TF32
products); the package sets no global flag.
"""
import torch
import torch.nn.functional as TF

from ...amp import cast_inputs

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        out = [int(x) for x in v]
        return tuple(out * n) if len(out) == 1 else tuple(out)
    return (int(v),) * n


def _padding(padding, n):
    """"SAME" / "VALID", or [(before, after)] for each spatial dim."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding {padding!r}")
        return mode
    if isinstance(padding, (list, tuple)):
        p = list(padding)
        if p and isinstance(p[0], (list, tuple)):
            pairs = [(int(a), int(b)) for a, b in p]
            return pairs[-n:] if len(pairs) == n + 2 else pairs
        if len(p) == 2 * n:
            return [(int(p[2 * i]), int(p[2 * i + 1])) for i in range(n)]
        if len(p) == 1:
            return [(int(p[0]), int(p[0]))] * n
        return [(int(v), int(v)) for v in p]
    return [(int(padding), int(padding))] * n


def _same(sizes, k_eff, strides):
    """lax's "SAME": an output of ceil(in / s), the odd pad after."""
    out = []
    for size, k, s in zip(sizes, k_eff, strides):
        tot = max((-(-size // s) - 1) * s + k - size, 0)
        out.append((tot // 2, tot - tot // 2))
    return out


def _pad_arg(pairs):
    """`F.pad`'s flat list, last dim first."""
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    return flat


def _add_bias(out, bias, n):
    if bias is None:
        return out
    return out + bias.reshape((-1,) + (1,) * n)


def _conv(x, weight, bias, stride, padding, dilation, groups, n,
          channel_last):
    if bias is None:
        x, weight = cast_inputs("conv", x, weight)
    else:
        x, weight, bias = cast_inputs("conv", x, weight, bias)
    strides, dil = _tuple(stride, n), _tuple(dilation, n)
    if channel_last:
        x = x.movedim(-1, 1)
    pads = _padding(padding, n)
    if pads == "VALID":
        pads = [(0, 0)] * n
    elif pads == "SAME":
        k_eff = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dil)]
        pads = _same(x.shape[2:], k_eff, strides)
    if all(lo == hi for lo, hi in pads):
        sym = [lo for lo, _ in pads]
    else:
        x = TF.pad(x, _pad_arg(pads))
        sym = 0
    out = _CONV[n](x, weight, None, strides, sym, dil, groups)
    out = _add_bias(out, bias, n)
    return out.movedim(1, -1) if channel_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format == "NLC")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format == "NHWC")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format == "NDHWC")


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, n, channel_last, output_size):
    """The reference's lhs-dilated convolution: torch's transpose with
    no padding gives the whole output, (in - 1) * s + k_eff a dim, of
    which the reference keeps [before, size - after + output_padding),
    zeros past its end (F.pad with negative widths crops)."""
    strides, dil = _tuple(stride, n), _tuple(dilation, n)
    opad = _tuple(output_padding, n)
    if channel_last:
        x = x.movedim(-1, 1)
    k_eff = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dil)]
    pads = _padding(padding, n)
    if pads == "VALID":
        pads = [(0, 0)] * n
    elif pads == "SAME":
        pads = _same(x.shape[2:], k_eff, strides)
    out = _CONV_T[n](x, weight, None, strides, 0, 0, groups, dil)
    widths = [(-lo, -hi + op) for (lo, hi), op in zip(pads, opad)]
    if any(w != (0, 0) for w in widths):
        out = TF.pad(out, _pad_arg(widths))
    out = _add_bias(out, bias, n)
    if output_size is not None:
        want = list(output_size) if isinstance(output_size, (list, tuple)) \
            else [output_size] * n
        extra = [max(int(w) - c, 0) for w, c in zip(want, out.shape[2:])]
        if any(extra):
            out = TF.pad(out, _pad_arg([(0, e) for e in extra]))
    return out.movedim(1, -1) if channel_last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1, data_format == "NLC",
                           output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2, data_format == "NHWC",
                           output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3, data_format == "NDHWC",
                           output_size)
