"""Convolution layers. Counterpart: paddle_tpu/nn/layer/conv.py, all of
it: Conv1D / Conv2D / Conv3D and their transposes over
nn/functional/conv.py, with the reference's signatures, parameter names
and shapes (`weight` [out, in / groups, *k], a transpose's [in, out /
groups, *k]; `bias` [out]) and its default initializer, Uniform(-1 /
sqrt(fan_in), 1 / sqrt(fan_in)) for both, fan_in = in / groups * prod(k).
`bias_attr=False` drops the bias. Port layers (`_paddle_io = False`);
`device` comes after `*` (nn/layer/common.py)."""
import math

from .. import initializer as I
from ..functional import conv as FC
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        return list(v) if len(v) > 1 else list(v) * n
    return [v] * n


class _ConvNd(Layer):
    _paddle_io = False

    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, padding_mode, weight_attr,
                 bias_attr, data_format, dims, transposed=False,
                 output_padding=0, *, device=None):
        super().__init__()
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, dims)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._padding_mode = padding_mode
        self._output_padding = output_padding
        self._dims = dims
        self._transposed = transposed
        if transposed:
            shape = [in_channels, out_channels // groups] + self._kernel_size
        else:
            shape = [out_channels, in_channels // groups] + self._kernel_size
        fan_in = in_channels // groups * math.prod(self._kernel_size)
        bound = 1.0 / math.sqrt(fan_in)
        init = I.Uniform(-bound, bound)
        self.weight = self.create_parameter(
            shape, attr=weight_attr, default_initializer=init, device=device)
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=init, device=device)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, 1,
                         device=device)

    def forward(self, x):
        return FC.conv1d(x, self.weight, self.bias, self._stride,
                         self._padding, self._dilation, self._groups,
                         self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, 2,
                         device=device)

    def forward(self, x):
        return FC.conv2d(x, self.weight, self.bias, self._stride,
                         self._padding, self._dilation, self._groups,
                         self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, 3,
                         device=device)

    def forward(self, x):
        return FC.conv3d(x, self.weight, self.bias, self._stride,
                         self._padding, self._dilation, self._groups,
                         self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, 1, transposed=True,
                         output_padding=output_padding, device=device)

    def forward(self, x, output_size=None):
        return FC.conv1d_transpose(x, self.weight, self.bias, self._stride,
                                   self._padding, self._output_padding,
                                   self._groups, self._dilation, output_size,
                                   self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, 2, transposed=True,
                         output_padding=output_padding, device=device)

    def forward(self, x, output_size=None):
        return FC.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                   self._padding, self._output_padding,
                                   self._groups, self._dilation, output_size,
                                   self._data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, 3, transposed=True,
                         output_padding=output_padding, device=device)

    def forward(self, x, output_size=None):
        return FC.conv3d_transpose(x, self.weight, self.bias, self._stride,
                                   self._padding, self._output_padding,
                                   self._groups, self._dilation, output_size,
                                   self._data_format)
