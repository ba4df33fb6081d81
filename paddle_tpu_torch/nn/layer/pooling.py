"""Pooling layers. Counterpart: paddle_tpu/nn/layer/pooling.py, all of
it: AvgPool1D/2D/3D, MaxPool1D/2D/3D, the adaptive pools and
MaxUnPool1D/2D/3D over nn/functional/pooling.py, with the reference's
signatures (a pool's keywords pass to its functional). Port layers
(`_paddle_io = False`)."""
from ..functional import pooling as FP
from .layers import Layer

__all__ = ["AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D"]


class _PoolNd(Layer):
    _paddle_io = False
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, **kwargs):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return type(self)._fn(x, self.kernel_size, self.stride,
                              self.padding, **self.kwargs)


class AvgPool1D(_PoolNd):
    _fn = FP.avg_pool1d


class AvgPool2D(_PoolNd):
    _fn = FP.avg_pool2d


class AvgPool3D(_PoolNd):
    _fn = FP.avg_pool3d


class MaxPool1D(_PoolNd):
    _fn = FP.max_pool1d


class MaxPool2D(_PoolNd):
    _fn = FP.max_pool2d


class MaxPool3D(_PoolNd):
    _fn = FP.max_pool3d


class _AdaptivePoolNd(Layer):
    _paddle_io = False
    _fn = None

    def __init__(self, output_size, **kwargs):
        super().__init__()
        self.output_size = output_size
        self.kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return type(self)._fn(x, self.output_size, **self.kwargs)


class AdaptiveAvgPool1D(_AdaptivePoolNd):
    _fn = FP.adaptive_avg_pool1d

    def forward(self, x):  # the reference passes no keyword through
        return FP.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(_AdaptivePoolNd):
    _fn = FP.adaptive_avg_pool2d


class AdaptiveAvgPool3D(_AdaptivePoolNd):
    _fn = FP.adaptive_avg_pool3d


class AdaptiveMaxPool1D(_AdaptivePoolNd):
    _fn = FP.adaptive_max_pool1d


class AdaptiveMaxPool2D(_AdaptivePoolNd):
    _fn = FP.adaptive_max_pool2d


class AdaptiveMaxPool3D(_AdaptivePoolNd):
    _fn = FP.adaptive_max_pool3d


class _MaxUnPoolNd(Layer):
    _paddle_io = False
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.data_format = data_format
        self.output_size = output_size

    def forward(self, x, indices):
        return type(self)._fn(x, indices, self.kernel_size, self.stride,
                              self.padding, output_size=self.output_size)


class MaxUnPool1D(_MaxUnPoolNd):
    _fn = FP.max_unpool1d

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)


class MaxUnPool2D(_MaxUnPoolNd):
    _fn = FP.max_unpool2d


class MaxUnPool3D(_MaxUnPoolNd):
    _fn = FP.max_unpool3d

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)
