"""Vision layers. Counterpart: paddle_tpu/nn/layer/vision.py, all of it:
PixelShuffle, PixelUnshuffle and ChannelShuffle over
nn/functional/vision.py. Port layers (`_paddle_io = False`)."""
from ..functional import vision as FV
from .layers import Layer

__all__ = ["PixelShuffle", "PixelUnshuffle", "ChannelShuffle"]


class PixelShuffle(Layer):
    _paddle_io = False

    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self._factor = upscale_factor
        self._data_format = data_format

    def forward(self, x):
        return FV.pixel_shuffle(x, self._factor, self._data_format)


class PixelUnshuffle(Layer):
    _paddle_io = False

    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self._factor = downscale_factor
        self._data_format = data_format

    def forward(self, x):
        return FV.pixel_unshuffle(x, self._factor, self._data_format)


class ChannelShuffle(Layer):
    _paddle_io = False

    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self._groups = groups
        self._data_format = data_format

    def forward(self, x):
        return FV.channel_shuffle(x, self._groups, self._data_format)
