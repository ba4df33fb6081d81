"""The ResNeXt family. Counterpart: paddle_tpu/vision/models/resnext.py,
all of it: the ResNet trunk with grouped bottlenecks, width 4 a group
and `groups` = cardinality (32 or 64), depth 50 / 101 / 152."""
from .resnet import BottleneckBlock, ResNet, _no_pretrained

__all__ = ["ResNeXt", "resnext50_32x4d", "resnext50_64x4d",
           "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d",
           "resnext152_64x4d"]


class ResNeXt(ResNet):
    def __init__(self, depth=50, cardinality=32, num_classes=1000,
                 with_pool=True):
        super().__init__(BottleneckBlock, depth=depth, width=4,
                         num_classes=num_classes, with_pool=with_pool,
                         groups=cardinality)
        self.cardinality = cardinality


def _resnext(depth, cardinality, pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return ResNeXt(depth=depth, cardinality=cardinality, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnext(50, 32, pretrained, **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnext(50, 64, pretrained, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnext(101, 32, pretrained, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnext(101, 64, pretrained, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnext(152, 32, pretrained, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnext(152, 64, pretrained, **kwargs)
