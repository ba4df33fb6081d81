"""paddle.vision.models of the port. Counterpart:
paddle_tpu/vision/models/__init__.py: ResNet, ResNeXt, LeNet, AlexNet,
VGG and SqueezeNet; MobileNet / ShuffleNet, DenseNet and Inception wait
for ROADMAP.md's A.15."""
from .resnet import (ResNet, resnet18, resnet34, resnet50, resnet101,
                     resnet152, wide_resnet50_2, wide_resnet101_2)
from .resnext import (ResNeXt, resnext50_32x4d, resnext50_64x4d,
                      resnext101_32x4d, resnext101_64x4d,
                      resnext152_32x4d, resnext152_64x4d)
from .small_nets import (LeNet, AlexNet, alexnet, VGG, vgg11, vgg13, vgg16,
                         vgg19, SqueezeNet, squeezenet1_0, squeezenet1_1)

__all__ = ["ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2", "ResNeXt",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
           "LeNet", "AlexNet", "alexnet", "VGG", "vgg11", "vgg13", "vgg16",
           "vgg19", "SqueezeNet", "squeezenet1_0", "squeezenet1_1"]
