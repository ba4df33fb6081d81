"""The port's layers. Counterpart: paddle_tpu/nn/layer/; the
convolutional, pooling, recurrent, decoding and vision layers wait for
ROADMAP.md's A.6 part 3."""
from . import activation, common, loss, norm, transformer
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import LayerDict, LayerList, ParameterList, Sequential
from .distance import PairwiseDistance
from .layers import Layer
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403

__all__ = (activation.__all__
           + [n for n in common.__all__ if n != "dropout_masks"]
           + ["LayerDict", "LayerList", "ParameterList", "Sequential",
              "PairwiseDistance", "Layer"]
           + loss.__all__ + norm.__all__ + transformer.__all__)
