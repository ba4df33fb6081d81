"""The port's layers. Counterpart: paddle_tpu/nn/layer/, every layer
of it, and the decoding utilities of its decode.py."""
from . import (activation, common, conv, decode, loss, norm, pooling, rnn,
               transformer, vision)
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import *  # noqa: F401,F403
from .decode import BeamSearchDecoder, dynamic_decode
from .distance import PairwiseDistance
from .layers import Layer
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403
from .vision import *  # noqa: F401,F403

__all__ = (activation.__all__
           + [n for n in common.__all__ if n != "dropout_masks"]
           + ["LayerDict", "LayerList", "ParameterList", "Sequential",
              "PairwiseDistance", "Layer"]
           + conv.__all__ + decode.__all__ + loss.__all__ + norm.__all__
           + pooling.__all__ + rnn.__all__ + transformer.__all__
           + vision.__all__)
