"""paddle.reader: the legacy reader-decorator utilities.

Counterpart: paddle_tpu/reader/__init__.py.
"""
from .decorator import (cache, map_readers, shuffle, chain, compose,
                        buffered, firstn, xmap_readers,
                        multiprocess_reader, ComposeNotAligned)

__all__ = []
