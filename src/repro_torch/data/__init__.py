"""The data feed of the port (`repro.data`): the synthetic token stream,
its splitter and distributor, and the double-buffered feed."""

from .pipeline import (BatchSpec, Distributor, Splitter, SyntheticLMStream,
                       stream_batches)
from .prefetch import DoubleBufferedFeed

__all__ = ["BatchSpec", "Distributor", "DoubleBufferedFeed", "Splitter",
           "SyntheticLMStream", "stream_batches"]
