"""Wave-to-wave separation: whole utterances, overlapped chunks, streams."""

from .pipeline import make_separate_fn, separate_directory, separated_length
from .streaming import StreamingSeparator, stream_separate
from .streaming_stateful import CausalStreamingSeparator, stateful_stream_separate
from .tasnet_chunked import separate_chunked

__all__ = [
    "CausalStreamingSeparator",
    "StreamingSeparator",
    "make_separate_fn",
    "separate_chunked",
    "separate_directory",
    "separated_length",
    "stateful_stream_separate",
    "stream_separate",
]
