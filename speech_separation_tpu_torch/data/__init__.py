"""Audio I/O, loaders and fixtures (numpy on the host)."""

from .audio_io import audioread, audiowrite, quantize_i16, read_normalized, read_wav, wait_for_pending_writes
from .datasets import (
    VaeBatch,
    VaeLoader,
    WaveformBatch,
    WaveformLoader,
    background_iterator,
    load_source_files,
    prefetch_to_device,
)
from .device_dataset import ResidentPackedCorpus
from .features import resolve_mix_dirname, utterance_names
from .fixture import make_synthetic_fixture, make_synthetic_librimix
from .packing import PackedBatch, PackedWaveformLoader
from .speaker_info import load_speaker_genders, mixture_genders

__all__ = [
    "audioread",
    "audiowrite",
    "quantize_i16",
    "read_normalized",
    "read_wav",
    "wait_for_pending_writes",
    "VaeBatch",
    "VaeLoader",
    "WaveformBatch",
    "WaveformLoader",
    "background_iterator",
    "load_source_files",
    "prefetch_to_device",
    "ResidentPackedCorpus",
    "resolve_mix_dirname",
    "utterance_names",
    "make_synthetic_fixture",
    "make_synthetic_librimix",
    "PackedBatch",
    "PackedWaveformLoader",
    "load_speaker_genders",
    "mixture_genders",
]
