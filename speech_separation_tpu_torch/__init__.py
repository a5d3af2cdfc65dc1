"""speech_separation_tpu_torch — the PyTorch and CUDA port of speech_separation_tpu.

The JAX package beside it is the reference; this package imports neither JAX
nor ``speech_separation_tpu``. Module paths mirror the JAX package's:

- ``ops``      : framing, windows, STFT/iSTFT, features, int16 quantization,
                 and the CUDA kernels' wrappers (``stft_cuda``, ``lstm_cuda``);
- ``models``   : the uPIT BLSTM separator as ``nn.Module``s;
- ``data``     : audio I/O, the waveform loader, the synthetic fixture;
- ``separate`` : wave-to-wave separation of a directory;
- ``weights``  : JAX parameter trees → ``state_dict``s;
- ``_build``   : builds ``csrc/*.cu`` with nvcc for sm_90a at first use.
"""

__version__ = "0.1.0"
