"""speech_separation_tpu_torch — the PyTorch and CUDA port of speech_separation_tpu.

The JAX package beside it is the reference; this package imports neither JAX
nor ``speech_separation_tpu``. Module paths mirror the JAX package's:

- ``ops``      : framing, windows, STFT/iSTFT, features (PSM labels), int16
                 quantization, and the CUDA kernels' wrappers (``stft_cuda``,
                 ``lstm_cuda``, ``lstm_train_cuda``, ``tcn_cuda``,
                 ``tcn_train_cuda``);
- ``models``   : the uPIT BLSTM separator as ``nn.Module``s, with its
                 training forward; Conv-TasNet and its folded serving and
                 kernel training paths (``fused_apply``, ``cuda_apply``,
                 ``train_apply``);
- ``losses``   : the PIT losses (masks, and SI-SDR over waveforms);
- ``train``    : Adam with optax's semantics, train state, steps,
                 checkpoints and the epoch loop;
- ``data``     : audio I/O, the waveform loader, the synthetic fixture;
- ``separate`` : wave-to-wave separation of a directory; Conv-TasNet's
                 overlapped-chunk stitching;
- ``utils``    : the training config and the metrics log;
- ``cli``      : ``train`` and ``separate`` (uPIT BLSTM and Conv-TasNet)
                 from the command line;
- ``weights``  : JAX parameter trees ↔ ``state_dict``s;
- ``_build``   : builds ``csrc/*.cu`` (with their ``*.cuh`` headers) with nvcc
                 for sm_90a at first use.
"""

__version__ = "0.1.0"
