"""speech_separation_tpu_torch — the PyTorch and CUDA port of speech_separation_tpu.

The JAX package beside it is the reference; this package imports neither JAX
nor ``speech_separation_tpu``. Module paths mirror the JAX package's:

- ``ops``      : framing, windows, STFT/iSTFT, features (PSM labels), int16
                 quantization, and the CUDA kernels' wrappers (``stft_cuda``,
                 ``lstm_cuda``, ``lstm_train_cuda``, ``tcn_cuda``,
                 ``tcn_train_cuda``, ``vq_cuda``);
- ``models``   : the uPIT BLSTM separator as ``nn.Module``s, with its
                 training forward; Conv-TasNet and its folded serving and
                 kernel training paths (``fused_apply``, ``cuda_apply``,
                 ``train_apply``); the VQ-VAE codecs and their quantizers;
- ``losses``   : the PIT losses (masks, and SI-SDR over waveforms), the
                 codecs' summed squared error;
- ``train``    : Adam and NAdam with optax's semantics, train state, steps,
                 checkpoints and the epoch loop;
- ``data``     : audio I/O, the waveform and codec loaders, the synthetic
                 fixture;
- ``separate`` : wave-to-wave separation of a directory; Conv-TasNet's
                 overlapped-chunk stitching;
- ``utils``    : the training configs and the metrics log;
- ``tokenizer``: the codebook health metrics of the codec CLI;
- ``cli``      : ``train`` and ``separate`` (uPIT BLSTM and Conv-TasNet),
                 ``train --workload vqvae`` and ``codec-encode``,
                 ``codec-decode``, ``codec-roundtrip`` from the command line;
- ``weights``  : JAX parameter trees ↔ ``state_dict``s;
- ``_build``   : builds ``csrc/*.cu`` (with their ``*.cuh`` headers) with nvcc
                 for sm_90a at first use.
"""

__version__ = "0.1.0"
