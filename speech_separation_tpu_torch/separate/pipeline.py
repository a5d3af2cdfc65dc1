"""Wave-to-wave separation (counterpart of ``separate/pipeline.py``).

STFT (the ``stft_cuda`` kernel) → magnitude and phase → ``UPitBlstm`` mask
estimation (the ``lstm_recurrence`` kernel) → phase reapply → iSTFT matmul and
overlap-add, over a padded batch on one device; the estimates come back in
page-locked host memory (``data.datasets.to_host``), and the host only trims
each utterance to its true length and writes wavs.

Variable lengths: frames beyond an utterance's true frame count are zeroed
*before* overlap-add, which makes the output within the valid region equal to
running the iSTFT on the truncated spectrogram; the host then keeps
``frames * shift - (size - shift)`` samples per utterance.
"""

from __future__ import annotations

import copy
import pathlib
from typing import Callable

import torch

from ..data.audio_io import audiowrite, wait_for_pending_writes
from ..data.datasets import WaveformLoader, prefetch_to_device, to_host
from ..ops.features import magnitude_angle
from ..ops.quant import dequant_i16, dequantize_estimates_i16, quantize_estimates_i16
from ..ops.stft import istft, stft
from ..ops.stft_cuda import stft_cuda

__all__ = ["separated_length", "make_separate_fn", "separate_directory"]


def separated_length(frames: int, size: int, shift: int) -> int:
    """Output sample count of a fade-cropped iSTFT over ``frames`` frames."""
    return frames * shift - (size - shift)


def make_separate_fn(
    model: torch.nn.Module,
    size: int = 256,
    shift: int = 128,
    num_speakers: int = 2,
    method: str = "matmul",
    compute_dtype: torch.dtype | None = None,
    quantize_output: bool = False,
) -> Callable:
    """Returns ``separate(mix, frame_lengths) -> [B, S, samples]`` on the host,
    page-locked where the model is on a GPU (``data.datasets.to_host``: one
    copy a call, which the call waits for).

    ``mix`` is ``[B, samples]`` float or int16 PCM (dequantized on the
    device); ``frame_lengths`` ``[B]`` holds each utterance's true STFT frame
    count. ``compute_dtype=torch.bfloat16`` runs the mask network on a bf16
    copy of the model, with the DSP in fp32. ``quantize_output=True`` returns
    ``(codes int16, scale)`` per ``ops.quant.quantize_estimates_i16``.

    ``method="matmul"`` analyses with the ``stft_cuda`` kernel and
    ``method="fft"`` with ``torch.fft`` (the oracle). Inside
    ``ops.plain_versions()`` every kernel runs its plain version: the
    reference path that a GPU run is compared with.
    """
    net = model if compute_dtype is None else copy.deepcopy(model).to(compute_dtype)
    net.eval()

    def analyse(wave: torch.Tensor) -> torch.Tensor:
        if method == "fft":
            return stft(wave, size, shift, method=method)
        return stft_cuda(wave, size, shift)

    @torch.inference_mode()
    def separate(mix: torch.Tensor, frame_lengths: torch.Tensor):
        spec = analyse(dequant_i16(mix))  # [B, T, F] complex
        mag, cos, sin = magnitude_angle(spec)
        preds = net(mag).to(mag.dtype)
        t, f = mag.shape[-2], mag.shape[-1]
        lengths = torch.as_tensor(frame_lengths, device=mag.device)
        frame_mask = (torch.arange(t, device=mag.device)[None, :] < lengths[:, None]).to(
            mag.dtype
        )
        wavs = []
        for s in range(num_speakers):
            masked = preds[..., s * f : (s + 1) * f] * frame_mask[..., None]
            est = torch.complex(masked * cos, masked * sin)
            wavs.append(istft(est, size, shift, method=method))
        out = torch.stack(wavs, dim=1)
        return to_host(quantize_estimates_i16(out) if quantize_output else out)

    return separate


def separate_directory(
    model: torch.nn.Module,
    split_dir: str | pathlib.Path,
    out_dir: str | pathlib.Path,
    size: int = 256,
    shift: int = 128,
    num_speakers: int = 2,
    batch_size: int = 2,
    sample_rate: int = 8000,
    normalize: bool = True,
    compute_dtype: torch.dtype | None = None,
    transfer_int16: bool = False,
) -> list[pathlib.Path]:
    """Separate every mixture in ``split_dir/mix`` → ``out_dir/{name}_s{i}.wav``.

    Runs on the model's device. Output naming and normalisation follow the
    JAX pipeline (peak-normalised int16, ``_s1``/``_s2`` suffixes).
    ``transfer_int16`` ships int16 PCM to the device and int16 estimates back
    (per-signal scale, no clipping).
    """
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    device = next(model.parameters()).device
    loader = WaveformLoader(
        split_dir,
        batch_size=batch_size,
        sample_rate=sample_rate,
        stft_size=size,
        stft_shift=shift,
        num_speakers=num_speakers,
        transfer_int16=transfer_int16,
    )
    separate = make_separate_fn(
        model, size, shift, num_speakers, compute_dtype=compute_dtype,
        quantize_output=transfer_int16,
    )
    written: list[pathlib.Path] = []
    for batch in prefetch_to_device(iter(loader), device):
        out = separate(batch.mix, batch.frame_lengths)
        if transfer_int16:
            codes, scale = out
            wavs = dequantize_estimates_i16(codes.numpy(), scale.numpy())
        else:
            wavs = out.numpy()
        for i, (name, frames) in enumerate(zip(batch.names, batch.frame_lengths.tolist())):
            stem = pathlib.Path(name).stem
            true_len = separated_length(int(frames), size, shift)
            for s in range(num_speakers):
                path = out_dir / f"{stem}_s{s + 1}.wav"
                audiowrite(
                    wavs[i, s, :true_len],
                    path,
                    samplerate=sample_rate,
                    normalize=normalize,
                    threaded=True,
                )
                written.append(path)
    wait_for_pending_writes()
    return written
