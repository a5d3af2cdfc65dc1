"""Exact stateful streaming for the causal Conv-TasNet (counterpart of
``separate/streaming_stateful.py``).

The window streamer (``separate/streaming.py``) reruns the model on a
``context + hop`` window every hop: O(window) work a hop, and window-local
statistics. The causal ``ConvTasNet`` (cumulative layer norm, left-padded
depthwise convs) needs neither: its dependence on the past is a finite
carried state, so a hop is processed exactly with O(hop) work:

- encoder: the raw samples not yet framed (the conv window's overlap);
- each block's causal depthwise conv: the last ``(kernel − 1) · dilation``
  frames of its input;
- every cumulative layer norm: three running sums a row (count, Σx, Σx²),
  which continue across hops as the offline cumulative sums do;
- decoder (transposed conv): the overlap-add tail of partial sums.

``CausalStreamingSeparator.push(hop)`` runs one step a hop on the module's
device, its state kept there between pushes; only the emitted audio comes back
to the host. The concatenated emissions equal the module's forward on the
hop-padded waveform to float tolerance (fp32). Algorithmic latency: one hop
plus ``win`` samples (2 ms at 8 kHz, win 16) for the encoder's and decoder's
window overlap. The step runs the module's own layers in eager PyTorch: no
trunk kernel is on this path (the kernel implements the gLN topology).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.tasnet import ConvTasNet

__all__ = ["CausalStreamingSeparator", "stateful_stream_separate"]


class _ClnState(NamedTuple):
    count: torch.Tensor  # [B] elements seen so far (channels × frames)
    s1: torch.Tensor  # [B] running Σx
    s2: torch.Tensor  # [B] running Σx²


def _cln_chunk(x: torch.Tensor, norm, st: _ClnState) -> tuple[torch.Tensor, _ClnState]:
    """Cumulative layer norm over a chunk ``x [B, F, C]`` fp32, continuing the
    carried statistics: the module's ``_Norm(causal=True)`` on the whole
    stream, restricted to these frames."""
    f, c = x.shape[1], x.shape[2]
    csum = st.s1[:, None] + torch.cumsum(x.sum(2), dim=1)
    csq = st.s2[:, None] + torch.cumsum(x.square().sum(2), dim=1)
    count = st.count[:, None] + c * torch.arange(1, f + 1, dtype=torch.float32, device=x.device)
    mean = csum / count
    var = torch.clamp(csq / count - mean.square(), min=0.0)
    out = norm.gamma * (x - mean[..., None]) / torch.sqrt(var + 1e-8)[..., None] + norm.beta
    return out, _ClnState(count[:, -1], csum[:, -1], csq[:, -1])


class _State(NamedTuple):
    in_buf: torch.Tensor  # [B, pad + stride] raw samples not yet framed (the first: the left pad)
    cln: tuple  # per-norm _ClnState: input_norm, then (norm1, norm2) a block
    dw_tails: tuple  # per block [B, (kernel − 1) · dilation, hidden] depthwise context
    ola: torch.Tensor  # [B, S, win − stride] decoder partial sums not yet final


class CausalStreamingSeparator:
    """Exact O(hop) streaming around a causal fp32 ``ConvTasNet`` module,
    whose layers and parameters it reads; its state lives on the module's
    device. ``hop_samples`` must be a multiple of the encoder stride
    (``win // 2``) and at least ``win``."""

    def __init__(self, model: ConvTasNet, hop_samples: int):
        if not model.causal:
            raise ValueError("stateful streaming requires ConvTasNet(causal=True)")
        dtype = next(model.parameters()).dtype
        if dtype != torch.float32:
            # the exactness contract (emissions == the offline forward) holds
            # in fp32; a module cast to another dtype would part from it
            raise ValueError(
                "stateful streaming computes fp32; stream the fp32 module, "
                f"got parameters in {dtype}"
            )
        stride = model.win // 2
        if hop_samples % stride != 0 or hop_samples < model.win:
            raise ValueError(f"hop must be a multiple of {stride} and ≥ {model.win}")
        self.model = model
        self.device = next(model.parameters()).device
        self.hop = hop_samples
        self.stride = stride
        self.win = model.win
        # the SAME encoder conv (kernel win, stride win/2) pads (win − stride)/2 a side
        self.pad = (self.win - stride) // 2
        self._state = None
        self._batch = None
        self._flushed = False

    def _init_state(self, b: int) -> _State:
        m = self.model

        def zeros(*shape):
            return torch.zeros(*shape, device=self.device)

        cln = [_ClnState(zeros(b), zeros(b), zeros(b))
               for _ in range(1 + 2 * m.repeats * m.blocks)]
        tails = [zeros(b, (m.kernel - 1) * 2**x, m.hidden)
                 for _ in range(m.repeats) for x in range(m.blocks)]
        # in_buf starts as the offline SAME left pad (zeros); after the first
        # push it holds pad + stride samples
        return _State(in_buf=zeros(b, self.pad), cln=tuple(cln), dw_tails=tuple(tails),
                      ola=zeros(b, m.num_speakers, self.win - self.stride))

    def push(self, hop: np.ndarray) -> np.ndarray:
        """Feed ``[B, hop]`` (or ``[hop]``) samples; returns the newly final
        ``[B, S, n]`` samples. The first push emits ``hop − win + stride −
        pad`` samples (its frames minus the one kept for the overlap, minus the
        decoder's one-time SAME left-pad trim of ``pad = (win − stride) //
        2``); later pushes emit exactly ``hop``."""
        if self._flushed:
            raise RuntimeError("push() after flush(): the stream is finalized")
        hop = torch.atleast_2d(torch.as_tensor(np.asarray(hop, np.float32))).to(self.device)
        # the one-time left-pad trim applies after a successful first step only
        first = self._state is None
        if first:
            self._batch = hop.shape[0]
            self._state = self._init_state(self._batch)
        try:
            self._state, out = _stream_step(self.model, self._state, hop, first=first)
        except Exception:
            if first:
                self._state = None  # a retried push is still the first push
            raise
        return out.cpu().numpy()

    def flush(self) -> np.ndarray:
        """Finalize: push one stride of zeros (the offline SAME right pad) to
        produce the last frame, then emit the overlap-add tail that no later
        frame can touch. The whole stream equals the offline forward on the
        hop-padded waveform. Call exactly once, after at least one push."""
        if self._state is None:
            raise RuntimeError("flush() before any push(): nothing to finalize")
        if self._flushed:
            raise RuntimeError("flush() called twice: the stream is finalized")
        self._flushed = True
        zeros = torch.zeros(self._batch, self.stride, device=self.device)
        self._state, out = _stream_step(self.model, self._state, zeros, first=False)
        with torch.no_grad():
            tail = self._state.ola[:, :, : self.pad] + self.model.decoder.bias[0]
        return torch.cat([out, tail], dim=2).cpu().numpy()


@torch.no_grad()
def _stream_step(model: ConvTasNet, st: _State, hop: torch.Tensor, *, first: bool):
    """One hop through every layer of ``model`` with the carried state:
    ``(new state, emitted [B, S, n])``."""
    n_src, enc_dim, win = model.num_speakers, model.enc_dim, model.win
    stride = win // 2
    b = hop.shape[0]

    # encoder: frame whatever is now complete
    buf = torch.cat([st.in_buf, hop], dim=1)
    n_frames = (buf.shape[1] - win) // stride + 1
    new_buf = buf[:, n_frames * stride :]
    enc = model.encoder
    feats = torch.relu(F.conv1d(buf[:, None, : (n_frames - 1) * stride + win],
                                enc.kernel.permute(2, 1, 0), enc.bias, stride=stride))
    feats = feats.transpose(1, 2)  # [B, F, N]

    cln, tails = list(st.cln), list(st.dw_tails)
    x, cln[0] = _cln_chunk(feats, model.input_norm, cln[0])
    h = model.input_proj.pointwise(x)  # [B, F, bottleneck]
    skip_sum = torch.zeros_like(h)
    ti = 0
    for r in range(model.repeats):
        for xb in range(model.blocks):
            blk = getattr(model, f"tcn_{r}_{xb}")
            y = blk.prelu1(blk.expand.pointwise(h))
            y, cln[1 + 2 * ti] = _cln_chunk(y, blk.norm1, cln[1 + 2 * ti])
            ctx = torch.cat([tails[ti], y], dim=1)
            if tails[ti].shape[1]:
                tails[ti] = ctx[:, -tails[ti].shape[1] :]
            # the causal dilated depthwise conv over the carried context, its
            # taps summed in the module's order
            w, dil, f = blk.depthwise.kernel[:, 0, :], blk.dilation, y.shape[1]
            y = ctx[:, 0:f] * w[0]
            for t in range(1, w.shape[0]):
                y = y + ctx[:, t * dil : t * dil + f] * w[t]
            y = blk.prelu2(y + blk.depthwise.bias)
            y, cln[2 + 2 * ti] = _cln_chunk(y, blk.norm2, cln[2 + 2 * ti])
            h = h + blk.res_out.pointwise(y)
            skip_sum = skip_sum + blk.skip_out.pointwise(y)
            ti += 1

    masks = torch.sigmoid(model.mask_proj.pointwise(model.mask_prelu(skip_sum)))
    f = feats.shape[1]
    masked = masks.view(b, f, n_src, enc_dim) * feats[:, :, None, :]  # [B, F, S, N]
    masked = masked.permute(0, 2, 3, 1).reshape(b * n_src, enc_dim, f)

    # decoder: the VALID transposed conv and the carried overlap-add
    seg = F.conv_transpose1d(masked, model.decoder.kernel.flip(0).permute(1, 2, 0), stride=stride)
    seg = seg.reshape(b, n_src, (f - 1) * stride + win)
    seg = torch.cat([seg[:, :, : win - stride] + st.ola, seg[:, :, win - stride :]], dim=2)
    emit = seg[:, :, : f * stride] + model.decoder.bias[0]
    new_ola = seg[:, :, f * stride :]
    if first:
        # the offline SAME decoder trims its left pad: drop those samples once
        emit = emit[:, :, (win - stride) // 2 :]
    return _State(new_buf, tuple(cln), tuple(tails), new_ola), emit


def stateful_stream_separate(model: ConvTasNet, mix: np.ndarray, hop_samples: int):
    """Stream a whole waveform through :class:`CausalStreamingSeparator`.

    Returns ``([S, samples] (or [B, S, samples]), per_push_latency_seconds)``:
    the emissions stitched and trimmed to the input length, equal to the
    module's forward on the whole utterance, and each push's wall-clock time
    (its emission fetched to the host included)."""
    mix = np.asarray(mix, np.float32)
    if mix.ndim == 1:
        mix = mix[None]
    b, samples = mix.shape
    sep = CausalStreamingSeparator(model, hop_samples)
    n_hops = -(-samples // hop_samples)
    padded = np.zeros((b, n_hops * hop_samples), np.float32)
    padded[:, :samples] = mix
    outs, lat = [], []
    for i in range(n_hops):
        t0 = time.perf_counter()
        outs.append(sep.push(padded[:, i * hop_samples : (i + 1) * hop_samples]))
        lat.append(time.perf_counter() - t0)
    outs.append(sep.flush())
    wav = np.concatenate(outs, axis=2)[:, :, :samples]
    return (wav[0] if wav.shape[0] == 1 else wav), lat
