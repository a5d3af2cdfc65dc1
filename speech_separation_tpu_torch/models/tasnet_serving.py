"""Conv-TasNet serving with the global layer norms folded into their consumers
(counterpart of ``models/tasnet_serving.py``).

gLN is an affine map with per-item scalars, ``n(x) = A · x + B`` with
``A = gamma / sigma`` and ``B = beta − mean · A``, so it folds exactly:

- into a following 1×1 conv ``W``: ``n @ W = (x @ gamma·W) / sigma + B @ W``;
- into a following depthwise conv: ``dw(n) = A · dw(x) + B · m``, where
  ``m[t, c] = Σ_k w[k, c] · inside(t + k·d − pad)`` corrects the "SAME"
  zero-padding (zero-padding ``n`` is not zero-padding ``x``);
- ``res_out`` and ``skip_out`` read the same input, so they run as one product
  with concatenated output channels.

:func:`fused_apply` computes the same function as ``ConvTasNet.forward`` over
the same parameters, in plain PyTorch, in fp32 or bf16. :func:`cuda_apply` is
the serving path with the whole TCN trunk in the ``tcn_trunk`` CUDA kernel
(``ops/tcn_cuda.py``), bf16 only; the encoder, input projection and the mask
projection's product stay PyTorch (cuDNN and cuBLAS), as the JAX package leaves
them to XLA around its Pallas trunk, and the rest of the mask head with the
decoder is one launch of the ``mask_decode`` kernel (``ops/mask_decode_cuda.py``,
:func:`_mask_and_decode_cuda`), which rounds only the masked features to bf16.
Both take the fp32 module and read its parameters; both serve the gLN topology
only. ``cuda_apply`` keeps what it derives from the parameters alone (the
trunk's stacks, the bf16 weights around it) in a cache keyed by the module,
rebuilt when a parameter changes (:func:`_serving`); ``fused_apply`` derives
them every call.

Where its caller declares ``ops.fixed_shape_calls()`` (a streaming engine
around its window), ``cuda_apply`` serves its launches after the weights
lookup (encoder, gLN, input projection, trunk, PReLU, mask product,
``mask_decode``) through a CUDA graph held in the cache entry, keyed by the
input's shape, dtype and device and the current stream (:func:`_graph_key`):
a key's first call runs eager, a second call in a row with the same key
captures the chain, later calls with that key copy the input into the
graph's and replay it (:class:`_Graphs`, one graph an entry). Every other
call runs eager, bulk batches among them: a batch's launches hide behind its
device time, and a capture costs a synchronisation, a garbage collection and
a private memory pool of the batch's intermediates. The graph dies with the
entry, and so with the weights it baked in.

:func:`train_apply` is the differentiable counterpart of ``cuda_apply`` that
``make_time_domain_steps(pallas_trunk=True)`` trains through (the JAX kernel
branch's ``_forward``): the live fp32 parameters cast to bf16 inside, the
trunk in the training kernels (``ops/tcn_train_cuda.py``), so gradients reach
every parameter in fp32.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import torch

from ..ops.dispatch import in_fixed_shape_calls, use_plain
from ..ops.mask_decode_cuda import mask_decode
from ..ops.tcn_cuda import stack_canonical, stack_tcn_weights, tcn_trunk_cuda
from ..ops.tcn_train_cuda import tcn_trunk_train
from ..utils.profiling import span
from .tasnet import ConvTasNet, decode, depthwise, encode

__all__ = ["fused_apply", "cuda_apply", "train_apply"]


def _gln_affine(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    """Per-item gLN coefficients over (time, channels), fp32, one pass:
    ``(s [B], a [B, C], b [B, C])`` with ``s = 1/sigma``, ``a = gamma·s``,
    ``b = beta − mean·a``."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2))
    var = torch.clamp(x32.square().mean(dim=(1, 2)) - mean.square(), min=0.0)
    s = torch.rsqrt(var + 1e-8)
    a = gamma[None, :] * s[:, None]
    return s, a, beta[None, :] - mean[:, None] * a


def _prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha.to(x.dtype) * x)


def _folded_dot(x, sab, wg, w, bias, dt):
    """``gLN_affine(x) @ w + bias`` with the normalisation folded into the
    product: ``x [B, T, C]`` in ``dt``, ``w [C, O]`` fp32 and ``wg`` its
    gamma-folded cast (:func:`_fold`). Returns ``[B, T, O]`` in ``dt``."""
    s, _, b = sab
    out = x @ wg
    bias2 = b @ w + bias[None, :]  # [B, O] fp32
    return (out.float() * s[:, None, None] + bias2[:, None, :]).to(dt)


def _fold(gamma: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    """The gLN's scale folded into the following 1×1 kernel ``w [C, O]``, in ``dt``."""
    return (gamma[:, None] * w).to(dt)


class _Head(NamedTuple):
    """The operands around the trunk in the compute dtype (the input
    projection's fp32 kernel besides, for the folded bias)."""

    enc_k: torch.Tensor
    enc_b: torch.Tensor
    proj_wg: torch.Tensor
    proj_w: torch.Tensor
    mask_k: torch.Tensor
    mask_b: torch.Tensor
    dec_k: torch.Tensor
    dec_b: torch.Tensor


def _head(p, dt) -> _Head:
    proj_w = p["input_proj.kernel"][0]
    return _Head(p["encoder.kernel"].to(dt), p["encoder.bias"].to(dt),
                 _fold(p["input_norm.gamma"], proj_w, dt), proj_w,
                 p["mask_proj.kernel"][0].to(dt), p["mask_proj.bias"].to(dt),
                 p["decoder.kernel"].to(dt), p["decoder.bias"].to(dt))


def _params(model: ConvTasNet, live: bool = False) -> dict[str, torch.Tensor]:
    """The module's parameters in fp32, detached unless ``live``."""
    if not isinstance(model, ConvTasNet):
        raise TypeError(f"expected a ConvTasNet, got {type(model).__name__}")
    return {name: p.float() if live else p.detach().float() for name, p in model.named_parameters()}


def _encode_and_project(p, head: _Head, mix, win, dt):
    """Encoder filterbank, and the input gLN folded into the 1×1 bottleneck
    projection: ``(feats [B, K, N], h [B, K, bottleneck])`` in ``dt``."""
    feats = encode(mix, head.enc_k, head.enc_b, win)
    sab = _gln_affine(feats, p["input_norm.gamma"], p["input_norm.beta"])
    h = _folded_dot(feats, sab, head.proj_wg, head.proj_w, p["input_proj.bias"], dt)
    return feats, h


def _mask_and_decode(p, head: _Head, feats, skip_sum, num_speakers, enc_dim, win, samples, dt):
    """PReLU → mask projection → mask × feats → the shared transposed decoder."""
    b, k = feats.shape[:2]
    mpre = _prelu(skip_sum.to(dt), p["mask_prelu.alpha"])
    masks = torch.sigmoid(mpre @ head.mask_k + head.mask_b)
    masked = masks.view(b, k, num_speakers, enc_dim) * feats[:, :, None, :]
    masked = masked.transpose(1, 2).reshape(b * num_speakers, k, enc_dim)
    wav = decode(masked, head.dec_k, head.dec_b, win)
    return wav.reshape(b, num_speakers, -1).float()[:, :, :samples]


def _mask_and_decode_cuda(p, head: _Head, feats, skip_sum, samples, dt):
    """PReLU → mask projection's product → the ``mask_decode`` kernel: the
    mask's bias and sigmoid, × feats, the transposed decoder and its bias in
    one launch, fp32 ``[B, S, samples]`` (its plain version on a CPU tensor)."""
    mpre = _prelu(skip_sum.to(dt), p["mask_prelu.alpha"])
    return mask_decode(mpre @ head.mask_k, head.mask_b, feats, head.dec_k, head.dec_b, samples)


def _check_mix(model: ConvTasNet, mix: torch.Tensor) -> None:
    if model.causal:
        raise ValueError(
            "the folded serving paths implement the gLN topology; a causal (cLN) "
            "ConvTasNet runs through its own forward"
        )
    if mix.dim() != 2 or mix.shape[1] % model.stride:
        raise ValueError(
            f"mix {tuple(mix.shape)}: expected [B, samples] with samples a multiple of "
            f"win//2 = {model.stride}"
        )


@torch.no_grad()
def fused_apply(model: ConvTasNet, mix: torch.Tensor, *, dtype: torch.dtype | None = torch.bfloat16):
    """``ConvTasNet`` forward with gLN folded, plain PyTorch: ``mix [B,
    samples]`` (a multiple of ``win // 2``) → fp32 ``[B, S, samples]``.
    ``dtype=None`` computes in fp32."""
    _check_mix(model, mix)
    dt = dtype or torch.float32
    p = _params(model)
    head = _head(p, dt)
    feats, h = _encode_and_project(p, head, mix, model.win, dt)
    k = feats.shape[1]
    t_idx = torch.arange(k, device=mix.device)[:, None]
    skip_sum = torch.zeros_like(h)
    for r in range(model.repeats):
        for x in range(model.blocks):
            pre = f"tcn_{r}_{x}."
            dil = 2**x
            t1 = _prelu(h @ p[pre + "expand.kernel"][0].to(dt) + p[pre + "expand.bias"].to(dt),
                        p[pre + "prelu1.alpha"])
            # norm1 folded into the depthwise conv: dw(n1) = A1 · dw(t1) + B1 · m + bias
            _, a1, b1 = _gln_affine(t1, p[pre + "norm1.gamma"], p[pre + "norm1.beta"])
            w_dw = p[pre + "depthwise.kernel"]
            dwy = depthwise(t1, w_dw.to(dt), dil)
            pad_left = (model.kernel - 1) * dil // 2
            m = 0
            for j in range(model.kernel):
                src = t_idx + (j * dil - pad_left)
                m = m + w_dw[j, 0][None, :] * ((src >= 0) & (src < k))  # [K, hidden] fp32
            t2 = _prelu(
                (dwy.float() * a1[:, None, :] + b1[:, None, :] * m[None]
                 + p[pre + "depthwise.bias"][None, None, :]).to(dt),
                p[pre + "prelu2.alpha"],
            )
            # norm2 folded into one combined res|skip product
            sab = _gln_affine(t2, p[pre + "norm2.gamma"], p[pre + "norm2.beta"])
            w_cat = torch.cat([p[pre + "res_out.kernel"][0], p[pre + "skip_out.kernel"][0]], dim=1)
            bias_cat = torch.cat([p[pre + "res_out.bias"], p[pre + "skip_out.bias"]])
            rs = _folded_dot(t2, sab, _fold(p[pre + "norm2.gamma"], w_cat, dt), w_cat, bias_cat, dt)
            h = h + rs[..., : model.bottleneck]
            skip_sum = skip_sum + rs[..., model.bottleneck :]
    return _mask_and_decode(p, head, feats, skip_sum, model.num_speakers, model.enc_dim,
                            model.win, mix.shape[1], dt)


@torch.no_grad()
def cuda_apply(model: ConvTasNet, mix: torch.Tensor) -> torch.Tensor:
    """``ConvTasNet`` forward with the TCN trunk in the ``tcn_trunk`` kernel
    (bf16, the kernel's precision contract): ``mix [B, samples]`` (a multiple
    of ``win // 2``) → fp32 ``[B, S, samples]``, the mask head's tail and
    the decoder in the ``mask_decode`` kernel; inside ``ops.plain_versions()``
    both kernels' plain versions, the reference a GPU run is compared with.
    The weights come from :func:`_serving`'s cache. Raises on a causal model.

    Inside ``ops.fixed_shape_calls()``, on a CUDA tensor outside
    ``plain_versions()`` (and outside another graph's capture), the launches
    after the lookup go through the entry's graph (:class:`_Graphs`): eager
    at a key's first call, captured at its second in a row, replayed after,
    with the same kernels on the same operands, so a replay's output equals
    the eager call's bit for bit. A replay returns a copy of the graph's
    output and runs inside a span ``sst.tasnet.graph.replay``; it calls
    neither kernel's wrapper, so their ``launches`` counters see the eager
    call and the capture only."""
    _check_mix(model, mix)
    with span("tasnet.weights"):
        w = _serving(model)
    if (not in_fixed_shape_calls() or use_plain(mix)
            or torch.cuda.is_current_stream_capturing()):
        return _launch(model, w, mix)
    stream = torch.cuda.current_stream(mix.device)
    key = _graph_key(mix, stream)
    graph = w.graphs.choose(key)
    if graph is None:
        return _launch(model, w, mix)
    if graph is _CAPTURE:
        out, graph = _capture(model, w, mix, stream)
        w.graphs.add(key, graph)
        return out
    with span("tasnet.graph.replay"):
        return graph(mix)


def _launch(model: ConvTasNet, w: "_Serving", mix: torch.Tensor) -> torch.Tensor:
    """Every launch of ``cuda_apply`` after the weights lookup."""
    dt = torch.bfloat16
    feats, h = _encode_and_project(w.p, w.head, mix, model.win, dt)
    skip_sum = tcn_trunk_cuda(h, *w.stacks, dils=w.dils, taps=model.kernel)
    return _mask_and_decode_cuda(w.p, w.head, feats, skip_sum, mix.shape[1], dt)


def _graph_key(mix: torch.Tensor, stream) -> tuple:
    """What a graph of :func:`_launch` is valid for, besides the weights:
    the input's shape, dtype and device, and the stream it replays on."""
    return tuple(mix.shape), mix.dtype, mix.device, stream.cuda_stream


_CAPTURE = object()  # _Graphs.choose's answer where the call should capture


class _Graphs:
    """Which way a weights entry serves a call, by the call's key: eager
    (``None``) at a key's first call, :data:`_CAPTURE` when the entry's last
    call had the same key, else the graph it holds for the key. It holds one
    graph; a new capture replaces it. Plain Python: it only remembers keys
    and what it is given."""

    def __init__(self):
        self.key = self.graph = None  # the held graph and its key
        self.last = None  # the key of the entry's last call

    def choose(self, key):
        previous, self.last = self.last, key
        if self.graph is not None and key == self.key:
            return self.graph
        return _CAPTURE if key == previous else None

    def add(self, key, graph) -> None:
        self.key, self.graph = key, graph


class _Replay:
    """A captured :func:`_launch`: its graph, the input it reads and the
    output it writes. Built around a copy of the call's input, before the
    capture that fills in the rest."""

    __slots__ = ("graph", "mix", "out")

    def __init__(self, mix: torch.Tensor):
        # a normal tensor even where the capture runs in inference mode, so that
        # a call outside that mode may copy into it
        with torch.inference_mode(False):
            self.mix = mix.clone()
        self.graph = self.out = None

    def __call__(self, mix: torch.Tensor) -> torch.Tensor:
        self.mix.copy_(mix)
        self.graph.replay()
        return self.out.clone()  # the static output is overwritten by the next replay


def _capture(model: ConvTasNet, w: "_Serving", mix: torch.Tensor, stream):
    """``(out, replay)``: :func:`_launch` run eager on a side stream (the
    warm-up that capture needs there, and this call's result), then captured
    there into a graph that reads a copy of ``mix``."""
    side = torch.cuda.Stream(mix.device)  # one of torch's pooled streams
    replay = _Replay(mix)
    side.wait_stream(stream)
    with torch.cuda.stream(side):
        out = _launch(model, w, replay.mix)
    replay.graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(replay.graph, stream=side, capture_error_mode="thread_local"):
        replay.out = _launch(model, w, replay.mix)
    stream.wait_stream(side)
    out.record_stream(stream)
    return out, replay


class _Serving(NamedTuple):
    """What :func:`cuda_apply` derives from the module's parameters alone."""

    p: dict[str, torch.Tensor]  # fp32, detached
    stacks: tuple  # the trunk kernel's (we, wdw, wg, vecs)
    head: _Head  # bf16
    dils: tuple[int, ...]
    graphs: _Graphs  # of _launch on these operands, under ops.fixed_shape_calls()


# module -> (validity key, operands, the parameters as the key saw them); an
# entry dies with its module, which carries nothing of it
_SERVING: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _build_serving(model: ConvTasNet) -> _Serving:
    p = _params(model)
    stacks = stack_tcn_weights(p, blocks=model.blocks, repeats=model.repeats)
    return _Serving(p, stacks, _head(p, torch.bfloat16), _dilations(model), _Graphs())


def _leaves(module: torch.nn.Module, out: list) -> list:
    """Every parameter of ``module``, in ``parameters()``'s order, read from
    the modules' own tables: a fifth of ``parameters()``'s host time, which
    builds names and drops duplicates that a key has no use for."""
    for q in module._parameters.values():
        if q is not None:
            out.append(q)
    for child in module._modules.values():
        if child is not None:
            _leaves(child, out)
    return out


def _serving(model: ConvTasNet) -> _Serving:
    """``cuda_apply``'s operands for ``model``: the cached ones while every
    parameter is as it was when they were built, else built anew and cached.

    The key is each parameter's ``(data_ptr(), _version)``. It sees an
    in-place update (an optimizer's ``add_`` under ``no_grad``,
    ``load_state_dict``'s ``copy_``) through the version counter, and new
    storage (``module.to(...)`` to another device or dtype, ``param.data =
    ...``, a new ``Parameter``) through the address: the entry holds the
    parameters' old storage, so no other tensor can take its address while
    the entry stands, and a device or dtype changes only with the storage
    (reading them too would add half again to a hit's host time). A write
    through ``p.data`` bypasses the version counter, as it does for autograd,
    and is not seen. Parameters made under ``torch.inference_mode()`` keep no
    version counter, so their operands are built every call. A caller that
    changes the weights between calls misses every time: the build it would
    have paid anyway, plus the key. A hit is marked by a span
    ``sst.tasnet.weights.hit``, recorded once the key has matched."""
    params = _leaves(model, [])
    try:
        key = tuple([(q.data_ptr(), q._version) for q in params])
    except RuntimeError:  # inference tensors: no version counter to validate an entry by
        return _build_serving(model)
    entry = _SERVING.get(model)
    if entry is not None and entry[0] == key:
        with span("tasnet.weights.hit"):
            return entry[1]
    served = _build_serving(model)
    _SERVING[model] = (key, served, [q.detach() for q in params])
    return served


def _dilations(model: ConvTasNet) -> tuple[int, ...]:
    return tuple(2**x for _ in range(model.repeats) for x in range(model.blocks))


def train_apply(model: ConvTasNet, mix: torch.Tensor) -> torch.Tensor:
    """``ConvTasNet`` forward for training, differentiable in the module's
    parameters, with the TCN trunk in the training kernels (bf16, the
    kernels' contract): ``mix [B, samples]`` (a multiple of ``win // 2``) →
    fp32 ``[B, S, samples]``; inside ``ops.plain_versions()`` the trunk's
    plain versions. Raises on a causal model."""
    _check_mix(model, mix)
    dt = torch.bfloat16
    p = _params(model, live=True)
    head = _head(p, dt)
    feats, h = _encode_and_project(p, head, mix, model.win, dt)
    arrays = stack_canonical(p, blocks=model.blocks, repeats=model.repeats)
    skip_sum = tcn_trunk_train(h, *arrays, dils=_dilations(model), taps=model.kernel)
    return _mask_and_decode(p, head, feats, skip_sum, model.num_speakers, model.enc_dim,
                            model.win, mix.shape[1], dt)
