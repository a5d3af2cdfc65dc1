"""PyTorch port, the mask-and-decode kernel's plain version and wrapper on the
CPU (``ops/mask_decode_cuda.py``): against the chain of PyTorch operations it
replaces in ``cuda_apply`` (``models/tasnet_serving.py::_mask_and_decode``:
bias, sigmoid, × feats, ``decode``, ``.float()``, trim), the wrapper's
refusals, its launch counter, and ``cuda_apply``'s tail against
``fused_apply``. The kernel itself runs in ``tests/test_torch_cuda.py``.

The refusals are checked on the ``meta`` device: a tensor that is not on the
CPU goes through every check the kernel's path makes, and a call that passes
them all is refused only for its device, before any launch.
"""

import numpy as np
import pytest
import torch

from speech_separation_tpu_torch.models.tasnet import ConvTasNet, conv_transpose_pads, decode
from speech_separation_tpu_torch.models.tasnet_serving import cuda_apply, fused_apply
from speech_separation_tpu_torch.ops import mask_decode_cuda
from speech_separation_tpu_torch.ops.mask_decode_cuda import mask_decode, mask_decode_plain

# fp32: the same sums in another order (measured ~1e-7 of the largest sample)
FP32_REL = 1e-5
# bf16 against today's chain with the kernel's roundings (v once to bf16, the
# decoder's output to bf16): that output rounding alone, half a bf16 ulp of
# each sample (measured 0.5), plus the sums' order
MATCHED_ULPS = 1.0
# bf16 against today's chain as it is: its bias add and sigmoid round to bf16
# besides, each ~2^-9 relative, and so does its output (measured 2.5e-3 to
# 3.3e-3 relative L2)
CHAIN_REL = 2.0**-8
BF16_PAIR_DB = 30.0  # two bf16 pipelines (tests/test_torch_tasnet.py)


def _chain(logits, mask_b, feats, dec_k, dec_b, samples, *, kernel_roundings=False):
    """``_mask_and_decode`` from the product on; with ``kernel_roundings`` the
    bias, sigmoid and product in fp32 and rounded once, as the kernel does."""
    b, k, n = feats.shape
    s, win = logits.shape[2] // n, dec_k.shape[0]
    if kernel_roundings:
        masks = torch.sigmoid(logits.float() + mask_b.float())
        masked = (masks.view(b, k, s, n) * feats.float()[:, :, None, :]).to(feats.dtype)
    else:
        masks = torch.sigmoid(logits + mask_b)
        masked = masks.view(b, k, s, n) * feats[:, :, None, :]
    masked = masked.transpose(1, 2).reshape(b * s, k, n)
    wav = decode(masked, dec_k, dec_b, win)
    return wav.reshape(b, s, -1).float()[:, :, :samples]


def _operands(batch, frames, win, dtype, channels=64, speakers=2, seed=0, device="cpu"):
    """``(logits, mask_b, feats, dec_k, dec_b)``, feats the transposed view of a
    contiguous ``[B, N, K]`` as the encoder leaves it."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(batch, frames, speakers * channels, generator=g)
    mask_b = 0.1 * torch.randn(speakers * channels, generator=g)
    feats = torch.relu(torch.randn(batch, channels, frames, generator=g)).transpose(1, 2)
    dec_k = torch.randn(win, channels, 1, generator=g) / np.sqrt(channels)
    dec_b = 0.1 * torch.randn(1, generator=g)
    return tuple(t.to(device, dtype) for t in (logits, mask_b, feats, dec_k, dec_b))


def _bf16_ulps(got, want):
    """The largest |got − want| in bf16 ulps of each ``want``."""
    _, e = torch.frexp(want.abs().clamp_min(2.0**-100))
    return ((got - want).abs() / torch.ldexp(torch.ones_like(want), e - 8)).max().item()


def _rel(got, want):
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("win", [40, 16])
@pytest.mark.parametrize("frames", [800, 131])
@pytest.mark.parametrize("batch", [1, 3])
def test_plain_matches_todays_chain(batch, frames, win, dtype):
    ops = _operands(batch, frames, win, dtype)
    samples = frames * (win // 2)
    got = mask_decode_plain(*ops, samples)
    want = _chain(*ops, samples)
    assert got.dtype == torch.float32 and got.shape == want.shape == (batch, 2, samples)
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= FP32_REL * want.abs().max().item()
        return
    assert _bf16_ulps(got, _chain(*ops, samples, kernel_roundings=True)) <= MATCHED_ULPS
    assert _rel(got, want) <= CHAIN_REL
    # fewer roundings: at least as close to the fp32 chain on the same operands
    exact = _chain(*(t.float() for t in ops), samples)
    assert _rel(got, exact) <= _rel(want, exact)


@pytest.mark.parametrize("samples_short", [0, 1, 7, 20])
def test_plain_trims_to_the_samples_asked_for(samples_short):
    ops = _operands(2, 50, 40, torch.float32, seed=1)
    full = mask_decode_plain(*ops, 50 * 20)
    got = mask_decode_plain(*ops, 50 * 20 - samples_short)
    assert torch.equal(got, full[..., : 50 * 20 - samples_short])


def test_plain_reads_either_feats_layout():
    logits, mask_b, feats, dec_k, dec_b = _operands(2, 131, 16, torch.bfloat16, seed=2)
    assert not feats.is_contiguous()
    want = mask_decode_plain(logits, mask_b, feats, dec_k, dec_b, 131 * 8)
    got = mask_decode_plain(logits, mask_b, feats.contiguous(), dec_k, dec_b, 131 * 8)
    assert torch.equal(got, want)


@pytest.mark.parametrize("win", [2, 3, 16, 17, 20, 32, 40, 64])
def test_left_offset_is_the_transposed_convs(win):
    ops = _operands(1, 9, win, torch.float32, channels=16, seed=3)
    speakers, w, stride, left = mask_decode_cuda._shape(ops[0], ops[2], ops[3], 9 * (win // 2))
    assert (speakers, w, stride) == (2, win, win // 2)
    assert left == conv_transpose_pads(win, win // 2)[0]
    got = mask_decode_plain(*ops, 9 * (win // 2))
    want = _chain(*ops, 9 * (win // 2))
    assert (got - want).abs().max().item() <= FP32_REL * want.abs().max().item()


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    ops = _operands(1, 64, 40, torch.bfloat16, seed=4)
    before = mask_decode.launches
    got = mask_decode(*ops, 64 * 20)
    assert mask_decode.launches == before
    assert torch.equal(got, mask_decode_plain(*ops, 64 * 20))


def _meta(batch=1, frames=64, win=40, channels=64, dtype=torch.bfloat16):
    return list(_operands(batch, frames, win, dtype, channels=channels, device="meta"))


def _refused(ops, samples, error, match):
    before = mask_decode.launches
    with pytest.raises(error, match=match):
        mask_decode(*ops, samples)
    assert mask_decode.launches == before


def test_a_call_that_passes_every_check_is_refused_only_off_a_cuda_device():
    _refused(_meta(), 64 * 20, ValueError, "one CUDA device")


@pytest.mark.parametrize("which", range(5))
def test_refuses_operands_other_than_bf16(which):
    ops = _meta()
    ops[which] = ops[which].float()
    _refused(ops, 64 * 20, TypeError, "bf16")


@pytest.mark.parametrize("case, match", [
    ("logits_columns", "no multiple"),
    ("batch_differs", "logits \\[B, K, S·N\\]"),
    ("dec_k_channels", "dec_k"),
    ("mask_b", "mask_b"),
    ("dec_b", "dec_b"),
    ("too_many_samples", "samples"),
    ("channels_not_8", "multiple of 8"),
    ("channels_past_512", "multiple of 8"),
    ("win_past_64", "win up to"),
])
def test_refuses_shapes(case, match):
    ops, samples = _meta(), 64 * 20
    if case == "logits_columns":
        ops[0] = ops[0][..., :-1].contiguous()
    elif case == "batch_differs":
        ops[0] = torch.cat([ops[0], ops[0]])
    elif case == "dec_k_channels":
        ops[3] = ops[3][:, :32].contiguous()
    elif case == "mask_b":
        ops[1] = ops[1][:64].contiguous()
    elif case == "dec_b":
        ops[4] = torch.cat([ops[4], ops[4]])
    elif case == "too_many_samples":
        samples += 1
    elif case == "channels_not_8":
        ops, samples = _meta(channels=20), 64 * 20
    elif case == "channels_past_512":
        ops, samples = _meta(channels=528), 64 * 20
    else:
        ops, samples = _meta(win=66), 64 * 33
    _refused(ops, samples, ValueError, match)


@pytest.mark.parametrize("which", ["logits", "mask_b", "dec_k", "feats", "feats_frames_major"])
def test_refuses_non_contiguous_operands(which):
    ops = _meta()
    meta = dict(device="meta", dtype=torch.bfloat16)
    if which == "logits":
        ops[0] = torch.empty(1, 64, 256, **meta)[..., :128]
    elif which == "mask_b":
        ops[1] = torch.empty(256, **meta)[::2]
    elif which == "dec_k":
        ops[3] = torch.empty(80, 64, 1, **meta)[::2]
    elif which == "feats":  # the transpose of no contiguous array
        ops[2] = torch.empty(1, 64, 128, **meta)[..., ::2]
    else:  # contiguous [B, K, N]: the kernel reads the encoder's [B, N, K]
        ops[2] = ops[2].contiguous()
    _refused(ops, 64 * 20, ValueError, "contiguous")


def _model(win):
    return ConvTasNet(enc_dim=64, win=win, bottleneck=32, hidden=48, blocks=4, repeats=2,
                      generator=torch.Generator().manual_seed(5)).eval()


@pytest.mark.parametrize("win", [16, 40])
def test_cuda_apply_tail_matches_fused_apply(win):
    """``cuda_apply`` on a CPU tensor (the trunk's and the tail's plain
    versions) against ``fused_apply`` in bf16, which ends in today's chain."""
    model = _model(win)
    for p in model.parameters():  # move norms, biases and slopes off their init
        p.data += 0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel()))
    mix = 0.3 * torch.randn(2, 130 * (win // 2), generator=torch.Generator().manual_seed(6))
    got = cuda_apply(model, mix)
    want = fused_apply(model, mix)
    assert got.shape == want.shape == (2, 2, mix.shape[1]) and got.dtype == torch.float32
    snr = 10 * torch.log10(want.double().square().sum() / (got - want).double().square().sum())
    assert snr.item() >= BF16_PAIR_DB
