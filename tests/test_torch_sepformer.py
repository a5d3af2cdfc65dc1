"""PyTorch port, SepFormer (``models/sepformer.py``) and the attention core
(``ops/attention.py``) on the CPU at toy widths: the module against the
benchmark's plain reference (``bench_torch/reference/sepformer.py``) forward
and through the SI-SDR PIT loss's gradients, bf16 serving, the attention's
plain version against the written-out product, the positions, the parameter
count at the published widths, the refusals, the profiler spans, ``cli
train --variant sepformer`` and ``cli separate``, and DPRNN's outputs bit for
bit through the dual-path scaffold the two models share. One CPU thread."""

from __future__ import annotations

import json
import math
import pathlib
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from scipy.io import wavfile
from torch.profiler import ProfilerActivity, profile

from bench_torch.reference import dprnn as dprnn_reference
from bench_torch.reference import sepformer as reference
from speech_separation_tpu_torch import cli, ops
from speech_separation_tpu_torch.data.fixture import make_synthetic_fixture
from speech_separation_tpu_torch.losses import pit_si_sdr_loss
from speech_separation_tpu_torch.models import dprnn
from speech_separation_tpu_torch.models.dprnn import DPRNN
from speech_separation_tpu_torch.models.sepformer import (
    SepFormer,
    positional_encoding,
    products_in_bf16,
    serving_fn,
)
from speech_separation_tpu_torch.models import sepformer
from speech_separation_tpu_torch.ops import layer_norm_cuda
from speech_separation_tpu_torch.ops.attention import attention, attention_plain
from speech_separation_tpu_torch.ops.layer_norm_cuda import (
    residual_layer_norm,
    residual_layer_norm_plain,
)
from speech_separation_tpu_torch.utils import UPitTrainConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOY = dict(num_speakers=2, enc_dim=16, win=16, d_model=32, heads=4, ffn=64, layers=2, chunk=8,
           blocks=1)
FORWARD_REL = 1e-5  # fp32 on both sides, sums in other orders
GRAD_REL = 1e-4  # relative L2 of each parameter's gradient against the reference's autograd
# bf16 serving against fp32: 8-bit mantissas in every product of 2 x 2 layers
# and the mask head, the stream fp32 (the toy reads 42-43 dB over three seeds)
BF16_DB = 30.0


@pytest.fixture(autouse=True)
def _one_thread():
    """One CPU thread for torch: the toy's small ops run far slower when the
    test workers' thread pools oversubscribe the cores, and the bit-for-bit
    comparisons need one summation order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _toy(seed: int = 7, **widths) -> tuple[SepFormer, dict, dict]:
    """The toy model with the reference's seeded weights, and its widths."""
    cfg = {**TOY, **widths}
    weights = reference.make_weights(cfg, seed, "cpu")
    model = SepFormer(**cfg)
    model.load_state_dict(weights)
    return model.eval(), weights, cfg


def _mix(shape, seed: int = 0) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("samples", [1200, 504])  # 150 and 63 frames: 39 and 17 chunks of 8
def test_forward_matches_the_reference(samples):
    model, weights, cfg = _toy()
    mix = _mix((3, samples), seed=1)
    with torch.no_grad():
        got = model(mix)
    want = reference.separate(weights, cfg, mix)
    assert got.shape == want.shape == (3, 2, samples) and got.dtype == torch.float32
    assert _rel(got, want) <= FORWARD_REL


def test_pit_si_sdr_gradients_match_the_reference_autograd():
    model, weights, cfg = _toy(seed=8)
    mix = _mix((2, 400), seed=2)
    sources = _mix((2, 2, 400), seed=3)
    lengths = torch.tensor([400, 328])
    pit_si_sdr_loss(model(mix), sources, lengths).backward()
    params = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    loss = pit_si_sdr_loss(reference.forward(params, cfg, mix), sources, lengths)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    for name, p in model.named_parameters():
        assert _rel(p.grad, grads[name]) <= GRAD_REL, name


def test_bf16_serving_keeps_the_stream_and_the_ends_in_fp32():
    model, _, _ = _toy()
    mix = _mix((2, 640), seed=4)
    want = serving_fn(model)(mix)
    got = serving_fn(model, bf16=True)(mix)
    assert got.dtype == torch.float32 and next(model.parameters()).dtype == torch.float32
    snr = 10 * math.log10(want.square().sum().item() / (got - want).square().sum().item())
    assert snr >= BF16_DB
    # the products' weights in bf16; the encoder, decoder and norms in fp32
    net = products_in_bf16(model)
    dtypes = {k: v.dtype for k, v in net.state_dict().items()}
    assert dtypes["encoder.kernel"] == dtypes["decoder.kernel"] == torch.float32
    assert dtypes["dp_0.intra.layer_0.attn_in.kernel"] == dtypes["mask_out.kernel"] == torch.bfloat16
    assert dtypes["dp_0.intra.norm.gamma"] == dtypes["dp_0.intra_norm.gamma"] == torch.float32
    # the residual stream in and out of a layer and a block; after the stream,
    # a layer gives the next LN's rows: bf16 for the next in-projection, fp32
    # for the final norm (gLN reads it)
    seen = {}

    def hook(name):
        def record(module, args, out):
            stream, *rows = out if isinstance(out, tuple) else (out,)
            seen.setdefault(name, (args[0].dtype, stream.dtype, *(r.dtype for r in rows)))

        return record

    for name, module in (("layer", net.dp_0.intra.layer_1), ("layer_0", net.dp_0.intra.layer_0),
                         ("block", net.dp_0)):
        module.register_forward_hook(hook(name))
    with torch.no_grad():
        torch.testing.assert_close(net(mix), got, rtol=0, atol=0)
    f32 = torch.float32
    assert seen == {"layer": (f32, f32, f32), "layer_0": (f32, f32, torch.bfloat16),
                    "block": (f32, f32)}


def test_attention_plain_is_the_written_out_product():
    q, k, v = (_mix((3, 4, 11, 8), seed=s).double() for s in (5, 6, 7))
    scores = torch.einsum("nhld,nhmd->nhlm", q, k) / math.sqrt(8)
    want = torch.einsum("nhlm,nhmd->nhld", torch.exp(scores) / torch.exp(scores).sum(-1, keepdim=True), v)
    for dtype, rel in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
        got = attention_plain(q.to(dtype), k.to(dtype), v.to(dtype))
        assert got.dtype == dtype and _rel(got.double(), want) <= rel
    # a CPU tensor, or the scoped switch, takes the plain version
    args = (q.float(), k.float(), v.float())
    assert torch.equal(attention(*args), attention_plain(*args))
    with ops.plain_versions():
        assert torch.equal(attention(*args), attention_plain(*args))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("branch", [torch.bfloat16, torch.float32, None], ids=["bf16", "fp32", "none"])
def test_residual_layer_norm_plain_is_the_add_the_norm_and_the_cast(branch, out_dtype):
    x = _mix((3, 5, 32), seed=20)
    y = None if branch is None else _mix((3, 5, 32), seed=21).to(branch)
    gamma, beta = 1 + 0.1 * _mix((32,), seed=22), _mix((32,), seed=23)
    want_sum = x if y is None else x + y.float()
    want = F.layer_norm(want_sum, (32,), gamma, beta, 1e-6).to(out_dtype)
    got_sum, got = residual_layer_norm_plain(x, y, gamma, beta, out_dtype)
    assert got.dtype == out_dtype and torch.equal(got_sum, want_sum) and torch.equal(got, want)
    assert (got_sum is x) == (y is None)  # nothing added, nothing copied
    # a CPU tensor, or the scoped switch, takes the plain version; x is not written
    before = x.clone()
    for switch in (False, True):
        with ops.plain_versions(switch):
            s, h = residual_layer_norm(x, y, gamma, beta, out_dtype)
        assert torch.equal(s, want_sum) and torch.equal(h, want) and torch.equal(x, before)


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


def test_residual_layer_norm_takes_the_plain_version_wherever_autograd_records():
    """On a device with a kernel (a meta tensor stands for one here) the
    wrapper runs the plain version under grad mode with a tensor that
    requires a gradient, and otherwise goes for the kernel, which a meta
    tensor does not reach."""
    x, y = _meta(4, 16), _meta(4, 16, dtype=torch.bfloat16)
    gamma, beta = _meta(16, grad=True), _meta(16, grad=True)
    s, h = residual_layer_norm(x, y, gamma, beta, torch.bfloat16)
    assert h.grad_fn is not None and h.dtype == torch.bfloat16 and s.device.type == "meta"
    for grad_mode, leaves in ((False, (gamma, beta)), (True, (gamma.detach(), beta.detach()))):
        with torch.set_grad_enabled(grad_mode), pytest.raises(ValueError, match="one CUDA device"):
            residual_layer_norm(x, y, *leaves, torch.bfloat16)
    with torch.inference_mode(), pytest.raises(ValueError, match="one CUDA device"):
        residual_layer_norm(x, None, gamma, beta, torch.float32)
    with ops.plain_versions(), torch.no_grad():
        assert residual_layer_norm(x, y, gamma, beta, torch.float32)[1].dtype == torch.float32


@pytest.mark.parametrize("case", ["wide", "strided", "bf16_stream", "fp16_branch", "fp16_out",
                                  "gamma"])
def test_residual_layer_norm_refuses_what_the_kernel_does_not_take(case):
    d = 1025 if case == "wide" else 64
    x = _meta(6, 2 * d)[:, :d] if case == "strided" else _meta(6, d)
    if case == "bf16_stream":
        x = x.to(torch.bfloat16)
    y = _meta(6, d, dtype=torch.float16 if case == "fp16_branch" else torch.bfloat16)
    gamma = _meta(d + 1 if case == "gamma" else d)
    out = torch.float16 if case == "fp16_out" else torch.bfloat16
    error, match = {"wide": (ValueError, "1 to 1024"), "strided": (ValueError, "contiguous"),
                    "bf16_stream": (TypeError, "must be fp32"),
                    "fp16_branch": (TypeError, "bf16 or fp32 of x's shape"),
                    "fp16_out": (TypeError, "writes bf16 or fp32"),
                    "gamma": (ValueError, "gamma and beta")}[case]
    with torch.no_grad(), pytest.raises(error, match=match):
        residual_layer_norm(x, y, gamma, _meta(d), out)


def test_residual_layer_norm_constants_match_the_kernel():
    src = (ROOT / "speech_separation_tpu_torch" / "csrc" / "residual_layer_norm.cu").read_text()
    # eps is the entry's argument; SepFormer's 1e-6 is the wrapper's default
    assert re.search(r"int y_bf16, int out_bf16,\s+float eps, void\* stream\)", src)
    assert "+ eps);" in src and layer_norm_cuda.EPS == 1e-6
    assert int(re.search(r"kMaxDim = (\d+);", src).group(1)) == layer_norm_cuda.MAX_DIM == 1024
    assert "residual_layer_norm_kernel" in src  # the name the benchmark's LN readers find


def _stack_before_fusing(stack, x):
    """The transformer stack as written before its adds were fused with its
    norms: x + MHA(LN(x)), then x + FFN(LN(x)), each LN fp32 and cast by the
    product that reads it, then the final LN."""
    def norm(ln, v):
        return F.layer_norm(v.float(), ln.gamma.shape, ln.gamma.float(), ln.beta.float(), 1e-6)

    def product(conv, v):
        return conv.pointwise(v.to(conv.kernel.dtype))

    x = x.float() + positional_encoding(x.shape[1], x.shape[2], x.device)
    for j in range(stack.layers):
        layer = getattr(stack, f"layer_{j}")
        r, length, d = x.shape
        qkv = product(layer.attn_in, norm(layer.attn_norm, x))
        q, k, v = qkv.view(r, length, 3, layer.heads, d // layer.heads).permute(2, 0, 3, 1, 4).unbind(0)
        y = attention(q, k, v).transpose(1, 2).reshape(r, length, d)
        x = x + product(layer.attn_out, y)
        h = torch.relu(product(layer.ffn_in, norm(layer.ffn_norm, x)))
        x = x + product(layer.ffn_out, h)
    return norm(stack.norm, x)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_fused_stack_equals_the_unfused_layer_order_bit_for_bit(monkeypatch, bf16):
    model, _, _ = _toy(seed=11)
    net = products_in_bf16(model) if bf16 else model
    mix = _mix((2, 640), seed=12)
    rows = _mix((3, 8, TOY["d_model"]), seed=13)
    with torch.no_grad():
        fused, stack = net(mix), net.dp_0.intra(rows)
        assert torch.equal(stack, _stack_before_fusing(net.dp_0.intra, rows))
        monkeypatch.setattr(sepformer._TransformerStack, "forward", _stack_before_fusing)
        assert torch.equal(fused, net(mix))
    assert stack.dtype == fused.dtype == torch.float32


def test_state_dict_keys_are_unchanged():
    model, weights, _ = _toy()
    layer = ["attn_norm.gamma", "attn_norm.beta", "attn_in.kernel", "attn_in.bias",
             "attn_out.kernel", "attn_out.bias", "ffn_norm.gamma", "ffn_norm.beta",
             "ffn_in.kernel", "ffn_in.bias", "ffn_out.kernel", "ffn_out.bias"]
    stack = [f"layer_{j}.{name}" for j in range(TOY["layers"]) for name in layer]
    want = {f"dp_0.{part}.{name}" for part in ("intra", "inter")
            for name in (*stack, "norm.gamma", "norm.beta")}
    keys = set(model.state_dict())
    assert {k for k in keys if k.startswith(("dp_0.intra.", "dp_0.inter."))} == want
    assert keys == set(weights)


def test_positions_are_the_published_sinusoids():
    pe = positional_encoding(250, 256)
    assert pe.shape == (250, 256) and pe.dtype == torch.float32
    for p, i in ((0, 0), (1, 0), (7, 3), (249, 127), (81, 64)):
        angle = p / 10000 ** (2 * i / 256)
        assert pe[p, 2 * i].item() == pytest.approx(math.sin(angle), abs=1e-7)
        assert pe[p, 2 * i + 1].item() == pytest.approx(math.cos(angle), abs=1e-7)


def test_parameter_count_at_the_published_widths_equals_the_config():
    cfg = json.loads((ROOT / "bench_torch" / "configs" / "sepformer.json").read_text())
    with torch.device("meta"):
        model = SepFormer()  # the defaults are the published widths
    count = sum(p.numel() for p in model.parameters())
    # 32 layers of 789,760, 4 final LNs and 4 gLNs of 512, 402,945 outside the blocks
    assert count == 32 * 789_760 + 8 * 512 + 402_945 == cfg["parameters"] == 25_679_361
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == reference.param_shapes(cfg)
    widths = ("enc_dim", "win", "d_model", "heads", "ffn", "layers", "chunk", "blocks")
    assert tuple(cfg[k] for k in widths) == (256, 16, 256, 8, 1024, 8, 250, 2)
    assert cfg["reduced"] == []


def test_odd_chunks_and_heads_that_do_not_divide_are_refused():
    for chunk in (251, 0):
        with pytest.raises(ValueError, match="chunk must be even"):
            SepFormer(**{**TOY, "chunk": chunk})
    for heads in (3, 0):
        with pytest.raises(ValueError, match="do not divide d_model"):
            SepFormer(**{**TOY, "heads": heads})
    with pytest.raises(ValueError, match="even d_model"):
        SepFormer(**{**TOY, "d_model": 33, "heads": 3})
    with pytest.raises(ValueError, match="multiple of win//2"):
        SepFormer(**TOY)(torch.zeros(1, 9))
    UPitTrainConfig(variant="sepformer")


def _spans(prof, name: str) -> list[tuple[int, int]]:
    return sorted((e.time_range.start, e.time_range.end) for e in prof.events() if e.name == name)


def test_spans_once_a_block_a_forward():
    model, _, _ = _toy(blocks=2)
    mix = _mix((2, 320), seed=9)
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        traced = [model(mix) for _ in range(2)]
    intra, inter = _spans(prof, "sst.sepformer.intra"), _spans(prof, "sst.sepformer.inter")
    assert len(intra) == len(inter) == 2 * 2
    assert all(a[1] <= b[0] for a, b in zip(intra, inter))  # intra, then inter, a block
    assert len(_spans(prof, "sst.sepformer.encode")) == len(_spans(prof, "sst.sepformer.decode")) == 2
    with torch.no_grad():
        assert all(torch.equal(t, model(mix)) for t in traced)


def test_spans_build_nothing_with_the_profiler_off(monkeypatch):
    built = []
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", lambda name: built.append(name))
    model, _, _ = _toy()
    with torch.no_grad():
        model(_mix((1, 160)))
    assert built == []


CLI_TOY = {"batch_size": 2, "sepformer_enc_dim": 16, "sepformer_d_model": 16, "sepformer_heads": 2,
           "sepformer_ffn": 32, "sepformer_layers": 1, "sepformer_chunk": 8, "sepformer_blocks": 1}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``cli train --variant sepformer`` for two epochs on a two-utterance
    fixture of 0.1-0.2 s: 100 to 200 frames at stride 8, 26 to 51 chunks of 8."""
    tmp = tmp_path_factory.mktemp("sepformer_cli")
    root = make_synthetic_fixture(tmp / "fx", utterances_per_split=2, min_seconds=0.1,
                                  max_seconds=0.2, seed=5)
    cfg = tmp / "cfg.json"
    cfg.write_text(json.dumps(CLI_TOY))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cli.main(["train", "--config", str(cfg), "--variant", "sepformer", "--data-root", str(root),
                  "--epochs", "2", "--checkpoint-dir", str(tmp / "ckpt"), "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    return root, tmp / "ckpt"


def test_cli_train_writes_a_sepformer_checkpoint(trained):
    _, ckpt = trained
    saved = json.loads((ckpt / "train_config.json").read_text())
    assert saved["variant"] == "sepformer" and saved["sepformer_chunk"] == 8
    lines = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    epochs = [r for r in lines if "epoch" in r]
    assert len(epochs) == 2 and all(math.isfinite(r["val_loss"]) for r in epochs)


@pytest.mark.parametrize("extra", [[], ["--bf16"], ["--chunk-seconds", "0.05",
                                                    "--chunk-overlap-seconds", "0.0125"]],
                         ids=["whole", "bf16", "chunked"])
def test_cli_separate_serves_the_checkpoint(trained, tmp_path, capsys, extra):
    root, ckpt = trained
    cli.main(["separate", "--checkpoint-dir", str(ckpt), "--data-root", str(root), "--out-dir",
              str(tmp_path / "sep"), "--device", "cpu", *extra])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    wavs = sorted((tmp_path / "sep").glob("*.wav"))
    assert report["written"] == len(wavs) == 4
    for p in wavs:  # each of its mixture's true length, not silent
        pcm = wavfile.read(p)[1]
        assert len(pcm) == len(wavfile.read(root / "tt" / "mix" / (p.name[:-7] + ".wav"))[1])
        assert np.abs(pcm).max() > 0


@pytest.mark.parametrize("extra,match", [(["--streaming-hop-seconds", "0.5"], "streaming"),
                                         (["--kernel", "pallas"], "kernel pallas")])
def test_cli_separate_refuses_what_sepformer_does_not_serve(trained, tmp_path, extra, match):
    root, ckpt = trained
    with pytest.raises(SystemExit, match=match):
        cli.main(["separate", "--checkpoint-dir", str(ckpt), "--data-root", str(root),
                  "--out-dir", str(tmp_path / "sep"), "--device", "cpu", *extra])
    assert not (tmp_path / "sep").exists()


DPRNN_TOY = dict(num_speakers=2, enc_dim=8, win=2, bottleneck=8, hidden=16, chunk=10, blocks=2)


def _block_forward_before_sharing(block, x):
    """DPRNN's block as it was written before SepFormer shared its scaffold."""
    b, s, k, n = x.shape
    y = block.intra_proj.pointwise(block.intra_rnn(x.reshape(b * s, k, n)))
    x = x + block.intra_norm(y.view(b, s * k, n)).view(b, s, k, n)
    y = block.inter_proj.pointwise(block.inter_rnn(x.transpose(1, 2).reshape(b * k, s, n)))
    y = block.inter_norm(y.view(b, k * s, n)).view(b, k, s, n)
    return x + y.transpose(1, 2)


def _dprnn_outputs(model: DPRNN, mix: torch.Tensor) -> dict[str, torch.Tensor]:
    with torch.no_grad():
        outs = {"serve": model(mix)}
    model.zero_grad(set_to_none=True)
    trained_out = model(mix)
    trained_out.square().sum().backward()
    outs["train"] = trained_out.detach()
    outs["grad"] = torch.cat([p.grad.flatten() for p in model.parameters()])
    return outs


def test_dprnn_bit_for_bit_through_the_shared_scaffold(monkeypatch):
    """DPRNN served and trained through ``_DualPathBlock`` equals its block
    as written before, and running a SepFormer in between moves nothing."""
    weights = dprnn_reference.make_weights(DPRNN_TOY, 3, "cpu")
    model = DPRNN(**DPRNN_TOY)
    model.load_state_dict(weights)
    mix = _mix((2, 90), seed=10)
    shared = _dprnn_outputs(model, mix)
    sepformer, _, _ = _toy()
    serving_fn(sepformer, bf16=True)(_mix((2, 160)))
    sepformer(_mix((1, 160))).sum().backward()
    again = _dprnn_outputs(model, mix)
    with monkeypatch.context() as m:
        m.setattr(dprnn._RecurrentBlock, "forward", _block_forward_before_sharing)
        before = _dprnn_outputs(model, mix)
    for name in ("serve", "train", "grad"):
        assert torch.equal(shared[name], before[name]), name
        assert torch.equal(again[name], before[name]), name
