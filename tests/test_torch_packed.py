"""PyTorch port, sequence-packed BLSTM training against the JAX reference on
the CPU: the carry gate, the row planner and the packed loader, the packed
PIT loss, the model's ``segment_ids`` (serving and training forward), the
packed and device-resident steps, and ``cli train`` with ``pack=true``.

Inputs come from numpy seeds and go through both packages; JAX's Pallas
training kernels run in interpret mode, the port's wrappers take their
kernels' plain versions (the tensors lie on the CPU). The oracles are those
of ``tests/test_packed.py``: packed equals each utterance run alone.
"""

import importlib
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_separation_tpu import cli as jax_cli
from speech_separation_tpu import train as jtrain
from speech_separation_tpu.data.device_dataset import ResidentPackedCorpus as JaxResidentCorpus
from speech_separation_tpu.data.packing import PackedWaveformLoader as JaxPackedLoader
from speech_separation_tpu.data.packing import plan_rows as jax_plan_rows
from speech_separation_tpu.losses.pit import pit_loss_packed as jax_pit_loss_packed
from speech_separation_tpu.models import UPitBlstm as JaxUPitBlstm
from speech_separation_tpu.models.blstm import segment_keep as jax_segment_keep
from speech_separation_tpu.models.upit import upit_blstm_train_forward
from speech_separation_tpu_torch import cli, train
from speech_separation_tpu_torch.data.datasets import WaveformLoader
from speech_separation_tpu_torch.data.device_dataset import ResidentPackedCorpus
from speech_separation_tpu_torch.data.fixture import make_synthetic_fixture
from speech_separation_tpu_torch.data.packing import PackedWaveformLoader, plan_rows
from speech_separation_tpu_torch.losses.pit import pit_loss, pit_loss_packed
from speech_separation_tpu_torch.models.blstm import segment_keep, segment_keeps
from speech_separation_tpu_torch.models.upit import UPitBlstm
from speech_separation_tpu_torch.train.steps import _packed_loss
from speech_separation_tpu_torch.utils import UPitTrainConfig, load_config
from speech_separation_tpu_torch.weights import upit_blstm_params, upit_blstm_state_dict

jax_config = importlib.import_module("speech_separation_tpu.utils.config")
jsteps = importlib.import_module("speech_separation_tpu.train.steps")

PIT_RTOL = 1e-5  # fp32 sums of the same squared errors in another order
FWD_TOL = 1e-5  # fp32 forward against the flax scan and JAX's interpret kernels
STEP_RTOL = 1e-4  # three fp32 packed train steps: STFT, network, packed loss, Adam
SMALL = dict(hidden=16, num_layers=2)
SIZE, SHIFT = 64, 32  # the STFT of tests/test_packed.py: short rows, many frames
BINS = SIZE // 2 + 1
FIXTURE = dict(utterances_per_split={"tr": 7, "cv": 3, "tt": 5}, min_seconds=0.4, max_seconds=0.9)
LOADER = dict(row_seconds=1.5, stft_size=SIZE, stft_shift=SHIFT)


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def fixture_tree(tmp_path_factory):
    return make_synthetic_fixture(tmp_path_factory.mktemp("packed_fixture"), **FIXTURE)


def _pack_rows(utts, row_t):
    """Per-utterance ``[1, K_u, F]`` arrays packed into one row with one
    guard frame between: ``(row [1, T, F], seg [1, T], spans)``."""
    row = np.zeros((1, row_t, utts[0].shape[-1]), np.float32)
    seg = np.full((1, row_t), -1, np.int32)
    spans, q = [], 0
    for si, u in enumerate(utts):
        k = u.shape[1]
        row[0, q : q + k], seg[0, q : q + k] = u[0], si
        spans.append((q, q + k))
        q += k + 1
    return row, seg, spans


# --- the carry gate and the planner ------------------------------------------


def test_segment_keep_and_keeps_equal_jax():
    rng = np.random.default_rng(0)
    seg = np.sort(rng.integers(0, 6, (4, 60)), axis=1).astype(np.int32)
    seg[1, 45:] = -1  # a tail
    seg[3] = -1  # an all-guard row
    got = segment_keep(torch.from_numpy(seg))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_segment_keep(jnp.asarray(seg))))
    keeps = segment_keeps(torch.from_numpy(seg))
    want = jnp.stack([jax_segment_keep(jnp.asarray(seg)), jax_segment_keep(jnp.asarray(seg[:, ::-1]))])
    assert keeps.shape == (2, 4, 60)
    np.testing.assert_array_equal(keeps.numpy(), np.asarray(want))
    np.testing.assert_array_equal(segment_keep(torch.tensor([[0, 0, 1, 1, 1, -1, 2, 2]]))[0].numpy(),
                                  [1, 1, 0, 1, 1, 0, 0, 1])


@pytest.mark.parametrize("seed,guard,row_frames", [(0, 0, 512), (1, 1, 512), (2, 0, 300)])
def test_plan_rows_equals_jax(seed, guard, row_frames):
    rng = np.random.default_rng(seed)
    frames = [int(x) for x in rng.integers(40, 200, size=97)]
    order = rng.permutation(len(frames))
    rows = plan_rows(frames, row_frames, guard, order)
    assert rows == jax_plan_rows(frames, row_frames, guard, order)
    assert sorted(i for r in rows for i in r) == list(range(len(frames)))
    assert all(sum(frames[i] for i in r) + guard * len(r) <= row_frames + guard for r in rows)
    with pytest.raises(ValueError, match="exceeds row capacity"):
        plan_rows([row_frames + 1], row_frames, guard, np.arange(1))


# --- the packed loader --------------------------------------------------------


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.names == w.names and g.audio_seconds == w.audio_seconds
        for key in ("mix", "sources", "frame_seg"):
            a, b = getattr(g, key), getattr(w, key)
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("options", [dict(), dict(shuffle=True, seed=3),
                                     dict(shuffle=True, drop_remainder=True),
                                     dict(transfer_int16=True, rows_per_batch=3)],
                         ids=["plain", "shuffle", "drop_remainder", "int16"])
def test_packed_loader_equals_jax(fixture_tree, options):
    kw = {"rows_per_batch": 2, **LOADER, **options}
    got, want = PackedWaveformLoader(fixture_tree / "tr", **kw), JaxPackedLoader(fixture_tree / "tr", **kw)
    for key in ("row_frames", "row_samples", "guard", "num_segments", "_lengths", "_frames", "names"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.row_samples == got.row_frames * SHIFT - (SIZE - SHIFT) and got.guard == 0
    assert len(got) == len(want) and got.frame_occupancy() == want.frame_occupancy()
    _assert_batches_equal(list(got), list(want))
    _assert_batches_equal(list(got), list(want))  # a second epoch: a new shuffle
    got.set_epoch(5)
    want.set_epoch(5)
    _assert_batches_equal(list(got), list(want))
    if options.get("drop_remainder"):
        assert all(b.mix.shape[0] == 2 for b in got)


def test_packed_loader_defaults_and_resampled_planning(tmp_path):
    loader = PackedWaveformLoader(make_synthetic_fixture(tmp_path / "a", utterances_per_split=2,
                                                         min_seconds=2.0, max_seconds=3.0) / "tt")
    assert (loader.rows_per_batch, loader.row_frames, loader.row_samples) == (16, 1001, 128000)
    root = make_synthetic_fixture(tmp_path / "fx16", utterances_per_split=4, sample_rate=16000,
                                  min_seconds=0.6, max_seconds=1.2)
    kw = dict(rows_per_batch=2, row_seconds=4.0, sample_rate=8000, stft_size=SIZE, stft_shift=SHIFT)
    got, want = PackedWaveformLoader(root / "tt", **kw), JaxPackedLoader(root / "tt", **kw)
    assert got._lengths == want._lengths  # the decoded (8 kHz) lengths, not the header's
    _assert_batches_equal(list(got), list(want))


# --- the packed loss ----------------------------------------------------------


def _loss_case(speakers, seed=1, feat=5, ks=(17, 9, 23)):
    rng = np.random.default_rng(seed)
    preds = [rng.normal(size=(1, k, speakers * feat)).astype(np.float32) for k in ks]
    labels = [rng.normal(size=(1, k, speakers * feat)).astype(np.float32) for k in ks]
    row_t = sum(ks) + len(ks) + 4
    prow, seg, _ = _pack_rows(preds, row_t)
    lrow, _, _ = _pack_rows(labels, row_t)
    prow = np.where(seg[..., None] < 0, rng.normal(size=prow.shape), prow).astype(np.float32)
    # a second row: an all-guard row (noise everywhere, no segment)
    prow = np.concatenate([prow, rng.normal(size=prow.shape).astype(np.float32)])
    lrow = np.concatenate([lrow, rng.normal(size=lrow.shape).astype(np.float32)])
    seg = np.concatenate([seg, np.full_like(seg, -1)])
    return preds, labels, ks, prow, lrow, seg


@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
@pytest.mark.parametrize("speakers", [2, 3])
def test_pit_loss_packed_matches_jax(speakers, reduction):
    *_, prow, lrow, seg = _loss_case(speakers)
    got = pit_loss_packed(torch.from_numpy(prow), torch.from_numpy(lrow), torch.from_numpy(seg),
                          speakers, num_segments=5, reduction=reduction)
    want = jax_pit_loss_packed(jnp.asarray(prow), jnp.asarray(lrow), jnp.asarray(seg), speakers,
                               num_segments=5, reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PIT_RTOL)
    if reduction == "none":  # the all-guard row and the unused segments add 0
        assert got.shape == (2, 5) and not got[1].any() and not got[0, 3:].any()


@pytest.mark.parametrize("speakers", [2, 3])
def test_pit_loss_packed_is_the_sum_of_per_utterance_losses(speakers):
    preds, labels, ks, prow, lrow, seg = _loss_case(speakers, seed=2)
    packed = pit_loss_packed(torch.from_numpy(prow), torch.from_numpy(lrow), torch.from_numpy(seg),
                             speakers, num_segments=8)
    singles = sum(pit_loss(torch.from_numpy(p), torch.from_numpy(lab), torch.tensor([k]), speakers).item()
                  for p, lab, k in zip(preds, labels, ks))
    np.testing.assert_allclose(packed.item(), singles, rtol=PIT_RTOL)
    with pytest.raises(ValueError, match="unknown reduction"):
        pit_loss_packed(torch.from_numpy(prow), torch.from_numpy(lrow), torch.from_numpy(seg),
                        speakers, reduction="max")


# --- the model's segment_ids --------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jmodel = JaxUPitBlstm(input_size=BINS, output_size=BINS, **SMALL, dropout_rate=0.0)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 8, BINS)))["params"]
    model = UPitBlstm(input_size=BINS, output_size=BINS, **SMALL, dropout_rate=0.0)
    model.load_state_dict(upit_blstm_state_dict(jax.tree.map(np.asarray, params)))
    return jmodel, params, model


def _packed_row(seed=4, ks=(13, 21, 9)):
    rng = np.random.default_rng(seed)
    utts = [np.abs(rng.normal(size=(1, k, BINS))).astype(np.float32) for k in ks]
    row, seg, spans = _pack_rows(utts, sum(ks) + len(ks) + 5)
    # a second row: two utterances and a tail
    row2, seg2, _ = _pack_rows(utts[1::-1], row.shape[1])
    return utts, np.concatenate([row, row2]), np.concatenate([seg, seg2]), spans


def test_forward_with_segment_ids_matches_flax(models):
    jmodel, params, model = models
    _, row, seg, _ = _packed_row()
    want = jmodel.apply({"params": params}, jnp.asarray(row), segment_ids=jnp.asarray(seg))
    with torch.no_grad():
        got = model(torch.from_numpy(row), segment_ids=torch.from_numpy(seg))
        unpacked = model(torch.from_numpy(row))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL, rtol=FWD_TOL)
    assert not torch.allclose(got, unpacked, atol=1e-3)  # the gate does reset the carry


def test_train_forward_with_segment_ids_matches_jax_kernels(models):
    _, params, model = models
    _, row, seg, _ = _packed_row(seed=5)
    want = upit_blstm_train_forward(params, jnp.asarray(row), num_layers=2, dropout_rng=None,
                                    compute_dtype=jnp.float32, interpret=True,
                                    segment_ids=jnp.asarray(seg))
    got = model(torch.from_numpy(row), segment_ids=torch.from_numpy(seg))  # under autograd
    with torch.no_grad():
        served = model(torch.from_numpy(row), segment_ids=torch.from_numpy(seg))
    assert got.grad_fn is not None
    got = got.detach()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL, rtol=FWD_TOL)
    torch.testing.assert_close(served, got, atol=1e-6, rtol=0)


@pytest.mark.parametrize("which", ["forward", "train_forward"])
def test_each_segment_equals_its_utterance_alone(models, which):
    """The carry gate isolates utterances in both directions: a segment's
    output is its utterance's output run alone (a missing or doubled flip of
    the backward direction's gate would leak the neighbour's carry).
    ``train_forward``: the module under autograd (the training recurrences)."""
    model = models[2]
    utts, row, seg, spans = _packed_row(seed=6)
    with torch.set_grad_enabled(which == "train_forward"):
        packed = model(torch.from_numpy(row), segment_ids=torch.from_numpy(seg))
        for u, (a, b) in zip(utts, spans):
            alone = model(torch.from_numpy(u))
            torch.testing.assert_close(packed[:1, a:b], alone, atol=1e-5, rtol=1e-4)


# --- the packed steps ---------------------------------------------------------


def _states(models_fixture):
    jmodel, params, _ = models_fixture
    rng = jax.random.key(0)
    jstate = jtrain.TrainState.create(jmodel.apply, params, jtrain.exponential_decay_adam(), rng)
    model = UPitBlstm(input_size=BINS, output_size=BINS, **SMALL, dropout_rate=0.0)
    model.load_state_dict(upit_blstm_state_dict(jax.tree.map(np.asarray, params)))
    return jmodel, jstate, model, train.TrainState.create(model, train.exponential_decay_adam(), seed=0)


def test_packed_steps_match_jax_pallas_steps(models, fixture_tree):
    jmodel, jstate, model, state = _states(models)
    loader = PackedWaveformLoader(fixture_tree / "tr", rows_per_batch=2, **LOADER)
    b = next(iter(loader))
    assert b.frame_seg.max() >= 1
    kw = dict(size=SIZE, shift=SHIFT, num_segments=loader.num_segments)
    jtrain_step, jeval_step = jtrain.make_upit_packed_steps(jmodel, donate_state=False,
                                                            pallas_scan=True, **kw)
    train_step, eval_step = train.make_upit_packed_steps(model, **kw)
    jargs = tuple(jnp.asarray(a) for a in (b.mix, b.sources, b.frame_seg))
    targs = tuple(torch.from_numpy(a) for a in (b.mix, b.sources, b.frame_seg))
    # the packed loss's gradients, before any update
    jloss_fn = jsteps._packed_loss_builder(jmodel, SIZE, SHIFT, 2, loader.num_segments, None, True)
    jgrads = jax.jit(jax.grad(lambda p, *a: jloss_fn(p, *a, jstate.rng, True)))(jstate.params, *jargs)
    _packed_loss(model, SIZE, SHIFT, 2, loader.num_segments, None)(*targs, None).backward()
    got = upit_blstm_params({n: p.grad for n, p in model.named_parameters()})
    for path, want in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jgrads)):
        g = got
        for key in path:
            g = g[key.key]
        rel = np.linalg.norm(g - want) / np.linalg.norm(want)
        assert rel <= STEP_RTOL, jax.tree_util.keystr(path)
    state.optimizer.zero_grad(set_to_none=True)
    for _ in range(3):
        jstate, jloss = jtrain_step(jstate, *jargs)
        state, loss = train_step(state, *targs)
        np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=STEP_RTOL)
    np.testing.assert_allclose(eval_step(state, *targs).numpy(), np.asarray(jeval_step(jstate, *jargs)),
                               rtol=STEP_RTOL)
    got = upit_blstm_params(state.model.state_dict())
    for path, want in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jstate.params)):
        g = got
        for key in path:
            g = g[key.key]
        rel = np.linalg.norm(g - want) / np.linalg.norm(want)
        assert rel <= STEP_RTOL, jax.tree_util.keystr(path)


def test_packed_eval_is_the_sum_of_unpacked_losses(models, fixture_tree):
    *_, model, state = _states(models)
    loader = PackedWaveformLoader(fixture_tree / "tt", rows_per_batch=2, **LOADER)
    _, eval_packed = train.make_upit_packed_steps(model, size=SIZE, shift=SHIFT,
                                                  num_segments=loader.num_segments)
    _, eval_single = train.make_upit_waveform_steps(model, size=SIZE, shift=SHIFT)
    singles = {}
    # one utterance a batch, unpadded: its backward direction starts at its own last frame
    for b in WaveformLoader(fixture_tree / "tt", batch_size=1, pad_quantum_samples=1,
                            stft_size=SIZE, stft_shift=SHIFT):
        singles[b.names[0]] = eval_single(state, *map(torch.from_numpy, (b.mix, b.sources,
                                                                        b.frame_lengths))).item()
    batches = list(loader)
    assert sorted(n for b in batches for row in b.names for n in row) == sorted(loader.names)
    for b in batches:
        got = eval_packed(state, *map(torch.from_numpy, (b.mix, b.sources, b.frame_seg))).item()
        np.testing.assert_allclose(got, sum(singles[n] for row in b.names for n in row), rtol=1e-5)


def test_resident_steps_equal_loader_steps(models, fixture_tree):
    *_, model, state = _states(models)
    split = fixture_tree / "tr"
    corpus = ResidentPackedCorpus(split, rows_per_batch=3, device="cpu", **LOADER)
    jcorpus = JaxResidentCorpus(split, rows_per_batch=3, **LOADER)
    loader = PackedWaveformLoader(split, rows_per_batch=3, transfer_int16=True, **LOADER)
    assert corpus.mix.dtype == torch.int16 and corpus.frame_seg.dtype == torch.int32
    for key in ("mix", "sources", "frame_seg"):
        np.testing.assert_array_equal(getattr(corpus, key).numpy(), np.asarray(getattr(jcorpus, key)))
    assert (corpus.num_rows, corpus.padded_rows, corpus.num_segments, len(corpus)) == (
        jcorpus.num_rows, jcorpus.padded_rows, jcorpus.num_segments, len(jcorpus))
    kw = dict(size=SIZE, shift=SHIFT, num_segments=corpus.num_segments)
    res_train, res_eval = train.make_upit_packed_resident_steps(
        model, corpus.mix, corpus.sources, corpus.frame_seg, **kw)
    _, eval_loader = train.make_upit_packed_steps(model, **kw)
    idx_batches = list(corpus)
    assert all(i.dtype == torch.int32 for i in idx_batches)
    assert [i.tolist() for i in idx_batches] == [i.tolist() for i in jcorpus]
    for idx, b in zip(idx_batches, loader):
        want = eval_loader(state, *map(torch.from_numpy, (b.mix, b.sources, b.frame_seg)))
        np.testing.assert_allclose(res_eval(state, idx).item(), want.item(), rtol=1e-6)
    assert corpus.padded_rows > corpus.num_rows  # the last batch is padded with empty rows
    # shuffled: the JAX order, every row once up to the dropped tail
    shuffled = ResidentPackedCorpus(split, rows_per_batch=2, shuffle=True, seed=4, device="cpu", **LOADER)
    jshuffled = JaxResidentCorpus(split, rows_per_batch=2, shuffle=True, seed=4, **LOADER)
    for _ in range(2):
        order = [i.tolist() for i in shuffled]
        assert order == [i.tolist() for i in jshuffled]
        flat = [r for o in order for r in o]
        assert len(set(flat)) == len(flat) == (shuffled.num_rows // 2) * 2
    state, loss = res_train(state, idx_batches[0])
    assert torch.isfinite(loss) and state.step == 1


# --- the config and cli train -------------------------------------------------


def test_config_accepts_pack(tmp_path):
    path = tmp_path / "cfg.json"
    jax_config.save_config(jax_config.UPitTrainConfig(pack=True, pack_rows_per_batch=4), path)
    cfg = load_config(UPitTrainConfig, path)
    assert cfg.pack and cfg.pack_rows_per_batch == 4 and cfg.pack_row_seconds == 16.0


def test_cli_refuses_pack_with_tasnet_as_jax_does(tmp_path, fixture_tree):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"pack": True, "variant": "tasnet"}))
    args = ["train", "--config", str(cfg), "--variant", "tasnet", "--data-root", str(fixture_tree),
            "--epochs", "1", "--checkpoint-dir", str(tmp_path / "ck")]
    with pytest.raises(SystemExit, match="only supported for the blstm variant"):
        cli.main([*args, "--device", "cpu"])
    with pytest.raises(ValueError, match="only supported for the blstm variant"):
        jax_cli.main(args)


def test_cli_train_pack_then_separate_and_evaluate(tmp_path, fixture_tree, capsys, monkeypatch):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({**SMALL, "pack": True, "pack_rows_per_batch": 2, "pack_row_seconds": 1.5,
                               "lr_schedule": "cosine", "transfer_int16": True, "seed": 1}))
    horizons = []
    real = cli._optimizer
    monkeypatch.setattr(cli, "_optimizer", lambda c, steps: horizons.append(steps) or real(c, steps))
    ckpt = tmp_path / "ck"
    cli.main(["train", "--config", str(cfg), "--data-root", str(fixture_tree), "--epochs", "2",
              "--checkpoint-dir", str(ckpt), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["best_val_loss"]) and out["device"] == "cpu"
    train_loader = PackedWaveformLoader(fixture_tree / "tr", rows_per_batch=2, row_seconds=1.5,
                                        drop_remainder=True, shuffle=True, seed=1)
    assert horizons[0] == len(train_loader) >= 1  # the cosine horizon counts packed batches
    records = [json.loads(x) for x in (ckpt / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in records if "loss" in r]
    # each shuffled epoch re-plans its rows and drops its ragged last batch
    assert len(steps) == sum(b.mix.shape[0] == 2 for _ in range(2) for b in train_loader)
    assert json.loads((ckpt / "train_config.json").read_text())["pack"] is True
    cli.main(["separate", "--checkpoint-dir", str(ckpt), "--data-root", str(fixture_tree),
              "--out-dir", str(tmp_path / "sep"), "--device", "cpu"])
    written = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["written"]
    assert written == 2 * FIXTURE["utterances_per_split"]["tt"]
    cli.main(["evaluate", "--data-root", str(fixture_tree), "--est-dir", str(tmp_path / "sep")])
    scores = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert scores["utterances"] == FIXTURE["utterances_per_split"]["tt"]
    assert all(np.isfinite(v) for v in scores.values())
