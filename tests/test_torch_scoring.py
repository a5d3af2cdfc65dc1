"""PyTorch port, scoring against the JAX reference on the CPU: SI-SDR (torch
and numpy), the permutation-best score and its streaming mean, BSS-eval
(images and sources), directory scoring and ``cli evaluate``.

Inputs come from numpy seeds and go through both packages. The port's
numpy scorers are copies of the JAX package's, so they must agree to the
last bit; the torch SI-SDR agrees to fp32 rounding. The brute-force cases of
``tests/test_losses_metrics.py`` are held to the port's functions here too.
"""

import importlib
import json
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speech_separation_tpu import cli as jax_cli
from speech_separation_tpu import metrics as jax_metrics
from speech_separation_tpu.losses import sisdr as jax_sisdr
from speech_separation_tpu_torch import cli
from speech_separation_tpu_torch.data.audio_io import audiowrite, read_wav
from speech_separation_tpu_torch.data.fixture import make_synthetic_fixture
from speech_separation_tpu_torch.evaluate import evaluate as port_eval
from speech_separation_tpu_torch.losses import si_sdr, si_sdr_loss
from speech_separation_tpu_torch.metrics import (
    MeanSiSdr,
    bss_eval_images,
    bss_eval_sources,
    permute_si_sdr,
    si_sdr_np,
)

jax_eval = importlib.import_module("speech_separation_tpu.evaluate.evaluate")

SISDR_RTOL = 1e-5  # fp32 sums of the same products in another order
BSS_ATOL = 1e-9  # dB: the same float64 numpy code on the same inputs
ORACLE_ATOL = 0.01  # dB: the dense lstsq oracle of tests/test_losses_metrics.py


def _normal(shape, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape) * scale


# --- SI-SDR in torch ----------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 500), (2, 800, 1)])
@pytest.mark.parametrize("eps", [0.0, 1e-8])
def test_si_sdr_matches_jax(shape, eps):
    ref = _normal(shape, 1).astype(np.float32)
    est = (ref + 0.3 * _normal(shape, 2)).astype(np.float32)
    got = si_sdr(torch.from_numpy(est), torch.from_numpy(ref), eps=eps).numpy()
    want = np.asarray(jax_sisdr.si_sdr(jnp.asarray(est), jnp.asarray(ref), eps=eps))
    assert got.shape == want.shape == (shape[0],)
    np.testing.assert_allclose(got, want, rtol=SISDR_RTOL)


def test_si_sdr_loss_matches_jax():
    ref = _normal((4, 640), 3).astype(np.float32)
    est = (0.5 * ref + 0.2 * _normal((4, 640), 4)).astype(np.float32)
    got = si_sdr_loss(torch.from_numpy(est), torch.from_numpy(ref)).item()
    want = float(jax_sisdr.si_sdr_loss(jnp.asarray(est), jnp.asarray(ref)))
    np.testing.assert_allclose(got, want, rtol=SISDR_RTOL)


def test_mean_si_sdr_matches_jax():
    refs = _normal((5, 400), 5).astype(np.float32)
    ests = (refs + 0.1 * _normal((5, 400), 6)).astype(np.float32)
    state, jstate = MeanSiSdr.init(), jax_metrics.MeanSiSdr.init()
    assert state.result().item() == 0.0  # no update: the count is clamped to 1
    for sl in (slice(0, 2), slice(2, 5)):
        state = state.update(torch.from_numpy(refs[sl]), torch.from_numpy(ests[sl]))
        jstate = jstate.update(jnp.asarray(refs[sl]), jnp.asarray(ests[sl]))
    assert state.count.item() == float(jstate.count) == 5
    np.testing.assert_allclose(state.result().item(), float(jstate.result()), rtol=SISDR_RTOL)


# --- numpy SI-SDR and the permutation-best score ------------------------------


@pytest.mark.parametrize("n", [2, 3])
def test_si_sdr_np_and_permute_si_sdr_equal_jax(n):
    refs = [_normal(700, 10 + i) for i in range(n)]
    ests = [refs[(i + 1) % n] + 0.2 * _normal(700, 20 + i) for i in range(n)]  # rotated
    for r, e in zip(refs, ests):
        assert si_sdr_np(r, e) == jax_metrics.si_sdr_np(r, e)
    assert permute_si_sdr(refs, ests) == jax_metrics.permute_si_sdr(refs, ests)
    # the rotation is found: better than the identity assignment
    identity = np.mean([si_sdr_np(r, e) for r, e in zip(refs, ests)])
    assert permute_si_sdr(refs, ests) > identity + 10


def test_si_sdr_matches_numpy_reference():
    rng = np.random.default_rng(30)
    ref = rng.standard_normal(4000)
    est = ref + 0.1 * rng.standard_normal(4000)
    got = si_sdr(torch.tensor(est[None], dtype=torch.float32),
                 torch.tensor(ref[None], dtype=torch.float32))[0].item()
    np.testing.assert_allclose(got, si_sdr_np(ref, est), rtol=1e-3)
    # scale-invariant: a scaled estimate keeps a high score
    assert si_sdr_np(ref, 0.3 * ref + 0.01 * rng.standard_normal(4000)) > 20


def test_permute_si_sdr_picks_best_assignment():
    rng = np.random.default_rng(31)
    s1, s2 = rng.standard_normal(2000), rng.standard_normal(2000)
    score = permute_si_sdr([s1, s2], [s2 + 0.01 * rng.standard_normal(2000), s1])
    assert score > 20
    assert score > 0.5 * (si_sdr_np(s1, s2) + si_sdr_np(s2, s1))


# --- BSS-eval -----------------------------------------------------------------


def _bss_case(kind, t=3000, nsrc=2, seed=40):
    gen = np.random.default_rng(seed)
    refs = gen.standard_normal((nsrc, t))
    kernel = gen.standard_normal(5) * np.array([1.0, 0.5, 0.2, 0.1, 0.05])
    ests = np.stack([np.convolve(refs[j], kernel)[:t] + 0.3 * refs[(j + 1) % nsrc]
                     + 0.05 * gen.standard_normal(t) for j in range(nsrc)])
    if kind == "zero":
        ests[1] = 0.0
    elif kind == "swapped":
        ests = ests[::-1].copy()
    return refs, ests


@pytest.mark.parametrize("flen", [32, 512])
@pytest.mark.parametrize("kind", ["mixed", "zero", "swapped"])
@pytest.mark.parametrize("version", ["images", "sources"])
def test_bss_eval_equals_jax(version, kind, flen):
    refs, ests = _bss_case(kind)
    port, ref_fn = ((bss_eval_images, jax_metrics.bss_eval_images) if version == "images"
                    else (bss_eval_sources, jax_metrics.bss_eval_sources))
    for perm in (True, False):
        got = port(refs, ests, flen=flen, compute_permutation=perm)
        want = ref_fn(refs, ests, flen=flen, compute_permutation=perm)
        assert type(got).__name__ == type(want).__name__ and got._fields == want._fields
        for key in want._fields:
            np.testing.assert_allclose(getattr(got, key), getattr(want, key), rtol=0,
                                       atol=BSS_ATOL, err_msg=key)
    if kind == "swapped":
        assert list(got.perm) == [0, 1] and list(port(refs, ests, flen=flen).perm) == [1, 0]


def test_bss_eval_three_sources_equal_jax():
    refs, ests = _bss_case("mixed", t=2000, nsrc=3, seed=41)
    ests = ests[[2, 0, 1]]
    got, want = bss_eval_images(refs, ests, flen=64), jax_metrics.bss_eval_images(refs, ests, flen=64)
    for key in want._fields:
        np.testing.assert_allclose(getattr(got, key), getattr(want, key), rtol=0, atol=BSS_ATOL)


def test_bss_eval_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match=r"\[nsrc, T\]"):
        bss_eval_images(np.zeros((2, 100)), np.zeros((2, 99)))
    with pytest.raises(ValueError, match=r"\[nsrc, T\]"):
        bss_eval_sources(np.zeros(100), np.zeros(100))


def _perfect(refs):
    return refs.copy()


def _delayed(refs):
    return np.stack([0.5 * np.concatenate([np.zeros(3), refs[0][:-3]]), 2.0 * refs[1]])


def _noisy(refs):
    return refs + 0.1 * np.random.default_rng(50).standard_normal(refs.shape)


def _interfering(refs):
    return np.stack([refs[0] + 0.5 * refs[1], refs[1] + 0.5 * refs[0]])


# the brute-force cases of tests/test_losses_metrics.py::TestBssEval
@pytest.mark.parametrize("case", ["perfect", "swapped", "delayed", "noisy", "interfering"])
def test_bss_eval_sources_brute_force_cases(case):
    refs = np.random.default_rng(51).standard_normal((2, 4000))
    ests = {"perfect": _perfect, "swapped": lambda r: r[::-1].copy(), "delayed": _delayed,
            "noisy": _noisy, "interfering": _interfering}[case](refs)
    res = bss_eval_sources(refs, ests, flen=64)
    if case in ("perfect", "swapped"):
        assert np.all(res.sdr > 100)
        assert list(res.perm) == ([0, 1] if case == "perfect" else [1, 0])
    elif case == "delayed":  # the delay costs 3 truncated samples: ~31 dB
        assert np.all(res.sdr > 25) and res.sdr[1] > 100
    elif case == "noisy":
        assert np.all(res.sdr > 15) and np.all(res.sdr < 30)
    else:
        assert np.all(res.sir < 15) and np.all(res.sar > res.sdr - 1)


def _oracle(references, estimates, flen, version):
    """The dense convolution-matrix ``lstsq`` projections, independent of the
    FFT Gram solve, and each metric from them (identity assignment)."""
    nsrc, t = references.shape
    a = np.zeros((t + flen - 1, nsrc * flen))
    for j in range(nsrc):
        for k in range(flen):
            a[k : k + t, j * flen + k] = references[j]

    def db(num, den):
        return 10.0 * np.log10((num + 1e-30) / (den + 1e-30))

    out = {}
    for j in range(nsrc):
        est_pad = np.concatenate([estimates[j], np.zeros(flen - 1)])
        proj_all = a @ np.linalg.lstsq(a, est_pad, rcond=None)[0]
        aj = a[:, j * flen : (j + 1) * flen]
        proj_j = aj @ np.linalg.lstsq(aj, est_pad, rcond=None)[0]
        e_interf, e_artif = proj_all - proj_j, est_pad - proj_all
        if version == "images":
            s_true = np.concatenate([references[j], np.zeros(flen - 1)])
            e_spat = proj_j - s_true
            values = {"sdr": db(np.sum(s_true**2), np.sum((e_spat + e_interf + e_artif) ** 2)),
                      "isr": db(np.sum(s_true**2), np.sum(e_spat**2))}
        else:
            values = {"sdr": db(np.sum(proj_j**2), np.sum((e_interf + e_artif) ** 2))}
        values["sir"] = db(np.sum(proj_j**2), np.sum(e_interf**2))
        values["sar"] = db(np.sum(proj_all**2), np.sum(e_artif**2))
        for k, v in values.items():
            out.setdefault(k, []).append(v)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("version,seed,flen", [("images", 0, 64), ("images", 1, 128),
                                               ("images", 2, 512), ("sources", 3, 64),
                                               ("sources", 4, 512)])
def test_bss_eval_matches_the_lstsq_oracle(version, seed, flen):
    refs, ests = _bss_case("mixed", t=1500, seed=seed)  # the dense oracle is O(t·(2·flen)²)
    fn = bss_eval_images if version == "images" else bss_eval_sources
    got = fn(refs, ests, flen=flen, compute_permutation=False)
    for key, want in _oracle(refs, ests, flen, version).items():
        np.testing.assert_allclose(getattr(got, key), want, atol=ORACLE_ATOL, err_msg=key)


def test_bss_eval_images_sdr_is_the_energy_ratio():
    refs, ests = _bss_case("mixed", seed=6)
    got = bss_eval_images(refs, ests, flen=64, compute_permutation=False)
    want = [10 * np.log10(np.sum(r**2) / np.sum((e - r) ** 2)) for r, e in zip(refs, ests)]
    np.testing.assert_allclose(got.sdr, want, atol=1e-6)


# --- directory scoring and cli evaluate --------------------------------------


def _estimates(root, speakers, out, seed=60):
    """Perturbed estimate wavs of every tt utterance, the speakers rotated in
    odd utterances (the permutation search must undo it)."""
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = sorted(p.name for p in (root / "tt" / "mix").glob("*.wav"))
    for u, name in enumerate(names):
        refs = [read_wav(root / "tt" / f"s{i + 1}" / name)[0] for i in range(speakers)]
        for i in range(speakers):
            src = refs[(i + u) % speakers]
            est = src[: len(src) - 37 * i] + 0.05 * rng.standard_normal(len(src) - 37 * i)
            audiowrite(est, out / f"{pathlib.Path(name).stem}_s{i + 1}.wav", normalize=True)
    return names


@pytest.fixture(scope="module", params=[2, 3], ids=["2spk", "3spk"])
def scored_tree(request, tmp_path_factory):
    speakers = request.param
    base = tmp_path_factory.mktemp(f"score_{speakers}")
    root = make_synthetic_fixture(base / "fx", utterances_per_split={"tr": 1, "cv": 1, "tt": 3},
                                  min_seconds=0.4, max_seconds=0.9, num_speakers=speakers)
    names = _estimates(root, speakers, base / "est")
    return root, base / "est", speakers, names


def test_load_pairs_and_speaker_count_equal_jax(scored_tree):
    root, est, speakers, names = scored_tree
    assert port_eval._detect_num_speakers(root / "tt") == speakers
    assert jax_eval._detect_num_speakers(root / "tt") == speakers
    got = list(port_eval._load_pairs(root, est))
    want = list(jax_eval._load_pairs(root, est))
    assert [g[0] for g in got] == [w[0] for w in want] == names
    for (_, gr, ge), (_, wr, we) in zip(got, want):
        for a, b in zip(gr + ge, wr + we):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["si_sdr", "si_sdri", "sdr_images", "sdr_sources"])
def test_directory_scores_equal_jax(scored_tree, which):
    root, est, _, _ = scored_tree
    if which.startswith("sdr"):
        version = which.split("_")[1]
        got = port_eval.eval_sdr(root, est, flen=64, version=version)
        want = jax_eval.eval_sdr(root, est, flen=64, version=version)
    else:
        fn = f"eval_{which}"
        got, want = getattr(port_eval, fn)(root, est), getattr(jax_eval, fn)(root, est)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=BSS_ATOL)


def test_evaluate_directory_and_score_pair_equal_jax(scored_tree):
    root, est, _, names = scored_tree
    per_utt, agg = port_eval.evaluate_directory(root, est, flen=128)
    want_utt, want_agg = jax_eval.evaluate_directory(root, est, flen=128)
    assert [u["name"] for u in per_utt] == names
    assert agg["utterances"] == want_agg["utterances"] == len(names)
    for got, want in zip([*per_utt, agg], [*want_utt, want_agg]):
        assert got.keys() == want.keys()
        for key, value in want.items():
            if isinstance(value, float):
                np.testing.assert_allclose(got[key], value, rtol=0, atol=BSS_ATOL, err_msg=key)
            else:
                assert got[key] == value
    # the rotated estimates were scored in the right assignment, above the mixture
    assert agg["si_sdr"] > 5 and agg["si_sdri"] > 5
    refs = [np.arange(1, 501, dtype=np.float64), np.cos(np.arange(480))]
    ests = [refs[1][:470] + 0.1, refs[0] * 2]
    got, want = port_eval.score_pair(refs, ests, flen=32), jax_eval.score_pair(refs, ests, flen=32)
    assert got == want


def test_evaluate_aggregation_tolerates_nan(scored_tree, monkeypatch):
    root, est, _, _ = scored_tree
    calls = []
    real = port_eval.score_pair

    def nan_first(refs, ests, flen=512):
        out = real(refs, ests, flen=flen)
        if not calls:
            out["sar"] = float("nan")
        calls.append(1)
        return out

    monkeypatch.setattr(port_eval, "score_pair", nan_first)
    per_utt, agg = port_eval.evaluate_directory(root, est, flen=32)
    assert np.isnan(per_utt[0]["sar"]) and np.isfinite(agg["sar"])
    np.testing.assert_allclose(agg["sar"], sum(u["sar"] for u in per_utt[1:]) / len(per_utt))


def _run_cli(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_evaluate_equals_jax(scored_tree, tmp_path, capsys):
    root, est, _, names = scored_tree
    args = ["evaluate", "--data-root", str(root), "--est-dir", str(est)]
    got = _run_cli(cli.main, [*args, "--per-utterance", str(tmp_path / "p" / "port.jsonl")], capsys)
    want = _run_cli(jax_cli.main, [*args, "--per-utterance", str(tmp_path / "jax.jsonl")], capsys)
    assert list(got) == ["si_sdr_db", "si_sdri_db", "sdr_db", "isr_db", "sir_db", "sar_db",
                         "utterances"] == list(want)
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-4, key
        assert got[key] == round(got[key], 4)
    assert got["utterances"] == len(names)
    port_lines = (tmp_path / "p" / "port.jsonl").read_text().splitlines()
    jax_lines = (tmp_path / "jax.jsonl").read_text().splitlines()
    assert [json.loads(x) for x in port_lines] == [json.loads(x) for x in jax_lines]
    assert [json.loads(x)["name"] for x in port_lines] == names


@pytest.mark.parametrize("what", ["missing", "empty"])
def test_cli_evaluate_error_exits_equal_jax(tmp_path, what):
    est = tmp_path / "est"
    if what == "empty":
        est.mkdir()
        (est / "notes.txt").write_text("no wavs")
    args = ["evaluate", "--data-root", str(tmp_path), "--est-dir", str(est)]
    messages = []
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as exc:
            main(args)
        messages.append(str(exc.value.code))
    assert messages[0] == messages[1]
    assert re.search("not found" if what == "missing" else "no .wav estimates", messages[0])


# --- the port imports no JAX ---------------------------------------------------

_ROOT = pathlib.Path(__file__).resolve().parents[1]
_PORT_FILES = sorted(p.relative_to(_ROOT).as_posix()
                     for p in (_ROOT / "speech_separation_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]
_JAX_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|orbax|speech_separation_tpu)\b(?!_torch)"
    r"|import_module\(\s*[\"'](?:jax|flax|speech_separation_tpu)\b(?!_torch)", re.MULTILINE)


@pytest.mark.parametrize("path", _PORT_FILES)
def test_port_file_imports_no_jax(path):
    """The port and chip_smoke.py run where JAX is not installed: no import of
    JAX, its libraries, or the JAX package (whose ``__init__`` imports jax)."""
    found = _JAX_IMPORT.findall((_ROOT / path).read_text())
    assert not found, f"{path} imports {found}"
