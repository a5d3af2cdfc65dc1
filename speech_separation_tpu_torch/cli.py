"""Command line of the PyTorch port (counterpart of ``cli.py``).

    python -m speech_separation_tpu_torch.cli train [--workload {upit,vqvae}] \\
        [--variant V] --config cfg.json --data-root D [--batch-size N] --epochs N \\
        --checkpoint-dir C [--resume] [--device {cuda,cpu}]
    python -m speech_separation_tpu_torch.cli separate --checkpoint-dir C \\
        --data-root D --split tt --out-dir O [--bf16] [--batch-size N] \\
        [--kernel {xla,pallas}] [--pad-quantum-seconds S] \\
        [--chunk-seconds S --chunk-overlap-seconds S] [--transfer-int16] \\
        [--device {cuda,cpu}]
    python -m speech_separation_tpu_torch.cli evaluate --data-root D --est-dir O \\
        [--split tt] [--per-utterance scores.jsonl]
    python -m speech_separation_tpu_torch.cli codec-encode --checkpoint-dir C \\
        --wav in.wav --out codes.npy|codes.npz [--device {cuda,cpu}]
    python -m speech_separation_tpu_torch.cli codec-decode --checkpoint-dir C \\
        --codes codes.npy|codes.npz --out out.wav [--device {cuda,cpu}]
    python -m speech_separation_tpu_torch.cli codec-roundtrip --checkpoint-dir C \\
        --wav in.wav --out out.wav [--device {cuda,cpu}]

``train`` trains the config's ``variant`` (``--variant`` overrides it) from
raw waveforms, writing ``train_config.json``, ``metrics.jsonl`` and the best
checkpoints to the checkpoint directory. ``--workload upit``: the uPIT BLSTM
(``blstm``) on the PIT loss of its masks, or Conv-TasNet (``tasnet``) wave to
wave on the negative SI-SDR, with ``tasnet_pallas_trunk`` running the TCN
trunk's forward and backward in the training CUDA kernels (bf16). With
``pack`` the BLSTM trains on sequence-packed rows (``data/packing.py``), its
recurrences in the training kernels' keep mode.
``--workload vqvae``: a VQ-VAE codec (``gumbel``, ``v2``, ``t2``, ``t3``,
``t3tok``) on the summed squared error plus its auxiliary losses, NAdam for
the t-series and Adam otherwise. ``separate`` loads the best checkpoint: a
``blstm`` checkpoint goes to ``separate_directory``; a ``tasnet`` checkpoint
to the time-domain path, whole utterances or overlapped chunks, with
``--kernel pallas`` running the TCN trunk in the ``tcn_trunk`` CUDA kernel
(bf16; the JAX flag's name) and ``--kernel xla`` the module's own forward.
``evaluate`` scores a separated split against its references (SI-SDR,
SI-SDRi and BSS-eval SDR/ISR/SIR/SAR, host-side numpy) and prints one JSON
line. The codec commands serve a codec checkpoint: ``codec-encode`` writes the
int32 codes (``.npz`` with ``deep`` and ``skip`` for t3tok; v2 has no code
stream), ``codec-decode`` reconstructs from codes alone (gumbel and t3tok),
``codec-roundtrip`` runs the deterministic forward; each prints one JSON
line, with the codebooks' perplexity and usage for ``codec-encode``. Every
nearest-code search runs in the ``nearest_code`` CUDA kernel. All of them
run on the GPU (``--device cuda``, the default), and exit with an error
where there is none; ``--device cpu`` runs them on the CPU, where every
kernel takes its plain version. The other subcommands and options of the JAX
CLI wait for later slices.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import torch

__all__ = ["main"]


def _device(name: str) -> torch.device:
    """The device ``--device`` names; exits when it is ``cuda`` and there is no GPU."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "error: --device cuda (the default) but torch.cuda.is_available() is false; "
            "pass --device cpu to run on the CPU"
        )
    return torch.device(name)


def _build_model(cfg, device: torch.device):
    from .models.tasnet import ConvTasNet
    from .models.upit import UPitBlstm

    if cfg.variant == "tasnet":
        model = ConvTasNet(
            num_speakers=cfg.num_speakers,
            enc_dim=cfg.tasnet_enc_dim,
            win=cfg.tasnet_win,
            bottleneck=cfg.tasnet_bottleneck,
            hidden=cfg.tasnet_hidden,
            blocks=cfg.tasnet_blocks,
            repeats=cfg.tasnet_repeats,
            causal=cfg.tasnet_causal,
            generator=torch.Generator().manual_seed(cfg.seed),
        )
        return model.to(device)
    model = UPitBlstm(
        hidden=cfg.hidden,
        num_layers=cfg.num_layers,
        num_speakers=cfg.num_speakers,
        dropout_rate=cfg.dropout,
        generator=torch.Generator().manual_seed(cfg.seed),
    )
    return model.to(device)


def _optimizer(cfg, steps_per_epoch: int):
    """The JAX CLI's choice: a cosine schedule when asked for, else plain Adam
    for Conv-TasNet and the staircase decay for the BLSTM."""
    from . import train

    if cfg.lr_schedule == "cosine":
        return train.cosine_adam(
            cfg.learning_rate,
            total_steps=(cfg.sched_epochs or cfg.epochs) * steps_per_epoch,
            warmup_steps=cfg.lr_warmup_steps,
            grad_clip_norm=cfg.grad_clip_norm,
        )
    if cfg.variant == "tasnet":
        return train.adam(cfg.learning_rate, grad_clip_norm=cfg.grad_clip_norm)
    return train.exponential_decay_adam(
        cfg.learning_rate, cfg.lr_decay_steps, cfg.lr_decay_rate,
        grad_clip_norm=cfg.grad_clip_norm,
    )


def _build_vae_model(cfg, device: torch.device):
    from .models import vqvae

    generator = torch.Generator().manual_seed(cfg.seed)
    if cfg.variant == "gumbel":
        model = vqvae.VqVaeGumbel(latent_dim=cfg.latent_dim, generator=generator)
    elif cfg.variant == "t3tok":
        model = vqvae.VqVaeT3Tok(
            embedding_dim=cfg.embedding_dim,
            num_embeddings=cfg.num_embeddings,
            skip_embeddings=cfg.skip_embeddings,
            deep_depth=cfg.deep_depth,
            skip_depth=cfg.skip_depth,
            skip_pq=cfg.skip_pq,
            generator=generator,
        )
    else:
        cls = {"v2": vqvae.VqVaeCodebook, "t2": vqvae.VqVaeT2, "t3": vqvae.VqVaeT3}[cfg.variant]
        model = cls(embedding_dim=cfg.embedding_dim, num_embeddings=cfg.num_embeddings,
                    generator=generator)
    return model.to(device)


def _vae_optimizer(cfg):
    """The JAX CLI's choice: NAdam for the t-series codecs, Adam otherwise."""
    from . import train

    if cfg.variant in ("t2", "t3", "t3tok"):
        return train.nadam(cfg.learning_rate)
    return train.adam(cfg.learning_rate)


def _stride_alignment(variant: str) -> int:
    """t3 and t3tok downsample 8x (three stride-2 levels), v2 and t2 4x."""
    return 8 if variant in ("t3", "t3tok") else 4


def _train_vae(args) -> None:
    from . import train
    from .data.datasets import VaeLoader
    from .losses import summed_squared_error
    from .utils import MetricsLogger, VaeTrainConfig, load_config, save_config

    cfg = load_config(
        VaeTrainConfig,
        args.config,
        dict(data_root=args.data_root, variant=args.variant, batch_size=args.batch_size,
             epochs=args.epochs, checkpoint_dir=args.checkpoint_dir),
    )
    device = _device(args.device)
    model = _build_vae_model(cfg, device)
    stacked = cfg.variant != "gumbel"
    if stacked:
        def loss_fn(preds, targets):
            return summed_squared_error(preds.reshape(preds.shape[0], -1, 1), targets)
    else:
        loss_fn = summed_squared_error
    train_step, eval_step = train.make_vae_steps(model, loss_fn)
    root = pathlib.Path(cfg.data_root)

    def make_loader(split: str, shuffle: bool) -> VaeLoader:
        return VaeLoader(
            root / split,
            source=cfg.source,
            batch_size=cfg.batch_size,
            sample_rate=cfg.sample_rate,
            stacked=stacked,
            stride_alignment=_stride_alignment(cfg.variant),
            shuffle=shuffle,
            seed=cfg.seed,
        )

    state = train.TrainState.create(model, _vae_optimizer(cfg), cfg.seed)
    ckpt = train.CheckpointManager(cfg.checkpoint_dir)
    save_config(cfg, pathlib.Path(cfg.checkpoint_dir) / "train_config.json")
    logger = MetricsLogger(pathlib.Path(cfg.checkpoint_dir) / "metrics.jsonl")
    result = train.fit(
        state,
        train_step,
        eval_step,
        make_loader(cfg.train_split, True),
        make_loader(cfg.val_split, False),
        lambda b: (b.inputs, b.targets),
        epochs=cfg.epochs,
        patience=cfg.patience,
        checkpoints=ckpt,
        resume=args.resume,
        metrics=logger,
    )
    logger.close()
    ckpt.close()
    print(json.dumps({"best_val_loss": result.best_val_loss, "best_epoch": result.best_epoch,
                      "device": str(device)}))


def cmd_train(args) -> None:
    from . import train
    from .data.datasets import WaveformLoader
    from .data.packing import PackedWaveformLoader
    from .utils import MetricsLogger, UPitTrainConfig, load_config, save_config

    if args.workload == "vqvae":
        _train_vae(args)
        return
    cfg = load_config(
        UPitTrainConfig,
        args.config,
        dict(data_root=args.data_root, variant=args.variant, batch_size=args.batch_size,
             epochs=args.epochs, checkpoint_dir=args.checkpoint_dir),
    )
    if cfg.variant == "tasnet" and cfg.tasnet_causal and cfg.tasnet_pallas_trunk:
        raise SystemExit(
            "error: tasnet_pallas_trunk runs the fused TCN trunk, which implements the gLN "
            "topology only; a causal (cLN) Conv-TasNet trains through the module "
            "(tasnet_pallas_trunk=false)"
        )
    if cfg.pack and cfg.variant != "blstm":
        raise SystemExit("error: pack=true is only supported for the blstm variant")
    device = _device(args.device)
    model = _build_model(cfg, device)
    root = pathlib.Path(cfg.data_root)
    compute_dtype = torch.bfloat16 if cfg.bf16_compute else None
    if cfg.pack:
        # sequence-packed rows (data/packing.py): one shape for every batch,
        # each utterance trained as if alone. Shuffled epochs re-plan the
        # rows, so their ragged last batch is dropped; validation keeps all.
        train_loader, val_loader = (
            PackedWaveformLoader(
                root / split,
                rows_per_batch=cfg.pack_rows_per_batch,
                row_seconds=cfg.pack_row_seconds,
                sample_rate=cfg.stft.sample_rate,
                stft_size=cfg.stft.size,
                stft_shift=cfg.stft.shift,
                num_speakers=cfg.num_speakers,
                shuffle=shuffle,
                seed=cfg.seed,
                transfer_int16=cfg.transfer_int16,
                drop_remainder=shuffle,
            )
            for split, shuffle in ((cfg.train_split, True), (cfg.val_split, False))
        )
        train_step, eval_step = train.make_upit_packed_steps(
            model,
            cfg.stft.size,
            cfg.stft.shift,
            cfg.num_speakers,
            num_segments=max(train_loader.num_segments, val_loader.num_segments),
            compute_dtype=compute_dtype,
        )

        def batch_arrays(b):
            return b.mix, b.sources, b.frame_seg

        # a packed epoch is len(train_loader) steps, not utterances / batch size
        steps_per_epoch = max(1, len(train_loader))
    else:
        train_loader, val_loader = (
            WaveformLoader(
                root / split,
                batch_size=cfg.batch_size,
                sample_rate=cfg.stft.sample_rate,
                stft_size=cfg.stft.size,
                stft_shift=cfg.stft.shift,
                num_speakers=cfg.num_speakers,
                shuffle=shuffle,
                seed=cfg.seed,
                transfer_int16=cfg.transfer_int16,
            )
            for split, shuffle in ((cfg.train_split, True), (cfg.val_split, False))
        )
        steps_per_epoch = max(1, len(train_loader.names) // cfg.batch_size)
        if cfg.variant == "tasnet":
            train_step, eval_step = train.make_time_domain_steps(
                model,
                compute_dtype=torch.bfloat16 if cfg.tasnet_pallas_trunk else compute_dtype,
                pallas_trunk=cfg.tasnet_pallas_trunk,
            )

            def batch_arrays(b):
                return b.mix, b.sources, b.sample_lengths

        else:
            train_step, eval_step = train.make_upit_waveform_steps(
                model, cfg.stft.size, cfg.stft.shift, cfg.num_speakers,
                compute_dtype=compute_dtype,
            )

            def batch_arrays(b):
                return b.mix, b.sources, b.frame_lengths

    state = train.TrainState.create(model, _optimizer(cfg, steps_per_epoch), cfg.seed)
    ckpt = train.CheckpointManager(cfg.checkpoint_dir)
    save_config(cfg, pathlib.Path(cfg.checkpoint_dir) / "train_config.json")
    logger = MetricsLogger(pathlib.Path(cfg.checkpoint_dir) / "metrics.jsonl")
    result = train.fit(
        state,
        train_step,
        eval_step,
        train_loader,
        val_loader,
        batch_arrays,
        epochs=cfg.epochs,
        patience=cfg.patience,
        checkpoints=ckpt,
        resume=args.resume,
        metrics=logger,
    )
    logger.close()
    ckpt.close()
    print(
        json.dumps(
            {
                "best_val_loss": result.best_val_loss,
                "best_epoch": result.best_epoch,
                "stopped_early": result.stopped_early,
                "diverged": result.diverged,
                "device": str(device),
            }
        )
    )


def _restore_upit(checkpoint_dir: str, device: torch.device):
    from . import train
    from .utils import UPitTrainConfig, load_config

    path = pathlib.Path(checkpoint_dir) / "train_config.json"
    if not path.exists():
        raise SystemExit(
            f"error: no separator checkpoint at {checkpoint_dir} (missing {path.name}; "
            "train one first)"
        )
    try:
        cfg = load_config(UPitTrainConfig, path)
    except ValueError as exc:
        raise SystemExit(f"error: checkpoint at {checkpoint_dir}: {exc}") from exc
    model = _build_model(cfg, device)
    state = train.TrainState.create(model, _optimizer(cfg, 1), cfg.seed)
    ckpt = train.CheckpointManager(checkpoint_dir)
    ckpt.restore_params(state)
    return cfg, state.model


def cmd_separate(args) -> None:
    from .separate.pipeline import separate_directory

    device = _device(args.device)
    cfg, model = _restore_upit(args.checkpoint_dir, device)
    if cfg.variant == "tasnet":
        _separate_time_domain(cfg, model, args, device)
        return
    written = separate_directory(
        model,
        pathlib.Path(args.data_root or cfg.data_root) / args.split,
        args.out_dir,
        size=cfg.stft.size,
        shift=cfg.stft.shift,
        num_speakers=cfg.num_speakers,
        batch_size=args.batch_size or cfg.batch_size,
        sample_rate=cfg.stft.sample_rate,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        transfer_int16=args.transfer_int16,
    )
    print(json.dumps({"written": len(written), "out_dir": str(args.out_dir), "device": str(device)}))


def _separate_time_domain(cfg, model, args, device: torch.device) -> None:
    """Conv-TasNet serving of a split (the JAX ``_separate_time_domain``'s
    full-utterance and chunked branches)."""
    import copy

    import numpy as np

    from .data.audio_io import audiowrite, wait_for_pending_writes
    from .data.datasets import WaveformLoader
    from .ops.quant import dequant_i16, dequantize_estimates_i16, quantize_estimates_i16

    use_kernel = args.kernel == "pallas"
    if use_kernel and cfg.tasnet_causal:
        raise SystemExit(
            "error: --kernel pallas runs the fused TCN trunk, which implements the gLN "
            "topology only; this checkpoint is causal (cLN, tasnet_causal=true). "
            "Use --kernel xla."
        )
    model.eval()
    if use_kernel:
        # the trunk kernel pads nothing: pad to the encoder stride, trim after
        from .models.tasnet_serving import cuda_apply

        stride = cfg.tasnet_win // 2

        def base(m: torch.Tensor) -> torch.Tensor:
            orig = m.shape[1]
            est = cuda_apply(model, torch.nn.functional.pad(m, (0, (-orig) % stride)))
            return est[:, :, :orig]

    else:
        # serving precision: convs and products in bf16, norm statistics fp32
        net = copy.deepcopy(model).to(torch.bfloat16) if args.bf16 else model

        def base(m: torch.Tensor) -> torch.Tensor:
            return net(m)

    # int16 transfer applies to the full-utterance path; chunks are sliced
    # from float waveforms on the host
    use_int16 = args.transfer_int16 and not args.chunk_seconds

    @torch.inference_mode()
    def separate(m: torch.Tensor):
        m = m.to(device)
        if use_int16:
            return quantize_estimates_i16(base(dequant_i16(m)).float())
        return base(m.float())

    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    loader = WaveformLoader(
        pathlib.Path(args.data_root or cfg.data_root) / args.split,
        batch_size=args.batch_size or cfg.batch_size,
        sample_rate=cfg.stft.sample_rate,
        num_speakers=cfg.num_speakers,
        pad_quantum_seconds=args.pad_quantum_seconds,
        transfer_int16=use_int16,
    )

    def write(wav: np.ndarray, stem: str, s: int) -> None:
        audiowrite(wav, out_dir / f"{stem}_s{s + 1}.wav", cfg.stft.sample_rate,
                   normalize=True, threaded=True)

    written = 0
    for b in loader:
        if args.chunk_seconds:
            # any length: fixed overlapped chunks, permutation-aligned crossfade
            from .separate.tasnet_chunked import separate_chunked

            for i, name in enumerate(b.names):
                est = separate_chunked(
                    separate,
                    b.mix[i, : int(b.sample_lengths[i])],
                    num_speakers=cfg.num_speakers,
                    sample_rate=cfg.stft.sample_rate,
                    chunk_seconds=args.chunk_seconds,
                    overlap_seconds=args.chunk_overlap_seconds,
                )
                for s in range(cfg.num_speakers):
                    write(est[s], pathlib.Path(name).stem, s)
                    written += 1
            continue
        out = separate(torch.from_numpy(b.mix))
        if use_int16:
            codes, scale = out
            est = dequantize_estimates_i16(codes.cpu().numpy(), scale.cpu().numpy())
        else:
            est = out.cpu().numpy()
        for i, name in enumerate(b.names):
            for s in range(cfg.num_speakers):
                write(est[i, s, : int(b.sample_lengths[i])], pathlib.Path(name).stem, s)
                written += 1
    wait_for_pending_writes()
    print(json.dumps({"written": written, "out_dir": str(out_dir), "device": str(device)}))


def cmd_evaluate(args) -> None:
    """Score a separated split: one JSON line of dB metrics (host-side numpy)."""
    from .evaluate import evaluate_directory

    est_dir = pathlib.Path(args.est_dir)
    if not est_dir.is_dir():
        raise SystemExit(f"error: estimate directory not found: {est_dir}")
    if not any(est_dir.glob("*.wav")):
        raise SystemExit(f"error: no .wav estimates in {est_dir} (run `separate` first)")
    per_utt, agg = evaluate_directory(args.data_root, args.est_dir, args.split)
    if args.per_utterance:
        out = pathlib.Path(args.per_utterance)
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "w") as fh:
            for record in per_utt:
                fh.write(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                                     for k, v in record.items()}) + "\n")
    print(json.dumps({
        "si_sdr_db": round(agg["si_sdr"], 4),
        "si_sdri_db": round(agg["si_sdri"], 4),
        "sdr_db": round(agg["sdr"], 4),
        "isr_db": round(agg["isr"], 4),
        "sir_db": round(agg["sir"], 4),
        "sar_db": round(agg["sar"], 4),
        "utterances": agg["utterances"],
    }))


def _stack_frames(wav, variant: str, frame_size: int = 40):
    """A waveform in the codec's input layout: gumbel (sample-level) ``[1, T, 1]``
    with T padded to a multiple of 32 (five stride-2 levels); the stacked
    variants ``[1, K, frame_size]`` with K aligned to the stride depth."""
    import numpy as np

    if variant == "gumbel":
        out = np.zeros((1, -(-len(wav) // 32) * 32, 1), np.float32)
        out[0, : len(wav), 0] = wav
        return out
    alignment = _stride_alignment(variant)
    k = -(-len(wav) // frame_size)
    k = -(-k // alignment) * alignment
    frames = np.zeros((1, k, frame_size), np.float32)
    frames[0].reshape(-1)[: len(wav)] = wav
    return frames


def _restore_vae(checkpoint_dir: str, device: torch.device):
    from . import train
    from .utils import VaeTrainConfig, load_config

    path = pathlib.Path(checkpoint_dir) / "train_config.json"
    if not path.exists():
        raise SystemExit(
            f"error: no codec checkpoint at {checkpoint_dir} (missing {path.name}; "
            "train one first)"
        )
    try:
        cfg = load_config(VaeTrainConfig, path)
    except ValueError as exc:
        raise SystemExit(f"error: checkpoint at {checkpoint_dir} is not a codec checkpoint "
                         f"({exc})") from exc
    model = _build_vae_model(cfg, device)
    state = train.TrainState.create(model, _vae_optimizer(cfg), cfg.seed)
    train.CheckpointManager(checkpoint_dir).restore_params(state)
    return cfg, model.eval()


def cmd_codec_encode(args) -> None:
    import numpy as np

    from .data.audio_io import read_normalized
    from .tokenizer import code_metrics

    device = _device(args.device)
    cfg, model = _restore_vae(args.checkpoint_dir, device)
    if not hasattr(model, "codes"):
        raise SystemExit(
            f"error: the {cfg.variant!r} codec does not expose a code stream "
            f"(its two VQ levels interleave mid-decoder); use gumbel, t2, t3 or t3tok"
        )
    wav = read_normalized(args.wav, cfg.sample_rate)
    frames = torch.from_numpy(_stack_frames(wav, cfg.variant)).to(device)
    with torch.inference_mode():
        codes = model.codes(frames)
    if cfg.variant == "t3tok":
        deep, skip = (c.cpu().numpy().astype(np.int32) for c in codes)
        np.savez(args.out, deep=deep, skip=skip)
        report = {
            "codes": str(args.out),
            "deep_shape": list(deep.shape),
            "skip_shape": list(skip.shape),
            "samples": len(wav),
            "deep": code_metrics(deep, cfg.num_embeddings),
            "skip": code_metrics(skip, cfg.skip_embeddings),
        }
    else:
        codes = codes.cpu().numpy().astype(np.int32)
        np.save(args.out, codes)
        vocab = cfg.latent_dim if cfg.variant == "gumbel" else cfg.num_embeddings
        report = {
            "codes": str(args.out),
            "shape": list(codes.shape),
            "samples": len(wav),
            "codebook": code_metrics(codes, vocab),
        }
    print(json.dumps({**report, "device": str(device)}))


def cmd_codec_decode(args) -> None:
    """Decode saved codes back to a waveform: the self-contained codecs only,
    ``gumbel`` (``codes.npy``) and ``t3tok`` (``codes.npz``, ``deep`` and
    ``skip``). t2 and t3 carry a raw U-skip, so their codes alone cannot
    reconstruct: ``codec-roundtrip`` serves them."""
    import numpy as np

    from .data.audio_io import audiowrite

    device = _device(args.device)
    cfg, model = _restore_vae(args.checkpoint_dir, device)
    if cfg.variant == "t3tok":
        with np.load(args.codes) as payload:
            deep, skip = (torch.from_numpy(payload[k]).to(device) for k in ("deep", "skip"))
        with torch.inference_mode():
            wav = model.decode_codes(deep, skip)
    elif cfg.variant == "gumbel":
        with torch.inference_mode():
            wav = model.decode_codes(torch.from_numpy(np.load(args.codes)).to(device))
    else:
        raise SystemExit(
            f"codec-decode requires a self-contained codec ('gumbel' or 't3tok'); the "
            f"{cfg.variant!r} hierarchy has a raw U-skip and needs codec-roundtrip"
        )
    out = wav.float().cpu().numpy().reshape(-1)
    audiowrite(out, args.out, cfg.sample_rate, normalize=True)
    print(json.dumps({"out": str(args.out), "samples": int(out.size), "device": str(device)}))


def cmd_codec_roundtrip(args) -> None:
    """Encode and decode a wav through the codec's deterministic forward."""
    from .data.audio_io import audiowrite, read_normalized

    device = _device(args.device)
    cfg, model = _restore_vae(args.checkpoint_dir, device)
    wav = read_normalized(args.wav, cfg.sample_rate)
    frames = torch.from_numpy(_stack_frames(wav, cfg.variant)).to(device)
    with torch.inference_mode():
        recon, _ = model(frames, deterministic=True)
    out = recon.float().cpu().numpy().reshape(-1)[: len(wav)]
    audiowrite(out, args.out, cfg.sample_rate, normalize=True)
    print(json.dumps({"out": str(args.out), "samples": int(len(wav)), "device": str(device)}))


def _add_device(parser) -> None:
    parser.add_argument(
        "--device",
        default="cuda",
        choices=["cuda", "cpu"],
        help="where to run (default cuda: exits if there is no GPU; cpu runs every kernel's "
        "plain version)",
    )


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="speech_separation_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train", help="train a separator or codec")
    p.add_argument("--config")
    p.add_argument("--workload", default="upit", choices=["upit", "vqvae"])
    p.add_argument("--variant", default=None, help="overrides the config's variant")
    p.add_argument("--data-root")
    p.add_argument("--batch-size", type=int)
    p.add_argument("--epochs", type=int)
    p.add_argument("--checkpoint-dir", default="./CKPT")
    p.add_argument("--resume", action="store_true", help="resume from latest checkpoint")
    _add_device(p)
    p.set_defaults(func=cmd_train)

    p = sub.add_parser("separate", help="separate a split with a trained model")
    p.add_argument("--checkpoint-dir", default="./CKPT")
    p.add_argument("--data-root")
    p.add_argument("--split", default="tt")
    p.add_argument("--out-dir", default="./test_wav")
    p.add_argument("--batch-size", type=int)
    p.add_argument("--bf16", action="store_true", help="bf16 mask network (serving precision)")
    p.add_argument(
        "--transfer-int16",
        action="store_true",
        help="int16 PCM to the device and int16 estimates back (per-signal scale, no "
        "clipping); the full-utterance path only",
    )
    p.add_argument(
        "--kernel",
        default="xla",
        choices=["xla", "pallas"],
        help="tasnet serving: 'pallas' runs the TCN trunk in the tcn_trunk CUDA kernel "
        "(bf16; implies --bf16); 'xla' the module's own forward",
    )
    p.add_argument(
        "--pad-quantum-seconds",
        type=float,
        default=1.0,
        help="tasnet: round padded batch lengths up to a multiple of this (default 1.0)",
    )
    p.add_argument(
        "--chunk-seconds",
        type=float,
        default=0.0,
        help="tasnet: separate in fixed overlapped chunks (any utterance length; "
        "permutation-aligned crossfade; gLN statistics become chunk-local)",
    )
    p.add_argument(
        "--chunk-overlap-seconds",
        type=float,
        default=1.0,
        help="overlap between serving chunks (with --chunk-seconds)",
    )
    _add_device(p)
    p.set_defaults(func=cmd_separate)

    p = sub.add_parser("evaluate", help="score separated wavs (SI-SDR, SI-SDRi, BSS SDR/SIR/SAR)")
    p.add_argument("--data-root", required=True)
    p.add_argument("--est-dir", required=True)
    p.add_argument("--split", default="tt")
    p.add_argument("--per-utterance", default=None,
                   help="write per-utterance scores to this JSONL")
    p.set_defaults(func=cmd_evaluate)

    for name, func, helptext, src in (
        ("codec-encode", cmd_codec_encode, "tokenise a wav with a trained VQ codec", "--wav"),
        ("codec-decode", cmd_codec_decode, "codes → wav (gumbel or t3tok codec)", "--codes"),
        ("codec-roundtrip", cmd_codec_roundtrip, "wav → codec → wav reconstruction", "--wav"),
    ):
        p = sub.add_parser(name, help=helptext)
        p.add_argument("--checkpoint-dir", default="./CKPT")
        p.add_argument(src, required=True)
        p.add_argument("--out", required=True)
        _add_device(p)
        p.set_defaults(func=func)

    args = parser.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
