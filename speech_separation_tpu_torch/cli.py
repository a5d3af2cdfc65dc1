"""Command line of the PyTorch port (counterpart of ``cli.py``).

    python -m speech_separation_tpu_torch.cli train --workload upit \\
        --config cfg.json --data-root D --epochs N --checkpoint-dir C [--resume] \\
        [--device {cuda,cpu}]
    python -m speech_separation_tpu_torch.cli separate --checkpoint-dir C \\
        --data-root D --split tt --out-dir O [--bf16] [--batch-size N] \\
        [--kernel {xla,pallas}] [--pad-quantum-seconds S] \\
        [--chunk-seconds S --chunk-overlap-seconds S] [--transfer-int16] \\
        [--device {cuda,cpu}]

``train`` trains the config's ``variant`` from raw waveforms, writing
``train_config.json``, ``metrics.jsonl`` and the best checkpoints to the
checkpoint directory: the uPIT BLSTM (``blstm``) on the PIT loss of its
masks, or Conv-TasNet (``tasnet``) wave to wave on the negative SI-SDR, with
``tasnet_pallas_trunk`` running the TCN trunk's forward and backward in the
training CUDA kernels (bf16). ``separate`` loads the best checkpoint: a
``blstm`` checkpoint goes to ``separate_directory``; a ``tasnet`` checkpoint
to the time-domain path, whole utterances or overlapped chunks, with
``--kernel pallas`` running the TCN trunk in the ``tcn_trunk`` CUDA kernel
(bf16; the JAX flag's name) and ``--kernel xla`` the module's own forward.
Both run on the GPU (``--device cuda``, the default), and exit with an error
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


def cmd_train(args) -> None:
    from . import train
    from .data.datasets import WaveformLoader
    from .utils import MetricsLogger, UPitTrainConfig, load_config, save_config

    cfg = load_config(
        UPitTrainConfig,
        args.config,
        dict(data_root=args.data_root, epochs=args.epochs, checkpoint_dir=args.checkpoint_dir),
    )
    if cfg.variant == "tasnet" and cfg.tasnet_causal and cfg.tasnet_pallas_trunk:
        raise SystemExit(
            "error: tasnet_pallas_trunk runs the fused TCN trunk, which implements the gLN "
            "topology only; a causal (cLN) Conv-TasNet trains through the module "
            "(tasnet_pallas_trunk=false)"
        )
    device = _device(args.device)
    model = _build_model(cfg, device)
    if cfg.variant == "tasnet":
        train_step, eval_step = train.make_time_domain_steps(
            model,
            compute_dtype=torch.bfloat16
            if (cfg.bf16_compute or cfg.tasnet_pallas_trunk)
            else None,
            pallas_trunk=cfg.tasnet_pallas_trunk,
        )

        def batch_arrays(b):
            return b.mix, b.sources, b.sample_lengths

    else:
        train_step, eval_step = train.make_upit_waveform_steps(
            model,
            cfg.stft.size,
            cfg.stft.shift,
            cfg.num_speakers,
            compute_dtype=torch.bfloat16 if cfg.bf16_compute else None,
        )

        def batch_arrays(b):
            return b.mix, b.sources, b.frame_lengths

    root = pathlib.Path(cfg.data_root)

    def make_loader(split: str, shuffle: bool) -> WaveformLoader:
        return WaveformLoader(
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

    train_loader = make_loader(cfg.train_split, True)
    state = train.TrainState.create(
        model, _optimizer(cfg, max(1, len(train_loader.names) // cfg.batch_size)), cfg.seed
    )
    ckpt = train.CheckpointManager(cfg.checkpoint_dir)
    save_config(cfg, pathlib.Path(cfg.checkpoint_dir) / "train_config.json")
    logger = MetricsLogger(pathlib.Path(cfg.checkpoint_dir) / "metrics.jsonl")
    result = train.fit(
        state,
        train_step,
        eval_step,
        train_loader,
        make_loader(cfg.val_split, False),
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

    p = sub.add_parser("train", help="train a separator")
    p.add_argument("--config")
    p.add_argument("--workload", default="upit", choices=["upit"])
    p.add_argument("--data-root")
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

    args = parser.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
