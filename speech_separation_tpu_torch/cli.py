"""Command line of the PyTorch port (counterpart of ``cli.py``).

    python -m speech_separation_tpu_torch.cli train --workload upit \\
        --config cfg.json --data-root D --epochs N --checkpoint-dir C [--resume]
    python -m speech_separation_tpu_torch.cli separate --checkpoint-dir C \\
        --data-root D --split tt --out-dir O [--bf16]

``train`` trains the uPIT BLSTM separator from raw waveforms (the ``blstm``
variant of the JAX ``train``), writing ``train_config.json``,
``metrics.jsonl`` and the best checkpoints to the checkpoint directory.
``separate`` loads the best checkpoint into ``separate_directory``. Both run
on the GPU when there is one, else on the CPU. The other subcommands and
options of the JAX CLI wait for later slices.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import torch

__all__ = ["main"]


def _device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _build_model(cfg, device: torch.device):
    from .models.upit import UPitBlstm

    model = UPitBlstm(
        hidden=cfg.hidden,
        num_layers=cfg.num_layers,
        num_speakers=cfg.num_speakers,
        dropout_rate=cfg.dropout,
        generator=torch.Generator().manual_seed(cfg.seed),
    )
    return model.to(device)


def _optimizer(cfg, steps_per_epoch: int):
    from . import train

    if cfg.lr_schedule == "cosine":
        return train.cosine_adam(
            cfg.learning_rate,
            total_steps=(cfg.sched_epochs or cfg.epochs) * steps_per_epoch,
            warmup_steps=cfg.lr_warmup_steps,
            grad_clip_norm=cfg.grad_clip_norm,
        )
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
    device = _device()
    model = _build_model(cfg, device)
    train_step, eval_step = train.make_upit_waveform_steps(
        model,
        cfg.stft.size,
        cfg.stft.shift,
        cfg.num_speakers,
        compute_dtype=torch.bfloat16 if cfg.bf16_compute else None,
    )
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
        lambda b: (b.mix, b.sources, b.frame_lengths),
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

    device = _device()
    cfg, model = _restore_upit(args.checkpoint_dir, device)
    written = separate_directory(
        model,
        pathlib.Path(args.data_root or cfg.data_root) / args.split,
        args.out_dir,
        size=cfg.stft.size,
        shift=cfg.stft.shift,
        num_speakers=cfg.num_speakers,
        batch_size=cfg.batch_size,
        sample_rate=cfg.stft.sample_rate,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
    )
    print(json.dumps({"written": len(written), "out_dir": str(args.out_dir), "device": str(device)}))


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
    p.set_defaults(func=cmd_train)

    p = sub.add_parser("separate", help="separate a split with a trained model")
    p.add_argument("--checkpoint-dir", default="./CKPT")
    p.add_argument("--data-root")
    p.add_argument("--split", default="tt")
    p.add_argument("--out-dir", default="./test_wav")
    p.add_argument("--bf16", action="store_true", help="bf16 mask network (serving precision)")
    p.set_defaults(func=cmd_separate)

    args = parser.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
