"""Typed training configuration with JSON round-trip (counterpart of
``utils/config.py``).

:class:`UPitTrainConfig` keeps the JAX package's field names and defaults, so
one ``cfg.json`` configures either package. ``variant`` is ``"blstm"`` or
``"tasnet"``, both served and trained (``tasnet_pallas_trunk`` trains
Conv-TasNet through the trunk's training kernels; ``pack`` trains the BLSTM
on sequence-packed rows). Fields whose feature the port does not serve yet
raise ``ValueError`` when set, rather than being ignored: ``variant="conv"``,
``dynamic_mix``, and a mesh of more than one device. ``blstm_pallas_scan`` is
accepted and has no effect: on a GPU the port always runs its BiLSTM training
kernels.

:class:`VaeTrainConfig` is the codecs' config, the JAX dataclass's fields and
defaults; every variant (``gumbel``, ``v2``, ``t2``, ``t3``, ``t3tok``) is
trained and served.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from dataclasses import dataclass, field
from typing import Any

__all__ = [
    "StftConfig",
    "MeshConfig",
    "UPitTrainConfig",
    "VaeTrainConfig",
    "load_config",
    "save_config",
]


@dataclass(frozen=True)
class StftConfig:
    size: int = 256
    shift: int = 128
    sample_rate: int = 8000
    method: str = "matmul"  # "matmul" (the stft_cuda kernel on a GPU) or "fft"


@dataclass(frozen=True)
class MeshConfig:
    data: int | None = None  # None → all devices (one, in the port)
    model: int = 1
    tensor_parallel: bool = False


@dataclass(frozen=True)
class UPitTrainConfig:
    data_root: str = "./mycode/wsj0_2mix/use_this"
    train_split: str = "tr"
    val_split: str = "cv"
    variant: str = "blstm"  # "blstm" or "tasnet" in the port; "conv" waits
    batch_size: int = 2
    epochs: int = 5
    patience: int = 50
    hidden: int = 496
    num_layers: int = 3
    num_speakers: int = 2
    dropout: float = 0.8
    learning_rate: float = 1e-3
    lr_decay_steps: int = 20
    lr_decay_rate: float = 0.96
    lr_schedule: str = "default"  # "cosine": warmup+cosine over the whole run
    lr_warmup_steps: int = 500
    sched_epochs: int = 0  # cosine horizon for chunked runs (0 → epochs)
    dynamic_mix: bool = False  # not served by the port yet
    grad_clip_norm: float = 0.0  # >0: optax-style global-norm clipping
    bf16_compute: bool = False  # mixed-precision train step
    blstm_pallas_scan: bool = False  # no effect: the port always runs its kernels
    pack: bool = False  # sequence-packed rows (blstm only)
    transfer_int16: bool = False  # int16 PCM to the device, dequantized in the step
    pack_rows_per_batch: int = 16
    pack_row_seconds: float = 16.0
    tasnet_pallas_trunk: bool = False
    frame_size: int = 40
    tasnet_enc_dim: int = 256
    tasnet_win: int = 16
    tasnet_bottleneck: int = 128
    tasnet_hidden: int = 256
    tasnet_blocks: int = 7
    tasnet_repeats: int = 3
    tasnet_causal: bool = False
    checkpoint_dir: str = "./CKPT"
    seed: int = 42
    stft: StftConfig = field(default_factory=StftConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def __post_init__(self) -> None:
        unserved = []
        if self.variant not in ("blstm", "tasnet"):
            unserved.append(f"variant={self.variant!r} (only 'blstm' and 'tasnet')")
        if self.dynamic_mix:
            unserved.append("dynamic_mix=true")
        if self.mesh.model > 1 or self.mesh.data not in (None, 1):
            unserved.append(f"mesh data={self.mesh.data} model={self.mesh.model} (one device)")
        if unserved:
            raise ValueError(
                "UPitTrainConfig: not served by the PyTorch port yet: " + "; ".join(unserved)
            )


VAE_VARIANTS = ("gumbel", "v2", "t2", "t3", "t3tok")


@dataclass(frozen=True)
class VaeTrainConfig:
    data_root: str = "./mycode/wsj0_2mix/use_this"
    train_split: str = "tr"
    val_split: str = "cv"
    variant: str = "t3"  # gumbel | v2 | t2 | t3 | t3tok
    source: str = "s1"
    batch_size: int = 2
    epochs: int = 5
    patience: int = 50
    latent_dim: int = 1024  # gumbel variant
    embedding_dim: int = 64
    num_embeddings: int = 512
    skip_embeddings: int = 512  # t3tok variant: second VQ over the U-skip
    deep_depth: int = 2  # t3tok: residual-VQ stages on the bottleneck
    skip_depth: int = 2  # t3tok: residual-VQ stages on the skip
    skip_pq: int = 2  # t3tok: product-quantization sub-vectors per skip stage
    learning_rate: float = 1e-3
    checkpoint_dir: str = "./CKPT"
    seed: int = 42
    sample_rate: int = 8000

    def __post_init__(self) -> None:
        if self.variant not in VAE_VARIANTS:
            raise ValueError(f"VaeTrainConfig: unknown variant {self.variant!r} "
                             f"(one of {', '.join(VAE_VARIANTS)})")


_NESTED = {"StftConfig": StftConfig, "MeshConfig": MeshConfig}


def _resolve_type(tp):
    """Field types are strings under ``from __future__ import annotations``."""
    if isinstance(tp, str):
        return _NESTED.get(tp)
    return tp if dataclasses.is_dataclass(tp) else None


def _from_dict(cls, payload: dict[str, Any]):
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(payload) - known
    if unknown:
        raise ValueError(
            f"unknown {cls.__name__} config keys: {sorted(unknown)} (valid: {sorted(known)})"
        )
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in payload:
            continue
        value = payload[f.name]
        nested = _resolve_type(f.type)
        if nested is not None and isinstance(value, dict):
            value = _from_dict(nested, value)
        elif isinstance(value, list):
            value = tuple(value)
        kwargs[f.name] = value
    return cls(**kwargs)


def load_config(cls, path: str | pathlib.Path | None = None, overrides: dict | None = None):
    """Build a config from a JSON file plus flat overrides (``None`` values skipped)."""
    payload: dict[str, Any] = {}
    if path is not None:
        payload = json.loads(pathlib.Path(path).read_text())
    if overrides:
        payload.update({k: v for k, v in overrides.items() if v is not None})
    return _from_dict(cls, payload)


def save_config(config, path: str | pathlib.Path) -> None:
    pathlib.Path(path).write_text(json.dumps(dataclasses.asdict(config), indent=2))
