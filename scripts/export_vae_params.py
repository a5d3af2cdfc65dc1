"""Export a trained VQ-VAE codec checkpoint's parameters as a numpy ``.npz``,
readable without JAX or orbax (the PyTorch port loads it with
``speech_separation_tpu_torch.weights.load_params_npz``).

    JAX_PLATFORMS=cpu python scripts/export_vae_params.py \\
        [--checkpoint artifacts/t3tok_hard/ckpt_ep38.tgz] \\
        [--out artifacts/t3tok_hard/params_ep38.npz]

The ``.tgz`` holds one orbax step directory; the ``train_config.json`` beside
it describes the codec. Both are unpacked into a temporary directory and
restored through the JAX package's own ``cli._restore_vae``. The file holds
one float32 array per parameter, named by its flax path joined with dots
(``encoder1.kernel``, ``vq2.embeddings``, ...). Needs JAX, flax and orbax.
"""

from __future__ import annotations

import argparse
import pathlib
import shutil
import sys
import tarfile
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CHECKPOINT = ROOT / "artifacts" / "t3tok_hard" / "ckpt_ep38.tgz"
OUT = ROOT / "artifacts" / "t3tok_hard" / "params_ep38.npz"


def restore_flat_params(checkpoint: pathlib.Path = CHECKPOINT) -> dict[str, np.ndarray]:
    """The checkpoint's parameters as ``{"path.joined.by.dots": float32 array}``."""
    import jax

    from speech_separation_tpu import cli

    checkpoint = pathlib.Path(checkpoint)
    with tempfile.TemporaryDirectory(prefix="vae_params_") as tmp:
        with tarfile.open(checkpoint) as tar:
            tar.extractall(tmp, filter="data")
        shutil.copy(checkpoint.parent / "train_config.json", tmp)
        _, _, state = cli._restore_vae(tmp)
        leaves = jax.tree_util.tree_leaves_with_path(state.params)
        return {
            ".".join(key.key for key in path): np.asarray(value, np.float32)
            for path, value in leaves
        }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkpoint", type=pathlib.Path, default=CHECKPOINT)
    parser.add_argument("--out", type=pathlib.Path, default=OUT)
    args = parser.parse_args()
    params = restore_flat_params(args.checkpoint)
    np.savez(args.out, **params)
    total = sum(v.size for v in params.values())
    print(f"{args.out}: {len(params)} arrays, {total:,} parameters")


if __name__ == "__main__":
    main()
