#!/usr/bin/env python3
"""Convert a JAX package checkpoint (orbax) to the PyTorch port's format.

    python3 convert_jax_checkpoint.py <jax_checkpoint_dir> <out_dir> [--step N]

Runs where JAX and orbax are installed.  Restores the latest (or the
given) ``model-<step>`` of ``<jax_checkpoint_dir>`` with
``pointgnn_tpu.train.checkpoint.restore_checkpoint``, carries its
parameters across with ``params_from_jax`` (bit for bit, on the CPU) and
writes ``<out_dir>/model-<step>/params.npz`` with
``pointgnn_tpu_torch.train.checkpoint.save_checkpoint``, copying the
frozen ``config`` and ``train_config`` files.  Only the parameters are
carried: the JAX optimizer state (optax) has no counterpart in the
port's optimizers.
"""

import argparse
import os
import shutil
import sys


def convert(jax_dir, out_dir, step=None):
    """Convert one step; returns the port's step directory."""
    from pointgnn_tpu.train import checkpoint as jax_ckpt
    from pointgnn_tpu_torch.params import params_from_jax
    from pointgnn_tpu_torch.train import checkpoint as torch_ckpt

    state, step = jax_ckpt.restore_checkpoint(jax_dir, step=step)
    if state is None:
        raise FileNotFoundError("no checkpoint found in %s" % jax_dir)
    params = state["params"] if "params" in state else state
    path = torch_ckpt.save_checkpoint(
        out_dir, step, {"params": params_from_jax(params, device="cpu")}
    )
    for name in ("config", "train_config"):
        src = os.path.join(jax_dir, name)
        if os.path.isfile(src):
            shutil.copyfile(src, os.path.join(out_dir, name))
    return path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("jax_checkpoint_dir")
    parser.add_argument("out_dir")
    parser.add_argument("--step", type=int, default=None,
                        help="step to convert (default: the latest)")
    args = parser.parse_args(argv)
    from pointgnn_tpu.utils.platform import honor_platform_env

    honor_platform_env()
    path = convert(args.jax_checkpoint_dir, args.out_dir, args.step)
    print("wrote %s" % path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
