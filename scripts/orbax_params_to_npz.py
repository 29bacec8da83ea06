"""Convert a JAX package checkpoint's online-network weights to the params
``.npz`` that the PyTorch port reads.

Run it where JAX is installed (the machine that trained the run), from the
root of the repository::

    python scripts/orbax_params_to_npz.py --checkpoint-dir runs/dqn_r3 \\
        --out dqn_r3_params.npz [--step N | --named tile_2048_ep1858]

then play the weights on the card with the port::

    python -m tpu2048_torch eval --policy model --params dqn_r3_params.npz \\
        [--features F --hidden H --blocks N --no-bf16]

The checkpoint is read with ``tpu2048.checkpoint.ckpt.restore_params_only``
on the CPU; the widths and the rest of the loop state's shape come from
the run's ``config.json`` as ``python -m tpu2048 eval`` takes them, and
``--features``, ``--hidden``, ``--blocks``, ``--no-bf16`` and ``--engine``
override it. The file holds the flax parameter names joined with ``/``
(``block0/conv1x1_kernel``, ``dense/kernel``, ...), which
``tpu2048_torch.checkpoint.params.load_params`` reads. Only the weights
convert: the rest of the loop state (the target network, Adam's moments,
the buffer, the threefry keys) has no counterpart that the port could
resume from.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def convert(checkpoint_dir: str, out: str, step=None, named=None,
            overrides=()) -> str:
    """Write the online weights of ``checkpoint_dir`` (the latest step, or
    ``step``, or the named checkpoint ``named``) to ``out``; returns the
    step or name read. ``overrides`` are ``python -m tpu2048 eval`` flags
    (``["--features", "32", ...]``) that win over ``config.json``."""
    import jax
    import numpy as np

    from tpu2048.checkpoint.ckpt import restore_params_only
    from tpu2048.cli.main import (_load_run_config, _restore_config,
                                  build_parser)
    from tpu2048_torch.checkpoint.params import save_params

    argv = ["eval", "--policy", "model", "--checkpoint-dir", checkpoint_dir,
            *overrides]
    args = build_parser().parse_args(argv)
    args._argv = argv
    args = _load_run_config(args, checkpoint_dir)
    config = _restore_config(args, checkpoint_dir)
    tag, params = restore_params_only(checkpoint_dir, step, config,
                                      named=named)
    if params is None:
        raise FileNotFoundError(f"no checkpoint found in {checkpoint_dir}")
    save_params(out, jax.tree.map(lambda x: np.asarray(x, np.float32),
                                  params))
    return tag


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                allow_abbrev=False)
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--out", required=True, help="the params .npz to write")
    which = p.add_mutually_exclusive_group()
    which.add_argument("--step", type=int, default=None,
                       help="step checkpoint (default: the latest)")
    which.add_argument("--named", type=str, default=None,
                       help="a named checkpoint (tile_*, block_checkpoint)")
    p.add_argument("--features", type=int)
    p.add_argument("--hidden", type=int)
    p.add_argument("--blocks", type=int)
    p.add_argument("--no-bf16", action="store_true")
    p.add_argument("--engine", choices=["auto", "fast", "lax"])
    args = p.parse_args(argv)
    overrides = []
    for flag in ("features", "hidden", "blocks", "engine"):
        value = getattr(args, flag)
        if value is not None:
            overrides += [f"--{flag}", str(value)]
    if args.no_bf16:
        overrides.append("--no-bf16")

    import jax

    # The restore runs on the host: no accelerator is needed.
    jax.config.update("jax_platforms", "cpu")
    try:
        tag = convert(args.checkpoint_dir, args.out, args.step, args.named,
                      overrides)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 2
    print(f"wrote {args.out} from {args.checkpoint_dir} ({tag})")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())
