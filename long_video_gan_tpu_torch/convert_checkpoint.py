"""Convert a reference PyTorch G_ema pickle into a `.lvg` checkpoint: the port's
counterpart of the repository's `convert_checkpoint.py`.

    python -m long_video_gan_tpu_torch.convert_checkpoint --pkl horseback_lres.pkl \\
        --kind lres --output horseback_lres.lvg --reference /path/to/long-video-gan

The reference's pickles rebuild their classes from the source they embed, so
`--reference` (its repository) goes on `sys.path` while unpickling, and
unpickling runs that code: convert only the published files. The output is
the JAX converter's file byte for byte (config `kind` and `kwargs`, then the
variables), arrays only; loading it executes nothing. Runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional


def convert(pkl_path: str, kind: str, output: str) -> None:
    """Read the pickle, load its state_dict into the port's generator of
    `kind` built from its init_kwargs (strictly: `load_reference_state`),
    and write the G_ema `.lvg`."""
    from .io.checkpoint import save_generator
    from .io.convert_torch import load_reference_pickle_state, load_reference_state

    state_dict, init_kwargs = load_reference_pickle_state(pkl_path)
    print(f"Loaded {pkl_path}: {len(state_dict)} tensors, init_kwargs={init_kwargs}")
    if kind == "lres":
        from .models.generator_lres import VideoGenerator
    else:
        from .models.generator_sres import VideoGenerator
    G = VideoGenerator(**init_kwargs, device="cpu")
    load_reference_state(G, state_dict)
    save_generator(output, G, dict(kind=f"generator_{kind}", kwargs=init_kwargs))
    print(f"Wrote {output}")


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pkl", dest="pkl_path", required=True, help="reference G_ema pickle")
    ap.add_argument("--kind", choices=["lres", "sres"], required=True)
    ap.add_argument("--output", required=True, help="output .lvg checkpoint")
    ap.add_argument("--reference", dest="reference_dir", default=None,
                    help="the reference repository, on sys.path while unpickling")
    args = ap.parse_args(argv)
    if args.reference_dir:
        sys.path.insert(0, args.reference_dir)
    convert(args.pkl_path, args.kind, args.output)


if __name__ == "__main__":
    main()
