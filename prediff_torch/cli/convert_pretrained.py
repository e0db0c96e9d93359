"""Convert the reference's published PyTorch checkpoints into the JAX
package's ``.npz`` parameter trees (``vae.npz``, ``earthformerunet.npz``,
``alignment.npz``: flax names and layouts, ``/``-joined keys), which the
``from_npz`` of both packages read.  Converts whichever of the three
``PRETRAINED_NAMES`` files are in ``--pt-dir``.  Counterpart of
``scripts/convert_pretrained.py``; host numpy, no device.

    python -m prediff_torch.cli.convert_pretrained --pt-dir /path/to/pt --out weights/
"""
import argparse
import os
import sys
from typing import Dict, List, Optional

from ..config import prediff_default_config
from ..factory import build_alignment_model, build_unet, build_vae
from ..utils.checkpoint import (DERIVED_BUFFERS, PRETRAINED_NAMES, load_torch_state_dict,
                                save_flax_npz)
from ..utils.convert import torch_params_to_flax

# output name -> the model's factory
MODELS = {"vae": build_vae, "earthformerunet": build_unet, "alignment": build_alignment_model}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pt-dir", required=True)
    p.add_argument("--out", default="weights")
    p.add_argument("--device", default=None, type=str,
                   help="taken for a uniform command line; the conversion is on the host")
    return p.parse_args(argv)


def convert(pt_dir: str, out: str, cfg=None) -> Dict[str, str]:
    """Each present ``.pt`` file of ``pt_dir`` as ``<out>/<name>.npz``;
    returns name -> written path."""
    cfg = cfg or prediff_default_config()
    os.makedirs(out, exist_ok=True)
    written = {}
    for name, build in MODELS.items():
        path = os.path.join(pt_dir, PRETRAINED_NAMES[name])
        if not os.path.exists(path):
            continue
        model = build(cfg)
        tree = torch_params_to_flax(model, load_torch_state_dict(path, model),
                                    skip_suffixes=DERIVED_BUFFERS)
        written[name] = os.path.join(out, f"{name}.npz")
        save_flax_npz(written[name], tree)
        print(f"converted {path} -> {written[name]}", flush=True)
    if not written:
        print("no known pretrained files found in", pt_dir, flush=True)
    return written


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    convert(args.pt_dir, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
