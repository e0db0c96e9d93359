"""Offline SEVIR -> SEVIR-LR downsampling: a block max over (t, h, w)
factors, the catalog copied beside the data.  Counterpart of
``scripts/downsample_sevir.py``; host numpy over h5py, no device.

    python -m prediff_torch.cli.downsample_sevir --sevir-dir /data/sevir --out /data/sevirlr
"""
import argparse
import os
import shutil
import sys
from typing import List, Optional

from ..datasets import SEVIRDataLoader


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sevir-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--t-factor", type=int, default=2)
    p.add_argument("--h-factor", type=int, default=3)
    p.add_argument("--w-factor", type=int, default=3)
    p.add_argument("--device", default=None, type=str,
                   help="taken for a uniform command line; the work is on the host")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    dl = SEVIRDataLoader(data_types=["vil"], seq_len=49, raw_seq_len=49, stride=12,
                         sevir_catalog=os.path.join(args.sevir_dir, "CATALOG.csv"),
                         sevir_data_dir=os.path.join(args.sevir_dir, "data"))
    os.makedirs(args.out, exist_ok=True)
    dl.save_downsampled_dataset(
        os.path.join(args.out, "data"),
        downsample_dict={"vil": (args.t_factor, args.h_factor, args.w_factor)})
    shutil.copy(os.path.join(args.sevir_dir, "CATALOG.csv"),
                os.path.join(args.out, "CATALOG.csv"))
    print(f"wrote downsampled dataset to {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
