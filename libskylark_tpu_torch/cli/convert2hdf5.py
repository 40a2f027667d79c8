"""skylark-convert2hdf5: LIBSVM → HDF5 converter (port of
``libskylark_tpu/cli/convert2hdf5.py``; ≙ ``ml/skylark_convert2hdf5.cpp``).

Host code only (the native LIBSVM parser, ``h5py``); ``--device`` only
checks that the device asked for exists, as every driver does.  The file
it writes is the reference's layout, read by either package.
"""

from __future__ import annotations

import argparse
import sys

from .common import add_device_args, run_scope


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="skylark-convert2hdf5")
    p.add_argument("input", help="LIBSVM file")
    p.add_argument("output", help="HDF5 file")
    p.add_argument("--sparse", action="store_true")
    add_device_args(p)
    args = p.parse_args(argv)

    from ..io import read_libsvm, write_hdf5

    with run_scope(args):
        X, y = read_libsvm(args.input, sparse=args.sparse)
        write_hdf5(args.output, X, y, sparse=args.sparse)
    print(f"Wrote {args.output}: X {tuple(X.shape)}, Y {y.shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
