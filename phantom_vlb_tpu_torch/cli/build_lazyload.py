"""vlb-build-lazyload-torch: stage 2 of the port, the lazy-load dataset builder.

Usage (the arguments of ``vlb-build-lazyload``)::

    vlb-build-lazyload-torch --features_path features_s1.h5 --timeseries_path bold_sub-01.h5 \
        --lazyload_path OUT_DIR --subject sub-01 --season s1 [--n_split 4 --delay 3 --window 3]

It writes ``friends_llFile_{subject}_{season}_n{i}.h5`` for each split
(``h5py``), each byte-equal to ``vlb-build-lazyload``'s. Like that CLI it
is host work (HRF weights and copies) and has no device flag.
"""

from __future__ import annotations

import argparse
import sys

from phantom_vlb_tpu_torch.data.lazyload_build import LazyloadBuildConfig, build_lazyload_dsets, infer_geometry


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--features_path", required=True)
    p.add_argument("--timeseries_path", required=True)
    p.add_argument("--lazyload_path", required=True)
    p.add_argument("--subject", required=True)
    p.add_argument("--season", required=True)
    p.add_argument("--n_split", type=int, default=4)
    p.add_argument("--delay", type=int, default=3)
    p.add_argument("--window", type=int, default=3)
    args = p.parse_args(argv)

    # The geometry comes from the features file (frames a sample, image
    # size, token widths), so builder and extraction never disagree.
    geometry = infer_geometry(args.features_path, window=args.window, delay=args.delay)
    paths = build_lazyload_dsets(LazyloadBuildConfig(
        features_path=args.features_path,
        timeseries_path=args.timeseries_path,
        lazyload_path=args.lazyload_path,
        subject=args.subject,
        season=args.season,
        n_split=args.n_split,
        geometry=geometry,
    ))
    print(f"Built lazy loading dset for {args.subject}, season {args.season}")
    for path in paths:
        print(f"  {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
