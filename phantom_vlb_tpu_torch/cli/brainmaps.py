"""vlb-brainmaps-torch: validation accuracies projected into brain volumes.

Counterpart of ``phantom_vlb_tpu/cli/brainmaps.py`` (the arguments of
``make_acc_brainmaps.py``)::

    vlb-brainmaps-torch --metrics_path results/.../version_0 \
        --atlas_path atlas.nii.gz --out_path maps/sub-01 [--export_nii True]
"""

from __future__ import annotations

import argparse
import sys

from phantom_vlb_tpu_torch.postprocessing.brainmaps import BrainmapConfig, make_brainmaps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--metrics_path", required=True)
    p.add_argument("--atlas_path", required=True)
    p.add_argument("--out_path", required=True)
    p.add_argument("--export_nii", type=bool, default=False)
    args = p.parse_args(argv)

    written = make_brainmaps(
        BrainmapConfig(
            metrics_path=args.metrics_path,
            atlas_path=args.atlas_path,
            out_path=args.out_path,
            export_nii=args.export_nii,
        )
    )
    for path in written:
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
