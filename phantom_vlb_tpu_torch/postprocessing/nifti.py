"""Minimal NIfTI-1 I/O for the brain maps (numpy and the standard library).

The port's own copy of ``phantom_vlb_tpu/postprocessing/nifti.py``: reading
an integer atlas volume (``.nii`` / ``.nii.gz``) and writing float volumes
with the same affine, in the single-file NIfTI-1 layout (348-byte header,
magic ``n+1``, vox_offset 352).
"""

from __future__ import annotations

import dataclasses
import gzip
import struct
from pathlib import Path

import numpy as np

__all__ = ["NiftiImage", "load_nifti", "save_nifti"]

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
    64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32,
    1024: np.int64, 1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclasses.dataclass
class NiftiImage:
    data: np.ndarray            # (X, Y, Z[, T]) array
    affine: np.ndarray          # (4, 4) voxel->world transform
    header_extra: dict = dataclasses.field(default_factory=dict)

    @property
    def shape(self):
        return self.data.shape


def _open(path: Path, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def load_nifti(path: str | Path) -> NiftiImage:
    path = Path(path)
    with _open(path, "rb") as f:
        raw = f.read()
    hdr = raw[:348]
    sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
    if sizeof_hdr != 348:
        raise ValueError(f"{path}: not a little-endian NIfTI-1 file")
    dim = struct.unpack_from("<8h", hdr, 40)
    ndim = dim[0]
    shape = tuple(dim[1 : 1 + ndim])
    datatype = struct.unpack_from("<h", hdr, 70)[0]
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dtype = np.dtype(_DTYPES[datatype])
    vox_offset = int(struct.unpack_from("<f", hdr, 108)[0])
    scl_slope = struct.unpack_from("<f", hdr, 112)[0]
    scl_inter = struct.unpack_from("<f", hdr, 116)[0]

    srow_x = struct.unpack_from("<4f", hdr, 280)
    srow_y = struct.unpack_from("<4f", hdr, 296)
    srow_z = struct.unpack_from("<4f", hdr, 312)
    sform_code = struct.unpack_from("<h", hdr, 254)[0]
    if sform_code > 0:
        affine = np.array([srow_x, srow_y, srow_z, [0, 0, 0, 1]], np.float64)
    else:
        pixdim = struct.unpack_from("<8f", hdr, 76)
        affine = np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0])

    count = int(np.prod(shape))
    data = np.frombuffer(
        raw, dtype=dtype, count=count, offset=vox_offset
    ).reshape(shape, order="F").copy()
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter
    return NiftiImage(data=data, affine=affine)


def save_nifti(img: NiftiImage, path: str | Path) -> None:
    data = np.asarray(img.data)
    if data.dtype not in _CODES:
        data = data.astype(np.float32)
    code = _CODES[np.dtype(data.dtype)]
    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    # pixdim from affine column norms.
    pixdim = [1.0] + [
        float(np.linalg.norm(img.affine[:3, i])) for i in range(3)
    ] + [1.0, 1.0, 1.0, 1.0]
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)   # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)     # scl_slope
    struct.pack_into("<h", hdr, 252, 1)       # qform_code (unused but valid)
    struct.pack_into("<h", hdr, 254, 1)       # sform_code
    struct.pack_into("<4f", hdr, 280, *img.affine[0])
    struct.pack_into("<4f", hdr, 296, *img.affine[1])
    struct.pack_into("<4f", hdr, 312, *img.affine[2])
    hdr[344:348] = b"n+1\x00"

    body = data.tobytes(order="F")
    with _open(Path(path), "wb") as f:
        f.write(bytes(hdr) + b"\x00" * 4 + body)
