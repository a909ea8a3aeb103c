"""``sdf_rows``: the SDF term's rows before the decoder, one a point: the two
point transforms, the voxel lookup and the count gate (about 60 operations);
bytes: the point and its flag in (13), the indexer entry, the slot's count
and latent read (4 + 4 + 116), the decoder row, the moved point and the use
flag out (128 + 12 + 1)."""

from fusion_bench.rooflines import PEAK_F32

OPS_ROW = 60


def work(rows: int):
    return rows * float(OPS_ROW), rows * (13 + 124 + 141.0), PEAK_F32
