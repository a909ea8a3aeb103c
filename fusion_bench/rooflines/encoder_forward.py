"""``encoder_forward``: the prior's point encoder, (rows, 6) -> (rows, 29)."""

from fusion_bench.rooflines import ENCODER_MACS, ENCODER_WEIGHT_WORDS, MLP_PASSES, PEAK_TF32


def work(rows: int):
    return (MLP_PASSES * 2.0 * ENCODER_MACS * rows,
            rows * (6 + 29) * 4.0 + ENCODER_WEIGHT_WORDS * 4.0, PEAK_TF32)
