"""``decoder_vjp``: the decoder's vector-Jacobian product in its input,
(rows, 32) + (rows, 2) -> (rows, 32): the forward recompute and the
reverse pass (lin3, lin2, lin1, lin0 transposed on the tensor cores)."""

from fusion_bench.rooflines import DECODER_HEAD_MACS, DECODER_HIDDEN_MACS, \
    DECODER_REVERSE_MACS, DECODER_WEIGHT_WORDS, MLP_PASSES, PEAK_TF32


def work(rows: int):
    return (MLP_PASSES * 2.0 * (DECODER_HIDDEN_MACS + DECODER_HEAD_MACS + DECODER_REVERSE_MACS)
            * rows, rows * (32 + 2 + 32) * 4.0 + DECODER_WEIGHT_WORDS * 4.0, PEAK_TF32)
