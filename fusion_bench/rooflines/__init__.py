"""One file per kernel: ``work(**sizes)`` -> (operations, bytes, peak
operations per second of the unit it computes on).

The least time of a call is the larger of operations over that peak and
bytes over the HBM rate (``discovery.bound_s``).  Work is what the inputs
need, each byte read once and written once; where a count depends on the
data and no counter gives it (valid pixels, distinct source rows), it is
left out, so the bound is a lower one.  Peaks: the NVIDIA H100 SXM data
sheet, dense, at the 700 W limit.
"""

PEAK_TF32 = 495e12          # tensor cores, TF32 operands, FLOP/s
PEAK_F32 = 67e12            # CUDA cores, float32, FLOP/s
HBM_BYTES_PER_S = 3.35e12

# The prior's layers at their published widths (latent 29 + xyz 3 in;
# hidden 128-128-96-128 with the input re-fed before the fourth; the sdf
# and std heads), multiply-adds a row.
DECODER_HIDDEN_MACS = 32 * 128 + 128 * 128 + 128 * 96 + (96 + 32) * 128
DECODER_HEAD_MACS = 2 * 128
# forward-mode d sdf / d xyz: three tangents through lin1, lin2, lin3's
# first 96 inputs and the sdf head (lin0's and the re-fed input's
# tangents are weight rows, no product)
DECODER_TANGENT_MACS = 3 * (128 * 128 + 128 * 96 + 96 * 128 + 128)
ENCODER_MACS = 6 * 32 + 32 * 64 + 64 * 256 + 256 * 29
DECODER_WEIGHT_WORDS = 49890
ENCODER_WEIGHT_WORDS = 27264
# The MLP kernels emulate float32 as three TF32 products on the tensor cores.
MLP_PASSES = 3


# the decoder's reverse pass in its input: the heads, then lin3, lin2, lin1
# and lin0 transposed (lin3's re-fed input rows included)
DECODER_REVERSE_MACS = DECODER_HEAD_MACS + 128 * 128 + 96 * 128 + 128 * 128 + 128 * 32


def model_flops(kernel: str, rows: int) -> float:
    """The prior's FLOPs for ``rows`` rows of ``kernel``, from the published
    widths, each row counted once (2 x multiply-adds; no emulation passes).
    ``decoder_vjp`` is the reverse pass alone: its forward recompute repeats
    what the refinement's ``decoder_forward`` call of the same step counts
    (model FLOPs count no recomputation)."""
    macs = {"decoder_forward": DECODER_HIDDEN_MACS + DECODER_HEAD_MACS,
            "decoder_forward_grad": DECODER_HIDDEN_MACS + DECODER_HEAD_MACS
            + DECODER_TANGENT_MACS,
            "decoder_vjp": DECODER_REVERSE_MACS,
            "encoder_forward": ENCODER_MACS}[kernel]
    return 2.0 * macs * rows
