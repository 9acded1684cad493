"""nicetpu — lossless image codec for the `.nice` format on JAX devices.

A JAX/XLA implementation (with a C++ host oracle) of the
`.nice` lossless RGB image format defined by the reference
`wouter-rombouts/fast-losless-image-compression-format` (see SURVEY.md for the
full behavioral spec).  The compute path runs on the device: the per-pixel mode
cascade, run analysis, histograms and bit-packing are vectorized tensor
programs; the runtime around them (Huffman table build, header pack/parse,
serial oracle codec) is native C++/numpy.

Public API:
    encode(img)   -> bytes           (.nice bitstream)
    decode(data)  -> np.ndarray      ((H, W, 3) uint8)
    encode_batch/decode_batch — batched (device-friendly) variants
    imread/imwrite — PNG <-> array bridges
"""

from nicetpu.api import (
    decode,
    decode_batch,
    encode,
    encode_batch,
    imread,
    imwrite,
)

__version__ = "0.1.0"

__all__ = [
    "encode",
    "decode",
    "encode_batch",
    "decode_batch",
    "imread",
    "imwrite",
    "__version__",
]
