"""ako_tpu_torch — the Ako wavelet image codec on PyTorch and CUDA.

The PyTorch port of ako_tpu, which stays the reference it is held
against: for every settings combination the `.ako` blob is
byte-identical and the decoded pixels bit-identical to ako_tpu's (and
the reference C codec's). The colour transform and the dyadic integer
lift run on the card through hand-written CUDA kernels: in the fused
wiring of AKO_TORCH_LIFT_MODE (the default) one whole-pyramid launch
per tile-shape group each way (csrc/lift_pyramid.cu, colour and
quantize/gate fused), after one launch a level (csrc/lift_level.cu,
colour, quantize/gate and the dequantize fused) for the planes too large
for a block; in the split wiring per-level V-only launches
(csrc/vlift.cu). With `device_entropy` (the default on the card)
Kagari coding runs there too: tokenize and pack as one launch of one
CUDA kernel per shape group (csrc/kagari_encode.cu), the block-parallel
decode as another (csrc/kagari_decode.cu) from host sync records;
MANBAVARAN under AKO_TPU_MANBAVARAN=1 is rANS-coded there by two more
(csrc/manba_encode.cu, csrc/manba_decode.cu). Otherwise, and for the
container, the port's copy of the native C runtime (csrc/akort.c)
codes on the host; AKO_TPU_ENCODE=host / AKO_TPU_DECODE=host code every
tile there. decode.decode_tiles_iter is the streaming decode.

For a stream of images, runtime/executor.py (PipelineEncoder,
PipelineDecoder, roundtrip_iter) keeps several images in flight, each on
a CUDA stream of its own with pinned host buffers, so that one image's
host work (staging, framing, the sync scans, placement) overlaps the
next image's device work.

tools/ holds the command lines (`python -m ako_tpu_torch.tools.akoenc`,
`... .akodec`) and rate control (tools/rate.encode_with_ratio, akoenc's
-dev-r): the pyramid is lifted once per colour variant, and each probe of
the search is one launch per shape group of a kernel that quantizes the
cached pyramid as it loads it and returns each tile's Kagari payload size
(in csrc/kagari_encode.cu, beside K3); the chosen q is serialized by
another (csrc/rate.cu) and packed by K3. The package imports torch and
numpy, never JAX, and reads no file of ako_tpu (the CLIs read images
through Pillow).
"""

from ako_tpu_torch.core.settings import (
    FORMAT_VERSION,
    MAX_CHANNELS,
    MAX_TILES_DIMENSION,
    MIN_TILES_DIMENSION,
    VERSION_MAJOR,
    VERSION_MINOR,
    VERSION_PATCH,
    AkoError,
    Color,
    Compression,
    Settings,
    Status,
    Wavelet,
    Wrap,
    default_settings,
    status_string,
)
from ako_tpu_torch.decode import decode
from ako_tpu_torch.encode import encode

__version__ = f"{VERSION_MAJOR}.{VERSION_MINOR}.{VERSION_PATCH}"

__all__ = [
    "Settings",
    "Wavelet",
    "Color",
    "Wrap",
    "Compression",
    "Status",
    "AkoError",
    "default_settings",
    "status_string",
    "encode",
    "decode",
    "MAX_CHANNELS",
    "MIN_TILES_DIMENSION",
    "MAX_TILES_DIMENSION",
    "FORMAT_VERSION",
]
