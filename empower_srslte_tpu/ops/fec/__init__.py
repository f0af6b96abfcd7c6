"""Forward error correction: turbo codec, convolutional codec, rate matching.

Batched counterpart of lib/src/phy/fec/. The turbo decoder is the
framework's flagship kernel (SURVEY.md section 7 stage 5): a windowed
max-log-MAP decoder batched over code blocks and trellis windows, replacing
the reference's SSE/AVX lane-parallel implementation
(lib/src/phy/fec/turbodecoder_win.h) with a GPU kernel (Pallas, Triton
route) and a plain-JAX scan formulation.
"""

from .tables import TURBO_CB_SIZES, cb_size_index, qpp_interleaver
from .cbsegm import CbSegm, cbsegm
from .turbo_encoder import turbo_encode, turbo_encode_np, TurboTrellis
from .rate_matching import RateMatchTurbo
from .turbo_decoder import TurboDecoder

__all__ = [
    "TURBO_CB_SIZES",
    "cb_size_index",
    "qpp_interleaver",
    "CbSegm",
    "cbsegm",
    "turbo_encode",
    "turbo_encode_np",
    "TurboTrellis",
    "RateMatchTurbo",
    "TurboDecoder",
]
