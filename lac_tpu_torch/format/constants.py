"""Wire-format constants for the ``.lac`` bitstream (the port's copy of
lac_tpu/format/constants.py; a test holds every name equal to it).

Single source of truth for every constant that appears on the wire or in
the canonical-validation rules. Values follow the reference format spec
(reference docs/format.md, src/codec/block/constants.hpp:6-15,
src/codec/lac/decoder.cpp:17-23, src/main.cpp:40-47).
"""

# ---------------------------------------------------------------- frame header
SYNC_WORD = 0x4C41  # "LA" (frame_header.hpp:8)
FORMAT_VERSION = 3  # current encoder output version
LEGACY_VERSION = 2  # decode-compatible serial version
HEADER_BYTES = 10  # 80-bit frame header (format.md:51)

SUPPORTED_SAMPLE_RATES = (44100, 48000, 96000, 192000)
SUPPORTED_BIT_DEPTHS = (16, 24)

STEREO_LR = 0
STEREO_MS = 1
STEREO_PER_BLOCK = 2

# ---------------------------------------------------------------- block layout
MAX_BLOCK_SIZE = 16384  # samples per channel per block (constants.hpp:6)
MIN_CANONICAL_NON_FINAL_BLOCK_SIZE = 256  # constants.hpp:7
ZERO_RUN_MIN_LENGTH = 4  # constants.hpp:8
ZERO_RUN_LENGTH_K = 2  # Rice k for encoded run lengths (constants.hpp:9)
MIN_PARTITION_SIZE = 32  # constants.hpp:10
MAX_PARTITION_ORDER = 8  # constants.hpp:11

# residual_control byte layout (format.md:180-189)
PARTITION_FLAG = 0x80
RESIDUAL_RESERVED_MASK = 0x10
PARTITION_ORDER_SHIFT = 0
PARTITION_ORDER_MASK = 0x0F
RESIDUAL_MODE_SHIFT = 5
RESIDUAL_MODE_MASK = 0x03

# ---------------------------------------------------------------- predictors
PREDICTOR_FIXED = 0
PREDICTOR_FIR = 1
PREDICTOR_LPC = 2

MAX_FIXED_ORDER = 4
FIR_ORDER = 2  # exactly 2 taps (format.md:136, block/encoder.cpp:59)
FIR_TAPS = (3, -1)  # block/encoder.cpp:59
FIR_SHIFT = 2  # block/encoder.cpp:58
MAX_LPC_ORDER = 32  # wire limit for predictor_order when LPC (format.md:136)
LPC_ORDER_CANDIDATES = (4, 6, 8, 10, 12)  # encoder search set (encoder.cpp:41)
LPC_FALLBACK_ORDERS = (12, 10, 8, 6, 4)  # residual range-fallback ladder (lpc.cpp:7)

# ---------------------------------------------------------------- residual modes
MODE_RICE = 0  # adaptive Rice
MODE_ZERO_RUN = 1
MODE_BIN = 2
MODE_STATIC = 3  # static Rice (fixed k per partition)

# zero-run token tags (format.md:346-354)
ZR_TAG_NORMAL = 0b00
ZR_TAG_RUN = 0b01
ZR_TAG_ESCAPE = 0b10

# bin-mode token tags (format.md:371-378)
BIN_TAG_ZERO = 0b00
BIN_TAG_ONE = 0b01
BIN_TAG_TWO = 0b10
BIN_TAG_FALLBACK = 0b11

# ---------------------------------------------------------------- encoder tuning
MAX_RICE_K = 31
INITIAL_SCAN_COUNT = 256  # samples scanned for initial k (encoder.cpp:42)
INITIAL_MAX_K = 12  # k search ceiling for initial k (encoder.cpp:43)
MAX_STATIC_K = 15  # k search ceiling for static mode (encoder.cpp:162)
DECODE_SPEED_MARGIN_DIVISOR = 20  # 5% static/partition margins (encoder.cpp:57)
ESCAPE_K_OFFSET = 3  # escape threshold = 1 << min(24, k+3) (encoder.cpp:250)
ESCAPE_K_CAP = 24

# adaptive-k window geometry (rice.hpp:12-13)
DRIFT_WINDOW = 256
MICRO_WINDOW = 96

# stereo-decision tuning (lac/encoder.cpp:18-20)
STEREO_CONFIDENCE_DIVISOR = 100
STEREO_PROBE_SIZE = 256
STEREO_FULL_COMPARISON_LIMIT = 4096

# ---------------------------------------------------------------- global limits
MAX_TOTAL_SAMPLES = 6_912_000_000  # 10 hours @ 192 kHz (lac/decoder.cpp:17)
MAX_DECODED_PCM_BYTES = 1 << 30  # lac/decoder.cpp:18
MAX_LAC_INPUT_BYTES = 1 << 30  # main.cpp:40
MAX_BLOCK_COUNT = (MAX_DECODED_PCM_BYTES // 4 + MIN_CANONICAL_NON_FINAL_BLOCK_SIZE - 1) // MIN_CANONICAL_NON_FINAL_BLOCK_SIZE

PCM16_MIN, PCM16_MAX = -32768, 32767
PCM24_MIN, PCM24_MAX = -0x800000, 0x7FFFFF

INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def pcm_range(bit_depth: int):
    """(lo, hi) valid sample range for a bit depth."""
    if bit_depth == 16:
        return PCM16_MIN, PCM16_MAX
    if bit_depth == 24:
        return PCM24_MIN, PCM24_MAX
    raise ValueError(f"unsupported bit depth: {bit_depth}")
