"""Error types for the JPEG engine.

The reference signals errors through a ctx->error string plus the
compile-time validation gate ``GLJ_ENABLE_VALIDATION`` (xjpeg.c:67-78).
We use exception types instead; the ``validate`` flag on the parser
controls how pedantic structural checking is.
"""


class JpegError(Exception):
    """Base class for all JPEG engine errors."""


class JpegFormatError(JpegError):
    """The bitstream violates the JPEG specification."""


class JpegUnsupportedError(JpegError):
    """Valid JPEG, but outside the supported subset.

    Supported subset (mirrors the reference, SURVEY.md 'Scope'):
    baseline sequential DCT (SOF0), 8-bit, 1 or 3 components, sampling
    factors 1/2/4, single scan, no arithmetic coding, no progressive.
    """
