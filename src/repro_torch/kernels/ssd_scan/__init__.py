from .ops import ssd, ssd_chunk, ssd_decode_step  # noqa: F401
from .ref import ssd_chunked_ref, ssd_ref  # noqa: F401
