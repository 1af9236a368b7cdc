from .ops import attention  # noqa: F401
from .ref import attention as attention_ref  # noqa: F401
