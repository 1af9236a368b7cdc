from .ops import tropical_closure, tropical_matmul  # noqa: F401
from .ref import NEG_INF, tropical_identity  # noqa: F401
