from .ops import (closure_route, tropical_closure,  # noqa: F401
                  tropical_matmul)
from .ref import NEG_INF, tropical_identity  # noqa: F401
