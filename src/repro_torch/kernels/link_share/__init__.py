from .ops import link_share  # noqa: F401
from .ref import link_share as link_share_ref  # noqa: F401
from .ref import waterfill  # noqa: F401
