from .ops import cloudlet_finish_pool  # noqa: F401
from .ref import FinishOut  # noqa: F401
from .ref import cloudlet_finish as cloudlet_finish_ref  # noqa: F401
