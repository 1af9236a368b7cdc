from .ops import (cloudlet_finish, cloudlet_finish_pool,  # noqa: F401
                  cloudlet_step)
from .ref import FinishOut  # noqa: F401
from .ref import cloudlet_finish as cloudlet_finish_ref  # noqa: F401
from .ref import cloudlet_step as cloudlet_step_ref  # noqa: F401
