from repro_torch.serve.cache import UserRepCache  # noqa: F401
from repro_torch.serve.engine import (  # noqa: F401
    ServeRequest,
    ServeResult,
    ServingEngine,
    bucket_for,
)
from repro_torch.serve.plan import (  # noqa: F401
    PlanError,
    PlanResolutionWarning,
    ServePlan,
)
from repro_torch.serve.profile import StageProfiler  # noqa: F401
