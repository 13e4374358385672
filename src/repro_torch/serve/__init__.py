"""Serving runtime of the port (``repro.serve``'s counterpart): ``engine``
(``ServingEngine``), ``batcher`` (``CoalescingBatcher``), ``cache``
(``UserRepCache`` and the device-resident tier ``DeviceRepStore``),
``hedging`` (``HedgePolicy``, ``HedgedRunner``), ``plan`` (``ServePlan``),
``profile`` (``StageProfiler``), ``service`` (``RankingService``) and
``errors``."""
from repro_torch.serve.batcher import (  # noqa: F401
    SLO_BEST_EFFORT,
    SLO_DEADLINE,
    CoalescingBatcher,
)
from repro_torch.serve.cache import DeviceRepStore, UserRepCache  # noqa: F401
from repro_torch.serve.engine import (  # noqa: F401
    ServeRequest,
    ServeResult,
    ServingEngine,
    bucket_for,
)
from repro_torch.serve.errors import (  # noqa: F401
    AdmissionError,
    BatcherClosedError,
    CircuitOpenError,
    FaultInjected,
    RetryExhausted,
    ServeError,
    WorkerCrashedError,
)
from repro_torch.serve.hedging import HedgedRunner, HedgePolicy  # noqa: F401
from repro_torch.serve.plan import (  # noqa: F401
    FaultPlan,
    MemPlan,
    ObsPlan,
    PlanError,
    PlanResolutionWarning,
    ServePlan,
)
from repro_torch.serve.profile import StageProfiler  # noqa: F401
from repro_torch.serve.service import RankingService  # noqa: F401
