"""Fault tolerance (port of ``repro.ft``): deterministic fault injection
(``faults``), the self-healing primitives ``CircuitBreaker`` and
``RetryPolicy`` (``recovery``), and the distributed control plane,
``HeartbeatMonitor`` and ``plan_elastic_remesh`` (``failures``)."""
from repro_torch.ft import failures as _failures
from repro_torch.ft.failures import (  # noqa: F401
    ElasticPlan,
    HeartbeatMonitor,
    plan_elastic_remesh,
)
from repro_torch.ft.faults import (  # noqa: F401
    CORRUPT,
    FAULT_SITES,
    FaultInjector,
    FaultSpec,
    parse_fault_spec,
)
from repro_torch.ft.recovery import (  # noqa: F401
    CircuitBreaker,
    RetryPolicy,
)


def __getattr__(name):
    # ``HedgePolicy``, re-exported lazily by ``ft.failures``
    return _failures.__getattr__(name)
