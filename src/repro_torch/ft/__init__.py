"""Fault tolerance (port of ``repro.ft``): deterministic fault injection
(``faults``) and the self-healing primitives, ``CircuitBreaker`` and
``RetryPolicy`` (``recovery``). The heartbeat and elastic re-mesh of
``repro.ft.failures`` belong to distributed serving, not ported yet."""
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
