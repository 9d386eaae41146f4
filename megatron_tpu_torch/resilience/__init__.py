"""Fault tolerance for long training runs and the serving engine
(megatron_tpu/resilience): the checkpoint manifests, verification,
fall-back and retention (`integrity`), retried storage I/O (`retry`), the
divergence guard (`guard`), the hung-step watchdog (`watchdog`) and the
fault-injection harness that proves them (`faults`)."""
from megatron_tpu_torch.resilience.faults import (  # noqa: F401
    FaultInjector, InjectedFault, activate, deactivate, fault_point,
    get_fault_injector, use_fault_injector)
from megatron_tpu_torch.resilience.guard import (  # noqa: F401
    DivergenceGuard, GuardAction, TrainingDivergedError)
from megatron_tpu_torch.resilience.integrity import (  # noqa: F401
    MANIFEST, apply_retention, find_latest_valid, list_iter_checkpoints,
    verify_checkpoint, write_manifest)
from megatron_tpu_torch.resilience.retry import (  # noqa: F401
    RetryPolicy, policy_from, retry)
from megatron_tpu_torch.resilience.watchdog import StepWatchdog  # noqa: F401
