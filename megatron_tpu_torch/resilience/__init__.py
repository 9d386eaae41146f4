"""Fault tolerance for long training runs (megatron_tpu/resilience): the
checkpoint manifests, verification, fall-back and retention
(`integrity`), retried storage I/O (`retry`) and the divergence guard
(`guard`). The hung-step watchdog and the fault-injection harness are
ported later (ROADMAP Queue 1 item 8)."""
from megatron_tpu_torch.resilience.guard import (  # noqa: F401
    DivergenceGuard, GuardAction, TrainingDivergedError)
from megatron_tpu_torch.resilience.integrity import (  # noqa: F401
    MANIFEST, apply_retention, find_latest_valid, list_iter_checkpoints,
    verify_checkpoint, write_manifest)
from megatron_tpu_torch.resilience.retry import (  # noqa: F401
    RetryPolicy, policy_from, retry)
