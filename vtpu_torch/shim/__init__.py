"""The cooperative tenant runtime: HBM quota, core-percent pacing and
the shared-region write path, for PyTorch tenants."""

from vtpu_torch.shim.runtime import (  # noqa: F401
    QuotaExceeded,
    ShimRuntime,
    stream_to_device,
)
