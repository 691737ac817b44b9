"""Continuous-batching serving over the tiered KV pool, PyTorch port.

The host-side modules (`request`, `scheduler`, `engine`, `block_pool`)
are copies of the reference's with imports pointed at the port; the
device side is `backend.LocalBackend` over `kv_pool.KVPoolState`.
"""

from repro_torch.serving.backend import (InferenceBackend, LocalBackend,  # noqa: F401
                                         make_backend)
from repro_torch.serving.engine import Engine  # noqa: F401
from repro_torch.serving.kv_pool import (KVPoolState, TieredKVPool,  # noqa: F401
                                         slot_kv_bytes, spill_lane_bytes)
from repro_torch.serving.metrics import (aggregate_metrics,  # noqa: F401
                                         request_metrics)
from repro_torch.serving.request import (Request,  # noqa: F401
                                         make_synthetic_requests)
from repro_torch.serving.scheduler import (CapacityBudget,  # noqa: F401
                                           FCFSScheduler, PrefillChunk,
                                           StepPlan)
from repro_torch.serving.telemetry import NullTelemetry  # noqa: F401
