"""Serving telemetry hooks.

Only the disabled stand-in, `NullTelemetry`, is ported so far: the
engine calls these hooks on its hot path. The reference's `Telemetry`
hub (span tracer, tier-traffic ledger, Prometheus export) is not ported
yet (ROADMAP Queue 1).
"""

from __future__ import annotations


class NullTelemetry:
    """Disabled-telemetry stand-in: every hook is an empty method, so
    the engine's instrumented hot path costs a handful of no-op calls
    per step (<2% throughput — the contract the bench asserts).
    `Engine(telemetry=None)` installs this."""

    enabled = False
    ledger = None

    def bind(self, **kw):
        pass

    def step_begin(self, step):
        pass

    def step_end(self, gauges=None):
        pass

    def phase_begin(self, name):
        pass

    def phase_end(self, count=None, **args):
        pass

    def request_submitted(self, req):
        pass

    def request_admitted(self, req, slot):
        pass

    def request_first_token(self, req):
        pass

    def token(self, req):
        pass

    def request_evicted(self, req, slot, lane, ctx, offload):
        pass

    def request_restored(self, req, lane, slot, ctx):
        pass

    def request_finished(self, req):
        pass

    def decision(self, code, rid=None, **args):
        pass

    def snapshot(self):
        return {}

    def close(self):
        pass
