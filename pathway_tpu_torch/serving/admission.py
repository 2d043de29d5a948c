"""Per-tenant admission control for the serving ingress.

The REST ingress used to buffer every request into an unbounded queue —
under overload that turns into unbounded memory growth and unbounded
tail latency, and a misbehaving tenant degrades everyone.  The
:class:`AdmissionController` makes the ingress *bounded*:

- a **token bucket** per tenant (``rate_per_s`` + ``burst``) caps the
  sustained request rate;
- a **bounded in-flight queue** per tenant (``queue_cap``) caps how many
  admitted requests a tenant may have inside the system at once;
- on either limit the request is **shed** with
  :class:`pathway_tpu_torch.io.http.RetryLater` — the ingress maps it to HTTP
  429 + ``Retry-After`` (the bucket's refill ETA), never a silent drop.

Tickets are released when the response resolves (or the request dies),
and every release notifies the shared :class:`WakeupHub` so a parked
:meth:`wait_admit` re-checks immediately — all waits on the admission
path are finite generation-waits, never unbounded blocks (lint LK006,
``scripts/check_locks.py``).

**Brownout mode**: the engine pushes its pressure level (ingest-buffer
occupancy, exchange credit backlog) via :meth:`set_pressure`.  Under
pressure the controller tightens each class's effective token rate by a
weight-graded power law — best-effort classes collapse first, the
interactive class degrades last — and computes ``Retry-After`` from the
*measured* drain rate (EWMA of ticket-release gaps) instead of the
configured rate, so clients back off proportionally to how slow the
system actually is.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from pathway_tpu_torch.engine.cluster import WakeupHub

__all__ = ["AdmissionController", "AdmissionTicket", "TenantPolicy"]

#: default weighted-fair share per SLO class (interactive requests get a
#: 4x device-time share over batch when both queues are backlogged)
DEFAULT_CLASS_WEIGHTS = {"interactive": 4.0, "batch": 1.0}


def _retry_later(retry_after: float, reason: str) -> Exception:
    # imported lazily: admission is loaded by /metrics scrapes and must
    # not pull the whole io stack in at import time
    from pathway_tpu_torch.io.http import RetryLater

    return RetryLater(retry_after=retry_after, reason=reason)


class TenantPolicy:
    """Admission + scheduling policy for one tenant.

    ``tenant_class`` names the SLO class ("interactive" / "batch");
    ``rate_per_s``/``burst`` parameterize the token bucket; ``queue_cap``
    bounds in-flight admitted requests; ``weight`` overrides the class's
    weighted-fair share in the SLO scheduler."""

    __slots__ = ("tenant_class", "rate_per_s", "burst", "queue_cap", "weight")

    def __init__(
        self,
        tenant_class: str = "interactive",
        rate_per_s: float = 50.0,
        burst: float | None = None,
        queue_cap: int = 8,
        weight: float | None = None,
    ):
        self.tenant_class = str(tenant_class)
        self.rate_per_s = max(0.001, float(rate_per_s))
        self.burst = float(burst) if burst is not None else max(1.0, self.rate_per_s / 4)
        self.queue_cap = max(1, int(queue_cap))
        self.weight = (
            float(weight)
            if weight is not None
            else DEFAULT_CLASS_WEIGHTS.get(self.tenant_class, 1.0)
        )


class _TokenBucket:
    """On-demand-refill token bucket (no timer thread)."""

    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.t_last = now

    def _refill(self, now: float) -> None:
        dt = now - self.t_last
        if dt > 0:
            self.tokens = min(self.burst, self.tokens + dt * self.rate)
            self.t_last = now

    def take(self, now: float) -> bool:
        self._refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def eta(self, now: float) -> float:
        """Seconds until one token is available (0 if available now)."""
        self._refill(now)
        if self.tokens >= 1.0:
            return 0.0
        return (1.0 - self.tokens) / self.rate


class AdmissionTicket:
    """One admitted request's slot in its tenant's bounded queue.

    ``release()`` is idempotent — the ingress calls it from a ``finally``
    and callbacks may race it."""

    __slots__ = ("_controller", "tenant", "tenant_class", "_released")

    def __init__(self, controller: "AdmissionController", tenant: str, tenant_class: str):
        self._controller = controller
        self.tenant = tenant
        self.tenant_class = tenant_class
        self._released = False

    def release(self) -> None:
        c, self._controller = self._controller, None
        if c is not None and not self._released:
            self._released = True
            c._release(self.tenant)


class AdmissionController:
    """Token-bucket + bounded-queue admission over named tenants."""

    def __init__(
        self,
        policies: dict[str, TenantPolicy] | None = None,
        *,
        default_policy: TenantPolicy | None = None,
        hub: WakeupHub | None = None,
        clock: Any = None,
    ):
        self._lock = threading.Lock()
        self.hub = hub if hub is not None else WakeupHub()
        self._clock = clock if clock is not None else time.monotonic
        self._policies: dict[str, TenantPolicy] = dict(policies or {})
        self._default = default_policy or TenantPolicy()
        self._buckets: dict[str, _TokenBucket] = {}
        self._inflight: dict[str, int] = {}
        self.admitted_total: dict[str, int] = {}
        self.shed_total: dict[str, int] = {}
        #: brownout inputs: pressure level in [0, 1] per source (e.g.
        #: "engine"); the effective level is the max across sources
        self._pressure: dict[str, float] = {}
        #: sheds attributable to brownout (also counted in shed_total)
        self.brownout_shed_total: dict[str, int] = {}
        #: EWMA of ticket-release gaps (seconds) — the measured service
        #: time brownout Retry-After is derived from
        self._drain_ewma_s: float | None = None
        self._last_release_t: float | None = None
        from pathway_tpu_torch import serving as _serving

        _serving._register_admission(self)

    # ------------------------------------------------------------- brownout

    def set_pressure(self, source: str, level: float) -> None:
        """Record a pressure signal in [0, 1]; ``level <= 0`` clears the
        source.  Notifies the hub so parked ``wait_admit`` calls re-check
        (pressure easing may admit them; pressure rising re-derives their
        shed verdict)."""
        level = min(1.0, float(level))
        with self._lock:
            if level <= 0.0:
                if self._pressure.pop(source, None) is None:
                    return
            else:
                self._pressure[source] = level
            # re-arm every bucket: effective rates change with pressure
            self._buckets.clear()
        self.hub.notify()

    def pressure_level(self) -> float:
        with self._lock:
            return max(self._pressure.values(), default=0.0)

    def _brownout_mult_locked(self, pol: TenantPolicy) -> float:
        """Rate multiplier in [0, 1] for this policy under the current
        pressure.  Weight-graded power law: with headroom ``h = 1 -
        level``, a class keeps ``h ** (w_max / w)`` of its rate — the
        heaviest class degrades linearly while lighter (best-effort)
        classes collapse polynomially faster, freeing the drain for
        interactive traffic."""
        if not self._pressure:
            return 1.0
        level = max(self._pressure.values())
        if level >= 1.0:
            return 0.0
        w_max = max(
            [p.weight for p in self._policies.values()]
            + [self._default.weight]
            + list(DEFAULT_CLASS_WEIGHTS.values())
        )
        return (1.0 - level) ** (w_max / max(pol.weight, 0.001))

    def _brownout_retry_after_locked(self) -> float:
        """Retry-After from the measured drain rate: roughly the time to
        drain everything currently in flight, clamped to [0.05, 30]."""
        ewma = self._drain_ewma_s
        if ewma is None:
            ewma = 0.1  # no releases observed yet: conservative default
        backlog = sum(self._inflight.values()) + 1
        return min(max(backlog * ewma, 0.05), 30.0)

    # ------------------------------------------------------------- policies

    def set_policy(self, tenant: str, policy: TenantPolicy) -> None:
        with self._lock:
            self._policies[tenant] = policy
            self._buckets.pop(tenant, None)  # re-arm with the new rate

    def policy(self, tenant: str) -> TenantPolicy:
        with self._lock:
            return self._policies.get(tenant, self._default)

    # ------------------------------------------------------------ admission

    def _admit_locked(
        self, tenant: str, now: float
    ) -> tuple[AdmissionTicket | None, float, str]:
        """(ticket, retry_after_s, reason); ticket None means shed."""
        pol = self._policies.get(tenant, self._default)
        mult = self._brownout_mult_locked(pol)
        if mult < 0.05:
            # this class's share has collapsed: shed outright, with a
            # Retry-After derived from the measured drain rate
            return None, self._brownout_retry_after_locked(), "brownout"
        bucket = self._buckets.get(tenant)
        if bucket is None:
            bucket = self._buckets[tenant] = _TokenBucket(
                pol.rate_per_s * mult, pol.burst, now
            )
        inflight = self._inflight.get(tenant, 0)
        if inflight >= pol.queue_cap:
            # ETA heuristic: one service turn at the tenant's rate
            return None, max(1.0 / pol.rate_per_s, 0.05), "tenant queue full"
        if not bucket.take(now):
            if mult < 1.0:
                # browned-out rate limit: back off at the DRAIN rate, not
                # the configured token rate the class no longer gets
                return (
                    None,
                    max(bucket.eta(now), self._brownout_retry_after_locked()),
                    "brownout rate limited",
                )
            return None, max(bucket.eta(now), 0.01), "rate limited"
        self._inflight[tenant] = inflight + 1
        cls = pol.tenant_class
        self.admitted_total[cls] = self.admitted_total.get(cls, 0) + 1
        return AdmissionTicket(self, tenant, cls), 0.0, "admitted"

    def admit(self, tenant: str, route: str | None = None) -> AdmissionTicket:
        """Admit one request or raise ``RetryLater`` (counted as shed)."""
        now = self._clock()
        with self._lock:
            ticket, retry_after, reason = self._admit_locked(tenant, now)
            if ticket is None:
                cls = self._policies.get(tenant, self._default).tenant_class
                self.shed_total[cls] = self.shed_total.get(cls, 0) + 1
                if reason.startswith("brownout"):
                    self.brownout_shed_total[cls] = (
                        self.brownout_shed_total.get(cls, 0) + 1
                    )
        if ticket is None:
            suffix = f" ({route})" if route else ""
            raise _retry_later(retry_after, f"{reason}: tenant {tenant!r}{suffix}")
        return ticket

    def try_admit(self, tenant: str, route: str | None = None) -> AdmissionTicket | None:
        """Non-raising probe; a refusal is NOT counted as shed (callers
        like :meth:`wait_admit` retry instead of failing the request)."""
        now = self._clock()
        with self._lock:
            ticket, _, _ = self._admit_locked(tenant, now)
        return ticket

    def wait_admit(
        self, tenant: str, route: str | None = None, timeout: float = 5.0
    ) -> AdmissionTicket:
        """Generation-wait until admitted or ``timeout`` (then sheds).

        Every park is a finite ``hub.wait`` slice: a ticket release (or
        token refill elsewhere) notifies the hub and the admit re-checks
        immediately — no polling sleep, no unbounded block."""
        deadline = self._clock() + max(0.0, timeout)
        while True:
            seen = self.hub.seq()
            ticket = self.try_admit(tenant, route)
            if ticket is not None:
                return ticket
            remaining = deadline - self._clock()
            if remaining <= 0:
                return self.admit(tenant, route)  # counts the shed, raises
            self.hub.wait(seen, min(remaining, 0.05))

    def _release(self, tenant: str) -> None:
        now = self._clock()
        with self._lock:
            n = self._inflight.get(tenant, 0)
            if n > 1:
                self._inflight[tenant] = n - 1
            else:
                self._inflight.pop(tenant, None)
            # drain-rate EWMA over release gaps (capped: an idle stretch
            # is not a slow drain) — feeds brownout Retry-After
            last = self._last_release_t
            self._last_release_t = now
            if last is not None:
                gap = min(max(now - last, 0.0), 5.0)
                ewma = self._drain_ewma_s
                self._drain_ewma_s = (
                    gap if ewma is None else 0.8 * ewma + 0.2 * gap
                )
        self.hub.notify()

    # -------------------------------------------------------------- metrics

    def stats(self) -> dict[str, Any]:
        with self._lock:
            inflight_by_class: dict[str, int] = {}
            for tenant, n in self._inflight.items():
                cls = self._policies.get(tenant, self._default).tenant_class
                inflight_by_class[cls] = inflight_by_class.get(cls, 0) + n
            return {
                "admitted_total": dict(self.admitted_total),
                "shed_total": dict(self.shed_total),
                "inflight": inflight_by_class,
                "tenants": len(self._policies),
                "pressure": {
                    "level": max(self._pressure.values(), default=0.0),
                    "sources": dict(self._pressure),
                    "brownout_shed_total": dict(self.brownout_shed_total),
                    "drain_s": self._drain_ewma_s,
                },
            }
