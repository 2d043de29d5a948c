"""Seedable multi-tenant traffic generator for the serving layer.

Open-loop load (arrivals follow the offered rate, not the service rate,
so queueing delay is *measured* instead of hidden), one pacing thread
per tenant, exponential inter-arrivals from a per-tenant
``numpy.random.default_rng(seed + index)`` — bit-identical schedules
run-to-run.  Mixed read/write: each arrival is a query or (with
``write_fraction``) an upsert into the live index, so the bench load is
the paper's concurrent query+churn regime, not a read-only cache test.

Reports per tenant and per SLO class: offered vs achieved qps, shed
count, and p50/p99 latency.  Shed requests (429 / ``RetryLater``) are
counted, not retried — the point is to see the admission controller
hold the bound.

Pacing waits are ``Event.wait(dt)`` on the generator's stop event
(finite, interruptible — LK006-clean), never bare sleeps.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

import numpy as np

__all__ = ["LoadGen", "TenantLoad", "percentile"]


def percentile(samples: list[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on empty input."""
    if not samples:
        return 0.0
    data = sorted(samples)
    rank = max(0, min(len(data) - 1, int(round(q / 100.0 * (len(data) - 1)))))
    return data[rank]


class TenantLoad:
    """One tenant's offered load: ``qps`` arrivals/s for ``duration_s``,
    each a query or (with probability ``write_fraction``) an upsert."""

    __slots__ = ("tenant", "qps", "write_fraction", "queries", "doc_words")

    def __init__(
        self,
        tenant: str,
        qps: float,
        write_fraction: float = 0.0,
        queries: list[str] | None = None,
        doc_words: int = 40,
    ):
        self.tenant = str(tenant)
        self.qps = max(0.01, float(qps))
        self.write_fraction = min(1.0, max(0.0, float(write_fraction)))
        self.queries = list(queries or ["latency tail", "index merge", "device slab"])
        self.doc_words = int(doc_words)


class LoadGen:
    """Drive a :class:`RagServingApp`-shaped target with concurrent
    tenants; ``run()`` blocks until the duration elapses and returns the
    per-tenant / per-class report."""

    def __init__(
        self,
        app: Any,
        tenants: list[TenantLoad],
        *,
        duration_s: float = 2.0,
        seed: int = 0,
        request_timeout_s: float = 30.0,
        submit: Callable[[str, str], Any] | None = None,
    ):
        self.app = app
        self.tenants = list(tenants)
        self.duration_s = float(duration_s)
        self.seed = int(seed)
        self.request_timeout_s = float(request_timeout_s)
        # submit(tenant, query) -> Future; defaults to the in-proc path
        self._submit = submit if submit is not None else app.submit_query
        self._stop = threading.Event()
        self._report_lock = threading.Lock()
        self._lat_ms: dict[str, list[float]] = {}
        self._shed: dict[str, int] = {}
        self._errors: dict[str, int] = {}
        self._sent: dict[str, int] = {}
        self._writes: dict[str, int] = {}

    # ---------------------------------------------------------------- drive

    def _record_latency(self, tenant: str, ms: float) -> None:
        with self._report_lock:
            self._lat_ms.setdefault(tenant, []).append(ms)

    def _bump(self, counter: dict[str, int], tenant: str) -> None:
        with self._report_lock:
            counter[tenant] = counter.get(tenant, 0) + 1

    def _request_done(self, tenant: str, t0: float, fut: Any) -> None:
        exc = fut.exception(timeout=0)
        if exc is None:
            self._record_latency(tenant, (time.monotonic() - t0) * 1e3)
            return
        if getattr(exc, "retry_after", None) is not None:
            self._bump(self._shed, tenant)
        else:
            self._bump(self._errors, tenant)

    def _fire(self, load: TenantLoad, rng: np.random.Generator, n: int) -> None:
        tenant = load.tenant
        if load.write_fraction > 0 and rng.random() < load.write_fraction:
            words = " ".join(
                rng.choice(["alpha", "beta", "gamma", "delta", "tpu", "index"])
                for _ in range(load.doc_words)
            )
            self._bump(self._writes, tenant)
            try:
                self.app.upsert(f"{tenant}-doc-{n}", words, tenant=tenant)
            except Exception:
                self._bump(self._errors, tenant)
            return
        query = load.queries[int(rng.integers(len(load.queries)))]
        self._bump(self._sent, tenant)
        t0 = time.monotonic()
        try:
            fut = self._submit(query, tenant)
        except Exception as e:  # RetryLater sheds at admission
            if getattr(e, "retry_after", None) is not None:
                self._bump(self._shed, tenant)
            else:
                self._bump(self._errors, tenant)
            return
        fut.add_done_callback(lambda f: self._request_done(tenant, t0, f))

    def _tenant_loop(self, idx: int, load: TenantLoad) -> None:
        rng = np.random.default_rng(self.seed + idx)
        deadline = time.monotonic() + self.duration_s
        n = 0
        while not self._stop.is_set():
            dt = float(rng.exponential(1.0 / load.qps))
            if self._stop.wait(timeout=dt):
                break
            if time.monotonic() >= deadline:
                break
            self._fire(load, rng, n)
            n += 1

    def run(self) -> dict[str, Any]:
        threads = [
            threading.Thread(
                target=self._tenant_loop,
                args=(i, load),
                daemon=True,
                name=f"loadgen_{load.tenant}",
            )
            for i, load in enumerate(self.tenants)
        ]
        t_start = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.duration_s + 10.0)
        # wait for in-flight responses to land before reporting
        settle_deadline = time.monotonic() + self.request_timeout_s
        while time.monotonic() < settle_deadline:
            with self._report_lock:
                landed = sum(len(v) for v in self._lat_ms.values())
                outstanding = (
                    sum(self._sent.values())
                    - landed
                    - sum(self._shed.values())
                    - sum(self._errors.values())
                )
            if outstanding <= 0:
                break
            self._stop.wait(timeout=0.05)
        wall_s = max(1e-6, time.monotonic() - t_start)
        return self.report(wall_s)

    def stop(self) -> None:
        self._stop.set()

    # --------------------------------------------------------------- report

    def report(self, wall_s: float) -> dict[str, Any]:
        classes: dict[str, dict[str, Any]] = {}
        per_tenant: dict[str, dict[str, Any]] = {}
        with self._report_lock:
            for load in self.tenants:
                tenant = load.tenant
                cls = self.app.admission.policy(tenant).tenant_class
                lat = self._lat_ms.get(tenant, [])
                row = {
                    "tenant_class": cls,
                    "offered_qps": load.qps,
                    "achieved_qps": len(lat) / wall_s,
                    "sent": self._sent.get(tenant, 0),
                    "completed": len(lat),
                    "shed": self._shed.get(tenant, 0),
                    "errors": self._errors.get(tenant, 0),
                    "writes": self._writes.get(tenant, 0),
                    "p50_ms": percentile(lat, 50),
                    "p99_ms": percentile(lat, 99),
                }
                per_tenant[tenant] = row
                agg = classes.setdefault(
                    cls,
                    {
                        "offered_qps": 0.0,
                        "achieved_qps": 0.0,
                        "sent": 0,
                        "completed": 0,
                        "shed": 0,
                        "errors": 0,
                        "writes": 0,
                        "_lat": [],
                    },
                )
                agg["offered_qps"] += row["offered_qps"]
                agg["achieved_qps"] += row["achieved_qps"]
                agg["sent"] += row["sent"]
                agg["completed"] += row["completed"]
                agg["shed"] += row["shed"]
                agg["errors"] += row["errors"]
                agg["writes"] += row["writes"]
                agg["_lat"].extend(lat)
        for cls, agg in classes.items():
            lat = agg.pop("_lat")
            agg["p50_ms"] = percentile(lat, 50)
            agg["p99_ms"] = percentile(lat, 99)
        return {
            "wall_s": wall_s,
            "seed": self.seed,
            "tenants": per_tenant,
            "classes": classes,
        }
