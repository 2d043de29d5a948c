"""License keys and entitlements (reference ``src/engine/license.rs``:
Ed25519-signed keys / offline license files, entitlement checks, free-tier
worker cap; ``license.rs:23-60``).

Same capability, fully offline: a license key is
``base64(payload_json) + "." + base64(ed25519_signature)`` verified
against the distribution public key (override with
``PATHWAY_LICENSE_PUBLIC_KEY`` — PEM — for self-issued deployments; the
reference instead phones ``license.pathway.com``, which this build never
does).  The payload carries the tier and entitlement list::

    {"tier": "scale", "entitlements": ["scale", "xpack-sharepoint"]}

No key (or the demo key) = free tier: everything works, workers cap at
:data:`MAX_WORKERS_FREE` like the reference
(``src/engine/dataflow/config.rs:7-11``).
"""

from __future__ import annotations

import base64
import binascii
import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any

_logger = logging.getLogger("pathway_tpu_torch.license")

__all__ = [
    "License",
    "LicenseError",
    "MAX_WORKERS_FREE",
    "check_entitlements",
    "generate_license_key",
    "get_license",
]

#: free-tier worker cap (reference MAX_WORKERS, config.rs:7-11)
MAX_WORKERS_FREE = 8

#: demo keys accepted verbatim (reference KEY_FOR_TELEMETRY-style demos)
_DEMO_KEYS = {"demo-license-key-with-telemetry", "demo"}

#: distribution public key (Ed25519, PEM).  Deployments that issue their
#: own licenses override via PATHWAY_LICENSE_PUBLIC_KEY.
_DEFAULT_PUBLIC_KEY_PEM = """-----BEGIN PUBLIC KEY-----
MCowBQYDK2VwAyEAvdMDRRaYVc7J0P5mRWMhKyUv2zvBTH4ZO0uFVUhmZi0=
-----END PUBLIC KEY-----"""


class LicenseError(ValueError):
    """Malformed, forged, or insufficient license."""


@dataclass(frozen=True)
class License:
    tier: str = "free"
    entitlements: tuple[str, ...] = ()
    telemetry: bool = False
    payload: dict = field(default_factory=dict)

    @property
    def scale_unlimited(self) -> bool:
        return "scale" in self.entitlements or "scale-unlimited" in self.entitlements

    def worker_cap(self) -> int | None:
        """None = unlimited."""
        return None if self.scale_unlimited else MAX_WORKERS_FREE

    def check_entitlements(self, *required: str) -> None:
        missing = [e for e in required if e not in self.entitlements]
        if missing:
            raise LicenseError(
                f"license (tier {self.tier!r}) is missing entitlement(s) "
                f"{missing}; set a key with pw.set_license_key(...)"
            )


def _public_key():
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PublicKey,
    )
    from cryptography.hazmat.primitives.serialization import load_pem_public_key

    pem = os.environ.get("PATHWAY_LICENSE_PUBLIC_KEY", _DEFAULT_PUBLIC_KEY_PEM)
    try:
        pk = load_pem_public_key(pem.encode())
    except Exception as e:  # malformed PEM -> the documented error type
        raise LicenseError(f"invalid license public key: {e}") from None
    if not isinstance(pk, Ed25519PublicKey):
        raise LicenseError("license public key must be Ed25519")
    return pk


def parse_license(key: str | None) -> License:
    """Validate a key and return the License (free tier for no key)."""
    if not key:
        return License()
    key = key.strip()
    if key.lower() in _DEMO_KEYS:
        # demo keys unlock licensed xpacks for offline evaluation (but not
        # the worker cap), like the reference's telemetry demo keys
        return License(
            tier="demo", telemetry=True, entitlements=("xpack-sharepoint",)
        )
    try:
        payload_b64, sig_b64 = key.split(".", 1)
        payload_bytes = base64.urlsafe_b64decode(payload_b64 + "===")
        signature = base64.urlsafe_b64decode(sig_b64 + "===")
    except (ValueError, binascii.Error) as e:
        raise LicenseError(f"malformed license key: {e}") from None
    from cryptography.exceptions import InvalidSignature

    try:
        _public_key().verify(signature, payload_bytes)
    except InvalidSignature:
        raise LicenseError("license key signature is invalid") from None
    try:
        payload = json.loads(payload_bytes)
    except ValueError as e:
        raise LicenseError(f"license payload is not JSON: {e}") from None
    return License(
        tier=str(payload.get("tier", "licensed")),
        entitlements=tuple(payload.get("entitlements", ())),
        telemetry=bool(payload.get("telemetry", False)),
        payload=payload,
    )


def generate_license_key(payload: dict, private_key_pem: bytes | str) -> str:
    """Issue a key for a self-managed deployment (pair with
    ``PATHWAY_LICENSE_PUBLIC_KEY``); also the test-suite hook."""
    from cryptography.hazmat.primitives.serialization import (
        load_pem_private_key,
    )

    if isinstance(private_key_pem, str):
        private_key_pem = private_key_pem.encode()
    sk = load_pem_private_key(private_key_pem, password=None)
    payload_bytes = json.dumps(payload, sort_keys=True).encode()
    sig = sk.sign(payload_bytes)
    return (
        base64.urlsafe_b64encode(payload_bytes).decode().rstrip("=")
        + "."
        + base64.urlsafe_b64encode(sig).decode().rstrip("=")
    )


_cache: dict[tuple[str, str], License] = {}


def get_license() -> License:
    """The validated license for the current config key (cached per
    (key, public key), so rotating PATHWAY_LICENSE_PUBLIC_KEY
    re-verifies)."""
    from pathway_tpu_torch.internals.config import pathway_config

    key = pathway_config.license_key or ""
    pub = os.environ.get("PATHWAY_LICENSE_PUBLIC_KEY", "")
    lic = _cache.get((key, pub))
    if lic is None:
        lic = parse_license(key)
        _cache[(key, pub)] = lic
    return lic


def check_entitlements(*required: str) -> None:
    """Entitlement gate for licensed features (reference
    ``license.rs`` entitlement checks; wired into e.g. the SharePoint
    xpack connector)."""
    get_license().check_entitlements(*required)


def effective_workers(requested: int) -> int:
    """Clamp a requested worker count to the license cap, warning like the
    reference free tier does."""
    cap = get_license().worker_cap()
    if cap is not None and requested > cap:
        _logger.warning(
            "free tier caps workers at %d (requested %d); set a license "
            "key with the 'scale' entitlement to lift the cap",
            cap,
            requested,
        )
        return cap
    return requested
