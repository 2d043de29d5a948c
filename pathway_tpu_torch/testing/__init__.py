"""Test-support utilities shipped with the package.

``pathway_tpu_torch.testing.chaos`` is the deterministic fault-injection
harness used by the crash-recovery drills (and usable against user
pipelines: inject connector faults, torn persistence writes, and
crash-between-snapshot-and-commit scenarios under a fixed seed).
"""

from pathway_tpu_torch.testing.chaos import ChaosError, chaos, flaky_once

__all__ = ["ChaosError", "chaos", "flaky_once"]
