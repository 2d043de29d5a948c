"""``pw.io.plaintext`` — read files line-by-line into a ``data: str`` column
(reference ``python/pathway/io/plaintext``)."""

from __future__ import annotations

import os
from typing import Any

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import fs as _fs

__all__ = ["read"]


def read(path: str | os.PathLike, *, mode: str = "streaming", **kwargs: Any) -> Table:
    return _fs.read(path, format="plaintext", mode=mode, **kwargs)
