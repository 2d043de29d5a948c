"""``pw.io.s3_csv`` — S3 CSV reader (reference ``python/pathway/io/s3_csv``):
``pw.io.s3.read`` preset to the CSV format.

Counterpart of ``pathway_tpu/io/s3_csv``: the same host code over the port's engine.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import s3 as _s3
from pathway_tpu_torch.io.s3 import AwsS3Settings

__all__ = ["read", "AwsS3Settings"]


def read(
    path: str,
    *,
    aws_s3_settings: AwsS3Settings | None = None,
    schema: Any = None,
    csv_settings: Any = None,
    mode: str = "streaming",
    **kwargs: Any,
) -> Table:
    return _s3.read(
        path,
        aws_s3_settings=aws_s3_settings,
        format="csv",
        schema=schema,
        csv_settings=csv_settings,
        mode=mode,
        name=kwargs.pop("name", "s3_csv"),
        **kwargs,
    )
