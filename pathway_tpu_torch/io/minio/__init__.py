"""``pw.io.minio`` — MinIO connector (reference ``python/pathway/io/minio``).

MinIO speaks the S3 protocol: settings wrap an endpoint + path-style
addressing and delegate to :mod:`pathway_tpu_torch.io.s3`.

Counterpart of ``pathway_tpu/io/minio``: the same host code over the port's engine.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import s3 as _s3

__all__ = ["MinIOSettings", "read"]


class MinIOSettings:
    """reference ``pw.io.minio.MinIOSettings``."""

    def __init__(
        self,
        endpoint: str | None = None,
        bucket_name: str | None = None,
        access_key: str | None = None,
        secret_access_key: str | None = None,
        *,
        with_path_style: bool = True,
        region: str | None = None,
        client: Any = None,
    ):
        self.endpoint = endpoint
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.with_path_style = with_path_style
        self.region = region
        self._client = client

    def create_aws_settings(self) -> _s3.AwsS3Settings:
        return _s3.AwsS3Settings(
            bucket_name=self.bucket_name,
            access_key=self.access_key,
            secret_access_key=self.secret_access_key,
            with_path_style=self.with_path_style,
            region=self.region,
            endpoint=self.endpoint,
            client=self._client,
        )


def read(
    path: str,
    minio_settings: MinIOSettings,
    *,
    format: str = "jsonlines",
    **kwargs: Any,
) -> Table:
    return _s3.read(
        path,
        aws_s3_settings=minio_settings.create_aws_settings(),
        format=format,
        name=kwargs.pop("name", "minio"),
        **kwargs,
    )
