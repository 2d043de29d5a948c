"""``pw.io.s3`` — object-store (S3/MinIO-compatible) connector.

Reference: ``python/pathway/io/s3`` + the Rust S3 scanner with a rayon
download pool (``src/connectors/scanner/s3.rs``).  Re-designed for this
engine: a polling object scanner (list → diff by etag/size → parallel
fetch via a thread pool → deterministic key-ordered emission) feeding the
same line parsers the filesystem connector uses.

The client is boto3-compatible (``list_objects_v2`` / ``get_object``) and
injectable: pass ``AwsS3Settings(client=...)`` for any object store or a
test double; without an injected client, boto3 is imported lazily (where it is not
installed, a read raises ``MissingDependency``).

Counterpart of ``pathway_tpu/io/s3``: the same host code over the port's engine.
"""

from __future__ import annotations

import time as _time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

from pathway_tpu_torch.internals import schema as sch
from pathway_tpu_torch.internals.keys import ref_scalar
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._connector import RowSource, coerce_row, input_table
from pathway_tpu_torch.io._gated import MissingDependency

__all__ = ["AwsS3Settings", "read"]


class AwsS3Settings:
    """Connection settings (reference ``pw.io.s3.AwsS3Settings``)."""

    def __init__(
        self,
        *,
        bucket_name: str | None = None,
        access_key: str | None = None,
        secret_access_key: str | None = None,
        with_path_style: bool = False,
        region: str | None = None,
        endpoint: str | None = None,
        client: Any = None,
    ):
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.with_path_style = with_path_style
        self.region = region
        self.endpoint = endpoint
        self._client = client

    def create_client(self) -> Any:
        if self._client is not None:
            return self._client
        try:
            import boto3  # type: ignore[import-not-found]
        except ImportError as e:
            raise MissingDependency(
                "boto3 is not installed; pass AwsS3Settings(client=...) with "
                "a boto3-compatible client (list_objects_v2/get_object)"
            ) from e
        return boto3.client(
            "s3",
            aws_access_key_id=self.access_key,
            aws_secret_access_key=self.secret_access_key,
            region_name=self.region,
            endpoint_url=self.endpoint,
        )


class _S3Source(RowSource):
    """Scans a bucket prefix; streaming mode re-lists and emits new or
    changed objects (etag/size diff) — the reference's posix-like dir
    watching applied to an object store."""

    deterministic_replay = True

    # disjoint key-hash row share per worker: same key always lands on
    # the same rank, and that rank reads objects in key-sorted order, so
    # per-key arrival order survives the split
    partitioning = "key"
    order_preserving = True

    def __init__(
        self,
        settings: AwsS3Settings,
        prefix: str,
        schema: sch.SchemaMetaclass,
        parser_factory: Callable[[str], Callable[[str], dict | None]],
        *,
        mode: str = "streaming",
        with_metadata: bool = False,
        poll_interval: float = 1.0,
        downloader_threads: int = 8,
        tag: str = "s3",
        object_cache: Any = None,
    ):
        #: optional pathway_tpu_torch.persistence.CachedObjectStorage — serves
        #: unchanged object versions (by ETag) without re-downloading
        self.object_cache = object_cache
        self.settings = settings
        self.prefix = prefix
        self.schema = schema
        self.parser_factory = parser_factory
        self.mode = mode
        self.with_metadata = with_metadata
        self.poll_interval = poll_interval
        self.downloader_threads = downloader_threads
        self.tag = tag
        self._part = (0, 1)

    def partition(self, worker: int, n_workers: int) -> "_S3Source":
        """Every worker lists; each emits a disjoint key-hash row share
        (parallel partitioned reads, reference dataflow.rs:3291)."""
        import copy

        sub = copy.copy(self)
        sub._part = (worker, n_workers)
        return sub

    # ------------------------------------------------------------------
    def _list(self, client: Any) -> list[dict]:
        """All objects under the prefix, key-sorted (paginated)."""
        bucket = self.settings.bucket_name
        out: list[dict] = []
        token: str | None = None
        while True:
            kwargs: dict[str, Any] = {"Bucket": bucket, "Prefix": self.prefix}
            if token:
                kwargs["ContinuationToken"] = token
            resp = client.list_objects_v2(**kwargs)
            out.extend(resp.get("Contents", []))
            if not resp.get("IsTruncated"):
                break
            token = resp.get("NextContinuationToken")
        return sorted(out, key=lambda o: o["Key"])

    def _fetch(self, client: Any, key: str, etag: str = "") -> bytes:
        cache = self.object_cache
        uri = f"s3://{self.settings.bucket_name}/{key}"
        if cache is not None and etag:
            hit = cache.get(uri, etag)
            if hit is not None:
                return hit
        body = client.get_object(Bucket=self.settings.bucket_name, Key=key)["Body"]
        data = body.read() if hasattr(body, "read") else bytes(body)
        if cache is not None and etag:
            cache.put(uri, etag, data)
        return data

    def _emit_object(
        self, events: Any, key: str, data: bytes, meta: dict
    ) -> set:
        """Emit an object's rows (upsert adds); returns the emitted row
        KEYS so a later version can delete rows that vanished.  Only keys
        are retained — the downstream upsert input session holds the old
        values, so the reader never duplicates the dataset in memory."""
        pk = self.schema.primary_key_columns()
        parser = self.parser_factory(key)
        w, n = self._part
        seq = 0
        emitted: set = set()
        for raw in data.split(b"\n"):
            line = raw.decode(errors="replace")
            if not line.strip():
                continue
            try:
                values = parser(line + "\n")
            except Exception:
                values = None
            if not isinstance(values, dict):
                continue
            if self.with_metadata:
                values["_metadata"] = meta
            if pk:
                row_key = ref_scalar(*[values[c] for c in pk])
            else:
                seq += 1
                row_key = ref_scalar("__s3__", self.tag, key, seq)
            if n > 1 and int(row_key) % n != w:
                continue
            events.add(row_key, coerce_row(values, self.schema))
            emitted.add(row_key)
        return emitted

    def run(self, events: Any) -> None:
        client = self.settings.create_client()
        seen: dict[str, tuple] = {}  # object key -> (etag, size)
        emitted: dict[str, set] = {}  # object key -> emitted row keys
        while True:
            objects = self._list(client)
            fresh = [
                o
                for o in objects
                if seen.get(o["Key"]) != (o.get("ETag"), o.get("Size"))
            ]
            if fresh:
                # parallel fetch (reference rayon pool, scanner/s3.rs:9-10)
                # with deterministic key-ordered emission
                with ThreadPoolExecutor(self.downloader_threads) as pool:
                    blobs = list(
                        pool.map(
                            lambda o: self._fetch(
                                client, o["Key"], str(o.get("ETag", ""))
                            ),
                            fresh,
                        )
                    )
                for obj, data in zip(fresh, blobs):
                    meta = {
                        "path": f"s3://{self.settings.bucket_name}/{obj['Key']}",
                        "modified_at": str(obj.get("LastModified", "")),
                        "size": obj.get("Size"),
                    }
                    # an object VERSION replaces its predecessor via the
                    # upsert input session: re-added keys overwrite in
                    # place (no-op when unchanged); keys of rows that
                    # VANISHED in the new version are deleted by key
                    # (reference retracts modified objects)
                    new_keys = self._emit_object(events, obj["Key"], data, meta)
                    for row_key in emitted.get(obj["Key"], set()) - new_keys:
                        events.remove(row_key, ())
                    emitted[obj["Key"]] = new_keys
                    seen[obj["Key"]] = (obj.get("ETag"), obj.get("Size"))
                events.commit()
            if self.mode == "static":
                return
            if events.stopped:
                return
            _time.sleep(self.poll_interval)


def _parser_for(
    format: str, schema: sch.SchemaMetaclass, csv_settings: Any
) -> Callable[[str], Callable[[str], dict | None]]:
    if format in ("plaintext", "binary"):
        return lambda _key: (lambda line: {"data": line.rstrip("\n")})
    if format in ("json", "jsonlines"):
        import json

        def factory(_key: str):
            def parse(line: str):
                obj = json.loads(line)
                return obj if isinstance(obj, dict) else None

            return parse

        return factory
    if format == "csv":
        import csv as _csv
        import io as _io

        from pathway_tpu_torch.io.csv import CsvParserSettings

        settings = csv_settings or CsvParserSettings()

        def factory(_key: str):
            state: dict[str, Any] = {"header": None}

            def parse(line: str) -> dict | None:
                line = line.rstrip("\n").rstrip("\r")
                if not line:
                    return None
                row = next(_csv.reader(_io.StringIO(line), **settings.reader_kwargs()))
                if state["header"] is None:
                    state["header"] = row
                    return None
                return dict(zip(state["header"], row))

            return parse

        return factory
    raise ValueError(f"unsupported s3 format {format!r}")


def read(
    path: str,
    *,
    aws_s3_settings: AwsS3Settings | None = None,
    format: str = "jsonlines",
    schema: sch.SchemaMetaclass | None = None,
    mode: str = "streaming",
    csv_settings: Any = None,
    with_metadata: bool = False,
    downloader_threads_count: int = 8,
    name: str = "s3",
    object_cache: Any = None,
    **kwargs: Any,
) -> Table:
    """Read objects under ``path`` (``s3://bucket/prefix``, or a bare
    prefix with ``aws_s3_settings.bucket_name`` set)."""
    settings = aws_s3_settings or AwsS3Settings()
    prefix = path
    if path.startswith("s3://"):
        rest = path[len("s3://"):]
        bucket, _, prefix = rest.partition("/")
        settings.bucket_name = settings.bucket_name or bucket
    if schema is None:
        schema = sch.schema_from_types(data=str)
        if format in ("json", "jsonlines"):
            format = "plaintext"
    src = _S3Source(
        settings,
        prefix,
        schema,
        _parser_for(format, schema, csv_settings),
        mode=mode,
        with_metadata=with_metadata,
        downloader_threads=downloader_threads_count,
        tag=f"s3:{settings.bucket_name}/{prefix}",
        object_cache=object_cache,
    )
    # upsert session: object re-reads overwrite by key (reference
    # SessionType::Upsert for key-overwrite sources)
    return input_table(src, schema, name=name, upsert=True)
