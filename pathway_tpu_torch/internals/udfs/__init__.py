"""UDF system: ``@pw.udf`` with sync/async executors, retries, caching.

Capability parity with reference ``python/pathway/internals/udfs/``
(executors sync/async/fully-async, caches, retries — ``executors.py:91-219``,
``caches.py``, ``retries.py``).  Async UDFs are micro-batched per epoch by
the engine's :class:`AsyncMapNode` — the whole epoch's rows are dispatched
concurrently on one event loop (the TPU-batched analogue of the reference's
``map_named_async`` FuturesUnordered block).
"""

from __future__ import annotations

import asyncio
import functools
import hashlib
import inspect
import os
import pickle
import random
import threading
import time
from typing import Any, Awaitable, Callable

from pathway_tpu_torch.internals import api
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    ApplyExpression,
    AsyncApplyExpression,
    ColumnExpression,
)

__all__ = [
    "udf",
    "UDF",
    "BatchUDF",
    "batch_udf",
    "async_executor",
    "sync_executor",
    "auto_executor",
    "fully_async_executor",
    "AsyncRetryStrategy",
    "ExponentialBackoffRetryStrategy",
    "FixedDelayRetryStrategy",
    "NoRetryStrategy",
    "CacheStrategy",
    "DefaultCache",
    "InMemoryCache",
    "DiskCache",
    "run_async_batch",
    "coerce_async",
    "with_capacity",
    "with_retry_strategy",
    "with_cache_strategy",
    "with_timeout",
]


# ---------------------------------------------------------------------------
# Retry strategies (reference internals/udfs/retries.py)


class AsyncRetryStrategy:
    async def invoke(self, fun: Callable[..., Awaitable[Any]], *args: Any, **kwargs: Any) -> Any:
        raise NotImplementedError


class NoRetryStrategy(AsyncRetryStrategy):
    async def invoke(self, fun, *args, **kwargs):
        return await fun(*args, **kwargs)


class FixedDelayRetryStrategy(AsyncRetryStrategy):
    def __init__(self, max_retries: int = 3, delay_ms: int = 1000):
        self._max_retries = max_retries
        self._delay = delay_ms / 1000

    def _next_delay(self, attempt: int) -> float:
        return self._delay

    def next_delay(self, attempt: int) -> float:
        """Delay in seconds before retry number ``attempt`` (0-based).
        Public: the connector supervisor reuses the same policy objects
        for its restart schedule."""
        return self._next_delay(attempt)

    async def invoke(self, fun, *args, **kwargs):
        last: Exception | None = None
        for attempt in range(self._max_retries + 1):
            try:
                return await fun(*args, **kwargs)
            except Exception as e:  # noqa: BLE001
                last = e
                if attempt < self._max_retries:
                    await asyncio.sleep(self._next_delay(attempt))
        assert last is not None
        raise last


class ExponentialBackoffRetryStrategy(FixedDelayRetryStrategy):
    """Exponential backoff with jitter.

    ``max_delay_ms`` caps every delay (with it unset, a long retry chain
    sleeps unboundedly: delay * factor**n).  ``full_jitter=True`` draws
    uniformly from ``[0, capped_base]`` (AWS full-jitter — decorrelates
    retry storms better than additive jitter); the default keeps the
    additive ``base + U(0, jitter_ms)`` behaviour.  ``seed`` makes the
    schedule deterministic (chaos tests, reproducible drills)."""

    def __init__(
        self,
        max_retries: int = 3,
        initial_delay: int = 1000,
        backoff_factor: float = 2.0,
        jitter_ms: int = 300,
        max_delay_ms: int | None = None,
        full_jitter: bool = False,
        seed: int | None = None,
    ):
        super().__init__(max_retries, initial_delay)
        self._backoff = backoff_factor
        self._jitter = jitter_ms / 1000
        self._max_delay = max_delay_ms / 1000 if max_delay_ms is not None else None
        self._full_jitter = full_jitter
        self._rng = random.Random(seed) if seed is not None else random

    def _next_delay(self, attempt: int) -> float:
        base = self._delay * (self._backoff**attempt)
        if self._max_delay is not None:
            base = min(base, self._max_delay)
        if self._full_jitter:
            return self._rng.uniform(0.0, base)
        delay = base + self._rng.random() * self._jitter
        if self._max_delay is not None:
            delay = min(delay, self._max_delay)
        return delay


# ---------------------------------------------------------------------------
# Cache strategies (reference internals/udfs/caches.py)


class CacheStrategy:
    def make_wrapper(self, fun: Callable[..., Awaitable[Any]]) -> Callable[..., Awaitable[Any]]:
        raise NotImplementedError


class InMemoryCache(CacheStrategy):
    def __init__(self) -> None:
        self._store: dict[bytes, Any] = {}
        self._lock = threading.Lock()

    def make_wrapper(self, fun):
        @functools.wraps(fun)
        async def wrapper(*args, **kwargs):
            key = _cache_key(fun, args, kwargs)
            with self._lock:
                if key in self._store:
                    return self._store[key]
            result = await fun(*args, **kwargs)
            with self._lock:
                self._store[key] = result
            return result

        return wrapper


class DiskCache(CacheStrategy):
    """Persists results under ``PATHWAY_PERSISTENT_STORAGE`` (reference
    UdfCaching persistence mode)."""

    def __init__(self, directory: str | None = None):
        self._dir = directory

    def _path(self, key: bytes) -> str:
        base = self._dir or os.environ.get(
            "PATHWAY_PERSISTENT_STORAGE", "/tmp/pathway_tpu_cache"
        )
        os.makedirs(base, exist_ok=True)
        return os.path.join(base, key.hex())

    def make_wrapper(self, fun):
        @functools.wraps(fun)
        async def wrapper(*args, **kwargs):
            key = _cache_key(fun, args, kwargs)
            path = self._path(key)
            if os.path.exists(path):
                try:
                    with open(path, "rb") as f:
                        return pickle.load(f)
                except Exception:
                    # torn/corrupt entry (crash mid-write before this
                    # cache used tmp+replace, disk corruption): a cache
                    # miss, not a permanent failure — drop it and recompute
                    try:
                        os.remove(path)
                    except OSError:
                        pass
            result = await fun(*args, **kwargs)
            # tmp + atomic rename: a crash mid-write must never leave a
            # half-written pickle under the final name (unique tmp per
            # writer — concurrent epochs may compute the same key)
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            try:
                with open(tmp, "wb") as f:
                    pickle.dump(result, f)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    try:
                        os.remove(tmp)
                    except OSError:
                        pass
            return result

        return wrapper


DefaultCache = InMemoryCache


def _cache_key(fun: Callable, args: tuple, kwargs: dict) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(getattr(fun, "__qualname__", repr(fun)).encode())
    try:
        h.update(pickle.dumps((args, sorted(kwargs.items()))))
    except Exception:
        h.update(repr((args, kwargs)).encode())
    return h.digest()


# ---------------------------------------------------------------------------
# Composable async wrappers (reference internals/udfs/executors.py:286-326)


def coerce_async(fun: Callable) -> Callable[..., Awaitable[Any]]:
    if inspect.iscoroutinefunction(fun):
        return fun

    @functools.wraps(fun)
    async def wrapper(*args, **kwargs):
        return fun(*args, **kwargs)

    return wrapper


def with_capacity(fun: Callable[..., Awaitable[Any]], capacity: int) -> Callable[..., Awaitable[Any]]:
    semaphores: dict[int, asyncio.Semaphore] = {}

    @functools.wraps(fun)
    async def wrapper(*args, **kwargs):
        loop_id = id(asyncio.get_running_loop())
        if loop_id not in semaphores:
            semaphores[loop_id] = asyncio.Semaphore(capacity)
        async with semaphores[loop_id]:
            return await fun(*args, **kwargs)

    return wrapper


def with_timeout(fun: Callable[..., Awaitable[Any]], timeout: float) -> Callable[..., Awaitable[Any]]:
    @functools.wraps(fun)
    async def wrapper(*args, **kwargs):
        return await asyncio.wait_for(fun(*args, **kwargs), timeout)

    return wrapper


def with_retry_strategy(
    fun: Callable[..., Awaitable[Any]], retry_strategy: AsyncRetryStrategy
) -> Callable[..., Awaitable[Any]]:
    @functools.wraps(fun)
    async def wrapper(*args, **kwargs):
        return await retry_strategy.invoke(fun, *args, **kwargs)

    return wrapper


def with_cache_strategy(
    fun: Callable[..., Awaitable[Any]], cache_strategy: CacheStrategy
) -> Callable[..., Awaitable[Any]]:
    return cache_strategy.make_wrapper(fun)


# ---------------------------------------------------------------------------
# Executors


class Executor:
    def wrap(self, fun: Callable) -> Callable:
        return fun

    is_async = False


class SyncExecutor(Executor):
    pass


class AsyncExecutor(Executor):
    is_async = True

    def __init__(
        self,
        *,
        capacity: int | None = None,
        timeout: float | None = None,
        retry_strategy: AsyncRetryStrategy | None = None,
        cache_strategy: CacheStrategy | None = None,
    ):
        self.capacity = capacity
        self.timeout = timeout
        self.retry_strategy = retry_strategy
        self.cache_strategy = cache_strategy

    def wrap(self, fun: Callable) -> Callable:
        f = coerce_async(fun)
        if self.retry_strategy is not None:
            f = with_retry_strategy(f, self.retry_strategy)
        if self.timeout is not None:
            f = with_timeout(f, self.timeout)
        if self.cache_strategy is not None:
            f = with_cache_strategy(f, self.cache_strategy)
        if self.capacity is not None:
            f = with_capacity(f, self.capacity)
        return f


class FullyAsyncExecutor(AsyncExecutor):
    """Results arrive at later epochs (reference fully_async_executor).
    Currently mapped to the blocking batched executor; the decoupled
    AsyncTransformer path covers the fully-async capability."""


def sync_executor() -> Executor:
    return SyncExecutor()


def async_executor(
    *,
    capacity: int | None = None,
    timeout: float | None = None,
    retry_strategy: AsyncRetryStrategy | None = None,
    cache_strategy: CacheStrategy | None = None,
) -> Executor:
    return AsyncExecutor(
        capacity=capacity,
        timeout=timeout,
        retry_strategy=retry_strategy,
        cache_strategy=cache_strategy,
    )


def fully_async_executor(**kwargs: Any) -> Executor:
    return FullyAsyncExecutor(**kwargs)


def auto_executor() -> Executor:
    return Executor()


# ---------------------------------------------------------------------------
# The @pw.udf decorator


class UDF:
    """Base class / wrapper for user-defined functions applied to columns
    (reference ``internals/udfs/__init__.py`` ``UDF``)."""

    def __init__(
        self,
        *,
        return_type: Any = None,
        deterministic: bool = False,
        propagate_none: bool = False,
        executor: Executor | None = None,
        cache_strategy: CacheStrategy | None = None,
        max_batch_size: int | None = None,
    ):
        self.return_type = return_type
        self.deterministic = deterministic
        self.propagate_none = propagate_none
        self.executor = executor
        self.cache_strategy = cache_strategy
        self.max_batch_size = max_batch_size
        self._wrapped: Callable | None = None

    # subclasses override ONE of these
    def __wrapped__(self, *args: Any, **kwargs: Any) -> Any:
        raise NotImplementedError

    #: subclasses may instead define ``__batch__(self, xs: list, ...) ->
    #: list`` to run ONCE per epoch with per-argument lists (the jitted
    #: TPU executor contract; see ``BatchApplyExpression``)
    __batch__: Callable | None = None

    def _resolve_fun(self) -> tuple[Callable, bool]:
        fun = self._wrapped if self._wrapped is not None else self.__wrapped__
        executor = self.executor
        is_async = inspect.iscoroutinefunction(fun) or (
            executor is not None and executor.is_async
        )
        if executor is None and is_async:
            executor = AsyncExecutor(cache_strategy=self.cache_strategy)
        if executor is None:
            executor = SyncExecutor()
        if isinstance(executor, AsyncExecutor):
            if self.cache_strategy is not None and executor.cache_strategy is None:
                executor.cache_strategy = self.cache_strategy
            return executor.wrap(fun), True
        if self.cache_strategy is not None:
            f = coerce_async(fun)
            f = with_cache_strategy(f, self.cache_strategy)
            return f, True
        return fun, False

    def _return_dtype(self) -> Any:
        if self.return_type is not None:
            return self.return_type
        fun = self._wrapped if self._wrapped is not None else self.__wrapped__
        try:
            import typing

            return typing.get_type_hints(fun).get("return", dt.ANY)
        except Exception:
            return dt.ANY

    def __call__(self, *args: Any, **kwargs: Any) -> ColumnExpression:
        from pathway_tpu_torch.internals.expression import BatchApplyExpression

        batch = getattr(self, "__batch__", None)
        if batch is not None:
            ret = self._return_dtype()
            fun = batch if not isinstance(batch, staticmethod) else batch.__func__
            if self.max_batch_size is not None:
                fun = _chunk_batches(fun, self.max_batch_size)
            return BatchApplyExpression(
                fun, ret, args, kwargs, propagate_none=self.propagate_none,
                deterministic=self.deterministic,
            )
        fun, is_async = self._resolve_fun()
        ret = self._return_dtype()
        if is_async:
            return AsyncApplyExpression(
                fun, ret, args, kwargs, propagate_none=self.propagate_none,
                deterministic=self.deterministic,
            )
        return ApplyExpression(
            fun, ret, args, kwargs, propagate_none=self.propagate_none,
            deterministic=self.deterministic,
        )


def _chunk_batches(fun: Callable, max_batch: int) -> Callable:
    """Split oversize epoch batches into chunks of ``max_batch`` rows."""

    @functools.wraps(fun)
    def wrapper(*arg_lists: list, **kw_lists: list) -> list:
        n = len(arg_lists[0]) if arg_lists else len(next(iter(kw_lists.values())))
        if n <= max_batch:
            return fun(*arg_lists, **kw_lists)
        out: list = []
        for s in range(0, n, max_batch):
            sl = slice(s, s + max_batch)
            out.extend(
                fun(
                    *[a[sl] for a in arg_lists],
                    **{k: v[sl] for k, v in kw_lists.items()},
                )
            )
        return out

    return wrapper


class BatchUDF(UDF):
    """UDF whose function takes per-argument LISTS covering the whole epoch
    (one jitted TPU call per epoch)."""

    def __init__(self, fun: Callable, **kwargs: Any):
        super().__init__(**kwargs)
        self.__batch__ = fun
        functools.update_wrapper(self, fun)


def batch_udf(
    fun: Callable | None = None,
    /,
    *,
    return_type: Any = None,
    max_batch_size: int | None = None,
    **kwargs: Any,
) -> Any:
    """Decorator: epoch-batched UDF (``fun(list, ...) -> list``)."""

    def wrap(f: Callable) -> BatchUDF:
        return BatchUDF(
            f, return_type=return_type, max_batch_size=max_batch_size, **kwargs
        )

    return wrap(fun) if fun is not None else wrap


class _FunctionUDF(UDF):
    def __init__(self, fun: Callable, **kwargs: Any):
        super().__init__(**kwargs)
        self._wrapped = fun
        functools.update_wrapper(self, fun)

    @property
    def __wrapped_fun__(self) -> Callable:
        assert self._wrapped is not None
        return self._wrapped


def udf(
    fun: Callable | None = None,
    /,
    *,
    return_type: Any = None,
    deterministic: bool = False,
    propagate_none: bool = False,
    executor: Executor | None = None,
    cache_strategy: CacheStrategy | None = None,
    max_batch_size: int | None = None,
) -> Any:
    """``@pw.udf`` — turn a Python function (sync or async) into a column
    operator."""

    def wrap(f: Callable) -> _FunctionUDF:
        return _FunctionUDF(
            f,
            return_type=return_type,
            deterministic=deterministic,
            propagate_none=propagate_none,
            executor=executor,
            cache_strategy=cache_strategy,
            max_batch_size=max_batch_size,
        )

    if fun is not None:
        return wrap(fun)
    return wrap


# ---------------------------------------------------------------------------
# Engine entry: run a whole epoch's calls on one event loop


_loop_holder: dict[str, Any] = {}
_loop_lock = threading.Lock()


def _get_loop() -> asyncio.AbstractEventLoop:
    with _loop_lock:
        loop = _loop_holder.get("loop")
        if loop is None or loop.is_closed():
            loop = asyncio.new_event_loop()
            t = threading.Thread(target=loop.run_forever, daemon=True)
            t.start()
            _loop_holder["loop"] = loop
            _loop_holder["thread"] = t
        return loop


def run_async_batch(
    fun: Callable[..., Awaitable[Any]], calls: list[tuple[list, dict]]
) -> list[Any]:
    """Run ``fun`` over every call in the batch concurrently; exceptions in
    individual calls become Error values (reference async-UDF semantics)."""
    afun = coerce_async(fun)

    async def one(args: list, kwargs: dict) -> Any:
        try:
            return await afun(*args, **kwargs)
        except Exception as e:  # noqa: BLE001
            from pathway_tpu_torch.internals.parse_graph import G

            G.log_error(f"async UDF {getattr(fun, '__name__', fun)!r} failed: {e!r}")
            return api.ERROR

    async def gather() -> list[Any]:
        return await asyncio.gather(*[one(a, k) for a, k in calls])

    loop = _get_loop()
    fut = asyncio.run_coroutine_threadsafe(gather(), loop)
    return fut.result()
