"""The ingest tail (K7's slab form, ``kernels.pool_normalize_into``: the
encoder's pooling and normalise with K2's scatter in one launch) and K7's
mean form, on the CPU.

- The plain form equals ``pool_normalize_plain`` followed by
  ``slab_scatter_plain`` bit for bit, over CLS and mean, normalise on and
  off, cos and dot, bf16 and f32 hidden, f32 and bf16 slabs, a pitched
  slab, pad, negative and re-upserted slots, masks with holes and an
  all-zero row.
- ``TorchEncoder.encode_into`` (the tiny flagship config, CLS and mean)
  into the port's one-shard ``ShardedKnnIndex`` against
  ``JittedEncoder.encode_into`` into the JAX index, 50 documents in chunks
  of 16 (the last chunk padded): each key's slab row within 1e-5 in f32
  (the f32 encoder tolerance) and within 2e-2 with cosine 0.999 in bf16 (the
  embedding tolerance: the two libraries round bf16 at different places),
  the valid flags equal, the search's top-k keys equal (bf16: each
  document its own top-1).
- The path: a one-shard index on the encoder's device takes the tail and
  never K2; two shards, or two data-parallel replicas, take K7 then K2 and
  leave the same slab.
- The argument checks refuse what the kernel does not take; the mean
  form's arithmetic (one block a sequence, rows skipped where the mask is
  0, runs of 8 rows a thread group, the partial rows summed in row order)
  emulated in torch against the plain version.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import __graft_entry__ as graft
from pathway_tpu.parallel import JittedEncoder
from pathway_tpu.parallel import ShardedKnnIndex as JaxIndex
from pathway_tpu_torch.kernels import _pitch
from pathway_tpu_torch.kernels import pool_normalize_into, pool_normalize_into_plain, pool_normalize_plain
from pathway_tpu_torch.kernels import slab_scatter_plain
from pathway_tpu_torch.models import encoder as encoder_mod
from pathway_tpu_torch.parallel import ShardedKnnIndex, TorchEncoder, make_mesh
from pathway_tpu_torch.parallel import sharded_knn
from test_torch_encoder import port_config
from test_torch_slice import _texts

# the module (the package attribute of that name is the wrapper function)
k7 = importlib.import_module("pathway_tpu_torch.kernels.pool_normalize")

F32_ATOL = 1e-5  # the f32 encoder tolerance of the port's parity tests
BF16_ATOL, BF16_COS = 2e-2, 0.999  # the bf16 embedding tolerance
H, PITCH_H = 36, 40  # a hidden width whose stored rows are pitched (kernels/_pitch.py)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: the tier-1 run has several test workers on the
    host's cores, and this file's small products gain little from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _hidden(rng, B, L, dtype):
    x = torch.from_numpy(rng.standard_normal((B, L, H)).astype(np.float32) * 2.0).to(dtype)
    lens = rng.integers(1, L + 1, B)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.uint8)
    mask[1, 2:5] = 0  # holes
    mask[2, 1::3] = 0
    mask[3] = 0  # an all-zero row: the mean divides by max(count, 1)
    return x, torch.from_numpy(mask)


# ---------------------------------------------------------------------------
# the plain form


@pytest.mark.parametrize("slab_dtype", [torch.float32, torch.bfloat16], ids=["slab_f32", "slab_bf16"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["x_f32", "x_bf16"])
@pytest.mark.parametrize("cos", [True, False], ids=["cos", "dot"])
@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_into_plain_is_pool_then_scatter(pool, normalize, cos, x_dtype, slab_dtype):
    rng = np.random.default_rng(7)
    B, L, cap = 8, 11, 24
    x, mask = _hidden(rng, B, L, x_dtype)
    # pads (= capacity), a negative slot, and slot 5 filled before: a re-upsert
    slots = torch.tensor([5, 0, cap, 17, -3, 23, cap, 9], dtype=torch.int32)
    slab = _pitch.pitched_zeros((cap, H), slab_dtype, "cpu")
    assert slab.stride(0) == PITCH_H
    slab.copy_(torch.from_numpy(rng.standard_normal((cap, H)).astype(np.float32)).to(slab_dtype))
    valid = torch.from_numpy((rng.random(cap) < 0.5).astype(np.float32))
    want_slab, want_valid = _pitch.pitched(slab), valid.clone()
    slab_scatter_plain(want_slab, want_valid, slots, pool_normalize_plain(x, mask, pool, normalize), cos)
    for fn in (pool_normalize_into_plain, pool_normalize_into):  # CPU tensors: the wrapper runs the plain form
        got_slab, got_valid = _pitch.pitched(slab), valid.clone()
        fn(got_slab, got_valid, slots, x, mask, pool, normalize, cos)
        assert torch.equal(got_slab, want_slab) and torch.equal(got_valid, want_valid)
    # what the two programs do: kept slots set, dropped ones left alone
    kept = [0, 1, 3, 5, 7]
    assert want_valid[slots[kept].long()].tolist() == [1.0] * len(kept)
    untouched = [s for s in range(cap) if s not in slots[kept].tolist()]
    assert torch.equal(want_slab[untouched], slab[untouched]) and torch.equal(want_valid[untouched], valid[untouched])
    if cos:  # unit rows, but the mean of sequence 3 (no valid row), which stays 0
        norms = want_slab[slots[kept].long()].float().norm(dim=1)
        unit = [0.0 if pool == "mean" and b == 3 else 1.0 for b in kept]
        np.testing.assert_allclose(norms.numpy(), unit, atol=1e-2 if slab_dtype == torch.bfloat16 else 1e-6)


# ---------------------------------------------------------------------------
# the slice against the JAX package


def _encoders(pool, dtype):
    jcfg = dataclasses.replace(graft._flagship_config(tiny=True), pool=pool, dtype=dtype)
    jenc = JittedEncoder(jcfg, max_batch=16, seed=0)
    params = jax.tree.map(np.asarray, jenc.params)
    tenc = TorchEncoder(port_config(jcfg), max_batch=16, params=params, device="cpu")
    return jenc, tenc


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("metric", ["cos", "dot"])
@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_encode_into_matches_jax(pool, metric, precision):
    dtype = jnp.float32 if precision == "f32" else jnp.bfloat16
    jenc, tenc = _encoders(pool, dtype)
    docs, keys = _texts(50, 3), [f"doc{i}" for i in range(50)]  # chunks of 16, 16, 16, 2 (6 pad rows)
    jidx = JaxIndex(64, metric=metric, capacity=128, dtype=dtype)
    tidx = ShardedKnnIndex(64, metric=metric, capacity=128, dtype=port_config(jenc.config).dtype, device="cpu")
    assert jenc.encode_into(jidx, keys, docs) == tenc.encode_into(tidx, keys, docs) == 50
    want = np.asarray(jidx._vectors, np.float32)
    got = tidx._vectors.float().numpy()
    for key in keys:
        w, g = want[jidx._slot_of[key]], got[tidx._slot_of[key]]
        if precision == "f32":
            np.testing.assert_allclose(g, w, atol=F32_ATOL)
        else:
            np.testing.assert_allclose(g, w, atol=BF16_ATOL)
            assert g @ w / np.linalg.norm(g) / np.linalg.norm(w) >= BF16_COS
    np.testing.assert_array_equal(tidx._valid.numpy(), np.asarray(jidx._valid))
    assert tidx._slot_of == jidx._slot_of
    queries = jenc.encode(docs[:16])
    for i, (rw, rg) in enumerate(zip(jidx.search(queries, 5), tidx.search(queries, 5))):
        if precision == "f32":
            assert [k for k, _ in rg] == [k for k, _ in rw]
        else:
            assert rg[0][0] == rw[0][0] == keys[i]


# ---------------------------------------------------------------------------
# the path taken


@pytest.fixture(scope="module")
def cls_pair():
    return _encoders("cls", jnp.float32)


def _spy(monkeypatch):
    calls = {"tail": 0, "k7": 0, "k2": 0}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(sharded_knn, "pool_normalize_into", counting("tail", sharded_knn.pool_normalize_into))
    monkeypatch.setattr(sharded_knn, "slab_scatter", counting("k2", sharded_knn.slab_scatter))
    # K7 runs in the model (several replicas) or in the index (one replica)
    monkeypatch.setattr(encoder_mod, "pool_normalize", counting("k7", encoder_mod.pool_normalize))
    monkeypatch.setattr(sharded_knn, "pool_normalize", counting("k7", sharded_knn.pool_normalize))
    return calls


@pytest.mark.parametrize("metric", ["cos", "dot"])
def test_one_shard_index_takes_the_tail_and_never_k2(cls_pair, monkeypatch, metric):
    _, tenc = cls_pair
    docs, keys = _texts(50, 3), [f"doc{i}" for i in range(50)]
    idx = ShardedKnnIndex(64, metric=metric, capacity=256, device="cpu")
    calls = _spy(monkeypatch)
    tenc.encode_into(idx, keys, docs)
    assert calls == {"tail": 4, "k7": 0, "k2": 0}  # one tail a chunk
    # two shards: K7 then K2, the same slab
    sharded = ShardedKnnIndex(64, metric=metric, capacity=256, mesh=make_mesh({"data": 2}, ["cpu"] * 2))
    tenc.encode_into(sharded, keys, docs)
    assert calls["tail"] == 4 and calls["k7"] == 4 and calls["k2"] == 4 * 2
    assert sharded._slot_of == idx._slot_of
    assert torch.equal(sharded._vectors, idx._vectors) and torch.equal(sharded._valid, idx._valid)


def test_data_parallel_encoder_takes_k7_then_k2(cls_pair, monkeypatch):
    jenc, tenc = cls_pair
    params = jax.tree.map(np.asarray, jenc.params)
    dp = TorchEncoder(port_config(jenc.config), max_batch=16, params=params,
                      mesh=make_mesh({"data": 2}, ["cpu"] * 2))
    docs, keys = _texts(50, 3), [f"doc{i}" for i in range(50)]
    one, two = (ShardedKnnIndex(64, capacity=128, device="cpu") for _ in range(2))
    tenc.encode_into(one, keys, docs)
    calls = _spy(monkeypatch)
    dp.encode_into(two, keys, docs)
    assert calls["tail"] == 0 and calls["k7"] == 2 * 4 and calls["k2"] == 4
    np.testing.assert_allclose(two._vectors.numpy(), one._vectors.numpy(), atol=F32_ATOL)
    assert torch.equal(two._valid, one._valid)


def test_index_pools_with_k7_across_devices(monkeypatch):
    """Two shards: ``add_pooled_device`` is K7 then ``add_batch_device``."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 6, 64)).astype(np.float32))
    m = torch.ones((4, 6), dtype=torch.uint8)
    m[1, 3:] = 0
    mesh = make_mesh({"data": 2}, ["cpu"] * 2)
    pooled, want = (ShardedKnnIndex(64, capacity=8, mesh=mesh) for _ in range(2))
    calls = _spy(monkeypatch)
    pooled.add_pooled_device(["a", "b", "c"], x, m, "mean", True)
    assert calls == {"tail": 0, "k7": 1, "k2": 2}
    want.add_batch_device(["a", "b", "c"], pool_normalize_plain(x, m, "mean", True))
    assert pooled._slot_of == want._slot_of
    assert torch.equal(pooled._vectors, want._vectors) and torch.equal(pooled._valid, want._valid)
    one = ShardedKnnIndex(64, capacity=128, device="cpu")
    with pytest.raises(ValueError, match="hidden dim"):
        one.add_pooled_device(["a"], torch.zeros((1, 4, 32)), m[:1], "cls", True)
    with pytest.raises(ValueError, match="keys but only"):
        one.add_pooled_device(["a", "b", "c", "d", "e"], x, m, "cls", True)


# ---------------------------------------------------------------------------
# refusals


def _args(**over):
    args = {
        "slab": _pitch.pitched_zeros((16, H), torch.float32, "cpu"),
        "valid": torch.zeros(16),
        "slots": torch.zeros(4, dtype=torch.int32),
        "x": torch.zeros((4, 6, H), dtype=torch.bfloat16),
        "mask": torch.ones((4, 6), dtype=torch.uint8),
        "pool": "mean",
    }
    args.update(over)
    return args


REFUSED = {
    "odd_hidden": ({"x": torch.zeros((4, 6, 35)), "slab": torch.zeros((16, 35))}, "even"),
    "too_wide": ({"x": torch.zeros((4, 6, 2056)), "slab": torch.zeros((16, 2056))}, "at most"),
    "empty_sequence": ({"x": torch.zeros((4, 0, H)), "mask": torch.ones((4, 0), dtype=torch.uint8)}, "L > 0"),
    "x_f16": ({"x": torch.zeros((4, 6, H), dtype=torch.float16)}, "bf16 or f32 x"),
    "mask_int32": ({"mask": torch.ones((4, 6), dtype=torch.int32)}, "uint8 mask"),
    "mask_shape": ({"mask": torch.ones((4, 5), dtype=torch.uint8)}, "mask"),
    "pool": ({"pool": "max"}, "pool"),
    "slab_f16": ({"slab": torch.zeros((16, H), dtype=torch.float16)}, "f32 or bf16"),
    "slab_width": ({"slab": _pitch.pitched_zeros((16, H + 2), torch.float32, "cpu")}, "capacity"),
    "slab_pitch": ({"slab": torch.zeros((16, 44))[:, :H]}, "pitch"),
    "slab_columns": ({"slab": torch.zeros((H, 16)).T}, "contiguous"),
    "slots_int64": ({"slots": torch.zeros(4, dtype=torch.int64)}, "int32"),
    "slots_shape": ({"slots": torch.zeros(5, dtype=torch.int32)}, "int32"),
    "valid_shape": ({"valid": torch.zeros(15)}, "valid"),
    "valid_bf16": ({"valid": torch.zeros(16, dtype=torch.bfloat16)}, "valid"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_check_pool_normalize_into_refuses(case):
    over, match = REFUSED[case]
    k7.check_pool_normalize_into(**_args())  # what the kernel takes
    with pytest.raises(ValueError, match=match):
        k7.check_pool_normalize_into(**_args(**over))


def test_kernel_forms_raise_on_a_tensor_they_cannot_launch_on():
    """Non-CPU tensors the kernel cannot take raise; nothing falls back."""
    meta = {name: (t.to("meta") if isinstance(t, torch.Tensor) else t) for name, t in _args().items()}
    meta["slab"] = _pitch.pitched_zeros((16, H), torch.float32, "meta")
    with pytest.raises(ValueError, match="CUDA"):
        pool_normalize_into(meta["slab"], meta["valid"], meta["slots"], meta["x"], meta["mask"], "mean", True, True)
    with pytest.raises(ValueError, match="CUDA"):
        k7.pool_normalize(meta["x"], meta["mask"], "mean", True)
    bad = _args(slots=torch.zeros(4, dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="int32"):
        pool_normalize_into(meta["slab"], meta["valid"], bad["slots"], meta["x"], meta["mask"], "mean", True, True)


# ---------------------------------------------------------------------------
# the mean form's arithmetic


def _rows_in_flight(h, dtype):
    """R of ``csrc/pool_normalize.cu``'s mean form: a thread a 16-byte
    vector (8 bf16 or 4 f32 values) where h allows it, else a pair; R
    groups of h / V threads in a block of at most 512 threads, R >= 1."""
    v = 4 if dtype == torch.float32 else 8
    v = v if h % v == 0 else 2
    return max(1, 512 // (h // v))


def _emulate_mean(x, mask, rows_in_flight, normalize, unroll=8, tile=2048):
    """The mean form's arithmetic in f32 torch, as ``csrc/pool_normalize.cu``
    orders it: one block a sequence, thread group r taking, in each tile of
    the mask staged, the runs of ``unroll`` consecutive rows at r * unroll,
    r * unroll + R * unroll, ..., each row in turn (a masked row skipped);
    the R partial rows added in row order; then the division (a product
    with the reciprocal), the rounding to x's type and the normalise
    (likewise)."""
    B, L, h = x.shape
    out = torch.empty((B, h))
    for b in range(B):
        parts = [torch.zeros(h) for _ in range(rows_in_flight)]
        count = 0.0
        for t0 in range(0, L, tile):
            for i in range(min(tile, L - t0)):
                w = float(mask[b, t0 + i])
                if w != 0.0:
                    r = (i // unroll) % rows_in_flight
                    parts[r] = parts[r] + x[b, t0 + i].float() * w
                    count += w
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        inv = torch.tensor(1.0) / max(count, 1.0)
        out[b] = (total * inv).to(x.dtype).float()
    if normalize:
        out = out * (1.0 / torch.clamp(out.norm(dim=1, keepdim=True), min=k7.NORM_EPS))
    return out


@pytest.mark.parametrize("seq_len", [1, 7, 8, 150, 2100])  # 2,100: the mask is staged in two tiles
@pytest.mark.parametrize("h", [36, 64])  # pairs and 16-byte vectors in bf16; 16 bytes in f32
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mean_arithmetic_matches_the_plain_version(dtype, h, seq_len):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((6, seq_len, h)).astype(np.float32) * 2.0).to(dtype)
    _, mask = _hidden(rng, 6, seq_len, dtype)
    want = pool_normalize_plain(x, mask, "mean", True)
    got = _emulate_mean(x, mask, _rows_in_flight(h, dtype), normalize=True)
    # f32: sums in another order and products with reciprocals; bf16: the
    # mean's rounding may land one bf16 ulp apart (2 ** -8 of a value)
    tol = 1e-6 if dtype == torch.float32 else 2 ** -7
    assert float((got - want).abs().max()) <= tol
    # the deliberate deviation (ROADMAP C 5): a padded row holding inf is
    # not read, where the reference's 0 * inf makes the row NaN
    x[0, -1] = float("inf")
    mask[0, -1] = 0
    assert torch.isnan(pool_normalize_plain(x, mask, "mean", True)[0]).all()
    assert torch.isfinite(_emulate_mean(x, mask, _rows_in_flight(h, dtype), normalize=True)[0]).all()
