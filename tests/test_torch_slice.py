"""The port's slice as a whole against the JAX package's, on the CPU, and
the package's import and device guards.

The tiny flagship config (f32, 2 layers, hidden 64) with the same flax
parameters embeds the same texts through the JAX ``JittedEncoder.
encode_into`` + ``ShardedKnnIndex`` and through the port's
``TorchEncoder`` + ``ShardedKnnIndex``; searches return the same keys,
with scores within 1e-4 (the f32 encoder tolerance).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import torch

import __graft_entry__ as graft
from pathway_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from pathway_tpu.parallel import JittedEncoder
from pathway_tpu.parallel import ShardedKnnIndex as JaxIndex
from pathway_tpu_torch.internals import device_counters
from pathway_tpu_torch.models import HashTokenizer
from pathway_tpu_torch.parallel import ShardedKnnIndex, TorchEncoder, make_mesh
from pathway_tpu_torch.xpacks.llm.embedders import (
    SentenceTransformerEmbedder,
    TorchEncoderEmbedder,
    _resolve_config,
)
from test_torch_encoder import port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: the tier-1 run has several test workers on the
    host's cores, and this file's small products gain little from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(300)] + ["stream", "index", "tpu", "gpu", "rag"]
    return [" ".join(rng.choice(words, rng.integers(3, 40))) for _ in range(n)]


@pytest.fixture(scope="module")
def pair():
    jcfg = graft._flagship_config(tiny=True)
    jenc = JittedEncoder(jcfg, max_batch=16, seed=0)
    params = jax.tree.map(np.asarray, jenc.params)
    tenc = TorchEncoder(port_config(jcfg), max_batch=16, params=params, device="cpu")
    return jenc, tenc


def test_tokenizer_ids_identical_to_jax():
    texts = _texts(20, 1) + ["", "Hello, World! 42", "x " * 600]
    for max_len in (512, 64):
        want = JaxHashTokenizer().encode_batch(texts, max_len=max_len)
        got = HashTokenizer().encode_batch(texts, max_len=max_len)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    pair_want = JaxHashTokenizer().encode_batch(texts[:3], pair=texts[3:6])
    pair_got = HashTokenizer().encode_batch(texts[:3], pair=texts[3:6])
    for a, b in zip(pair_got, pair_want):
        np.testing.assert_array_equal(a, b)


def test_encode_matches_jax(pair):
    jenc, tenc = pair
    texts = _texts(37, 2)  # three chunks of 16, the last one padded
    np.testing.assert_allclose(tenc.encode(texts), jenc.encode(texts), atol=TOL)
    assert tenc.encode([]).shape == (0, 64)


@pytest.mark.parametrize("metric", ["cos", "dot"])
def test_encode_into_and_search_match_jax(pair, metric):
    jenc, tenc = pair
    docs = _texts(50, 3)
    keys = [f"doc{i}" for i in range(50)]
    jidx = JaxIndex(64, metric=metric, capacity=128)
    tidx = ShardedKnnIndex(64, metric=metric, capacity=128, device="cpu")
    assert jenc.encode_into(jidx, keys, docs) == tenc.encode_into(tidx, keys, docs) == 50
    jidx.remove(keys[::7])
    tidx.remove(keys[::7])
    queries = jenc.encode(docs[:16])
    want = jidx.search(queries, 5)
    got = tidx.search(tenc.encode(docs[:16]), 5)
    for rw, rg in zip(want, got):
        assert [k for k, _ in rg] == [k for k, _ in rw]
        np.testing.assert_allclose([s for _, s in rg], [s for _, s in rw], atol=TOL)
    # a document re-embedded in the same batch is its own top-1
    for i, row in enumerate(got):
        if i % 7:
            assert row[0][0] == keys[i] and row[0][1] >= 0.999


def test_transfers_are_counted(pair):
    _, tenc = pair
    device_counters.reset_for_tests()
    idx = ShardedKnnIndex(64, capacity=128, device="cpu")
    tenc.encode_into(idx, ["a", "b", "c"], ["x y", "y z", "z"])
    snap = device_counters.snapshot()
    # int16 ids + uint8 mask/type for an 8-row bucket, then the int32 slots
    assert snap["h2d_transfers"] == 2 and snap["d2h_bytes"] == 0
    assert snap["h2d_bytes"] == 8 * 16 * (2 + 1 + 1) + 8 * 4
    idx.search(np.ones((1, 64), np.float32), 2)
    assert device_counters.snapshot()["d2h_transfers"] == 1


def test_padded_rows_get_one_valid_token(pair):
    _, tenc = pair
    ids = np.ones((3, 16), np.int32)
    mask = np.zeros((3, 16), np.int32)
    _, m, _, n = tenc._pad_batch(ids, mask, ids.copy())
    assert n == 3 and m.shape == (8, 16)
    assert m[3:, 0].tolist() == [1] * 5 and m[3:, 1:].sum() == 0


def test_embedder_presets_and_alias():
    assert SentenceTransformerEmbedder is TorchEncoderEmbedder
    assert _resolve_config("BAAI/bge-base-en-v1.5").hidden == 768
    assert _resolve_config("unknown-model").hidden == 384
    jcfg = graft._flagship_config(tiny=True)
    emb = TorchEncoderEmbedder("bge-base", config=port_config(jcfg), max_batch_size=8, device="cpu")
    assert emb.get_embedding_dimension() == 64
    rows = emb.__batch__(["alpha beta", ""])
    assert len(rows) == 2 and rows[0].shape == (64,)
    np.testing.assert_allclose(emb.__wrapped__("alpha beta"), rows[0], atol=1e-6)


@pytest.mark.parametrize(
    "kwargs,error",
    [pytest.param({"cross": True, "checkpoint_dir": "/nonexistent"}, FileNotFoundError, id="kwargs0-A3"),
     pytest.param({"mesh": make_mesh({"data": 2, "x": 4}, ["cpu"] * 8)}, "besides", id="kwargs1-A9"),
     pytest.param({"sequence_axis": "data"}, ValueError, id="kwargs2-A9"),
     pytest.param({"checkpoint_dir": "/nonexistent"}, FileNotFoundError, id="kwargs3-A3")],
)
def test_unported_executor_options_name_their_roadmap_item(kwargs, error):
    """A mesh axis the encoder does not spread over ("data", "model" and a
    sequence axis are ported; ``tests/test_torch_tp.py`` and
    ``tests/test_torch_ring.py`` run them) raises naming the axes it
    knows; a missing checkpoint directory, and a sequence axis without a
    mesh, raise as the JAX executor does."""
    cfg = port_config(graft._flagship_config(tiny=True))
    if isinstance(error, str):
        with pytest.raises(NotImplementedError, match=error):
            TorchEncoder(cfg, device="cpu", **kwargs)
        return
    jax_kwargs = {k: v for k, v in kwargs.items() if k != "mesh"}
    with pytest.raises(error):
        JittedEncoder(graft._flagship_config(tiny=True), **jax_kwargs)
    with pytest.raises(error):
        TorchEncoder(cfg, device="cpu", **kwargs)


def test_import_pulls_in_no_jax():
    code = (
        "import sys, pathway_tpu_torch, pathway_tpu_torch.kernels._build,"
        " pathway_tpu_torch.xpacks.llm.rerankers, pathway_tpu_torch.persistence,"
        " pathway_tpu_torch.testing, pathway_tpu_torch.testing.chaos,"
        " pathway_tpu_torch.engine.temporal, pathway_tpu_torch.stdlib.temporal,"
        " pathway_tpu_torch.stdlib.ordered, pathway_tpu_torch.stdlib.stateful,"
        " pathway_tpu_torch.stdlib.statistical, pathway_tpu_torch.internals.iterate,"
        " pathway_tpu_torch.universes, pathway_tpu_torch.stdlib.graphs, pathway_tpu_torch.stdlib.ml,"
        " pathway_tpu_torch.stdlib.ml.index, pathway_tpu_torch.stdlib.ml.classifiers,"
        " pathway_tpu_torch.stdlib.ml.hmm, pathway_tpu_torch.stdlib.ml.smart_table_ops,"
        " pathway_tpu_torch.internals.sql, pathway_tpu_torch.internals.interactive,"
        " pathway_tpu_torch.internals.yaml_loader, pathway_tpu_torch.demo, pathway_tpu_torch.stdlib.viz,"
        " pathway_tpu_torch.xpacks.llm.rag_eval, pathway_tpu_torch.cli,"
        " pathway_tpu_torch.xpacks.llm.parsers, pathway_tpu_torch.xpacks.llm._layout,"
        " pathway_tpu_torch.xpacks.llm._doc, pathway_tpu_torch.io.null, pathway_tpu_torch.io.sqlite,"
        " pathway_tpu_torch.io.pyfilesystem, pathway_tpu_torch.io.s3, pathway_tpu_torch.io.s3_csv,"
        " pathway_tpu_torch.io.minio, pathway_tpu_torch.io.kafka, pathway_tpu_torch.io.redpanda,"
        " pathway_tpu_torch.io.debezium, pathway_tpu_torch.io.postgres;"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'pathway_tpu'));"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    cfg = port_config(graft._flagship_config(tiny=True))
    for build in (lambda: ShardedKnnIndex(8), lambda: TorchEncoder(cfg),
                  lambda: TorchEncoderEmbedder("bge-small", config=cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_kernel_wrappers_raise_instead_of_falling_back():
    """A wrapper given a non-CPU tensor it cannot launch on raises; it
    never runs the plain version for it."""
    from pathway_tpu_torch.kernels import attention, knn_topk, slab_clear, slab_scatter

    meta = torch.zeros((2, 16, 2, 32), device="meta", dtype=torch.bfloat16)
    m = torch.zeros((2, 16), device="meta", dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        attention(meta, meta, meta, m)
    slab = torch.zeros((8, 4), device="meta")
    valid = torch.zeros(8, device="meta")
    slots = torch.zeros(2, device="meta", dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        slab_scatter(slab, valid, slots, torch.zeros((2, 4), device="meta"), True)
    with pytest.raises(ValueError, match="CUDA"):
        slab_clear(valid, slots)
    with pytest.raises(ValueError, match="CUDA"):
        knn_topk(torch.zeros((1, 4), device="meta"), slab, valid, 2, "dot")
