"""Tensor parallelism over the mesh's "model" axis against the JAX
package, on the CPU.

The JAX side shards the parameters by its ``encoder_param_specs`` over
the virtual 8-device CPU mesh (``conftest.py``); the port cuts them by
its own ``encoder_param_specs`` over a mesh that names the CPU device
eight times, runs each shard's heads and MLP width, and sums the partial
products on the group's first device.  Both run the f32 tiny config
(``TINY`` of ``tests/test_tpu_plane.py``): embeddings and scores within
1e-5, partial sums taken in another order.
"""

from __future__ import annotations

import dataclasses
import gc
import weakref

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import __graft_entry__ as graft
from pathway_tpu.models import CrossEncoderModel as JaxCross
from pathway_tpu.models import TextEncoderModel as JaxEncoder
from pathway_tpu.models import encoder_param_specs as jax_specs
from pathway_tpu.parallel import JittedEncoder
from pathway_tpu.parallel import ShardedKnnIndex as JaxIndex
from pathway_tpu.parallel import best_mesh as jax_best_mesh
from pathway_tpu_torch import best_mesh, make_mesh
from pathway_tpu_torch.models import CrossEncoderModel, TextEncoderModel, encoder_param_specs
from pathway_tpu_torch.parallel import ShardedKnnIndex, TorchEncoder
from pathway_tpu_torch.parallel.mesh import data_devices, encoder_grids
from test_torch_encoder import port_config
from test_torch_slice import _texts


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: the tier-1 run has several test workers on the
    host's cores, and this file's small products gain little from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = 1e-5
CPU8 = ["cpu"] * 8
TINY = dataclasses.replace(graft._flagship_config(tiny=True), dtype=jnp.float32)
CROSS = dataclasses.replace(TINY, num_labels=1, pool="cls", normalize=False)


# ---------------------------------------------------------------------------
# the sharding rules


def _port_name(path: tuple[str, ...]) -> str:
    """The port's parameter name of a flax leaf (``models/convert.py``)."""
    *mods, leaf = path
    mods = ["token_type" if (m == "type" and mods[0] == "embeddings") else m for m in mods]
    if leaf in ("scale", "embedding", "kernel"):
        leaf = "weight"
    return ".".join(mods + [leaf])


def _port_spec(path: tuple[str, ...], spec, ndim: int) -> tuple:
    """A JAX PartitionSpec carried through the layout table: a kernel's
    dims merge (q/k/v ``[hidden, heads, hd]`` -> ``[hidden, heads*hd]``,
    out ``[heads, hd, hidden]`` -> ``[heads*hd, hidden]``) and transpose;
    a bias flattens.  Only a merged group's major dim may be split."""
    axes = tuple(spec) + (None,) * (ndim - len(spec))
    leaf, mod = path[-1], path[-2]
    if leaf == "kernel":
        groups = [(0, 1), (2,)] if (ndim == 3 and mod == "out") else [(0,), tuple(range(1, ndim))]
    else:
        groups = [tuple(range(ndim))]
    merged = []
    for g in groups:
        assert all(axes[d] is None for d in g[1:]), (path, spec)
        merged.append(axes[g[0]])
    if leaf == "kernel":
        merged = merged[::-1]
    return () if all(a is None for a in merged) else tuple(merged)


@pytest.mark.parametrize("jax_cls,port_cls,jcfg", [
    (JaxEncoder, TextEncoderModel, TINY), (JaxCross, CrossEncoderModel, CROSS),
], ids=["text", "cross"])
def test_encoder_param_specs_match_jax_leaf_by_leaf(jax_cls, port_cls, jcfg):
    ids = jnp.ones((1, 8), jnp.int32)
    params = jax_cls(jcfg).init(jax.random.PRNGKey(0), ids, ids)
    specs = jax_specs(params, "model")
    want = {}
    for (path, spec), (_, leaf) in zip(jax.tree_util.tree_leaves_with_path(specs, is_leaf=lambda x: x is None or
                                                                         type(x).__name__ == "PartitionSpec"),
                                       jax.tree_util.tree_leaves_with_path(params)):
        keys = tuple(str(getattr(p, "key", p)) for p in path)[1:]  # drop "params"
        want[_port_name(keys)] = _port_spec(keys, spec, leaf.ndim)
    got = encoder_param_specs(port_cls(port_config(jcfg), device="cpu"), "model")
    assert got == want
    assert got["layer_0.attention.query.weight"] == ("model", None)
    assert got["layer_1.attention.out.weight"] == (None, "model")
    assert got["layer_0.mlp_down.bias"] == ()


def test_place_cuts_each_shard_once_and_sums_to_the_full_model():
    cfg = port_config(TINY)
    full = TextEncoderModel(cfg, device="cpu", seed=3)
    tp = TextEncoderModel(cfg, device="cpu", seed=3)
    tp.place([["cpu", "cpu"]])
    (a, b), = tp._grid
    assert a is not b and a is not tp and a.blocks()[0].attention.heads == cfg.heads // 2
    w = full.state_dict()["layer_1.mlp_down.weight"]
    torch.testing.assert_close(b.state_dict()["layer_1.mlp_down.weight"], w[:, w.shape[1] // 2:])
    q = full.state_dict()["layer_0.attention.query.bias"]
    torch.testing.assert_close(a.state_dict()["layer_0.attention.query.bias"], q[: q.shape[0] // 2])
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1000, cfg.vocab_size, (3, 16)))
    mask = torch.from_numpy((np.arange(16)[None] < np.array([[16], [5], [1]])).astype(np.int32))
    with torch.no_grad():
        torch.testing.assert_close(tp(ids, mask), full(ids, mask), atol=TOL, rtol=0)
        # new weights are cut again
        tp.load_state_dict(TextEncoderModel(cfg, device="cpu", seed=4).state_dict())
        torch.testing.assert_close(tp(ids, mask), TextEncoderModel(cfg, device="cpu", seed=4)(ids, mask),
                                   atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="divide heads"):
        tp.place([["cpu"] * 3])


@pytest.mark.filterwarnings("ignore:.*to a meta parameter")
def test_model_shards_leave_the_full_weights_in_host_memory():
    """Cut into model shards, each device holds only its own: the full
    weights stay in host memory ("meta" devices stand in for the cards)."""
    cfg = port_config(TINY)
    tenc = TorchEncoder(cfg, mesh=make_mesh({"data": 2, "model": 2}, ["meta"] * 4))
    assert {p.device.type for p in tenc.model.parameters()} == {"cpu"}
    assert tenc.model.device == torch.device("meta")
    (cells,) = tenc.model._grid
    assert {p.device.type for cell in cells for p in cell.parameters()} == {"meta"}
    assert [cell.blocks()[0].mlp_up.weight.shape[0] for cell in cells] == [cfg.mlp_dim // 2] * 2
    # one device: the model is its own cell, on that device
    one = TorchEncoder(cfg, device="meta")
    assert one.model.cells() == [[one.model]] and one.model.embeddings.word.weight.device.type == "meta"


@pytest.mark.parametrize("where", [
    {"device": "cpu"}, {"mesh": best_mesh(2, CPU8)},
    {"mesh": make_mesh({"data": 4}, CPU8[:4]), "sequence_axis": "data"},
], ids=["one_device", "tp_dp", "sp"])
def test_a_dropped_encoder_frees_its_model_at_once(where):
    """A model's grid keeps no reference back to the model: dropped, it
    goes (with its device memory) without the garbage collector."""
    gc.collect()
    gc.disable()
    try:
        enc = TorchEncoder(port_config(TINY), **where)
        model = weakref.ref(enc.model)
        del enc
        assert model() is None
    finally:
        gc.enable()


def test_mesh_grids_and_data_devices_take_the_model_axis():
    mesh = best_mesh(2, CPU8)
    assert mesh.shape == {"data": 4, "model": 2}
    grids = encoder_grids(mesh)
    assert len(grids) == 4 and all(len(g) == 1 and len(g[0]) == 2 for g in grids)
    (sp,) = encoder_grids(mesh, sequence_axis="data")
    assert len(sp) == 4 and all(len(row) == 2 for row in sp)
    assert data_devices(mesh, "data", "test") == [torch.device("cpu")] * 4
    with pytest.raises(NotImplementedError, match="besides"):
        encoder_grids(make_mesh({"data": 2, "x": 4}, CPU8))
    with pytest.raises(ValueError, match="model axis"):
        encoder_grids(mesh, sequence_axis="model")


# ---------------------------------------------------------------------------
# the tensor-parallel executor


@pytest.fixture(scope="module")
def tp_pair():
    jenc = JittedEncoder(TINY, mesh=jax_best_mesh(model_parallel=2), max_batch=16)
    tenc = TorchEncoder(port_config(TINY), mesh=best_mesh(2, CPU8), max_batch=16,
                        params=jax.tree.map(np.asarray, jenc.params))
    return jenc, tenc


def test_tp_dp_encoder_matches_jax(tp_pair):
    jenc, tenc = tp_pair
    assert tenc._dp == 4 and len(set(map(id, tenc._replicas))) == 1  # one group on the repeated devices
    texts = _texts(37, 5)
    got = tenc.encode(texts)
    np.testing.assert_allclose(got, jenc.encode(texts), atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), np.ones(37), atol=1e-4)


def test_tp_encode_into_a_sharded_index_matches_jax(tp_pair):
    jenc, tenc = tp_pair
    docs = _texts(40, 6)
    keys = [f"d{i}" for i in range(40)]
    jidx = JaxIndex(64, capacity=64, mesh=jax_best_mesh(model_parallel=2))
    tidx = ShardedKnnIndex(64, capacity=64, mesh=best_mesh(2, CPU8))
    assert jenc.encode_into(jidx, keys, docs) == tenc.encode_into(tidx, keys, docs) == 40
    q = tenc.encode(docs[:8])
    for ja, tb in zip(jidx.search(q, 4), tidx.search(q, 4)):
        assert [k for k, _ in ja] == [k for k, _ in tb]
        np.testing.assert_allclose([s for _, s in ja], [s for _, s in tb], atol=TOL)


def test_tp_score_pairs_matches_jax():
    jenc = JittedEncoder(CROSS, cross=True, mesh=jax_best_mesh(model_parallel=2))
    tenc = TorchEncoder(port_config(CROSS), cross=True, mesh=best_mesh(2, CPU8),
                        params=jax.tree.map(np.asarray, jenc.params))
    queries = _texts(11, 7)
    docs = _texts(11, 8)
    np.testing.assert_allclose(tenc.score_pairs(queries, docs), jenc.score_pairs(queries, docs), atol=TOL)


def test_sequence_and_tensor_parallel_together_match_jax():
    """``best_mesh(model_parallel=2)`` with the sequence over "data": the
    JAX executor runs it (ring attention, heads over "model"), and so does
    the port, each model shard's heads in their own ring."""
    cfg = dataclasses.replace(TINY, max_len=64)
    jenc = JittedEncoder(cfg, mesh=jax_best_mesh(model_parallel=2), sequence_axis="data")
    tenc = TorchEncoder(port_config(cfg), mesh=best_mesh(2, CPU8), sequence_axis="data",
                        params=jax.tree.map(np.asarray, jenc.params))
    assert len(tenc.model._grid) == 4 and all(len(row) == 2 for row in tenc.model._grid)
    docs = ["a b c", "w " * 40, "hello there general", "x"]
    np.testing.assert_allclose(tenc.encode(docs), jenc.encode(docs), atol=TOL)
