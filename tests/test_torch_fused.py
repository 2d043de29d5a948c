"""The plain versions of kernels K4-K7 against the JAX computations they
replace, on the CPU.

On CPU tensors each wrapper (``bias_act``, ``add_layer_norm``,
``embed_ln``, ``pool_normalize``) runs its plain PyTorch version; the
same numpy-seeded inputs go through the flax modules / jnp ops of
``pathway_tpu`` and through the wrapper.  Tolerances: f32 atol 1e-5;
bf16 cosine >= 0.999 per row with atol 2e-2 plus two bf16 ulps of the
value (rtol 2**-6): the two libraries round bf16 after the same steps
but sum products and statistics in another order, so an output may land
one ulp apart.  No CUDA launch may be counted.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

import __graft_entry__ as graft
from pathway_tpu.models.encoder import Embeddings as JaxEmbeddings
from pathway_tpu.ops.pooling import cls_pool, masked_mean_pool
from pathway_tpu_torch import kernels
from pathway_tpu_torch.kernels import (
    add_layer_norm,
    bias_act,
    embed_ln,
    pool_normalize,
)
from test_torch_encoder import port_config

_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_RTOL = 2.0**-6


def assert_close(got: torch.Tensor, want, dtype: str) -> None:
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        return
    # cosine in f64 (a row of 1e-20-sized values underflows f32 norms),
    # over the rows that are not zero on both sides
    g, w = (a.reshape(-1, a.shape[-1]).astype(np.float64) for a in (got, want))
    norms = np.linalg.norm(g, axis=1) * np.linalg.norm(w, axis=1)
    live = norms > 0
    assert np.array_equal(live, np.abs(g).sum(1) + np.abs(w).sum(1) > 0)
    assert ((g * w).sum(1)[live] / norms[live]).min(initial=1.0) >= 0.999
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=BF16_RTOL)


@pytest.fixture
def no_launch():
    """The CPU path counts no CUDA launch."""
    before = kernels.launch_counts()
    yield
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("act", ["none", "gelu_tanh", "gelu_erf", "tanh"])
def test_bias_act_matches_flax_dense_and_activation(dtype, act, no_launch):
    jdt, tdt = _DT[dtype]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 5, 32)).astype(np.float32)
    kernel = (rng.standard_normal((32, 48)) * 0.3).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    dense = nn.Dense(48, dtype=jdt, param_dtype=jnp.float32)
    want = dense.apply({"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x, jdt))
    want = {
        "none": lambda h: h,
        "gelu_tanh": lambda h: nn.gelu(h, approximate=True),
        "gelu_erf": lambda h: nn.gelu(h, approximate=False),
        "tanh": jnp.tanh,
    }[act](want)
    y = F.linear(torch.from_numpy(x).to(tdt), torch.from_numpy(kernel.T.copy()).to(tdt))
    got = bias_act(y, torch.from_numpy(bias), act)
    assert got is y and got.dtype == tdt  # in place
    assert_close(got, want, dtype)


def test_bias_act_rejects_unknown_activation():
    with pytest.raises(ValueError, match="act"):
        bias_act(torch.zeros(2, 8), torch.zeros(8), "relu")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_add_layer_norm_matches_flax_layernorm_of_sum(dtype, no_launch):
    jdt, tdt = _DT[dtype]
    rng = np.random.default_rng(3)
    x, r = (rng.standard_normal((4, 7, 64)).astype(np.float32) for _ in range(2))
    x += 0.5  # rows with a mean away from zero
    scale = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    ln = nn.LayerNorm(epsilon=1e-12, dtype=jdt, param_dtype=jnp.float32)
    want = ln.apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x, jdt) + jnp.asarray(r, jdt))
    got = add_layer_norm(
        torch.from_numpy(x).to(tdt), torch.from_numpy(r).to(tdt),
        torch.from_numpy(scale), torch.from_numpy(bias), 1e-12,
    )
    assert got.dtype == tdt
    assert_close(got, want, dtype)


def _embed_inputs(vocab: int, type_vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (3, 16)).astype(np.int32)
    types = rng.integers(0, max(type_vocab, 1), (3, 16)).astype(np.int32)
    return ids, types


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("type_vocab,with_types", [(2, True), (2, False), (0, False)])
@pytest.mark.parametrize("id_dtype", [torch.int16, torch.int32, torch.int64])
def test_embed_ln_matches_flax_embeddings(dtype, type_vocab, with_types, id_dtype, no_launch):
    jdt, tdt = _DT[dtype]
    jcfg = dataclasses.replace(graft._flagship_config(tiny=True), dtype=jdt, type_vocab=type_vocab)
    ids, types = _embed_inputs(jcfg.vocab_size, type_vocab)
    module = JaxEmbeddings(jcfg)
    params = module.init(jax.random.PRNGKey(1), jnp.asarray(ids), None)["params"]
    rng = np.random.default_rng(5)
    # LayerNorm parameters away from their (1, 0) init, so both are exercised
    params = dict(params, ln={
        "scale": (1.0 + 0.1 * rng.standard_normal(jcfg.hidden)).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(jcfg.hidden)).astype(np.float32),
    })
    jtypes = jnp.asarray(types) if with_types else None
    want = module.apply({"params": params}, jnp.asarray(ids), jtypes)
    p = jax.tree.map(np.asarray, params)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    got = embed_ln(
        torch.from_numpy(ids).to(id_dtype),
        torch.from_numpy(types).to(torch.uint8) if with_types else None,
        t(p["word"]["embedding"]), t(p["position"]["embedding"]),
        t(p["type"]["embedding"]) if type_vocab else None,
        t(p["ln"]["scale"]), t(p["ln"]["bias"]), jcfg.ln_eps, port_config(jcfg).dtype,
    )
    assert got.shape == (3, 16, jcfg.hidden) and got.dtype == tdt
    assert_close(got, want, dtype)


def _jax_tail(x, mask, pool: str, normalize: bool):
    """``TextEncoderModel.__call__`` tail, pathway_tpu/models/encoder.py:196-202."""
    pooled = cls_pool(x) if pool == "cls" else masked_mean_pool(x, mask)
    if normalize:
        norm = jnp.sqrt(jnp.sum(pooled.astype(jnp.float32) ** 2, axis=-1, keepdims=True))
        pooled = pooled.astype(jnp.float32) / jnp.maximum(norm, 1e-12)
    return pooled.astype(jnp.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pool", ["mean", "cls"])
@pytest.mark.parametrize("normalize", [True, False])
def test_pool_normalize_matches_jax_tail(dtype, pool, normalize, no_launch):
    jdt, tdt = _DT[dtype]
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((5, 12, 64)) + 0.2).astype(np.float32)
    x[4] *= 1e-20  # a row whose norm is below the eps: divided by 1e-12
    lens = np.array([12, 1, 5, 0, 7])  # row 3 fully masked: count clamps to 1
    mask = (np.arange(12)[None] < lens[:, None]).astype(np.uint8)
    want = _jax_tail(jnp.asarray(x, jdt), jnp.asarray(mask), pool, normalize)
    got = pool_normalize(torch.from_numpy(x).to(tdt), torch.from_numpy(mask), pool, normalize)
    assert got.dtype == torch.float32 and got.shape == (5, 64)
    assert_close(got, want, dtype)


def test_pool_normalize_rejects_unknown_pool():
    with pytest.raises(ValueError, match="pool"):
        pool_normalize(torch.zeros(1, 2, 4), torch.ones(1, 2, dtype=torch.uint8), "max")


def test_fused_wrappers_raise_instead_of_falling_back():
    """A wrapper given a non-CPU tensor it cannot launch on raises; it
    never runs the plain version for it."""
    y = torch.zeros((4, 16), device="meta", dtype=torch.bfloat16)
    p = torch.zeros(16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        bias_act(y, p, "gelu_tanh")
    with pytest.raises(ValueError, match="CUDA"):
        add_layer_norm(y, y, p, p, 1e-12)
    ids = torch.zeros((2, 4), device="meta", dtype=torch.int16)
    table = torch.zeros((8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        embed_ln(ids, None, table, table, None, p, p, 1e-12)
    with pytest.raises(ValueError, match="CUDA"):
        pool_normalize(y[None], torch.zeros((1, 4), device="meta", dtype=torch.uint8), "cls")
