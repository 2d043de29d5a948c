"""The port's encoder against the JAX package's, on the CPU.

Both run the same weights: the flax ``TextEncoderModel.init`` parameters
of the tiny flagship config go through
``pathway_tpu_torch.models.state_dict_from_flax`` into the port.
Tolerances: f32 atol 1e-4 on the pooled embeddings; bf16 activations
cosine >= 0.999 per row and atol 2e-2 (the two libraries round bf16 at
slightly different places inside GELU and the bias adds).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import __graft_entry__ as graft
from pathway_tpu.models import TextEncoderModel as JaxEncoder
from pathway_tpu_torch.kernels import attention, attention_plain
from pathway_tpu_torch.models import (
    BGE_BASE,
    BGE_LARGE,
    BGE_SMALL,
    E5_BASE,
    MINILM_L6,
    EncoderConfig,
    TextEncoderModel,
    state_dict_from_flax,
)

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def port_config(jcfg) -> EncoderConfig:
    """The port's EncoderConfig with the same fields as a JAX one."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(EncoderConfig)}
    fields["dtype"] = _DTYPES[jcfg.dtype]
    fields["param_dtype"] = _DTYPES[jcfg.param_dtype]
    return EncoderConfig(**fields)


def ragged_batch(vocab: int, B: int = 5, L: int = 16, seed: int = 0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1000, vocab, (B, L)).astype(np.int32)
    lens = np.array([L, 3, 9, 1, 12])[:B]
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    types = (np.arange(L)[None] >= lens[:, None] // 2).astype(np.int32) * mask
    return ids, mask, types


def both_encoders(jcfg, ids, mask):
    jm = JaxEncoder(jcfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))
    cfg = port_config(jcfg)
    tm = TextEncoderModel(cfg, device="cpu")
    tm.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params), cfg))
    return jm, params, tm


def run_both(jcfg, with_types=False):
    ids, mask, types = ragged_batch(jcfg.vocab_size)
    jm, params, tm = both_encoders(jcfg, ids, mask)
    jt = jnp.asarray(types) if with_types else None
    want = np.asarray(jm.apply(params, jnp.asarray(ids), jnp.asarray(mask), jt))
    with torch.no_grad():
        tt = torch.from_numpy(types) if with_types else None
        got = tm(torch.from_numpy(ids), torch.from_numpy(mask), tt).numpy()
    return got, want


@pytest.mark.parametrize("pool", ["cls", "mean"])
@pytest.mark.parametrize("gelu_approx", [True, False])
def test_pooled_embeddings_match_jax_f32(pool, gelu_approx):
    jcfg = dataclasses.replace(graft._flagship_config(tiny=True), pool=pool, gelu_approx=gelu_approx)
    got, want = run_both(jcfg)
    assert got.dtype == np.float32 and got.shape == (5, jcfg.hidden)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("pool", ["cls", "mean"])
@pytest.mark.parametrize("gelu_approx", [True, False])
def test_pooled_embeddings_match_jax_bf16(pool, gelu_approx):
    jcfg = dataclasses.replace(
        graft._flagship_config(tiny=True), pool=pool, gelu_approx=gelu_approx, dtype=jnp.bfloat16
    )
    got, want = run_both(jcfg)
    cos = (got * want).sum(1) / np.linalg.norm(got, axis=1) / np.linalg.norm(want, axis=1)
    assert cos.min() >= 0.999
    np.testing.assert_allclose(got, want, atol=2e-2)


def test_type_ids_and_unnormalized_output_match_jax():
    jcfg = dataclasses.replace(graft._flagship_config(tiny=True), normalize=False)
    got, want = run_both(jcfg, with_types=True)
    assert not np.allclose(np.linalg.norm(got, axis=1), 1.0)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_state_dict_covers_every_parameter():
    jcfg = graft._flagship_config(tiny=True)
    ids, mask, _ = ragged_batch(jcfg.vocab_size)
    _, params, tm = both_encoders(jcfg, ids, mask)
    sd = state_dict_from_flax(params, port_config(jcfg))
    assert set(sd) == set(tm.state_dict())
    assert all(sd[k].shape == v.shape for k, v in tm.state_dict().items())


def test_narrow_int16_ids_give_the_same_embedding():
    jcfg = graft._flagship_config(tiny=True)
    ids, mask, _ = ragged_batch(jcfg.vocab_size)
    _, _, tm = both_encoders(jcfg, ids, mask)
    with torch.no_grad():
        wide = tm(torch.from_numpy(ids), torch.from_numpy(mask))
        narrow = tm(torch.from_numpy(ids.astype(np.int16)), torch.from_numpy(mask.astype(np.uint8)))
    torch.testing.assert_close(wide, narrow, rtol=0, atol=0)


def _jax_attention(q, k, v, mask, dtype):
    """``SelfAttention.__call__`` core, pathway_tpu/models/encoder.py:113-117."""
    q, k, v = (jnp.asarray(a, dtype) for a in (q, k, v))
    scale = 1.0 / jnp.sqrt(jnp.float32(q.shape[-1]))
    logits = jnp.einsum("blhd,bmhd->bhlm", q, k).astype(jnp.float32) * scale
    bias = jnp.where(jnp.asarray(mask).astype(bool)[:, None, None, :], 0.0, -1e30)
    probs = jax.nn.softmax(logits + bias, axis=-1).astype(dtype)
    return np.asarray(jnp.einsum("bhlm,bmhd->blhd", probs, v).astype(jnp.float32))


@pytest.mark.parametrize(
    "dtype,atol", [(jnp.float32, 1e-5), (jnp.bfloat16, 2e-2)], ids=["f32", "bf16"]
)
@pytest.mark.parametrize("D", [32, 64])
def test_attention_plain_matches_jax_math(dtype, atol, D):
    rng = np.random.default_rng(D)
    B, L, H = 3, 16, 2
    q, k, v = (rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(3))
    mask = (np.arange(L)[None] < np.array([16, 5, 1])[:, None]).astype(np.uint8)
    want = _jax_attention(q, k, v, mask, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(_DTYPES[dtype]) for a in (q, k, v))
    got = attention_plain(tq, tk, tv, torch.from_numpy(mask)).float().numpy()
    np.testing.assert_allclose(got, want, atol=atol)
    # on CPU tensors the wrapper is the plain version
    torch.testing.assert_close(attention(tq, tk, tv, torch.from_numpy(mask)).float(), torch.from_numpy(got))


def _holes_mask(L):
    """Rows of [4, L]: every key; none (a fully masked row); a run in the
    first 64-key tile and one in the last, with fully masked tiles between
    (holes); only the last key."""
    mask = np.zeros((4, L), np.uint8)
    mask[0] = 1
    mask[2, 5:40] = 1
    mask[2, L - 20:L - 3] = 1
    mask[3, L - 1] = 1
    return mask


@pytest.mark.parametrize(
    "dtype,atol", [(jnp.float32, 1e-5), (jnp.bfloat16, 2e-2)], ids=["f32", "bf16"]
)
@pytest.mark.parametrize("D", [16, 32, 64])
@pytest.mark.parametrize("L", [100, 196])
def test_attention_plain_matches_jax_with_holes_and_empty_rows(dtype, atol, D, L):
    rng = np.random.default_rng(L + D)
    q, k, v = (rng.standard_normal((4, L, 2, D)).astype(np.float32) for _ in range(3))
    mask = _holes_mask(L)
    want = _jax_attention(q, k, v, mask, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(_DTYPES[dtype]) for a in (q, k, v))
    got = attention_plain(tq, tk, tv, torch.from_numpy(mask)).float().numpy()
    np.testing.assert_allclose(got, want, atol=atol)
    # the fully masked row attends uniformly over all L keys
    mean = tv[1].float().mean(0).numpy()
    np.testing.assert_allclose(got[1], np.broadcast_to(mean, got[1].shape), atol=atol)


def test_fully_masked_row_attends_uniformly_like_jax():
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((1, 8, 1, 32)).astype(np.float32) for _ in range(3))
    mask = np.zeros((1, 8), np.uint8)
    want = _jax_attention(q, k, v, mask, jnp.float32)
    got = attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy()[0, 0, 0], v[0, :, 0].mean(0), atol=1e-5)


def test_presets_match_jax():
    from pathway_tpu.models import encoder as jenc

    for name, cfg in [("MINILM_L6", MINILM_L6), ("BGE_SMALL", BGE_SMALL), ("BGE_BASE", BGE_BASE),
                      ("BGE_LARGE", BGE_LARGE), ("E5_BASE", E5_BASE)]:
        assert port_config(getattr(jenc, name)) == cfg, name


def test_seeded_init_is_deterministic():
    cfg = port_config(graft._flagship_config(tiny=True))
    a = TextEncoderModel(cfg, device="cpu", seed=3).state_dict()
    b = TextEncoderModel(cfg, device="cpu", seed=3).state_dict()
    c = TextEncoderModel(cfg, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layer_0.mlp_up.weight"], c["layer_0.mlp_up.weight"])


# ---------------------------------------------------------------------------
# C6: K1 takes any length up to 524,288 and any head dim that is a
# multiple of 8 up to 128 (the checks are device-independent)


@pytest.mark.parametrize("shape", [(2, 576, 12, 64), (1, 8192, 12, 64), (2, 16, 4, 128), (2, 16, 4, 80),
                                   (2, 16, 4, 96), (1, 1 << 19, 1, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_check_attention_takes_long_sequences_and_wide_heads(shape, dtype):
    from pathway_tpu_torch.kernels.attention import check_attention

    q = torch.empty(shape, dtype=dtype, device="meta")
    check_attention(q, q, q, torch.empty(shape[:2], dtype=torch.uint8, device="meta"))


@pytest.mark.parametrize("D", [136, 20])
def test_check_attention_names_the_head_dim_limit(D):
    from pathway_tpu_torch.kernels.attention import check_attention

    q = torch.empty((1, 16, 2, D), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="multiple of 8 up to 128"):
        check_attention(q, q, q, torch.empty((1, 16), dtype=torch.uint8, device="meta"))


def test_encoder_at_max_len_1024_matches_jax_on_a_700_token_row():
    # a checkpoint with more than 512 positions, no sequence mesh: K1 takes
    # the whole row (f32, 1e-5)
    jcfg = dataclasses.replace(graft._flagship_config(tiny=True), max_len=1024)
    rng = np.random.default_rng(0)
    L = 700
    ids = rng.integers(1000, jcfg.vocab_size, (3, L)).astype(np.int32)
    mask = (np.arange(L)[None] < np.array([L, 600, 17])[:, None]).astype(np.int32)
    jm, params, tm = both_encoders(jcfg, ids, mask)
    want = np.asarray(jm.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
