"""The port's rerank path against the JAX package's, on the CPU.

The tiny ``BGE_RERANKER_BASE`` variant of ``tests/test_xpack_llm.py``
(2 layers, hidden 64, f32) runs the same flax ``CrossEncoderModel``
parameters on both sides: the JAX ``JittedEncoder(cross=True)`` makes
them, ``state_dict_from_flax`` carries them into the port.  Tolerances:
f32 atol 1e-4 on the scores (the encoder tolerance of
``tests/test_torch_encoder.py``); bf16 atol 2e-2 with rtol 2**-6 (two
bf16 ulps), the bf16 encoder tolerance.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import chip_smoke
from pathway_tpu.models import BGE_RERANKER_BASE as JAX_RERANKER
from pathway_tpu.models import CrossEncoderModel as JaxCross
from pathway_tpu.parallel import JittedEncoder
from pathway_tpu.parallel import ShardedKnnIndex as JaxIndex
from pathway_tpu.xpacks.llm import rerankers as jrr
from pathway_tpu.xpacks.llm.embedders import TPUEncoderEmbedder
from pathway_tpu_torch import kernels
from pathway_tpu_torch.models import (
    BGE_RERANKER_BASE,
    CrossEncoderModel,
    TextEncoderModel,
    state_dict_from_flax,
)
from pathway_tpu_torch.parallel import ShardedKnnIndex, TorchEncoder
from pathway_tpu_torch.xpacks.llm.embedders import TorchEncoderEmbedder
from pathway_tpu_torch.xpacks.llm.rerankers import (
    CrossEncoderReranker,
    EncoderReranker,
    rerank_topk_filter,
)
from test_torch_encoder import port_config, ragged_batch

TINY = dataclasses.replace(JAX_RERANKER, layers=2, hidden=64, heads=4, mlp_dim=128, dtype=jnp.float32)
TINY_BI = dataclasses.replace(TINY, num_labels=0, pool="mean", normalize=True)
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: the tier-1 run has several test workers on the
    host's cores, and this file's small products gain little from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _texts(n, seed, lo=3, hi=40):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(300)] + ["stream", "index", "gpu", "rag"]
    return [" ".join(rng.choice(words, rng.integers(lo, hi))) for _ in range(n)]


def _params(encoder) -> dict:
    return jax.tree.map(np.asarray, encoder.params)


@pytest.fixture(scope="module")
def cross_pair():
    jenc = JittedEncoder(TINY, cross=True, max_batch=16, seed=0)
    tenc = TorchEncoder(port_config(TINY), cross=True, max_batch=16, params=_params(jenc), device="cpu")
    return jenc, tenc


@pytest.fixture(scope="module")
def bi_pair():
    jenc = JittedEncoder(TINY_BI, max_batch=16, seed=1)
    tenc = TorchEncoder(port_config(TINY_BI), max_batch=16, params=_params(jenc), device="cpu")
    return jenc, tenc


def _run_cross(jcfg, num_labels=None):
    if num_labels is not None:
        jcfg = dataclasses.replace(jcfg, num_labels=num_labels)
    ids, mask, types = ragged_batch(jcfg.vocab_size)
    jm = JaxCross(jcfg)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(ids), jnp.asarray(mask))
    want = np.asarray(jm.apply(params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types)))
    cfg = port_config(jcfg)
    tm = CrossEncoderModel(cfg, device="cpu")
    tm.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params), cfg))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (ids, mask, types))).numpy()
    return got, want


def test_cross_encoder_matches_jax_f32():
    got, want = _run_cross(TINY)
    assert got.shape == (5,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL)


def test_cross_encoder_matches_jax_bf16():
    got, want = _run_cross(dataclasses.replace(TINY, dtype=jnp.bfloat16))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2.0**-6)


def test_cross_encoder_with_several_labels_matches_jax():
    got, want = _run_cross(TINY, num_labels=3)
    assert got.shape == (5, 3)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_cross_state_dict_covers_every_parameter(cross_pair):
    jenc, tenc = cross_pair
    sd = state_dict_from_flax(_params(jenc), tenc.config, cross=True)
    assert set(sd) == set(tenc.model.state_dict())
    assert sd["classifier.weight"].shape == (1, 64) and sd["pooler.weight"].shape == (64, 64)
    # the config's num_labels picks the head by default; the bi-encoder
    # tree has no pooler/classifier and needs none
    assert "pooler.weight" in state_dict_from_flax(_params(jenc), port_config(TINY))
    assert "pooler.weight" not in state_dict_from_flax(_params(jenc), port_config(TINY_BI))


def test_reranker_preset_matches_jax():
    assert port_config(JAX_RERANKER) == BGE_RERANKER_BASE
    assert (BGE_RERANKER_BASE.hidden, BGE_RERANKER_BASE.layers, BGE_RERANKER_BASE.num_labels) == (768, 12, 1)
    assert BGE_RERANKER_BASE.pool == "cls" and not BGE_RERANKER_BASE.normalize


def test_score_pairs_matches_jax(cross_pair):
    jenc, tenc = cross_pair
    queries = _texts(37, 4, 2, 12)  # three chunks of 16, the last one padded
    docs = _texts(37, 5, 20, 600)  # some truncated to the pair budget
    got = tenc.score_pairs(queries, docs)
    assert got.shape == (37,) and got.dtype == np.float32
    np.testing.assert_allclose(got, jenc.score_pairs(queries, docs), atol=TOL)
    assert tenc.score_pairs([], []).shape == (0,)
    with pytest.raises(ValueError, match="align"):
        tenc.score_pairs(["q"], [])


def test_score_pairs_puts_the_query_first(cross_pair):
    _, tenc = cross_pair
    q, d = "short question", "a much longer passage " * 5
    assert abs(tenc.score_pairs([q], [d])[0] - tenc.score_pairs([d], [q])[0]) > 1e-6


def test_wrong_executor_kind_raises(cross_pair, bi_pair):
    _, cross = cross_pair
    _, bi = bi_pair
    with pytest.raises(TypeError, match="score_pairs"):
        cross.encode(["x"])
    with pytest.raises(TypeError, match="score_pairs"):
        cross.encode_into(ShardedKnnIndex(64, capacity=8, device="cpu"), ["k"], ["x"])
    with pytest.raises(TypeError, match="encode"):
        bi.score_pairs(["q"], ["d"])


def test_rerank_topk_filter_matches_jax():
    rng = np.random.default_rng(0)
    docs = [{"text": f"d{i}"} for i in range(12)]
    for scores in (rng.standard_normal(12).tolist(), [0.1, 0.9, 0.5, 0.3, 0.8] + [0.0] * 7):
        for k in (1, 3, 5, 20):
            assert rerank_topk_filter.__wrapped_fun__(docs, scores, k) == jrr.rerank_topk_filter.__wrapped_fun__(docs, scores, k)


def test_cross_encoder_reranker_matches_jax(cross_pair):
    jenc, _ = cross_pair
    params = _params(jenc)
    jr = jrr.CrossEncoderReranker(config=TINY, params=params, max_batch_size=8)
    tr = CrossEncoderReranker(config=port_config(TINY), params=params, max_batch_size=8, device="cpu")
    docs = [{"text": t} for t in _texts(11, 6, 10, 80)] + ["a plain string doc"]
    queries = _texts(12, 7, 2, 10)
    got = tr.__batch__(docs, queries)
    assert len(got) == 12 and all(isinstance(s, float) for s in got)
    np.testing.assert_allclose(got, jr.__batch__(docs, queries), atol=TOL)
    assert tr.__wrapped__(docs[0], queries[0]) == pytest.approx(got[0], abs=1e-6)


def test_encoder_reranker_matches_jax(bi_pair):
    jenc, _ = bi_pair
    params = _params(jenc)
    jr = jrr.EncoderReranker(embedder=TPUEncoderEmbedder(config=TINY_BI, params=params))
    tr = EncoderReranker(embedder=TorchEncoderEmbedder(config=port_config(TINY_BI), params=params, device="cpu"))
    docs = [{"text": t} for t in _texts(6, 8)]
    queries = _texts(6, 9, 2, 10)
    np.testing.assert_allclose(tr.__batch__(docs, queries), jr.__batch__(docs, queries), atol=TOL)


def test_reranker_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    for build in (lambda: CrossEncoderReranker(config=port_config(TINY)),
                  lambda: TorchEncoder(port_config(TINY), cross=True),
                  lambda: EncoderReranker(model_name="all-MiniLM-L6-v2")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_retrieve_rerank_slice_matches_jax(cross_pair, bi_pair):
    """200 documents indexed, 4 questions retrieve 8 each, reranked, 3 kept:
    the same keys in the same order on both packages."""
    jbi, tbi = bi_pair
    jcross, tcross = cross_pair
    docs = _texts(200, 10, 8, 60)
    keys = [f"doc{i}" for i in range(200)]
    text_of = dict(zip(keys, docs))
    rng = np.random.default_rng(11)
    questions = [" ".join(rng.choice(docs[i].split(), 6)) for i in (3, 50, 120, 199)]

    def run(bi, cross, index):
        bi.encode_into(index, keys, docs)
        kept = []
        for q, hits in zip(questions, index.search(bi.encode(questions), 8)):
            cands = [key for key, _ in hits]
            scores = cross.score_pairs([q] * len(cands), [text_of[c] for c in cands])
            kept.append(rerank_topk_filter.__wrapped_fun__(cands, scores.tolist(), 3))
        return kept

    want = run(jbi, jcross, JaxIndex(64, metric="cos", capacity=256))
    got = run(tbi, tcross, ShardedKnnIndex(64, metric="cos", capacity=256, device="cpu"))
    for (gk, gs), (wk, ws) in zip(got, want):
        assert gk == wk and len(gk) == 3
        np.testing.assert_allclose(gs, ws, atol=TOL)


@pytest.mark.parametrize("cross", [False, True], ids=["bi", "cross"])
@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_plain_reference_forward_is_the_model_on_cpu(cross, pool):
    """``chip_smoke.plain_forward`` (the card's plain-only reference) is the
    model's own forward wherever the wrappers run their plain versions."""
    cfg = dataclasses.replace(port_config(TINY if cross else TINY_BI), pool=pool, dtype=torch.bfloat16)
    model = (CrossEncoderModel if cross else TextEncoderModel)(cfg, device="cpu", seed=3)
    ids, mask, types = (torch.from_numpy(a) for a in ragged_batch(cfg.vocab_size))
    before = kernels.launch_counts()
    with torch.no_grad():
        want = model(ids.to(torch.int16), mask, types.to(torch.uint8))
        got = chip_smoke.plain_forward(model, ids.to(torch.int16), mask.to(torch.uint8), types.to(torch.uint8))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert kernels.launch_counts() == before
