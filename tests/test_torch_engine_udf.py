"""The text embedder as a UDF inside a pipeline: the port's
``TorchEncoderEmbedder`` (``device="cpu"``) against the JAX package's
``TPUEncoderEmbedder`` on the flagship tiny config with the same flax
parameters, each applied to a column by its own package's engine.

The embeddings are compared per id at the bf16 tolerance that
``tests/test_torch_checkpoint.py`` uses for this pair (``_compare``: atol
2e-2 and cosine >= 0.999 a row; the two libraries round bf16 at other
places), at a ``max_batch_size`` above the table's size and at one below
it, where the engine hands the UDF several chunks.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import torch

import __graft_entry__ as graft
import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.parallel import JittedEncoder
from pathway_tpu.xpacks.llm.embedders import TPUEncoderEmbedder
from pathway_tpu_torch import kernels
from pathway_tpu_torch.xpacks.llm.embedders import BaseEmbedder, TorchEncoderEmbedder
from test_torch_checkpoint import _compare
from test_torch_encoder import port_config

DOCS = [
    "the quick brown fox",
    "jumps over the lazy dog",
    "",
    "retrieval augmented generation keeps a live index",
    "alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu",
    "x",
    "documents change while questions arrive",
    "a b c d e f g",
    "the quick brown fox",
    "tpu and gpu",
    "one more line of text for the encoder",
]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: the tier-1 run has several test workers on the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_port_graph():
    """Reset the port's global graph around each test (``tests/conftest.py``
    resets the JAX package's)."""
    tpw.G.clear()
    yield
    tpw.G.clear()


@pytest.fixture(scope="module")
def params():
    jcfg = graft._flagship_config(tiny=True)
    return jcfg, jax.tree.map(np.asarray, JittedEncoder(jcfg).params)


def embed_in_pipeline(pw, embedder) -> dict:
    """``docs.select(emb=embedder(text))`` through ``pw.debug``: id -> row."""
    pw.G.clear()
    docs = pw.debug.table_from_rows(pw.schema_from_types(text=str), [(d,) for d in DOCS])
    keys, cols = pw.debug.table_to_dicts(docs.select(docs.text, emb=embedder(docs.text)))
    pw.G.clear()
    assert len(keys) == len(DOCS)
    return {int(k): np.asarray(cols["emb"][k], np.float32) for k in keys}


@pytest.mark.parametrize("max_batch_size", [64, 4], ids=["one_chunk", "three_chunks"])
def test_embedder_udf_matches_jax_in_a_pipeline(params, max_batch_size):
    jcfg, flax_params = params
    jemb = TPUEncoderEmbedder(config=jcfg, params=flax_params, max_batch_size=max_batch_size)
    temb = TorchEncoderEmbedder(config=port_config(jcfg), params=flax_params, max_batch_size=max_batch_size,
                                device="cpu")
    assert isinstance(temb, tpw.UDF) and isinstance(temb, BaseEmbedder)
    assert temb.max_batch_size == max_batch_size
    before = dict(kernels.launch_counts())
    want = embed_in_pipeline(jpw, jemb)
    got = embed_in_pipeline(tpw, temb)
    assert got.keys() == want.keys()
    ids = sorted(want)
    _compare(np.stack([got[i] for i in ids]), np.stack([want[i] for i in ids]), "bf16")
    assert dict(kernels.launch_counts()) == before  # CPU tensors: the plain versions only


def test_embedder_udf_chunks_give_the_table_whole(params):
    """A ``max_batch_size`` below the table's size: the engine calls the
    UDF once a chunk, and the rows equal the one-chunk run's."""
    jcfg, flax_params = params
    seen: list[int] = []

    class Counting(TorchEncoderEmbedder):
        def __batch__(self, texts):
            seen.append(len(texts))
            return super().__batch__(texts)

    cfg = port_config(jcfg)
    whole = embed_in_pipeline(tpw, TorchEncoderEmbedder(config=cfg, params=flax_params, max_batch_size=64,
                                                        device="cpu"))
    chunked = embed_in_pipeline(tpw, Counting(config=cfg, params=flax_params, max_batch_size=4, device="cpu"))
    assert sorted(seen) == [3, 4, 4]
    ids = sorted(whole)
    _compare(np.stack([chunked[i] for i in ids]), np.stack([whole[i] for i in ids]), "bf16")


def test_embedder_udf_defaults_to_cuda(params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    jcfg, flax_params = params
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchEncoderEmbedder(config=port_config(jcfg), params=flax_params)
