"""The port's checkpoint loading, WordPiece and local HF tokenizers against
the JAX package's and ``transformers``', on the CPU.

A tiny ``BertModel`` and a ``BertForSequenceClassification`` are saved
by ``transformers`` into a temporary directory, as ``model.safetensors``
and as ``pytorch_model.bin``, beside a ``vocab.txt``; both packages load
them.  Tolerances: token ids exactly equal; the port's safetensors
reader bit-equal to ``safetensors.numpy``; embeddings and logits within
1e-4 of the JAX ``load_encoder`` forward in f32 (sums in another order);
in bf16, the port's encoder tolerance (``test_torch_encoder.py``): cosine
>= 0.999 per row and atol 2e-2 on embeddings, 2e-2 on logits.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax.numpy as jnp
import safetensors.numpy
import safetensors.torch
import torch
import transformers

from pathway_tpu.models import convert as jconvert
from pathway_tpu.models.tokenizer import HFTokenizer as JaxHFTokenizer
from pathway_tpu.models.tokenizer import get_tokenizer as jax_get_tokenizer
from pathway_tpu.models.wordpiece import WordPieceTokenizer as JaxWordPiece
from pathway_tpu.parallel import JittedEncoder
from pathway_tpu.xpacks.llm.embedders import TPUEncoderEmbedder
from pathway_tpu.xpacks.llm.rerankers import CrossEncoderReranker as JaxCrossEncoderReranker
from pathway_tpu_torch.models import (
    HashTokenizer,
    HFTokenizer,
    WordPieceTokenizer,
    config_from_hf,
    convert,
    get_tokenizer,
    load_encoder,
    load_vocab,
)
from pathway_tpu_torch.parallel import TorchEncoder
from pathway_tpu_torch.xpacks.llm.embedders import TorchEncoderEmbedder
from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = (
    "[PAD] [unused0] [UNK] [CLS] [SEP] [MASK] the quick brown fox jumps over "
    "lazy dog un ##aff ##able run ##ning , . ! ? ' \" - hello world stream "
    "##ing data ##flow 2 ##0 ##2 ##4 tpu gpu index ##es café"
).split()
SENTENCES = [
    "The quick brown fox jumps over the lazy dog!",
    "hello world, streaming dataflow",
    "unaffable running data 2024 tpu",
    "the the the",
    "gpu indexes: the stream",
]
TRICKY = SENTENCES + [
    "  double  spaces\tand\nnewlines ",
    "punct,punct.punct!end?",
    "ACCENTS: café résumé",
    "unknownword xyzzy",
    "",
    "##weird ## tokens",
    "中文 mixed 字",
]
F32_TOL = 1e-4
BF16_COS, BF16_ATOL = 0.999, 2e-2
_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: the tier-1 run has several test workers on the
    host's cores, and this file's small products gain little from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _save(model, d, safe: bool) -> str:
    model.save_pretrained(str(d), safe_serialization=safe)
    with open(os.path.join(d, "vocab.txt"), "w") as f:
        f.write("\n".join(VOCAB))
    return str(d)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """{kind: directory} for the bi- and cross-encoder, safetensors and bin."""
    shape = dict(
        vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=64, type_vocab_size=2, hidden_act="gelu",
    )
    torch.manual_seed(0)
    bert = transformers.BertModel(transformers.BertConfig(**shape)).eval()
    cls_cfg = transformers.BertConfig(**shape, num_labels=1)
    cls = transformers.BertForSequenceClassification(cls_cfg).eval()
    # the classifier's bias is zero at init: give it a value the loaders must carry
    with torch.no_grad():
        cls.classifier.bias.fill_(0.25)
    root = tmp_path_factory.mktemp("ckpt")
    out = {}
    for name, model in (("bert", bert), ("cls", cls)):
        for safe in (True, False):
            kind = f"{name}_{'st' if safe else 'bin'}"
            out[kind] = _save(model, root / kind, safe)
    return out


def test_wordpiece_ids_match_jax_and_transformers(ckpt):
    vocab = os.path.join(ckpt["bert_st"], "vocab.txt")
    hf = transformers.BertTokenizer(vocab)
    ours, jax_tok = WordPieceTokenizer(vocab), JaxWordPiece(vocab)
    assert load_vocab(vocab) == jax_tok.vocab
    for s in TRICKY:
        ids, mask, _ = ours.encode_batch([s], max_len=64, bucket_len=False)
        got = [int(i) for i in ids[0][: int(mask[0].sum())]]
        assert got == hf.encode(s, add_special_tokens=True), s
        assert ours.tokenize_ids(s) == jax_tok.tokenize_ids(s), s
    for max_len in (64, 12):
        for pair in (None, TRICKY[::-1]):
            want = jax_tok.encode_batch(TRICKY, max_len=max_len, pair=pair)
            got = ours.encode_batch(TRICKY, max_len=max_len, pair=pair)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    enc = hf("quick fox?", "the lazy dog runs over the fox.", truncation=True, max_length=16)
    ids, mask, tps = ours.encode_batch(["quick fox?"], pair=["the lazy dog runs over the fox."],
                                       max_len=16, bucket_len=False)
    n = int(mask[0].sum())
    assert [int(i) for i in ids[0][:n]] == enc["input_ids"]
    assert [int(i) for i in tps[0][:n]] == enc["token_type_ids"]
    assert ours.count_tokens(SENTENCES[0]) == jax_tok.count_tokens(SENTENCES[0])


def test_get_tokenizer_resolves_a_local_directory_as_jax_does(ckpt):
    """C2: a name that resolves locally gives the HF tokenizer and the JAX
    package's ids; an unknown name gives the hash tokenizer on both."""
    d = ckpt["bert_st"]
    tok, jtok = get_tokenizer(d), jax_get_tokenizer(d)
    assert isinstance(tok, HFTokenizer) and isinstance(jtok, JaxHFTokenizer)
    for pair in (None, SENTENCES[::-1]):
        for a, b in zip(tok.encode_batch(SENTENCES, pair=pair, max_len=32),
                        jtok.encode_batch(SENTENCES, pair=pair, max_len=32)):
            np.testing.assert_array_equal(a, b)
    wp = WordPieceTokenizer(os.path.join(d, "vocab.txt")).encode_batch(SENTENCES, max_len=32)
    np.testing.assert_array_equal(tok.encode_batch(SENTENCES, max_len=32)[0], wp[0])
    assert tok.count_tokens(SENTENCES[1]) == jtok.count_tokens(SENTENCES[1])
    assert isinstance(get_tokenizer("no-such-model-anywhere", 512), HashTokenizer)
    assert isinstance(get_tokenizer(None), HashTokenizer)


def test_get_tokenizer_skips_transformers_for_a_name_that_cannot_resolve(tmp_path):
    """A preset name with no directory and no hub-cache entry gives the
    hash tokenizer, as in the JAX package, without importing
    ``transformers``; a hub-cache entry of that name sends it to
    ``transformers`` again."""
    code = textwrap.dedent(f"""
        import json, os, sys
        os.environ["HF_HUB_CACHE"] = {str(tmp_path / "hub")!r}
        from pathway_tpu_torch.models.tokenizer import HashTokenizer, _may_resolve_locally, get_tokenizer
        out = [isinstance(get_tokenizer("bge-base", 512), HashTokenizer), "transformers" in sys.modules,
               _may_resolve_locally("BAAI/bge-base-en-v1.5")]
        os.makedirs(os.path.join({str(tmp_path / "hub")!r}, "models--BAAI--bge-base-en-v1.5"))
        out.append(_may_resolve_locally("BAAI/bge-base-en-v1.5"))
        print(json.dumps(out))
    """)
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "TRANSFORMERS_CACHE")}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, False, False, True]
    assert type(jax_get_tokenizer("bge-base", 512)).__name__ == "HashTokenizer"  # the JAX package's choice


def test_safetensors_reader_matches_the_package(ckpt, tmp_path):
    path = os.path.join(ckpt["bert_st"], "model.safetensors")
    ours, theirs = convert.load_safetensors(path), safetensors.numpy.load_file(path)
    assert sorted(ours) == sorted(theirs)
    for name, arr in theirs.items():
        assert ours[name].dtype == arr.dtype and ours[name].shape == arr.shape
        np.testing.assert_array_equal(ours[name], arr)
    # the writer, read back by the package; BF16 widened to f32 by the reader
    rng = np.random.default_rng(0)
    arrays = {"f32": rng.standard_normal((3, 5)).astype(np.float32),
              "f16": rng.standard_normal((7,)).astype(np.float16),
              "i64": np.arange(6, dtype=np.int64).reshape(2, 3), "scalar": np.float32(2.5)}
    convert.save_safetensors(str(tmp_path / "w.safetensors"), arrays)
    back = safetensors.numpy.load_file(str(tmp_path / "w.safetensors"))
    for name, arr in arrays.items():
        np.testing.assert_array_equal(back[name], arr)
        assert back[name].dtype == np.asarray(arr).dtype
    bf = torch.randn(4, 6).to(torch.bfloat16)
    safetensors.torch.save_file({"bf": bf}, str(tmp_path / "bf.safetensors"))
    np.testing.assert_array_equal(convert.load_safetensors(str(tmp_path / "bf.safetensors"))["bf"],
                                  bf.float().numpy())


@pytest.mark.parametrize("kind", ["bert_st", "bert_bin", "cls_st", "cls_bin"])
def test_state_dict_and_config_match_jax(ckpt, kind):
    d = ckpt[kind]
    ours, theirs = convert.load_state_dict(d), jconvert.load_state_dict(d)
    assert sorted(ours) == sorted(theirs)
    for name in theirs:
        np.testing.assert_array_equal(ours[name], theirs[name])
    cfg, jcfg = config_from_hf(d), jconvert.config_from_hf(d)
    for f in ("vocab_size", "hidden", "layers", "heads", "mlp_dim", "max_len", "type_vocab",
              "ln_eps", "gelu_approx", "pool", "num_labels"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.num_labels == (1 if kind.startswith("cls") else 0)


def _compare(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=F32_TOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL)
        if got.ndim == 2:
            cos = (got * want).sum(1) / np.linalg.norm(got, axis=1) / np.linalg.norm(want, axis=1)
            assert cos.min() >= BF16_COS


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind,pool", [("bert_st", "mean"), ("bert_bin", "cls"), ("cls_st", None),
                                       ("cls_bin", None)])
def test_load_encoder_forward_matches_jax(ckpt, kind, pool, dtype):
    """Embeddings (bi-encoder) and logits (cross-encoder) of the port's
    ``load_encoder`` against the JAX package's on the same ids."""
    d = ckpt[kind]
    jd, td = _DT[dtype]
    model, sd, tok = load_encoder(d, pool=pool, dtype=td, device="cpu")
    jmodel, params, jtok = jconvert.load_encoder(d, pool=pool, dtype=jd)
    assert isinstance(tok, WordPieceTokenizer) and isinstance(jtok, JaxWordPiece)
    pair = SENTENCES[::-1] if kind.startswith("cls") else None
    ids, mask, tps = tok.encode_batch(SENTENCES, pair=pair, max_len=64)
    want = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(tps))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(tps))
    _compare(got.float().numpy(), np.asarray(want, np.float32), dtype)
    assert sorted(sd) == sorted(model.state_dict())


def test_f32_checkpoint_matches_transformers(ckpt):
    """The loaded bi-encoder's CLS embedding against ``transformers``'s own
    forward of the saved model (f32, cosine >= 0.9999)."""
    d = ckpt["bert_st"]
    model, _, tok = load_encoder(d, pool="cls", dtype=torch.float32, device="cpu")
    ids, mask, tps = tok.encode_batch(SENTENCES, max_len=64)
    hf = transformers.BertModel.from_pretrained(d).eval()
    with torch.inference_mode():
        ref = hf(input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask).long(),
                 token_type_ids=torch.from_numpy(tps).long()).last_hidden_state[:, 0]
        ref = torch.nn.functional.normalize(ref, dim=-1)
        got = model(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(tps))
    assert (got * ref).sum(1).min().item() >= 0.9999


@pytest.mark.parametrize("cross", [False, True])
def test_executor_checkpoint_dir_matches_jax(ckpt, cross):
    d = ckpt["cls_st" if cross else "bert_st"]
    jenc = JittedEncoder(None, cross=cross, checkpoint_dir=d, max_batch=4)
    tenc = TorchEncoder(None, cross=cross, checkpoint_dir=d, max_batch=4, device="cpu")
    assert isinstance(tenc.tokenizer, WordPieceTokenizer)
    assert tenc.config.normalize is (not cross) and tenc.config.num_labels == int(cross)
    assert tenc.config.pool == jenc.config.pool
    if cross:
        _compare(tenc.score_pairs(SENTENCES, SENTENCES[::-1]), jenc.score_pairs(SENTENCES, SENTENCES[::-1]),
                 "bf16")
    else:
        _compare(tenc.encode(SENTENCES), jenc.encode(SENTENCES), "bf16")
    # an explicit config overrides only the pooling and the activation type
    jcfg = dataclasses.replace(jconvert.config_from_hf(d), pool="cls", dtype=jnp.float32, layers=1)
    tcfg = dataclasses.replace(config_from_hf(d), pool="cls", dtype=torch.float32, layers=1)
    jenc = JittedEncoder(jcfg, cross=cross, checkpoint_dir=d)
    tenc = TorchEncoder(tcfg, cross=cross, checkpoint_dir=d, device="cpu")
    assert (tenc.config.pool, tenc.config.dtype, tenc.config.layers) == ("cls", torch.float32, 2)
    if cross:
        _compare(tenc.score_pairs(SENTENCES, SENTENCES), jenc.score_pairs(SENTENCES, SENTENCES), "f32")
    else:
        _compare(tenc.encode(SENTENCES), jenc.encode(SENTENCES), "f32")
    with pytest.raises(ValueError, match="params"):
        TorchEncoder(None, checkpoint_dir=d, params={"params": {}}, device="cpu")
    with pytest.raises(ValueError, match="config"):
        TorchEncoder(None, device="cpu")


def test_embedder_and_reranker_load_a_checkpoint_directory(ckpt, tmp_path):
    """C1: a directory as the model name loads the checkpoint, as the JAX
    embedder and reranker do; a directory without ``config.json`` raises
    as theirs do."""
    d = ckpt["bert_st"]
    emb = TorchEncoderEmbedder(d, max_batch_size=4, device="cpu")
    jemb = TPUEncoderEmbedder(d, max_batch_size=4)
    assert emb.get_embedding_dimension() == jemb.get_embedding_dimension() == 32
    _compare(np.stack(emb.__batch__(SENTENCES)), np.stack(jemb.__batch__(SENTENCES)), "bf16")
    model, _, tok = load_encoder(d, device="cpu")
    ids, mask, tps = tok.encode_batch(SENTENCES[:1])
    with torch.inference_mode():
        direct = model(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(tps))[0]
    np.testing.assert_allclose(emb.__wrapped__(SENTENCES[0]), direct.numpy(), atol=1e-6)

    rd = ckpt["cls_bin"]
    rer, jrer = CrossEncoderReranker(rd, device="cpu"), JaxCrossEncoderReranker(rd)
    docs = [{"text": s} for s in SENTENCES]
    _compare(rer.__batch__(docs, SENTENCES[::-1]), jrer.__batch__(docs, SENTENCES[::-1]), "bf16")

    empty = tmp_path / "empty"
    empty.mkdir()
    for build in (lambda: TPUEncoderEmbedder(str(empty)), lambda: JaxCrossEncoderReranker(str(empty)),
                  lambda: TorchEncoderEmbedder(str(empty), device="cpu"),
                  lambda: CrossEncoderReranker(str(empty), device="cpu")):
        with pytest.raises(FileNotFoundError):
            build()
