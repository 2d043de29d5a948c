"""The cross-encoder's head (B8, ``kernels.cross_head``) and K18's loss form
(``kernels.contrastive_loss`` / ``contrastive_loss_bwd``), on the CPU.

- The head's plain version against the JAX ``CrossEncoderModel``'s head
  (``pathway_tpu/models/encoder.py:222-231``: the ``pooler`` Dense in the
  activation type, ``jnp.tanh``, the ``classifier`` Dense in f32) on the
  same CLS rows and parameters: f32 within 1e-5, bf16 within 2e-2 (the bf16
  encoder tolerance: the two libraries round the bf16 product's sum in
  other orders), 1 and 3 labels, B in {1, 32, 33}.
- ``CrossEncoderModel.forward`` runs the head through ``cross_head`` on the
  strided CLS view outside training, and through K4's Function where a
  gradient is asked for.
- The loss form's plain loss and ``d emb`` against ``jax.value_and_grad``
  of ``loss_fn`` (``__graft_entry__.py:117-124``) over the embeddings:
  B in {2, 64, 130}, f32 within 1e-5; ``ContrastiveLossFunction`` in f64
  against ``torch.autograd.gradcheck``.
- The device-independent argument checks (``check_cross_head``,
  ``check_contrastive_loss``) take what the kernels take and refuse the
  rest.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax
import torch

import importlib

from pathway_tpu_torch.kernels.contrastive_loss import (
    ContrastiveLossFunction,
    check_contrastive_loss,
    contrastive_loss_bwd_plain,
    contrastive_loss_fwd_plain,
    contrastive_loss_plain,
    in_batch_loss,
)
from pathway_tpu_torch.kernels.cross_head import check_cross_head, cross_head, cross_head_plain
from pathway_tpu_torch.models import CrossEncoderModel, EncoderConfig
from pathway_tpu_torch.models import encoder as encoder_mod

# the modules (the package attributes of these names are the wrappers)
k18 = importlib.import_module("pathway_tpu_torch.kernels.contrastive_loss")
b8 = importlib.import_module("pathway_tpu_torch.kernels.cross_head")

F32_ATOL = 1e-5  # the f32 tolerance of the port's parity tests
BF16_ATOL = 2e-2  # the bf16 encoder tolerance
H = 64


def jax_head(cls: np.ndarray, params: dict, dtype, labels: int) -> np.ndarray:
    """The head of the JAX package's ``CrossEncoderModel.__call__``
    (``encoder.py:222-231``), as it is there, on the CLS rows."""
    x = jnp.asarray(cls).astype(dtype)
    h = nn.Dense(H, dtype=dtype, param_dtype=jnp.float32).apply({"params": params["pooler"]}, x)
    h = jnp.tanh(h)
    logits = nn.Dense(labels, dtype=jnp.float32, param_dtype=jnp.float32).apply({"params": params["classifier"]}, h)
    return np.asarray(logits, np.float32)


def head_inputs(B: int, labels: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    cls = rng.standard_normal((B, H)).astype(np.float32)
    wp = (rng.standard_normal((H, H)) * 0.1).astype(np.float32)  # [out, in], as torch keeps it
    bp = (rng.standard_normal(H) * 0.5).astype(np.float32)
    wc = (rng.standard_normal((labels, H)) * 0.1).astype(np.float32)
    bc = rng.standard_normal(labels).astype(np.float32)
    params = {"pooler": {"kernel": wp.T, "bias": bp}, "classifier": {"kernel": wc.T, "bias": bc}}
    return cls, (wp, bp, wc, bc), params


def tiny_cross(dtype) -> CrossEncoderModel:
    cfg = EncoderConfig(vocab_size=500, hidden=H, layers=2, heads=4, mlp_dim=128, num_labels=3, pool="cls",
                        normalize=False, dtype=dtype)
    return CrossEncoderModel(cfg, device="cpu", seed=1)


def tiny_batch():
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 500, (4, 12)).astype(np.int32))
    return ids, torch.ones((4, 12), dtype=torch.int32)


@pytest.mark.parametrize("labels", [1, 3])
@pytest.mark.parametrize("B", [1, 32, 33])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_head_plain_matches_jax_head(dtype, B, labels):
    cls, (wp, bp, wc, bc), params = head_inputs(B, labels, seed=B + labels)
    tdt, jdt, atol = ((torch.float32, jnp.float32, F32_ATOL) if dtype == "f32"
                      else (torch.bfloat16, jnp.bfloat16, BF16_ATOL))
    # the CLS rows as the model hands them over: a strided view of [B, L, H]
    hidden = torch.zeros((B, 5, H), dtype=tdt)
    hidden[:, 0] = torch.from_numpy(cls).to(tdt)
    x = hidden[:, 0]
    got = cross_head(x, *(torch.from_numpy(a) for a in (wp, bp, wc, bc)))
    want = jax_head(cls, params, jdt, labels)
    assert got.dtype == torch.float32 and got.shape == (B, labels)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_head_plain_is_the_chain_it_replaces():
    """``cross_head_plain`` is the five-step chain the model ran before:
    the pooler's product in the activation type, K4's plain bias + tanh,
    h.float(), the classifier in f32 (bit for bit)."""
    cls, (wp, bp, wc, bc), _ = head_inputs(33, 3, seed=7)
    x = torch.from_numpy(cls).to(torch.bfloat16)
    p = [torch.from_numpy(a) for a in (wp, bp, wc, bc)]
    h = torch.nn.functional.linear(x, p[0].to(torch.bfloat16)) + p[1].to(torch.bfloat16)
    h = torch.tanh(h.float()).to(torch.bfloat16)
    want = torch.nn.functional.linear(h.float(), p[2], p[3])
    assert torch.equal(cross_head_plain(x, *p), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_encoder_forward_takes_the_head_kernel_outside_training(monkeypatch, dtype):
    model = tiny_cross(dtype).eval()
    ids, mask = tiny_batch()
    seen = []

    def spy(x, *params):
        seen.append((x.shape, x.stride(), x.dtype))
        return cross_head(x, *params)

    monkeypatch.setattr(encoder_mod, "cross_head", spy)
    with torch.no_grad():
        logits = model(ids, mask)
    # one head launch, on the CLS view of the last hidden state (rows L * H apart)
    assert seen == [((4, H), (12 * H, 1), dtype)]
    assert logits.shape == (4, 3) and logits.dtype == torch.float32


def test_cross_encoder_head_keeps_k4_where_a_gradient_is_asked_for(monkeypatch):
    """Training (f32 only): the head is the pooler's product, K4's
    Function and the f32 classifier, with the same logits as the head
    kernel's plain version."""
    model = tiny_cross(torch.float32)
    ids, mask = tiny_batch()
    with torch.no_grad():
        want = model(ids, mask)
    seen = []
    monkeypatch.setattr(encoder_mod, "cross_head", lambda *a: seen.append(a))
    out = model(ids, mask)
    assert seen == [] and out.requires_grad
    out.sum().backward()
    assert model.pooler.weight.grad is not None and model.classifier.weight.grad is not None
    assert torch.equal(out.detach(), want)


def jax_loss(emb: np.ndarray):
    """``loss_fn``'s loss of the embeddings (``__graft_entry__.py:117-124``)
    and its gradient with respect to them."""

    def loss_fn(e):
        logits = e @ e.T * 20.0
        labels = jnp.arange(e.shape[0])
        logits = logits - 1e9 * jnp.eye(e.shape[0])
        pos = labels ^ 1
        return optax.softmax_cross_entropy_with_integer_labels(logits, pos).mean()

    loss, grad = jax.value_and_grad(loss_fn)(jnp.asarray(emb))
    return float(loss), np.asarray(grad)


def unit_rows(B: int, seed: int) -> np.ndarray:
    e = np.random.default_rng(seed).standard_normal((B, 48)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


@pytest.mark.parametrize("B", [2, 64, 130])
def test_loss_form_matches_jax_value_and_grad(B):
    emb = unit_rows(B, seed=B)
    want_loss, want_grad = jax_loss(emb)
    e = torch.from_numpy(emb)
    loss, lse, raw = contrastive_loss_fwd_plain(e)
    demb = contrastive_loss_bwd_plain(e, raw, lse, torch.tensor(1.0))
    assert abs(float(loss) - want_loss) <= F32_ATOL * max(1.0, abs(want_loss))
    np.testing.assert_allclose(demb.numpy(), want_grad, rtol=0, atol=F32_ATOL)
    # the differentiable loss (the wrappers' CPU path) gives the same
    et = e.clone().requires_grad_()
    out = in_batch_loss(et)
    out.backward()
    assert float(out.detach()) == float(loss)
    np.testing.assert_allclose(et.grad.numpy(), want_grad, rtol=0, atol=F32_ATOL)


def test_loss_form_keeps_what_the_raw_form_computes():
    """lse and raw as the forward keeps them, and d emb as (G + G^T) @ emb
    with G from ``contrastive_loss_plain``, scaled by the incoming gradient."""
    e = torch.from_numpy(unit_rows(12, seed=3))
    loss, lse, raw = contrastive_loss_fwd_plain(e)
    ref_loss, G = contrastive_loss_plain(e @ e.T)
    assert torch.equal(raw, e @ e.T) and torch.equal(loss, ref_loss)
    x = raw * 20.0 - 1e9 * torch.eye(12)
    assert torch.equal(lse, torch.logsumexp(x, dim=1))
    g = torch.tensor(0.37)
    torch.testing.assert_close(contrastive_loss_bwd_plain(e, raw, lse, g), ((G + G.T) @ e) * g, rtol=0, atol=0)


def test_loss_function_gradcheck_f64():
    emb = torch.from_numpy(np.random.default_rng(5).standard_normal((6, 4))).requires_grad_()
    assert torch.autograd.gradcheck(ContrastiveLossFunction.apply, (emb,))


def test_loss_form_refuses_odd_batches():
    with pytest.raises(ValueError, match="even"):
        k18.contrastive_loss(torch.zeros((5, 8)))
    with pytest.raises(ValueError, match="even"):
        in_batch_loss(torch.zeros((3, 8)))


# ---------------------------------------------------------------------------
# the argument checks (shapes, strides, types and alignment; any device)


def _head_args(B=4, h=128, labels=1, dtype=torch.bfloat16, L=3):
    hidden = torch.zeros((B, L, h), dtype=dtype)
    return (hidden[:, 0], torch.zeros((h, h)), torch.zeros(h), torch.zeros((labels, h)), torch.zeros(labels))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h, labels", [(64, 1), (768, 1), (1024, 3), (384, 64)])
def test_check_cross_head_takes_the_strided_cls_view(dtype, h, labels):
    check_cross_head(*_head_args(h=h, labels=labels, dtype=dtype))


@pytest.mark.parametrize("case, match", [
    ("hidden not a multiple of 64", "multiple of 64"),
    ("hidden above the limit", "multiple of 64"),
    ("too many labels", "labels"),
    ("no labels", "labels"),
    ("f16 rows", "bf16 or f32"),
    ("bf16 weight", "bf16 or f32"),
    ("pooler not square", "pooler"),
    ("classifier width", "classifier"),
    ("rows not contiguous", "16-byte"),
    ("rows 8 bytes apart", "16-byte"),
    ("three-dimensional rows", "CLS rows"),
    ("classifier transposed", "contiguous"),
])
def test_check_cross_head_refuses(case, match):
    x, wp, bp, wc, bc = _head_args(h=128, labels=2)
    if case == "hidden not a multiple of 64":
        x, wp, bp, wc, bc = _head_args(h=96)
    elif case == "hidden above the limit":
        x, wp, bp, wc, bc = _head_args(h=b8.MAX_HIDDEN + 64)
    elif case == "too many labels":
        x, wp, bp, wc, bc = _head_args(labels=b8.MAX_LABELS + 1)
    elif case == "no labels":
        wc, bc = torch.zeros((0, 128)), torch.zeros(0)
    elif case == "f16 rows":
        x = x.to(torch.float16)
    elif case == "bf16 weight":
        wp = wp.to(torch.bfloat16)
    elif case == "pooler not square":
        wp = torch.zeros((64, 128))
    elif case == "classifier width":
        wc = torch.zeros((2, 64))
    elif case == "rows not contiguous":
        x = torch.zeros((4, 256), dtype=torch.bfloat16)[:, ::2]
    elif case == "rows 8 bytes apart":
        x = torch.zeros((4 * 132,), dtype=torch.bfloat16).as_strided((4, 128), (132, 1))
    elif case == "three-dimensional rows":
        x = torch.zeros((4, 1, 128), dtype=torch.bfloat16)
    elif case == "classifier transposed":
        wc = torch.zeros((128, 2)).T
    with pytest.raises(ValueError, match=match):
        check_cross_head(x, wp, bp, wc, bc)


@pytest.mark.parametrize("B, H", [(2, 1), (64, 768), (130, 36), (4096, 8)])
def test_check_contrastive_loss_takes_even_batches_of_any_width(B, H):
    assert check_contrastive_loss(torch.zeros((B, H))) == B


@pytest.mark.parametrize("case", ["odd", "one row", "f64", "bf16", "1-d", "not contiguous", "no columns"])
def test_check_contrastive_loss_refuses(case):
    emb = {
        "odd": torch.zeros((5, 8)),
        "one row": torch.zeros((1, 8)),
        "f64": torch.zeros((4, 8), dtype=torch.float64),
        "bf16": torch.zeros((4, 8), dtype=torch.bfloat16),
        "1-d": torch.zeros(8),
        "not contiguous": torch.zeros((8, 4)).T,
        "no columns": torch.zeros((4, 0)),
    }[case]
    with pytest.raises(ValueError):
        check_contrastive_loss(emb)


def test_new_wrappers_raise_instead_of_falling_back():
    """A tensor that is neither on the CPU nor on a card (``meta``) makes
    each wrapper raise; none runs its plain version for it."""

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    calls = [
        lambda: cross_head(meta(4, 64, dtype=torch.bfloat16), meta(64, 64), meta(64), meta(1, 64), meta(1)),
        lambda: k18.contrastive_loss(meta(4, 8)),
        lambda: k18.contrastive_loss_bwd(meta(4, 8), meta(4, 4), meta(4), meta()),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
