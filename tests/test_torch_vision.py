"""The port's SigLIP-class image tower and dual encoder against the JAX
package's, on the CPU, and the plain versions of kernels K8 (patchify),
K4 with its position addend, K9 (vision_head), K10 (dual_logits) and the
repaired K6 (embed_ln) against the flax modules / jnp expressions they
replace.

Both sides run the same weights: the flax ``init`` parameters (biases and
LayerNorm parameters moved away from their zero / one init so every add
is exercised) go through ``dual_state_dict_from_flax`` /
``vision_state_dict_from_flax`` into the port.  The configuration is
tiny: 32-pixel images, patch 8 (P = 16), hidden 64, 2 layers, 2 heads,
MLP 128; the tower alone projects to ``embed_dim`` 48, so a transposed
projection shows.  Tolerances: f32 activations atol 1e-4 (the encoder
tolerance of ``tests/test_torch_encoder.py``); bf16 activations cosine
>= 0.999 per row and atol 2e-2 (the two libraries round bf16 at slightly
different places inside GELU and the bias adds); the plain versions of the
single kernels f32 atol 1e-5, bf16 atol 2e-2 with two bf16 ulps (rtol
2**-6), and exact where both sides round at the same steps; the logits,
``cos * e^0.3 - 0.7`` with the test's scalars, atol 1e-4 in f32 and 3e-2
in bf16 (the bf16 embedding tolerance times e^0.3).  No CUDA launch may be
counted.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import torch

import chip_smoke
from pathway_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from pathway_tpu.models.encoder import Embeddings as JaxEmbeddings
from pathway_tpu.models.vision import DualEncoderModel as JaxDual
from pathway_tpu.models.vision import VisionConfig as JaxVisionConfig
from pathway_tpu.models.vision import VisionEncoderModel as JaxVision
from pathway_tpu_torch import kernels
from pathway_tpu_torch.kernels import (
    bias_act,
    dual_logits,
    embed_ln,
    patch_grid,
    patchify,
    vision_head,
)
from pathway_tpu_torch.kernels.patchify import check_patchify
from pathway_tpu_torch.kernels.vision_head import check_vision_head
from pathway_tpu_torch.models import (
    SIGLIP_BASE,
    DualEncoderModel,
    VisionConfig,
    VisionEncoderModel,
    dual_state_dict_from_flax,
    vision_state_dict_from_flax,
)
from test_torch_encoder import port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread: the tier-1 run has several test workers on the
    host's cores, and this file's small products gain little from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_RTOL = 2.0**-6

TINY_VISION = JaxVisionConfig(
    image_size=32, patch=8, hidden=64, layers=2, heads=2, mlp_dim=128, embed_dim=48, dtype=jnp.float32
)
TINY_TEXT = JaxEncoderConfig(vocab_size=500, hidden=64, layers=2, heads=2, mlp_dim=128, max_len=32)


def vision_port_config(jcfg: JaxVisionConfig) -> VisionConfig:
    """The port's VisionConfig with the same fields as a JAX one."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(VisionConfig)}
    fields["dtype"] = _DT["bf16" if jcfg.dtype == jnp.bfloat16 else "f32"][1]
    fields["param_dtype"] = torch.float32
    return VisionConfig(**fields)


def images(B: int = 3, size: int = 32, seed: int = 0, dtype=np.float32) -> np.ndarray:
    """Seeded NHWC images; uint8 as pixel values, f32 in [0, 1)."""
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (B, size, size, 3)).astype(np.uint8)
    return rng.random((B, size, size, 3)).astype(np.float32)


def perturbed(params, seed: int = 1):
    """``params`` with every bias, LayerNorm scale and the logit scalars
    moved off their constant init, so each add and scale is exercised."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        name = getattr(path[-1], "key", "")
        leaf = np.asarray(leaf, np.float32)
        if name in ("bias", "scale"):
            return leaf + 0.1 * rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "logit_scale":
            return np.float32(0.3)
        if name == "logit_bias":
            return np.float32(-0.7)
        return leaf

    return jax.tree_util.tree_map_with_path(move, params)


def assert_embeddings_close(got: np.ndarray, want: np.ndarray, dtype: str) -> None:
    assert got.shape == want.shape and got.dtype == np.float32
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-4)
        return
    cos = (got * want).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(want, axis=-1)
    assert cos.min() >= 0.999
    np.testing.assert_allclose(got, want, atol=2e-2)


@pytest.fixture
def no_launch():
    """The CPU path counts no CUDA launch."""
    before = kernels.launch_counts()
    yield
    assert kernels.launch_counts() == before


def both_towers(jcfg: JaxVisionConfig, imgs: np.ndarray):
    jm = JaxVision(jcfg)
    params = perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(imgs)))
    cfg = vision_port_config(jcfg)
    tm = VisionEncoderModel(cfg, device="cpu")
    tm.load_state_dict(vision_state_dict_from_flax(params, cfg))
    return jm, params, tm


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("image_dtype", [np.float32, np.uint8], ids=["f32_images", "uint8_images"])
def test_vision_tower_matches_jax(dtype, image_dtype, no_launch):
    jcfg = dataclasses.replace(TINY_VISION, dtype=_DT[dtype][0])
    imgs = images(dtype=image_dtype)
    jm, params, tm = both_towers(jcfg, imgs)
    want = np.asarray(jm.apply(params, jnp.asarray(imgs)))
    with torch.no_grad():
        got = tm(torch.from_numpy(imgs)).numpy()
    assert got.shape == (3, 48)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    assert_embeddings_close(got, want, dtype)


def both_duals(dtype: str):
    jv = dataclasses.replace(TINY_VISION, dtype=_DT[dtype][0], embed_dim=64)
    jt = dataclasses.replace(TINY_TEXT, dtype=_DT[dtype][0])
    imgs = images(4)
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 500, (5, 12)).astype(np.int32)
    mask = (np.arange(12)[None] < np.array([12, 3, 7, 1, 10])[:, None]).astype(np.int32)
    jm = JaxDual(jv, jt)
    params = perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(ids), jnp.asarray(mask)))
    vcfg, tcfg = vision_port_config(jv), port_config(jt)
    tm = DualEncoderModel(vcfg, tcfg, device="cpu")
    tm.load_state_dict(dual_state_dict_from_flax(params, vcfg, tcfg))
    return jm, params, tm, imgs, ids, mask


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dual_encoder_embeddings_and_logits_match_jax(dtype, no_launch):
    jm, params, tm, imgs, ids, mask = both_duals(dtype)
    ji, jt, jl = (jnp.asarray(a) for a in (imgs, ids, mask))
    want_img = np.asarray(jm.apply(params, ji, method=JaxDual.embed_image))
    want_txt = np.asarray(jm.apply(params, jt, jl, method=JaxDual.embed_text))
    want_logits = np.asarray(jm.apply(params, ji, jt, jl))
    ti, tt, tl = (torch.from_numpy(a) for a in (imgs, ids, mask))
    with torch.no_grad():
        got_img = tm.embed_image(ti).numpy()
        got_txt = tm.embed_text(tt, tl).numpy()
        got_logits = tm(ti, tt, tl).numpy()
    assert_embeddings_close(got_img, want_img, dtype)
    assert_embeddings_close(got_txt, want_txt, dtype)
    assert got_logits.shape == (4, 5)
    # logits = cos * e^0.3 - 0.7: bf16 embedding noise scales by e^0.3
    np.testing.assert_allclose(got_logits, want_logits, atol=1e-4 if dtype == "f32" else 3e-2)


def test_dual_encoder_forces_the_text_tower_to_normalize():
    tcfg = dataclasses.replace(port_config(TINY_TEXT), normalize=False)
    m = DualEncoderModel(vision_port_config(dataclasses.replace(TINY_VISION, embed_dim=64)), tcfg, device="cpu")
    assert m.text.cfg.normalize and not tcfg.normalize
    assert m.logit_scale.item() == 1.0 and m.logit_bias.item() == 0.0
    assert m.logit_scale.dtype == m.logit_bias.dtype == torch.float32 and m.logit_scale.dim() == 0


def test_dual_state_dict_covers_every_parameter():
    jm, params, tm, *_ = both_duals("f32")
    sd = dual_state_dict_from_flax(params, tm.vision_cfg, tm.text_cfg)
    assert set(sd) == set(tm.state_dict())
    assert all(sd[k].shape == v.shape for k, v in tm.state_dict().items())
    assert not any(k.startswith("text.pooler") for k in sd)


def test_patch_kernel_hwio_layout_lands_in_patchify_column_order(no_launch):
    """A kernel with every entry distinct, and an image whose channels
    differ: the bridge's weight column (kh * p + kw) * 3 + c holds
    kernel[kh, kw, c], and the port's conv equals flax's."""
    p, hidden = 8, 64
    rng = np.random.default_rng(4)
    kernel = rng.standard_normal((p, p, 3, hidden)).astype(np.float32)
    bias = rng.standard_normal(hidden).astype(np.float32)
    cfg = vision_port_config(TINY_VISION)
    tree = perturbed(JaxVision(TINY_VISION).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    tree = jax.tree.map(np.asarray, tree)
    tree["params"]["patch_embed"] = {"kernel": kernel, "bias": bias}
    sd = vision_state_dict_from_flax(tree, cfg)
    w = sd["patch_embed.weight"].numpy()
    assert w.shape == (hidden, p * p * 3)
    for kh, kw, c in ((0, 0, 0), (0, 1, 0), (1, 0, 0), (0, 0, 2), (7, 3, 1), (5, 6, 2)):
        np.testing.assert_array_equal(w[:, (kh * p + kw) * 3 + c], kernel[kh, kw, c])
    imgs = images(2)
    imgs[..., 0] *= 3.0  # channels on different scales
    imgs[..., 2] -= 0.5
    conv = nn.Conv(hidden, (p, p), strides=(p, p), dtype=jnp.float32)
    want = np.asarray(conv.apply({"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(imgs)))
    want = want.reshape(2, -1, hidden) + tree["params"]["pos_embed"]
    tm = VisionEncoderModel(cfg, device="cpu")
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm.patch_embeddings(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("size", [32, 30, 25, (32, 27)], ids=["exact", "pad_2", "pad_7", "non_square"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_patchify_plain_times_kernel_is_the_flax_conv(size, dtype, no_launch):
    """K8's plain version, including flax's "SAME" padding of sides that
    are not multiples of the patch: patch rows x the HWIO kernel reshaped
    = ``nn.Conv``; in bf16 the patch values are exactly the image cast."""
    jdt, tdt = _DT[dtype]
    h, w = (size, size) if isinstance(size, int) else size
    rng = np.random.default_rng(5)
    imgs = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    kernel = rng.standard_normal((8, 8, 3, 16)).astype(np.float32)
    conv = nn.Conv(16, (8, 8), strides=(8, 8), use_bias=False, dtype=jnp.float32)
    want = np.asarray(conv.apply({"params": {"kernel": kernel}}, jnp.asarray(jnp.asarray(imgs, jdt), jnp.float32)))
    rows = patchify(torch.from_numpy(imgs), 8, tdt)
    gh, gw, top, left = patch_grid(h, w, 8)
    assert rows.shape == (2 * gh * gw, 192) and rows.dtype == tdt
    assert (gh, gw) == want.shape[1:3]
    pads = jax.lax.padtype_to_pads((h, w), (8, 8), (8, 8), "SAME")
    assert (top, left) == (pads[0][0], pads[1][0])
    got = (rows.float() @ torch.from_numpy(kernel.reshape(-1, 16))).numpy()
    np.testing.assert_allclose(got, want.reshape(-1, 16), atol=1e-4)
    # the values themselves: image row top + 8 * ho + kh, column left + 8 * wo + kw
    cast = np.asarray(jnp.asarray(imgs, jdt).astype(jnp.float32))
    r = rows.float().numpy().reshape(2, gh, gw, 8, 8, 3)
    y, x = 8 + 3 - top, 8 * (gw - 1) + 2 - left  # patch (1, gw - 1), kh=3, kw=2
    np.testing.assert_array_equal(r[1, 1, gw - 1, 3, 2], cast[1, y, x])


@pytest.mark.parametrize("size", [40, 33], ids=["grid_5", "grid_5_padded"])
def test_grid_that_misses_the_position_embedding_fails_on_both(size):
    """Sides whose "SAME" grid is not image_size // patch patches: the JAX
    model fails on the position embedding's broadcast, the port raises
    ValueError and never pads to a grid of its own."""
    imgs = images(1, size)
    jm = JaxVision(TINY_VISION)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    with pytest.raises(TypeError, match="broadcast"):
        jm.apply(params, jnp.asarray(imgs))
    tm = VisionEncoderModel(vision_port_config(TINY_VISION), device="cpu")
    with pytest.raises(ValueError, match="5x5 grid"):
        tm(torch.from_numpy(imgs))


def test_padded_grid_of_the_right_size_matches_jax(no_launch):
    """30-pixel images with image_size 32: "SAME" pads one pixel a side to
    the same 4 x 4 grid, and both packages accept them."""
    imgs = images(2, 30)
    jm, params, tm = both_towers(TINY_VISION, images(1))
    want = np.asarray(jm.apply(params, jnp.asarray(imgs)))
    with torch.no_grad():
        got = tm(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bias_act_pos_matches_flax_conv_bias_then_position_add(dtype, no_launch):
    """K4 in pos mode: round(round(y + b) + bf16(pos)), as flax's conv
    bias add and ``x + pos.astype(dtype)`` round (exact in bf16)."""
    jdt, tdt = _DT[dtype]
    rng = np.random.default_rng(6)
    B, P, N = 3, 16, 64
    y = rng.standard_normal((B * P, N)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    pos = (0.3 * rng.standard_normal((1, P, N))).astype(np.float32)
    jy = jnp.asarray(y, jdt)
    want = ((jy + jnp.asarray(b).astype(jdt)).reshape(B, P, N) + jnp.asarray(pos).astype(jdt)).reshape(B * P, N)
    t = torch.from_numpy(y).to(tdt)
    got = bias_act(t, torch.from_numpy(b), "none", pos=torch.from_numpy(pos[0]))
    assert got is t
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_bias_act_pos_rejects_a_table_that_does_not_tile_the_rows():
    with pytest.raises(ValueError, match="pos"):
        bias_act(torch.zeros(10, 8), torch.zeros(8), "none", pos=torch.zeros(4, 8))
    with pytest.raises(ValueError, match="pos"):
        bias_act(torch.zeros(8, 8), torch.zeros(8), "none", pos=torch.zeros(4, 16))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_vision_head_plain_matches_jax_tail(dtype, no_launch):
    """K9's plain version against ``vision.py:81-87``: f32 mean of every
    patch row (not rounded back to bf16), f32 Dense, normalize (eps 1e-12,
    a row of tiny values divided by it)."""
    jdt, tdt = _DT[dtype]
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4, 16, 64)) + 0.3).astype(np.float32)
    x[3] *= 1e-30
    kernel = (0.2 * rng.standard_normal((64, 48))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(48)).astype(np.float32)
    jx = jnp.asarray(x, jdt)
    dense = nn.Dense(48, dtype=jnp.float32, param_dtype=jnp.float32)
    for b in (bias, np.zeros_like(bias)):
        out = dense.apply({"params": {"kernel": kernel, "bias": b}}, jnp.mean(jx.astype(jnp.float32), axis=1))
        want = np.asarray(out / jnp.maximum(jnp.sqrt(jnp.sum(out**2, axis=-1, keepdims=True)), 1e-12))
        got = vision_head(torch.from_numpy(x).to(tdt), torch.from_numpy(kernel.T.copy()), torch.from_numpy(b))
        assert got.dtype == torch.float32 and got.shape == (4, 48)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_dual_logits_plain_matches_jax_expression(no_launch):
    rng = np.random.default_rng(8)
    img = rng.standard_normal((5, 32)).astype(np.float32)
    txt = rng.standard_normal((7, 32)).astype(np.float32)
    for s, b in ((1.0, 0.0), (-0.4, 2.5)):
        want = np.asarray(jnp.asarray(img) @ jnp.asarray(txt).T * jnp.exp(jnp.float32(s)) + jnp.float32(b))
        got = dual_logits(torch.from_numpy(img), torch.from_numpy(txt), torch.tensor(s), torch.tensor(b))
        assert got.shape == (5, 7) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("id_dtype", [torch.int16, torch.int32, torch.int64])
def test_embed_ln_out_of_range_ids_follow_flax_embed(dtype, id_dtype, no_launch):
    """K6's plain version against flax ``nn.Embed``: word and type ids in
    [-n, 0) wrap to n + id; ids >= n or < -n give NaN rows."""
    jdt, tdt = _DT[dtype]
    jcfg = dataclasses.replace(TINY_TEXT, dtype=jdt, max_len=16)
    n = jcfg.vocab_size
    ids = np.array([[3, n, n + 7, -1, -n, -n - 1, 499, 0], [-3, 12, 2 * n, -250, 1, 2, 3, 4]], np.int32)
    types = np.array([[0, 1, 0, -1, 1, 0, 2, -3], [1, 0, 0, 0, -2, 1, 0, 0]], np.int32)
    module = JaxEmbeddings(jcfg)
    params = perturbed(module.init(jax.random.PRNGKey(1), jnp.asarray(ids), None))["params"]
    want = np.asarray(module.apply({"params": params}, jnp.asarray(ids), jnp.asarray(types)).astype(jnp.float32))
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    got = embed_ln(
        torch.from_numpy(ids).to(id_dtype), torch.from_numpy(types).to(id_dtype),
        t(params["word"]["embedding"]), t(params["position"]["embedding"]), t(params["type"]["embedding"]),
        t(params["ln"]["scale"]), t(params["ln"]["bias"]), jcfg.ln_eps, tdt,
    ).float().numpy()
    nan_rows = np.isnan(want).all(-1)
    # ids >= n or < -n, and type ids 2, -3: NaN rows; no other NaN anywhere
    expect = (ids >= n) | (ids < -n) | (types >= 2) | (types < -2)
    np.testing.assert_array_equal(nan_rows, expect)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    live = ~nan_rows
    np.testing.assert_allclose(got[live], want[live], atol=1e-5 if dtype == "f32" else 2e-2,
                               rtol=0 if dtype == "f32" else BF16_RTOL)


@pytest.mark.parametrize("image_dtype", [torch.float32, torch.uint8], ids=["f32_images", "uint8_images"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_patchify_check_takes_both_activation_types(dtype, image_dtype):
    """K8's launch check (C8): the kernel writes the tower's activation type,
    f32 as well as bf16, at SigLIP-base's and the tiny config's shapes; the
    check reads shapes, types and alignment only, so it runs on CPU tensors."""
    check_patchify(torch.zeros((2, 224, 224, 3), dtype=image_dtype), 16, dtype)
    check_patchify(torch.zeros((2, 30, 27, 3), dtype=image_dtype), 8, dtype)  # "SAME" padding
    # rows of 4 values (patch 2, one channel) fit the f32 form's 4-value
    # stores and not the bf16 form's 8-value ones
    narrow = torch.zeros((1, 8, 8, 1), dtype=image_dtype)
    if dtype == torch.float32:
        check_patchify(narrow, 2, dtype)
    else:
        with pytest.raises(ValueError, match="8-value"):
            check_patchify(narrow, 2, dtype)
    with pytest.raises(ValueError, match="4-value" if dtype == torch.float32 else "8-value"):
        check_patchify(torch.zeros((1, 9, 9, 1), dtype=image_dtype), 3, dtype)  # 9 columns
    with pytest.raises(ValueError, match="16-byte"):
        check_patchify(torch.zeros(4 * 8 * 8 * 3 + 1, dtype=torch.float32)[1:].view(4, 8, 8, 3), 4, dtype)
    with pytest.raises(ValueError, match="too large"):
        check_patchify(torch.zeros((1, 1, 1, 8), dtype=image_dtype).expand(2**28, 1, 1, 8), 1, dtype)


def test_patchify_check_refuses_what_the_kernel_cannot_write():
    with pytest.raises(ValueError, match="bf16 or f32"):
        check_patchify(torch.zeros((1, 16, 16, 3)), 8, torch.float16)
    with pytest.raises(ValueError, match="f32 or uint8"):
        check_patchify(torch.zeros((1, 16, 16, 3), dtype=torch.float64), 8, torch.float32)
    with pytest.raises(ValueError, match=r"\[B, H, W, C\]"):
        check_patchify(torch.zeros((16, 16, 3)), 8, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_vision_head_check_takes_both_activation_types(dtype):
    """K9's launch check (C8): x in the tower's activation type, f32 as well
    as bf16, at SigLIP-base's shape and the tiny config's (the projection to
    48 columns, not a multiple of the kernel's cluster of 8)."""
    check_vision_head(torch.zeros((4, 196, 768), dtype=dtype), torch.zeros((768, 768)), torch.zeros(768))
    check_vision_head(torch.zeros((3, 16, 64), dtype=dtype), torch.zeros((48, 64)), torch.zeros(48))
    with pytest.raises(ValueError, match="divisible by 4"):
        check_vision_head(torch.zeros((3, 16, 66), dtype=dtype), torch.zeros((48, 66)), torch.zeros(48))
    with pytest.raises(ValueError, match="f32 weight"):
        check_vision_head(torch.zeros((3, 16, 64), dtype=dtype), torch.zeros((48, 64), dtype=torch.bfloat16),
                          torch.zeros(48))
    with pytest.raises(ValueError, match="16-byte"):
        check_vision_head(torch.zeros((3, 16, 64), dtype=dtype), torch.zeros(48 * 64 + 1)[1:].view(48, 64),
                          torch.zeros(48))


def test_vision_head_check_refuses_what_the_kernel_cannot_read():
    with pytest.raises(ValueError, match="bf16 or f32 x"):
        check_vision_head(torch.zeros((3, 16, 64), dtype=torch.float16), torch.zeros((48, 64)), torch.zeros(48))
    with pytest.raises(ValueError, match=r"\[B, P, hidden\]"):
        check_vision_head(torch.zeros((16, 64)), torch.zeros((48, 64)), torch.zeros(48))
    with pytest.raises(ValueError, match="P > 0"):
        check_vision_head(torch.zeros((3, 0, 64)), torch.zeros((48, 64)), torch.zeros(48))


def test_vision_wrappers_raise_instead_of_falling_back():
    """A wrapper given a non-CPU tensor it cannot launch on raises; it
    never runs the plain version for it."""
    meta = {"device": "meta"}
    with pytest.raises(ValueError, match="CUDA"):
        patchify(torch.zeros((1, 32, 32, 3), **meta), 8)
    with pytest.raises(ValueError, match="CUDA"):
        vision_head(torch.zeros((1, 16, 64), dtype=torch.bfloat16, **meta),
                    torch.zeros((48, 64), **meta), torch.zeros(48, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        dual_logits(torch.zeros((2, 8), **meta), torch.zeros((3, 8), **meta),
                    torch.zeros((), **meta), torch.zeros((), **meta))
    with pytest.raises(ValueError, match="CUDA"):
        bias_act(torch.zeros((32, 64), dtype=torch.bfloat16, **meta), torch.zeros(64, **meta),
                 "none", pos=torch.zeros((16, 64), **meta))


def test_siglip_base_shape():
    cfg = SIGLIP_BASE
    assert (cfg.image_size, cfg.patch, cfg.n_patches, cfg.hidden) == (224, 16, 196, 768)
    assert (cfg.layers, cfg.heads, cfg.mlp_dim, cfg.embed_dim) == (12, 12, 3072, 768)
    assert (cfg.dtype, cfg.param_dtype) == (torch.bfloat16, torch.float32)
    ecfg = cfg.as_encoder_cfg()
    assert (ecfg.hidden, ecfg.layers, ecfg.heads, ecfg.mlp_dim, ecfg.dtype) == (768, 12, 12, 3072, torch.bfloat16)
    jcfg = JaxVisionConfig()
    assert vision_port_config(jcfg) == cfg


def test_vision_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    cfg = vision_port_config(TINY_VISION)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VisionEncoderModel(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DualEncoderModel(cfg, port_config(TINY_TEXT))


def test_vision_import_pulls_in_no_jax():
    code = (
        "import sys, pathway_tpu_torch.models.vision, pathway_tpu_torch.kernels.patchify,"
        " pathway_tpu_torch.kernels.vision_head, pathway_tpu_torch.kernels.dual_logits;"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'pathway_tpu'));"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_chip_smoke_plain_vision_forward_is_the_tower(dtype, no_launch):
    """The reference phase 5 holds the image path to is the tower's own
    forward when every wrapper runs its plain version (on the CPU)."""
    cfg = vision_port_config(dataclasses.replace(TINY_VISION, dtype=_DT[dtype][0]))
    tm = VisionEncoderModel(cfg, device="cpu", seed=3)
    imgs = chip_smoke.synthetic_images(np, torch, 4, 32, 0, "cpu")
    with torch.no_grad():
        torch.testing.assert_close(chip_smoke.plain_vision_forward(tm, imgs), tm(imgs), rtol=0, atol=0)


def test_chip_smoke_synthetic_images_are_structured_and_distinct():
    a = chip_smoke.synthetic_images(np, torch, 16, 32, 0, "cpu").numpy()
    assert a.shape == (16, 32, 32, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, chip_smoke.synthetic_images(np, torch, 16, 32, 0, "cpu").numpy())
    flat = a.reshape(16, -1).astype(np.float64)
    assert len({row.tobytes() for row in a.reshape(16, -1)}) == 16
    # structured, not noise: neighbouring pixels mostly agree
    assert (np.abs(np.diff(a.astype(np.int16), axis=2)) <= 8).mean() > 0.8
    assert flat.std(axis=1).min() > 10
